"""Observability of the port, in three planes:

* :mod:`repro_torch.obs.probe`: the in-sim telemetry rings (off by
  default; on or off, no result changes);
* :mod:`repro_torch.obs.trace`: Chrome trace-event streaming of the
  control plane's events and the host's spans (Perfetto-viewable), and
  :mod:`repro_torch.obs.log`'s structured event log behind the
  ``verbose=`` flags;
* :mod:`repro_torch.obs.report`: a campaign job's report (trajectories,
  replan timeline) from its telemetry, trace and metrics.
"""

from .log import EventLog, NULL_LOG
from .probe import (TEL_COUNT_FIELDS, TEL_KEYS, Telemetry, resolved_epoch,
                    telemetry_state)
from .trace import (NULL_TRACER, NullTracer, TraceWriter, read_trace,
                    validate_events)

__all__ = [
    "EventLog", "NULL_LOG",
    "TEL_COUNT_FIELDS", "TEL_KEYS", "Telemetry", "resolved_epoch",
    "telemetry_state",
    "NULL_TRACER", "NullTracer", "TraceWriter", "read_trace",
    "validate_events",
]
