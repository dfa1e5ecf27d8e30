"""Observability of the port: the structured event log, the in-sim
telemetry probes, and the no-op tracer whose interface the Chrome-trace
writer will fill (the writer and the report are not ported yet, ROADMAP
queue 1, item 9)."""

from .log import EventLog
from .probe import (TEL_COUNT_FIELDS, TEL_KEYS, Telemetry, resolved_epoch,
                    telemetry_state)
from .trace import NULL_TRACER, NullTracer

__all__ = ["EventLog", "NullTracer", "NULL_TRACER", "TEL_KEYS",
           "TEL_COUNT_FIELDS", "Telemetry", "resolved_epoch",
           "telemetry_state"]
