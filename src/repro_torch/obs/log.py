"""Structured event log: one emitter behind every ``verbose=`` flag.

Each call site names the event kind and its structured fields once; the
log then

* prints the human-readable line iff ``verbose`` (quiet runs print
  nothing), and
* forwards the structured form to a trace writer
  (:class:`repro_torch.obs.trace.TraceWriter`) as an instant event when
  one is attached; tracing does not depend on verbosity, so a quiet
  campaign job still records its trace.
"""

from __future__ import annotations

import sys

from .trace import NULL_TRACER

__all__ = ["EventLog", "NULL_LOG"]


class EventLog:
    def __init__(self, verbose: bool = False, tracer=None, stream=None):
        self.verbose = bool(verbose)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stream = stream

    def event(self, kind: str, msg: str | None = None, *,
              cat: str = "log", **fields) -> None:
        """Record one event.  ``msg`` is the human line (defaults to
        ``kind key=value ...``); ``fields`` are the structured args."""
        if self.verbose:
            if msg is None:
                msg = kind + "".join(f" {k}={v}" for k, v in fields.items())
            print(msg, file=self.stream or sys.stdout, flush=True)
        self.tracer.instant(kind, cat=cat, args=fields or None)


NULL_LOG = EventLog(verbose=False)
