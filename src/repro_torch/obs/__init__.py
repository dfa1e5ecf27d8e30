"""Observability of the port: the structured event log, and the no-op
tracer whose interface the Chrome-trace writer will fill (the writer and
the report are not ported yet, ROADMAP queue 1, item 9)."""

from .log import EventLog
from .trace import NULL_TRACER, NullTracer

__all__ = ["EventLog", "NullTracer", "NULL_TRACER"]
