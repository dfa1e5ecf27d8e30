"""The no-op trace sink, with the emit interface of the reference's
trace writer.

Nothing in the port traces yet: ``run_controlled`` and ``replan`` raise
on a ``tracer=``.  The streaming Chrome trace writer (``TraceWriter``)
and the instrumented call sites that default to :data:`NULL_TRACER` come
with ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import contextlib

__all__ = ["NullTracer", "NULL_TRACER"]


class NullTracer:
    """No-op tracer with the trace writer's emit interface."""

    enabled = False

    def now_us(self) -> float:
        return 0.0

    def instant(self, name, **kw) -> None:
        pass

    def counter(self, name, values, **kw) -> None:
        pass

    def complete(self, name, ts_us, dur_us, **kw) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name, **kw):
        yield {}

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()
