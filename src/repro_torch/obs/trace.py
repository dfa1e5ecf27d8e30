"""Structured trace events: Chrome trace-event JSON, Perfetto-viewable.

The host-side plane of the port's observability.  :class:`TraceWriter`
streams events to disk in the Chrome trace-event **JSON Array Format**:
a ``[`` followed by one ``{event},`` a line.  The format allows the
closing ``]`` to be absent, so a stream killed mid-write is still
loadable by Perfetto or ``chrome://tracing``: the writer never closes
the array, and a resumed job appends to it.

Phases used here (``ph``):

* ``X`` *complete*: a span with ``ts`` and ``dur`` (the host wall time of
  a plan build, a control epoch, a campaign cell);
* ``i`` *instant*: a point event (drift detection, table hot-swap, link
  fail or recover, plan-cache hit or miss);
* ``C`` *counter*: a named value series (the drift TV distance an epoch).

Timestamps are microseconds since the Unix epoch, so spans from separate
processes or resumed jobs land on one timeline.

:data:`NULL_TRACER` is the no-op sink: instrumented code takes a
``tracer`` and defaults to it, so tracing off costs one attribute read an
event site and nothing else.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["TraceWriter", "NullTracer", "NULL_TRACER", "read_trace",
           "validate_events"]


class NullTracer:
    """No-op tracer with the :class:`TraceWriter` emit interface."""

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


class TraceWriter:
    """Streaming Chrome trace-event writer (see module docstring).

    ``append=True`` (the default) continues an existing stream — the
    resume path: the array stays unterminated, so the concatenation of
    a job's runs is one valid trace.  Thread-safe: the campaign
    service emits from a daemon thread while ``status()`` pollers run
    on the caller's.
    """

    enabled = True

    def __init__(self, path: str, *, pid: str = "qstar",
                 append: bool = True):
        self.path = str(path)
        self.pid = str(pid)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a" if append else "w")
        if self._f.tell() == 0:
            self._f.write("[\n")
            self._f.flush()

    def now_us(self) -> float:
        """Current timestamp on the trace clock (Unix epoch µs)."""
        return time.time() * 1e6

    # ------------------------------------------------------------- #
    def _emit(self, ev: dict) -> None:
        line = json.dumps(ev, sort_keys=True, default=str)
        with self._lock:
            self._f.write(line + ",\n")
            self._f.flush()

    def instant(self, name: str, *, cat: str = "ctrl",
                args: dict | None = None, tid: int = 0,
                ts_us: float | None = None) -> None:
        ev = {"name": name, "ph": "i", "cat": cat, "s": "t",
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict, *, cat: str = "ctrl",
                tid: int = 0, ts_us: float | None = None) -> None:
        self._emit({"name": name, "ph": "C", "cat": cat,
                    "ts": self.now_us() if ts_us is None else ts_us,
                    "pid": self.pid, "tid": tid,
                    "args": {k: float(v) for k, v in values.items()}})

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "host", args: dict | None = None,
                 tid: int = 0) -> None:
        ev = {"name": name, "ph": "X", "cat": cat, "ts": ts_us,
              "dur": max(float(dur_us), 0.0), "pid": self.pid,
              "tid": tid}
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host",
             args: dict | None = None, tid: int = 0):
        """``with tracer.span("replan") as a:`` — emits one complete
        event on exit (exceptions included, flagged in args).  The
        yielded dict collects extra args discovered inside the span."""
        extra: dict = {}
        t0 = self.now_us()
        try:
            yield extra
        except BaseException:
            extra["error"] = True
            raise
        finally:
            self.complete(name, t0, self.now_us() - t0, cat=cat,
                          args={**(args or {}), **extra} or None, tid=tid)

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        """Close the file handle.  The array is deliberately left
        unterminated — valid per the trace-event spec, and the only
        representation that survives a kill at any byte."""
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


# ------------------------------------------------------------------- #
# readers (reports + tests)
# ------------------------------------------------------------------- #
def read_trace(path: str) -> list[dict]:
    """Parse a (possibly unterminated) JSON-array trace stream.

    Tolerates the trailing comma and missing ``]`` of a killed stream —
    the same leniency Perfetto's importer applies."""
    with open(path) as f:
        text = f.read()
    body = text.strip()
    if body.startswith("["):
        body = body[1:]
    body = body.rstrip().rstrip("]").rstrip().rstrip(",")
    if not body:
        return []
    return json.loads("[" + body + "]")


_PHASES = {"X", "i", "C"}


def validate_events(events: list[dict]) -> list[str]:
    """Schema check of the vocabulary this package emits; returns a
    list of problems (empty == valid)."""
    problems = []
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"event {i}: complete event without dur")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            problems.append(f"event {i}: counter without args dict")
        ts = ev.get("ts")
        if ts is not None and not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts {ts!r}")
    return problems
