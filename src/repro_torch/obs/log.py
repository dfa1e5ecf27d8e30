"""Structured event log: one emitter behind every ``verbose=`` flag.

Each call site names the event kind and its structured fields once; the
log prints the human-readable line to stdout iff ``verbose`` (quiet runs
emit nothing).  Forwarding events to a trace writer comes with the
writer (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

__all__ = ["EventLog"]


class EventLog:
    def __init__(self, verbose: bool = False):
        self.verbose = bool(verbose)

    def event(self, kind: str, msg: str | None = None, **fields) -> None:
        """Print one event iff verbose.  ``msg`` is the human line
        (defaults to ``kind key=value ...``)."""
        if self.verbose:
            if msg is None:
                msg = kind + "".join(f" {k}={v}" for k, v in fields.items())
            print(msg, flush=True)
