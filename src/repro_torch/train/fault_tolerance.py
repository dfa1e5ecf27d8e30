"""Fault tolerance, the reference's ``train/fault_tolerance.py`` on one
process:

* ``resume_or_init`` — restore the latest complete checkpoint if one
  exists, else start fresh; with the atomic-rename writer this gives
  at-least-once training progress across preemptions.
* ``PreemptionHandler`` — SIGTERM/SIGINT → finish the in-flight step,
  write a final checkpoint, exit cleanly.
* ``ElasticMesh`` — the largest (data, model) shape for the visible
  device count, and the gradient accumulation that keeps the global
  batch as the data axis shrinks.  There is no mesh object: the port
  runs on one card, so the shape is all a caller reads.
* ``StragglerMonitor`` — EWMA of per-step wall time; flags steps slower
  than ``threshold ×`` the moving average.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from .checkpoint import CheckpointManager


def resume_or_init(mgr: CheckpointManager, like_state):
    """Restore the latest checkpoint into ``like_state``, or return
    (like_state, step=0) if none exists."""
    if mgr.latest_step() is None:
        return like_state, 0
    return mgr.restore(like_state)


class PreemptionHandler:
    """SIGTERM-graceful checkpointing.

    >>> handler = PreemptionHandler()
    >>> while training:
    ...     state = train_step(state)
    ...     if handler.should_stop:
    ...         mgr.save(step, state); break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:  # not the main thread
                pass

    def _handle(self, signum, frame):
        self.should_stop = True

    def restore_handlers(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclasses.dataclass
class ElasticMesh:
    """Largest (data, model) shape for the live device count.

    ``model`` parallel degree is pinned (weights are laid out for it);
    ``data`` shrinks to what remains.
    """

    model_degree: int

    def build(self, devices=None) -> dict:
        """``devices``: a sequence of devices, or None for the visible
        CUDA devices (one CPU where there are none).  Returns the shape
        ``{"data": d, "model": m}``."""
        if devices is None:
            n = torch.cuda.device_count() or 1
        else:
            n = len(devices)
        data = n // self.model_degree
        if data < 1:
            raise RuntimeError(
                f"{n} devices cannot sustain model degree "
                f"{self.model_degree}")
        return {"data": data, "model": self.model_degree}

    def grad_accum_for(self, global_batch: int, per_chip_batch: int,
                       mesh: dict) -> int:
        """Keep the global batch constant as the data axis shrinks."""
        per_step = mesh["data"] * per_chip_batch
        return max(1, -(-global_batch // per_step))


class StragglerMonitor:
    """EWMA step-time tracker with threshold-based flagging."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma = None
        self.count = 0
        self.flagged: list[tuple[int, float]] = []
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record one step; returns True if it was a straggler step."""
        return self.observe(time.monotonic() - self._t0)

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.count > self.warmup
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((self.count, dt))
        else:
            # stragglers don't poison the moving average
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler
