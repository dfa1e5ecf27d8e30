"""Fault tolerance, the reference's ``train/fault_tolerance.py``:

* ``resume_or_init`` — restore the latest complete checkpoint if one
  exists, else start fresh; with the atomic-rename writer this gives
  at-least-once training progress across preemptions.
* ``PreemptionHandler`` — SIGTERM/SIGINT → finish the in-flight step,
  write a final checkpoint, exit cleanly; on a mesh a stop seen on any
  rank stops every rank after the same step (``poll``).
* ``ElasticMesh`` — the largest (data, model) shape for the live ranks
  (the process group's world, or a device count), and the gradient
  accumulation that keeps the global batch as the data axis shrinks.
* ``StragglerMonitor`` — EWMA of per-step wall time; flags steps slower
  than ``threshold ×`` the moving average.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch
import torch.distributed as dist

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

    def poll(self, device=None) -> bool:
        """Whether to stop now: this process's flag or, with a process
        group of several ranks up, any rank's (a MAX all-reduce on
        ``device``, so every rank stops after the same step)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self.should_stop
        flag = torch.tensor([int(self.should_stop)], dtype=torch.int32,
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

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
        """The shape ``{"data": d, "model": m}`` for ``devices`` (a
        sequence) or, with None, for the world's ranks where a process
        group is up, else the visible CUDA devices (one CPU where there
        are none).  ``launch.mesh.make_mesh`` builds the mesh of a
        shape."""
        if devices is not None:
            n = len(devices)
        elif dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() or 1
        data = n // self.model_degree
        if data < 1:
            raise RuntimeError(
                f"{n} devices cannot sustain model degree "
                f"{self.model_degree}")
        return {"data": data, "model": self.model_degree}

    def grad_accum_for(self, global_batch: int, per_chip_batch: int,
                       mesh) -> int:
        """Keep the global batch constant as the data axis shrinks
        (``mesh``: a shape or a ``DeviceMesh``)."""
        from ..sharding.specs import axis_sizes

        per_step = axis_sizes(mesh)["data"] * per_chip_batch
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
