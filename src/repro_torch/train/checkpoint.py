"""Atomic, async checkpointing with keep-k retention, the reference's
``train/checkpoint.py`` for torch state.

Layout (one directory per step, atomically renamed into place):

    ckpt_dir/
      step_00000100/
        manifest.json      # leaves' paths, shapes, dtypes; the step
        leaf_00000.npy     # one file per leaf, in the state's order
      step_00000200/ ...

A state is nested dicts of tensors and ``nn.Module``\\ s (a module's
leaves are its ``named_parameters``).  numpy has no bfloat16: a bf16
leaf is stored as its uint16 bit pattern, with ``"bfloat16"`` in the
manifest, and restored bit for bit.

Fault-tolerance contract (the reference's):
  * writes go to ``step_X.tmp0`` then ``os.replace``: readers never see
    a partial checkpoint;
  * ``latest_step`` scans for complete manifests only;
  * ``restore(like)`` loads each leaf onto the like-state's tensor, its
    device and dtype (in place: no second copy of the weights), and
    returns the like-state;
  * async mode: the device→host copy is synchronous (a consistent
    snapshot), the file I/O runs on a daemon thread; ``wait()`` joins.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch
from torch import nn


def flatten(state, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in order: a module's parameters as
    ``named_parameters`` gives them, a dict's entries in insertion
    order; paths join keys with "/"."""
    if isinstance(state, nn.Module):
        return [(f"{prefix}{n}", p) for n, p in state.named_parameters()]
    if isinstance(state, dict):
        out = []
        for k, v in state.items():
            out += flatten(v, f"{prefix}{k}/")
        return out
    if isinstance(state, torch.Tensor):
        return [(prefix.rstrip("/"), state)]
    raise TypeError(f"{prefix}: not a tensor, dict or module: {type(state)}")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: bf16 as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    # ------------------------------------------------------------------ #
    def save(self, step: int, state, async_: bool = False) -> None:
        """Snapshot ``state`` (device→host now; file I/O maybe async)."""
        self.wait()
        leaves = flatten(state)
        host = [to_host(t) for _, t in leaves]
        manifest = {
            "num_leaves": len(host),
            "step": step,
            "leaves": [{"path": p, "shape": list(t.shape),
                        "dtype": _dtype_name(t)} for p, t in leaves],
        }

        def write():
            final = self._step_dir(step)
            tmp = final + ".tmp0"
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if async_:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def restore(self, like, step: int | None = None):
        """Load a checkpoint into ``like`` (same structure): each leaf is
        copied onto the like-state's tensor, so it keeps that tensor's
        device and dtype.  Returns (like, step)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = flatten(like)
        if len(leaves) != manifest["num_leaves"]:
            raise ValueError(f"checkpoint has {manifest['num_leaves']} "
                             f"leaves, the target {len(leaves)}")
        for i, ((path, ref), meta) in enumerate(zip(leaves,
                                                    manifest["leaves"])):
            a = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            if meta["path"] != path or tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint {meta['path']} "
                                 f"{a.shape}, target {path} "
                                 f"{tuple(ref.shape)}")
            ref.copy_(from_host(a, meta["dtype"]).to(ref.dtype))
        return like, step
