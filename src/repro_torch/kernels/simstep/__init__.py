"""Flit step: the simulator's per-cycle transition as two CUDA kernels
(``simstep_tile``, ``simstep_finish``) beside their plain-torch twins."""

from .ops import FlitStep, make_step, resolve_path
from .ref import (MOV_W, N_PART, draw_chunk, make_cycle_fn, make_cycle_parts,
                  split_rand)

__all__ = ["FlitStep", "make_step", "resolve_path", "MOV_W", "N_PART",
           "draw_chunk", "make_cycle_fn", "make_cycle_parts", "split_rand"]
