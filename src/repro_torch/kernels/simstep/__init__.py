"""Flit step: the simulator's cycles as one CUDA chunk kernel
(``simstep_chunk``), or for cells it cannot lay out a kernel pair a
cycle (``simstep_tile``, ``simstep_finish``), beside their plain-torch
twin."""

from .ops import (FlitStep, card_kernel, card_tile, chunk_tiles, make_step,
                  resolve_path)
from .ref import (MOV_W, N_PART, draw_chunk, make_cycle_fn, make_cycle_parts,
                  node_uniform, reorder_occupancy, reorder_occupancy_update,
                  split_rand)

__all__ = ["FlitStep", "card_kernel", "card_tile", "chunk_tiles",
           "make_step", "resolve_path", "MOV_W", "N_PART", "draw_chunk",
           "make_cycle_fn", "make_cycle_parts", "node_uniform",
           "reorder_occupancy", "reorder_occupancy_update", "split_rand"]
