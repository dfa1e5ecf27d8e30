"""Flit step: the simulator's cycles as one CUDA launch a chunk
(``simstep_chunk``, or ``simstep_grid`` for cells no cluster holds),
beside their plain-torch twin."""

from .ops import (FlitStep, card_kernel, card_tile, chunk_tiles, grid_layout,
                  make_step, resolve_path)
from .ref import (MOV_W, N_PART, draw_chunk, make_cycle_fn, make_cycle_parts,
                  node_uniform, reorder_occupancy, reorder_occupancy_update,
                  split_rand)

__all__ = ["FlitStep", "card_kernel", "card_tile", "chunk_tiles",
           "grid_layout", "make_step", "resolve_path", "MOV_W", "N_PART",
           "draw_chunk", "make_cycle_fn", "make_cycle_parts", "node_uniform",
           "reorder_occupancy", "reorder_occupancy_update", "split_rand"]
