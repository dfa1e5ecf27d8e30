"""Possibility passes of the N-Rank planner: CUDA kernels + plain twins."""

from .ops import (possibility_v, possibility_weights, possibility_weights_op,
                  prepare_weights)
from .ref import possibility_v_plain, possibility_weights_plain

__all__ = ["possibility_v", "possibility_v_plain", "possibility_weights",
           "possibility_weights_op", "possibility_weights_plain",
           "prepare_weights"]
