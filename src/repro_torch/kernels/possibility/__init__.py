"""Possibility pass of the N-Rank planner: CUDA kernel + plain twin."""

from .ops import possibility_v
from .ref import possibility_v_plain

__all__ = ["possibility_v", "possibility_v_plain"]
