"""Mamba's selective scan: the CUDA kernels (the scan and its gradient)
and their plain twins."""

from .ops import SelectiveScan, selective_scan
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["SelectiveScan", "selective_scan", "selective_scan_bwd_ref",
           "selective_scan_ref"]
