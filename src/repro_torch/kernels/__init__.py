"""Hand-written CUDA kernels of the port, each beside its plain twin.

Every wrapper launches its kernel for tensors on the card and runs the
plain-torch version for tensors on the CPU; nothing falls back from one
to the other.  :data:`LAUNCHES` counts kernel launches by name: a wrapper
adds one where it launches and nowhere else, so a run can show that the
main path went through the kernels.  The scan's backward wrapper
launches two kernels and counts its second, the reduction, under
``selective_scan_bwd_reduce``.  :data:`LAUNCH_SIZES` counts the
possibility passes' launches by (name, N, C) beside it.
"""

from collections import Counter

LAUNCHES = {"possibility_v": 0, "possibility_weights": 0, "simstep_chunk": 0,
            "simstep_grid": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "selective_scan": 0,
            "selective_scan_bwd": 0, "selective_scan_bwd_reduce": 0}
LAUNCH_SIZES: Counter = Counter()


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SIZES.clear()
