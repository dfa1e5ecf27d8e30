"""N-Rank (paper §3.2): the parts the device planner needs.

The planner (:mod:`repro_torch.core.plan_fast`) runs the whole N-Rank
evolution itself; this module carries its result record, the paper's
termination defaults and eq. (1).  The stage-by-stage host oracle
(``possibility_weights``, ``nrank``, ``nrank_channel``) is not ported
yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["NRankResult", "initial_weights", "W_TH", "ITER_TH"]

# paper §3.2.1 defaults
W_TH = 0.01
ITER_TH = 100


@dataclasses.dataclass(frozen=True)
class NRankResult:
    """Output of the N-Rank evolution."""

    w_nr: np.ndarray          # (N,) NR-weights — likelihood of heavy load
    w0: np.ndarray            # (N,) initial weights (eq. 1)
    w_final: np.ndarray       # (N,) residual weight at termination
    iterations: int
    p: np.ndarray             # (C,) transfer probability per channel (eq. 8)
    p_drn: np.ndarray         # (C,) draining probability per channel (eq. 9)
    w_possibility: np.ndarray  # (C,) possibility weight W^{u,n} (eq. 5)


def initial_weights(traffic: np.ndarray) -> np.ndarray:
    """Eq. (1): w0[n] = Σ_{n'} T[n, n']."""
    return np.asarray(traffic, dtype=np.float64).sum(axis=1)
