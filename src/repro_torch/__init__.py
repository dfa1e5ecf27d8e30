"""Q-StaR on PyTorch and CUDA: the port of the JAX reproduction.

Slice 1 runs the paper's main path — topology + traffic matrix, N-Rank
plan, BiDOR choice table with its deadlock certificate, table-routed
flit simulation, campaign statistics — for XY and BiDOR.  Slice 2 adds
the stage-by-stage N-Rank oracle behind ``build_plan`` and the
quasi-static control plane (:mod:`repro_torch.noc.ctrl`).  Slice 10
adds the paper's other routing algorithms (YX, O1TURN, VALIANT, ROMM,
odd-even) and trace replay (``run_trace_sweep``, ``clos_leaf_trace``).
Slice 13 adds ML collective traffic from recorded post-SPMD HLO
(:mod:`repro_torch.noc.mltraffic`) and the dense LM family.  The
planner's possibility passes and the simulator's flit step are
hand-written CUDA kernels (:mod:`repro_torch.kernels`).  The package
imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
