"""Simulator configuration (paper §4.1 defaults)."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Algo(enum.IntEnum):
    """Routing algorithms evaluated in the paper (§2.1 / §4.1)."""

    XY = 0        # deterministic DOR
    YX = 1        # deterministic DOR, reverse order
    O1TURN = 2    # oblivious: random XY/YX per packet [17]
    VALIANT = 3   # oblivious: random intermediate anywhere [20]
    ROMM = 4      # oblivious: random intermediate in MinRect [15]
    ODDEVEN = 5   # adaptive: odd-even turn model [1]
    BIDOR = 6     # Q-StaR: N-Rank-guided XY/YX choice (this paper)


# Packed flit-record layout: one (L, NIN, BUF, NF) int32 array per lane
# batch — a FIFO push or pop moves one contiguous NF-word record.  The
# layout is the JAX reference's, word for word, so states carry across
# (repro_torch.convert) and the CUDA flit-step kernel indexes the same
# records as its plain-torch twin.
NF = 10
(F_SRC, F_DST, F_INTER, F_SEQ, F_TIME,
 F_HOPS, F_ORDER, F_HEAD, F_TAIL, F_PHASE) = range(NF)
# Packed source-queue packet records: (N, Q, NQ) int32.
NQ = 5
(Q_DST, Q_INTER, Q_ORDER, Q_TIME, Q_SEQ) = range(NQ)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Cycle-level simulation parameters.

    Defaults mirror the paper's setup (§4.1): input-queued routers, wormhole
    flits, credit-based flow control, 2 VCs sharing a 64-flit input buffer,
    and a 2-cycle base hop latency (realized as 1 movement/cycle + 1 extra
    cycle per hop charged in latency accounting — identical across all
    algorithms, preserving every relative comparison).
    """

    algo: Algo = Algo.XY
    num_vcs: int = 2
    buf_per_vc: int = 32          # 64-flit input buffer shared by 2 VCs
    packet_len: int = 4           # flits per packet
    src_queue_pkts: int = 64      # per-node source queue (open loop)
    cycles: int = 12_000
    warmup: int = 4_000
    drain: int = 0                # trailing cycles with injection halted
    injection_rate: float = 0.1   # flits / cycle / I/O port
    seed: int = 0
    reorder_window: int = 32      # per-flow sequence tracking window
    lat_bins: int = 96            # latency histogram bins (percentiles)
    lat_bin_width: int = 8        # cycles per histogram bin; last = overflow
    # Kept for field-for-field parity with the reference configuration;
    # the port has one per-cycle transition (repro_torch.kernels.simstep),
    # so this flag selects nothing.
    use_kernel: bool = True
    # Node-tile size of the flit-step kernel (repro_torch.kernels.simstep):
    # the nodes of one CUDA block; with the chunk kernel a lane's blocks
    # form one cluster.  Must divide the node count; on the card it must
    # also fit the layout of the kernel the shape takes (chunk: at most 16
    # blocks a lane within a block's shared memory; grid: at most the 32
    # warps' worth of nodes a block carries a round, 96 at P·V = 10).
    # 0 = auto:
    # repro_torch.kernels.simstep.ops.resolve_path picks the tile from
    # the card's limits.  Every tile size gives bit-identical states.
    sim_tile_nodes: int = 0
    # In-sim telemetry probes (repro_torch.obs.probe)
    telemetry: bool = False
    tel_epoch: int = 0
    tel_slots: int = 64
    tel_occ_bins: int = 16
    # Stall watchdog (repro_torch.noc.watchdog)
    watchdog: bool = False
    wd_stall_cycles: int = 64
    wd_hop_limit: int = 64
    wd_throttle_cycles: int = 32

    def __post_init__(self):
        if self.warmup + self.drain >= self.cycles:
            raise ValueError(
                f"warmup ({self.warmup}) + drain ({self.drain}) leaves no "
                f"measurement window inside cycles ({self.cycles})")
        if self.sim_tile_nodes < 0:
            raise ValueError(
                f"sim_tile_nodes ({self.sim_tile_nodes}) must be >= 0")

    @property
    def measure(self) -> int:
        """Length of the measurement window (cycles)."""
        return self.cycles - self.warmup - self.drain

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Post-processed simulation statistics."""

    algo: Algo
    injection_rate: float
    throughput: float           # accepted flits / cycle / I/O port
    offered: float              # offered flits / cycle / I/O port
    avg_latency: float
    max_latency: float
    node_load: np.ndarray       # (N,) forwarding rate per node
    lcv: float                  # coefficient of variation of node loads
    reorder_value: int          # max reorder-buffer occupancy (flits)
    ejected_flits: int
    injected_flits: int
    in_flight_flits: int        # conservation check: injected = ejected + in flight
    seed: int = 0
    meas_cycles: int = 0        # cycles actually measured (early exit aware)
    saturated: bool = False     # campaign saturation detector verdict
    p50_latency: float = 0.0    # histogram-derived percentiles
    p90_latency: float = 0.0
    p99_latency: float = 0.0
    link_load_max: float = 0.0  # max per-channel load / bandwidth

    def summary(self) -> str:
        sat = " SAT" if self.saturated else ""
        return (f"{self.algo.name:8s} rate={self.injection_rate:.3f} "
                f"thr={self.throughput:.4f} lat={self.avg_latency:.1f} "
                f"p99={self.p99_latency:.0f} maxlat={self.max_latency:.0f} "
                f"lcv={self.lcv:.3f} reorder={self.reorder_value}{sat}")


def check_topology(cfg: SimConfig, ndim: int) -> None:
    """The reference's refusal of a routing algorithm on a topology:
    odd-even is a 2-D turn model."""
    if Algo(cfg.algo) == Algo.ODDEVEN and ndim != 2:
        raise ValueError("odd-even routing is a 2D turn model; "
                         f"topology has ndim={ndim}")
