"""Flit-level NoC simulator on torch (lane-batched, table-routed).

The model is the reference's (paper §4.1): input-queued wormhole
routers, ``num_vcs`` virtual channels per input port, credit-based flow
control, one flit per channel per cycle, round-robin switch allocation,
single-cycle routing, every routing decision a gather over a
:class:`repro_torch.core.bidor.BiDORTable`.

What changes in the port:

* the (rate, seed) lanes that the reference ``vmap``s become a leading
  lane axis ``L`` on every state tensor; scalars become (L,) vectors and
  the tables are shared by all lanes;
* ``lax.scan`` over a chunk of cycles becomes one launch of the chunk
  kernel on the card (:mod:`repro_torch.kernels.simstep`), which runs
  the key chain, the draws and every cycle there, the state updated in
  place; on the CPU the chunk's draws are made up front
  (:func:`repro_torch.kernels.simstep.draw_chunk`) and the plain twin
  runs cycle by cycle, bit-identical to the reference's per-cycle
  ``split_rand``;
* the PRNG key of each lane is a (2,) uint32 row of ``state["key"]``, a
  numpy array on the host, copied to the card and back once a chunk;
* the reference's ``shard_map`` lane split over a ("lane",) device mesh
  (``get_runner(multi_device=)``) is :class:`LaneGroups`: contiguous
  blocks of lanes, one a device, each with its own copy of the tables,
  every block's chunk launched before any is read back.  Lanes are
  independent, so the split is bit for bit the one-device run
  (:func:`lane_devices` chooses it as the reference does).

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..core.bidor import BiDORTable, dor_table
from ..core.routes import dimension_orders, next_port_table
from ..core.topology import Topology
from ..device import resolve_device, resolve_devices
from ..obs.probe import Telemetry, telemetry_state
from .. import prng
from .simconfig import Algo, SimConfig, SimResult, NF, NQ
from .watchdog import WatchdogReport, watchdog_state

__all__ = ["Tables", "build_tables", "retarget_tables", "fresh_state",
           "LaneGroups", "lane_devices", "tables_to",
           "make_states", "point_key", "run_cycles", "run_sweep", "run_sim",
           "state_to_host", "state_from_host",
           "run_trace_sweep", "run_trace", "postprocess", "hist_percentile",
           "queue_occupancy", "source_queue_meta", "static_bw_slots"]

# an open-ended injection and measurement window (the reference's _BIG)
_BIG = 1 << 30


class Tables(NamedTuple):
    """Lookup tables of one cell (shared by every lane)."""

    port: torch.Tensor      # (O, N, N) int32: plan out-port (order, cur, target)
    choice: torch.Tensor    # (N, N) int32: plan order per (s, d)
    neighbor: torch.Tensor  # (N, P) int32
    recv_port: torch.Tensor  # (N, P) int32: input port at the neighbor
    cdf: torch.Tensor       # (N, N) float32 destination CDF per source
    p_gen: torch.Tensor     # (N,) float32 packet-generation probability @rate 1
    coords: torch.Tensor    # (N, ndim) int32
    strides: torch.Tensor   # (ndim,) int32: coord → node-id strides
    n_of: torch.Tensor      # (NIN,) node of each input
    v_of: torch.Tensor      # (NIN,) vc of each input
    chan_src_n: torch.Tensor  # (C,) source node of each channel
    chan_src_p: torch.Tensor  # (C,) output port of each channel at its source
    chan_of: torch.Tensor   # (N, P) int32: channel at (node, out-port); C if none
    chan_bw: torch.Tensor   # (C,) float32 relative bandwidth (0 = link down)
    # (N, N) int32: the watchdog's escape out-port (cur, target), the first
    # dimension order's routes, built from the topology alone, so it is
    # acyclic whatever plan was deployed; (0, 0) when built without it
    esc_port: torch.Tensor


def _gen_tables(topo: Topology, traffic) -> tuple[np.ndarray, np.ndarray]:
    """Per-source destination CDF and per-node generation probability at
    rate 1 (× rate / packet_len at run time), as float32."""
    t = np.asarray(traffic, np.float64)
    row = t.sum(1)
    with np.errstate(invalid="ignore"):
        cdf = np.cumsum(
            np.where(row[:, None] > 0,
                     t / np.maximum(row, 1e-300)[:, None], 0), 1)
    p_gen = row * topo.io_weights.sum()
    return cdf.astype(np.float32), p_gen.astype(np.float32)


def build_tables(topo: Topology, traffic: np.ndarray,
                 table: BiDORTable | None, num_vcs: int,
                 device=None, *, escape: bool = True) -> tuple[Tables, dict]:
    """Tables of one simulation cell, on ``device``.  ``table`` is the
    BiDOR plan's routing artifact; ``None`` routes over the trivial DOR
    artifact (:func:`repro_torch.core.bidor.dor_table`).  ``escape=False``
    leaves out the watchdog's escape table (an empty ``esc_port``): a cell
    with the watchdog off then pays neither its host DOR routes nor its
    N×N copy to the device."""
    dev = resolve_device(device)
    if table is None:
        table = dor_table(topo)
    n, p, v = topo.num_nodes, topo.num_ports, num_vcs
    port = np.asarray(table.port_tables, np.int32)
    if port.shape[1:] != (n, n):
        raise ValueError(f"port tables {port.shape} do not match {n} nodes")
    recv_port = np.zeros((n, p), np.int32)
    for c in range(topo.num_channels):
        u = int(topo.channels[c, 0])
        recv_port[u, topo.channel_port[c]] = topo.port_of_channel_at_receiver[c]
    cdf, p_gen = _gen_tables(topo, traffic)
    nin = n * p * v
    idx = np.arange(nin, dtype=np.int32)
    chan_of = np.full((n, p), topo.num_channels, np.int32)
    chan_of[topo.channels[:, 0], topo.channel_port] = np.arange(
        topo.num_channels, dtype=np.int32)
    arrays = dict(
        port=port, choice=np.asarray(table.choice, np.int32),
        neighbor=topo.neighbor_table.astype(np.int32), recv_port=recv_port,
        cdf=cdf, p_gen=p_gen, coords=topo.coords.astype(np.int32),
        strides=topo.coord_strides.astype(np.int32),
        n_of=idx // (p * v), v_of=idx % v,
        chan_src_n=topo.channels[:, 0].astype(np.int32),
        chan_src_p=topo.channel_port.astype(np.int32),
        chan_of=chan_of,
        chan_bw=np.asarray(topo.channel_bw, np.float32),
        esc_port=(next_port_table(topo, dimension_orders(topo.ndim)[0])
                  if escape else np.zeros((0, 0))).astype(np.int32))
    tables = Tables(**{k: torch.as_tensor(np.ascontiguousarray(a),
                                          device=dev)
                       for k, a in arrays.items()})
    meta = dict(N=n, P=p, V=v, NIN=nin, P_LOCAL=topo.port_local,
                NDIM=topo.ndim, O=port.shape[0], C=topo.num_channels)
    return tables, meta


def retarget_tables(tables: Tables, topo: Topology, *,
                    traffic: np.ndarray | None = None,
                    choice: np.ndarray | None = None,
                    channel_bw: np.ndarray | None = None) -> Tables:
    """Plan hot-swap: new :class:`Tables` with only the requested fields
    replaced, on the device of the old ones.

    Called between chunks only (:func:`run_cycles` draws a whole chunk
    against the tables it was given), so in-flight state is untouched:

    * ``traffic`` — new generation matrix (destination CDF and per-node
      injection probability are rebuilt; drift epochs);
    * ``choice`` — new BiDOR plan; only packets generated after the swap
      follow it, in-flight packets keep the order stamped at injection;
    * ``channel_bw`` — link fail / recover / degrade events.

    Passing nothing returns the same tables.
    """
    dev = tables.choice.device
    kw = {}
    if traffic is not None:
        cdf, p_gen = _gen_tables(topo, traffic)
        kw["cdf"] = torch.as_tensor(cdf, device=dev)
        kw["p_gen"] = torch.as_tensor(p_gen, device=dev)
    if choice is not None:
        kw["choice"] = torch.as_tensor(
            np.ascontiguousarray(choice, np.int32), device=dev)
    if channel_bw is not None:
        kw["chan_bw"] = torch.as_tensor(
            np.ascontiguousarray(channel_bw, np.float32), device=dev)
    return tables._replace(**kw) if kw else tables


def source_queue_meta(tables: Tables,
                      cfg: SimConfig) -> tuple[np.ndarray, float]:
    """(io_mask, qcap) for :func:`queue_occupancy`: compute once per cell."""
    io_mask = tables.p_gen.cpu().numpy() > 0
    qcap = float(io_mask.sum() * cfg.src_queue_pkts)
    return io_mask, qcap


def queue_occupancy(tables: Tables, cfg: SimConfig, q_size,
                    meta: tuple[np.ndarray, float] | None = None,
                    ) -> np.ndarray:
    """Per-lane source-queue occupancy fraction over the I/O-capable
    nodes — the campaign's lane-saturation criterion (0.0 when no node
    can source traffic)."""
    io_mask, qcap = source_queue_meta(tables, cfg) if meta is None else meta
    q = (q_size.cpu().numpy() if isinstance(q_size, torch.Tensor)
         else np.asarray(q_size))
    if qcap <= 0:
        return np.zeros(q.shape[0])
    return q[:, io_mask].sum(1) / qcap


def fresh_state(meta: dict, cfg: SimConfig, num_lanes: int,
                device=None) -> dict:
    """Lane-batched initial state: a dict of (L, ...) tensors plus the
    (L, 2) uint32 host ``key`` array (``PRNGKey(cfg.seed)`` per lane).
    The telemetry rings and the watchdog's arrays are there only when
    ``cfg`` switches them on."""
    dev = resolve_device(device)
    n, nin, L = meta["N"], meta["NIN"], num_lanes
    b, q = cfg.buf_per_vc, cfg.src_queue_pkts
    i32 = torch.int32

    def z(*shape):
        return torch.zeros((L,) + shape, dtype=i32, device=dev)

    def full(val, *shape):
        return torch.full((L,) + shape, val, dtype=i32, device=dev)

    return dict(
        **telemetry_state(meta, cfg, L, dev),
        **watchdog_state(meta, cfg, L, dev),
        flits=z(nin, b, NF),
        fifo_start=z(nin), fifo_size=z(nin),
        lock_op=full(-1, nin), lock_ov=full(-1, nin),
        out_held=full(-1, n, meta["P"], meta["V"]),
        rr=z(n, meta["P"]),
        qpkts=z(n, q, NQ),
        q_start=z(n), q_size=z(n), prog=z(n),
        next_seq=z(n, n),
        exp_seq=z(n, n), rbits=z(n, n),
        node_fwd=z(n), eject_flits=z(n), chan_fwd=z(meta["C"]),
        chan_seen=z(meta["C"]),
        lat_sum=z(), lat_cnt=z(), lat_max=z(),
        lat_hist=z(cfg.lat_bins),
        reorder_max=z(), injected=z(), offered=z(), dropped=z(),
        eject_total=z(), meas_cnt=z(),
        rate=torch.zeros(L, dtype=torch.float32, device=dev),
        cycle0=z(),
        inject_until=full(cfg.cycles - cfg.drain),
        measure_until=full(cfg.cycles - cfg.drain),
        key=np.tile(prng.key(cfg.seed), (L, 1)),
    )


def point_key(seed: int, rate: float) -> np.ndarray:
    """PRNG key of a (rate, seed) campaign point:
    ``fold_in(PRNGKey(seed), float32 bits of rate)``."""
    rate_bits = int(np.float32(rate).view(np.uint32))
    return prng.fold_in(prng.key(seed), rate_bits)


def make_states(meta: dict, cfg: SimConfig,
                points: list[tuple[float, int]], device=None) -> dict:
    """Fresh lane-batched state for a list of (rate, seed) points."""
    st = fresh_state(meta, cfg, len(points), device)
    st["rate"].copy_(torch.tensor([r for r, _ in points],
                                  dtype=torch.float32))
    st["key"] = np.stack([point_key(s, r) for r, s in points])
    return st


def run_cycles(tables: Tables, meta: dict, cfg: SimConfig, state: dict,
               num_cycles: int) -> dict:
    """Advance every lane by ``num_cycles`` cycles, in place (one chunk:
    on the card one kernel launch, on the CPU the plain twin cycle by
    cycle), the PRNG keys with them, then advance ``cycle0`` as the
    reference's chunk runner does.  Returns ``state``."""
    # deferred: the kernel package imports this package's simconfig
    from ..kernels.simstep import make_step

    step = make_step(meta, cfg, tables, state)
    state["key"] = step.run(num_cycles, state["key"])
    state["cycle0"] += num_cycles
    return state


def lane_devices(device, num_lanes: int,
                 multi_device: bool | None = None) -> tuple:
    """The devices a batch of ``num_lanes`` lanes runs on, one block of
    lanes a device: the reference's ``get_runner(multi_device=)``.
    ``device`` is what ``device.resolve_devices`` reads (default: every
    visible card; a sequence names the devices, the CPU or a card
    possibly more than once).  ``multi_device=True`` splits over them all
    and raises with one device or lanes that do not divide; ``False``
    keeps the first; ``None`` splits when there are several and the lanes
    divide."""
    devs = resolve_devices(device)
    ndev = len(devs)
    want = (multi_device if multi_device is not None
            else ndev > 1 and num_lanes % ndev == 0)
    if not want:
        return devs[:1]
    if ndev <= 1:
        raise ValueError("multi_device=True with a single device; on the "
                         "CPU name it several times, device=('cpu', "
                         "'cpu', ...)")
    if num_lanes % ndev:
        raise ValueError(
            f"multi_device=True needs the lane count to divide over the "
            f"devices ({num_lanes} lanes, {ndev} devices)")
    return devs


def tables_to(tables: Tables, device) -> Tables:
    """A copy of ``tables`` on ``device`` (the same tables where they are
    there already)."""
    dev = torch.device(device)
    if tables.choice.device == dev:
        return tables
    return Tables(*(t.to(dev) for t in tables))


class LaneGroups:
    """A lane batch split into contiguous blocks of lanes, one a device
    (the reference's ``PartitionSpec("lane")``; the rate-major lane
    order kept): each block holds its lanes' state, its PRNG keys and a
    copy of the tables on its device.  :meth:`run` launches every
    block's chunk, each on its own card, before reading any back, so the
    cards run at once; the reads (:meth:`read`, :meth:`to_host`) join
    the blocks in lane order.  One block is :func:`run_cycles` itself."""

    def __init__(self, tables: Tables, meta: dict, cfg: SimConfig,
                 states: list[dict]):
        self.meta, self.cfg, self.states = meta, cfg, states
        self.devices = [st["fifo_size"].device for st in states]
        self.tables = [tables_to(tables, d) for d in self.devices]
        self.sizes = [st["fifo_size"].shape[0] for st in states]

    @classmethod
    def fresh(cls, tables: Tables, meta: dict, cfg: SimConfig,
              points: list[tuple[float, int]], devices) -> "LaneGroups":
        """Fresh states of ``points`` (:func:`make_states`), split in
        order over ``devices`` (which divide them)."""
        per = len(points) // len(devices)
        return cls(tables, meta, cfg, [
            make_states(meta, cfg, points[i * per:(i + 1) * per], d)
            for i, d in enumerate(devices)])

    @classmethod
    def from_host(cls, tables: Tables, meta: dict, cfg: SimConfig,
                  host: dict, devices) -> "LaneGroups":
        """The groups of a host state (:func:`state_to_host`, all lanes),
        split in order over ``devices``: a state gathered on any device
        count resumes on any other."""
        lanes = len(np.asarray(host["key"]).reshape(-1, 2))
        per = lanes // len(devices)
        return cls(tables, meta, cfg, [
            state_from_host({k: np.asarray(v)[i * per:(i + 1) * per]
                             for k, v in host.items()}, d)
            for i, d in enumerate(devices)])

    def run(self, num_cycles: int) -> None:
        """Advance every lane by ``num_cycles`` cycles: each block's chunk
        launched on its own card (made current around the launch), then
        each block's keys read back."""
        from ..kernels.simstep import make_step

        steps = []
        for dev, tables, st in zip(self.devices, self.tables, self.states):
            with _current(dev):
                step = make_step(self.meta, self.cfg, tables, st)
                step.start(num_cycles, st["key"])
            steps.append(step)
        for step, st in zip(steps, self.states):
            st["key"] = step.finish()
            st["cycle0"] += num_cycles

    def read(self, key: str) -> np.ndarray:
        """State ``key`` of every lane, in lane order (numpy)."""
        return np.concatenate([np.asarray(st[key].cpu().numpy())
                               for st in self.states])

    def to_host(self) -> dict:
        """:func:`state_to_host` of every lane, in lane order."""
        hosts = [state_to_host(st) for st in self.states]
        return {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}

    def retarget(self, topo: Topology, **kw) -> None:
        """:func:`retarget_tables` on every block's tables (one swap a
        distinct table set)."""
        done: dict[int, Tables] = {}
        out = []
        for t in self.tables:
            if id(t) not in done:
                done[id(t)] = retarget_tables(t, topo, **kw)
            out.append(done[id(t)])
        self.tables = out

    def set_rate(self, rates) -> None:
        """Every lane's injection rate (lane order), float32."""
        r = np.asarray(rates, np.float32)
        at = 0
        for st, n in zip(self.states, self.sizes):
            st["rate"] = torch.tensor(r[at:at + n], dtype=torch.float32,
                                      device=st["rate"].device)
            at += n

    def synchronize(self) -> None:
        """Wait for every card that holds a block."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _current(dev: torch.device):
    """``dev`` made the current card (nothing on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def state_to_host(state: dict) -> dict:
    """numpy copy of a lane-batched state (``rbits`` as uint32)."""
    out = {}
    for k, x in state.items():
        if isinstance(x, torch.Tensor):
            a = x.cpu().numpy()
            out[k] = a.view(np.uint32) if k == "rbits" else a
        else:
            out[k] = np.array(x)
    return out


def state_from_host(host: dict, device=None) -> dict:
    """The inverse of :func:`state_to_host`: tensors on ``device`` from a
    numpy state (``rbits`` uint32 back to the int32 that holds its bits;
    ``key``, the (L, 2) uint32 PRNG keys, stays a numpy array)."""
    dev = resolve_device(device)
    out = {}
    for k, a in host.items():
        a = np.asarray(a)
        if k == "key":
            out[k] = np.array(a, np.uint32).reshape(-1, 2)
        elif k == "rbits":
            out[k] = torch.as_tensor(
                np.array(a, np.uint32, order="C").view(np.int32),
                device=dev)
        else:
            out[k] = torch.as_tensor(np.array(a, order="C"), device=dev)
    return out


def hist_percentile(hist: np.ndarray, bin_width: int, q: float) -> float:
    """q-quantile (0 < q < 1) from a fixed-width latency histogram, with
    linear interpolation inside the bin.  The last bin is an overflow
    bucket, so quantiles landing there are lower bounds."""
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total <= 0:
        return 0.0
    target = q * total
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, target))
    before = cum[b - 1] if b > 0 else 0.0
    frac = (target - before) / max(hist[b], 1.0)
    return float((b + frac) * bin_width)


def postprocess(o: dict, cfg: SimConfig, topo: Topology, *,
                rate: float, seed: int, saturated: bool = False,
                meas_cycles: int | None = None) -> SimResult:
    """Turn one lane's host state into a SimResult."""
    meas = int(o["meas_cnt"]) if meas_cycles is None else int(meas_cycles)
    meas = max(meas, 1)
    ports = float(topo.io_weights.sum())
    load = o["node_fwd"].astype(np.float64) / meas
    active = load[load > 1e-9]
    lat_cnt = max(int(o["lat_cnt"]), 1)
    bw = np.asarray(topo.channel_bw, np.float64)
    flits = o["chan_fwd"].astype(np.float64) / meas
    # dead (bw = 0) channels never forward, so 0/0 → 0 by convention
    link = flits / np.where(bw > 0, bw, 1.0)
    hist = o["lat_hist"]
    return SimResult(
        algo=Algo(cfg.algo), injection_rate=float(rate),
        throughput=int(o["eject_flits"].sum()) / meas / ports,
        offered=float(o["offered"]) / meas / ports,
        avg_latency=float(o["lat_sum"]) / lat_cnt,
        max_latency=float(o["lat_max"]),
        node_load=load,
        lcv=float(active.std() / active.mean()) if active.size else 0.0,
        reorder_value=int(o["reorder_max"]),
        ejected_flits=int(o["eject_total"]),
        injected_flits=int(o["injected"]),
        in_flight_flits=int(o["fifo_size"].sum()),
        seed=int(seed),
        meas_cycles=meas,
        saturated=bool(saturated),
        p50_latency=hist_percentile(hist, cfg.lat_bin_width, 0.50),
        p90_latency=hist_percentile(hist, cfg.lat_bin_width, 0.90),
        p99_latency=hist_percentile(hist, cfg.lat_bin_width, 0.99),
        link_load_max=float(link.max()) if link.size else 0.0,
    )


def lane(host: dict, i: int) -> dict:
    """Lane ``i`` of a host state."""
    return {k: v[i] for k, v in host.items()}


def static_bw_slots(topo: Topology, cfg: SimConfig) -> np.ndarray:
    """(tel_slots, C) bandwidth a telemetry slot of a run without fault
    events: the topology's channel bandwidths in every slot."""
    return np.broadcast_to(
        np.asarray(topo.channel_bw, np.float64),
        (int(cfg.tel_slots), topo.num_channels)).copy()


def run_sweep(topo: Topology, traffic: np.ndarray, cfg: SimConfig,
              rates: list[float], bidor_table: BiDORTable | None = None,
              seeds: list[int] | None = None, *,
              return_telemetry: bool = False, return_watchdog: bool = False,
              device=None):
    """All (rate, seed) points as lanes of one batch, rate-major:
    ``[(r, s) for r in rates for s in seeds]``.

    ``return_telemetry=True`` returns ``(results, telemetry)``: the
    lane-major :class:`repro_torch.obs.probe.Telemetry` (None when
    ``cfg.telemetry`` is off).  ``return_watchdog=True`` appends the
    all-lane :class:`repro_torch.noc.watchdog.WatchdogReport` (None when
    ``cfg.watchdog`` is off) as the last element."""
    table = None
    if cfg.algo == Algo.BIDOR:
        if bidor_table is None:
            raise ValueError("BIDOR needs a BiDORTable")
        table = bidor_table
    tables, meta = build_tables(topo, traffic, table, cfg.num_vcs, device,
                                escape=cfg.watchdog)
    points = [(r, s) for r in rates for s in (seeds or [cfg.seed])]
    state = make_states(meta, cfg, points, device)
    host = state_to_host(run_cycles(tables, meta, cfg, state, cfg.cycles))
    results = [postprocess(lane(host, i), cfg, topo, rate=r, seed=s)
               for i, (r, s) in enumerate(points)]
    extras: list = []
    if return_telemetry:
        tel = Telemetry.from_state(host, cfg)
        if tel is not None:
            tel = tel.with_bw(static_bw_slots(topo, cfg))
        extras.append(tel)
    if return_watchdog:
        extras.append(WatchdogReport.from_state(host, cfg))
    return (results, *extras) if extras else results


def run_sim(topo: Topology, traffic: np.ndarray, cfg: SimConfig,
            bidor_table: BiDORTable | None = None, *,
            return_telemetry: bool = False, return_watchdog: bool = False,
            device=None):
    """Run one simulation and post-process its statistics.  With
    ``return_telemetry`` and ``return_watchdog``, the
    :class:`~repro_torch.obs.probe.Telemetry` and the
    :class:`~repro_torch.noc.watchdog.WatchdogReport` (or None) follow
    the result, in that order."""
    out = run_sweep(topo, traffic, cfg, [cfg.injection_rate], bidor_table,
                    return_telemetry=return_telemetry,
                    return_watchdog=return_watchdog, device=device)
    if return_telemetry or return_watchdog:
        results, *extras = out
        return (results[0], *extras)
    return out[0]


def run_trace_sweep(topo: Topology,
                    segments: list[tuple[np.ndarray, float]],
                    cfg: SimConfig,
                    bidor_table: BiDORTable | None = None,
                    seeds: list[int] | None = None, *,
                    device=None) -> list[tuple[SimResult, list[float]]]:
    """Trace-driven simulation: piecewise-constant traffic epochs, the
    seeds as lanes of one batch (paper §4.3, Fig. 9).

    Each segment is ``(traffic_matrix, injection_rate)`` and runs
    ``cfg.cycles`` cycles; the network state carries across segments,
    and only the generation tables are swapped between them
    (:func:`retarget_tables`).  BiDOR's routing table stays fixed.  Lane
    ``i``'s key is ``fold_in(PRNGKey(seeds[i]), 0)``, and injection and
    measurement are open-ended, as in the reference.

    Returns, per seed, (SimResult over all measured cycles, the LCV of
    each segment's per-node forwarding counts).
    """
    table = None
    if cfg.algo == Algo.BIDOR:
        if bidor_table is None:
            raise ValueError("BIDOR needs a BiDORTable")
        table = bidor_table
    seeds = list(seeds or [cfg.seed])
    state = tables = meta = None
    lcvs: list[list[float]] = [[] for _ in seeds]
    prev_fwd = None
    for si, (tm, rate) in enumerate(segments):
        if tables is None:
            tables, meta = build_tables(topo, tm, table, cfg.num_vcs, device,
                                        escape=cfg.watchdog)
        else:
            tables = retarget_tables(tables, topo, traffic=tm)
        if state is None:
            state = fresh_state(meta, cfg, len(seeds), device)
            state["key"] = np.stack([prng.fold_in(prng.key(s), si)
                                     for s in seeds])
            state["inject_until"].fill_(_BIG)
            state["measure_until"].fill_(_BIG)
            prev_fwd = np.zeros((len(seeds), meta["N"]), np.int64)
        state["rate"].fill_(float(np.float32(rate)))
        run_cycles(tables, meta, cfg, state, cfg.cycles)
        fwd = state["node_fwd"].cpu().numpy().astype(np.int64)
        seg, prev_fwd = fwd - prev_fwd, fwd
        for bi in range(len(seeds)):
            active = seg[bi][seg[bi] > 0]
            if active.size:
                lcvs[bi].append(float(active.std() / active.mean()))
    host = state_to_host(state)
    mean_rate = float(np.mean([r for _, r in segments]))
    return [(postprocess(lane(host, bi), cfg, topo, rate=mean_rate,
                         seed=seeds[bi]), lcvs[bi])
            for bi in range(len(seeds))]


def run_trace(topo: Topology, segments: list[tuple[np.ndarray, float]],
              cfg: SimConfig, bidor_table: BiDORTable | None = None, *,
              device=None) -> tuple[SimResult, list[float]]:
    """Single-seed :func:`run_trace_sweep`: ``(SimResult, lcvs)``."""
    return run_trace_sweep(topo, segments, cfg, bidor_table,
                           device=device)[0]
