"""Plain-torch flit step: the CPU path and the CUDA kernel's yardstick.

The reference's per-cycle transition (``repro.kernels.simstep.ref``)
split into the same two parts, lane-batched (a leading lane axis ``L``
on every state tensor; the tables are shared by all lanes):

* ``tile_fn`` — stages 1–6 for one node tile: packet generation,
  source-queue push, flit injection, table-routed port selection,
  eligibility, round-robin switch allocation, pops, locks and
  ``out_held``.  It reads other nodes' state only through ``fs_pre``,
  the snapshot of ``fifo_size`` taken before the cycle, and emits the
  ``mov`` record per (node, output port) plus integer partial sums.
* ``finish_fn`` — the receive-side pushes from ``mov`` and the
  statistics.

Both update the state dict **in place** (the CUDA kernel does too); a
caller that needs the old state keeps a copy.  A ``mov`` record of a
port that granted nothing is all zeros (the reference leaves the tile's
last input there; nothing reads it).

Everything else follows the reference operation for operation (the
same op order, dtypes, clip and sentinel conventions), so the states
match it bit for bit.  Gathers clamp their indices as XLA's do.
``rbits`` is carried as int32 holding the uint32 bit pattern; its
arithmetic runs in int64 masked to 32 bits, since torch on the CPU has
no uint32 add or shift.

Every routing algorithm of the reference runs here: XY and YX, O1TURN,
the two-phase VALIANT and ROMM (a packet routes to its intermediate
node, then on to its destination, the phase bit flipping on the way),
odd-even adaptive routing and BiDOR.  So do the stall watchdog
(:mod:`repro_torch.noc.watchdog`: the generation throttle and stall ages
in ``tile_fn``, the escape hop, the trips and the livelock throttle's
set in ``finish_fn``) and the telemetry rings
(:mod:`repro_torch.obs.probe`, in ``finish_fn``), each only where the
config switches it on.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import prng
from ...obs.probe import resolved_epoch
from ...noc.simconfig import (Algo, SimConfig, NF, F_SRC, F_DST, F_INTER,
                              F_SEQ, F_TIME, F_HOPS, F_ORDER, F_HEAD, F_TAIL,
                              F_PHASE, Q_DST, Q_INTER, Q_ORDER, Q_TIME, Q_SEQ,
                              check_topology)

_BIG = 1 << 30
MASK32 = 0xFFFFFFFF

# tile_fn's ``mov`` record per (node, out-port): the NF flit words of the
# granted winner, its routing decision (op, ov, route_phase) and the grant
MOV_W = NF + 4
# the tile's integer partial sums, in the reference's layout (the stall
# trips stay 0 with the watchdog off)
N_PART = 5
(PART_GEN, PART_PUSH, PART_SHED, PART_INJ, PART_STALL) = range(N_PART)


def _dev_keys(k: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(k, np.uint32).astype(np.int64),
                           device=device)


def algo_draws(algo: Algo, km: np.ndarray, n: int, ndim: int,
               device) -> dict:
    """The draws an algorithm takes from the metadata key ``km``
    ((..., 2) uint32), hashed on ``device``: ``k1, k2, k3 = split(km, 3)``,
    then O1TURN ``ob = bernoulli(k1, 0.5, (n,))`` (bool), VALIANT
    ``ri = randint(k2, (n,), 0, n)`` (int32), ROMM
    ``ur = uniform(k3, (n, ndim))`` (float32); nothing for XY, YX,
    ODDEVEN and BIDOR.  Each has the leading axes of ``km``."""
    algo = Algo(algo)
    if algo not in (Algo.O1TURN, Algo.VALIANT, Algo.ROMM):
        return {}
    k = prng.split(km, 3)
    if algo == Algo.O1TURN:
        u = prng.uniform_torch(_dev_keys(k[..., 0, :], device), n)
        return {"ob": u < 0.5}
    if algo == Algo.VALIANT:
        s = prng.split(k[..., 1, :], 2)
        hi = prng.random_bits_torch(_dev_keys(s[..., 0, :], device), n)
        lo = prng.random_bits_torch(_dev_keys(s[..., 1, :], device), n)
        return {"ri": prng.randint_from_bits(hi, lo, 0, n).to(torch.int32)}
    u = prng.uniform_torch(_dev_keys(k[..., 2, :], device), n * ndim)
    return {"ur": u.view(u.shape[:-1] + (n, ndim))}


def split_rand(key, algo: Algo, n: int, ndim: int, device="cpu"):
    """Advance the PRNG key by exactly one cycle, as the reference does.

    ``key`` is a (2,) or (L, 2) uint32 array.  One 5-way split, then the
    ``u`` and ``ud`` uniforms of the generation and destination keys and
    the algorithm's draws from the metadata key ``km``
    (:func:`algo_draws`).  Returns ``(new_key, rand)``, the draws as
    tensors on ``device``.  The chunk runner uses :func:`draw_chunk`,
    which yields the same bits for many cycles at once."""
    ks = prng.split(key, 5)
    new_key, kg, kd, km = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :], \
        ks[..., 3, :]
    rand = {"u": torch.as_tensor(prng.uniform(kg, n), device=device),
            "ud": torch.as_tensor(prng.uniform(kd, n), device=device)}
    rand.update(algo_draws(algo, km, n, ndim, device))
    return new_key, rand


def draw_chunk(keys: np.ndarray, cycles: int, n: int, device,
               algo: Algo = Algo.XY, ndim: int = 2):
    """The draws of ``cycles`` consecutive cycles for every lane:
    ``(new_keys (L, 2), rand)``, ``rand`` holding ``u`` and ``ud``
    (cycles, L, n) and the algorithm's draws (:func:`algo_draws`) with
    the same leading axes.  The key chain advances on the host
    (:func:`repro_torch.prng.chain_keys`); the draws are hashed on
    ``device`` in bulk."""
    new_keys, kg, kd, km = prng.chain_keys(keys, cycles)
    both = torch.as_tensor(np.stack([kg, kd], 0).astype(np.int64),
                           device=device)
    draws = prng.uniform_torch(both, n)          # (2, cycles, L, n)
    rand = {"u": draws[0], "ud": draws[1]}
    rand.update(algo_draws(algo, km, n, ndim, device))
    return new_keys, rand


def node_uniform(kg, n, num_nodes: int) -> np.ndarray:
    """``uniform(kg, num_nodes)[n]`` computed for node ``n`` alone, as
    the card's kernels do: one threefry2x32 block per node
    (:func:`repro_torch.prng.bits_at`).  ``kg`` is a (..., 2) uint32 key
    and ``n`` an int array that broadcasts against its leading axes;
    returns float32."""
    return prng._bits_to_unit(prng.bits_at(kg, n, num_nodes))


def node_draws(algo: Algo, km, n, num_nodes: int, ndim: int) -> dict:
    """:func:`algo_draws` for node ``n`` alone, as the card's kernels
    hash them where a packet is pushed: O1TURN one block of ``k1``;
    VALIANT one block of each of the two keys ``split(k2)`` (the split
    made once a cycle); ROMM the ``ndim`` entries ``ndim·n + d`` of the
    flat ``(N, ndim)`` count, one block each.  Arguments broadcast as in
    :func:`node_uniform`; returns numpy arrays."""
    algo = Algo(algo)
    n = np.asarray(n, np.int64)
    k = prng.split(km, 3)
    if algo == Algo.O1TURN:
        return {"ob": node_uniform(k[..., 0, None, :], n, num_nodes) < 0.5}
    if algo == Algo.VALIANT:
        s = prng.split(k[..., 1, :], 2)
        hi = prng.bits_at(s[..., 0, None, :], n, num_nodes)
        lo = prng.bits_at(s[..., 1, None, :], n, num_nodes)
        return {"ri": prng.randint_from_bits(hi, lo, 0, num_nodes)
                .astype(np.int32)}
    if algo == Algo.ROMM:
        e = n[..., None] * ndim + np.arange(ndim)
        bits = prng.bits_at(k[..., 2, None, None, :], e, num_nodes * ndim)
        return {"ur": prng._bits_to_unit(bits)}
    return {}


def reorder_occupancy(rbits: torch.Tensor) -> torch.Tensor:
    """Set reorder bits per (lane, node): the full scan of each node's
    row of the (L, N, N) ``rbits`` (uint32 patterns in int32), as the
    plain ``finish_fn`` takes it every measured cycle; int64 (L, N)."""
    return popcount32(rbits.long() & MASK32).sum(-1)


def reorder_occupancy_update(occ: torch.Tensor, old_word: torch.Tensor,
                             new_word: torch.Tensor) -> torch.Tensor:
    """The chunk kernel's O(1) update of :func:`reorder_occupancy`: a
    tail ejection rewrites one word of its node's row (at the packet's
    source), so the node's count moves by popc(new) − popc(old).
    ``old_word``/``new_word`` are (L, N) words at that position (equal
    where nothing was ejected)."""
    return (occ + popcount32(new_word.long() & MASK32)
            - popcount32(old_word.long() & MASK32))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def receiver_free(t, fs_pre: torch.Tensor, nodes: torch.Tensor, v: int,
                  b: int) -> torch.Tensor:
    """Odd-even's credits: for each of ``nodes``, the free slots of the
    ``v`` receive FIFOs behind each of its ports in the pre-cycle
    snapshot ``fs_pre`` (L, NIN): (L, len(nodes), P, V).  A port without
    a neighbour (−1) reads index (−P + rp)·V + k, which the reference's
    indexing wraps by NIN, then clamps; the turn rules keep its value
    from deciding a route."""
    nin, p = fs_pre.shape[1], t.neighbor.shape[1]
    base = (t.neighbor[nodes] * p + t.recv_port[nodes]) * v     # (n, P)
    idx = base[..., None] + torch.arange(v, device=base.device)
    idx = torch.where(idx < 0, idx + nin, idx).clamp(0, nin - 1)
    li = torch.arange(fs_pre.shape[0], device=fs_pre.device)
    return b - fs_pre[li[:, None, None, None], idx[None]]


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) → int32 with the same bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def make_cycle_parts(meta: dict, cfg: SimConfig):
    """``(tile_fn, finish_fn)`` over lane-batched torch state.

    ``tile_fn(t, state, rand, fs_pre, cycle, node0, tn) -> (mov, parts)``
        runs stages 1–6 for nodes ``[node0, node0 + tn)`` and their
        inputs, in place; ``rand`` is one cycle's draws (``u``, ``ud``
        (L, N) and the algorithm's, :func:`algo_draws`), ``fs_pre`` the
        (L, NIN) pre-cycle ``fifo_size`` snapshot, ``cycle`` the
        in-chunk cycle index.  ``mov`` is (L, tn, P, MOV_W) int32,
        ``parts`` (L, N_PART) int32.
    ``finish_fn(t, state, mov, parts, cycle) -> None``
        the receive pushes and statistics over the whole network, in
        place; ``mov`` is (L, N, P, MOV_W), ``parts`` summed over tiles.
    """
    check_topology(cfg, meta["NDIM"])
    algo = Algo(cfg.algo)
    n, p, v, nin = meta["N"], meta["P"], meta["V"], meta["NIN"]
    p_local = meta["P_LOCAL"]
    num_orders = meta["O"]
    b, q, l = cfg.buf_per_vc, cfg.src_queue_pkts, cfg.packet_len
    pv = p * v
    two_phase = algo in (Algo.VALIANT, Algo.ROMM)
    watchdog = bool(cfg.watchdog)
    tel_epoch = resolved_epoch(cfg)          # 0: telemetry off
    i32 = torch.int32

    def gen_metadata(t, rand, na, ns_, dst):
        """Per-algorithm (order, inter) of the packets generated at nodes
        ``na`` (absolute ids) toward ``dst`` (L, tn)."""
        if algo == Algo.YX:
            order = torch.full_like(dst, num_orders - 1, dtype=i32)
        elif algo == Algo.O1TURN:
            order = torch.where(rand["ob"][:, ns_], num_orders - 1,
                                0).to(i32)
        elif algo == Algo.BIDOR:
            order = t.choice[na[None, :], dst]
        else:
            order = torch.zeros_like(dst, dtype=i32)
        if algo == Algo.VALIANT:
            inter = rand["ri"][:, ns_]
        elif algo == Algo.ROMM:
            cs, cd = t.coords[na][None], t.coords[dst]       # (.., ndim)
            lo, hi = torch.minimum(cs, cd), torch.maximum(cs, cd)
            # a float32 product, truncated toward zero
            ic = lo + (rand["ur"][:, ns_] * (hi - lo + 1).to(
                torch.float32)).to(i32)
            ic = torch.minimum(torch.maximum(ic, lo), hi)
            inter = (ic * t.strides).sum(-1).to(i32)
        else:
            inter = torch.full_like(dst, -1, dtype=i32)
        return order, inter

    def oddeven_route(t, cur, src, target, free_port):
        """Chiu's minimal adaptive odd-even ROUTE and credit-based
        selection, ports 0 = +x, 1 = −x, 2 = +y, 3 = −y; (L, NIN_T)."""
        cx = t.coords[cur, 0]
        sx = t.coords[src, 0]
        tx = t.coords[target, 0]
        dx = tx - cx
        dy = t.coords[target, 1] - t.coords[cur, 1]
        y_port = torch.where(dy > 0, 2, 3)
        east_ok = (dx > 0) & ((dy == 0) | (tx % 2 == 1) | (dx != 1))
        y_ok_east = (dx > 0) & (dy != 0) & ((cx % 2 == 1) | (cx == sx))
        west_ok = dx < 0
        y_ok_west = (dx < 0) & (dy != 0) & (cx % 2 == 0)
        y_ok_straight = (dx == 0) & (dy != 0)
        x_port = torch.where(dx > 0, 0, 1)
        x_ok = east_ok | west_ok
        y_ok = y_ok_east | y_ok_west | y_ok_straight
        fx = free_port.gather(-1, x_port[..., None])[..., 0]
        fy = free_port.gather(-1, y_port[..., None])[..., 0]
        prefer_y = y_ok & (~x_ok | (fy > fx))
        return torch.where(prefer_y, y_port, x_port)

    def tile_fn(t, st, rand, fs_pre, cycle, node0, tn):
        u, ud = rand["u"], rand["ud"]
        dev = u.device
        lanes = u.shape[0]
        li = torch.arange(lanes, device=dev)[:, None]        # (L, 1)
        nl = torch.arange(tn, device=dev)
        na = node0 + nl                                      # absolute ids
        ns_ = slice(node0, node0 + tn)
        is_ = slice(node0 * pv, (node0 + tn) * pv)
        nin_t = tn * pv
        cyc = st["cycle0"] + cycle                           # (L,)

        # ---------------- 1. packet generation (open loop) -------------- #
        uu, udd = u[:, ns_], ud[:, ns_]
        rate_l = st["rate"] / torch.full_like(st["rate"], float(l))
        gen = ((uu < t.p_gen[ns_][None, :] * rate_l[:, None])
               & (cyc < st["inject_until"])[:, None])
        if watchdog:
            # the livelock throttle masks generation only (the draws are
            # made as before); its set, from moving flits, is finish_fn's
            thr = st["wd_throttle"][:, ns_]
            gen = gen & (thr <= 0)
            st["wd_throttle"][:, ns_] = torch.clamp(thr - 1, min=0)
        raw_dst = (t.cdf[ns_][None] <= udd[:, :, None]).sum(-1)
        dst = torch.clamp(raw_dst, 0, n - 1)                 # (L, tn) int64
        order, inter = gen_metadata(t, rand, na, ns_, dst)
        q_size = st["q_size"][:, ns_].clone()
        q_start = st["q_start"][:, ns_].clone()
        space = q_size < q
        push = gen & space
        seq = st["next_seq"][li, na, dst]
        st["next_seq"][li, na, dst] = seq + push.to(i32)
        slot = (q_start + q_size) % q
        qrec = torch.stack([dst.to(i32), inter, order.to(i32),
                            cyc[:, None].expand(lanes, tn).to(i32),
                            seq], -1)
        old = st["qpkts"][li, na, slot]
        st["qpkts"][li, na, slot] = torch.where(push[..., None], qrec, old)
        q_size = q_size + push.to(i32)

        # ---------------- 2. flit injection (1/cycle/node) -------------- #
        hs = q_start
        hpkt = st["qpkts"][li, na, hs]                       # (L, tn, NQ)
        h_dst, h_inter = hpkt[..., Q_DST], hpkt[..., Q_INTER]
        h_order, h_seq, h_time = hpkt[..., Q_ORDER], hpkt[..., Q_SEQ], \
            hpkt[..., Q_TIME]
        prog = st["prog"][:, ns_].clone()
        fl_head = prog == 0
        fl_tail = prog == l - 1
        phase0 = (h_inter < 0) | (h_inter == na)
        if algo in (Algo.XY, Algo.YX):
            vc_in = (na + h_dst) % v
        elif algo in (Algo.O1TURN, Algo.BIDOR):
            vc_in = h_order % v
        elif two_phase:
            vc_in = phase0.to(i32) % v
        else:   # odd-even: the local VC with the most space, first minimum
            local = (na * p + p_local) * v
            sizes = st["fifo_size"][li[..., None],
                                    local[:, None] + torch.arange(
                                        v, device=dev)]
            vc_in = sizes.argmin(-1)
        lf_idx = (na * p + p_local) * v + vc_in              # absolute
        lf_size = st["fifo_size"][li, lf_idx]
        can = (q_size > 0) & (lf_size < b)
        inj_rec = torch.stack(
            [na.expand(lanes, tn).to(i32), h_dst, h_inter, h_seq, h_time,
             torch.zeros_like(h_dst), h_order, fl_head.to(i32),
             fl_tail.to(i32), phase0.to(i32)], -1)
        fslot = (st["fifo_start"][li, lf_idx] + lf_size) % b
        old = st["flits"][li, lf_idx, fslot]
        st["flits"][li, lf_idx, fslot] = torch.where(can[..., None],
                                                     inj_rec, old)
        st["fifo_size"][li, lf_idx] = lf_size + can.to(i32)
        prog = torch.where(can, prog + 1, prog)
        done = can & (prog >= l)
        st["prog"][:, ns_] = torch.where(done, 0, prog)
        st["q_start"][:, ns_] = torch.where(done, (hs + 1) % q, hs)
        st["q_size"][:, ns_] = q_size - done.to(i32)

        # ---------------- 3. head-of-line + routing --------------------- #
        ii = torch.arange(node0 * pv, (node0 + tn) * pv, device=dev)
        st_ = st["fifo_start"][:, is_].clone()
        g_all = st["flits"][li, ii, st_]                     # (L, NIN_T, NF)
        valid = st["fifo_size"][:, is_] > 0
        n_of = t.n_of[is_]
        route_phase = ((g_all[..., F_PHASE] != 0) | (g_all[..., F_INTER] < 0)
                       | (g_all[..., F_INTER] == n_of))
        target = torch.where(route_phase, g_all[..., F_DST],
                             g_all[..., F_INTER])
        target = torch.clamp(target, 0, n - 1)
        at_dest = target == n_of
        lock_op = st["lock_op"][:, is_].clone()
        lock_ov = st["lock_ov"][:, is_].clone()
        locked = lock_op >= 0
        g_order = g_all[..., F_ORDER]
        nli = torch.arange(nin_t, device=dev) // pv
        if algo == Algo.ODDEVEN:
            # (L, NIN_T, P, V): the credits behind each port of its node
            free_pv = receiver_free(t, fs_pre, na, v, b)[:, nli]
            op_route = oddeven_route(
                t, n_of, torch.clamp(g_all[..., F_SRC], 0, n - 1), target,
                free_pv.sum(-1))
            # the freer VC at the chosen port, a held one scored −1
            held = st["out_held"][li, n_of, op_route] >= 0   # (L, NIN_T, V)
            f = free_pv.gather(2, op_route[..., None, None].expand(
                lanes, nin_t, 1, v))[:, :, 0]
            ov_route = torch.where(held, -1, f).argmax(-1)
        else:
            if algo in (Algo.XY, Algo.VALIANT, Algo.ROMM):
                eff_order = torch.zeros_like(g_order)
            elif algo == Algo.YX:
                eff_order = torch.full_like(g_order, num_orders - 1)
            else:
                eff_order = torch.clamp(g_order, 0, num_orders - 1)
            op_route = t.port[eff_order, n_of, target]
            if algo in (Algo.XY, Algo.YX):
                ov_route = t.v_of[is_].expand(lanes, nin_t)
            elif two_phase:
                ov_route = route_phase.to(i32) % v
            else:
                ov_route = g_order % v
        op = torch.where(at_dest, p_local, op_route)
        ov = torch.where(at_dest, 0, ov_route)
        op = torch.where(locked, lock_op, op)
        ov = torch.where(locked, lock_ov, ov)
        stall = None
        if watchdog:
            # a head stalled past the threshold escapes by one hop of the
            # escape table, on the highest VC
            stall = st["wd_stall"][:, is_].clone()
            esc = ((stall >= cfg.wd_stall_cycles) & valid
                   & (g_all[..., F_HEAD] != 0) & ~locked & ~at_dest)
            op = torch.where(esc, t.esc_port[n_of, target], op)
            ov = torch.where(esc, v - 1, ov)

        # ---------------- 4. eligibility -------------------------------- #
        is_eject = op == p_local
        clip_op = torch.clamp(op, 0, p - 1)
        nei = t.neighbor[n_of, clip_op]
        rp = t.recv_port[n_of, clip_op]
        recv_idx = (nei * p + rp) * v + ov
        has_credit = is_eject | (
            fs_pre[li, torch.clamp(recv_idx, 0, nin - 1)] < b)
        vc_free = st["out_held"][li, n_of, clip_op,
                                 torch.clamp(ov, 0, v - 1)] == -1
        needs_alloc = (g_all[..., F_HEAD] != 0) & ~locked & ~is_eject
        cycf = cyc.to(torch.float32)[:, None]
        chan_live = (torch.floor((cycf + 1.0) * t.chan_bw[None])
                     - torch.floor(cycf * t.chan_bw[None])) >= 1.0
        chan_live = torch.cat(                  # sentinel: no channel
            [chan_live, torch.zeros((lanes, 1), dtype=torch.bool,
                                    device=dev)], 1)
        chan_ok = is_eject | chan_live[li, t.chan_of[n_of, clip_op]]
        elig = valid & has_credit & chan_ok & (vc_free | ~needs_alloc)

        # ---------------- 5. switch allocation (round-robin) ------------ #
        in_local = torch.arange(nin_t, device=dev) % pv
        elig2 = elig.view(lanes, tn, pv)
        op2 = op.view(lanes, tn, pv)
        ports = torch.arange(p, device=dev)
        mask_po = elig2[..., None] & (op2[..., None] == ports)
        rr = st["rr"][:, ns_].clone()
        score = (torch.arange(pv, device=dev)[None, None, :, None]
                 - rr[:, :, None, :]) % pv
        score = torch.where(mask_po, score, _BIG)          # (L, tn, PV, P)
        win = score.argmin(2).to(i32)                       # first minimum
        ok = score.amin(2) < _BIG
        grants = torch.where(ok, win, -1)                   # (L, tn, P)
        st["rr"][:, ns_] = torch.where(ok, (win + 1) % pv, rr)

        # ---------------- 6. move granted flits (tile part) ------------- #
        granted = grants >= 0
        popped = elig & (grants[li, nli, clip_op] == in_local)
        win_flat = torch.where(granted, nl[:, None] * pv + grants, 0)
        g_ext = torch.cat([g_all, op[..., None].to(i32),
                           ov[..., None].to(i32),
                           route_phase[..., None].to(i32)], -1)
        w_ext = g_ext[li, win_flat.view(lanes, -1)].view(lanes, tn, p,
                                                          NF + 3)
        w_ext = torch.where(granted[..., None], w_ext, 0)
        st["fifo_start"][:, is_] = torch.where(popped, (st_ + 1) % b, st_)
        st["fifo_size"][:, is_] -= popped.to(i32)
        head, tail = g_all[..., F_HEAD] != 0, g_all[..., F_TAIL] != 0
        set_lock = popped & head & ~tail
        clr_lock = popped & tail
        st["lock_op"][:, is_] = torch.where(
            set_lock, op, torch.where(clr_lock, -1, lock_op)).to(i32)
        st["lock_ov"][:, is_] = torch.where(
            set_lock, ov, torch.where(clr_lock, -1, lock_ov)).to(i32)
        w_op = w_ext[..., NF]
        net = granted & (w_op != p_local)
        w_head = w_ext[..., F_HEAD] != 0
        w_tail = w_ext[..., F_TAIL] != 0
        w_ov = w_ext[..., NF + 1]
        hold_set = granted & w_head & ~w_tail & net
        hold_clr = granted & w_tail & net
        vmask = ((hold_set | hold_clr)[..., None]
                 & (torch.arange(v, device=dev) == w_ov[..., None]))
        hold_val = torch.where(hold_set, grants, -1)
        st["out_held"][:, ns_] = torch.where(vmask, hold_val[..., None],
                                             st["out_held"][:, ns_])

        trips = torch.zeros(lanes, dtype=torch.int64, device=dev)
        if watchdog:
            new_stall = torch.where(valid & ~popped, stall + 1, 0).to(i32)
            trips = (new_stall == cfg.wd_stall_cycles).sum(1)
            st["wd_stall"][:, is_] = new_stall

        mov = torch.cat([w_ext, granted[..., None].to(i32)], -1)
        parts = torch.stack([gen.sum(1), push.sum(1), (gen & ~space).sum(1),
                             can.sum(1), trips], 1).to(i32)
        return mov, parts

    def finish_fn(t, st, mov, parts, cycle):
        dev = mov.device
        lanes = mov.shape[0]
        li = torch.arange(lanes, device=dev)[:, None]
        n_ar = torch.arange(n, device=dev)
        cyc = st["cycle0"] + cycle
        measuring = (cyc >= cfg.warmup) & (cyc < st["measure_until"])
        st["meas_cnt"] += measuring.to(i32)
        st["offered"] += torch.where(measuring, parts[:, PART_GEN], 0)
        st["dropped"] += torch.where(measuring, parts[:, PART_SHED], 0)
        st["injected"] += parts[:, PART_INJ]

        # ------------- 6b. receive-side pushes (cross-tile) ------------- #
        granted = mov[..., NF + 3] != 0                     # (L, N, P)
        w_all = mov[..., :NF]
        w_op, w_ov, w_phase = mov[..., NF], mov[..., NF + 1], mov[..., NF + 2]
        net = granted & (w_op != p_local)
        cop = torch.clamp(w_op, 0, p - 1)
        dest_idx = ((t.neighbor[n_ar[:, None], cop] * p
                     + t.recv_port[n_ar[:, None], cop]) * v + w_ov)
        push_rec = w_all.clone()
        push_rec[..., F_HOPS] += 1
        push_rec[..., F_PHASE] = w_phase
        # one push per target input per cycle (one winner per channel):
        # slots come from the post-pop start and size.  Non-pushing
        # entries add 0 at a clamped index, so the accumulate never
        # disturbs a real push that lands there.
        idx = torch.clamp(torch.where(net, dest_idx, 0), 0, nin - 1).view(
            lanes, -1).long()
        okf = net.view(lanes, -1)
        slot = ((st["fifo_start"][li, idx] + st["fifo_size"][li, idx])
                % b).long()
        old = st["flits"][li, idx, slot]
        delta = torch.where(okf[..., None],
                            push_rec.view(lanes, -1, NF) - old, 0)
        li_e = li.expand_as(idx)
        st["flits"].index_put_((li_e, idx, slot), delta, accumulate=True)
        st["fifo_size"].index_put_((li_e, idx), okf.to(i32),
                                   accumulate=True)
        if watchdog:
            # the livelock throttle's set overrides tile_fn's decrement
            st["wd_trips"][:, 0] += parts[:, PART_STALL]
            hops_now = push_rec[..., F_HOPS]
            lv = net & (hops_now > cfg.wd_hop_limit)
            lv_src = w_all[..., F_SRC]
            lv_l = li[..., None].expand_as(lv_src)[lv]
            st["wd_throttle"][lv_l, lv_src[lv].long()] = cfg.wd_throttle_cycles
            st["wd_trips"][:, 1] += (
                net & (hops_now == cfg.wd_hop_limit + 1)).sum((1, 2)).to(i32)

        # ---------------- 7. statistics --------------------------------- #
        st["node_fwd"] += torch.where(measuring[:, None],
                                      granted.sum(2).to(i32), 0)
        on_chan = net[:, t.chan_src_n, t.chan_src_p]         # (L, C)
        st["chan_fwd"] += (on_chan & measuring[:, None]).to(i32)
        st["chan_seen"] += on_chan.to(i32)
        ej_n = granted[:, :, p_local]
        wl = mov[:, :, p_local, :]                           # (L, N, MOV_W)
        st["eject_total"] += ej_n.sum(1).to(i32)
        st["eject_flits"] += torch.where(measuring[:, None], ej_n.to(i32), 0)
        tail_ej = ej_n & (wl[..., F_TAIL] != 0)
        lat = (cyc[:, None] - wl[..., F_TIME]) + wl[..., F_HOPS] + 1
        lat_ok = tail_ej & (wl[..., F_TIME] >= cfg.warmup)
        lat0 = torch.where(lat_ok, lat, 0)
        st["lat_sum"] += lat0.sum(1).to(i32)     # wraps as int32 sums do
        st["lat_cnt"] += lat_ok.sum(1).to(i32)
        st["lat_max"].copy_(torch.maximum(st["lat_max"], lat0.amax(1)))
        lbin = torch.clamp(torch.div(lat, cfg.lat_bin_width,
                                     rounding_mode="floor"),
                           max=cfg.lat_bins - 1)
        hbin = torch.clamp(torch.where(lat_ok, lbin, 0), 0,
                           cfg.lat_bins - 1).long()
        st["lat_hist"].index_put_((li.expand_as(hbin), hbin),
                                  lat_ok.to(i32), accumulate=True)
        # reorder tracking (≤ 1 tail eject per node per cycle)
        te = tail_ej
        src_safe = torch.where(te, wl[..., F_SRC], 0).long()
        exp = st["exp_seq"][li, n_ar, src_safe]
        bits = st["rbits"][li, n_ar, src_safe].long() & MASK32
        off = wl[..., F_SEQ] - exp
        in_win = (off >= 0) & (off < 32)
        off_c = torch.clamp(off, 0, 31).long()
        bits2 = torch.where(te & in_win,
                            bits | (torch.ones_like(off_c) << off_c), bits)
        lowmask = bits2 & ~(bits2 + 1)          # trailing ones
        run = popcount32(lowmask)
        advance = te & ((bits2 & 1) == 1)
        exp2 = torch.where(advance, exp + run.to(i32), exp)
        run_c = torch.clamp(run, max=31)
        bits3 = torch.where(advance,
                            torch.where(run >= 32, 0, bits2 >> run_c),
                            bits2)
        st["exp_seq"][li, n_ar, src_safe] = torch.where(te, exp2, exp)
        st["rbits"][li, n_ar, src_safe] = torch.where(
            te, _to_i32_bits(bits3), st["rbits"][li, n_ar, src_safe])
        occ = popcount32(st["rbits"].long() & MASK32).sum(2) * l
        st["reorder_max"].copy_(torch.maximum(
            st["reorder_max"],
            torch.where(measuring, occ.amax(1), 0).to(i32)))

        # ---------------- 8. telemetry probes --------------------------- #
        if tel_epoch:
            slot = ((cyc // tel_epoch) % cfg.tel_slots).long()    # (L,)
            li1 = li[:, 0]
            st["tel_cycles"][li1, slot] += 1
            st["tel_chan"][li1, slot] += on_chan.to(i32)
            st["tel_counts"][li1, slot] += torch.stack(
                [parts[:, PART_GEN], parts[:, PART_PUSH],
                 parts[:, PART_SHED], tail_ej.sum(1).to(i32)], 1)
            nb = cfg.tel_occ_bins
            obin = torch.clamp(
                st["q_size"].sum(1) * nb // (n * cfg.src_queue_pkts),
                max=nb - 1)
            st["tel_qocc"][li1, slot, obin] += 1
            lat_l = li.expand_as(lbin)[tail_ej]
            st["tel_lat"].index_put_(
                (lat_l, slot[lat_l], lbin[tail_ej].long()),
                torch.ones_like(lat_l, dtype=i32), accumulate=True)

    return tile_fn, finish_fn


def make_cycle_fn(meta: dict, cfg: SimConfig):
    """``cycle_fn(t, state, rand, cycle)``: one whole cycle in place, the
    whole network as one tile — the plain composition the tiled paths
    are held against."""
    tile_fn, finish_fn = make_cycle_parts(meta, cfg)

    def cycle_fn(t, state, rand, cycle):
        fs_pre = state["fifo_size"].clone()
        mov, parts = tile_fn(t, state, rand, fs_pre, cycle, 0, meta["N"])
        finish_fn(t, state, mov, parts, cycle)

    return cycle_fn
