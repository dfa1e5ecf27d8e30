"""Post-SPMD HLO analysis: per-device FLOPs, HBM bytes, collective bytes.

The reference's ``analysis/hlo.py`` (pure ``re``/``math``), text
analysis only.  XLA's own cost analysis counts a ``while`` body once,
but every scanned layer stack and flash-attention chunk loop of the
reference is a while loop; this module parses ``compiled.as_text()``
(per-device shapes, after partitioning), recovers while trip counts from
their condition computations, and propagates execution counts through
the call graph.

Accounting model (roofline-oriented):
  * FLOPs: ``dot`` ops — 2 · prod(result dims) · prod(contracting dims)
    (elementwise flops are ignored).
  * HBM bytes: per top-level instruction, operands + result, with
    slice-accurate special cases (dynamic-slice/gather read the slice, not
    the operand; dynamic-update-slice writes the update in place).  Fusion
    internals are not double counted: the fusion instruction's operands
    and result are the traffic (a perfectly fused executable).
  * Collectives: per-op bytes (max of result/operand estimate) + ring-wire
    bytes with the group size parsed from ``replica_groups``.

Not here (ROADMAP queue 1, item 11.7): ``xla_cost_analysis``, which reads
a JAX compiled object, and the roofline terms, which wait for the
H100's own peaks.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(r"^\s+(ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.+)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\(.*\))?\s*->.*{\s*$")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shape_bytes(text: str) -> int:
    """Total bytes of all shapes appearing in a type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _result_dims(text: str) -> tuple[str, list[int]] | None:
    m = _SHAPE_RE.search(text)
    if not m:
        return None
    dt, dims = m.groups()
    return dt, [int(d) for d in dims.split(",") if d]


@dataclasses.dataclass
class Instruction:
    name: str
    opcode: str
    result_type: str
    operands: list[str]
    attrs: str
    line: str


@dataclasses.dataclass
class Computation:
    name: str
    instructions: dict[str, Instruction]
    is_entry: bool = False


def _parse_operands(rest: str) -> tuple[list[str], str]:
    """Split `opcode(%a, %b), attr=...` into operand names and attrs."""
    depth = 0
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
            if depth == 1:
                start = i + 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                inner = rest[start:i]
                attrs = rest[i + 1:]
                ops = re.findall(r"%([\w\.\-]+)", inner)
                return ops, attrs
    return [], rest


def parse_hlo(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for line in text.splitlines():
        if line.endswith("{") and ("->" in line or line.startswith("ENTRY")):
            m = _COMP_RE.match(line.strip())
            name = None
            if m:
                name = m.group(1)
            else:
                m2 = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)", line.strip())
                name = m2.group(1) if m2 else f"comp{len(comps)}"
            cur = Computation(name=name, instructions={},
                              is_entry=line.strip().startswith("ENTRY"))
            comps[name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        root_kw, name, rhs = m.groups()
        # rhs = "TYPE opcode(...), attrs"
        om = re.match(r"((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:{[^}]*})?)+)\s+([\w\-]+)\(",
                      rhs)
        if not om:
            continue
        rtype, opcode = om.groups()
        rest = rhs[om.start(2):]
        ops, attrs = _parse_operands(rest[len(opcode):])
        cur.instructions[name] = Instruction(
            name=name, opcode=opcode, result_type=rtype,
            operands=ops, attrs=attrs,
            line=("ROOT " if root_kw else "") + line.strip())
    return comps


def _trip_count(cond: Computation) -> int:
    """Extract the while trip count from its condition computation."""
    consts = {}
    for ins in cond.instructions.values():
        if ins.opcode == "constant":
            m = re.search(r"constant\((-?\d+)\)", ins.line)
            if m:
                consts[ins.name] = int(m.group(1))
    # ROOT compare(%iv, %const), direction=LT
    for ins in cond.instructions.values():
        if ins.opcode == "compare" and "direction=LT" in ins.attrs:
            for op in ins.operands:
                if op in consts:
                    return max(consts[op], 1)
    if consts:
        return max(max(consts.values()), 1)
    return 1


def _group_size(attrs: str, default: int) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[(\d+)\]", attrs)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([0-9, ]+)\}", attrs)
    if m:
        return len(m.group(1).split(","))
    return default


def parse_replica_groups(attrs: str,
                         num_devices: int) -> tuple[tuple[int, ...], ...]:
    """Expand ``replica_groups`` to explicit device-id groups.

    Handles both printed forms:

    * iota form ``[G,S]<=[d0,d1,...]`` with an optional transpose
      ``T(p0,p1,...)`` — ``arange(prod(dims)).reshape(dims)``, transposed,
      then reshaped to (G, S) row groups;
    * explicit form ``{{0,1},{2,3}}``.

    An op with no ``replica_groups`` attribute (or an empty ``{}``)
    addresses every device: one group of ``range(num_devices)``.
    """
    m = re.search(
        r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?",
        attrs)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        ids = list(range(math.prod(dims)))
        if m.group(4):
            perm = [int(p) for p in m.group(4).split(",")]
            ids = list(np.arange(math.prod(dims)).reshape(dims)
                       .transpose(perm).reshape(-1))
        return tuple(tuple(int(ids[r * s + c]) for c in range(s))
                     for r in range(g))
    m = re.search(r"replica_groups=\{(\{[0-9, ]*\}(?:,\s*\{[0-9, ]*\})*)\}",
                  attrs)
    if m:
        groups = []
        for grp in re.findall(r"\{([0-9, ]*)\}", m.group(1)):
            ids = [int(x) for x in grp.replace(" ", "").split(",") if x]
            if ids:
                groups.append(tuple(ids))
        if groups:
            return tuple(groups)
    return (tuple(range(num_devices)),)


def parse_source_target_pairs(attrs: str) -> tuple[tuple[int, int], ...]:
    """``source_target_pairs={{0,1},{1,2}}`` → ((0, 1), (1, 2))."""
    m = re.search(
        r"source_target_pairs=\{(\{\d+,\s*\d+\}(?:,\s*\{\d+,\s*\d+\})*)\}",
        attrs)
    if not m:
        return ()
    return tuple(
        (int(a), int(b))
        for a, b in re.findall(r"\{(\d+),\s*(\d+)\}", m.group(1)))


_SKIP_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "after-all", "iota", "broadcast", "reshape",
             "transpose", "convert", "partition-id", "replica-id",
             "custom-call", "conditional", "opt-barrier", "rng-bit-generator"}


@dataclasses.dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0      # Σ per-op bytes (spec formula)
    collective_wire_bytes: float = 0.0  # ring-algorithm wire estimate
    collective_counts: dict = dataclasses.field(default_factory=dict)
    while_trip_counts: list = dataclasses.field(default_factory=list)

    def merged(self, other: "HloStats", mult: float) -> "HloStats":
        out = HloStats(
            flops=self.flops + mult * other.flops,
            hbm_bytes=self.hbm_bytes + mult * other.hbm_bytes,
            collective_bytes=self.collective_bytes
            + mult * other.collective_bytes,
            collective_wire_bytes=self.collective_wire_bytes
            + mult * other.collective_wire_bytes,
            collective_counts=dict(self.collective_counts),
            while_trip_counts=self.while_trip_counts
            + other.while_trip_counts,
        )
        for k, v in other.collective_counts.items():
            out.collective_counts[k] = out.collective_counts.get(k, 0) \
                + mult * v
        return out


def _instr_shape_dims(comp: Computation, name: str):
    ins = comp.instructions.get(name)
    if ins is None:
        return None
    return _result_dims(ins.result_type)


def analyze_computation(comps, comp: Computation, num_devices: int,
                        _memo) -> HloStats:
    if comp.name in _memo:
        return _memo[comp.name]
    stats = HloStats()
    for ins in comp.instructions.values():
        op = ins.opcode
        if op == "while":
            body = cond = None
            bm = re.search(r"body=%?([\w\.\-]+)", ins.attrs)
            cm = re.search(r"condition=%?([\w\.\-]+)", ins.attrs)
            if bm and bm.group(1) in comps:
                body = comps[bm.group(1)]
            if cm and cm.group(1) in comps:
                cond = comps[cm.group(1)]
            trips = _trip_count(cond) if cond else 1
            stats.while_trip_counts.append(trips)
            if body is not None:
                inner = analyze_computation(comps, body, num_devices, _memo)
                stats = stats.merged(inner, trips)
            continue
        if op == "fusion":
            fm = re.search(r"calls=%?([\w\.\-]+)", ins.attrs)
            fused = comps.get(fm.group(1)) if fm else None
            # traffic = operands + result, EXCEPT operands that the fused
            # computation only dynamic-slices: a scan body slicing one row
            # out of a loop-invariant array reads the slice, not the array
            in_bytes = 0.0
            sliced = _slice_only_param_bytes(fused) if fused else {}
            for oi, o in enumerate(ins.operands):
                if o not in comp.instructions:
                    continue
                full = _shape_bytes(comp.instructions[o].result_type)
                in_bytes += sliced.get(oi, full)
            out_bytes = _shape_bytes(ins.result_type)
            if fused is not None and _root_is_dus(fused):
                out_bytes = min(out_bytes, _dus_update_bytes(fused))
            stats.hbm_bytes += in_bytes + out_bytes
            # flops inside the fused computation (dots can be fused)
            if fused is not None:
                inner = analyze_computation(comps, fused, num_devices,
                                            _memo)
                stats.flops += inner.flops
            continue
        if op in _SKIP_OPS:
            continue
        if op == "dot":
            rd = _result_dims(ins.result_type)
            lhs = _instr_shape_dims(comp, ins.operands[0]) \
                if ins.operands else None
            flops = 0.0
            if rd:
                n = math.prod(rd[1]) if rd[1] else 1
                k = 1
                cm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}",
                               ins.attrs)
                if cm and lhs:
                    for d in cm.group(1).split(","):
                        if d:
                            k *= lhs[1][int(d)]
                flops = 2.0 * n * k
            stats.flops += flops
            in_bytes = sum(
                _shape_bytes(comp.instructions[o].result_type)
                for o in ins.operands if o in comp.instructions)
            stats.hbm_bytes += in_bytes + _shape_bytes(ins.result_type)
            continue
        if any(op.startswith(c) for c in COLLECTIVES):
            base = op.replace("-start", "")
            out_bytes = _shape_bytes(ins.result_type)
            in_bytes = sum(
                _shape_bytes(comp.instructions[o].result_type)
                for o in ins.operands if o in comp.instructions)
            size = max(out_bytes, in_bytes)
            g = _group_size(ins.attrs, num_devices)
            if base.startswith("all-reduce"):
                wire = 2 * (g - 1) / max(g, 1) * size
            elif base.startswith("collective-permute"):
                wire = out_bytes
            else:  # all-gather / reduce-scatter / all-to-all
                wire = (g - 1) / max(g, 1) * size
            stats.collective_bytes += size
            stats.collective_wire_bytes += wire
            key = base.split(".")[0]
            stats.collective_counts[key] = \
                stats.collective_counts.get(key, 0) + 1
            continue
        if op in ("dynamic-slice", "gather"):
            stats.hbm_bytes += 2 * _shape_bytes(ins.result_type)
            continue
        if op in ("dynamic-update-slice", "scatter"):
            upd = (comp.instructions[ins.operands[1]].result_type
                   if len(ins.operands) > 1
                   and ins.operands[1] in comp.instructions else "")
            ub = _shape_bytes(upd)
            stats.hbm_bytes += 2 * ub if ub else _shape_bytes(
                ins.result_type)
            continue
        # generic op: operands + result
        in_bytes = sum(
            _shape_bytes(comp.instructions[o].result_type)
            for o in ins.operands if o in comp.instructions)
        stats.hbm_bytes += in_bytes + _shape_bytes(ins.result_type)
    _memo[comp.name] = stats
    return stats


def _slice_only_param_bytes(fused: "Computation") -> dict[int, float]:
    """Parameter index → charged bytes, for fused-computation parameters
    consumed ONLY by dynamic-slice/gather ops (charge the slice results)."""
    out: dict[int, float] = {}
    params: dict[str, int] = {}
    for ins in fused.instructions.values():
        if ins.opcode == "parameter":
            m = re.search(r"parameter\((\d+)\)", ins.line)
            if m:
                params[ins.name] = int(m.group(1))
    for pname, pidx in params.items():
        consumers = [i for i in fused.instructions.values()
                     if pname in i.operands and i.opcode != "parameter"]
        if consumers and all(c.opcode in ("dynamic-slice", "gather")
                             for c in consumers):
            out[pidx] = sum(_shape_bytes(c.result_type) for c in consumers)
    return out


def _root_is_dus(fused: "Computation") -> bool:
    for ins in fused.instructions.values():
        if "ROOT" in ins.line and ins.opcode == "dynamic-update-slice":
            return True
    return False


def _dus_update_bytes(fused: "Computation") -> float:
    for ins in fused.instructions.values():
        if "ROOT" in ins.line and ins.opcode == "dynamic-update-slice":
            if len(ins.operands) > 1:
                upd = ins.operands[1]
                if upd in fused.instructions:
                    return 2 * _shape_bytes(
                        fused.instructions[upd].result_type)
            return _shape_bytes(ins.result_type)
    return 0.0


# ---------------------------------------------------------------------- #
# per-collective-op extraction (the ML-traffic derivation input)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective instruction of the entry program, with its execution
    multiplicity through the while-loop call graph.

    ``size_bytes``/``wire_bytes`` are per-participant per-execution (the
    same accounting as :class:`HloStats`); ``count`` is the number of times
    the op executes per entry call (product of enclosing while trip
    counts).  ``groups`` are explicit device-id groups; ``pairs`` is the
    ``source_target_pairs`` list (collective-permute only, else empty).
    """

    name: str
    kind: str                               # all-reduce / all-gather / ...
    size_bytes: float
    wire_bytes: float
    groups: tuple[tuple[int, ...], ...]
    pairs: tuple[tuple[int, int], ...] = ()
    count: float = 1.0

    @property
    def group_size(self) -> int:
        return len(self.groups[0]) if self.groups else 1

    @property
    def fabric_bytes(self) -> float:
        """Total wire bytes this op puts on the fabric per entry call —
        the sum over all participants of all groups, times ``count``.

        Ring accounting (paper §2 collective model): an all-reduce over a
        g-group moves ``2(g-1)·size`` bytes around the ring in total, an
        all-gather/reduce-scatter/all-to-all ``(g-1)·size``, and a
        collective-permute ``size`` per source→target pair.
        """
        if self.kind == "collective-permute":
            return self.count * len(self.pairs) * self.size_bytes
        total = 0.0
        factor = 2.0 if self.kind == "all-reduce" else 1.0
        for grp in self.groups:
            g = len(grp)
            if g > 1:
                total += factor * (g - 1) * self.size_bytes
        return self.count * total


def collective_ops(text: str, num_devices: int = 1) -> list[CollectiveOp]:
    """Walk the entry program (while-trip-count aware, like
    :func:`analyze_hlo_text`) and return every collective op with its
    replica groups and execution multiplicity.

    ``*-done`` halves of async pairs are skipped — the ``*-start`` op
    carries the payload; counting both would double the traffic.
    """
    comps = parse_hlo(text)
    entry = None
    for c in comps.values():
        if c.is_entry:
            entry = c
            break
    if entry is None:
        entry = max(comps.values(), key=lambda c: len(c.instructions))
    out: list[CollectiveOp] = []

    def walk(comp: Computation, mult: float) -> None:
        for ins in comp.instructions.values():
            op = ins.opcode
            if op == "while":
                body = cond = None
                bm = re.search(r"body=%?([\w\.\-]+)", ins.attrs)
                cm = re.search(r"condition=%?([\w\.\-]+)", ins.attrs)
                if bm and bm.group(1) in comps:
                    body = comps[bm.group(1)]
                if cm and cm.group(1) in comps:
                    cond = comps[cm.group(1)]
                trips = _trip_count(cond) if cond else 1
                if body is not None:
                    walk(body, mult * trips)
                continue
            if not any(op.startswith(c) for c in COLLECTIVES):
                continue
            if op.endswith("-done"):
                continue
            base = op.replace("-start", "")
            kind = base.split(".")[0]
            out_bytes = _shape_bytes(ins.result_type)
            in_bytes = sum(
                _shape_bytes(comp.instructions[o].result_type)
                for o in ins.operands if o in comp.instructions)
            size = max(out_bytes, in_bytes)
            groups = parse_replica_groups(ins.attrs, num_devices)
            pairs = ()
            if kind == "collective-permute":
                size = out_bytes
                pairs = parse_source_target_pairs(ins.attrs)
                wire = out_bytes
            else:
                g = len(groups[0]) if groups else 1
                if kind == "all-reduce":
                    wire = 2 * (g - 1) / max(g, 1) * size
                else:
                    wire = (g - 1) / max(g, 1) * size
            out.append(CollectiveOp(
                name=ins.name, kind=kind, size_bytes=float(size),
                wire_bytes=float(wire), groups=groups, pairs=pairs,
                count=mult))

    walk(entry, 1.0)
    return out


def collective_flow_totals(ops: list[CollectiveOp]) -> dict[str, float]:
    """Per-kind fabric wire bytes (Σ :attr:`CollectiveOp.fabric_bytes`) —
    the conservation target the derived flow matrices must sum to
    (:mod:`repro_torch.noc.mltraffic`)."""
    totals: dict[str, float] = {}
    for op in ops:
        totals[op.kind] = totals.get(op.kind, 0.0) + op.fabric_bytes
    return totals


def analyze_hlo_text(text: str, num_devices: int = 1) -> HloStats:
    comps = parse_hlo(text)
    entry = None
    for c in comps.values():
        if c.is_entry:
            entry = c
            break
    if entry is None:  # fall back to the largest computation
        entry = max(comps.values(), key=lambda c: len(c.instructions))
    return analyze_computation(comps, entry, num_devices, {})
