"""ML collective traffic from recorded post-SPMD HLO → NoC traffic matrices.

The reference (``noc/mltraffic.py``) lowers one sharded smoke model's
phase programs (train step, forward loss, decode step) under JAX's SPMD
partitioner and reads the compiled HLO text.  PyTorch has no counterpart
of that lowering, so the port starts from the text: the reference's HLO
is recorded once (``tests/goldens/mltraffic/``, regenerated by
``tests/goldens/regen_torch.py``) and everything after the lowering runs
here, with no JAX:

  1. every collective of a phase's HLO — bytes, replica groups,
     ``source_target_pairs``, while-loop execution counts — via
     :func:`repro_torch.analysis.hlo.collective_ops`;
  2. each collective mapped onto logical-device (rank, rank) flows under
     the ring collective model (all-reduce rings, all-gather /
     reduce-scatter rings, all-to-all full exchange, collective-permute
     explicit pairs);
  3. ranks embedded onto a physical
     :class:`~repro_torch.core.topology.Topology` (mesh axis k → torus
     dim k when the shapes line up, flat rank → node otherwise) and
     normalised into a campaign traffic matrix.

The resulting :class:`MLWorkload` is an entry of ``CampaignSpec``'s
``workloads`` axis: it has ``.name`` and ``.matrix_for(topo)``.  Byte
conservation holds per phase and per collective kind: a kind's flow
matrix sums to the fabric wire bytes of
:func:`repro_torch.analysis.hlo.collective_flow_totals`.  Workloads
saved by either package (:meth:`MLWorkload.save`, the reference's npz
layout) load in the other.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import json
import os

import numpy as np

from ..analysis.hlo import collective_flow_totals, collective_ops
from ..core import traffic as traffic_mod

__all__ = ["WorkloadSpec", "MLWorkload", "collective_flows", "embed_ranks",
           "derive_from_hlo", "derive_workload", "read_hlo", "hlo_path",
           "DIRECT_PHASES", "STAGE_GRID"]

# phases lowered as real programs; "bwd" is derived as train − fwd
DIRECT_PHASES = ("fwd", "train", "decode")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One model workload, field for field the reference's (so that
    :meth:`fingerprint` gives the reference's hash).

    ``data``/``model`` are the logical mesh shape; ``axes`` only names
    those two mesh axes.  ``moe_pad_to`` pads the expert count so expert
    parallelism divides the model axis.  ``phases`` lists the programs
    whose HLO is read (a subset of ``DIRECT_PHASES``).
    """

    arch: str
    data: int = 1
    model: int = 8
    batch: int = 4
    seq: int = 32
    decode_len: int = 32
    moe_pad_to: int = 0
    phases: tuple[str, ...] = ("train", "decode")
    axes: tuple[str, str] = ("data", "model")
    label: str = ""

    def __post_init__(self):
        bad = [p for p in self.phases if p not in DIRECT_PHASES]
        if bad:
            raise ValueError(f"unknown phases {bad}; derivable phases are "
                             f"{DIRECT_PHASES} ('bwd' is computed from "
                             f"train − fwd)")

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @property
    def name(self) -> str:
        return self.label or f"{self.arch}@{self.data}x{self.model}"

    def fingerprint(self) -> str:
        return hashlib.sha256(json.dumps(
            dataclasses.asdict(self), sort_keys=True,
            default=str).encode()).hexdigest()


def collective_flows(ops, num_devices: int) -> dict[str, np.ndarray]:
    """Per-kind (rank, rank) wire-byte matrices under the ring model.

    * all-reduce / all-gather / reduce-scatter: each group is a logical
      ring over its ranks in group order; every ring edge (i → next)
      carries the per-participant wire bytes (``2(g-1)/g·size`` for
      all-reduce, ``(g-1)/g·size`` otherwise).
    * all-to-all: every ordered pair within a group exchanges ``size/g``.
    * collective-permute: each ``source_target_pairs`` entry carries the
      full payload.

    The sums run in op order, as the reference's, so the matrices are
    bit for bit the reference's.
    """
    mats: dict[str, np.ndarray] = {}
    for op in ops:
        m = mats.setdefault(
            op.kind, np.zeros((num_devices, num_devices), np.float64))
        if op.kind == "collective-permute":
            for s, t in op.pairs:
                m[s, t] += op.count * op.size_bytes
            continue
        for grp in op.groups:
            g = len(grp)
            if g <= 1:
                continue
            if op.kind == "all-to-all":
                per = op.size_bytes / g
                for i in grp:
                    for j in grp:
                        if i != j:
                            m[i, j] += op.count * per
            else:
                factor = 2.0 if op.kind == "all-reduce" else 1.0
                per = factor * (g - 1) / g * op.size_bytes
                for a, b in zip(grp, grp[1:] + (grp[0],)):
                    m[a, b] += op.count * per
    return mats


def embed_ranks(topo, mesh_shape: tuple[int, ...]) -> np.ndarray:
    """Map logical mesh ranks onto physical topology node ids.

    Mesh rank r has mesh coordinates ``np.unravel_index(r, mesh_shape)``
    (last axis fastest).  When the topology's dims equal the mesh shape
    axis for axis, mesh axis k lands on torus dim k; ``Topology.node_id``
    runs dim 0 fastest, so this is not the identity for ``data > 1``.
    Otherwise, if the node count covers the rank count, rank r goes to
    node r (an ``(1, 8)`` mesh folded onto a 2×4 torus: the model ring
    snakes across both dimensions).
    """
    d = int(np.prod(mesh_shape))
    if tuple(topo.dims) == tuple(mesh_shape):
        emb = np.empty(d, np.int64)
        for r in range(d):
            emb[r] = topo.node_id(np.unravel_index(r, mesh_shape))
        return emb
    if topo.num_nodes >= d:
        return np.arange(d, dtype=np.int64)
    raise ValueError(
        f"cannot embed {d} mesh ranks ({mesh_shape}) onto "
        f"{topo.name} ({topo.num_nodes} nodes)")


@dataclasses.dataclass
class MLWorkload:
    """Per-phase collective flows of one :class:`WorkloadSpec`.

    ``flows[phase][kind]`` is a (D, D) rank-pair wire-byte matrix;
    ``totals[phase][kind]`` is the HLO-side fabric byte total the matrix
    sums to.  The phases present are exactly ``spec.phases``.
    """

    spec: WorkloadSpec
    flows: dict[str, dict[str, np.ndarray]]
    totals: dict[str, dict[str, float]]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.spec.name

    def phase_flows(self, phase: str) -> np.ndarray:
        """(D, D) byte matrix of one phase, summed over collective kinds.

        ``"bwd"`` is the backward residual ``max(train − fwd, 0)`` (needs
        both phases); ``"step"`` means ``"train"``.
        """
        if phase == "step":
            phase = "train"
        if phase == "bwd":
            return np.maximum(
                self.phase_flows("train") - self.phase_flows("fwd"), 0.0)
        if phase not in self.flows:
            raise KeyError(f"phase {phase!r} not derived for {self.name}; "
                           f"have {sorted(self.flows)}")
        d = self.spec.num_devices
        out = np.zeros((d, d), np.float64)
        for m in self.flows[phase].values():
            out += m
        return out

    def campaign_flows(self) -> np.ndarray:
        """The workload's campaign-axis byte matrix: every derived phase
        summed, except ``fwd`` when ``train`` is present (a train step
        re-runs the forward collectives)."""
        phases = [p for p in self.flows
                  if not (p == "fwd" and "train" in self.flows)]
        d = self.spec.num_devices
        out = np.zeros((d, d), np.float64)
        for p in phases:
            out += self.phase_flows(p)
        return out

    def matrix_for(self, topo) -> np.ndarray:
        """Campaign traffic matrix on ``topo``: rank flows embedded onto
        nodes, then normalised like every synthetic pattern (zero
        diagonal, Σ = 1) by ``traffic.from_pair_counts``."""
        flows = self.campaign_flows()
        if flows.sum() <= 0:
            raise ValueError(
                f"workload {self.name} derived zero collective bytes "
                f"(mesh {self.spec.data}x{self.spec.model}) — nothing to "
                f"route; use a sharded mesh (model > 1)")
        emb = embed_ranks(topo, (self.spec.data, self.spec.model))
        counts = np.zeros((topo.num_nodes, topo.num_nodes), np.float64)
        counts[np.ix_(emb, emb)] = flows
        return traffic_mod.from_pair_counts(topo, counts)

    # ----------------------------------------------------------------- #
    def save(self, path: str) -> None:
        """The reference's npz layout: a 0-d string ``__meta__`` (spec,
        totals, meta as JSON) and one ``flow__<phase>__<kind>`` array a
        matrix."""
        arrs = {f"flow__{ph}__{k}": m
                for ph, kinds in self.flows.items()
                for k, m in kinds.items()}
        header = json.dumps({
            "spec": dataclasses.asdict(self.spec),
            "totals": self.totals,
            "meta": self.meta,
        })
        np.savez(path, __meta__=np.array(header), **arrs)

    @classmethod
    def load(cls, path: str) -> "MLWorkload":
        with np.load(path) as z:
            header = json.loads(str(z["__meta__"]))
            flows: dict[str, dict[str, np.ndarray]] = {}
            for key in z.files:
                if not key.startswith("flow__"):
                    continue
                _, ph, kind = key.split("__", 2)
                flows.setdefault(ph, {})[kind] = np.asarray(
                    z[key], np.float64)
        sd = header["spec"]
        for k in ("phases", "axes"):
            sd[k] = tuple(sd[k])
        return cls(spec=WorkloadSpec(**sd), flows=flows,
                   totals=header["totals"], meta=header.get("meta", {}))


# the ML-traffic stage's workloads (the reference's ``benchmarks/run.py``,
# ``bench_ml_traffic``), MoE first: (spec, is MoE) pairs on a 1x8 mesh
STAGE_GRID = (
    (WorkloadSpec("qwen2-moe-a2.7b", data=1, model=8, moe_pad_to=8,
                  phases=("decode",), label="qwen2-moe@1x8:decode"), True),
    (WorkloadSpec("dbrx-132b", data=1, model=8, moe_pad_to=8,
                  phases=("train", "decode"), label="dbrx@1x8:step"), True),
    (WorkloadSpec("internlm2-1.8b", data=1, model=8,
                  phases=("train", "decode"),
                  label="internlm2@1x8:step"), False),
    (WorkloadSpec("stablelm-3b", data=1, model=8,
                  phases=("train", "decode"),
                  label="stablelm@1x8:step"), False),
)


# --------------------------------------------------------------------- #
# derivation: recorded HLO → ops → flows
# --------------------------------------------------------------------- #
def derive_from_hlo(spec: WorkloadSpec, texts: dict[str, str]) -> MLWorkload:
    """The workload from ``texts`` (phase → post-SPMD HLO text of that
    phase's program under ``spec``'s mesh)."""
    missing = [p for p in spec.phases if p not in texts]
    if missing:
        raise KeyError(f"{spec.name}: no HLO for phases {missing}")
    flows: dict[str, dict[str, np.ndarray]] = {}
    totals: dict[str, dict[str, float]] = {}
    counts: dict[str, int] = {}
    for phase in spec.phases:
        ops = collective_ops(texts[phase], spec.num_devices)
        flows[phase] = collective_flows(ops, spec.num_devices)
        totals[phase] = collective_flow_totals(ops)
        counts[phase] = len(ops)
    return MLWorkload(spec=spec, flows=flows, totals=totals,
                      meta={"collective_op_counts": counts})


def _stem(spec) -> str:
    """The spec's name as a file stem, as the reference's cache names it."""
    return spec.name.replace("@", "_").replace("/", "-")


def hlo_path(spec, phase: str, hlo_dir: str) -> str:
    """``<hlo_dir>/<stem>__<phase>.hlo.gz``, one recorded phase program
    (``spec``: either package's :class:`WorkloadSpec`)."""
    return os.path.join(hlo_dir, f"{_stem(spec)}__{phase}.hlo.gz")


def read_hlo(spec: WorkloadSpec, hlo_dir: str) -> dict[str, str]:
    """Phase → recorded HLO text; ``FileNotFoundError`` names the
    regeneration command when a phase was never recorded."""
    texts = {}
    for phase in spec.phases:
        path = hlo_path(spec, phase, hlo_dir)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{spec.name}: no recorded HLO for phase {phase!r} at "
                f"{path}; record it from the reference with `PYTHONPATH=src "
                f"python tests/goldens/regen_torch.py mltraffic`")
        with gzip.open(path, "rt", encoding="utf-8") as f:
            texts[phase] = f.read()
    return texts


def derive_workload(spec: WorkloadSpec, *, hlo_dir: str,
                    cache_dir: str | None = None) -> MLWorkload:
    """The workload of ``spec``: served from the npz cache in
    ``cache_dir`` when it is there (the reference's name,
    ``<stem>__<fingerprint[:10]>.npz``; its files load too), else derived
    from the HLO recorded in ``hlo_dir`` (and stored in the cache)."""
    path = None
    if cache_dir:
        path = os.path.join(cache_dir,
                            f"{_stem(spec)}__{spec.fingerprint()[:10]}.npz")
        if os.path.exists(path):
            return MLWorkload.load(path)
    wl = derive_from_hlo(spec, read_hlo(spec, hlo_dir))
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        wl.save(path)
    return wl
