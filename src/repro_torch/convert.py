"""Carry tables, state and plans across between the reference and the port.

The reference keeps a cell's tables as a NamedTuple of arrays and a
lane-stacked state as a dict of arrays (scalars stacked to (L,)); the
port keeps the same fields as torch tensors on a device.  These helpers
take the reference's arrays as numpy — so nothing here imports the
reference — and give the port's tensors, or back:

* ``rbits`` is uint32 in the reference and int32 holding the same bit
  pattern in the port;
* ``key`` is a (L, 2) uint32 numpy array on both sides (the port
  advances the key chain on the host).

The control plane's records come across too: :func:`nrank_result` (a
warm start for ``replan(prev=...)``), :func:`scenario` (events,
policy and re-planner knobs) and :func:`ctrl_snapshot` (an epoch-boundary
snapshot of a controlled run, which the port then resumes).  Both read the reference objects by their
field names only.  So do a model's parameters:
:func:`encdec_params_from_numpy`, :func:`hybrid_params_from_numpy`,
:func:`dense_params_from_numpy` and :func:`xlstm_params_from_numpy` take
the reference's whisper, Jamba, decoder-LM (qwen2-vl's too) and xLSTM
parameter trees (nested dicts of numpy arrays, layers stacked on leading
axes; a MoE layer's experts on the axis after them).  A train state
comes across both ways: :func:`train_state_from_numpy` and
:func:`train_state_to_numpy` carry the parameters and the optimizer's
state (m, v — fp32, or int8 codes and scales — and the step).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .core.bidor import BiDORTable
from .core.nrank import NRankResult
from .device import resolve_device
from .models import encdec, hybrid, lm, xlstm_model
from .models.common import ModelConfig
from .noc import ctrl
from .noc.sim import Tables, state_from_host, state_to_host

__all__ = ["tables_from_numpy", "state_from_numpy", "state_to_numpy",
           "plan_from_numpy", "nrank_result", "scenario", "ctrl_snapshot",
           "encdec_params_from_numpy", "hybrid_params_from_numpy",
           "dense_params_from_numpy", "xlstm_params_from_numpy",
           "params_from_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]


def tables_from_numpy(tables, device=None) -> Tables:
    """Port :class:`~repro_torch.noc.sim.Tables` from the reference's
    tables (any object with the same field names, or a dict of arrays)."""
    dev = resolve_device(device)
    get = tables.get if isinstance(tables, dict) else (
        lambda k: getattr(tables, k))
    return Tables(**{k: torch.as_tensor(np.array(get(k), order="C"),
                                        device=dev)
                     for k in Tables._fields})


def state_from_numpy(state: dict, device=None) -> dict:
    """Port state from a lane-stacked reference state (numpy arrays)."""
    return state_from_host(state, device)


def state_to_numpy(state: dict) -> dict:
    """Reference-layout numpy copy of a port state (``rbits`` uint32)."""
    return state_to_host(state)


def plan_from_numpy(choice, port_tables, orders=((0, 1), (1, 0)),
                    costs=None, unroutable=None) -> BiDORTable:
    """A :class:`BiDORTable` from a choice table and per-order port
    tables (e.g. a reference plan's ``table.choice`` / ``.port_tables``)."""
    choice = np.asarray(choice, np.int8)
    port_tables = np.asarray(port_tables, np.int8)
    if costs is None:
        costs = np.zeros(port_tables.shape, np.float64)
    return BiDORTable(choice=choice, orders=tuple(map(tuple, orders)),
                      costs=np.asarray(costs, np.float64),
                      port_tables=port_tables,
                      unroutable=(None if unroutable is None
                                  else np.asarray(unroutable, bool)))


def nrank_result(ref) -> NRankResult:
    """The port's :class:`NRankResult` from a reference one, every array
    copied with its dtype (the node-level evolution's float32 fields
    stay float32)."""
    fields = [f.name for f in dataclasses.fields(NRankResult)]
    return NRankResult(**{
        f: (int(getattr(ref, f)) if f == "iterations"
            else np.array(getattr(ref, f))) for f in fields})


_EVENTS = {"LinkFail": ctrl.LinkFail, "LinkRecover": ctrl.LinkRecover,
           "TrafficDrift": ctrl.TrafficDrift}


def _event(ev):
    cls = _EVENTS.get(type(ev).__name__)
    if cls is None:
        raise TypeError(f"unknown event {ev!r}")
    kw = {f.name: getattr(ev, f.name) for f in dataclasses.fields(cls)}
    if "traffic" in kw:
        kw["traffic"] = np.array(kw["traffic"], np.float64)
    return cls(**kw)


def scenario(ref) -> ctrl.Scenario:
    """The port's :class:`~repro_torch.noc.ctrl.Scenario` from a
    reference one: its events, policy and :class:`ReplanConfig`."""
    rc = None
    if ref.replan is not None:
        rc = ctrl.ReplanConfig(**{
            f.name: getattr(ref.replan, f.name)
            for f in dataclasses.fields(ctrl.ReplanConfig)})
    return ctrl.Scenario(name=ref.name,
                         events=tuple(_event(e) for e in ref.events),
                         policy=ref.policy, replan=rc)


def ctrl_snapshot(arrays: dict, meta: dict) -> tuple[dict, dict]:
    """The port's epoch-boundary snapshot from one the reference's
    ``run_controlled(checkpoint=...)`` saved: ``(arrays, meta)`` for the
    port's ``run_controlled`` to resume.  The layouts agree key for key
    (the simulator state as ``s_<key>``, ``rbits`` and the (L, 2) PRNG
    keys as uint32); the port's meta also carries the replans' host
    milliseconds, which the reference did not time and which come across
    as NaN."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if k == "s_key":
            a = a.astype(np.uint32).reshape(-1, 2)
        elif k == "s_rbits":
            a = a.astype(np.uint32)
        out[k] = np.array(a)
    meta = json.loads(json.dumps(meta))
    meta.setdefault("replan_ms", [float("nan")] * len(meta["replans"]))
    return out, meta


def _split_name(name: str) -> tuple[list[str], tuple[int, ...]]:
    """A port parameter's dotted name → (the reference tree's keys, the
    ``ModuleList`` indices into its stacked arrays, outermost first)."""
    keys, layers = [], []
    for key in name.split("."):
        (layers if key.isdigit() else keys).append(
            int(key) if key.isdigit() else key)
    return keys, tuple(layers)


def _leaf(tree: dict, name: str):
    """The reference's leaf for a port parameter: its array (or a dict of
    arrays, as an int8 moment's codes and scales) sliced at the
    parameter's layer indices; bfloat16 arrays (numpy's ``ml_dtypes``)
    as float32, which holds them exactly."""
    keys, layers = _split_name(name)
    node = tree
    for key in keys:
        node = node[key]

    def cut(x):
        a = np.asarray(x)[layers]
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    return ({k: cut(v) for k, v in node.items()} if isinstance(node, dict)
            else cut(node))


def _params_from_numpy(model: torch.nn.Module, tree: dict) -> None:
    """Copy the reference's tree into ``model``: a parameter's dotted name
    walks the tree by its keys, and each integer in it (a ``ModuleList``
    index) indexes the stacked array found there, outermost first.
    Arrays are cast to the parameter's dtype."""
    for name, param in model.named_parameters():
        a = _leaf(tree, name)
        if a.shape != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {a.shape}, port "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.as_tensor(np.ascontiguousarray(a)))


def _stack(named) -> dict:
    """The reference's nested tree from (port name, numpy array) pairs:
    arrays of one tree path stacked on leading axes by their layer
    indices (the inverse of :func:`_leaf`)."""
    groups: dict[tuple, list] = {}
    for name, a in named:
        keys, layers = _split_name(name)
        groups.setdefault(tuple(keys), []).append((layers, a))
    tree: dict = {}
    for keys, items in groups.items():
        lead = [max(ix[d] for ix, _ in items) + 1
                for d in range(len(items[0][0]))]
        arr = np.empty(lead + list(items[0][1].shape), items[0][1].dtype)
        for ix, a in items:
            arr[ix] = a
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def encdec_params_from_numpy(tree: dict, cfg: ModelConfig,
                             device=None) -> encdec.EncDec:
    """The port's whisper parameters from the reference's tree
    (``enc_blocks`` and ``dec_blocks`` stacked on a leading layer axis)."""
    return params_from_numpy(tree, cfg, device)


def hybrid_params_from_numpy(tree: dict, cfg: ModelConfig,
                             device=None) -> hybrid.Hybrid:
    """The port's Jamba parameters from the reference's tree: ``blocks``
    stacked on axis 0 by super-block, and inside it ``mamba``,
    ``mamba_ln``, ``ffn_ln``, ``ffn_dense`` and ``ffn_moe`` (with
    experts) on axis 1 by layer, a MoE FFN's experts on axis 2."""
    return params_from_numpy(tree, cfg, device)


def dense_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device=None) -> lm.LM:
    """The port's decoder-LM parameters (dense, MoE, MLA, or MoE and MLA
    together) from the reference's tree (``blocks`` stacked on a leading
    layer axis; a MoE FFN's experts on axis 1)."""
    return params_from_numpy(tree, cfg, device)


def xlstm_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device=None) -> xlstm_model.XLSTM:
    """The port's xLSTM parameters from the reference's tree: ``blocks``
    stacked on axis 0 by super-block, and inside it ``mlstm`` and
    ``mlstm_ln`` on axis 1 by mLSTM layer."""
    return params_from_numpy(tree, cfg, device)


_MODEL_CLASS = {"dense": lm.LM, "moe": lm.LM, "vlm": lm.LM,
                "encdec": encdec.EncDec, "hybrid": hybrid.Hybrid,
                "ssm": xlstm_model.XLSTM}


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None):
    """The port's parameters of any family from the reference's tree."""
    model = _MODEL_CLASS[cfg.family](cfg, None, "meta").to_empty(
        device=resolve_device(device))
    _params_from_numpy(model, tree)
    return model


def train_state_from_numpy(state: dict, cfg: ModelConfig,
                           device=None) -> dict:
    """The port's train state from the reference's
    ``{"params": tree, "opt": {"m": tree, "v": tree, "step": int32}}``
    (numpy arrays; a moment's leaf an fp32 array or ``{"q": int8 codes,
    "s": fp32 scales}``): the parameters, gradients on, and the
    optimizer's state keyed by the port's parameter names."""
    from .train.train_step import trainable

    dev = resolve_device(device)
    params = trainable(params_from_numpy(state["params"], cfg, dev))

    def moment(tree, name):
        leaf = _leaf(tree, name)
        if isinstance(leaf, dict):
            return {k: torch.as_tensor(np.ascontiguousarray(a), device=dev)
                    for k, a in leaf.items()}
        return torch.as_tensor(np.ascontiguousarray(leaf), device=dev)

    opt = state["opt"]
    names = [n for n, _ in params.named_parameters()]
    return {"params": params,
            "opt": {"m": {n: moment(opt["m"], n) for n in names},
                    "v": {n: moment(opt["v"], n) for n in names},
                    "step": torch.as_tensor(np.int32(opt["step"]),
                                            device=dev)}}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_to_numpy(state: dict) -> dict:
    """The reference's layout of a port train state, numpy arrays (a
    bfloat16 parameter as float32, which holds it exactly)."""

    def moments(part):
        pairs = []
        for n, m in part.items():
            if isinstance(m, dict):
                pairs += [(f"{n}.{k}", _host(a)) for k, a in m.items()]
            else:
                pairs.append((n, _host(m)))
        return _stack(pairs)

    opt = state["opt"]
    return {"params": _stack((n, _host(p)) for n, p in
                             state["params"].named_parameters()),
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": np.int32(int(opt["step"]))}}
