"""Sharding rules: DP / FSDP / TP / EP / SP as per-dimension specs, the
reference's ``sharding/specs.py`` without JAX.

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the first the major) — a ``PartitionSpec``'s entries.  A mesh
is anything :func:`axis_sizes` reads: a ``DeviceMesh`` (its dim names
and sizes), a mapping of axis sizes, or an object with a ``.shape``
mapping (a JAX ``AbstractMesh`` reads so).

Strategy (the reference's):

* **DP**: batch over ``("pod", "data")``.
* **FSDP**: weight matrices also split over ``data`` on a non-TP dim.
* **TP**: head / FFN / expert-hidden dims over ``model``.
* **EP**: expert dim over ``model`` when ``E % model == 0``, otherwise
  per-expert TP.
* **SP**: with ``seq_parallel`` the cache's sequence dim over ``data``.

Every rule passes through :func:`fit_spec`, which drops an axis where
the dim does not divide by its size.

Leaves are matched by basename and trailing dims.  The reference stacks
repeated layers on leading axes; the port keeps one parameter a layer
(``blocks.3.attn.wq``), so :func:`param_specs` and :func:`opt_specs`
apply the rules to the stacked shape the port's names imply (the
integers in a name index it) and drop the stacked dims' entries where
they are all None.  Where a rule splits a stacked layer axis (the MoE
rules of three trailing dims match a stacked dense FFN: Jamba's,
qwen2-moe's shared expert), the spec keeps those leading entries: the
leaf then lives whole on the ranks whose coordinate holds its layer
(``sharding.state.placement``).
"""

from __future__ import annotations

import math
from collections.abc import Mapping

from ..models.common import ModelConfig

DATA = ("pod", "data")  # batch axes (pod present only on multi-pod meshes)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or an object
    with a ``.shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh if isinstance(mesh, Mapping) else mesh.shape)


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry's axis names (none for a replicated dim)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_in_mesh(sizes: dict, axes):
    present = tuple(a for a in axes_of(axes) if a in sizes)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def axis_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes_of(entry))


def fit_spec(mesh, shape, spec) -> tuple:
    """Drop sharding on dims that do not divide by the axis size; pad the
    spec with leading Nones to the rank of ``shape``."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec)
    if len(spec) < len(shape):
        spec = (None,) * (len(shape) - len(spec)) + spec
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    out = []
    for dim, axes in zip(shape, spec):
        axes = _axes_in_mesh(sizes, axes)
        if axes is None or dim % axis_size(sizes, axes) != 0:
            out.append(None)
        else:
            out.append(axes)
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A rank's shard shape of a ``shape`` array split by ``spec``."""
    return tuple(d // axis_size(mesh, s) for d, s in zip(shape, spec))


# ---------------------------------------------------------------------- #
# parameter rules (by leaf basename; trailing dims)
# ---------------------------------------------------------------------- #
def _param_rules(cfg: ModelConfig, mesh):
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    ep = cfg.is_moe and cfg.moe_experts % model == 0
    # KV projections split over model only when the kv heads divide it
    kv_spec = ("data", "model") if cfg.n_kv_heads % model == 0 else \
        ("data", None)
    rules: dict[tuple[str, int], tuple] = {
        ("table", 2): (None, "data"),
        ("w", 2): ("model", "data"),            # lm head
        ("wq", 2): ("data", "model"),
        ("wk", 2): kv_spec,
        ("wv", 2): kv_spec,
        ("wo", 2): ("model", "data"),
        ("w_gate", 2): ("data", "model"),
        ("w_up", 2): ("data", "model"),
        ("w_down", 2): ("model", "data"),
        ("w_in", 2): ("data", "model"),
        ("w_out", 2): ("model", "data"),
        ("b_in", 1): ("model",),
        ("q_down", 2): ("data", None),
        ("q_up", 2): (None, "model"),
        ("kv_down", 2): ("data", None),
        ("kv_up", 2): (None, "model"),
        ("in_proj", 2): ("data", "model"),
        ("x_proj", 2): ("model", None),
        ("dt_proj", 2): (None, "model"),
        ("conv_w", 2): (None, "model"),
        ("conv_b", 1): ("model",),
        ("dt_bias", 1): ("model",),
        ("d_skip", 1): ("model",),
        ("a_log", 2): ("model", None),
        ("out_proj", 2): ("model", "data"),
        ("up", 2): ("data", "model"),
        ("down", 2): ("model", "data"),
        ("r", 3): (None, None, "model"),
        ("out", 2): ("model", "data"),
        ("pos", 2): (None, "data"),
        # MoE expert tensors (trailing 3 dims: E, in, out)
        ("w_gate", 3): ("model", "data", None) if ep else
        (None, "data", "model"),
        ("w_up", 3): ("model", "data", None) if ep else
        (None, "data", "model"),
        ("w_down", 3): ("model", None, "data") if ep else
        (None, "model", "data"),
        ("router", 2): (None, None),
    }
    if cfg.family == "ssm":
        # mLSTM: contraction dim of wq/wk/wv matches model-split acts
        rules[("wq", 2)] = ("model", None)
        rules[("wk", 2)] = ("model", None)
        rules[("wv", 2)] = ("model", None)
    return rules


def _rule_spec(rules, mesh, name: str, shape) -> tuple:
    for nd in range(len(shape), 0, -1):
        if (name, nd) in rules:
            return fit_spec(mesh, shape, rules[(name, nd)])
    return (None,) * len(shape)   # replicate (norm scales, biases)


def split_name(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A port parameter's dotted name → (the reference tree's keys, the
    ``ModuleList`` indices that index its stacked array)."""
    keys, layers = [], []
    for key in name.split("."):
        if key.isdigit():
            layers.append(int(key))
        else:
            keys.append(key)
    return tuple(keys), tuple(layers)


def stack_extents(names) -> dict[tuple[str, ...], tuple[int, ...]]:
    """The stacked layer axes' sizes of each tree path the names imply:
    one more than the largest index on each axis."""
    out: dict[tuple, list] = {}
    for name in names:
        keys, layers = split_name(name)
        ext = out.setdefault(keys, [0] * len(layers))
        for i, ix in enumerate(layers):
            ext[i] = max(ext[i], ix + 1)
    return {k: tuple(v) for k, v in out.items()}


def _leaf_spec(rules, mesh, name: str, shape, extents) -> tuple:
    keys, _ = split_name(name)
    lead = extents[keys]
    spec = _rule_spec(rules, mesh, keys[-1], (*lead, *shape))
    if all(s is None for s in spec[:len(lead)]):
        return spec[len(lead):]
    return spec


def _named_shapes(params) -> list[tuple[str, tuple[int, ...]]]:
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items() if isinstance(params, Mapping) else params)
    return [(n, tuple(p.shape)) for n, p in items]


def param_specs(cfg: ModelConfig, mesh, params) -> dict[str, tuple]:
    """{parameter name: spec} of ``params`` (a module, a mapping of
    names to tensors, or (name, tensor) pairs; shapes are all it reads).
    A spec longer than its leaf's rank leads with the entries of its
    stacked layer axes (see the module's docstring)."""
    rules = _param_rules(cfg, mesh)
    named = _named_shapes(params)
    extents = stack_extents(n for n, _ in named)
    return {n: _leaf_spec(rules, mesh, n, s, extents) for n, s in named}


def opt_specs(cfg: ModelConfig, mesh, opt_state: dict) -> dict:
    """Specs of an optimizer state ``{"m": {name: moment}, "v": ...,
    "step"}`` (``train.optimizer.init_opt_state``): fp32 moments as
    their parameters; an int8 moment's codes and scales each by its
    parameter's rule applied to its own shape (the scales drop the last
    axis's split where their block count does not divide by it)."""
    rules = _param_rules(cfg, mesh)
    extents = stack_extents(opt_state["m"])

    def spec(name, mom):
        if isinstance(mom, Mapping):
            return {k: _leaf_spec(rules, mesh, name, tuple(a.shape), extents)
                    for k, a in mom.items()}
        return _leaf_spec(rules, mesh, name, tuple(mom.shape), extents)

    out = {part: {n: spec(n, mom) for n, mom in opt_state[part].items()}
           for part in ("m", "v")}
    out["step"] = ()
    return out


# ---------------------------------------------------------------------- #
# batch / cache rules
# ---------------------------------------------------------------------- #
def batch_specs(mesh, batch: Mapping) -> dict[str, tuple]:
    """tokens/labels/mask: batch over (pod, data); M-RoPE positions lead
    with their (3,) axis; frame embeddings (B, S, d)."""

    def spec(name, shape):
        if name == "positions" and len(shape) == 3:
            return fit_spec(mesh, shape, (None, DATA, None))
        if name == "embeds":
            return fit_spec(mesh, shape, (DATA, None, None))
        return fit_spec(mesh, shape, (DATA,) + (None,) * (len(shape) - 1))

    return {k: spec(k, tuple(v.shape)) for k, v in batch.items()}


def _cache_leaf(mesh, name: str, shape, seq_parallel: bool) -> tuple:
    nd = len(shape)
    if name in ("k", "v"):          # (L, B, S, KV, HD)
        if seq_parallel:
            s = fit_spec(mesh, shape, (None, None, "data", "model", None))
            if s[3] is None:        # kv not divisible → split head_dim
                s = fit_spec(mesh, shape,
                             (None, None, "data", None, "model"))
            return s
        s = fit_spec(mesh, shape, (None, DATA, None, "model", None))
        if s[3] is None:
            s = fit_spec(mesh, shape, (None, DATA, None, None, "model"))
        return s
    if name in ("c_kv", "k_rope"):  # MLA latents (L, B, S, R)
        if seq_parallel:
            return fit_spec(mesh, shape, (None, None, "data", None))
        return fit_spec(mesh, shape, (None, DATA, None, None))
    if name == "conv":              # (SB, ap-1, B, dc-1, di)
        return fit_spec(mesh, shape, (None, None, DATA, None, "model"))
    if name == "ssm":               # (SB, ap-1, B, di, ds)
        return fit_spec(mesh, shape, (None, None, DATA, "model", None))
    if name == "c" and nd >= 4:     # mLSTM (SB, sp-1, B, H, dh, dh)
        if seq_parallel:
            return fit_spec(mesh, shape,
                            (None, None, None, None, "data", "model"))
        return fit_spec(mesh, shape,
                        (None,) * (nd - 4) + (DATA, None, "model", None))
    if name in ("n", "h", "m") or name == "c":
        return fit_spec(mesh, shape, (None,) * (nd - 3) + (DATA, None,
                                                           "model"))
    return fit_spec(mesh, shape, (None,) * nd)


def cache_specs(cfg: ModelConfig, mesh, cache: Mapping,
                seq_parallel: bool) -> dict:
    """KV / recurrent-state cache specs, the cache's nesting kept: batch
    over (pod, data), kv heads (or head_dim) over model; with
    ``seq_parallel`` (batch 1) the sequence dim over data."""

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else _cache_leaf(mesh, k, tuple(v.shape), seq_parallel)
                for k, v in node.items()}

    return walk(cache)
