"""The port's sharding rules, meshes and optimized configurations
against the JAX package's, on the CPU, with no devices: a mesh is its
axis sizes (the reference's ``AbstractMesh``).

For every architecture's published configuration on the meshes (16, 16),
(2, 16, 16), (4, 2), (2, 4) and (1, 1): ``param_specs`` leaf for leaf
(the port's leaf is one layer of the reference's stacked leaf, matched
by path as ``convert`` matches them, the stacked dims' entries dropped
where they are all None and kept where a rule splits a layer axis),
``opt_specs`` with fp32 and int8 moments, ``batch_specs`` and
``cache_specs`` with and without ``seq_parallel`` (the port's caches
built under ``FakeTensorMode``: shapes, no storage).  On the smoke
configurations, whose narrow dims hit ``fit_spec``'s divisibility drop,
each rank's local shape against the reference's ``shard_shape``.
``ici_topology`` against the reference's, ``optimized_config`` field
for field, and a forward pass of the qwen2-moe smoke with its
``moe_pad_to`` override and of the xLSTM smoke with its ``xlstm_chunk``
override against the reference's under the same override (the MoE and
xLSTM tests' tolerances).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import xlstm_model as ref_xlstm  # noqa: E402
from repro.sharding import specs as ref_specs  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (OPTIMIZED_OVERRIDES, SHAPES,  # noqa: E402
                                 get_arch, list_archs, optimized_config)
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import lm, registry, xlstm_model  # noqa: E402
from repro_torch.serve import golden  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.state import placement  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCHS = list_archs()
_CACHE = {}


def _mesh(key):
    return AbstractMesh(*MESHES[key])


def _norm(spec, ndim) -> tuple:
    """A spec as a tuple of ``ndim`` entries (an empty ``PartitionSpec``
    is all None)."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _ref_params(arch, kind="full"):
    key = ("ref", arch, kind)
    if key not in _CACHE:
        cfg = getattr(ref_get_arch(arch), kind)
        _CACHE[key] = (cfg, ref_registry.abstract_params(cfg))
    return _CACHE[key]


def _port_params(arch, kind="full"):
    key = ("port", arch, kind)
    if key not in _CACHE:
        cfg = getattr(get_arch(arch), kind)
        _CACHE[key] = (cfg, registry.init(cfg, device="meta"))
    return _CACHE[key]


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _expected(ref_spec, ref_shape, port_shape) -> tuple:
    """The port's spec for one layer of a stacked reference leaf: the
    stacked dims' entries dropped where all None, else kept."""
    full = _norm(ref_spec, len(ref_shape))
    lead = len(ref_shape) - len(port_shape)
    assert tuple(ref_shape[lead:]) == tuple(port_shape)
    return full[lead:] if all(s is None for s in full[:lead]) else full


# --------------------------------------------------------------------- #
# the published configurations on the five meshes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh_key):
    """``param_specs`` and ``opt_specs`` (fp32 and int8 moments) leaf for
    leaf; the leaves whose stacked layer axis a rule splits are where
    the reference's MoE rules of three dims meet a stacked dense FFN."""
    mesh = _mesh(mesh_key)
    ref_cfg, ref_tree = _ref_params(arch)
    cfg, model = _port_params(arch)
    want = ref_specs.param_specs(ref_cfg, mesh, ref_tree)
    got = specs.param_specs(cfg, mesh, model)
    names = [n for n, _ in model.named_parameters()]
    assert list(got) == names
    extents = specs.stack_extents(names)
    layered = set()
    for n, p in model.named_parameters():
        keys, _ = convert._split_name(n)
        ref_leaf = _node(ref_tree, keys)
        exp = _expected(_node(want, keys), ref_leaf.shape, p.shape)
        assert got[n] == exp, (n, got[n], exp)
        pl = placement(specs.axis_sizes(mesh), n, p.shape, got[n],
                       extents[tuple(keys)])
        if pl.owner:
            layered.add(keys[-2] if keys[-2] in ("shared", "ffn_dense")
                        else n)
    assert layered <= {"shared", "ffn_dense"}

    for md in ("float32", "int8"):
        ocfg = ref_opt.OptConfig(moment_dtype=md)
        ref_opt_tree = jax.eval_shape(
            lambda: ref_opt.init_opt_state(ocfg, ref_tree))
        want_o = ref_specs.opt_specs(ref_cfg, mesh, ref_opt_tree, want)
        port_opt = init_opt_state(OptConfig(moment_dtype=md), model)
        got_o = specs.opt_specs(cfg, mesh, port_opt)
        assert got_o["step"] == () and _norm(want_o["step"], 0) == ()
        for part in ("m", "v"):
            for n, mom in port_opt[part].items():
                keys, _ = convert._split_name(n)
                ref_node = _node(ref_opt_tree[part], keys)
                spec_node = _node(want_o[part], keys)
                if md == "int8":
                    for k in ("q", "s"):
                        exp = _expected(spec_node[k], ref_node[k].shape,
                                        mom[k].shape)
                        assert got_o[part][n][k] == exp, (md, n, k)
                else:
                    exp = _expected(spec_node, ref_node.shape, mom.shape)
                    assert got_o[part][n] == exp, (md, n)


def _batch_shapes(cfg, b, s):
    shapes = {"tokens": (b, s), "labels": (b, s), "mask": (b, s)}
    if cfg.family == "vlm":
        shapes["positions"] = (3, b, s)
    if cfg.family == "encdec":
        shapes["embeds"] = (b, cfg.enc_seq, cfg.d_model)
    return shapes


def _tree_equal(got, want_specs, want_tree, path=""):
    assert set(got) == set(want_tree), path
    for k, v in got.items():
        if isinstance(v, dict):
            _tree_equal(v, want_specs[k], want_tree[k], f"{path}/{k}")
        else:
            exp = _norm(want_specs[k], len(want_tree[k].shape))
            assert v == exp, (f"{path}/{k}", v, exp)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_key):
    """``batch_specs`` at train_4k's batch; ``cache_specs`` of the port's
    own cache (its nesting and shapes, which equal the reference's) at
    decode_32k with and without ``seq_parallel`` and at long_500k with
    it."""
    mesh = _mesh(mesh_key)
    ref_cfg, cfg = ref_get_arch(arch).full, get_arch(arch).full
    tr = SHAPES["train_4k"]
    shapes = _batch_shapes(cfg, tr.global_batch, tr.seq_len)
    want = ref_specs.batch_specs(mesh, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                        for k, s in shapes.items()})
    got = specs.batch_specs(mesh, {k: torch.empty(s, device="meta")
                                   for k, s in shapes.items()})
    assert got == {k: _norm(v, len(shapes[k])) for k, v in want.items()}

    for shape, sps in (("decode_32k", (False, True)), ("long_500k", (True,))):
        sh = SHAPES[shape]
        ref_cache = jax.eval_shape(lambda: ref_registry.init_cache(
            ref_cfg, sh.global_batch, sh.seq_len))
        with FakeTensorMode():
            cache = registry.init_cache(cfg, sh.global_batch, sh.seq_len,
                                        device="cpu")
        shapes_of = jax.tree.map(lambda a: tuple(a.shape), ref_cache)
        assert jax.tree.map(lambda a: tuple(a.shape), cache,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)) \
            == shapes_of
        for sp in sps:
            want_c = ref_specs.cache_specs(ref_cfg, mesh, ref_cache, sp)
            _tree_equal(specs.cache_specs(cfg, mesh, cache, sp), want_c,
                        ref_cache)


def _dropped(cfg, mesh, name, shape, extents) -> int:
    """The axes ``fit_spec`` drops from leaf ``name``'s rule for dims
    that do not divide."""
    keys, _ = convert._split_name(name)
    stacked = (*extents[tuple(keys)], *shape)
    rules = specs._param_rules(cfg, mesh)
    sizes = specs.axis_sizes(mesh)
    for nd in range(len(stacked), 0, -1):
        if (keys[-1], nd) in rules:
            raw = rules[(keys[-1], nd)]
            fit = specs.fit_spec(mesh, stacked, raw)[len(stacked) - nd:]
            return sum(any(a in sizes for a in specs.axes_of(r))
                       and f is None for r, f in zip(raw, fit))
    return 0


# --------------------------------------------------------------------- #
# the smoke configurations: each rank's local shapes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_key", ["4x2", "2x4", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_local_shapes_match_reference(arch, mesh_key):
    """A rank's shard of each parameter: the trailing dims of the
    reference's ``shard_shape`` (a leaf whose layer axis is split lives
    whole on the ranks holding its layer)."""
    mesh = _mesh(mesh_key)
    ref_cfg, ref_tree = _ref_params(arch, "smoke")
    cfg, model = _port_params(arch, "smoke")
    want = ref_specs.param_specs(ref_cfg, mesh, ref_tree)
    got = specs.param_specs(cfg, mesh, model)
    for n, p in model.named_parameters():
        keys, _ = convert._split_name(n)
        ref_leaf = _node(ref_tree, keys)
        ref_local = NamedSharding(mesh, _node(want, keys)).shard_shape(
            ref_leaf.shape)
        spec = got[n][len(got[n]) - p.dim():]
        local = specs.local_shape(tuple(p.shape), spec, mesh)
        assert local == tuple(ref_local[ref_leaf.ndim - p.dim():]), n


def test_smoke_meshes_hit_the_divisibility_drop():
    """The smoke cases above reach ``fit_spec``'s drop: xLSTM's narrow
    dims on every mesh, Jamba's on 2x4."""
    dropped = {}
    for mesh_key in ("4x2", "2x4", "2x16x16"):
        mesh = _mesh(mesh_key)
        for arch in ARCHS:
            cfg, model = _port_params(arch, "smoke")
            ext = specs.stack_extents(n for n, _ in model.named_parameters())
            dropped[mesh_key, arch] = sum(
                _dropped(cfg, mesh, n, p.shape, ext)
                for n, p in model.named_parameters())
    hit = {k for k, v in dropped.items() if v}
    assert ("2x16x16", "xlstm-1.3b") in hit
    assert {("4x2", "xlstm-1.3b"), ("2x4", "jamba-1.5-large-398b")} <= hit


# --------------------------------------------------------------------- #
# meshes and optimized configurations
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_ici_topology_matches_reference(mesh_key):
    mesh = _mesh(mesh_key)
    got, want = port_mesh.ici_topology(mesh), ref_mesh.ici_topology(mesh)
    assert (got.name, tuple(got.dims), tuple(got.wrap)) == \
        (want.name, tuple(want.dims), tuple(want.wrap))
    for f in ("coords", "channels", "io_weights", "channel_bw"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_production_mesh_needs_its_rank_count():
    """No process group up: a world of 1, and the error names the count."""
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need 8 ranks"):
        port_mesh.make_mesh_for_devices(4, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_config_matches_reference(arch):
    assert OPTIMIZED_OVERRIDES == ref_base.OPTIMIZED_OVERRIDES
    got = dataclasses.asdict(optimized_config(arch))
    want = dataclasses.asdict(ref_base.optimized_config(arch))
    assert got == want


def test_moe_pad_to_forward_matches_reference(torch_one_thread):  # noqa: F811
    """qwen2-moe's smoke with its override's dummy experts: logits within
    1e-5 and the auxiliary loss within 1e-6 (``test_torch_moe.py``)."""
    over = OPTIMIZED_OVERRIDES["qwen2-moe-a2.7b"]
    cfg = get_arch("qwen2-moe-a2.7b").smoke.replace(**over)
    ref_cfg = ref_get_arch("qwen2-moe-a2.7b").smoke.replace(**over)
    tree, prompts = golden.lm_numpy_case(cfg)
    assert tree["blocks"]["ffn"]["w_gate"].shape[1] == 64
    with reference():
        want, want_aux = ref_lm.forward(ref_cfg, jax.tree.map(jnp.asarray,
                                                              tree),
                                        jnp.asarray(prompts))
    got, aux = lm.forward(cfg, convert.dense_params_from_numpy(tree, cfg,
                                                               "cpu"),
                          torch.as_tensor(prompts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_xlstm_chunk_forward_matches_reference(torch_one_thread):  # noqa: F811
    """The xLSTM smoke at its override's chunk of 256, over 300 tokens (a
    whole chunk and a ragged one): logits within atol 2e-5, rtol 1e-5
    (``test_torch_xlstm.py``)."""
    over = OPTIMIZED_OVERRIDES["xlstm-1.3b"]
    cfg = get_arch("xlstm-1.3b").smoke.replace(**over)
    ref_cfg = ref_get_arch("xlstm-1.3b").smoke.replace(**over)
    assert cfg.xlstm_chunk == 256 > get_arch("xlstm-1.3b").smoke.xlstm_chunk
    tree, prompts = golden.xlstm_numpy_case(cfg, batch=2, prompt_len=300)
    with reference():
        want, _ = ref_xlstm.forward(ref_cfg, jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(prompts))
    got, _ = xlstm_model.forward(cfg, convert.xlstm_params_from_numpy(
        tree, cfg, "cpu"), torch.as_tensor(prompts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
