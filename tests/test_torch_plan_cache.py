"""The port's content-addressed plan cache (``repro_torch.core.plan_cache``)
and the planner's use of it (``plan_fast``'s ``cache=``).

* ``topology_fingerprint`` and the plan key are the reference's strings
  (the port plans in fp64, as the reference does on the CPU);
* a cached plan comes back bit for bit as a fresh build, with its
  certificate's verdict;
* a warm batched build plans nothing: no planner run, no possibility
  launch; a warm-started (``w0``) build is never stored.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.core import plan_cache as jcache  # noqa: E402
from repro.core import plan_fast as jfast  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import plan_fast  # noqa: E402
from repro_torch.core.nrank import initial_weights  # noqa: E402
from repro_torch.core.plan_cache import (PlanCache, plan_key,  # noqa: E402
                                         topology_fingerprint)

TOPOS = {
    "mesh4x4": lambda m: m.mesh2d(4, 4),
    "torus6x6": lambda m: m.torus(6, 6),
    "fault_region": lambda m: m.fault_region_mesh(5, 5, (1, 1, 2, 2)),
}


def _down(topo):
    """Both directions of the first link, or the region's dead channels."""
    if topo.down_channels.size:
        return topo.down_channels
    u, n = (int(x) for x in topo.channels[0])
    return np.array([topo.channel_index(u, n), topo.channel_index(n, u)])


@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("name", sorted(TOPOS))
def test_keys_match_reference(name, down):
    jt, tt = TOPOS[name](jcore), TOPOS[name](tcore)
    tm = tcore.traffic.transpose(tt)
    dc = _down(tt) if down else None
    with reference():
        want_fp = jcache.topology_fingerprint(jt)
        want = jfast.plan_cache_key(jt, tm, down_channels=dc)
        want_k = jfast.plan_cache_key(jt, tm, down_channels=dc,
                                      k_orders=True, w_th=0.02, iter_th=50)
    assert topology_fingerprint(tt) == want_fp
    assert plan_fast.plan_cache_key(tt, tm, down_channels=dc) == want
    assert plan_fast.plan_cache_key(tt, tm, down_channels=dc, k_orders=True,
                                    w_th=0.02, iter_th=50) == want_k
    # a bool mask keys as its channel ids
    if dc is not None:
        mask = np.zeros(tt.num_channels, bool)
        mask[dc] = True
        assert plan_key(tt, tm, down_channels=mask, w_th=0.01,
                        iter_th=100) == want


def _same_plan(a, b):
    ta, tb = a.table, b.table
    assert np.array_equal(ta.choice, tb.choice)
    assert ta.choice.dtype == tb.choice.dtype == np.int8
    assert np.array_equal(ta.costs, tb.costs)
    assert np.array_equal(ta.port_tables, tb.port_tables)
    assert ta.orders == tb.orders
    assert (ta.unroutable is None) == (tb.unroutable is None)
    if ta.unroutable is not None:
        assert np.array_equal(ta.unroutable, tb.unroutable)
    for f in ("w_nr", "w0", "w_final", "p", "p_drn", "w_possibility"):
        assert np.array_equal(getattr(a.nrank, f), getattr(b.nrank, f)), f
    assert a.nrank.iterations == b.nrank.iterations
    assert np.array_equal(a.traffic, b.traffic)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_round_trip_is_bit_identical(tmp_path, name):
    topo = TOPOS[name](tcore)
    tm = tcore.traffic.transpose(topo)
    dc = topo.down_channels if topo.down_channels.size else None
    fresh = plan_fast.build_plan_fast(topo, tm, down_channels=dc,
                                      device="cpu")
    cache = PlanCache(str(tmp_path))
    stored = plan_fast.build_plan_fast(topo, tm, down_channels=dc,
                                       device="cpu", cache=cache)
    assert cache.stats.as_dict() == {"hits": 0, "misses": 1, "stores": 1,
                                     "device_builds": 1}
    key = plan_fast.plan_cache_key(topo, tm, down_channels=dc)
    assert key in cache
    got = PlanCache(str(tmp_path)).get(key, topo)
    _same_plan(got, fresh)
    _same_plan(stored, fresh)
    cert = cache.get_cert(key)
    assert cert is not None and cert.verdict == fresh.cert.verdict
    assert cert.cdg_edges == fresh.cert.cdg_edges
    # served from the cache: the same plan, its certificate attached
    again = plan_fast.build_plan_fast(topo, tm, down_channels=dc,
                                      device="cpu", cache=cache)
    _same_plan(again, fresh)
    assert again.cert.verdict == fresh.cert.verdict
    assert cache.stats.hits == 1 and cache.stats.device_builds == 1


def test_entry_without_a_certificate_is_certified_again(tmp_path):
    """A miss has no certificate; an entry stored without one is served
    only after the gate certifies it again."""
    topo = tcore.mesh2d(3, 3)
    tm = tcore.traffic.uniform(topo)
    cache = PlanCache(str(tmp_path))
    assert cache.get_cert("0" * 64) is None
    assert cache.get("0" * 64, topo) is None
    assert cache.stats.misses == 1
    plan = plan_fast.build_plan_fast(topo, tm, device="cpu")
    key = plan_fast.plan_cache_key(topo, tm)
    cache.put(key, dataclasses.replace(plan, cert=None))
    assert key in cache and cache.get_cert(key) is None
    again = plan_fast.build_plan_fast(topo, tm, device="cpu", cache=cache)
    assert again.cert is not None and again.cert.verdict == "clean"
    _same_plan(again, plan)


def test_warm_batched_build_plans_nothing(tmp_path, monkeypatch):
    topo = tcore.mesh2d(4, 4)
    tms = [tcore.traffic.uniform(topo), tcore.traffic.transpose(topo)]
    cache = PlanCache(str(tmp_path))
    cold = plan_fast.build_plans_batched(topo, tms, device="cpu",
                                         cache=cache)
    assert cache.stats.device_builds == 1 and cache.stats.stores == 2

    calls = []
    real = plan_fast.possibility_v

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(plan_fast, "possibility_v", counting)
    warm_cache = PlanCache(str(tmp_path))
    warm = plan_fast.build_plans_batched(topo, tms, device="cpu",
                                         cache=warm_cache)
    assert calls == []
    assert warm_cache.stats.as_dict() == {"hits": 2, "misses": 0,
                                          "stores": 0, "device_builds": 0}
    for a, b in zip(warm, cold):
        _same_plan(a, b)
    # one miss among hits: one planner run for the missing lane alone
    third = tcore.traffic.PATTERNS["tornado"](topo)
    mixed = plan_fast.build_plans_batched(topo, tms + [third],
                                          device="cpu", cache=warm_cache)
    assert len(calls) == 1 and warm_cache.stats.device_builds == 1
    _same_plan(mixed[2], plan_fast.build_plan_fast(topo, third,
                                                   device="cpu"))


def test_warm_started_build_is_not_stored(tmp_path):
    topo = tcore.mesh2d(4, 4)
    tm = tcore.traffic.uniform(topo)
    cache = PlanCache(str(tmp_path))
    first = plan_fast.build_plan_fast(topo, tm, device="cpu")
    w0 = initial_weights(tm) + first.nrank.w_final
    plan_fast.build_plan_fast(topo, tm, w0=w0, device="cpu", cache=cache)
    plan_fast.build_plans_batched(topo, [tm], w0s=[w0], device="cpu",
                                  cache=cache)
    assert cache.stats.stores == 0 and cache.stats.hits == 0
    assert cache.stats.misses == 0
    assert not list(tmp_path.iterdir())
