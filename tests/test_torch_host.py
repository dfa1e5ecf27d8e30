"""The port's host modules (numpy copies) and simulator tables against
the reference, array for array."""

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.core import certify as jcert, routes as jroutes  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import certify as tcert, routes as troutes  # noqa: E402
from repro_torch.noc import sim as tsim  # noqa: E402

TOPOS = {"mesh4x4": ("mesh2d", (4, 4)), "edge5x5": ("mesh2d_edge_io", (5, 5))}


def _pair(name):
    fn, args = TOPOS[name]
    return getattr(jcore, fn)(*args), getattr(tcore, fn)(*args)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_topology(name):
    j, t = _pair(name)
    for f in ("coords", "channels", "io_weights", "channel_bw", "distances",
              "neighbor_table", "channel_port", "port_of_channel_at_receiver",
              "coord_strides"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.num_ports, j.port_local, j.route_horizon) == (
        t.num_ports, t.port_local, t.route_horizon)


ZOO = [("mesh2d", (7, 5)), ("torus", (4, 5)), ("torus", (3, 3, 3)),
       ("cmesh", (3, 3, 2)), ("express_mesh", (6, 6)),
       ("fault_region_mesh", (6, 6, (2, 2, 3, 3))), ("multipod", (2, 3, 3))]


@pytest.mark.parametrize("fn,args", ZOO, ids=[f for f, _ in ZOO])
def test_distances_on_the_zoo(fn, args):
    """The port's BFS (in-neighbour gathers) gives the reference's hop
    distances, unreachable pairs included."""
    assert np.array_equal(getattr(jcore, fn)(*args).distances,
                          getattr(tcore, fn)(*args).distances)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_traffic_patterns(name):
    j, t = _pair(name)
    for pat in ("uniform", "tornado", "overturn", "shuffle", "permutation",
                "hotspot"):
        assert np.array_equal(jcore.traffic.PATTERNS[pat](j),
                              tcore.traffic.PATTERNS[pat](t)), pat


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_routes_and_dor_table(name):
    j, t = _pair(name)
    for order in jroutes.dimension_orders(2):
        assert np.array_equal(jroutes.next_hop_table(j, order),
                              troutes.next_hop_table(t, order))
        assert np.array_equal(jroutes.next_port_table(j, order),
                              troutes.next_port_table(t, order))
        assert np.array_equal(jroutes.walk_routes(j, order),
                              troutes.walk_routes(t, order))
    jd, td = jcore.dor_table(j), tcore.dor_table(t)
    for f in ("choice", "costs", "port_tables"):
        assert np.array_equal(getattr(jd, f), getattr(td, f)), f


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_certify(name):
    """The certifier's verdict and CDG on a random choice table."""
    j, t = _pair(name)
    rng = np.random.default_rng(5)
    choice = rng.integers(0, 2, (j.num_nodes,) * 2).astype(np.int8)
    ports = jcore.dor_table(j).port_tables
    cj = jcert.certify_ports(j, ports, choice)
    ct = tcert.certify_ports(t, ports, choice)
    assert (cj.verdict, cj.cyclic_nodes) == (ct.verdict, ct.cyclic_nodes)
    for k, a in cj.as_arrays().items():
        assert np.array_equal(a, ct.as_arrays()[k]), k
    ej, _ = jcert.build_cdg(j, ports, choice)[:2]
    et, _ = tcert.build_cdg(t, ports, choice)[:2]
    assert np.array_equal(ej, et)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_build_tables(name):
    """Every table field the port keeps (the reference's fields for the
    algorithms and the watchdog not ported yet are left out), and the
    reference's tables carried in through ``convert.tables_from_numpy``."""
    j, t = _pair(name)
    tm = jcore.traffic.uniform(j)
    with reference():
        jt, jmeta = jsim.build_tables(j, tm, None, 2)
        jt = type(jt)(*[np.asarray(x) for x in jt])
    tt, tmeta = tsim.build_tables(t, tm, None, 2, device="cpu")
    assert jmeta == tmeta
    assert set(tt._fields) <= set(jt._fields)
    for f in tt._fields:
        a, b = getattr(jt, f), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    carried = convert.tables_from_numpy(jt, device="cpu")
    for f in tt._fields:
        assert np.array_equal(getattr(carried, f).numpy(), getattr(jt, f))
