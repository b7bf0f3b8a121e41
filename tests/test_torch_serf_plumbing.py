"""PyTorch port vs the JAX reference: the serf→server plumbing
(``consul_tpu_torch/server/serf_plumbing.py``) on the reference tests'
own flows (tests/test_serf_plumbing.py).

- ``build_tags`` / ``parse_tags`` and ``LanEventHandler``: the reference's
  tests run on both sides with equal transcripts (``torch_server_parity``;
  the LAN handler's flows in tests/test_torch_endpoints.py).
- ``TestSimToCatalogSlice`` at its n = 48, K = 16: the port's dense serf
  tick, fed the reference's initial state and its key ladder
  (``torch_parity``), kills the same view neighbour and runs the same 300
  ticks; ``members_from_sim`` on the port's dense state and on its packed
  form equals the reference's list, and the catalog each side's leader
  reconciles from its list holds the same checks (critical for the
  victim, passing for every member seen alive).
- ``TestCoordinateSlice`` at n = 64, 8 seats: both sides'
  ``sync_coordinates`` read the reference's state after 400 ticks (the
  port's dense copy and its packed form); the stored coordinates agree
  within ``torch_parity``'s float tolerances (bfloat16's for the packed
  form) and ``Catalog.ListNodes near=`` returns the same order. The port's
  own 400-tick simulation then meets the reference test's bounds (RMSE of
  the stored coordinates < 15 ms, the nearest stored node among the true
  top 3).
- Neither reader unpacks the whole state: ``layout.unpack`` raises on any
  input with ``cfg.n`` rows while they run, and each copies only the rows
  it reads to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serf_plumbing
import torch_parity as tp
import torch_server_parity as sp
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import coalesce as jcoalesce
from consul_tpu.models import serf as jserf
from consul_tpu.models import state as jstate
from consul_tpu.ops import topology as jtopo
from consul_tpu.server import endpoints as jendpoints
from consul_tpu.server import serf_plumbing as jplumb
from consul_tpu_torch import convert
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import coalesce as tcoalesce
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.ops import topology as ttopo
from consul_tpu_torch.server import endpoints as tendpoints
from consul_tpu_torch.server import rtt as trtt
from consul_tpu_torch.server import serf_plumbing as tplumb
from torch_parity import quick_reference_compiles  # noqa: F401

SLICE_N, SLICE_K, SLICE_TICKS = 48, 16, 300
COORD_N, COORD_K, COORD_TICKS = 64, 16, 400
SEATS = list(range(0, COORD_N, 8))


@pytest.mark.parametrize("case", [
    "TestTags.test_server_tags_roundtrip",
    "TestTags.test_client_member_is_not_server",
    "TestTags.test_malformed_tags_never_crash"])
def test_tags_match_reference(monkeypatch, tmp_path, case):
    (_, mod, cls, fn, params), = sp.flows(test_serf_plumbing, [case])
    sp.assert_same(monkeypatch, mod, cls, fn, params, tmp_path=tmp_path)


# ----------------------------------------------------------------------
# The membership slice (tests/test_serf_plumbing.py:84-133)
# ----------------------------------------------------------------------

def _slice_setup():
    jcfg, tcfg = tp.configs(n=SLICE_N, view_degree=SLICE_K)
    kw, kn, ks = jax.random.split(jax.random.PRNGKey(3), 3)
    world = jtopo.make_world(jcfg, kw)
    topo = jtopo.make_topology(jcfg, kn)
    state = jserf.init(jcfg, ks)
    victim = int(jtopo.nbrs_table(topo)[0, 3])
    return jcfg, tcfg, world, topo, state, victim


def _reference_slice():
    """The reference test's run: its members list after 300 ticks."""
    jcfg, _, world, topo, state, victim = _slice_setup()
    step = jax.jit(lambda st, k: jserf.step(jcfg, topo, world, st, k))
    state = state._replace(
        swim=jstate.kill(state.swim, jnp.arange(jcfg.n) == victim))
    base = jax.random.PRNGKey(9)
    for i in range(SLICE_TICKS):
        state = step(state, jax.random.fold_in(base, i))
    return jplumb.members_from_sim(jcfg, topo, state, observer=0)


@pytest.fixture(scope="module")
def membership(tmp_path_factory):
    """(the reference's members list, the port's dense serf state after
    the same run, the port's config and topology, the victim), once per
    session (``torch_parity.shared``)."""
    return tp.shared(tmp_path_factory, "serf_plumbing/slice n48 k16 t300",
                     _membership)


def _membership():
    want = _reference_slice()
    jcfg, tcfg, world, topo, state, victim = _slice_setup()
    draws_fn = tp.make_serf_draws_fn(jcfg)
    tworld = convert.world_from(tp.np_tree(world))
    ttop = convert.topology_from(tp.np_tree(topo))
    st = convert.serf_state_from(tp.np_tree(state))
    st = st._replace(swim=tstate.kill(
        st.swim, torch.arange(SLICE_N) == victim))
    base = jax.random.PRNGKey(9)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(SLICE_TICKS))
    ladder = jax.device_get(jax.vmap(draws_fn)(keys))
    for i in range(SLICE_TICKS):
        d = tp.to_serf_draws(jax.tree.map(lambda x: x[i], ladder))
        st = tserf.step(tcfg, ttop, tworld, st, d)
    return want, st, tcfg, ttop, victim


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_members_from_sim_matches_reference(membership, layout):
    want, st, tcfg, ttop, victim = membership
    if layout == "packed":
        st = tlayout.pack_state(st)
        assert tlayout.is_packed(st)
    got = tplumb.members_from_sim(tcfg, ttop, st, observer=0)
    assert got == want
    by_name = {m["name"]: m for m in got}
    assert by_name[f"sim-{victim}"]["status"] == "failed"
    assert by_name["sim-0"]["status"] == "alive"
    assert sum(m["status"] == "alive" for m in got) == ttop.degree


def _catalog_checks(endpoints, coalesce, plumb, members):
    """The reference test's catalog half (tests/test_serf_plumbing.py:
    108-133) on one side: join every member, then the observed states,
    and return the leader's serfHealth checks."""
    c = endpoints.ServerCluster(3, seed=43)
    leader = c.wait_converged()
    h = plumb.LanEventHandler(leader, c)
    h.handle_events([coalesce.Event(coalesce.MEMBER_JOIN, name=m["name"])
                     for m in members])
    c.step(120)
    h.handle_events([coalesce.Event(
        coalesce.MEMBER_JOIN if m["status"] == "alive"
        else coalesce.MEMBER_FAILED, name=m["name"]) for m in members])
    c.step(120)
    h.handle_events([])
    c.step(120)
    return {ch["node"]: ch["status"] for ch in leader.store.checks()}


def test_reconciled_catalog_matches_reference(membership):
    want, st, tcfg, ttop, victim = membership
    got = tplumb.members_from_sim(tcfg, ttop, tlayout.pack_state(st), 0)
    ref = _catalog_checks(jendpoints, jcoalesce, jplumb, want)
    port = _catalog_checks(tendpoints, tcoalesce, tplumb, got)
    assert port == ref
    assert port[f"sim-{victim}"] == "critical"
    alive = [m["name"] for m in got if m["status"] == "alive"]
    assert all(port.get(n) == "passing" for n in alive)


# ----------------------------------------------------------------------
# The coordinate slice (tests/test_serf_plumbing.py:136-186)
# ----------------------------------------------------------------------

def _reference_coords():
    """The reference test's run: the simulation's world, topology and
    dense state after 400 ticks, and the coordinates its leader stored."""
    jcfg, _ = tp.configs(n=COORD_N, view_degree=COORD_K)
    sim = jcluster.Simulation(jcfg, seed=2)
    sim.run(COORD_TICKS, chunk=100, with_metrics=False)
    c = jendpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    stored, order = _store_coords(c, leader, jplumb, sim)
    return dict(world=tp.np_tree(sim.world), topo=tp.np_tree(sim.topo),
                state=tp.np_tree(sim.state), stored=stored, order=order)


def _store_coords(c, leader, plumb, sim):
    for s in SEATS:
        leader.rpc("Catalog.Register", node=f"sim-{s}", address=f"sim-{s}")
    c.step(120)
    assert plumb.sync_coordinates(sim, leader, SEATS) == len(SEATS)
    assert leader.flush_coordinates()
    c.step(120)
    stored = {r["node"]: r["coord"] for r in leader.store.coordinates()}
    out = leader.rpc("Catalog.ListNodes", near="sim-0")
    return stored, [r["node"] for r in out["value"]]


@pytest.fixture(scope="module")
def coords(tmp_path_factory):
    return tp.shared(tmp_path_factory, "serf_plumbing/coords n64 k16 t400",
                     _reference_coords)


def _port_sim(ref, layout):
    _, tcfg = tp.configs(n=COORD_N, view_degree=COORD_K)
    st = convert.sim_state_from(ref["state"])
    return tcluster.Simulation(
        tcfg, seed=0, layout=layout, kernel="torch", device="cpu",
        world=convert.world_from(ref["world"]),
        topo=convert.topology_from(ref["topo"]),
        state=st if layout == "dense" else tlayout.pack(st))


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_sync_coordinates_matches_reference(coords, layout):
    sim = _port_sim(coords, layout)
    c = tendpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    stored, order = _store_coords(c, leader, tplumb, sim)
    assert set(stored) == set(coords["stored"]) == {f"sim-{s}" for s in SEATS}
    rtol, atol = ((tp.VIV_RTOL, tp.VIV_ATOL) if layout == "dense"
                  else (tp.PACKED_RTOL, tp.PACKED_ATOL))
    for node, want in coords["stored"].items():
        got = stored[node]
        for f in ("vec", "height", "error", "adjustment"):
            np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=atol,
                                       err_msg=f"{layout} {node} {f}")
    assert order == coords["order"]


def test_port_coordinate_slice_meets_reference_bounds():
    """The reference test's own bounds on the port's own run."""
    _, tcfg = tp.configs(n=COORD_N, view_degree=COORD_K)
    sim = tcluster.Simulation(tcfg, seed=2, layout="packed", kernel="torch",
                              device="cpu")
    sim.run(COORD_TICKS, chunk=100, with_metrics=False)
    c = tendpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    stored, order = _store_coords(c, leader, tplumb, sim)
    errs = [trtt.compute_distance(stored["sim-0"], stored[f"sim-{a}"])
            - float(ttopo.true_rtt(sim.world, 0, a)) for a in SEATS[1:]]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert rmse < 0.015, f"stored-coordinate RMSE {rmse * 1000:.1f} ms"
    ranked = [n for n in order if n != "sim-0"]
    true_rank = sorted(SEATS[1:],
                       key=lambda a: float(ttopo.true_rtt(sim.world, 0, a)))
    assert ranked[0] in {f"sim-{a}" for a in true_rank[:3]}


# ----------------------------------------------------------------------
# No whole-state unpack
# ----------------------------------------------------------------------

def test_readers_never_unpack_the_whole_state(monkeypatch, membership,
                                              coords):
    want, st, tcfg, ttop, _ = membership
    packed = tlayout.pack_state(st)
    sim = _port_sim(coords, "packed")
    real = tlayout.unpack
    seen = []

    def guarded(p):
        rows = p.flags.shape[0]
        seen.append(rows)
        assert rows not in (SLICE_N, COORD_N), f"unpacked {rows} rows"
        return real(p)

    monkeypatch.setattr(tlayout, "unpack", guarded)
    before = tplumb.STATS["d2h_bytes"]
    assert tplumb.members_from_sim(tcfg, ttop, packed, 0) == want
    row_bytes = tplumb.STATS["d2h_bytes"] - before
    # One row: view_key and down_since of K columns and the tick, int64.
    assert row_bytes == (2 * SLICE_K + 1) * 8
    c = tendpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    before = tplumb.STATS["d2h_bytes"]
    assert tplumb.sync_coordinates(sim, leader, SEATS) == len(SEATS)
    d = tcfg.vivaldi.dimensionality
    assert tplumb.STATS["d2h_bytes"] - before == len(SEATS) * (d + 3) * 4
    assert seen == [1, len(SEATS)]


def test_sync_coordinates_refuses_a_mesh():
    """A meshed state is only whole once gathered from every shard, so
    the coordinate reader refuses it as the packet bridge does."""
    cfg = tp.configs(n=64, view_degree=16)[1]
    sim = tcluster.Simulation(cfg, seed=1, kernel="torch", device="cpu",
                              mesh=["cpu"] * 2)
    c = tendpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    with pytest.raises(ValueError, match="one device"):
        tplumb.sync_coordinates(sim, leader, SEATS)
    leader.flush_coordinates()
    assert leader.store.coordinates() == []
