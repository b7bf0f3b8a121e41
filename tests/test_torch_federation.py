"""PyTorch port vs the JAX reference: the federation of LAN pools and the
WAN pool (``consul_tpu_torch/models/federation.py``), with the port's
``server/router.py``.

- The reference's ``Federation(n_dc=3, nodes_per_dc=48, servers_per_dc=3)``
  as tests/test_federation.py builds it: 60 ticks to form, a non-server
  node of dc0 killed, dc2 killed whole, 150 ticks more. The port starts
  from the reference's worlds, topologies and state (``convert.py``) and
  draws each tick from the reference's key ladder (``fold_in(base_key,
  t)``, split into LAN and WAN, the LAN key split n_dc ways; the WAN bundle
  only on fire ticks). At every chunk boundary the packed LAN and WAN
  states unpack to the reference's: the discrete plane bit-identical, the
  Vivaldi and RTT floats within tests/test_layout_parity.py's tolerance
  (the port keeps them packed at rest, in bfloat16 and float8); the
  cumulative ``GossipCounters`` of every DC and of the WAN pool equal the
  reference's ``swim.step_counted`` replayed on each tick's inputs; and
  ``lan_health``, ``wan_health``, ``wan_server_coord``,
  ``wan_members_seen_by`` and ``true_dc_distance_order`` equal the
  reference's.
- Port only: a run split into calls at other ticks (``chunk`` is the
  reference's signature only) leaves the trajectory as it is; a mesh
  without a ``dc`` axis raises (tests/test_torch_fed_mesh.py holds
  ``mesh=`` to one device); ``kernel="cuda"`` without a card raises; the
  port's ``Router`` orders DCs as the reference's on the same coordinates;
  ``swim.step`` is ``step_counted`` without its counters; ``nbrs_table``
  equals the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models import federation as jfed_mod
from consul_tpu.ops import topology as jtopo
from consul_tpu.server.router import Router as JRouter
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.models import federation as tfed_mod
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.ops import topology as ttopo
from consul_tpu_torch.server.router import Router as TRouter

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

FIELDS = tcounters.FIELDS
KW = dict(n_dc=3, nodes_per_dc=48, servers_per_dc=3)
SEED = 4
CHUNK = 30
FORM, AFTER = 60, 150


def kill_dense(jcfg, st, dc, mask):
    """The reference's ``Federation.kill`` on a dense FederationState."""
    mask = jnp.asarray(mask, bool)
    s = jcfg.servers_per_dc
    g = (jcfg.dc_offset + dc) * s
    return st._replace(
        lan=st.lan._replace(alive_truth=st.lan.alive_truth.at[dc].set(
            st.lan.alive_truth[dc] & ~mask)),
        wan=st.wan._replace(alive_truth=st.wan.alive_truth.at[g:g + s].set(
            st.wan.alive_truth[g:g + s] & ~mask[:s])))


@pytest.fixture(scope="module")
def federation_run():
    """The reference's Federation and the port side by side in chunks, and
    the reference's tick rounded through the packed codec with its
    counters (torch_parity.fed_oracle) tick by tick; snapshots of all
    three at every chunk boundary."""
    jcfg, tcfg = tp.fed_configs(**KW)
    jfed = jfed_mod.Federation(jcfg, seed=SEED)
    tfed = tp.port_federation(jcfg, tcfg, jfed)
    oracle = tp.fed_oracle(jcfg, jfed.lan_topo, jfed.wan_topo)
    ost = oracle.start(jfed.state)
    lan_c = np.zeros((jcfg.n_dc, len(FIELDS)), np.int64)
    wan_c = np.zeros(len(FIELDS), np.int64)
    points = []

    def advance(ticks):
        nonlocal ost, lan_c, wan_c
        for _ in range(ticks // CHUNK):
            for _ in range(CHUNK):
                key = jax.random.fold_in(jfed.base_key, tfed._t)
                ost, lc, wc = oracle(jfed.lan_world, jfed.wan_world, ost, key)
                lan_c = lan_c + np.asarray(lc, np.int64)
                wan_c = wan_c + np.asarray(wc, np.int64)
                tfed.run(1, chunk=CHUNK)
            jfed.run(CHUNK, chunk=CHUNK)
            points.append((tfed._t, tp.np_tree(jfed.state), tp.np_tree(ost),
                           tfed.state, tfed.counters(), lan_c.copy(),
                           wan_c.copy()))

    advance(FORM)
    victim = np.arange(KW["nodes_per_dc"]) == 10
    everyone = np.ones(KW["nodes_per_dc"], bool)
    for side in (jfed, tfed):
        side.kill(0, victim)
        side.kill_dc(2)
    ost = kill_dense(jcfg, kill_dense(jcfg, ost, 0, victim), 2, everyone)
    advance(AFTER)
    return jcfg, tcfg, jfed, tfed, points


def test_federation_matches_reference_at_every_chunk_boundary(federation_run):
    jcfg, tcfg, jfed, tfed, points = federation_run
    assert [p[0] for p in points] == list(range(CHUNK, FORM + AFTER + 1, CHUNK))
    fired = 0
    for t, ref, rounded, got, cnt, lan_c, wan_c in points:
        tp.assert_fed_state(ref, got, f"tick {t}")
        tp.assert_fed_close(rounded, got, f"tick {t}")
        for i in range(jcfg.n_dc):
            assert cnt["lan"][i] == dict(zip(FIELDS, lan_c[i].tolist())), \
                f"tick {t} dc{i} counters"
        assert cnt["wan"] == dict(zip(FIELDS, wan_c.tolist())), \
            f"tick {t} WAN counters"
        fired = int(ref.wan.t)
    # 2 of every 5 LAN ticks fire the WAN tick; the kill left its marks.
    assert fired == (FORM + AFTER) * 2 // 5
    last = points[-1]
    assert last[6][FIELDS.index("suspicions_started")] > 0
    assert last[5][0][FIELDS.index("deaths_declared")] > 0


def test_federation_readouts_match_reference(federation_run):
    jcfg, tcfg, jfed, tfed, _ = federation_run
    for dc in range(jcfg.n_dc):
        want, got = jfed.lan_health(dc), tfed.lan_health(dc)
        for name in ("agreement", "false_positive", "undetected"):
            assert np.float32(getattr(got, name)) == \
                np.asarray(getattr(want, name)), (dc, name)
        assert int(got.live_nodes) == int(want.live_nodes)
    assert int(tfed.lan_health(0).live_nodes) == KW["nodes_per_dc"] - 1
    assert int(tfed.lan_health(1).live_nodes) == KW["nodes_per_dc"]
    assert int(tfed.lan_health(2).live_nodes) == 0
    want, got = jfed.wan_health(), tfed.wan_health()
    for name in ("agreement", "false_positive", "undetected", "live_nodes"):
        assert float(getattr(got, name)) == float(getattr(want, name)), name
    for dc in range(jcfg.n_dc):
        for s in range(jcfg.servers_per_dc):
            w, g = jfed.wan_server_coord(dc, s), tfed.wan_server_coord(dc, s)
            np.testing.assert_allclose(
                [*g["vec"], g["error"], g["height"], g["adjustment"]],
                [*w["vec"], w["error"], w["height"], w["adjustment"]],
                rtol=tp.PACKED_RTOL, atol=tp.PACKED_ATOL)
    for obs in range(jcfg.n_dc):
        assert tfed.wan_members_seen_by(obs) == jfed.wan_members_seen_by(obs)
    seen = {m["status"] for m in tfed.wan_members_seen_by(0) if m["dc"] == "dc2"}
    assert seen and "alive" not in seen
    for dc in range(jcfg.n_dc):
        assert tfed.true_dc_distance_order(dc) == jfed.true_dc_distance_order(dc)


def _router_order(cls, fed, cfg):
    router = cls("dc0")
    for dc in range(cfg.n_dc):
        for s in range(cfg.servers_per_dc):
            router.add_server(f"srv{s}.dc{dc}", f"dc{dc}",
                              coord=fed.wan_server_coord(dc, s))
    for m in fed.wan_members_seen_by(0):
        router.add_server(m["id"], m["dc"])
    return router.get_datacenters_by_distance(), router.find_route("dc1")


def test_port_router_orders_dcs_as_the_reference(federation_run):
    jcfg, tcfg, jfed, tfed, _ = federation_run
    # Both routers read the same coordinates: the port's.
    assert _router_order(TRouter, tfed, tcfg) == _router_order(JRouter, tfed, tcfg)
    got, route = _router_order(TRouter, tfed, tcfg)
    assert route is not None
    assert got[0] == "dc0" and sorted(got) == ["dc0", "dc1", "dc2"]


def test_chunk_length_leaves_the_trajectory():
    """``chunk`` is the reference's signature only: a run split into calls
    at other ticks, with other chunk arguments, follows one trajectory (the
    tick count, the WAN accumulator and the draw generator carry across
    calls, through a kill between them)."""
    cfg = tfed_mod.FederationConfig(n_dc=2, nodes_per_dc=32, servers_per_dc=2,
                                    lan=TSimConfig(view_degree=8))
    a = tfed_mod.Federation(cfg, seed=3, device="cpu", kernel="torch")
    b = tfed_mod.Federation(cfg, seed=3, device="cpu", kernel="torch")
    a.run(23, chunk=23)
    b.run(9, chunk=2)
    b.run(14, chunk=7)
    b.kill(1, np.arange(32) == 0)
    a.kill(1, np.arange(32) == 0)
    a.run(5, chunk=5)
    a.run(7, chunk=3)
    b.run(12, chunk=12)
    assert a.state.wan_accum_ms == b.state.wan_accum_ms
    for sa, sb in zip([*a.state.lan, a.state.wan], [*b.state.lan, b.state.wan]):
        for x, y in zip(tlayout.leaves(sa), tlayout.leaves(sb)):
            assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                               y.view(torch.uint8) if y.dim() else y)
    assert a.counters() == b.counters()
    assert int(a.state.wan.flags[2]) & 1 == 0   # dc1's server 0 is dead
    assert a.counters()["wan"]["probes_sent"] > 0


def test_mesh_and_cuda_without_a_card_raise():
    cfg = tfed_mod.FederationConfig(n_dc=2, nodes_per_dc=16, servers_per_dc=2)
    with pytest.raises(ValueError, match="dc"):
        tfed_mod.Federation(cfg, mesh=["cpu"] * 2, device="cpu", kernel="torch")
    with pytest.raises(ValueError, match="CUDA device"):
        tfed_mod.Federation(cfg, device="cpu", kernel="cuda")


def test_config_matches_reference():
    jcfg, tcfg = tp.fed_configs(n_dc=4, nodes_per_dc=250_000, servers_per_dc=3,
                         lan=dict(view_degree=32))
    for j, t in ((jcfg.lan, tcfg.lan), (jcfg.wan, tcfg.wan)):
        assert (t.n, t.degree, t.world_diameter_ms) == \
            (j.n, j.degree, j.world_diameter_ms)
        assert dataclasses.asdict(t.gossip) == dataclasses.asdict(j.gossip)
    assert (tcfg.n_wan, tcfg.wan.degree) == (12, 11)
    icfg = dataclasses.replace(tcfg, n_dc=2, n_dc_total=4, dc_offset=2)
    assert (icfg.dc_total, icfg.wan.n) == (4, 12)


def test_swim_step_is_step_counted_without_counters():
    cfg = TSimConfig(n=64, view_degree=8)
    gen = torch.Generator().manual_seed(5)
    world = ttopo.make_world(cfg, gen)
    topo = ttopo.make_topology(cfg, gen)
    st = tstate.init(cfg, gen)
    st = st._replace(alive_truth=torch.arange(64) >= 3)
    d = tswim.draw_tick(cfg, gen, "cpu")
    want = tswim.step_counted(cfg, topo, world, st, d)[0]
    got = tswim.step(cfg, topo, world, st, d)
    for a, b in zip(tlayout.leaves(got), tlayout.leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,view_degree", [(48, 0), (64, 8)])
def test_nbrs_table_matches_reference(n, view_degree):
    jcfg = JSimConfig(n=n, view_degree=view_degree)
    topo = jtopo.make_topology(jcfg, jax.random.PRNGKey(2))
    want = np.asarray(jtopo.nbrs_table(topo))
    got = ttopo.nbrs_table(convert.topology_from(tp.np_tree(topo)))
    np.testing.assert_array_equal(got.numpy(), want)

