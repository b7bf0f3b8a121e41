"""PyTorch port: the planes that ride a sharded Simulation (the raft tier,
the serving plane's two-stage top-k, scenario sweeps) and the mesh moves
(``Simulation.set_mesh``, ``run_resilient(mesh=, elastic=)``), against
the port's one-device path and, three times, against the JAX reference's
sharded programs.

Shards are repeated ``"cpu"`` devices (threads, ``parallel/shard_step``),
at n = 64-128, K = 16, packed, under both groupings (``device``: the
default, one device group; ``shard``: ``parallel.mesh.shard_groups``, a
group per shard, the several-card schedule):

- raft, R = 8 (group-sharded) and R = 3 (replicated), 2 and 4 shards,
  ``Simulation`` and ``SerfSimulation``: a leader kill (``RaftKill``)
  and proposals mid-run; every RaftState leaf, the raft counters, the
  summary and the gossip state and counters equal one device's, and the
  group-sharded blocks are adjacent per device group;
- the two-stage top-k (``ops/serving.execute_sharded``) against
  ``execute`` on the whole snapshot, bit for bit, with k wider than a
  block and with every coordinate tied; through a write-attached plane on
  a sharded simulation, every read, the apply index and a KV read;
- sweeps on 2 shards against the one-device sweep (rows and lane states)
  and against solo ``run_scenario`` replays on the mesh; a raft-armed
  sweep on a mesh raises "single-device", the simulation unmoved;
  ``bench_pareto(mesh=)`` against the one-device table;
- ``set_mesh`` round trips (None -> 4 -> 2 shards -> None) with raft and
  a plane armed, bit-equal to a run that never moved;
- an elastic resume from a checkpoint written on 4 shards, onto 2 shards
  and onto one device: ``reshards`` and ``sim.runtime.reshards`` are 1,
  the final state is bit-equal to an uninterrupted one-device run, and
  the checkpoint's meta says ``mesh_devices`` 4; ``restore_placed``.

Against the reference (on ``jax.devices()[:2]``; its sharded programs
are the cost): its ``set_mesh`` + ``set_raft`` trajectory fed the
reference's draw tables, its ``_execute_sharded`` on one snapshot, and
its mesh sweep from one formed state: discrete leaves and counters bit
for bit, floats within ``torch_parity``'s tolerances.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.chaos import sweep as jsweep
from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import raft as jraft_mod
from consul_tpu.ops import raft_ops as jraft
from consul_tpu.ops import serving as jserving
from consul_tpu.parallel import mesh as jmesh
from consul_tpu.parallel import shard_step as jshard
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch import runtime as rt
from consul_tpu_torch.chaos import sweep as tsweep
from consul_tpu_torch.config import RaftConfig, SimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models.cluster import SerfSimulation, Simulation
from consul_tpu_torch.ops import raft_ops as traft
from consul_tpu_torch.ops import serving as tserving
from consul_tpu_torch.parallel import mesh as tmesh
from consul_tpu_torch.parallel import shard_step
from consul_tpu_torch.serving import ServingPlane
from consul_tpu_torch.utils import checkpoint as tck

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401
from test_torch_serving import (assert_results_equal, make_queries,
                                make_snapshot)
from test_torch_sweep import _to_ref

N, K = 64, 16
ELECTION = dict(election_ticks_min=6, election_ticks_max=12)


def _groups(mesh, grouping):
    mesh = tmesh.make_mesh(mesh)
    return tmesh.shard_groups(mesh) if grouping == "shard" else None


def _sim(cls=Simulation, mesh=None, grouping="device", n=N, seed=3):
    return cls(SimConfig(n=n, view_degree=K), seed=seed, kernel="torch",
               device="cpu", mesh=mesh,
               groups=None if mesh is None else _groups(mesh, grouping))


def _identical(a, b):
    pa, pb = tck.flatten(a), tck.flatten(b)
    return len(pa) == len(pb) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


def _assert_adjacent(blocks, leaf):
    xs = [leaf(b) for b in blocks]
    step = xs[0].numel() * xs[0].element_size()
    assert [x.data_ptr() for x in xs] == [xs[0].data_ptr() + d * step
                                          for d in range(len(xs))]


# -- the raft arm ------------------------------------------------------------

RAFT_CASES = [(8, 2, "device", Simulation), (8, 4, "shard", Simulation),
              (3, 2, "shard", SerfSimulation), (3, 4, "device", Simulation)]


def _raft_run(cls, mesh, grouping, groups):
    sim = _sim(cls, mesh, grouping)
    plane = sim.set_raft(groups, peers=3, window=16, **ELECTION)
    sim.set_chaos([tchaos.RaftKill(12, 20, group=1, peer=-1)])
    sim.run(12, chunk=6, with_metrics=False)
    plane.propose([(0, 1, 5)], group=0)
    plane.propose([(0, 2, 6)], group=groups - 1)
    sim.run(18, chunk=6, with_metrics=False)
    return sim, plane


@pytest.mark.parametrize("groups, r, grouping, cls", RAFT_CASES,
                         ids=[f"R{g}-x{r}-{gr}-{c.__name__}"
                              for g, r, gr, c in RAFT_CASES])
def test_raft_matches_one_device(groups, r, grouping, cls):
    one, p1 = _raft_run(cls, None, "device", groups)
    sh, pr = _raft_run(cls, ["cpu"] * r, grouping, groups)
    assert pr.arm.sharded == (groups % r == 0)
    assert _identical(p1.state, pr.whole_state())
    assert p1.counters_snapshot() == pr.counters_snapshot()
    assert p1.summary() == pr.summary()
    assert p1.summary()["terms"][1] >= 2  # the kill deposed group 1's leader
    assert _identical(one.state, sh._whole()) and one.counters == sh.counters
    if pr.arm.sharded and grouping == "device":
        _assert_adjacent(pr.state, lambda b: b.term)
    name = traft.METRIC_NAMES["elections_started"]
    assert sh.sink.counter_sum(name) == one.sink.counter_sum(name) > 0


def test_raft_on_a_mesh_matches_the_reference():
    n, chunk, groups = 48, 8, 4
    jcfg, tcfg = tp.configs(n=n, view_degree=12)
    kw = dict(groups=groups, peers=3, window=16, **ELECTION)
    jr, tr = JRaftConfig(**kw), RaftConfig(**kw)
    jsim = jcluster.Simulation(jcfg, seed=7, layout="packed",
                               mesh=jmesh.make_mesh(jax.devices()[:2]))
    base = jsim.base_key
    draws = tp.make_draws_fn(jcfg, chaos=True)
    tsim = Simulation(
        tcfg, seed=7, kernel="torch", device="cpu", mesh=["cpu"] * 2,
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.packed_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_tick_draws(draws(jax.random.fold_in(base, t))))
    jplane = jsim.set_raft(jr)
    init_key = jraft_mod.init_key_of(jsim)
    tplane = tsim.set_raft(
        tr, draws=lambda t: convert.raft_draws_from(jraft.draw_table(jr, base, t)),
        timers=convert.raft_draws_from(jraft.timeout_draws(jr, init_key, 0,
                                                           jr.groups)))
    assert tplane.arm.sharded
    jsim.set_chaos([jchaos.RaftKill(start=10, stop=20, group=3, peer=-1)])
    tsim.set_chaos([tchaos.RaftKill(10, 20, group=3, peer=-1)])
    for i in range(3):
        if i == 1:
            for plane in (jplane, tplane):
                plane.propose([(0, 1, 5)], group=0)
                plane.propose([(0, 2, 6)], group=3)
        jsim.run(chunk, chunk=chunk, with_metrics=False)
        tsim.run(chunk, chunk=chunk, with_metrics=False)
        want = jax.device_get(jplane.state)
        got = tplane.whole_state()
        for f in traft.RaftState._fields:
            np.testing.assert_array_equal(
                getattr(got, f).numpy().astype(np.int64),
                np.asarray(getattr(want, f)).astype(np.int64),
                err_msg=f"chunk {i}: RaftState.{f}")
        assert tsim.counters == {f: jsim.counters[f] for f in tsim.counters}
    tp.assert_packed_close(tp.np_tree(jsim.state),
                           convert.gathered(tsim.state, n), "gossip plane")
    assert tplane.counters_snapshot() == jplane.counters_snapshot()
    assert tplane.summary() == jplane.summary()


# -- the two-stage top-k -----------------------------------------------------

# k = 24 over blocks of 16 rows, 40 over 32 and 64 over 16 run past a block.
TOPK_CASES = [(8, 4, "device", False), (24, 4, "shard", False),
              (40, 2, "device", True), (64, 4, "shard", True)]


@pytest.mark.parametrize("k, r, grouping, tie", TOPK_CASES,
                         ids=[f"k{k}-x{r}-{g}" + ("-tie" if t else "")
                              for k, r, g, t in TOPK_CASES])
def test_two_stage_topk_equals_execute(k, r, grouping, tie):
    rng = np.random.default_rng(k + r)
    snap = convert.snapshot_from(make_snapshot(rng, tie=tie))
    mode, src, arg = (torch.from_numpy(x) for x in make_queries(rng, 40))
    want = tserving.execute(k, snap, mode, src, arg)
    mesh = tmesh.make_mesh(["cpu"] * r)
    placed = tserving.place_snapshot(mesh, snap, _groups(["cpu"] * r, grouping))
    got = tserving.sharded_kernel_for(k, mesh)(placed, mode, src, arg)
    for a, b in zip(want[:3], got[:3]):
        assert torch.equal(a, b)
    assert int(want[3]) == int(got[3])


def test_two_stage_topk_matches_the_reference():
    k = 24
    rng = np.random.default_rng(11)
    snap_np = make_snapshot(rng)
    mode, src, arg = make_queries(rng, 40)
    # The reference's sharded executor gives a negative source to no shard
    # (all +inf, id order) where its one-device executor counts it from
    # the end; the port's follows the one-device rule (the tests above),
    # so the sources here name their rows directly.
    src = np.where(src < 0, src + N, src).astype(np.int32)
    jm = jmesh.make_mesh(jax.devices()[:2])
    ref = jax.device_get(jserving.sharded_kernel_for(k, jm)(
        jshard.place(jm, snap_np, N), mode, src, arg))
    mesh = tmesh.make_mesh(["cpu"] * 2)
    got = tserving.execute_sharded(
        k, mesh, tserving.place_snapshot(mesh, convert.snapshot_from(snap_np)),
        *(torch.from_numpy(x) for x in (mode, src, arg)))
    assert_results_equal(ref, got)


@pytest.mark.parametrize("r, grouping", [(2, "shard"), (4, "device")])
def test_plane_on_a_sharded_simulation(r, grouping):
    def reads(mesh):
        sim = _sim(mesh=mesh, grouping=grouping, n=128)
        plane = ServingPlane(k=40, num_services=3, device="cpu")
        sim.attach_serving(plane, writes=True, kv_slots=16)
        sim.run(8, chunk=8, with_metrics=False)
        sim.kill(torch.arange(128) < 10)
        plane.kv_put("a", 7)
        plane.register(5, 2)
        sim.run(4, chunk=4, with_metrics=False)
        snap = plane.snapshot()
        out = [plane.nearest(i, service=s) for i in (0, 11, 127, -1)
               for s in (-1, 1)]
        return snap, plane, out + [
            plane.health_nodes(1), plane.catalog_nodes(2),
            plane.node_distance(3, 70), plane.kv_get("a"), plane.apply_index,
            plane.node_entry(5)]
    s1, _, one = reads(None)
    sr, plane, got = reads(["cpu"] * r)
    assert isinstance(sr, tserving.ShardedSnapshot) and len(sr.parts) == (
        r if grouping == "shard" else 1)
    assert plane.kernel().func is tserving.execute_sharded
    assert got == one
    assert torch.equal(sr.live, s1.live)


# -- sweeps ------------------------------------------------------------------

def _formed(cls, mesh):
    sim = _sim(cls, mesh, seed=2)
    sim.run(12, chunk=12, with_metrics=False)
    return sim


@pytest.mark.parametrize("cls", [Simulation, SerfSimulation],
                         ids=["swim", "serf"])
def test_mesh_sweep_matches_one_device_and_solo_replays(cls):
    scens = tsweep.scenario_grid(N, 3)
    out = []
    for mesh in (None, ["cpu"] * 2):
        sim = _formed(cls, mesh)
        t0, gen = sim._t, sim.gen.get_state()
        rows = sim.sweep(scens, settle=6)
        sch, ticks = tsweep.compile_scenarios(sim, scens, settle=6)
        states, cnt, _ = sim._run_lanes(sch, ticks)
        assert sim._t == t0 and torch.equal(sim.gen.get_state(), gen)
        out.append((sim, rows, states))
    (one, rows1, st1), (sh, rows2, st2) = out
    assert rows1 == rows2
    for a, b in zip(st1, st2):
        assert _identical(a, shard_step.gather(b, N, sh.device))
    if cls is Simulation:
        # Lane s equals a solo replay of scenario s on the mesh.
        twin = _formed(cls, ["cpu"] * 2)
        solo = twin.run_scenario(scens[2], settle=6)
        assert solo.counters == rows2[2]["counters"]


def test_mesh_sweep_matches_the_reference():
    n, vd, form, ticks = 64, 8, 16, 20
    jcfg, tcfg = tp.configs(n=n, view_degree=vd)
    jsim = jcluster.Simulation(jcfg, seed=0)
    draws = tp.make_draws_fn(jcfg, chaos=True)
    base = jsim.base_key
    tsim = Simulation(
        tcfg, seed=0, kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.sim_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_tick_draws(draws(jax.random.fold_in(base, t))))
    tsim.run(form, chunk=form, with_metrics=False)
    jsim.state = _to_ref(jsim.state, tsim.swim_state)
    jsim.set_mesh(jmesh.make_mesh(jax.devices()[:2]))
    tsim.set_mesh(["cpu"] * 2)
    scens_t = tsweep.scenario_grid(n, 2)
    scens_j = jsweep.scenario_grid(n, 2)
    got = tsweep.run_sweep(tsim, scens_t, ticks=ticks, chunk=ticks)
    want = jsweep.run_sweep(jsim, scens_j, ticks=ticks, chunk=ticks)
    for g, w in zip(got, want):
        assert g["counters"] == {f: w["counters"][f] for f in g["counters"]}
        assert g["slo"] == w["slo"] and g["ticks"] == w["ticks"]
    assert any(r["slo"]["fault_ticks"] > 0 for r in got)


def test_raft_armed_mesh_sweep_raises_single_device():
    sim = _formed(Simulation, ["cpu"] * 2)
    sim.set_raft(2, peers=3, **ELECTION)
    t0 = sim._t
    with pytest.raises(ValueError, match="single-device"):
        tsweep.run_sweep(sim, [[tchaos.RaftStorm(start=2, stop=10)]],
                         ticks=16)
    assert sim._t == t0


def test_bench_pareto_on_a_mesh_matches_one_device():
    kw = dict(n=N, degree=K, scenarios=2, families=("hier", "circulant"),
              form_ticks=8, settle=4, device="cpu", kernel="torch")
    got = tsweep.bench_pareto(mesh=["cpu"] * 2, **kw)
    assert got == tsweep.bench_pareto(**kw)
    assert any(s["fault_ticks"] > 0 for r in got["pareto"]
               for s in r["scenarios"])


# -- set_mesh ----------------------------------------------------------------

def test_set_mesh_round_trips():
    def armed(sim):
        sim.set_raft(4, peers=3, **ELECTION)
        plane = ServingPlane(k=8, num_services=2, device="cpu")
        sim.attach_serving(plane)
        return plane

    one = _sim()
    p1 = armed(one)
    moved = _sim()
    p2 = armed(moved)
    for mesh, width in ((None, None), (["cpu"] * 4, 4), (["cpu"] * 2, 2),
                        (None, None)):
        if mesh is not None or moved.mesh is not None:
            moved.set_mesh(mesh)
        assert (moved.mesh.size if moved.mesh else None) == width
        assert isinstance(p2.snapshot(), tserving.ShardedSnapshot) == (
            width is not None)
        if width is not None:
            _assert_adjacent(moved.state, lambda b: b.meta)
            assert moved.raft.arm.sharded
        for sim in (one, moved):
            sim.run(6, chunk=6, with_metrics=False)
        assert _identical(one.state, moved._whole())
        assert _identical(one.raft.state, moved.raft.whole_state())
        assert p1.nearest(5) == p2.nearest(5)
    assert one.counters == moved.counters
    assert one.raft.counters_snapshot() == moved.raft.counters_snapshot()


def test_set_mesh_keeps_the_refusals():
    sim = _sim()
    sim.set_lens(4)
    with pytest.raises(ValueError, match="lens is single-device"):
        sim.set_mesh(["cpu"] * 2)
    assert sim.mesh is None
    with pytest.raises(ValueError, match="one device"):
        tcluster.ReferenceSerfSimulation(SimConfig(n=N, view_degree=K),
                                         kernel="torch", device="cpu"
                                         ).set_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        _sim().set_mesh(["cuda:0"] * 2)


# -- elastic resume ----------------------------------------------------------

def _preempt_after_first_chunk(monkeypatch):
    real = tcluster.Simulation.run
    fired = {"done": False}

    def run_and_sigterm(self, *a, **kw):
        out = real(self, *a, **kw)
        if not fired["done"]:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    monkeypatch.setattr(tcluster.Simulation, "run", run_and_sigterm)


@pytest.mark.parametrize("target", ["2-shards", "one-device"])
def test_elastic_resume_from_4_shards(tmp_path, monkeypatch, target):
    ref = _sim(seed=9)
    rt.run_resilient(ref, 36, chunk=12)

    def policy():
        return rt.CheckpointPolicy(directory=str(tmp_path), tag="el",
                                   min_interval_s=9999.0)
    _preempt_after_first_chunk(monkeypatch)
    with pytest.raises(rt.Preempted):
        rt.run_resilient(_sim(seed=9), 36, chunk=12, policy=policy(),
                         mesh=["cpu"] * 4)
    monkeypatch.undo()
    meta = tck.read_meta(policy().path)
    assert meta["mesh_devices"] == 4 and meta["ticks_done"] == 12
    placed = rt.restore_placed(policy().path, ref.state, mesh=["cpu"] * 4)
    assert len(placed) == 4 and int(placed[3].t) == 12
    sim = _sim(seed=9)
    kw = (dict(mesh=["cpu"] * 2) if target == "2-shards"
          else dict(elastic=True, devices=["cpu"]))
    rep = rt.run_resilient(sim, 36, chunk=12, policy=policy(), **kw)
    assert rep.reshards == 1 and rep.resumed_from_tick == 12
    assert sim.sink.counter_sum("sim.runtime.reshards") == 1
    assert (sim.mesh.size if sim.mesh else 1) == (2 if target == "2-shards"
                                                  else 1)
    assert _identical(ref.state, sim._whole())
