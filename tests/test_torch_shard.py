"""PyTorch port: the node-sharded Simulation against one device and
against the JAX reference's sharded runner.

Shards are repeated ``"cpu"`` devices; every tick runs the plain step in
one thread per shard (``parallel/shard_step.py``). At n = 256, K = 16,
packed, 12 ticks in chunks of 4, at 2 and 4 shards, ``Simulation`` /
``SerfSimulation(mesh=...)`` against the same classes on one device, from
one seed:

- SWIM with packet loss; serf with an event and a query under loss (the
  query's acks cross shards); SWIM under a composed schedule with the
  sentinel on; the dense view. Every packed and serf leaf bit for bit
  (floats included: every op of the step is row-local or an exact
  gather), all 26 counters and the chunk's metrics row equal.
- a 5 % kill converges on the same tick, with equal counters and state
  (2 shards, suspicion cut so it converges in ~180 ticks).

Against the reference, twice only (its sharded programs are the cost):
``consul_tpu.models.cluster.Simulation(mesh=make_mesh(jax.devices()[:2]),
layout="packed")`` and the reference's ``make_sharded_counted_serf_step``
(an event and a query under loss) against the port on two shards, fed
the reference's key ladder: discrete leaves and counters bit for bit,
floats within ``torch_parity``'s packed / Vivaldi tolerances.

The placement (no reference needed): a sharded ``Simulation``'s blocks
are adjacent row views of one storage per device group after placement,
a kill (``_edit``), ``set_swim_state``, ``load_state`` and a serf verb,
and its schedule's node masks too (checked by ``data_ptr``). The sharded
CUDA tick's operands, built on the CPU without a launch: each group's
row origin of a mirrored leaf is its mirror (one group: the leaf itself;
one group per shard: the group's full-height buffer), its exchange fills
every other group's rows and its tally sums the groups' in order; a call
on CPU blocks raises, and so do blocks that are not adjacent.

What must raise: an ``n`` that does not divide over the shards,
``kernel="cuda"`` on a CPU mesh, the dense layout on a mesh, a
``device=`` that disagrees with the mesh, and what the reference refuses
on a mesh too: the lens, ``ReferenceSerfSimulation`` and a raft-armed
sweep. The raft tier, a serving plane, a sweep and ``run_resilient`` run
on a sharded simulation (tests/test_torch_mesh_planes.py holds them to
one device).
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models import serf as jserf
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.parallel import mesh as jmesh
from consul_tpu.parallel import shard_step as jshard
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch import runtime
from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models.cluster import SerfSimulation, Simulation
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.ops import cuda_gossip as cg
from consul_tpu_torch.ops import serving as tserving
from consul_tpu_torch.ops import topology
from consul_tpu_torch.parallel import mesh as tmesh
from consul_tpu_torch.parallel import shard_step as tshard
from consul_tpu_torch.serving import ServingPlane

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N, K, TICKS, CHUNK = 256, 16, 12, 4
SHARDS = (2, 4)


def _bits_equal(a, b, where=""):
    """Two state trees, leaf for leaf, bit for bit."""
    if isinstance(a, torch.Tensor):
        np.testing.assert_array_equal(convert.bits(a), convert.bits(b),
                                      err_msg=where)
        return
    for f, x, y in zip(a._fields, a, b):
        _bits_equal(x, y, f"{where}.{f}")


def _twins(cls, cfg, r, setup=lambda sim: None):
    """The same run on one device and on ``r`` shards: (sims, traces)."""
    sims, traces = [], []
    for mesh in (None, ["cpu"] * r):
        sim = cls(cfg, seed=5, kernel="torch", device="cpu", mesh=mesh)
        setup(sim)
        traces.append(sim.run(TICKS, chunk=CHUNK))
        sims.append(sim)
    one, sharded = sims
    _bits_equal(one.state, sharded._whole(), f"{cls.__name__} x{r}")
    assert one.counters == sharded.counters
    assert sharded.mesh.size == r and len(sharded.state) == r
    # The sharded runner samples the chunk's last tick only.
    for a, b in zip(traces[0], traces[1]):
        assert b.shape == (TICKS // CHUNK,)
        np.testing.assert_array_equal(a.numpy()[CHUNK - 1::CHUNK], b.numpy())
    return sharded


def _mask(rows):
    m = torch.zeros(N, dtype=torch.bool)
    m[rows] = True
    return m


@pytest.mark.parametrize("r", SHARDS + (8,))
def test_swim_matches_one_device(r):
    sim = _twins(Simulation, SimConfig(n=N, view_degree=K, packet_loss=0.05), r)
    assert sim.counters["gossip_rx"] > 0 and sim.counters["nacks_received"] > 0


@pytest.mark.parametrize("r", SHARDS)
def test_serf_event_and_query_under_loss(r):
    def setup(sim):
        sim.run(4, chunk=4)
        sim.user_event(_mask([3]), 7)
        sim.query(_mask([N - 20]), 9)   # acks arrive from every shard
        sim.leave(_mask(slice(100, 104)))

    cfg = SimConfig(n=N, view_degree=K, packet_loss=0.05)
    sim = _twins(SerfSimulation, cfg, r, setup)
    st = sim.serf_state
    assert int(st.q_acks[N - 20].sum()) > 8
    assert sim.counters["serf_intents_queued"] > 0


@pytest.mark.parametrize("r", SHARDS)
def test_schedule_with_the_sentinel(r):
    def setup(sim):
        sim.set_sentinel(True)
        sim.set_chaos([
            tchaos.Partition(2, 10, slice(0, N // 3)),
            tchaos.LinkLoss(0, 12, slice(N // 3, N // 2), slice(N // 2, N),
                            fwd=0.5, rev=0.2),
            tchaos.ChurnWave(1, 11, slice(N - 40, N - 20), period=4,
                             down_ticks=2),
            tchaos.Degrade(0, 12, slice(40, 60), tx_loss=0.3, rx_loss=0.1)])

    sim = _twins(Simulation, SimConfig(n=N, view_degree=K, packet_loss=0.01),
                 r, setup)
    c = sim.counters
    assert c["chaos_fault_ticks"] > 0 and c["chaos_msgs_dropped"] > 0
    assert all(c[f] == 0 for f in tcounters.SENTINEL_FIELDS)


@pytest.mark.parametrize("r", SHARDS)
def test_dense_view(r):
    _twins(Simulation, SimConfig(n=N, view_degree=0, packet_loss=0.02), r)


def test_kill_converges_on_the_same_tick():
    cfg = SimConfig(n=N, view_degree=K, gossip=GossipConfig(
        suspicion_mult=1, suspicion_max_timeout_mult=2))
    runs = []
    for mesh in (None, ["cpu"] * 2):
        sim = Simulation(cfg, seed=5, kernel="torch", device="cpu",
                         mesh=mesh)
        sim.run(16, chunk=16, with_metrics=False)
        sim.kill(_mask(slice(0, N // 20)))
        runs.append((sim, sim.run_until_converged(1024, chunk=16)))
    (one, (ok1, used1, _)), (sh, (ok2, used2, _)) = runs
    assert ok1 and ok2 and used1 == used2
    assert one.counters == sh.counters and sh.counters["deaths_declared"] > 0
    _bits_equal(one.state, sh._whole(), "after convergence")


# -- against the reference's sharded runners -------------------------------

def test_swim_matches_the_reference_sharded_simulation():
    jcfg, tcfg = tp.configs(n=N, view_degree=K, packet_loss=0.02)
    jsim = JSimulation(jcfg, seed=5, layout="packed",
                       mesh=jmesh.make_mesh(jax.devices()[:2]))
    draws, base = tp.make_draws_fn(jcfg), jsim.base_key
    tsim = Simulation(
        tcfg, seed=5, kernel="torch", device="cpu", mesh=["cpu"] * 2,
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.packed_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_tick_draws(draws(jax.random.fold_in(base, t))))
    jsim.run(TICKS, chunk=CHUNK, with_metrics=False)
    tsim.run(TICKS, chunk=CHUNK, with_metrics=False)
    tp.assert_packed_close(tp.np_tree(jsim.state),
                           convert.gathered(tsim.state, N), "sharded SWIM")
    assert tsim.counters == {f: jsim.counters[f] for f in tsim.counters}


def test_serf_matches_the_reference_sharded_serf_step():
    jcfg, tcfg, jw, jtopo, jst = tp.setup(N, K, seed=3, packet_loss=0.05)
    jst = jserf.init(jcfg, jax.random.PRNGKey(11))._replace(swim=jst)
    m = np.zeros(N, bool)
    m[5] = True
    jst = jserf.user_event(jcfg, jst, m, 3)
    m = np.zeros(N, bool)
    m[N - 7] = True
    jst = jserf.query(jcfg, jst, m, 4)
    jmesh2 = jmesh.make_mesh(jax.devices()[:2])
    jstep = jshard.make_sharded_counted_serf_step(jcfg, jtopo, jmesh2)
    tmesh2 = tshard.mesh_mod.make_mesh(["cpu"] * 2)
    tstep = tshard.make_sharded_counted_serf_step(
        tcfg, convert.topology_from(tp.np_tree(jtopo)), tmesh2)
    tw = convert.on_mesh(convert.world_from(tp.np_tree(jw)), tmesh2, N)
    ts = convert.on_mesh(convert.serf_state_from(tp.np_tree(jst)), tmesh2, N)
    jwp, jsp = jshard.place(jmesh2, jw, N), jshard.place(jmesh2, jst, N)
    draws = tp.make_serf_draws_fn(jcfg)
    base = jax.random.PRNGKey(17)
    acks = 0
    for t in range(8):
        key = jax.random.fold_in(base, t)
        jsp, jc = jstep(jwp, jsp, key)
        ts, tc = tstep(tw, ts, tp.to_serf_draws(draws(key)))
        ref, got = tp.np_tree(jsp), convert.gathered(ts, N)
        tp.assert_state_matches(ref.swim, got.swim, f"tick {t}")
        tp.assert_serf_equal(ref, got, f"tick {t}")
        assert [int(x) for x in tc] == [int(np.asarray(x)) for x in jc], t
        acks = int(got.q_acks[N - 7].sum())
    assert acks > 0


# -- the sharded step factories ----------------------------------------------

@pytest.mark.parametrize("name", [
    "make_sharded_step", "make_sharded_serf_step", "make_sharded_counted_step",
    "make_sharded_counted_serf_step", "make_sharded_chaos_step"])
def test_sharded_step_factories_match_one_device(name):
    # Each factory on two shards of a dense state against the one-device
    # step: every leaf bit for bit, and the counters where it counts them.
    serf_plane, chaos = "serf" in name, "chaos" in name
    counted = chaos or "counted" in name
    n = 64
    cfg = SimConfig(n=n, view_degree=16, packet_loss=0.05)
    gen = torch.Generator().manual_seed(3)
    world = topology.make_world(cfg, gen, "cpu")
    topo = topology.make_topology(cfg, gen, "cpu")
    st = (tserf.init(cfg, gen, "cpu") if serf_plane
          else tstate.init(cfg, gen, "cpu"))
    if serf_plane:
        st = tserf.user_event(cfg, st, torch.arange(n) == 5, 3)
    sched = (tchaos.compile_schedule(n, [
        tchaos.Partition(0, 8, slice(0, n // 4))], "cpu") if chaos else None)
    mesh = tshard.mesh_mod.make_mesh(["cpu"] * 2)
    factory = getattr(tshard, name)
    step = (factory(cfg, topo, mesh, counted=True, sentinel=True) if chaos
            else factory(cfg, topo, mesh))
    one = tserf.step_counted if serf_plane else tswim.step_counted
    wb, sb = convert.on_mesh(world, mesh, n), convert.on_mesh(st, mesh, n)
    scheds = [tchaos.place(sched, d, 2, "cpu") for d in range(2)] if chaos else None
    for t in range(3):
        d = (tserf.draw_serf_tick(cfg, gen, "cpu", chaos=chaos) if serf_plane
             else tswim.draw_tick(cfg, gen, "cpu", chaos=chaos))
        st, cnt = one(cfg, topo, world, st, d, sched=sched, sentinel=chaos)
        out = step(wb, scheds, sb, d) if chaos else step(wb, sb, d)
        sb, got = out if counted else (out, None)
        _bits_equal(st, convert.gathered(sb, n), f"{name} tick {t}")
        if counted:
            assert [int(x) for x in got] == [int(x) for x in cnt], (name, t)


# -- what must raise ---------------------------------------------------------

def test_what_must_raise(tmp_path):
    cfg = SimConfig(n=N, view_degree=K)
    with pytest.raises(ValueError, match="must divide over 3 shards"):
        Simulation(cfg, kernel="torch", device="cpu", mesh=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Simulation(cfg, kernel="cuda", device="cpu", mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="packed layout"):
        Simulation(cfg, kernel="torch", device="cpu", layout="dense",
                   mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        Simulation(cfg, kernel="torch", device="cuda", mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        Simulation(cfg, kernel="torch", device="cpu", mesh=["cuda:0"] * 2)
    sim = Simulation(cfg, kernel="torch", device="cpu", mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="lens is single-device"):
        sim.set_lens(4)
    with pytest.raises(ValueError, match="one device"):
        tcluster.ReferenceSerfSimulation(cfg, kernel="torch", device="cpu",
                                         mesh=["cpu"] * 2)
    # What the reference runs on a mesh runs here: a sweep, a serving plane,
    # the raft tier, run_resilient; then a raft-armed sweep raises.
    rows = sim.sweep([[tchaos.Partition(0, 4, slice(0, 8))]], settle=2)
    assert rows[0]["slo"]["fault_ticks"] > 0 and sim._t == 0
    plane = ServingPlane(k=4, num_services=2, device="cpu")
    sim.attach_serving(plane)
    assert isinstance(plane.snapshot(), tserving.ShardedSnapshot)
    sim.set_raft(2, peers=3, election_ticks_min=3, election_ticks_max=5)
    rep = runtime.run_resilient(sim, 8, chunk=4)
    assert rep.ticks_done == 8 and sim._t == 8 and plane.tick == 8
    assert sum(sim.raft.counters_snapshot().values()) > 0
    with pytest.raises(ValueError, match="single-device"):
        sim.sweep([[tchaos.Partition(0, 4, slice(0, 8))]])
    assert sim._t == 8


# -- the adjacent placement and the sharded CUDA tick's operands ------------

def _assert_adjacent(blocks, n, r, leaf=lambda b: b.meta):
    """Every shard's block of ``leaf`` right after the one before it, in
    one storage (``["cpu"] * r`` is one device group)."""
    xs = [leaf(b) for b in blocks]
    step = xs[0].numel() * xs[0].element_size()
    assert [x.data_ptr() for x in xs] == [xs[0].data_ptr() + d * step
                                          for d in range(r)]
    assert xs[0].untyped_storage().nbytes() == r * step
    tmesh.group_tree(blocks, tuple(range(r)), n // r, n)


def test_a_sharded_simulation_keeps_its_blocks_adjacent():
    cfg = SimConfig(n=N, view_degree=K)
    sim = SerfSimulation(cfg, seed=5, kernel="torch", device="cpu",
                         mesh=["cpu"] * 4)
    for leaf in (lambda b: b.swim.meta, lambda b: b.swim.flags,
                 lambda b: b.q_acks, lambda b: b.swim.viv.vec):
        _assert_adjacent(sim.state, N, 4, leaf)
    sim.kill(_mask(slice(0, 8)))
    _assert_adjacent(sim.state, N, 4, lambda b: b.swim.meta)
    sim.user_event(_mask([3]), 7)
    _assert_adjacent(sim.state, N, 4, lambda b: b.ev_key)
    sim.set_swim_state(sim.swim_state)
    _assert_adjacent(sim.state, N, 4, lambda b: b.swim.susp_seen)
    before = sim._whole()
    sim.load_state(before)
    _assert_adjacent(sim.state, N, 4, lambda b: b.swim.lat_buf)
    _bits_equal(before, sim._whole(), "restored")
    sim.set_chaos([tchaos.Partition(0, 4, slice(0, N // 3))])
    _assert_adjacent(sim._sched_blocks(), N, 4, lambda s: s.part_side)


def _k7_operands(r, grouping, serf_plane, chaos_on):
    """A sharded tick's operands for one tick on ``["cpu"] * r``, built
    without a launch: (kernel, blocks, draws, schedule blocks, groups'
    operands, their TickArgs)."""
    n = 64
    cfg = SimConfig(n=n, view_degree=16, packet_loss=0.05)
    gen = torch.Generator().manual_seed(3)
    world = topology.make_world(cfg, gen, "cpu")
    topo = topology.make_topology(cfg, gen, "cpu")
    st = tlayout.pack_state(tserf.init(cfg, gen, "cpu") if serf_plane
                            else tstate.init(cfg, gen, "cpu"))
    sched = (tchaos.compile_schedule(n, [
        tchaos.Partition(0, 8, slice(0, n // 4))], "cpu") if chaos_on else None)
    d = (tserf.draw_serf_tick(cfg, gen, "cpu", chaos=chaos_on) if serf_plane
         else tswim.draw_tick(cfg, gen, "cpu", chaos=chaos_on))
    mesh = tmesh.make_mesh(["cpu"] * r)
    k7 = cg.ShardedTickKernel(
        cfg, topo, mesh, serf_plane=serf_plane, sentinel=chaos_on,
        groups=(tmesh.device_groups(mesh) if grouping == "device"
                else tmesh.shard_groups(mesh)))
    k7.set_world(world)
    blocks = tshard.place(mesh, st, n, groups=k7.groups)
    sb = (tshard.place_schedule(mesh, sched, n, groups=k7.groups)
          if chaos_on else None)
    parts, args = k7._operands(blocks, d, sb)
    return k7, blocks, d, sb, parts, args


@pytest.mark.parametrize("r", SHARDS)
@pytest.mark.parametrize("grouping", ["device", "shard"])
@pytest.mark.parametrize("serf_plane,chaos_on", [(False, False), (True, True)],
                         ids=["bare", "serf_chaos"])
def test_sharded_tick_operands(r, grouping, serf_plane, chaos_on):
    k7, blocks, d, sb, parts, args = _k7_operands(r, grouping, serf_plane,
                                                  chaos_on)
    multi = grouping == "shard"
    assert len(parts) == (r if multi else 1)
    # Each group's row origin of a mirrored leaf is its mirror: the leaf
    # itself in one group, the group's full-height buffer under several.
    for part, a in zip(parts, args):
        assert a.i[cg._INTS.index("slo_defer")] == int(multi and chaos_on)
        assert (a.i[cg._INTS.index("row0")], a.i[cg._INTS.index("rows")]) == (
            part.row0, part.rows)
        for col, src in cg._SOURCE.items():
            name = cg._PTRS[col]
            if multi and name in ("t_acks", "t_resps"):
                t = part.tensors[col]
                assert (t is None) != serf_plane
                assert t is None or (t.shape[0] == 64 and not t.any())
                continue
            assert a.p[col] == a.p[src], name
    # The outputs, handed back as blocks, are what the next tick takes.
    outs = [blk for g, part in zip(k7.groups, parts)
            for blk in tmesh.shard_views(part.out, g, k7.rows)]
    k7._operands(outs, d, sb)
    # The exchange before each launch fills every other group's rows of
    # each leaf it reads, and copies nothing with one group.
    stamp = {}
    for gi, part in enumerate(parts):
        for col in cg._SOURCE:
            src, x = cg._SOURCE[col], part.tensors[cg._SOURCE[col]]
            if cg._PTRS[col] in cg.EXCHANGES["probe_send"] + \
                    cg.EXCHANGES["pushpull"] and x is not None:
                x.copy_(torch.full_like(x, gi + 1))
                stamp[(gi, col)] = part.tensors[col]
    for key in ("probe_send", "pushpull"):
        k7._exchange(key, parts)
    assert k7.copies == (0 if not multi else 7 * r * (r - 1))
    for (gi, col), mirror in stamp.items():
        for gj, other in enumerate(parts):
            rows = mirror[other.row0:other.row0 + other.rows]
            assert bool((rows == gj + 1).all()), (cg._PTRS[col], gi, gj)
    if serf_plane and multi:
        # D's tally: the groups' scratch summed in order into each group's
        # rows of the output.
        q = parts[0].out.q_acks
        before = [p.out.q_acks.clone() for p in parts]
        g = torch.Generator().manual_seed(1)
        tallies = [torch.randint(0, 3, p.tensors[cg._PTRS.index("t_acks")].shape,
                                 generator=g, dtype=torch.int32) for p in parts]
        for p, t in zip(parts, tallies):
            p.tensors[cg._PTRS.index("t_acks")].copy_(t)
            p.tensors[cg._PTRS.index("t_resps")].zero_()
        k7._tally(parts)
        total = sum(tallies)
        for p, b0 in zip(parts, before):
            assert torch.equal(p.out.q_acks,
                               b0 + total[p.row0:p.row0 + p.rows])
        assert q.dtype == torch.int32


def test_sharded_tick_raises_on_cpu_blocks_and_loose_blocks():
    k7, blocks, d, _, _, _ = _k7_operands(4, "device", False, False)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k7(blocks, d)
    loose = [tmesh.block_of(tlayout.pack_state(tstate.init(
        k7.cfg, torch.Generator().manual_seed(3), "cpu")), 64, s, 4, "cpu")
        for s in range(4)]
    with pytest.raises(ValueError, match="parallel.mesh.split"):
        k7._operands(loose, d, None)
