"""PyTorch port vs the JAX reference: fault schedules and the invariant
sentinel (``consul_tpu_torch/chaos``, the chaos and sentinel branches of
``swim.step_counted``, ``Simulation.set_chaos``/``run_scenario``/
``set_sentinel``, and ``cuda_gossip.plain_tick(sched, sentinel=True)``).

Inputs come from the reference and cross through ``convert.py``
(``convert.schedule_from`` for schedules); random numbers are the
reference's own key ladder with the chaos-only push-pull draw
(``torch_parity.make_draws_fn(chaos=True)``).

- ``compile_schedule`` leaf-equal (and digest-equal) with the reference on
  a mixed schedule, each family alone, none, and after ``shift_schedule``;
  the same validation errors.
- ``node_terms``, ``down_at``, ``fault_started``, the survival products
  and ``pair_ok`` bit-equal at several ticks, with three overlapping
  Degrades and two overlapping LinkLosses on the same rows.
- 12 ticks of ``step_counted(sched, sentinel=True)`` against the
  reference's jitted step, sparse (n = 1024, K = 16) and dense (n = 128),
  at loss 0 and 0.01, with corruption injected (a NaN coordinate, an
  incarnation past MAX_INCARNATION, a NaN RTT sample): discrete plane and
  all 26 counters equal every tick, floats within ``torch_parity``'s tolerance (NaN only
  where both hold it), schedule drops and sentinel tallies nonzero.
- 4 ticks of ``plain_tick(sched, sentinel=True)`` against the reference's
  interpret-mode Pallas tick, with a NaN coordinate and NaN RTT samples.
- ``Simulation(device="cpu", kernel="torch")`` raises SentinelViolation
  with the reference's mask and deltas; ``run_scenario`` on the bench's
  partition-heal shape returns the reference's ``slo`` dict.
- The paths that are not ported (the raft lane, the sentinel's
  checkpoint) raise, on ``Simulation`` and ``SerfSimulation``; the serf
  kernel takes a schedule and the sentinel; the kernel wrapper rejects a
  schedule leaf of the wrong dtype or shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import layout as jlayout
from consul_tpu.models import swim as jswim
from consul_tpu.ops import pallas_gossip
from consul_tpu_torch import convert
from consul_tpu_torch.chaos import schedule as tchaos
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.ops import cuda_gossip, merge, topology as ttopo

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

FIELDS = tcounters.FIELDS


def _events(C, n):
    """Every family, overlapping: two Partitions, two LinkLosses (the
    first as in tests/test_chaos.py), a ChurnWave whose kill and revive
    edges fall inside 12 ticks, and three Degrades on the same rows."""
    return [
        C.Partition(1, 10, slice(0, n // 4)),
        C.Partition(3, 12, slice(n // 8, 3 * n // 8)),
        C.LinkLoss(0, 14, slice(0, n // 8), slice(n // 8, n // 4), fwd=0.8,
                   rev=0.2),
        C.LinkLoss(2, 14, slice(0, n // 4), slice(n // 8, n // 2), fwd=0.3,
                   rev=0.6),
        C.ChurnWave(1, 20, slice(n // 2, n // 2 + n // 20), period=4,
                    down_ticks=2),
        C.Degrade(0, 14, slice(n - n // 8, n), tx_loss=0.4),
        C.Degrade(0, 14, slice(n - n // 4, n), tx_loss=0.3, rx_loss=0.2),
        C.Degrade(2, 14, slice(n - n // 4, n), tx_loss=0.7, rx_loss=0.1),
    ]


def _family(C, n, kind):
    ev = _events(C, n)
    pick = {"mixed": ev, "none": [], "partition": ev[:2], "link": ev[2:4],
            "churn": ev[4:5], "degrade": ev[5:]}
    return pick[kind]


def _both(n, kind):
    return (jchaos.compile_schedule(n, _family(jchaos, n, kind)),
            tchaos.compile_schedule(n, _family(tchaos, n, kind)))


def _leaves_equal(js, ts, context):
    for f in tchaos.ChaosSchedule._fields:
        r, g = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert g.dtype == r.dtype, f"{context}: {f} {g.dtype} != {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{context}: {f}")


# ----------------------------------------------------------------------
# The schedule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mixed", "none", "partition", "link",
                                  "churn", "degrade"])
def test_compile_schedule_matches_reference(kind):
    n = 64
    js, ts = _both(n, kind)
    _leaves_equal(js, ts, kind)
    assert tchaos.is_empty(ts) == jchaos.is_empty(js) == (kind == "none")
    assert tchaos.digest_of(ts) == jchaos.digest_of(js)
    _leaves_equal(jchaos.shift_schedule(js, 37), tchaos.shift_schedule(ts, 37),
                  kind + " shifted")
    _leaves_equal(js, convert.schedule_from(tp.np_tree(js)), kind + " convert")


@pytest.mark.parametrize("events", [
    lambda C: [C.Partition(5, 5, [0])],
    lambda C: [C.LinkLoss(0, 5, [0], [1], fwd=1.5)],
    lambda C: [C.Degrade(0, 5, [0], rx_loss=-0.1)],
    lambda C: [C.ChurnWave(0, 5, [0], period=-1)],
    lambda C: [C.Partition(0, 5, [0])] * (C.MAX_PARTITIONS + 1),
    lambda C: [C.RaftPartition(0, 5, cut=0)],
    lambda C: [C.Partition(0, 5, np.ones(3, bool))],
    lambda C: ["not an entry"],
], ids=["empty-window", "fwd-rate", "rx-rate", "period", "too-many",
        "raft-cut", "mask-shape", "type"])
def test_validation_errors_match_reference(events):
    with pytest.raises((ValueError, TypeError)) as want:
        jchaos.compile_schedule(32, events(jchaos))
    with pytest.raises(want.type) as got:
        tchaos.compile_schedule(32, events(tchaos))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("t", [0, 2, 3, 9, 13, 19, 25])
def test_terms_and_pair_ok_bit_equal(t):
    n = 128
    js, ts = _both(n, "mixed")
    jt, tt = jchaos.node_terms(js, t), tchaos.node_terms(ts, t)
    for f, a, b in zip(tchaos.NodeTerms._fields, jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    np.testing.assert_array_equal(tchaos.down_at(ts, t).numpy(),
                                  np.asarray(jchaos.down_at(js, t)))
    assert bool(tchaos.fault_started(ts, t)) == bool(jchaos.fault_started(js, t))
    u = np.random.default_rng(t).random(n, dtype=np.float32)
    for shift in (1, n // 8, n // 4 + 3):
        jr, tr = jchaos.roll_terms(jt, shift), tchaos.roll_terms(tt, shift)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(
            tchaos._survival(ts, tt, tr).numpy(),
            np.asarray(jchaos._survival(js, jt, jr)))
        for rt in (False, True):
            for loss in (0.0, 0.01):
                np.testing.assert_array_equal(
                    tchaos.pair_ok(ts, tt, tr, torch.from_numpy(u), loss,
                                   rt).numpy(),
                    np.asarray(jchaos.pair_ok(js, jt, jr, u, loss, rt)))


# ----------------------------------------------------------------------
# The tick
# ----------------------------------------------------------------------

def _nan_rtt(st, row):
    """A NaN in the first RTT slot of ``row``'s first two columns, marked
    written (tests/test_runtime.py:683-695 puts an inf there)."""
    buf = np.asarray(st.lat_buf).copy()
    cnt = np.asarray(st.lat_cnt).copy()
    buf[row, :2, 0] = np.nan
    cnt[row, :2] = np.maximum(cnt[row, :2], 2)
    return st._replace(lat_buf=jnp.asarray(buf),
                       lat_cnt=jnp.asarray(cnt, dtype=st.lat_cnt.dtype))


def _corrupt(st):
    """A NaN coordinate on row 3, an incarnation past the packed-key
    headroom on row 5 (tests/test_runtime.py:641-680) and a NaN RTT
    sample on a live row in the middle."""
    vec = np.asarray(st.viv.vec).copy()
    vec[3, :] = np.nan
    oi = np.asarray(st.own_inc).copy()
    oi[5] = merge.MAX_INCARNATION + 5
    st = _nan_rtt(st, vec.shape[0] // 2)
    return st._replace(viv=st.viv._replace(vec=jnp.asarray(vec)),
                       own_inc=jnp.asarray(oi, dtype=jnp.uint32))


@pytest.mark.parametrize("n,view_degree,loss", [
    (1024, 16, 0.0), (1024, 16, 0.01), (128, 0, 0.0), (128, 0, 0.01)],
    ids=["sparse-1024-loss0", "sparse-1024-loss1pct", "dense-128-loss0",
         "dense-128-loss1pct"])
def test_step_counted_matches_reference(n, view_degree, loss):
    jcfg, tcfg, world, topo, st = tp.setup(n, view_degree, packet_loss=loss)
    kill = np.zeros(n, bool)
    kill[: n // 20] = True
    st = _corrupt(st._replace(alive_truth=st.alive_truth & ~kill))
    js = jchaos.compile_schedule(n, _events(jchaos, n))
    ts = convert.schedule_from(tp.np_tree(js))
    step = jax.jit(lambda s, k: jswim.step_counted(jcfg, topo, world, s, k, js,
                                                   sentinel=True))
    draws = tp.make_draws_fn(jcfg, chaos=True)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    ps = convert.sim_state_from(tp.np_tree(st))
    base = jax.random.PRNGKey(5)
    totals = np.zeros(len(FIELDS), np.int64)
    for t in range(12):
        key = jax.random.fold_in(base, t)
        st, jc = step(st, key)
        ps, pc = tswim.step_counted(tcfg, tt, tw, ps, tp.to_tick_draws(draws(key)),
                                    sched=ts, sentinel=True)
        tp.assert_state_matches(tp.np_tree(st), ps, f"tick {t}")
        want = [int(x) for x in jc]
        assert [int(x) for x in pc] == want, f"tick {t} counters"
        totals += want
    for f in ("chaos_msgs_dropped", "chaos_fault_ticks", "sentinel_range",
              "sentinel_nonfinite_coord", "sentinel_nonfinite_rtt",
              "probe_timeouts"):
        assert totals[FIELDS.index(f)] > 0, f


def test_plain_tick_matches_interpret_tick():
    n = 256
    jcfg, tcfg, world, topo, st = tp.setup(n, 16, packet_loss=0.01)
    vec = np.asarray(st.viv.vec).copy()
    vec[7, :] = np.nan
    st = _nan_rtt(st._replace(viv=st.viv._replace(vec=jnp.asarray(vec))), 9)
    js = jchaos.compile_schedule(n, _events(jchaos, n))
    ts = convert.schedule_from(tp.np_tree(js))
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo, sentinel=True))
    draws = tp.make_draws_fn(jcfg, chaos=True)
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    pp = convert.packed_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(17)
    dropped = bad_rtt = 0
    for t in range(4):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, js, kp, key)
        pp, pc = cuda_gossip.plain_tick(tcfg, tt, tw, pp,
                                        tp.to_tick_draws(draws(key)), ts,
                                        sentinel=True)
        tp.assert_packed_close(tp.np_tree(kp), pp, f"tick {t}")
        assert pc.tolist() == [int(x) for x in kc], f"tick {t} counters"
        dropped += int(pc[FIELDS.index("chaos_msgs_dropped")])
        bad_rtt += int(pc[FIELDS.index("sentinel_nonfinite_rtt")])
    assert dropped > 0 and bad_rtt > 0


# ----------------------------------------------------------------------
# The Simulation entry points
# ----------------------------------------------------------------------

def _port_sim(jsim, tcfg, layout, chaos_draws):
    """The port's Simulation started from the reference simulation's
    world, topology and state, fed the reference's key ladder (with the
    chaos draw whenever a schedule is installed)."""
    base = jsim.base_key
    holder = {}

    def draws(t):
        d = chaos_draws(jax.random.fold_in(base, t))
        return tp.to_tick_draws(d, chaos=holder["sim"].chaos is not None)

    conv = (convert.packed_state_from if layout == "packed"
            else convert.sim_state_from)
    sim = tcluster.Simulation(
        tcfg, seed=0, layout=layout, kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=conv(tp.np_tree(jsim.state)), draws=draws)
    holder["sim"] = sim
    return sim


@pytest.mark.parametrize("field", ["sentinel_nonfinite_coord", "sentinel_range",
                                   "sentinel_nonfinite_rtt"])
def test_sentinel_violation_matches_reference(field):
    jcfg, tcfg = tp.configs(n=128, view_degree=16)
    jsim = jcluster.Simulation(jcfg, seed=11)
    tsim = _port_sim(jsim, tcfg, "dense", tp.make_draws_fn(jcfg, chaos=True))
    jsim.set_sentinel(True)
    tsim.set_sentinel(True)
    sw = jsim.swim_state
    if field == "sentinel_nonfinite_coord":
        vec = np.asarray(sw.viv.vec).copy()
        vec[3, :] = np.nan
        sw = sw._replace(viv=sw.viv._replace(vec=jnp.asarray(vec)))
    elif field == "sentinel_range":
        oi = np.asarray(sw.own_inc).copy()
        oi[5] = merge.MAX_INCARNATION + 5
        sw = sw._replace(own_inc=jnp.asarray(oi, dtype=jnp.uint32))
    else:
        sw = _nan_rtt(sw, 9)
    jsim.set_swim_state(sw)
    tsim.set_swim_state(convert.sim_state_from(tp.np_tree(sw)))
    with pytest.raises(jcluster.SentinelViolation) as want:
        jsim.run(32, chunk=16, with_metrics=False)
    with pytest.raises(tcluster.SentinelViolation) as got:
        tsim.run(32, chunk=16, with_metrics=False)
    assert got.value.deltas[field] > 0
    assert (got.value.mask, got.value.deltas) == (want.value.mask, want.value.deltas)
    assert tsim._t == int(jsim.swim_state.t) == 16
    assert str(got.value) == str(want.value)


def test_run_scenario_slo_matches_reference():
    """The bench's partition-heal probe (bench.py:467-470) at n = 1024: a
    30 % side split over ticks 4..16 of a scenario, 64 ticks to settle."""
    n = 1024
    jcfg, tcfg = tp.configs(n=n, view_degree=32)
    jsim = jcluster.Simulation(jcfg, seed=0, layout="packed")
    tsim = _port_sim(jsim, tcfg, "packed", tp.make_draws_fn(jcfg, chaos=True))
    jsim.run(64, chunk=32, with_metrics=False)
    tsim.run(64, chunk=32, with_metrics=False)
    assert tsim.counters == {f: jsim.counters[f] for f in FIELDS}
    events = lambda C: [C.Partition(start=4, stop=16,
                                    side_a=slice(0, int(n * 0.3)))]
    want = jsim.run_scenario(events(jchaos), chunk=32, settle=64)
    got = tsim.run_scenario(events(tchaos), chunk=32, settle=64)
    assert set(got.slo) == set(jcluster.SLO_KEYS.values())
    assert got.slo == want.slo
    assert got.counters == {f: want.counters[f] for f in FIELDS}
    assert got.ticks == want.ticks == 80
    assert got.slo["fault_ticks"] > 0 and got.slo["messages_dropped"] > 0
    assert tsim.chaos is None
    tp.assert_packed_equal(tp.np_tree(jsim.state), tsim.state, "after")


# ----------------------------------------------------------------------
# What is not ported, and the CUDA wrapper off the card
# ----------------------------------------------------------------------

def _small(n=128, k=16):
    cfg = TSimConfig(n=n, view_degree=k)
    gen = torch.Generator().manual_seed(0)
    world = ttopo.make_world(cfg, gen)
    topo = ttopo.make_topology(cfg, gen)
    return cfg, gen, world, topo


def test_unported_paths_raise():
    cfg, gen, world, topo = _small()
    sched = tchaos.compile_schedule(cfg.n, _events(tchaos, cfg.n))
    st = tlayout.pack(tstate.init(cfg, gen))
    d = tswim.draw_tick(cfg, gen, "cpu", chaos=True)
    kernel = cuda_gossip.make_tick_kernel(cfg, topo, sentinel=True)
    before = dict(cuda_gossip.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(world, st, d, sched)
    assert cuda_gossip.LAUNCHES == before
    dev = torch.device("cpu")
    kernel._check_inputs(world, st, d, dev, sched)
    with pytest.raises(ValueError, match="u_pp"):
        kernel._check_inputs(world, st, d._replace(u_pp=d.u_pp[:0]), dev, sched)
    with pytest.raises(TypeError, match="ll_fwd"):
        kernel._check_inputs(world, st, d, dev,
                             sched._replace(ll_fwd=sched.ll_fwd.double()))
    # The serf + chaos + sentinel variant takes a schedule and checks its
    # chaos draws, and still launches nothing on CPU tensors.
    skernel = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True,
                                           sentinel=True)
    sst = tlayout.pack_state(tserf.init(cfg, gen))
    sd = tserf.draw_serf_tick(cfg, gen, "cpu", chaos=True)
    skernel._check_inputs(world, sst, sd, dev, sched)
    with pytest.raises(ValueError, match="u_pp"):
        skernel._check_inputs(world, sst, tserf.draw_serf_tick(cfg, gen, "cpu"),
                              dev, sched)
    with pytest.raises(ValueError, match="CUDA tensors"):
        skernel(world, sst, sd, sched)
    assert cuda_gossip.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        tcluster.SerfSimulation(cfg, device="cpu", kernel="cuda")
    # The raft lane is taken on both simulations (ROADMAP A16): a
    # raft-only schedule is installed and runs the chaos tick (its draws
    # carry u_pp). The sentinel's diagnostic checkpoint (A12): a dump
    # directory is taken, and nothing is written until the sentinel trips.
    sim = tcluster.Simulation(cfg, device="cpu", kernel="torch")
    ssim = tcluster.SerfSimulation(cfg, device="cpu", kernel="torch")
    for s in (sim, ssim):
        s.set_chaos([tchaos.RaftKill(2, 8)])
        assert s.chaos is not None and s.chaos.rk_kind.shape[0] == 1
        d = s.draws(s._t)
        assert tuple((d.swim if s is ssim else d).u_pp.shape) == (cfg.n,)
        s.run(2, chunk=2, with_metrics=False)
        s.set_chaos(None)
        s.set_sentinel(True, dump_dir="diag")
        assert s.sentinel and s.sentinel_dump_dir == "diag"
        s.set_sentinel(False)
        assert not s.sentinel and s.sentinel_dump_dir == "diag"
    ssim.set_chaos([tchaos.Partition(1, 4, [0])])
    ssim.set_sentinel(True)
    assert ssim.chaos is not None and ssim.sentinel
    assert tuple(ssim.draws(ssim._t).swim.u_pp.shape) == (cfg.n,)
    sim.set_chaos([])
    assert sim.chaos is None


@pytest.mark.parametrize("leaf", cuda_gossip._SCHED_LEAVES)
def test_kernel_checks_every_schedule_leaf(leaf):
    """The wrapper holds each schedule leaf the kernel reads to the dtype
    and shape compile_schedule gives it, and names what it rejects."""
    cfg, gen, world, topo = _small()
    sched = tchaos.compile_schedule(cfg.n, _events(tchaos, cfg.n))
    st = tlayout.pack(tstate.init(cfg, gen))
    d = tswim.draw_tick(cfg, gen, "cpu", chaos=True)
    kernel = cuda_gossip.make_tick_kernel(cfg, topo, sentinel=True)
    dev = torch.device("cpu")
    kernel._check_inputs(world, st, d, dev, sched)
    x = getattr(sched, leaf)
    other = torch.int64 if x.dtype != torch.int64 else torch.int32
    with pytest.raises(TypeError, match=leaf):
        kernel._check_inputs(world, st, d, dev,
                             sched._replace(**{leaf: x.to(other)}))
    # A family's slot count is its start leaf's length, so a short start
    # leaf shows as a mismatch of a sibling.
    with pytest.raises(ValueError, match="sched." + leaf.split("_")[0]):
        kernel._check_inputs(world, st, d, dev,
                             sched._replace(**{leaf: x[:-1]}))


def test_simulation_chaos_draws_and_clear():
    """set_chaos draws u_pp only while a schedule is installed, and an
    empty schedule leaves the bare tick's draws and trajectory."""
    cfg, gen, world, topo = _small()
    a = tcluster.Simulation(cfg, seed=4, device="cpu", kernel="torch")
    b = tcluster.Simulation(cfg, seed=4, device="cpu", kernel="torch")
    b.set_chaos(tchaos.empty(cfg.n))
    a.run(8, chunk=4, with_metrics=False)
    b.run(8, chunk=4, with_metrics=False)
    assert a.counters == b.counters
    b.set_chaos([tchaos.Partition(0, 100, slice(0, 32))])
    assert tuple(b.draws(b._t).u_pp.shape) == (cfg.n,)
    b.run(4, chunk=4, with_metrics=False)
    assert b.counters["chaos_fault_ticks"] == 4
    b.set_chaos(None)
    assert b.draws(b._t).u_pp.numel() == 0


def test_hbm_contract_with_schedule_matches_reference():
    n = 1024
    jcfg, tcfg = tp.configs(n=n, view_degree=32)
    from consul_tpu.models import state as jstate
    from consul_tpu.ops import topology as jtopo
    jst = jlayout.pack(jstate.init(jcfg, jax.random.PRNGKey(0)))
    jw = jtopo.make_world(jcfg, jax.random.PRNGKey(1))
    for kind in ("mixed", "churn", "none"):
        js, ts = _both(n, kind)
        want = pallas_gossip.tick_hbm_bytes_per_node(jst, jw, js)
        gen = torch.Generator().manual_seed(0)
        got = cuda_gossip.tick_hbm_bytes_per_node(
            tlayout.pack(tstate.init(tcfg, gen)), ttopo.make_world(tcfg, gen), ts)
        assert got == want, kind
    # Bool masks are one byte per node and slot (2 + 4 + 1 + 3 = 10
    # slots), beside 112 bytes of per-slot scalars.
    st, world = tlayout.pack(tstate.init(tcfg, gen)), ttopo.make_world(tcfg, gen)
    extra = (cuda_gossip.tick_hbm_bytes_per_node(
        st, world, tchaos.compile_schedule(n, _events(tchaos, n)))
        - cuda_gossip.tick_hbm_bytes_per_node(st, world))
    assert extra == pytest.approx(10 + 112 / n)
