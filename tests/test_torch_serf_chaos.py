"""PyTorch port vs the JAX reference: the serf tick under a fault schedule
and the invariant sentinel (``serf.step_counted(sched, sentinel=True)``,
``cuda_gossip.plain_serf_tick(sched, sentinel=True)`` and
``SerfSimulation.set_chaos``/``run_scenario``/``set_sentinel``).

Inputs come from the reference and cross through ``convert.py``; random
numbers are the reference's own key ladder with the chaos draws
(``torch_parity.make_serf_draws_fn(chaos=True)``: ``u_pp`` and the relay
draws, which a schedule runs even without loss).

- 12 ticks of ``serf.step_counted`` (dense SWIM plane, rounded through the
  packed codec each tick as the reference's packed simulation does) and of
  ``plain_serf_tick`` against the reference's jitted step at n = 256,
  K = 16, under every fault family overlapping and under a partition
  alone, ``query_relay_factor`` 0 and 2, loss 0 and 0.01, with an event
  storm, a query whose origin sits on the partition's side A and a leave
  in flight, and corruption for the sentinel: every serf leaf, every
  discrete SWIM leaf and all 26 counters equal on every tick; floats
  within ``torch_parity``'s tolerance.
- 4 ticks of ``plain_serf_tick(sched, sentinel=True)`` against the
  reference's interpret-mode Pallas tick with ``step_fn=serf.step_counted``.
- ``SerfSimulation.run_scenario`` against the reference's on
  tests/test_chaos.py:336-350's partition heal with churn, cut to n = 1024
  and 96 ticks: the SLO counters, the query's acks and responses and each
  event's coverage equal.
- The serf sentinel's ``SentinelViolation`` equals the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.config import SerfConfig as JSerfConfig
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import layout as jlayout
from consul_tpu.models import serf as jserf
from consul_tpu.ops import pallas_gossip
from consul_tpu.ops import topology as jtopo
from consul_tpu_torch import convert
from consul_tpu_torch.chaos import schedule as tchaos
from consul_tpu_torch.config import SerfConfig as TSerfConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.ops import cuda_gossip, merge, topology as ttopo

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

FIELDS = tcounters.FIELDS
N, K = 256, 16
TICKS = 12
# The query's origin: a live row on both Partitions' side A, so that some
# of its responders sit across a partition from it.
Q_ROW = 40


def _configs(n=N, k=K, rf=0, loss=0.0):
    jcfg, tcfg = tp.configs(n=n, view_degree=k, packet_loss=loss)
    return (jcfg.__class__(**{**jcfg.__dict__,
                              "serf": JSerfConfig(query_relay_factor=rf)}),
            tcfg.__class__(**{**tcfg.__dict__,
                              "serf": TSerfConfig(query_relay_factor=rf)}))


def _events(C, n, family):
    """Every family, overlapping (two Partitions, two LinkLosses, a
    ChurnWave whose kill and revive edges fall inside the window, two
    Degrades on the same rows), or the first Partition alone."""
    events = [
        C.Partition(1, 10, slice(0, n // 4)),
        C.Partition(3, 12, slice(n // 8, 3 * n // 8)),
        C.LinkLoss(0, 14, slice(0, n // 8), slice(n // 8, n // 4), fwd=0.8,
                   rev=0.2),
        C.LinkLoss(2, 14, slice(0, n // 4), slice(n // 8, n // 2), fwd=0.3,
                   rev=0.6),
        C.ChurnWave(1, 20, slice(n // 2, n // 2 + n // 20), period=4,
                    down_ticks=2),
        C.Degrade(0, 14, slice(n - n // 8, n), tx_loss=0.4),
        C.Degrade(2, 14, slice(n - n // 4, n), tx_loss=0.7, rx_loss=0.1),
    ]
    return events if family == "mixed" else events[:1]


def _mask(rows, n=N):
    m = np.zeros(n, bool)
    m[list(rows)] = True
    return m


def _in_flight(jcfg, st):
    """An event storm from both partition sides (12 events over 6
    ltimes), a query from Q_ROW, a leave that goes quiet inside the
    window, and corruption for the sentinel that the packed layout
    keeps: a NaN coordinate and a NaN RTT sample on live rows."""
    n = jcfg.n
    for lt in range(6):
        st = jserf.user_event(jcfg, st, _mask([14 + lt, n // 2 + 5 + lt], n),
                              5 + lt)
    st = jserf.query(jcfg, st, _mask([Q_ROW], n), 3)
    st = jserf.leave(jcfg, st, _mask([n - 20], n))
    st = st._replace(leave_at=st.leave_at.at[n - 20].set(6))
    sw = st.swim
    vec = np.asarray(sw.viv.vec).copy()
    vec[3 * n // 4, :] = np.nan
    buf = np.asarray(sw.lat_buf).copy()
    cnt = np.asarray(sw.lat_cnt).copy()
    buf[n // 2, :2, 0] = np.nan
    cnt[n // 2, :2] = np.maximum(cnt[n // 2, :2], 2)
    return st._replace(swim=sw._replace(
        viv=sw.viv._replace(vec=jnp.asarray(vec)), lat_buf=jnp.asarray(buf),
        lat_cnt=jnp.asarray(cnt, dtype=sw.lat_cnt.dtype)))


def _setup(rf, loss, family):
    jcfg, tcfg = _configs(rf=rf, loss=loss)
    kw, kt, ks = jax.random.split(jax.random.PRNGKey(3), 3)
    world, topo = jtopo.make_world(jcfg, kw), jtopo.make_topology(jcfg, kt)
    st = jserf.init(jcfg, ks)
    kill = _mask(range(N // 20))
    st = st._replace(swim=st.swim._replace(alive_truth=st.swim.alive_truth & ~kill))
    js = jchaos.compile_schedule(N, _events(jchaos, N, family))
    return jcfg, tcfg, world, topo, _in_flight(jcfg, st), js


@pytest.mark.parametrize("family,rf,loss", [
    ("mixed", 2, 0.01), ("mixed", 0, 0.0), ("partition", 2, 0.0),
    ("partition", 0, 0.01)],
    ids=["mixed-relay2-loss1pct", "mixed-relay0-loss0",
         "partition-relay2-loss0", "partition-relay0-loss1pct"])
def test_step_counted_matches_reference(family, rf, loss):
    jcfg, tcfg, world, topo, st, js = _setup(rf, loss, family)
    ts = convert.schedule_from(tp.np_tree(js))

    @jax.jit
    def ref_tick(s, k):
        s, c = jserf.step_counted(jcfg, topo, world, s, k, js, sentinel=True)
        return jlayout.unpack_state(jlayout.pack_state(s)), c

    draws = tp.make_serf_draws_fn(jcfg, chaos=True)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    dense = convert.serf_state_from(tp.np_tree(st))
    packed = convert.serf_state_from(tp.np_tree(jlayout.pack_state(st)))
    acks0 = int(np.asarray(st.q_acks)[Q_ROW].sum())
    base = jax.random.PRNGKey(17)
    totals = np.zeros(len(FIELDS), np.int64)
    for t in range(TICKS):
        key = jax.random.fold_in(base, t)
        st, jc = ref_tick(st, key)
        d = tp.to_serf_draws(draws(key))
        assert d.relay_u1.shape[1] == rf
        dense, dc = tserf.step_counted(tcfg, tt, tw, dense, d, sched=ts,
                                       sentinel=True)
        dense = tlayout.unpack_state(tlayout.pack_state(dense))
        packed, pc = cuda_gossip.plain_serf_tick(tcfg, tt, tw, packed, d, ts,
                                                 sentinel=True)
        want = [int(x) for x in jc]
        assert [int(x) for x in dc] == want, f"tick {t} counters"
        assert pc.tolist() == want, f"tick {t} plain_serf_tick counters"
        ref = tp.np_tree(st)
        tp.assert_serf_equal(ref, dense, f"tick {t}")
        tp.assert_state_matches(ref.swim, dense.swim, f"tick {t}")
        ref_p = tp.np_tree(jlayout.pack_state(st))
        tp.assert_serf_equal(ref_p, packed, f"tick {t} packed")
        tp.assert_packed_close(ref_p.swim, packed.swim, f"tick {t} packed")
        totals += want
    for f in ("chaos_msgs_dropped", "chaos_fault_ticks", "serf_intents_queued",
              "serf_intents_retx", "sentinel_nonfinite_coord",
              "sentinel_nonfinite_rtt"):
        assert totals[FIELDS.index(f)] > 0, f
    final = tp.np_tree(st)
    assert final.swim.left[N - 20]
    # The partition kept some acks from the query's origin.
    acks = int(final.q_acks[Q_ROW].sum()) - acks0
    live = int((final.swim.alive_truth & ~final.swim.left).sum())
    assert 0 < acks < live


def test_plain_serf_tick_matches_interpret_tick():
    jcfg, tcfg, world, topo, st, js = _setup(2, 0.01, "mixed")
    ts = convert.schedule_from(tp.np_tree(js))
    tick = jax.jit(pallas_gossip.interpret_tick(
        jcfg, topo, step_fn=jserf.step_counted, sentinel=True))
    draws = tp.make_serf_draws_fn(jcfg, chaos=True)
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    pp = convert.serf_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(23)
    dropped = 0
    for t in range(4):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, js, kp, key)
        pp, pc = cuda_gossip.plain_serf_tick(tcfg, tt, tw, pp,
                                             tp.to_serf_draws(draws(key)), ts,
                                             sentinel=True)
        ref = tp.np_tree(kp)
        tp.assert_serf_equal(ref, pp, f"tick {t}")
        tp.assert_packed_close(ref.swim, pp.swim, f"tick {t}")
        assert pc.tolist() == [int(x) for x in kc], f"tick {t} counters"
        dropped += int(pc[FIELDS.index("chaos_msgs_dropped")])
    assert dropped > 0


# ----------------------------------------------------------------------
# SerfSimulation
# ----------------------------------------------------------------------

def _port_sim(jsim, tcfg, layout):
    """The port's SerfSimulation started from the reference simulation's
    world, topology and state, fed the reference's key ladder (with the
    chaos draws whenever a schedule is installed)."""
    base = jsim.base_key
    plain = tp.make_serf_draws_fn(jsim.cfg)
    chaos = tp.make_serf_draws_fn(jsim.cfg, chaos=True)
    holder = {}

    def draws(t):
        fn = plain if holder["sim"].chaos is None else chaos
        return tp.to_serf_draws(fn(jax.random.fold_in(base, t)))

    sim = tcluster.SerfSimulation(
        tcfg, seed=0, layout=layout, kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.serf_state_from(tp.np_tree(jsim.state)), draws=draws)
    holder["sim"] = sim
    return sim


def test_run_scenario_matches_reference():
    """tests/test_chaos.py:336-350 (a partition of 30 % that heals inside
    the suspicion window, with a churn wave riding along, on the serf
    stack) at n = 1024, with 32 ticks to form and 96 ticks of scenario,
    with two events and a query from side A in flight."""
    n = 1024
    jcfg, tcfg = _configs(n=n, rf=2)
    jsim = jcluster.SerfSimulation(jcfg, seed=1, layout="packed")
    tsim = _port_sim(jsim, tcfg, "packed")
    tsim.set_sentinel(True)
    jsim.set_sentinel(True)
    jsim.run(32, chunk=32, with_metrics=False)
    tsim.run(32, chunk=32, with_metrics=False)
    fired = []
    for r, name in ((100, 21), (700, 22)):
        fired.append((int(np.asarray(jsim.serf_state.event_clock)[r]), name, r))
        jsim.user_event(_mask([r], n), name)
        tsim.user_event(_mask([r], n), name)
    jsim.query(_mask([Q_ROW], n), 3)
    tsim.query(_mask([Q_ROW], n), 3)
    # The slot closes at its deadline inside the scenario; its tallies stay.
    slot = jserf.newest_query_slot(jsim.serf_state, Q_ROW)
    assert tserf.newest_query_slot(tsim.state, Q_ROW) == slot >= 0
    events = lambda C: [C.Partition(start=2, stop=42, side_a=slice(0, 307)),
                        C.ChurnWave(start=8, stop=24, nodes=slice(990, 1000))]
    want = jsim.run_scenario(events(jchaos), ticks=96, chunk=32)
    got = tsim.run_scenario(events(tchaos), ticks=96, chunk=32)
    assert got.slo == want.slo
    assert got.counters == {f: want.counters[f] for f in FIELDS}
    assert got.slo["fault_ticks"] >= 40 and got.slo["messages_dropped"] > 0
    assert got.counters["sentinel_monotonic"] == 0
    ref = tp.np_tree(jsim.state)
    tp.assert_serf_equal(ref, tsim.state, "after")
    tp.assert_packed_equal(ref.swim, tsim.state.swim, "after")
    acks = int(tsim.state.q_acks[Q_ROW, slot])
    assert acks == int(ref.q_acks[Q_ROW, slot]) > 0
    assert int(tsim.state.q_resps[Q_ROW, slot]) == int(ref.q_resps[Q_ROW, slot])
    dense = tsim.serf_state
    jdense = jlayout.unpack_state(jsim.serf_state)
    for lt, name, r in fired:
        cover = float(tserf.event_coverage(tcfg, dense,
                                           tserf.make_event_key(lt, name), r))
        assert cover == float(jserf.event_coverage(
            jcfg, jdense, jserf.make_event_key(lt, name), r)) > 0.0
    assert tsim.chaos is None


@pytest.mark.parametrize("field", ["sentinel_nonfinite_coord", "sentinel_range"])
def test_sentinel_violation_matches_reference(field):
    jcfg, tcfg = _configs(n=128)
    jsim = jcluster.SerfSimulation(jcfg, seed=11)
    tsim = _port_sim(jsim, tcfg, "dense")
    jsim.set_sentinel(True)
    tsim.set_sentinel(True)
    sw = jsim.swim_state
    if field == "sentinel_nonfinite_coord":
        vec = np.asarray(sw.viv.vec).copy()
        vec[3, :] = np.nan
        sw = sw._replace(viv=sw.viv._replace(vec=jnp.asarray(vec)))
    else:
        oi = np.asarray(sw.own_inc).copy()
        oi[5] = merge.MAX_INCARNATION + 5
        sw = sw._replace(own_inc=jnp.asarray(oi, dtype=jnp.uint32))
    jsim.set_swim_state(sw)
    tsim.set_swim_state(convert.sim_state_from(tp.np_tree(sw)))
    with pytest.raises(jcluster.SentinelViolation) as want:
        jsim.run(32, chunk=16, with_metrics=False)
    with pytest.raises(tcluster.SentinelViolation) as got:
        tsim.run(32, chunk=16, with_metrics=False)
    assert got.value.deltas[field] > 0
    assert (got.value.mask, got.value.deltas) == (want.value.mask, want.value.deltas)
    assert str(got.value) == str(want.value)
    tp.assert_serf_equal(tp.np_tree(jsim.state), tsim.state, "tripped")


def test_serf_hbm_contract_with_schedule_matches_reference():
    """The serf variant's contract counts the schedule as the reference's
    does, and its buffers take the schedule, the chaos draws and the
    relay draws a schedule runs."""
    n = 1024
    jcfg, tcfg = _configs(n=n, k=32, rf=2)
    jst = jlayout.pack_state(jserf.init(jcfg, jax.random.PRNGKey(0)))
    jw = jtopo.make_world(jcfg, jax.random.PRNGKey(1))
    js = jchaos.compile_schedule(n, _events(jchaos, n, "mixed"))
    want = pallas_gossip.tick_hbm_bytes_per_node(jst, jw, js)
    gen = torch.Generator().manual_seed(0)
    st = tlayout.pack_state(tserf.init(tcfg, gen))
    world = ttopo.make_world(tcfg, gen)
    ts = tchaos.compile_schedule(n, _events(tchaos, n, "mixed"))
    got = cuda_gossip.tick_hbm_bytes_per_node(st, world, ts)
    assert got == want
    assert got > cuda_gossip.tick_hbm_bytes_per_node(st, world)
    kernel = cuda_gossip.make_tick_kernel(
        tcfg, ttopo.make_topology(tcfg, gen), serf_plane=True,
        sentinel=True)
    d = tserf.draw_serf_tick(tcfg, gen, "cpu", chaos=True)
    assert d.relay_u1.shape == (n, 2)
    moved = kernel.buffer_bytes_per_node(world, st, d, ts)
    assert moved > kernel.buffer_bytes_per_node(
        world, st, tserf.draw_serf_tick(tcfg, gen, "cpu")) > got
