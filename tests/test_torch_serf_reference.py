"""PyTorch port vs the JAX reference: the pre-fusion serf oracle
(``serf.step_reference_counted``, ``cluster.ReferenceSerfSimulation``).

Inputs come from the reference and cross through ``convert.py``; random
numbers are the reference's own key ladder for the pre-fusion tick
(``torch_parity.make_reference_serf_draws_fn``: ``k_cols, k_loss, k_resp =
split(k_ev, 3)``). At n = 256, K = 16:

- 20 ticks of ``serf.step_reference_counted`` (dense SWIM plane, rounded
  through the packed codec each tick as the reference's packed driver
  does) and of ``cluster.plain_reference_serf_tick`` (packed) against the
  reference's jitted step, with an event storm, a query and a leave in
  flight: chaos off with 1 % loss and no relays, and under a partition
  with a lossy link, the sentinel on and two relays: every serf leaf,
  every discrete SWIM leaf and all 26 counters equal on every tick,
  floats within ``torch_parity``'s tolerance;
- ``ReferenceSerfSimulation(device="cpu", kernel="torch")`` against the reference's over
  two chunks from the reference's world, topology and state, fed its key
  ladder;
- on the port alone, ``SerfSimulation`` against ``ReferenceSerfSimulation``
  from one seed (tests/test_serf_fused.py's observables at n = 512): the
  SWIM plane bit for bit, every fired event at coverage 1.0 on both,
  per-node delivered counts, ``event_clock`` / ``ev_floor`` / ``q_floor``
  and the SLO counters equal, chaos off with a query and chaos on with
  events only;
- ``kernel="cuda"`` (its default, B8) raises on the CPU; on a card the
  oracle runs through it (``tests/test_torch_b8.py``, which imports no
  JAX, holds that and B8's wrapper).
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.config import SerfConfig as JSerfConfig
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import layout as jlayout
from consul_tpu.models import serf as jserf
from consul_tpu.ops import topology as jtopo
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch.config import SerfConfig as TSerfConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import serf as tserf

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

FIELDS = tcounters.FIELDS
N, K = 256, 16
TICKS = 20
Q_ROW = 40


def _configs(rf, loss, n=N):
    jcfg, tcfg = tp.configs(n=n, view_degree=K, packet_loss=loss)
    return (jcfg.__class__(**{**jcfg.__dict__,
                              "serf": JSerfConfig(query_relay_factor=rf)}),
            tcfg.__class__(**{**tcfg.__dict__,
                              "serf": TSerfConfig(query_relay_factor=rf)}))


def _mask(rows, n=N):
    m = np.zeros(n, bool)
    m[list(rows)] = True
    return m


def _in_flight(jcfg, st):
    """An event storm from both halves (12 events over 6 ltimes), a query
    from Q_ROW and a leave that goes quiet inside the window."""
    n = jcfg.n
    for lt in range(6):
        st = jserf.user_event(jcfg, st, _mask([14 + lt, n // 2 + 5 + lt], n),
                              5 + lt)
    st = jserf.query(jcfg, st, _mask([Q_ROW], n), 3)
    st = jserf.leave(jcfg, st, _mask([n - 20], n))
    return st._replace(leave_at=st.leave_at.at[n - 20].set(6))


def _events(C, n):
    return [C.Partition(1, 10, slice(0, n // 4)),
            C.LinkLoss(0, 14, slice(0, n // 8), slice(n // 8, n // 2),
                       fwd=0.5, rev=0.3)]


@pytest.mark.parametrize("chaos_on,rf,loss", [(False, 0, 0.01), (True, 2, 0.0)],
                         ids=["quiet-loss1pct", "partition-relay2-sentinel"])
def test_step_reference_counted_matches_reference(chaos_on, rf, loss):
    jcfg, tcfg = _configs(rf, loss)
    kw, kt, ks = jax.random.split(jax.random.PRNGKey(3), 3)
    world, topo = jtopo.make_world(jcfg, kw), jtopo.make_topology(jcfg, kt)
    st = jserf.init(jcfg, ks)
    st = st._replace(swim=st.swim._replace(
        alive_truth=st.swim.alive_truth & ~_mask(range(N // 20))))
    st = _in_flight(jcfg, st)
    js = jchaos.compile_schedule(N, _events(jchaos, N)) if chaos_on else None
    ts = convert.schedule_from(tp.np_tree(js)) if chaos_on else None

    @jax.jit
    def ref_tick(s, k):
        s, c = jserf.step_reference_counted(jcfg, topo, world, s, k, js,
                                            sentinel=chaos_on)
        return jlayout.unpack_state(jlayout.pack_state(s)), c

    draws = tp.make_reference_serf_draws_fn(jcfg, chaos=chaos_on)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    dense = convert.serf_state_from(tp.np_tree(st))
    packed = convert.serf_state_from(tp.np_tree(jlayout.pack_state(st)))
    base = jax.random.PRNGKey(17)
    totals = np.zeros(len(FIELDS), np.int64)
    for t in range(TICKS):
        key = jax.random.fold_in(base, t)
        st, jc = ref_tick(st, key)
        d = tp.to_reference_serf_draws(draws(key))
        assert d.relay_u1.shape[1] == rf
        dense, dc = tserf.step_reference_counted(tcfg, tt, tw, dense, d,
                                                 sched=ts, sentinel=chaos_on)
        dense = tlayout.unpack_state(tlayout.pack_state(dense))
        packed, pc = tcluster.plain_reference_serf_tick(
            tcfg, tt, tw, packed, d, ts, sentinel=chaos_on)
        want = [int(x) for x in jc]
        assert [int(x) for x in dc] == want, f"tick {t} counters"
        assert pc.tolist() == want, f"tick {t} packed counters"
        ref = tp.np_tree(st)
        tp.assert_serf_equal(ref, dense, f"tick {t}")
        tp.assert_state_matches(ref.swim, dense.swim, f"tick {t}")
        ref_p = tp.np_tree(jlayout.pack_state(st))
        tp.assert_serf_equal(ref_p, packed, f"tick {t} packed")
        tp.assert_packed_close(ref_p.swim, packed.swim, f"tick {t} packed")
        totals += want
    moved = ["serf_intents_queued", "serf_intents_retx", "serf_intents_dropped"]
    if chaos_on:
        moved += ["chaos_msgs_dropped", "chaos_fault_ticks"]
    for f in moved:
        assert totals[FIELDS.index(f)] > 0, f
    final = tp.np_tree(st)
    assert final.swim.left[N - 20]
    assert final.ev_delivered.sum() > N
    assert final.q_acks[Q_ROW].max() > 0


def test_reference_serf_simulation_matches_reference():
    jcfg, tcfg = _configs(0, 0.01)
    jsim = jcluster.ReferenceSerfSimulation(jcfg, seed=5, layout="packed")
    base = jsim.base_key
    draws = tp.make_reference_serf_draws_fn(jcfg)
    tsim = tcluster.ReferenceSerfSimulation(
        tcfg, seed=0, device="cpu", kernel="torch",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.serf_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_reference_serf_draws(
            draws(jax.random.fold_in(base, t))))
    for sim in (jsim, tsim):
        sim.user_event(_mask([3]), 21)
        sim.user_event(_mask([130]), 22)
        sim.query(_mask([Q_ROW]), 4)
    for c in range(2):
        jsim.run(16, chunk=16, with_metrics=False)
        tsim.run(16, chunk=16, with_metrics=False)
        ref = tp.np_tree(jsim.state)
        tp.assert_serf_equal(ref, tsim.state, f"chunk {c}")
        tp.assert_packed_close(ref.swim, tsim.state.swim, f"chunk {c}")
        assert tsim.counters == {f: int(v) for f, v in jsim.counters.items()
                                 if f in tsim.counters}, f"chunk {c}"
    assert tsim.counters["serf_intents_queued"] > 0


# ----------------------------------------------------------------------
# The fused tick against the oracle, on the port alone
# ----------------------------------------------------------------------

FN = 512
FUSED_EVENTS = [(0, 11), (97, 42), (FN - 1, 7)]
FUSED_QUERY = (9, 3)


def _fire(sim):
    keys = []
    for row, name in FUSED_EVENTS:
        keys.append((int(tserf.make_event_key(int(sim.state.event_clock[row]),
                                              name)), row))
        sim.user_event(torch.arange(FN) == row, name)
    return keys


def _converged(sim, keys):
    st = sim.serf_state
    return all(float(tserf.event_coverage(sim.cfg, st, k, o)) == 1.0
               for k, o in keys)


@pytest.mark.parametrize("with_chaos", [False, True], ids=["quiet-query",
                                                           "chaos-events"])
def test_fused_matches_oracle_observables(with_chaos):
    cfg = TSimConfig(n=FN, view_degree=16)
    fused = tcluster.SerfSimulation(cfg, seed=3, device="cpu", kernel="torch")
    oracle = tcluster.ReferenceSerfSimulation(cfg, seed=3, device="cpu",
                                              kernel="torch")
    fired = [_fire(sim) for sim in (fused, oracle)]
    assert fired[0] == fired[1]
    for sim in (fused, oracle):
        if with_chaos:
            sim.run_scenario([tchaos.LinkLoss(
                start=1, stop=13, a=slice(0, FN // 8), b=slice(FN // 2, FN),
                fwd=0.5, rev=0.5)], ticks=48, chunk=16)
        else:
            sim.query(torch.arange(FN) == FUSED_QUERY[0], FUSED_QUERY[1])
            sim.run(48, chunk=16, with_metrics=False)
    a, b = fused.serf_state, oracle.serf_state
    for f in tp.DISCRETE:
        assert torch.equal(getattr(a.swim, f), getattr(b.swim, f)), f
    for f in a.swim.viv._fields:
        assert torch.equal(getattr(a.swim.viv, f), getattr(b.swim.viv, f)), f
    assert torch.equal(a.swim.lat_buf, b.swim.lat_buf)
    assert _converged(fused, fired[0]) and _converged(oracle, fired[0])
    for f in ("ev_delivered", "event_clock", "ev_floor", "q_floor"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    slo = [{f: sim.counters[f] for f in tcluster.SLO_KEYS}
           for sim in (fused, oracle)]
    assert slo[0] == slo[1]
    if with_chaos:
        assert slo[0]["chaos_msgs_dropped"] > 0
    else:
        qrow, qname = FUSED_QUERY
        qkey = int(tserf.make_event_key(int(a.query_clock[qrow]) - 1, qname,
                                        True))
        for sim in (fused, oracle):
            assert float(tserf.event_coverage(cfg, sim.serf_state, qkey,
                                              qrow)) == 1.0


def _assert_leaves_equal(a, b, path="state"):
    """Every leaf of two state trees (nested named tuples) equal."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
        return
    for f in a._fields:
        _assert_leaves_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")


@pytest.mark.parametrize("uncounted,counted", [
    (tserf.step, tserf.step_counted),
    (tserf.step_reference, tserf.step_reference_counted)],
    ids=["fused", "reference"])
def test_uncounted_step_is_the_counted_state(uncounted, counted):
    """``serf.step`` / ``serf.step_reference`` (reference serf.py:466,
    :584) return their counted forms' state, under a schedule too."""
    cfg = TSimConfig(n=FN, view_degree=16)
    sim_cls = (tcluster.ReferenceSerfSimulation
               if counted is tserf.step_reference_counted
               else tcluster.SerfSimulation)
    sim = sim_cls(cfg, seed=3, device="cpu", kernel="torch")
    _fire(sim)
    sim.set_chaos([tchaos.LinkLoss(
        start=0, stop=4, a=slice(0, FN // 8), b=slice(FN // 2, FN),
        fwd=0.5, rev=0.5)])
    sched = sim.chaos
    st = sim.serf_state
    for t in range(3):
        d = sim.draws(t)
        want, _ = counted(cfg, sim.topo, sim.world, st, d, sched=sched,
                          sentinel=True)
        got = uncounted(cfg, sim.topo, sim.world, st, d, sched=sched,
                        sentinel=True)
        _assert_leaves_equal(want, got, f"tick {t}")
        st = want
    assert int(st.ev_delivered.sum()) > 0


def test_oracle_resume_is_bit_equal(tmp_path):
    """A checkpoint carries both of the oracle's generators: a save, a few
    ticks, then a restore and the rest of the run leave the oracle
    bit-equal to an uninterrupted run (the event sweep draws as it would
    have)."""
    from consul_tpu_torch.utils import checkpoint as ckpt_mod

    cfg = TSimConfig(n=FN, view_degree=16)
    whole = tcluster.ReferenceSerfSimulation(cfg, seed=3, device="cpu",
                                             kernel="torch")
    resumed = tcluster.ReferenceSerfSimulation(cfg, seed=3, device="cpu",
                                               kernel="torch")
    for sim in (whole, resumed):
        _fire(sim)
        sim.run(16, chunk=16, with_metrics=False)
    path = str(tmp_path / "oracle.ckpt")
    ckpt_mod.save(path, resumed.state,
                  meta={"generator": resumed.generator_state()})
    _fire(resumed)
    resumed.run(16, chunk=16, with_metrics=False)
    resumed.load_state(ckpt_mod.restore(path, resumed.state),
                       generator=ckpt_mod.read_meta(path)["generator"])
    for sim in (whole, resumed):
        _fire(sim)
        sim.run(8, chunk=8, with_metrics=False)
    _assert_leaves_equal(whole.serf_state, resumed.serf_state)
    assert whole.generator_state() == resumed.generator_state()
    swim_only = dict(resumed.generator_state())
    del swim_only["event_state"]
    with pytest.raises(ValueError, match="event sweep"):
        resumed.load_state(resumed.state, generator=swim_only)


def test_cuda_kernel_refused():
    """B8 is the oracle's default engine: ``kernel="cuda"`` (or its alias
    ``"pallas"``) without a card raises and never falls back, as does a
    mesh; ``kernel="torch"`` runs the plain version on the CPU."""
    cfg = TSimConfig(n=64, view_degree=8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tcluster.ReferenceSerfSimulation(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tcluster.ReferenceSerfSimulation(cfg, device="cpu", kernel="pallas")
    with pytest.raises(ValueError, match="one device"):
        tcluster.ReferenceSerfSimulation(cfg, device="cpu", kernel="torch",
                                         mesh=["cpu"] * 2)
    assert tcluster.ReferenceSerfSimulation.kernel == "cuda"
    sim = tcluster.ReferenceSerfSimulation(cfg, seed=1, device="cpu",
                                           kernel="xla")
    assert sim.kernel == "torch"
    assert isinstance(sim.draws(0), tserf.ReferenceSerfDraws)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        sim.set_kernel("cuda")
    assert sim.kernel == "torch"

