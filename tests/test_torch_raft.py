"""PyTorch port vs the JAX reference: the batched raft tier
(``consul_tpu_torch/ops/raft_ops.py``, ``models/raft.py`` and its wiring
into ``Simulation``, the serving write path and ``run_resilient``).

- ``raft_ops.tick`` equals the reference's ``raft_ops.tick`` and
  ``server/raft.LockstepRaftOracle`` field by field at every tick, fed
  the reference's ``draw_table``, quiet and under a leader kill, a
  partition and a storm, with a log window that fills (a re-elected
  leader's no-op does not fit); ``chaos_masks`` equals the reference's
  ``chaos_masks_reference``; ``summary`` equals the reference's.
- ``Simulation(kernel="torch", device="cpu")`` with ``set_raft`` equals
  the reference's ``Simulation.set_raft`` at chunk boundaries, gossip and
  raft, with the reference's draws.
- Arming raft and clearing it leaves the gossip trajectory bit-equal.
- The write gate: a write answers ``proposed`` and applies only at quorum
  commit; the leader-kill drill loses no acknowledged write.
- Raft counters reach ``Simulation.sink``; ``run_resilient``'s meta
  carries the raft frontier.
"""

import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.models import layout as jlayout
from consul_tpu.models import raft as jraft_mod
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.ops import raft_ops as jraft
from consul_tpu.server.raft import LockstepRaftOracle
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch import runtime as rt
from consul_tpu_torch.config import RaftConfig as TRaftConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.ops import raft_ops as traft
from consul_tpu_torch.serving import ServingPlane

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

# Short timeouts so elections resolve inside small windows (the
# reference's tests/test_raft_device.py settings).
ELECTION = dict(election_ticks_min=6, election_ticks_max=12)


def _rcfgs(groups=2, peers=3, window=16):
    kw = dict(groups=groups, peers=peers, window=window, **ELECTION)
    return JRaftConfig(**kw), TRaftConfig(**kw)


def _events(mod, groups):
    """A leader kill on every group once logs are full, a minority cut of
    the last group, then a storm on every group."""
    return [mod.RaftKill(start=30, stop=44, group=-1, peer=-1),
            mod.RaftPartition(start=48, stop=60, cut=1, group=groups - 1),
            mod.RaftStorm(start=64, stop=72, group=-1)]


def _assert_raft_equal(got, want, where):
    """Every RaftState field of the port (tensors) against ``want``
    (numpy or JAX arrays, or the oracle's snapshot dict), exactly."""
    for f in traft.RaftState._fields:
        g = getattr(got, f).cpu().numpy()
        w = np.asarray(want[f] if isinstance(want, dict) else getattr(want, f))
        assert g.dtype == (bool if f == "log_client" else np.int32), (where, f)
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=f"{where}: RaftState.{f}")


# -- (a) the tick against the reference and the oracle --------------------

TICK_CASES = [(2, 3, 16), (3, 5, 8)]


@pytest.mark.parametrize("chaos", [False, True], ids=["quiet", "chaos"])
@pytest.mark.parametrize("shape", TICK_CASES,
                         ids=[f"{g}x{p}w{w}" for g, p, w in TICK_CASES])
def test_tick_matches_reference_and_oracle(shape, chaos):
    groups, peers, window = shape
    jcfg, tcfg = _rcfgs(groups, peers, window)
    base = jax.random.PRNGKey(5)
    init_key = jax.random.fold_in(base, 40961)
    jev = _events(jchaos, groups) if chaos else []
    tev = _events(tchaos, groups) if chaos else []
    jsched = jchaos.compile_schedule(64, jev) if chaos else None
    tsched = tchaos.compile_schedule(64, tev) if chaos else None
    oracle = LockstepRaftOracle(jcfg, base, init_key, events=jev)
    jtick = jax.jit(lambda rst, t, key, sched: jraft.tick(jcfg, rst, t, key,
                                                          sched))
    jst = jraft.init(jcfg, init_key)
    tst = traft.init(tcfg, convert.raft_draws_from(
        jraft.timeout_draws(jcfg, init_key, 0, groups)))
    _assert_raft_equal(tst, jst, "init")
    # Client intents: one batch on group 0, an overfill of the window on
    # the last group (its log fills; later winners have no room).
    bumps = {16: [(0, 3), (groups - 1, window + 4)], 52: [(0, 2)]}
    tot = {f: 0 for f in traft.FIELDS}
    full_wins = 0
    for t in range(80):
        for g, k in bumps.get(t, ()):
            oracle.bump(g, k)
            jst = jst._replace(next_seq=jst.next_seq.at[g].add(k))
            tst = tst._replace(next_seq=tst.next_seq + torch.tensor(
                [k if i == g else 0 for i in range(groups)], dtype=torch.int32))
        was_lead = tst.role == traft.ROLE_LEADER
        draws = convert.raft_draws_from(jraft.draw_table(jcfg, base, t))
        jst, jc = jtick(jst, t, jax.random.fold_in(base, t), jsched)
        tst, tc = traft.tick(tcfg, tst, t, draws, tsched)
        oracle.step(t)
        _assert_raft_equal(tst, jst, f"tick {t} vs reference")
        _assert_raft_equal(tst, oracle.snapshot(), f"tick {t} vs oracle")
        for f in traft.FIELDS:
            assert getattr(tc, f).dtype == torch.int32
            assert int(getattr(tc, f)) == int(getattr(jc, f)), (t, f)
            tot[f] += int(getattr(tc, f))
        new_lead = (tst.role == traft.ROLE_LEADER) & ~was_lead
        full = ((tst.last_index == window)
                & (tst.log_term[..., -1] < tst.term))
        full_wins += int((new_lead & full).sum())
    assert tot == oracle.cnt
    assert tot["elections_won"] >= groups and tot["commit_advances"] > 0
    if chaos:
        assert full_wins > 0, "no leader won with a full window"
        assert tot["elections_won"] > groups


# -- (b) chaos masks --------------------------------------------------------

def test_chaos_masks_match_reference():
    groups, peers = 3, 5
    jev = [jchaos.RaftKill(start=2, stop=9, group=1, peer=-1),
           jchaos.RaftKill(start=4, stop=6, group=-1, peer=3),
           jchaos.RaftPartition(start=3, stop=8, cut=2, group=-1),
           jchaos.RaftStorm(start=7, stop=10, group=2)]
    tev = [tchaos.RaftKill(start=2, stop=9, group=1, peer=-1),
           tchaos.RaftKill(start=4, stop=6, group=-1, peer=3),
           tchaos.RaftPartition(start=3, stop=8, cut=2, group=-1),
           tchaos.RaftStorm(start=7, stop=10, group=2)]
    tsched = tchaos.compile_schedule(16, tev)
    rng = np.random.default_rng(3)
    gids = np.arange(groups)
    for t in range(12):
        role = rng.integers(0, 3, (groups, peers)).astype(np.int32)
        want = jraft.chaos_masks_reference(jev, t, role, gids)
        twin = traft.chaos_masks_reference(tev, t, role, gids)
        got = traft.chaos_masks(tsched, t, torch.from_numpy(role),
                                torch.from_numpy(gids.astype(np.int32)))
        for w, tw, g in zip(want, twin, got):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"t={t}")
            np.testing.assert_array_equal(tw, w, err_msg=f"t={t}")
    alive, deliver = traft.chaos_masks(None, 0, torch.zeros(
        (groups, peers), dtype=torch.int32), torch.arange(groups))
    assert bool(alive.all()) and bool(deliver.all())


# -- (c) summary ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_matches_reference(seed):
    """Random states with several leaders and tied terms: the first
    maximum of the leader score, the committed client count."""
    r, p, w = 4, 5, 8
    rng = np.random.default_rng(seed)
    st = {f: np.zeros((r, p), np.int32) for f in (
        "voted_for", "leader", "timer", "hb", "last_index")}
    st.update(
        term=rng.integers(0, 3, (r, p)).astype(np.int32),
        role=rng.integers(0, 3, (r, p)).astype(np.int32),
        log_term=rng.integers(0, 4, (r, p, w)).astype(np.int32),
        log_client=rng.random((r, p, w)) < 0.5,
        commit=rng.integers(0, w + 1, (r, p)).astype(np.int32),
        match=np.zeros((r, p, p), np.int32),
        next_seq=np.zeros((r,), np.int32))
    st["role"][0] = traft.ROLE_FOLLOWER  # a group without a leader
    jst = jraft.RaftState(**{f: jax.numpy.asarray(v) for f, v in st.items()})
    want = jax.device_get(jraft.summary(jst))
    got = traft.summary(convert.raft_state_from(st))
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


# -- (d) Simulation + raft against the reference's ----------------------------

def test_simulation_with_raft_matches_reference():
    n, chunk = 48, 8
    jcfg_sim, tcfg_sim = tp.configs(n=n, view_degree=12)
    jr, tr = _rcfgs()
    jsim = JSimulation(jcfg_sim, seed=7, layout="packed")
    base = jsim.base_key
    draws = tp.make_draws_fn(jcfg_sim, chaos=True)
    tsim = tcluster.Simulation(
        tcfg_sim, seed=7, layout="packed", kernel="torch", device="cpu",
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
    events = (jchaos.RaftKill(start=18, stop=28, group=0, peer=-1),
              jchaos.RaftStorm(start=34, stop=40, group=-1))
    jsim.set_chaos(list(events))
    tsim.set_chaos([tchaos.RaftKill(18, 28, group=0, peer=-1),
                    tchaos.RaftStorm(34, 40, group=-1)])
    oracle = LockstepRaftOracle(jr, base, init_key, events=events)
    for i in range(6):
        if i == 1:  # proposals mid-trajectory, mirrored on every side
            for plane in (jplane, tplane):
                plane.propose([(0, 1, 5)], group=0)
                plane.propose([(0, 2, 6), (0, 3, 7)], group=1)
            oracle.bump(0, 1)
            oracle.bump(1, 2)
        jsim.run(chunk, chunk=chunk, with_metrics=False)
        tsim.run(chunk, chunk=chunk, with_metrics=False)
        oracle.run(range(i * chunk, (i + 1) * chunk))
        where = f"chunk {i}"
        _assert_raft_equal(tplane.state, jax.device_get(jplane.state), where)
        _assert_raft_equal(tplane.state, oracle.snapshot(), where)
        tp.assert_state_matches(
            tp.np_tree(jlayout.unpack_state(jsim.state)),
            tlayout.unpack(tsim.state), where)
        assert tsim.counters == {f: jsim.counters[f] for f in tsim.counters}
        assert tplane.counters_snapshot() == jplane.counters_snapshot()
    assert tplane.summary() == jplane.summary()
    assert tplane.summary()["committed_clients"] == [1, 2]
    assert tplane.inflight == 0


# -- (e) raft never moves the gossip trajectory -----------------------------

@pytest.mark.parametrize("cls", [tcluster.Simulation, tcluster.SerfSimulation],
                         ids=["swim", "serf"])
def test_arming_raft_leaves_the_gossip_trajectory(cls):
    cfg = TSimConfig(n=64, view_degree=16, packet_loss=0.01)
    events = [tchaos.RaftStorm(4, 12), tchaos.RaftKill(14, 20, peer=-1)]

    def make():
        sim = cls(cfg, seed=9, kernel="torch", device="cpu")
        sim.kill(np.arange(64) < 3)
        sim.set_chaos(events)
        return sim

    off, on = make(), make()
    plane = on.set_raft(2, peers=3, window=16, **ELECTION)
    for sim in (off, on):
        sim.run(24, chunk=8, with_metrics=False)
    assert plane.counters_snapshot()["elections_won"] > 0
    assert on.set_raft(None) is None and on.raft is None
    for sim in (off, on):
        sim.run(8, chunk=8, with_metrics=True)
    assert on.counters == off.counters
    for a, b in zip(tlayout.leaves(on.state), tlayout.leaves(off.state)):
        assert torch.equal(a, b)
    assert torch.equal(on.gen.get_state(), off.gen.get_state())


def test_raft_only_schedule_runs_the_chaos_tick():
    cfg = TSimConfig(n=64, view_degree=16)
    sim = tcluster.Simulation(cfg, seed=2, kernel="torch", device="cpu")
    sim.set_chaos([tchaos.RaftKill(2, 8)])
    assert sim.chaos is not None and sim.chaos.part_start.shape[0] == 0
    assert tuple(sim.draws(sim._t).u_pp.shape) == (cfg.n,)
    with pytest.raises(ValueError, match="CUDA device"):
        tcluster.Simulation(cfg, device="cpu", kernel="cuda").set_raft(2)


# -- (f) the write gate (reference tests/test_raft_device.py:260-306) --------

def _armed_stack(n=48, seed=7, groups=2, peers=3):
    sim = tcluster.Simulation(TSimConfig(n=n, view_degree=12), seed=seed,
                              kernel="torch", device="cpu")
    plane = ServingPlane(k=4, device="cpu")
    sim.attach_serving(plane, writes=True, kv_slots=64)
    rplane = sim.set_raft(groups, peers=peers, window=16, **ELECTION)
    return sim, plane, rplane


def _run_until(sim, pred, max_chunks=24, chunk=8):
    for _ in range(max_chunks):
        if pred():
            return True
        sim.run(chunk, chunk=chunk, with_metrics=False)
    return pred()


def test_write_applies_only_at_quorum_commit():
    sim, plane, rplane = _armed_stack()
    assert plane.raft_gate is rplane
    res = plane.kv_put("svc/leader", 42)
    assert res.status == "proposed" and not res.applied and res.index == -1
    assert rplane.inflight == 1
    base_index = plane.apply_index
    sim.publish_serving()  # nothing is committed before the first tick
    assert plane.apply_index == base_index and plane.kv_get("svc/leader") is None
    index_seen = [base_index]
    ok = _run_until(sim, lambda: index_seen.append(plane.apply_index)
                    or rplane.inflight == 0)
    assert ok, "proposal never quorum-committed"
    # The apply index moved once, at the pump that found the commit.
    assert plane.apply_index > base_index
    assert sorted(set(index_seen)) == [base_index, plane.apply_index]
    got = plane.kv_get("svc/leader")
    assert got is not None and got["Value"] == 42
    assert rplane.summary()["committed_clients"][0] == 1


def test_ticket_wait_returns_committed_results():
    sim, plane, rplane = _armed_stack()
    tk = rplane.propose([(2, 0, 7)])  # OP_KV_PUT slot 0
    done = []
    th = threading.Thread(
        target=lambda: done.append(tk.wait(timeout_s=30.0)))
    th.start()
    _run_until(sim, lambda: tk.done.is_set())
    th.join(timeout=30.0)
    assert not th.is_alive()
    # No batcher staged this ticket, so it commits without an apply: the
    # result carries the group's commit index, as the reference's does.
    assert done and all(r.applied and r.status == "committed" for r in done[0])
    assert done[0][0].index == rplane.summary()["commit"][0] > 0
    # Staged through the plane, the committed result is the apply's.
    assert plane.kv_put("k", 3).status == "proposed"
    tk = rplane._tickets[1][0]
    _run_until(sim, lambda: tk.done.is_set())
    assert [r.status for r in tk.wait(0)] == ["applied"]
    assert tk.results[0].index == plane.apply_index


# -- (g) the leader-kill drill (reference tests/test_raft_device.py:308-366) -

def test_leader_kill_drill_loses_no_acknowledged_write():
    sim, plane, rplane = _armed_stack(n=64, seed=5, groups=1, peers=5)
    sim.run(24, chunk=8, with_metrics=False)
    for i in range(6):
        assert plane.kv_put(f"drill/{i}", 100 + i).status == "proposed"
    assert _run_until(sim, lambda: rplane.inflight == 0)
    acked_index = plane.apply_index
    before = rplane.summary()
    assert before["leaders"][0] >= 0 and before["committed_clients"][0] == 6
    t0 = sim._t
    sim.set_chaos([tchaos.RaftKill(start=t0 + 2, stop=t0 + 20, group=0,
                                   peer=-1)])
    sim.run(48, chunk=8, with_metrics=False)
    sim.set_chaos(None)
    after = rplane.summary()
    # Re-elected within 48 ticks (two maximal election timeouts past the
    # kill window's start), at a higher term, nothing committed lost.
    assert after["leaders"][0] >= 0 and after["terms"][0] > before["terms"][0]
    assert after["committed_clients"][0] >= 6
    assert plane.apply_index >= acked_index
    for i in range(6):
        got = plane.kv_get(f"drill/{i}")
        assert got is not None and got["Value"] == 100 + i, i
    assert plane.kv_put("drill/post", 999).status == "proposed"
    assert _run_until(sim, lambda: rplane.inflight == 0)
    assert plane.kv_get("drill/post")["Value"] == 999


# -- (h) telemetry, (i) run_resilient's provenance ---------------------------

def test_raft_counters_reach_the_sink():
    sim, plane, rplane = _armed_stack()
    plane.kv_put("a", 1)
    sim.run(32, chunk=8, with_metrics=False)
    # The last pump flushed every chunk's counters; nothing is pending.
    assert not rplane._pending_vecs
    counts = rplane.counters_snapshot()
    assert counts["elections_won"] > 0 and counts["commit_advances"] > 0
    for f, name in traft.METRIC_NAMES.items():
        assert sim.sink.counter_sum(name) == counts[f], name
    assert sim.sink.gauge_value("consul.raft.commitIndex") == max(
        rplane.summary()["commit"])


@pytest.mark.parametrize("armed", [False, True], ids=["off", "on"])
def test_run_resilient_meta_carries_raft(tmp_path, monkeypatch, armed):
    sim = tcluster.Simulation(TSimConfig(n=48, view_degree=12), seed=3,
                              kernel="torch", device="cpu")
    if armed:
        sim.set_raft(2, peers=3, **ELECTION)
    pol = rt.CheckpointPolicy(directory=str(tmp_path), tag="raft",
                              min_interval_s=9999.0)
    real = tcluster.Simulation.run

    def run_and_sigterm(self, *a, **kw):
        out = real(self, *a, **kw)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(tcluster.Simulation, "run", run_and_sigterm)
    with pytest.raises(rt.Preempted):
        rt.run_resilient(sim, 64, chunk=32, policy=pol)
    meta = pol.read_meta()["raft"]
    if not armed:
        assert meta is None
        return
    s = sim.raft.summary()
    assert meta == {"groups": 2, "peers": 3, "terms": s["terms"],
                    "commit": s["commit"]}
    assert all(term > 0 for term in meta["terms"])
