"""PyTorch port vs the JAX reference: the resilient run harness
(``consul_tpu_torch/runtime``).

- ``CheckpointPolicy``: save / load / retire, the identity match, the
  interval, on-hang and on-signal triggers, counted save failures;
  ``SignalTrap`` traps SIGTERM and restores the previous handler.
- ``HeartbeatMonitor``: no beat is a backend-init hang, a beat then a
  stall a mid-run hang (one-shot, with the last completed state), live
  beats never fire; ``run_resilient(heartbeat_s=...)`` writes the hang's
  diagnostic checkpoint of the last completed chunk.
- ``run_resilient``: a run interrupted after a checkpoint (in process, by
  SIGTERM, and by kill -9 of a child process) and rerun ends bit-identical
  to an uninterrupted run, for SWIM, SWIM under a fault schedule and serf
  (and not when the draw generator's state is left out of the resume),
  also when the ``.meta.json`` sidecar is a save behind the checkpoint; a
  checkpoint from another schedule is not resumed; a checkpoint the
  reference wrote for the same trajectory is refused as a resume point
  with the reason; the sentinel writes its diagnostic checkpoint before
  raising; ``mesh=`` / ``elastic=`` raise.
"""

import logging
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from consul_tpu import runtime as jrt
from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch import runtime as rt
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.runtime import watchdog as wd
from consul_tpu_torch.utils import checkpoint as tck

import torch_parity  # noqa: F401  (one intra-op thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sim(n=128, seed=11, serf=False):
    cls = tcluster.SerfSimulation if serf else tcluster.Simulation
    return cls(TSimConfig(n=n, view_degree=16), seed=seed, kernel="torch",
               device="cpu")


def _events():
    return [tchaos.Partition(start=4, stop=12, side_a=slice(0, 40)),
            tchaos.ChurnWave(start=8, stop=16, nodes=slice(100, 108),
                             period=4, down_ticks=2)]


def _identical(a, b):
    pa, pb = tck.flatten(a), tck.flatten(b)
    return len(pa) == len(pb) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


class _CountingSink:
    def __init__(self):
        self.counters = {}

    def incr_counter(self, name, v=1):
        self.counters[name] = self.counters.get(name, 0) + v


# -- CheckpointPolicy and SignalTrap ------------------------------------

def test_policy_save_load_retire(tmp_path):
    sim = _sim(n=64)
    sim.run(8, chunk=8, with_metrics=False)
    pol = rt.CheckpointPolicy(directory=str(tmp_path), tag="t")
    pol.save(sim.state, {"a": 1, "ticks_done": 8})
    assert os.path.exists(pol.path) and os.path.exists(pol.meta_path)
    assert pol.read_meta()["a"] == 1
    assert tck.read_meta(pol.path)["ticks_done"] == 8
    tpl = _sim(n=64)
    assert pol.load(tpl.state, match={"a": 2}) == (None, None)
    state, meta = pol.load(tpl.state, match={"a": 1})
    assert meta["ticks_done"] == 8 and _identical(state, sim.state)
    pol.retire()
    assert not os.path.exists(pol.path)
    assert pol.load(tpl.state) == (None, None)


def test_policy_triggers(tmp_path):
    pol = rt.CheckpointPolicy(directory=str(tmp_path), tag="t",
                              min_interval_s=9999.0)
    assert not pol.due(10_000)
    pol.request()
    assert pol.due(0)
    pol._requested = False
    pol._last_save -= 10_000
    assert pol.due(0)
    pol2 = rt.CheckpointPolicy(directory=str(tmp_path), tag="u",
                               every_ticks=64, min_interval_s=0.0)
    assert not pol2.due(32) and pol2.due(64)
    pol3 = rt.CheckpointPolicy(directory=str(tmp_path), tag="v",
                               min_interval_s=9999.0, trap=rt.SignalTrap())
    with pol3.trap:
        assert not pol3.due(0)
        os.kill(os.getpid(), signal.SIGTERM)
        assert pol3.trap.fired == signal.SIGTERM and pol3.due(0)


def test_policy_counts_save_failures(tmp_path, caplog, monkeypatch):
    sink = _CountingSink()
    pol = rt.CheckpointPolicy(directory=str(tmp_path), tag="t", sink=sink)

    def boom(path, state, meta=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(tck, "save", boom)
    with caplog.at_level(logging.WARNING,
                         logger="consul_tpu_torch.runtime.policy"):
        assert pol.try_save(_sim(n=64).state, {}) is False
        assert pol.try_save(_sim(n=64).state, {}) is False
    assert pol.failures == 2 and isinstance(pol.first_error, OSError)
    assert sink.counters["sim.runtime.ckpt_failures"] == 2
    assert sum("checkpoint save failed" in r.message
               for r in caplog.records) == 1


def test_signal_trap_records_and_restores():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with rt.SignalTrap() as trap:
            os.kill(os.getpid(), signal.SIGTERM)
            assert trap.fired == signal.SIGTERM and not seen
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- HeartbeatMonitor ---------------------------------------------------

def _wait_status(mon):
    deadline = time.monotonic() + 5
    while mon.status is None and time.monotonic() < deadline:
        time.sleep(0.02)


def test_heartbeat_classification():
    sink, hangs = _CountingSink(), []
    mon = wd.HeartbeatMonitor(0.15, on_hang=lambda *a: hangs.append(a),
                              sink=sink, poll_s=0.03).start()
    try:
        _wait_status(mon)
    finally:
        mon.stop()
    assert mon.status == wd.INIT_HANG and hangs == [(wd.INIT_HANG, 0, None)]
    assert sink.counters["sim.runtime.backend_hangs"] == 1
    hangs.clear()
    with wd.HeartbeatMonitor(0.15, on_hang=lambda *a: hangs.append(a),
                             sink=sink, poll_s=0.03) as mon:
        mon.beat(16, {"chunk": 1})
        _wait_status(mon)
    assert mon.status == wd.MID_RUN_HANG
    assert hangs == [(wd.MID_RUN_HANG, 16, {"chunk": 1})]
    assert sink.counters["sim.runtime.mid_run_hangs"] == 1
    with wd.HeartbeatMonitor(1.0, poll_s=0.02) as mon:
        for i in range(5):
            time.sleep(0.04)
            mon.beat(i + 1)
    assert mon.status is None and mon.beats == 5


def test_mid_run_hang_dumps_last_completed_chunk(tmp_path):
    sim = _sim()
    real = sim.run
    calls = {"n": 0}
    dump = rt.hang_dump_path(str(tmp_path), 16)

    def run(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the wedged chunk: it waits for the dump
            deadline = time.monotonic() + 60
            while not os.path.exists(dump) and time.monotonic() < deadline:
                time.sleep(0.05)
        return real(*a, **kw)

    sim.run = run
    after_first = {}
    orig_beat = wd.HeartbeatMonitor.beat

    def beat(self, done, state=None):
        after_first.setdefault("state", state[0])
        return orig_beat(self, done, state)

    wd.HeartbeatMonitor.beat = beat
    try:
        rep = rt.run_resilient(sim, 32, chunk=16, heartbeat_s=2.0,
                               hang_dump_dir=str(tmp_path))
    finally:
        wd.HeartbeatMonitor.beat = orig_beat
    assert rep.hang_status == wd.MID_RUN_HANG and rep.ticks_done == 32
    assert rep.hang_checkpoint == dump
    meta = tck.read_meta(dump)
    assert meta["classification"] == wd.MID_RUN_HANG
    assert meta["ticks_done"] == 16
    back = tck.restore(dump, sim.state)
    assert _identical(back, after_first["state"])
    assert sim.sink.counter_sum("sim.runtime.mid_run_hangs") == 1


# -- run_resilient: resume bit-identity ----------------------------------

class _Killed(BaseException):
    pass


def _interrupt_after_first_save(monkeypatch):
    orig = rt.CheckpointPolicy.try_save

    def wrapper(self, state, meta):
        ok = orig(self, state, meta)
        raise _Killed()

    monkeypatch.setattr(rt.CheckpointPolicy, "try_save", wrapper)


def _policy(tmp_path, tag="bi"):
    return rt.CheckpointPolicy(directory=str(tmp_path), tag=tag,
                               every_ticks=16, min_interval_s=0.0)


@pytest.mark.parametrize("case", ["swim", "chaos", "serf"])
def test_resume_bit_identical(tmp_path, monkeypatch, case):
    serf, events = case == "serf", (_events() if case == "chaos" else None)
    ref = _sim(serf=serf)
    full = rt.run_resilient(ref, 48, chunk=16, events=events)
    _interrupt_after_first_save(monkeypatch)
    with pytest.raises(_Killed):
        rt.run_resilient(_sim(serf=serf), 48, chunk=16, events=events,
                         policy=_policy(tmp_path / "a"))
    monkeypatch.undo()
    meta = tck.read_meta(_policy(tmp_path / "a").path)
    assert meta["ticks_done"] == 16 and "generator" in meta
    # The generator's state carries the draw stream across: a resume that
    # leaves it out draws the first ticks' numbers again and ends elsewhere.
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    load = tcluster.Simulation.load_state
    monkeypatch.setattr(tcluster.Simulation, "load_state",
                        lambda self, state, generator=None: load(self, state))
    blind = _sim(serf=serf)
    assert rt.run_resilient(blind, 48, chunk=16, events=events,
                            policy=_policy(tmp_path / "b")).resumed_from_tick == 16
    monkeypatch.undo()
    assert not _identical(ref.state, blind.state)

    sim2 = _sim(serf=serf)
    rep = rt.run_resilient(sim2, 48, chunk=16, events=events,
                           policy=_policy(tmp_path / "a"))
    assert rep.resumed_from_tick == 16 and rep.ticks_done == 48
    assert _identical(ref.state, sim2.state) and sim2._t == ref._t
    assert not os.path.exists(_policy(tmp_path / "a").path)
    assert (rep.slo is None) == (events is None)
    if events is not None:
        assert full.slo["fault_ticks"] > 0


def test_resume_reads_the_manifest_not_a_stale_sidecar(tmp_path, monkeypatch):
    # A kill between a save's rename and its sidecar write leaves the
    # sidecar one save behind the leaves: the resume must take its
    # provenance (ticks done, the generator's state) from the manifest.
    ref = _sim()
    rt.run_resilient(ref, 48, chunk=16)
    pol = _policy(tmp_path)
    _interrupt_after_first_save(monkeypatch)
    with pytest.raises(_Killed):
        rt.run_resilient(_sim(), 48, chunk=16, policy=pol)
    stale = tmp_path / "stale.meta.json"
    shutil.copy(pol.meta_path, stale)
    with pytest.raises(_Killed):
        rt.run_resilient(_sim(), 48, chunk=16, policy=_policy(tmp_path))
    monkeypatch.undo()
    assert tck.read_meta(pol.path)["ticks_done"] == 32
    shutil.copy(stale, pol.meta_path)
    sim = _sim()
    rep = rt.run_resilient(sim, 48, chunk=16, policy=_policy(tmp_path))
    assert rep.resumed_from_tick == 32 and rep.ticks_done == 48
    assert _identical(ref.state, sim.state) and sim._t == ref._t


def test_sigterm_saves_and_raises_then_resumes(tmp_path, monkeypatch):
    sim = _sim()
    pol = rt.CheckpointPolicy(directory=str(tmp_path), tag="pre",
                              min_interval_s=9999.0)
    real = tcluster.Simulation.run
    fired = {"done": False}

    def run_and_sigterm(self, *a, **kw):
        out = real(self, *a, **kw)
        if not fired["done"]:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(tcluster.Simulation, "run", run_and_sigterm)
    with pytest.raises(rt.Preempted) as ei:
        rt.run_resilient(sim, 64, chunk=16, policy=pol)
    monkeypatch.undo()
    assert ei.value.report.preempted and ei.value.report.ticks_done == 16
    assert pol.read_meta()["ticks_done"] == 16
    sim2 = _sim()
    rep = rt.run_resilient(sim2, 64, chunk=16, policy=rt.CheckpointPolicy(
        directory=str(tmp_path), tag="pre", min_interval_s=9999.0))
    assert rep.resumed_from_tick == 16 and rep.ticks_done == 64
    ref = _sim()
    rt.run_resilient(ref, 64, chunk=16)
    assert _identical(ref.state, sim2.state)


def test_schedule_digest_gates_resume(tmp_path, monkeypatch):
    _interrupt_after_first_save(monkeypatch)
    with pytest.raises(_Killed):
        rt.run_resilient(_sim(), 48, chunk=16, events=_events(),
                         policy=_policy(tmp_path, "dg"))
    monkeypatch.undo()
    other = [tchaos.Partition(start=2, stop=20, side_a=slice(0, 64))]
    rep = rt.run_resilient(_sim(), 48, chunk=16, events=other,
                           policy=rt.CheckpointPolicy(
                               directory=str(tmp_path), tag="dg",
                               every_ticks=1 << 30, min_interval_s=9999.0))
    assert rep.resumed_from_tick == 0 and rep.ticks_done == 48


def test_reference_checkpoint_refused_as_resume(tmp_path, monkeypatch):
    jsim = JSimulation(JSimConfig(n=128, view_degree=16), seed=11)
    jpol = jrt.CheckpointPolicy(directory=str(tmp_path), tag="ref",
                                every_ticks=16, min_interval_s=0.0)
    orig = jrt.CheckpointPolicy.try_save

    def save_then_stop(self, state, meta):
        orig(self, state, meta)
        raise _Killed()

    monkeypatch.setattr(jrt.CheckpointPolicy, "try_save", save_then_stop)
    with pytest.raises(_Killed):
        jrt.run_resilient(jsim, 48, chunk=16, policy=jpol)
    monkeypatch.undo()
    sim = _sim()
    with pytest.raises(RuntimeError, match="no draw generator state"):
        rt.run_resilient(sim, 48, chunk=16, policy=rt.CheckpointPolicy(
            directory=str(tmp_path), tag="ref", min_interval_s=9999.0))
    # As a state it still restores, through convert.py.
    assert tck.read_meta(jpol.path)["ticks_done"] == 16
    back = convert.sim_state_from(tck.restore_tree(jpol.path))
    assert int(back.t) == 16 and back.view_key.dtype == torch.int64


def test_sentinel_dump_before_raising(tmp_path):
    sim = _sim()
    sim.run(8, chunk=8, with_metrics=False)
    vec = sim.state.viv.vec.clone()
    vec[50] = float("nan")
    sim.state = sim.state._replace(viv=sim.state.viv._replace(vec=vec))
    bad = sim.state
    with pytest.raises(rt.SentinelViolation) as ei:
        rt.run_resilient(sim, 16, chunk=8, sentinel=True,
                         sentinel_dump_dir=str(tmp_path / "diag"))
    err = ei.value
    assert err.dump_path == rt.diagnostic_dump_path(str(tmp_path / "diag"), 16)
    assert err.dump_path in str(err) and os.path.exists(err.dump_path)
    meta = tck.read_meta(err.dump_path)
    assert meta["reason"] == "sentinel" and meta["mask"] == err.mask
    assert meta["deltas"]["sentinel_nonfinite_coord"] > 0
    dumped = tck.restore(err.dump_path, bad)
    assert int(dumped.t) == 16 and _identical(dumped, sim.state)
    assert int(dumped.viv.resets[50]) > int(bad.viv.resets[50])
    assert sim.sink.counter_sum("sim.sentinel.trips") == 1


def test_mesh_and_elastic_raise():
    for kw in ({"mesh": object()}, {"elastic": True}):
        with pytest.raises(NotImplementedError, match="A13"):
            rt.run_resilient(_sim(n=64), 8, **kw)


# -- kill -9 of a child process ---------------------------------------------

_CHILD = textwrap.dedent("""
    import sys, time, torch
    sys.path.insert(0, {repo!r})
    torch.set_num_threads(1)
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models.cluster import Simulation
    from consul_tpu_torch import runtime as rt
    from consul_tpu_torch.utils import checkpoint

    class Policy(rt.CheckpointPolicy):
        def save(self, state, meta):
            out = super().save(state, meta)
            print("SAVED", meta["ticks_done"], flush=True)
            if {hang}:
                time.sleep(600)  # killed here, with a checkpoint on disk
            return out

    sim = Simulation(SimConfig(n=256, view_degree=16), seed=5,
                     kernel="torch", device="cpu")
    pol = Policy(directory={ck!r}, tag="k9", every_ticks=16,
                 min_interval_s=0.0)
    rep = rt.run_resilient(sim, 64, chunk=16, policy=pol)
    checkpoint.save({end!r}, sim.state)
    print("DONE", rep.resumed_from_tick, flush=True)
""")


def test_kill9_then_rerun_is_bit_identical(tmp_path):
    ck, end = str(tmp_path / "ck"), str(tmp_path / "end.ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO, ck=ck, end=end,
                                             hang=True)],
        stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert line.startswith("SAVED 16"), line
    assert proc.returncode == -signal.SIGKILL
    assert os.path.exists(os.path.join(ck, "k9.ckpt"))
    rerun = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=REPO, ck=ck, end=end,
                                             hang=False)],
        capture_output=True, text=True, timeout=300)
    assert rerun.returncode == 0, rerun.stderr[-2000:]
    assert rerun.stdout.strip().splitlines()[-1] == "DONE 16"
    assert not os.path.exists(os.path.join(ck, "k9.ckpt"))
    ref = tcluster.Simulation(TSimConfig(n=256, view_degree=16), seed=5,
                              kernel="torch", device="cpu")
    rt.run_resilient(ref, 64, chunk=16)
    assert _identical(tck.restore(end, ref.state), ref.state)
