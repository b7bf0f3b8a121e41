"""PyTorch port vs the JAX reference: the game day (``gameday/``).

- ``slo.evaluate`` equals the reference's on a table of measured dicts;
  ``_composed_events`` and ``GamedayConfig.resolved_window`` equal the
  reference's.
- Trajectory parity: ``run_gameday`` at the reference's tiny shape
  (tests/test_gameday.py:22-29) with both DCN islands, the port's
  ``Simulation`` started from the reference's world, topology and state
  and fed its key ladder and raft draw tables (the harness's
  ``_simulation`` patched, as ``torch_parity.ladder_draws`` stands in
  elsewhere): the verdict has the reference's keys and passes, and its
  deterministic fields (``lost_writes``, ``max_time_to_heal_ticks``, the
  acked ledger, the six chaos counters, the raft summary, the apply index,
  flips and deliveries, the DCN report) equal the reference's. Latencies,
  shed counts and wall times are checked for the contract only.
- On the port alone: the threaded and the async front end (with a
  two-process HTTP swarm) pass with ``lost_writes`` 0 and one owned thread
  on the async side; a trap at a phase boundary then a resume gives the
  same deterministic fields as an uninterrupted run, and retires the
  manifest; a manifest of another shape starts fresh; the swarm's import
  chain holds no ``torch``; the port's goldens are re-measured within
  their tolerances.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import pytest

from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.gameday import harness as jharness
from consul_tpu.gameday import slo as jslo
from consul_tpu.models import raft as jraft_mod
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.ops import raft_ops as jraft
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.gameday import (PHASES, GamedayConfig, load_goldens,
                                      run_gameday)
from consul_tpu_torch.gameday import harness as tharness
from consul_tpu_torch.gameday import slo as tslo
from consul_tpu_torch.gameday.goldens import (measure_raft_commit,
                                              measure_topology)
from consul_tpu_torch.models import cluster as tcluster

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", kernel="torch")
# The verdict fields that follow from the trajectory alone.
DETERMINISTIC = ("lost_writes", "max_time_to_heal_ticks", "ledger", "chaos",
                 "drained", "phases", "watchers", "watch_delivery_lag")


def _tiny_kw(**kw):
    base = dict(n=128, view_degree=8, watchers=32, watch_queue=8,
                kv_slots=256, read_batch=64, warmup_ticks=32,
                ticks_per_round=16, steady_rounds=1, fault_rounds=2,
                heal_rounds=1, drain_rounds=2, dcn_islands=0)
    base.update(kw)
    return base


def _tiny(**kw):
    return GamedayConfig(**_tiny_kw(**CPU, **kw))


class _TrapAfter:
    """A SignalTrap stand-in that fires once a named phase completes."""

    def __init__(self, phase: str):
        self.fired = None
        self._phase = phase

    def note(self, rec: dict) -> None:
        if rec.get("gameday") == self._phase:
            self.fired = 15


MEASURED = [
    {"p99_read_ms": 1.0, "p99_write_ms": 2.0, "p99_watch_ms": 3.0,
     "lost_writes": 0, "max_time_to_heal_ticks": 100,
     "watch_delivery_lag": 0, "shed": 5, "rejected": 0},
    {"p99_read_ms": 1.0, "p99_write_ms": 1.0, "p99_watch_ms": 1.0,
     "lost_writes": 1, "max_time_to_heal_ticks": 10,
     "watch_delivery_lag": 0, "shed": 0, "rejected": 0},
    {"p99_read_ms": 1.0, "p99_write_ms": 1.0, "p99_watch_ms": 1.0,
     "max_time_to_heal_ticks": 10, "watch_delivery_lag": 0, "shed": 0,
     "rejected": 0},
    {"p99_read_ms": 1.0, "p99_write_ms": 1.0, "p99_watch_ms": 1.0,
     "lost_writes": None, "max_time_to_heal_ticks": 10,
     "watch_delivery_lag": 0, "shed": 0, "rejected": 0},
    {"p99_read_ms": 2500.0, "p99_write_ms": 1.0, "p99_watch_ms": 4100.0,
     "lost_writes": 0, "max_time_to_heal_ticks": 5000,
     "watch_delivery_lag": 3, "shed": 10 ** 6, "rejected": 10 ** 6},
]


@pytest.mark.parametrize("i", range(len(MEASURED)))
@pytest.mark.parametrize("th", [None, dict(max_shed=0), dict(
    max_rejected=5, max_time_to_heal_ticks=10, p99_read_ms=None)],
    ids=["default", "shed0", "mixed"])
def test_evaluate_equals_reference(i, th):
    jt = None if th is None else jslo.SloThresholds(**th)
    tt = None if th is None else tslo.SloThresholds(**th)
    assert tslo.evaluate(MEASURED[i], tt) == jslo.evaluate(MEASURED[i], jt)


def _entry(e):
    return type(e).__name__, dataclasses.astuple(e)


@pytest.mark.parametrize("kw", [
    {}, dict(n=128, partition_frac=0.5, churn_frac=0.1),
    dict(n=1_048_576, view_degree=32), dict(ratio="80:19:1", raft_groups=2),
    dict(raft_window=100), dict(steady_rounds=40, fault_rounds=30,
                                heal_rounds=30, read_batch=1024)])
def test_composed_events_and_window_equal_reference(kw):
    jc, tc = jharness.GamedayConfig(**kw), GamedayConfig(**kw)
    assert tc.resolved_window() == jc.resolved_window()
    assert tc.ident() == jc.ident()
    for window in (8, 64, 192):
        assert [_entry(e) for e in tharness._composed_events(tc, window)] == [
            _entry(e) for e in jharness._composed_events(jc, window)]


def _ladder_simulation(cfg):
    """The port's Simulation for the game day, started from the reference
    harness's own simulation (same config and seed) and fed its key ladder
    and raft draw tables."""
    jcfg = JSimConfig(n=cfg.n, view_degree=cfg.view_degree)
    jsim = JSimulation(jcfg, seed=cfg.seed)
    base = jsim.base_key
    init_key = jraft_mod.init_key_of(jsim)
    draws_fn = tp.make_draws_fn(jcfg, chaos=True)
    holder = {}

    class LadderSimulation(tcluster.Simulation):
        def set_raft(self, groups=None, draws=None, timers=None, **kw):
            if groups is None:
                return super().set_raft(None)
            jr = JRaftConfig(**dataclasses.asdict(groups))
            return super().set_raft(
                groups,
                draws=lambda t: convert.raft_draws_from(
                    jraft.draw_table(jr, base, t)),
                timers=convert.raft_draws_from(
                    jraft.timeout_draws(jr, init_key, 0, jr.groups)))

    def draws(t):
        d = draws_fn(jax.random.fold_in(base, t))
        return tp.to_tick_draws(d, chaos=holder["sim"].chaos is not None)

    sim = LadderSimulation(
        TSimConfig(n=cfg.n, view_degree=cfg.view_degree), seed=cfg.seed,
        layout="dense", kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.sim_state_from(tp.np_tree(jsim.state)), draws=draws)
    holder["sim"] = sim
    return sim


def test_trajectory_matches_reference(monkeypatch):
    """The port's game day, DCN leg included, on the reference's draws.
    The reference runs without its DCN leg here: that leg is its own
    federation, independent of the main trajectory, and
    :func:`test_dcn_leg_matches_reference` holds its report, so the two
    reference compiles can run on two workers."""
    kw = _tiny_kw(dcn_islands=2)
    ref = jharness.run_gameday(jharness.GamedayConfig(**dict(
        kw, dcn_islands=0)))
    monkeypatch.setattr(tharness, "_simulation", _ladder_simulation)
    got = run_gameday(GamedayConfig(**kw, **CPU))
    assert set(got) == set(ref)
    assert got["pass"] is True, got["violations"]
    assert ref["pass"] is True, ref["violations"]
    for f in DETERMINISTIC + ("raft", "apply_index", "flips", "deliveries",
                              "frontend", "frontend_threads", "n"):
        assert got[f] == ref[f], (f, got[f], ref[f])
    assert got["lost_writes"] == 0
    assert got["ledger"]["acked"] == got["ledger"]["written"] > 0
    assert got["chaos"]["messages_dropped"] > 0
    assert got["dcn"]["converged"] and got["dcn"]["heals"] > 0
    assert sum(got["raft"]["committed_clients"]) >= got["ledger"]["acked"]
    for f in ("p99_read_ms", "p99_write_ms", "p99_watch_ms"):
        assert got[f] is not None and got[f] >= 0.0


def test_dcn_leg_matches_reference():
    """The game day's DCN leg (two islands, the reference's link faults):
    the report equals the reference's."""
    kw = _tiny_kw(dcn_islands=2)
    ref = jharness._dcn_leg(jharness.GamedayConfig(**kw))
    got = tharness._dcn_leg(GamedayConfig(**kw, **CPU))
    assert got == ref
    assert got["converged"] and got["heals"] > 0 and got["retries"] > 0


@pytest.fixture(scope="module")
def threaded_tiny():
    """One threaded run at the ``_tiny`` shape, shared by the tests that
    hold a verdict to it."""
    return run_gameday(_tiny())


def test_front_ends_pass_the_gate(threaded_tiny):
    vt = threaded_tiny
    va = run_gameday(_tiny(frontend="async", swarm_procs=2, swarm_requests=16))
    for v in (vt, va):
        assert v["pass"] is True, v["violations"]
        assert v["phases"] == list(PHASES) and v["drained"] is True
        assert v["lost_writes"] == 0 and v["watch_delivery_lag"] == 0
        assert v["ledger"]["acked"] == v["ledger"]["written"] > 0
        assert v["flips"] > 0 and v["deliveries"] > 0 and v["watchers"] >= 32
    assert (vt["frontend"], vt["frontend_threads"]) == ("threaded", 0)
    assert (va["frontend"], va["frontend_threads"]) == ("async", 1)
    assert va["ledger"]["written"] == vt["ledger"]["written"]
    sw = va["swarm"]
    assert sw["procs"] == 2 and sw["requests"] == 32 and sw["failed"] == 0
    assert sw["blocking"] > 0
    # The async run's schedule and gossip are the threaded run's.
    assert va["chaos"] == vt["chaos"]


def test_resume_at_a_boundary_equals_uninterrupted(tmp_path, threaded_tiny):
    whole = threaded_tiny
    rd = str(tmp_path / "gd")
    trap = _TrapAfter("steady")
    v1 = run_gameday(_tiny(resume_dir=rd), trap=trap, emit=trap.note)
    assert v1["preempted"] is True and v1["pass"] is False
    assert v1["phases"] == ["warmup", "steady"]
    assert any("preempted" in s for s in v1["violations"])
    manifest = os.path.join(rd, "gameday_manifest.json")
    assert os.path.exists(manifest)
    v2 = run_gameday(_tiny(resume_dir=rd))
    assert v2["pass"] is True, v2["violations"]
    for f in DETERMINISTIC:
        assert v2[f] == whole[f], (f, v2[f], whole[f])
    assert not os.path.exists(manifest)
    # A manifest saved under another shape is not resumed.
    trap = _TrapAfter("warmup")
    run_gameday(_tiny(resume_dir=rd), trap=trap, emit=trap.note)
    assert os.path.exists(manifest)
    v3 = run_gameday(_tiny(n=64, watchers=8, resume_dir=rd))
    assert v3["phases"] == list(PHASES) and v3["pass"] is True


def test_swarm_imports_no_torch():
    code = ("import sys; import consul_tpu_torch.gameday.swarm as s; "
            "import consul_tpu_torch.gameday as g; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "assert g.PHASES[0] == 'warmup'")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    out = subprocess.run([sys.executable, "-m", "consul_tpu_torch.gameday.swarm"],
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "usage" in out.stdout


def test_goldens_within_tolerance():
    # The stored points are CPU trajectories: re-measure them on the CPU.
    cpu = {"device": "cpu", "kernel": "torch"}
    g = load_goldens()
    t = g["topology"]
    m = measure_topology(**cpu, **{k: t[k] for k in ("n", "degree", "scenarios",
                                                     "settle", "chunk", "seed")})
    assert m["time_to_heal"] <= t["max_time_to_heal"]
    assert m["false_positive_deaths"] <= t["max_false_positive_deaths"]
    assert m["time_to_first_suspect"] <= t["max_time_to_first_suspect"]
    assert m["time_to_heal"] >= 0
    r = g["raft"]
    m = measure_raft_commit(**cpu, **{k: r[k] for k in ("n", "groups", "peers",
                                                        "window", "probes",
                                                        "rchunk", "seed")})
    assert m["all_committed"]
    assert m["commit_ticks_p99"] <= r["max_commit_ticks_p99"]
    assert os.path.dirname(tslo.GOLDENS_PATH).endswith(
        os.path.join("consul_tpu_torch", "gameday"))
