"""The port's compile and launch hygiene (ROADMAP A20): the prewarm
(``utils/prewarm.py``), the kernels' build directory
(``utils/compile_cache.py``), the run-time guards (``analysis/guards.py``)
and ``runtime/watchdog.with_failover``, on the CPU:

- a prewarmed simulation (``prewarm_simulation``, with and without
  metrics, under a schedule, the lens and raft armed) runs bit-equal to
  a cold one: state, counters, generators, the sink's counters, the lens
  recording and ``cuda_gossip.LAUNCHES``; ``prewarm`` returns the
  reference's summary keys, one signature each;
- ``compile_cache`` takes its directory from ``enable`` or
  ``CONSUL_TPU_COMPILE_CACHE`` and counts hits and misses;
  ``CompileLedger.expect`` pins the build count;
- ``with_failover`` keeps the reference's retries and failover between
  cards, and raises where it would fail over to the CPU.
"""

import os

import pytest
import torch

from consul_tpu_torch import chaos
from consul_tpu_torch.analysis import guards
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import cluster, layout
from consul_tpu_torch.ops import cuda_gossip
from consul_tpu_torch.runtime import watchdog
from consul_tpu_torch.utils import compile_cache, prewarm

CPU = dict(device="cpu", kernel="torch")


def _bits(x):
    return x.reshape(-1).contiguous().view(torch.uint8)


def _run(cls, warm):
    sim = cls(SimConfig(n=128, view_degree=8, packet_loss=0.01), seed=4,
              **CPU)
    sim.set_lens(4)
    sim.set_raft(2, peers=3)
    if cls is not cluster.Simulation:
        sim.user_event(torch.arange(128) == 7, 5)
    sim.set_chaos([chaos.Partition(start=2, stop=10, side_a=slice(0, 40))])
    if warm:
        for with_metrics in (False, True):
            prewarm.prewarm_simulation(sim, 16, with_metrics)
    launches = dict(cuda_gossip.LAUNCHES)
    sim.run(32, chunk=16, with_metrics=True)
    sim.run(16, chunk=16, with_metrics=False)
    return sim, launches


@pytest.mark.parametrize("cls", [cluster.Simulation, cluster.SerfSimulation,
                                 cluster.ReferenceSerfSimulation],
                         ids=["swim", "serf", "reference"])
def test_prewarm_leaves_the_trajectory_bit_equal(cls):
    before = dict(cuda_gossip.LAUNCHES)
    cold, _ = _run(cls, False)
    warm, at_run = _run(cls, True)
    assert at_run == before
    for a, b in zip(layout.leaves(cold.state), layout.leaves(warm.state)):
        assert torch.equal(_bits(a), _bits(b))
    assert cold.counters == warm.counters
    assert cold.chunk_counters == warm.chunk_counters
    assert cold.generator_state() == warm.generator_state()
    assert cold._chunk_seq == warm._chunk_seq
    assert cold.raft.counters_snapshot() == warm.raft.counters_snapshot()
    (ta, va), (tb, vb) = cold.lens.timelines(), warm.lens.timelines()
    assert (ta == tb).all() and va.tobytes() == vb.tobytes()
    sa, sb = cold.sink.snapshot(), warm.sink.snapshot()
    assert sa["Counters"] == sb["Counters"]
    assert [x["Name"] for x in sa["Samples"]] == [x["Name"] for x in sb["Samples"]]


def test_prewarm_summary():
    out = prewarm.prewarm([64, 128], kinds=("swim", "serf_reference"),
                          chunks=(8,), chaos=True, sweep=2, view_degree=8,
                          **CPU)
    assert set(out) == {"signatures", "compiled", "cache", "wall_s"}
    # 2 n x 2 kinds x (2 schedules x 2 metrics modes + 1 sweep lane).
    assert out["compiled"] == len(out["signatures"]) == 20
    assert {s["kind"] for s in out["signatures"]} == {"swim",
                                                      "serf_reference"}
    assert out["cache"]["misses"] == 0
    with pytest.raises(ValueError, match="unknown kind"):
        prewarm.prewarm([64], kinds=("raft",), **CPU)


def test_compile_cache_directory_and_counts(tmp_path, monkeypatch):
    saved = dict(compile_cache._state)
    try:
        assert compile_cache.build_dir() == (saved["dir"]
                                             or compile_cache.DEFAULT_DIR)
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
        path = compile_cache.maybe_enable_from_env()
        assert path == str(tmp_path / "cc") and os.path.isdir(path)
        assert compile_cache.build_dir() == path
        assert compile_cache.maybe_enable_from_env({}) is None
        before = compile_cache.stats()
        compile_cache.record(hit=True)
        compile_cache.record(hit=False)
        assert compile_cache.stats_delta(before) == {
            "enabled": True, "dir": path, "hits": 1, "misses": 1}
        led = guards.CompileLedger()
        with led.expect(1, "one build"):
            compile_cache.record(hit=False)
        with pytest.raises(guards.CompileLedgerError, match="expected exactly 0"):
            with led.expect(0):
                compile_cache.record(hit=False)
    finally:
        compile_cache._state.clear()
        compile_cache._state.update(saved)


def test_no_transfers_is_scoped():
    with guards.no_transfers():
        x = torch.ones(3).sum().item()
    assert x == 3.0
    if torch.cuda.is_available():
        before = torch.cuda.get_sync_debug_mode()
        with pytest.raises(RuntimeError):
            with guards.no_transfers():
                torch.ones(3, device="cuda").sum().item()
        assert torch.cuda.get_sync_debug_mode() == before


def _attempts(script):
    calls = []

    def attempt(plat):
        calls.append(plat)
        return {"status": script[len(calls) - 1], "wall_s": 1.0}
    return attempt, calls


def test_with_failover_retries_and_refuses_the_cpu():
    hang, ok = watchdog.INIT_HANG, watchdog.OK
    attempt, calls = _attempts([hang, ok])
    result, prov = watchdog.with_failover(attempt, ["cuda:0", "cpu"])
    assert result["status"] == ok and calls == ["cuda:0", "cuda:0"]
    assert prov["platform"] == "cuda:0" and prov["retries"] == 1
    attempt, calls = _attempts([hang, hang, ok])
    result, prov = watchdog.with_failover(attempt, ["cuda:0", "cuda:1"])
    assert prov["platform"] == "cuda:1" and prov["degraded_from"] == "cuda:0"
    attempt, calls = _attempts([hang, hang, ok])
    with pytest.raises(watchdog.FailoverRefused, match="CPU"):
        watchdog.with_failover(attempt, ["cuda", "cpu"])
    assert calls == ["cuda", "cuda"]
    attempt, _ = _attempts([ok])
    assert watchdog.with_failover(attempt, ["cpu"])[1]["platform"] == "cpu"
