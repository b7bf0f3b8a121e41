"""PyTorch port vs the JAX reference: the driver end to end, and the
port's package rules.

- ``Simulation`` at n = 512, K = 16, packed layout, plain PyTorch tick
  on the CPU, started from the reference simulation's world, topology and
  state and fed the reference's per-tick key ladder: after a 5 % kill it
  converges on the same tick as the reference's packed ``Simulation``,
  with equal per-chunk counters and equal per-tick agreement (exact: the
  discrete plane). The suspicion timeouts are cut (``suspicion_mult=2``,
  ``suspicion_max_timeout_mult=2``) so the run converges in ~200 ticks.
- metrics never move the trajectory (fault C1): ``Simulation`` and
  ``SerfSimulation`` stepped from one seed through ``run`` or
  ``run_scenario`` with ``with_metrics`` on and off end with equal packed
  leaves and counters, and a tick's RMSE pairs do not depend on chunking
  or on whether earlier ticks had metrics.
- ``kernel="cuda"`` raises without a CUDA device and with the dense
  layout.
- No module of ``consul_tpu_torch`` (its ``chaos``, ``obs``, ``runtime``,
  ``server``, ``serving`` and ``wire`` subpackages included) and no line
  of ``chip_smoke.py`` imports ``jax`` or ``consul_tpu``; none imports
  ``msgpack``, and ``cryptography`` only in ``wire/keyring.py``'s guarded
  import.
"""

import ast
import os

import jax
import numpy as np
import pytest

import torch

from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch.config import GossipConfig as TGossipConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models.cluster import SerfSimulation as TSerfSimulation
from consul_tpu_torch.models.cluster import Simulation as TSimulation

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16
N = 512
GOSSIP = dict(suspicion_mult=2, suspicion_max_timeout_mult=2)


def test_simulation_converges_on_the_reference_tick():
    jcfg, tcfg = tp.configs(n=N, view_degree=16, gossip=GOSSIP)
    jsim = JSimulation(jcfg, seed=5, layout="packed")
    draws = tp.make_draws_fn(jcfg)
    base = jsim.base_key
    tsim = TSimulation(
        tcfg, seed=5, layout="packed", kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.packed_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_tick_draws(draws(jax.random.fold_in(base, t))))

    jtr = jsim.run(CHUNK, chunk=CHUNK)
    ttr = tsim.run(CHUNK, chunk=CHUNK)
    np.testing.assert_array_equal(ttr.agreement.numpy(), np.asarray(jtr.agreement))
    assert tsim.counters == {f: jsim.counters[f] for f in tsim.counters}
    mask = np.zeros(N, bool)
    mask[:N // 20] = True
    jsim.kill(mask)
    tsim.kill(mask)

    # The reference, chunk by chunk, with run_until_converged's rule.
    j_chunks, j_agree, used, converged = [], [], 0, False
    while used < 1024 and not converged:
        before = dict(jsim.counters)
        tr = jsim.run(CHUNK, chunk=CHUNK)
        j_chunks.append({f: jsim.counters[f] - before[f] for f in before})
        j_agree.append(np.asarray(tr.agreement))
        used += CHUNK
        converged = float(tr.agreement[-1]) >= 1.0
    assert converged

    first = len(tsim.chunk_counters)
    ok, t_used, trace = tsim.run_until_converged(max_ticks=1024, chunk=CHUNK)
    assert (ok, t_used) == (converged, used)
    np.testing.assert_array_equal(trace.agreement.numpy(), j_agree[-1])
    got = [{f: c[f] for f in j_chunks[0]} for c in tsim.chunk_counters[first:]]
    assert got == j_chunks
    assert sum(c["deaths_declared"] for c in got) > 0
    assert float(tsim.health().agreement) == 1.0
    assert np.isfinite(tsim.rmse())


@pytest.mark.parametrize("verb", ["run", "run_scenario"])
@pytest.mark.parametrize("cls", [TSimulation, TSerfSimulation],
                         ids=["swim", "serf"])
def test_metrics_leave_the_trajectory_unchanged(cls, verb):
    n, ticks = 256, 16
    cfg = TSimConfig(n=n, view_degree=16, packet_loss=0.01,
                     gossip=TGossipConfig(**GOSSIP))
    events = [tchaos.Partition(2, 10, side_a=slice(0, n // 4))]

    def make():
        sim = cls(cfg, seed=4, kernel="torch", device="cpu")
        if cls is TSerfSimulation:
            sim.user_event(np.arange(n) == 7, 5)
        sim.kill(np.arange(n) < n // 20)
        return sim

    def drive(sim, count, with_metrics, chunk):
        if verb == "run":
            return sim.run(count, chunk=chunk, with_metrics=with_metrics)
        return sim.run_scenario(events, ticks=count, chunk=chunk,
                                with_metrics=with_metrics).trace

    on, off = make(), make()
    trace = drive(on, ticks, True, 4)
    assert drive(off, ticks, False, ticks) is None
    assert trace.rmse.shape == (ticks,)
    assert on.counters == off.counters
    assert on.counters["deaths_declared"] + on.counters["suspicions_started"] > 0
    for a, b in zip(tlayout.leaves(on.state), tlayout.leaves(off.state)):
        assert torch.equal(a, b)
    # A tick's pairs: the same in one chunk, and after ticks without metrics.
    assert torch.equal(drive(make(), ticks, True, ticks).rmse, trace.rmse)
    late = make()
    late.run(ticks // 2, chunk=ticks, with_metrics=False)
    tail = late.run(ticks // 2, chunk=ticks // 2)
    if verb == "run":
        assert torch.equal(tail.rmse, trace.rmse[ticks // 2:])


def test_cuda_kernel_never_falls_back():
    cfg = TSimConfig(n=64, view_degree=16)
    with pytest.raises(ValueError, match="CUDA device"):
        TSimulation(cfg, device="cpu", kernel="cuda")
    with pytest.raises(ValueError, match="packed"):
        TSimulation(cfg, device="cpu", kernel="cuda", layout="dense")
    sim = TSimulation(cfg, device="cpu", kernel="torch", layout="dense")
    sim.run(4, chunk=4)
    assert sum(sim.counters.values()) > 0


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "consul_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    assert {"__init__.py", "schedule.py"} <= {
        os.path.basename(f) for f in files
        if os.path.basename(os.path.dirname(f)) == "chaos"}
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {os.path.join("consul_tpu_torch", *p) for p in (
        ("runtime", "__init__.py"), ("runtime", "harness.py"),
        ("runtime", "policy.py"), ("runtime", "watchdog.py"),
        ("utils", "checkpoint.py"), ("utils", "telemetry.py"),
        ("server", "rtt.py"), ("ops", "serving.py"), ("ops", "deltas.py"),
        ("serving", "__init__.py"), ("serving", "batcher.py"),
        ("serving", "plane.py"), ("serving", "writes.py"),
        ("serving", "watch.py"), ("serving", "mixed.py"),
        ("ops", "raft_ops.py"), ("models", "raft.py"),
        ("models", "federation.py"), ("parallel", "dcn.py"),
        ("server", "router.py"), ("obs", "__init__.py"), ("obs", "trace.py"),
        ("obs", "lens.py"), ("obs", "blackbox.py"), ("utils", "debug.py"),
        ("models", "snapshot.py"), ("models", "coalesce.py"),
        ("agent", "__init__.py"), ("agent", "http.py"),
        ("gameday", "__init__.py"), ("gameday", "slo.py"),
        ("gameday", "goldens.py"), ("gameday", "harness.py"),
        ("gameday", "swarm.py"), ("cli.py",),
        ("utils", "prewarm.py"), ("utils", "compile_cache.py"),
        ("analysis", "__init__.py"), ("analysis", "guards.py"),
        ("wire", "__init__.py"), ("wire", "_msgpack.py"),
        ("wire", "keyring.py"), ("wire", "lzw.py"), ("wire", "codec.py"),
        ("wire", "keymanager.py"), ("wire", "bridge.py"),
        ("server", "state_store.py"), ("server", "fsm.py"),
        ("server", "raft_store.py"), ("server", "raft.py"),
        ("utils", "hcl.py"), ("utils", "health.py"), ("server", "acl.py"),
        ("server", "connect_ca.py"), ("server", "discovery_chain.py"),
        ("server", "prepared_query.py"), ("server", "autopilot.py"),
        ("server", "endpoints.py"), ("server", "leader.py"),
        ("server", "serf_plumbing.py"))} <= rel
    # The asyncio front end landed with the game day (ROADMAP A19).
    assert os.path.join("consul_tpu_torch", "serving", "frontend.py") in rel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "consul_tpu"), (path, mod)
            # The machine with the card has neither package: the codec
            # carries its own msgpack, and only the keyring's and the
            # Connect CA's guarded imports may name cryptography.
            assert top != "msgpack", (path, mod)
            if top == "cryptography":
                assert path.endswith((os.path.join("wire", "keyring.py"),
                                      os.path.join("server", "connect_ca.py"))
                                     ), path
    for guarded_mod in (("wire", "keyring.py"), ("server", "connect_ca.py")):
        src = ast.parse(open(os.path.join(
            REPO, "consul_tpu_torch", *guarded_mod)).read())
        guarded = [n for n in src.body if isinstance(n, ast.Try)]
        assert len(guarded) == 1 and {
            a.module.split(".")[0] for a in ast.walk(guarded[0])
            if isinstance(a, ast.ImportFrom)} == {"cryptography"}, guarded_mod
        assert not [n for n in src.body
                    if isinstance(n, (ast.Import, ast.ImportFrom))
                    and "cryptography" in ast.dump(n)], guarded_mod
