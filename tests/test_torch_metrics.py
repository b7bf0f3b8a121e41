"""PyTorch port vs the JAX reference: the simulation's metrics from the
packed leaves (``metrics.health_packed``, ``metrics.vivaldi_rmse_packed``,
``cuda_gossip.plain_metrics``, the plain version of launch M).

- On packed states the reference's packed ``Simulation`` reached (n = 256,
  K = 16: formed, after a 5 % kill, under a partition; and the dense view
  at n = 64) and on one with a NaN coordinate on a sampled live row, the
  packed metrics equal ``health`` / ``vivaldi_rmse`` of the unpacked state
  with ``torch.equal`` (NaN on both sides for the RMSE of the NaN state),
  and the reference's values: health exactly (integer counts over one
  float32 division), the RMSE within relative 1e-6 (the reference may sum
  the world distance's three squares in another order).
- ``Simulation``'s per-tick trace is the plain version of launch M on the
  tick's state, with the tick's seeded pairs, for both simulations (and the
  unpacked metrics for the dense layout).
- ``MetricsKernel`` takes CUDA tensors only: on CPU tensors it raises and
  launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.models import layout as jlayout
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.utils import metrics as jmetrics
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.ops import cuda_gossip
from consul_tpu_torch.utils import metrics as tmetrics

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N, K, SAMPLES = 256, 16, 2048
RMSE_RTOL = 1e-6


CASES = ["formed", "after_kill", "schedule", "dense", "nan"]


def _pairs(key, n):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (SAMPLES,), 0, n)),
            np.asarray(jax.random.randint(k2, (SAMPLES,), 0, n)))


def _reference_cases():
    """Per case: the reference's config, world and topology (numpy), its
    packed state (numpy; the NaN case with a NaN coordinate on a sampled
    live row), the sampled pairs, and the reference's own health and RMSE
    on its unpacked view of that state. Once per session
    (``torch_parity.shared``)."""
    jcfg, _ = tp.configs(n=N, view_degree=K, packet_loss=0.01)
    jsim = JSimulation(jcfg, seed=9, layout="packed")
    jsim.run(8, chunk=8, with_metrics=False)
    states = {"formed": (jsim, tp.np_tree(jsim.state))}
    jsim.kill(np.arange(N) < N // 20)
    jsim.run(24, chunk=8, with_metrics=False)
    killed = tp.np_tree(jsim.state)
    states["after_kill"] = (jsim, killed)
    jsim.run_scenario([jchaos.Partition(1, 12, side_a=slice(0, N // 4))],
                      ticks=16, chunk=8)
    states["schedule"] = (jsim, tp.np_tree(jsim.state))
    dcfg, _ = tp.configs(n=64)
    dsim = JSimulation(dcfg, seed=9, layout="packed")
    dsim.kill(np.arange(64) < 4)
    dsim.run(16, chunk=8, with_metrics=False)
    states["dense"] = (dsim, tp.np_tree(dsim.state))
    states["nan"] = (jsim, killed)
    out = {}
    key = jax.random.PRNGKey(17)
    for case in CASES:
        sim, packed = states[case]
        jc, n = sim.cfg, sim.cfg.n
        i_np, j_np = _pairs(key, n)
        if case == "nan":
            alive = np.asarray(packed.flags) & 1
            s = next(s for s in range(SAMPLES) if i_np[s] != j_np[s]
                     and alive[i_np[s]] and alive[j_np[s]])
            vec = np.array(packed.viv.vec, copy=True)
            vec[i_np[s], 0] = np.nan
            packed = packed._replace(viv=packed.viv._replace(vec=vec))
        # The reference, on its own unpacked view of the same packed state.
        jdense = jlayout.unpack(jax.tree.map(jnp.asarray, packed))
        ref_h = tp.np_tree(jmetrics.health(jc, sim.topo, jdense))
        ref_r = float(jmetrics.vivaldi_rmse(jc, sim.world, jdense, key,
                                            samples=SAMPLES))
        out[case] = dict(n=n, view_degree=jc.view_degree, packed=packed,
                         world=tp.np_tree(sim.world), topo=tp.np_tree(sim.topo),
                         pairs=(i_np, j_np), health=ref_h, rmse=ref_r)
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return tp.shared(tmp_path_factory, "metrics/reference_cases",
                     _reference_cases)


@pytest.mark.parametrize("case", CASES)
def test_packed_metrics_equal_unpacked_and_reference(cases, case):
    c = cases[case]
    n, packed = c["n"], c["packed"]
    i_np, j_np = c["pairs"]
    tcfg = tp.configs(n=n, view_degree=c["view_degree"])[1]
    world = convert.world_from(c["world"])
    topo = convert.topology_from(c["topo"])
    tst = convert.packed_state_from(packed)
    i, j = torch.tensor(i_np), torch.tensor(j_np)

    got_h = tmetrics.health_packed(tcfg, topo, tst)
    got_r = tmetrics.vivaldi_rmse_packed(tcfg, world, tst, i, j)
    dense = tlayout.unpack(tst)
    want_h = tmetrics.health(tcfg, topo, dense)
    want_r = tmetrics.vivaldi_rmse(tcfg, world, dense, i, j)
    for a, b in zip(got_h, want_h):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if case == "nan":
        assert torch.isnan(got_r) and torch.isnan(want_r)
    else:
        assert torch.equal(got_r, want_r) and torch.isfinite(got_r)
    row = cuda_gossip.plain_metrics(tcfg, topo, world, tst, i, j)
    assert row.dtype == torch.float32 and row.shape == (4,)
    assert torch.equal(row[:3], torch.stack(list(got_h[:3])))

    # The reference, on its own unpacked view of the same packed state.
    ref_h, ref_r = c["health"], c["rmse"]
    for name in ("agreement", "false_positive", "undetected"):
        assert np.float32(getattr(got_h, name)) == np.asarray(getattr(ref_h, name))
    assert int(got_h.live_nodes) == int(ref_h.live_nodes)
    if case == "nan":
        assert np.isnan(ref_r)
    else:
        np.testing.assert_allclose(float(got_r), ref_r, rtol=RMSE_RTOL)
    if case in ("after_kill", "schedule"):
        assert float(got_h.undetected) + float(got_h.false_positive) > 0


@pytest.mark.parametrize("kind", ["swim", "serf", "dense_layout"])
def test_simulation_trace_is_the_plain_metrics(kind):
    n = 128
    cfg = TSimConfig(n=n, view_degree=16)
    cls = tcluster.SerfSimulation if kind == "serf" else tcluster.Simulation
    sim = cls(cfg, seed=2, kernel="torch", device="cpu",
              layout="dense" if kind == "dense_layout" else "packed")
    sim.kill(np.arange(n) < 6)
    for _ in range(6):
        t = sim._t
        trace = sim.run(1, chunk=1)
        gen = torch.Generator().manual_seed(tcluster.metric_seed(sim.seed, t))
        i, j = tmetrics.rmse_samples(cfg, gen, tcluster.RMSE_SAMPLES, "cpu")
        sw = sim.state.swim if kind == "serf" else sim.state
        if kind == "dense_layout":
            h = tmetrics.health(cfg, sim.topo, sw)
            want = torch.stack([h.agreement, h.false_positive, h.undetected,
                                tmetrics.vivaldi_rmse(cfg, sim.world, sw, i, j)])
        else:
            want = cuda_gossip.plain_metrics(cfg, sim.topo, sim.world, sw, i, j)
        got = torch.stack([x[0] for x in trace])
        assert torch.equal(got, want), (t, got, want)


def test_metrics_kernel_takes_cuda_tensors_only():
    cfg = TSimConfig(n=64, view_degree=8)
    sim = tcluster.Simulation(cfg, seed=1, kernel="torch", device="cpu")
    m = cuda_gossip.make_metrics_kernel(cfg, sim.topo)
    i = torch.zeros(4, dtype=torch.int64)
    before = dict(cuda_gossip.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        m(sim.world, sim.state, i, i, torch.empty(4))
    assert cuda_gossip.LAUNCHES == before
    assert "metrics" in cuda_gossip.LAUNCHES
    assert "metrics" not in cuda_gossip.STAGES


def test_metrics_engine_follows_the_tick_engine(monkeypatch):
    # The tick's engine decides the metrics' engine, whatever the device:
    # the plain tick on the card computes plain metrics, not launch M.
    cfg = TSimConfig(n=64, view_degree=8)
    sim = tcluster.Simulation(cfg, seed=1, kernel="torch", device="cpu")
    built = []
    monkeypatch.setattr(cuda_gossip, "make_metrics_kernel",
                        lambda *a: built.append(a) or (lambda *b: None))
    sim.device = torch.device("cuda")
    sim._make_metrics_fn()
    assert built == []
    sim.kernel = cuda_gossip.CUDA
    sim._make_metrics_fn()
    assert len(built) == 1
