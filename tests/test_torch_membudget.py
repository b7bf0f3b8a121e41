"""PyTorch port vs the JAX reference: the memory planner
(``consul_tpu_torch/runtime/membudget.py``) and cohort streaming
(``models/cluster.StreamedSimulation``, ``StreamedSerfSimulation``;
reference consul_tpu/runtime/membudget.py and cluster.py:974-1158), on
the CPU.

- ``plan()`` equals the reference's ``plan(...).to_dict()`` field for
  field, floats to the last bit, over n in {2,048, 65,536, 4,194,304},
  both kinds, layouts ``auto`` / ``dense`` / ``packed``, budgets 4MB,
  20MB and 1GB, chaos on and off; ``state_bytes_per_node`` equals the
  reference's exactly (the 1M packed SWIM state reads 536.0000004768
  B/node: the tick scalar is divided by n too); ``parse_budget`` as
  tests/test_layout.py:131-142; the streaming error names the family and
  the knobs (tests/test_sweep.py:207-217).
- ``StreamedSimulation(SimConfig(n=1024, view_degree=8), cohort_n=256,
  seed=2, chunk=4)``: the port starts from the reference's archives,
  topology and worlds and draws each cohort's ticks from the reference's
  per-cohort key ladder (``fold_in(fold_in(kb, cohort), t)``); after 8
  ticks every cohort's packed archive equals the reference's (discrete
  leaves bit for bit, floats within ``torch_parity.MAX_STEPS``) and the
  counters are equal.
- Port only, the counterparts of tests/test_layout.py:229-297: the
  refusals, cohorts in lockstep, the serf smoke, chaos in every cohort,
  ``resident_bytes() <= plan.budget_bytes``, and ``kernel="cuda"``
  without a card raises.
"""

import functools
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models import cluster as jcluster
from consul_tpu.runtime import membudget as jmem
from consul_tpu_torch import chaos, convert
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import cluster, layout
from consul_tpu_torch.runtime import MemoryPlan, membudget, plan_memory

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

NS = (2048, 65536, 4194304)
BUDGETS = ("4MB", "20MB", "1GB")


@pytest.fixture
def cached_reference(monkeypatch):
    """The reference's abstract state memoised per (cfg, kind, layout):
    the same pure ``eval_shape``, traced once per shape instead of at
    every call of the grid."""
    monkeypatch.setattr(jmem, "_state_abstract",
                        functools.lru_cache(maxsize=None)(jmem._state_abstract))


def _plan_or_error(mod, cfg, *args, **kw):
    try:
        return mod.plan(cfg, *args, **kw).to_dict()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("layout_", ("auto", "dense", "packed"))
@pytest.mark.parametrize("kind", membudget.KINDS)
def test_plan_equals_reference(cached_reference, kind, layout_):
    for n, budget, on in itertools.product(NS, BUDGETS, (False, True)):
        want = _plan_or_error(jmem, JSimConfig(n=n, view_degree=8), kind,
                              layout=layout_, budget=budget, chaos=on)
        got = _plan_or_error(membudget, SimConfig(n=n, view_degree=8), kind,
                             layout=layout_, budget=budget, chaos=on)
        assert got == want, (n, budget, on)


@pytest.mark.parametrize("kind", membudget.KINDS)
def test_state_bytes_per_node_equal_reference(kind):
    for n, k, lay in ((1 << 20, 32, "packed"), (1 << 20, 32, "dense"),
                      (50000, 16, "packed"), (2048, 8, "dense")):
        want = jmem.state_bytes_per_node(JSimConfig(n=n, view_degree=k), kind,
                                         lay)
        got = membudget.state_bytes_per_node(SimConfig(n=n, view_degree=k),
                                             kind, lay)
        assert got == want, (n, k, lay)
        assert membudget.dense_f32i32_bytes_per_node(
            SimConfig(n=n, view_degree=k), kind) == \
            jmem.dense_f32i32_bytes_per_node(JSimConfig(n=n, view_degree=k), kind)
    if kind == "swim":
        got = membudget.state_bytes_per_node(SimConfig(n=1 << 20, view_degree=32),
                                             "swim", "packed")
        assert got == 536 + 4 / (1 << 20) and got != 536


def test_sizing_allocates_nothing_and_matches_real_tensors():
    cfg = SimConfig(n=4096, view_degree=8)
    g = torch.Generator()
    g.manual_seed(0)
    from consul_tpu_torch.models import state as sim_state

    real = layout.pack_state(sim_state.init(cfg, g))
    assert layout.bytes_per_node(real, cfg.n) == \
        membudget.state_bytes_per_node(cfg, "swim", layout.PACKED)
    abstract = membudget._state_abstract(cfg, "serf", layout.PACKED)
    assert all(x.device.type == "meta" for x in layout.leaves(abstract))


def test_parse_budget():
    assert membudget.parse_budget("2GB") == 2 * 10**9
    assert membudget.parse_budget("512MiB") == 512 * 2**20
    assert membudget.parse_budget("1.5G") == int(1.5 * 10**9)
    assert membudget.parse_budget(12345) == 12345
    assert membudget.parse_budget("auto") is None
    assert membudget.parse_budget(None) is None
    with pytest.raises(ValueError, match="unparseable"):
        membudget.parse_budget("lots")


def test_streaming_error_names_the_family():
    cfg = SimConfig(n=1 << 22, view_degree=0, topo_family="expander")
    with pytest.raises(ValueError) as ei:
        membudget.plan(cfg, "swim", layout="dense", budget="1GB")
    msg = str(ei.value)
    assert "expander" in msg and "--view-degree" in msg and "--family" in msg


def test_plan_surface():
    plan = plan_memory(SimConfig(n=65536, view_degree=8), kind="serf",
                       budget="20MB")
    assert isinstance(plan, MemoryPlan) and plan.streamed
    assert plan.prewarm_args() == {"ns": [plan.cohort_n], "kinds": ["serf"],
                                   "chunks": [plan.chunk],
                                   "layout": layout.PACKED}
    assert plan.to_dict()["packed_cut"] == round(plan.packed_cut, 3)
    # The CPU's budget is host RAM: a 1k population stays dense resident.
    plan = membudget.plan(SimConfig(n=1024, view_degree=8), device="cpu")
    assert not plan.streamed and plan.layout == layout.DENSE
    with pytest.raises(ValueError, match="single device"):
        membudget.plan(SimConfig(n=65536, view_degree=8), budget="4MB",
                       mesh=types.SimpleNamespace(size=8, devices=[None] * 8))


def _ladder(jcfg, jsim):
    draws_fn = tp.make_draws_fn(jcfg)

    def draws(cohort, t):
        key = jax.random.fold_in(jsim._cohort_key(cohort), t)
        return tp.to_tick_draws(jax.device_get(draws_fn(key)))
    return draws


def test_streamed_equals_reference_cohort_for_cohort():
    jcfg, tcfg = tp.configs(n=1024, view_degree=8)
    jsim = jcluster.StreamedSimulation(jcfg, cohort_n=256, seed=2, chunk=4)
    sim = cluster.StreamedSimulation(
        tcfg, cohort_n=256, seed=2, chunk=4, device="cpu", kernel="torch",
        topo=convert.topology_from(jsim.topo),
        world_of=lambda i: convert.world_from(jax.device_get(jsim._world_of(i))),
        archives=[convert.packed_state_from(a) for a in jsim._archive],
        draws=_ladder(jsim.cohort_cfg, jsim))
    want, got = jsim.run(8), sim.run(8)
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in want.items() if k != "wall_s"}
    for i in range(sim.cohorts):
        tp.assert_packed_close(tp.np_tree(jsim._archive[i]),
                               sim.cohort_state(i), f"cohort {i}")
    assert sim.counters == jsim.counters
    assert sim.counters["probes_sent"] > 0
    assert sim.sink.counter_sum("sim.stream.passes") == 1


def _streamed(cls=cluster.StreamedSimulation, n=1024, cohort_n=256, **kw):
    return cls(SimConfig(n=n, view_degree=8), cohort_n=cohort_n,
               device="cpu", kernel="torch", **kw)


@pytest.mark.parametrize("case", ("divide", "dense_view", "cuda_without_card"))
def test_streamed_refusals(case):
    if case == "divide":
        with pytest.raises(ValueError, match="divide"):
            _streamed(n=1000, cohort_n=300)
    elif case == "dense_view":
        with pytest.raises(ValueError, match="sparse view"):
            cluster.StreamedSimulation(SimConfig(n=1024), cohort_n=256,
                                       device="cpu", kernel="torch")
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        for cls in (cluster.StreamedSimulation, cluster.StreamedSerfSimulation):
            with pytest.raises(ValueError, match="CUDA device"):
                cls(SimConfig(n=1024, view_degree=8), cohort_n=256)
            with pytest.raises(ValueError, match="CUDA device"):
                cls(SimConfig(n=1024, view_degree=8), cohort_n=256,
                    device="cpu", kernel="cuda")


def test_streamed_cohorts_advance_in_lockstep():
    sim = _streamed(seed=2, chunk=4)
    out = sim.run(8)
    assert out["cohorts"] == 4 and out["layout"] == layout.PACKED
    assert sim._tick() == 8
    assert [int(sim.cohort_swim_state(i).t) for i in range(4)] == [8] * 4
    assert sim.counters["probes_sent"] > 0
    # A second pass carries each cohort's draw generator on.
    states = [g.get_state() for g in sim.gens]
    sim.run(4)
    assert sim._tick() == 12
    assert all(not torch.equal(a, g.get_state()) for a, g in zip(states, sim.gens))


def test_streamed_serf_smoke():
    sim = _streamed(cluster.StreamedSerfSimulation, n=512, seed=1, chunk=4)
    out = sim.run(4)
    assert out["cohorts"] == 2 and sim._tick() == 4
    assert sim.counters["gossip_tx"] > 0


def test_streamed_chaos_in_every_cohort():
    faulted, quiet = _streamed(seed=2, chunk=4), _streamed(seed=2, chunk=4)
    faulted.set_chaos([chaos.LinkLoss(start=1, stop=6, a=slice(0, 64),
                                      b=slice(128, 256), fwd=1.0, rev=1.0)])
    faulted.run(8)
    quiet.run(8)
    assert faulted.counters["chaos_msgs_dropped"] > 0
    assert quiet.counters["chaos_msgs_dropped"] == 0
    # The schedule replays in every cohort: each one's trajectory moved.
    for i in range(faulted.cohorts):
        a = layout.leaves(faulted.cohort_state(i))
        b = layout.leaves(quiet.cohort_state(i))
        assert any(not torch.equal(x, y) for x, y in zip(a, b)), i


def test_planned_cohort_fits_within_budget():
    cfg = SimConfig(n=4096, view_degree=8)
    plan = membudget.plan(cfg, budget="4MB")
    assert plan.streamed
    sim = cluster.StreamedSimulation(cfg, cohort_n=plan.cohort_n, seed=0,
                                     layout=plan.layout, chunk=plan.chunk,
                                     device="cpu", kernel="torch")
    assert sim.resident_bytes() <= plan.budget_bytes
    assert sim._tick() == 0
    state_b = sum(layout.np_size_bytes(x)
                  for x in layout.leaves(sim.cohort_state(0)))
    assert sim.resident_bytes() >= 2 * state_b
    np.testing.assert_equal(sim.archive_bytes(), state_b * sim.cohorts)
