"""PyTorch port vs the JAX reference: scenario sweeps
(``consul_tpu_torch/chaos/sweep.py``, ``Simulation.sweep`` and its lane
runner ``Simulation._run_lanes``).

At the reference tests' size (tests/test_sweep.py: N = 128, K = 8, 32
ticks to form, 40 of scenario, chunk 20). The port's simulation (packed,
``kernel="torch"`` on the CPU) starts from the reference's world,
topology and initial state, fed the reference's key ladder (with the
chaos-only push-pull draw), and forms; the reference's simulation takes
the formed state over, so both sides sweep from the same bits. (Forming
on the port spares the reference one compile per family; tier-1 holds
the port's tick to the reference's step.) Every counter is compared
exactly. The reference sweeps the grid's lanes padded to the random
lanes' slot shape with no-op entries (an empty ChurnWave, a Degrade
without loss: its own remedy for mixed shapes), so every reference sweep
here shares one executable; the port sweeps the grid unpadded, so its
rows equal the reference's only if the padding changes nothing.

- The port's ``run_sweep`` equals the reference's lane for lane (every
  counter, ``slo``, ``ticks``) for ``scenario_grid(N, 3)`` and
  ``scenario_random(N, 3, seed=7)`` on the four view-graph families;
  ``family_sweep`` rows equal the reference's, ``spectral_gap`` included.
  (``SerfSimulation`` and raft-armed sweeps against the reference:
  tests/test_torch_sweep_planes.py, which shares these helpers.)
- Against itself: each lane equals a solo ``run_scenario``; the packed
  and dense layouts give the same counters; ``chunk`` (which only the
  forming in ``bench_pareto`` uses) does not matter.
- A sweep leaves the simulation bit-equal (state, tick, draw generator,
  counters), and ``run(8)`` after it equals a twin's that never swept.
- The refusals carry the reference's messages; the sink counts runs and
  scenarios; the pure helpers equal the reference's.
(On a card, the sweep through the CUDA tick kernel against the plain
tick: tests/test_torch_sweep_card.py.)
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.chaos import sweep as jsweep
from consul_tpu.models import cluster as jcluster
from consul_tpu.ops import topology as jtopology
from consul_tpu_torch import convert
from consul_tpu_torch.chaos import schedule as tchaos
from consul_tpu_torch.chaos import sweep as tsweep
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import counters as tcounters

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N, VD = 128, 8
FORM, TICKS, CHUNK = 32, 40, 20
FAMILIES = ("circulant", "expander", "smallworld", "hier")
MODES = {"grid": lambda C: C.scenario_grid(N, 3),
         "random": lambda C: C.scenario_random(N, 3, seed=7)}


def _padded(scens):
    """Grid lanes in the random lanes' slot shape: a no-op ChurnWave and
    Degrade over each Partition's window."""
    return [ev + [jchaos.ChurnWave(start=ev[0].start, stop=ev[0].stop,
                                   nodes=slice(0, 0)),
                  jchaos.Degrade(start=ev[0].start, stop=ev[0].stop,
                                 nodes=slice(0, N // 10), tx_loss=0.0)]
            for ev in scens]


def _ref_scens(mode):
    """The reference's lanes for ``mode`` (the grid padded, see above)."""
    scens = MODES[mode](jsweep)
    return _padded(scens) if mode == "grid" else scens


@functools.lru_cache(maxsize=None)
def _draws_fn(shape_cfg, serf: bool):
    """The reference's jitted draw ladder for a family-free config: one
    compile per shape, shared by every family's simulation."""
    make = tp.make_serf_draws_fn if serf else tp.make_draws_fn
    return make(shape_cfg, chaos=True)


def _port_sim(jsim, layout="packed"):
    """The port's simulation from the reference's world, topology and
    state, fed the reference's key ladder with the chaos-only draws."""
    serf = isinstance(jsim, jcluster.SerfSimulation)
    _, tcfg = tp.configs(n=jsim.cfg.n, view_degree=jsim.cfg.view_degree,
                         topo_family=jsim.cfg.topo_family)
    fn = _draws_fn(dataclasses.replace(jsim.cfg, topo_family="circulant"),
                   serf)
    if serf:
        to, conv, cls = (tp.to_serf_draws, convert.serf_state_from,
                         tcluster.SerfSimulation)
    else:
        to, conv, cls = (tp.to_tick_draws, convert.sim_state_from,
                         tcluster.Simulation)
    base = jsim.base_key
    return cls(tcfg, seed=0, layout=layout, kernel="torch", device="cpu",
               world=convert.world_from(tp.np_tree(jsim.world)),
               topo=convert.topology_from(tp.np_tree(jsim.topo)),
               state=conv(tp.np_tree(jsim.state)),
               draws=lambda t: to(fn(jax.random.fold_in(base, t))))


def _to_ref(template, port):
    """A port state tree as the reference's: ``template`` (a reference
    state) gives the classes and dtypes, fields match by name."""
    if isinstance(template, tuple):
        return type(template)(*(_to_ref(getattr(template, f), getattr(port, f))
                                for f in template._fields))
    return jnp.asarray(port.cpu().numpy().astype(np.asarray(template).dtype))


def _formed_pair(cls, family):
    """The reference's simulation and the port's, both at the state the
    port's plain tick reaches after FORM ticks from the reference's
    initial state on the reference's key ladder (tier-1 holds that tick
    to the reference's step)."""
    jcfg, _ = tp.configs(n=N, view_degree=VD, topo_family=family)
    jsim = cls(jcfg, seed=0)
    tsim = _port_sim(jsim)
    tsim.run(FORM, chunk=FORM, with_metrics=False)
    dense = tsim.serf_state if tsim._serf_plane else tsim.swim_state
    jsim.state = _to_ref(jsim.state, dense)
    return jsim, tsim


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["counters"] == {f: w["counters"][f]
                                 for f in tcounters.FIELDS}, i
        assert g["slo"] == w["slo"], i
        assert g["ticks"] == w["ticks"], i


def _reference_run(fam):
    """The reference's side of the module for one family, once per
    session (``torch_parity.shared``): its simulation's world, topology,
    initial state and key, both sides' ``run_sweep`` rows for each mode
    from the formed state, its ``family_sweep`` row, and (on the circulant
    family) its refusal messages."""
    jsim, tsim = _formed_pair(jcluster.Simulation, fam)
    rec = dict(rows={}, family=jsweep.family_sweep(
        jsim, _ref_scens("grid"), ticks=CHUNK, chunk=CHUNK))
    for mode, make in MODES.items():
        rec["rows"][mode] = (
            tsweep.run_sweep(tsim, make(tsweep), ticks=TICKS, chunk=CHUNK),
            jsweep.run_sweep(jsim, _ref_scens(mode), ticks=TICKS,
                             chunk=CHUNK))
    if fam == "circulant":
        rec["refusals"] = {k: _refusal(jsweep, jchaos, jsim, k)
                           for k in ("empty", "mixed")}
    rec["formed_state"] = tp.np_tree(jsim.state)
    rec["sim"] = dict(world=tp.np_tree(jsim.world),
                      topo=tp.np_tree(jsim.topo),
                      base_key=np.asarray(jsim.base_key))
    return rec


class _OnFirstUse(dict):
    """A mapping whose values are built when first looked up, so a worker
    builds (or waits for) only the families its tests read, and two
    workers can build two families at once."""

    def __init__(self, build):
        super().__init__()
        self._build = build

    def __missing__(self, key):
        self[key] = value = self._build(key)
        return value


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """family -> :func:`_reference_run`'s record."""
    return _OnFirstUse(lambda fam: tp.shared(
        tmp_path_factory, f"sweep/reference_run {fam}",
        functools.partial(_reference_run, fam)))


@pytest.fixture(scope="module")
def formed(reference_runs):
    """family -> (the reference simulation's formed inputs, the port sim
    formed from them): the first a stand-in with the reference's config,
    world, topology, formed state and key ladder."""
    def build(fam):
        rec = reference_runs[fam]
        jcfg, _ = tp.configs(n=N, view_degree=VD, topo_family=fam)
        ref = types.SimpleNamespace(
            cfg=jcfg, world=rec["sim"]["world"], topo=rec["sim"]["topo"],
            state=rec["formed_state"],
            base_key=jnp.asarray(rec["sim"]["base_key"]))
        return ref, _port_sim(ref)

    return _OnFirstUse(build)


@pytest.fixture(scope="module")
def rows(reference_runs):
    """(family, mode) -> (the port's run_sweep rows, the reference's)."""
    return _OnFirstUse(lambda key: reference_runs[key[0]]["rows"][key[1]])


def _own_sim(cls=tcluster.Simulation):
    """A port simulation on its own draw generator, formed."""
    sim = cls(TSimConfig(n=N, view_degree=VD), seed=5, kernel="torch",
              device="cpu")
    sim.run(16, chunk=16, with_metrics=False)
    return sim


# ----------------------------------------------------------------------
# Against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_matches_reference(rows, family, mode):
    got, want = rows[(family, mode)]
    _assert_rows_equal(got, want)
    assert any(r["slo"]["fault_ticks"] > 0 for r in got)
    assert any(r["slo"]["messages_dropped"] > 0 for r in got)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_sweep_matches_reference(formed, reference_runs, family):
    """One chunk of CHUNK ticks: the reference's executable again."""
    _, tsim = formed[family]
    want = reference_runs[family]["family"]
    got = tsweep.family_sweep(tsim, tsweep.scenario_grid(N, 3),
                              ticks=CHUNK, chunk=CHUNK)
    assert got == want
    assert got["spectral_gap"] > 0.0


# ----------------------------------------------------------------------
# Against itself
# ----------------------------------------------------------------------

def test_lanes_equal_solo_replays(formed, rows):
    jsim, _ = formed["circulant"]
    got = rows[("circulant", "random")][0]
    for i, ev in enumerate(MODES["random"](tsweep)):
        solo = _port_sim(jsim)
        ref = solo.run_scenario(ev, ticks=TICKS, chunk=CHUNK)
        assert got[i]["counters"] == ref.counters, i
        assert got[i]["slo"] == ref.slo, i
        assert got[i]["ticks"] == ref.ticks


def test_packed_and_dense_layouts_agree(formed, rows):
    jsim, _ = formed["smallworld"]
    dense = _port_sim(jsim, layout="dense")
    assert dense.layout == "dense"
    got = dense.sweep(MODES["random"](tsweep), ticks=TICKS, chunk=CHUNK)
    _assert_rows_equal(got, rows[("smallworld", "random")][0])


def test_counters_do_not_depend_on_chunk():
    """The sweeps step tick by tick and take ``chunk`` for the reference's
    signature only; bench_pareto forms its simulations in chunks of it."""
    kw = dict(n=64, degree=VD, scenarios=2, families=("hier",),
              form_ticks=8, settle=4, device="cpu", kernel="torch")
    a = tsweep.bench_pareto(chunk=3, **kw)     # forms 3 + 3 + 2
    b = tsweep.bench_pareto(chunk=8, **kw)
    assert a == b
    assert a["pareto"][0]["scenarios"][0]["fault_ticks"] > 0


def _snapshot(sim):
    return ([convert.bits(x) for x in _leaves(sim.state)], sim._t,
            sim.gen.get_state().clone(), dict(sim.counters))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _assert_same(a, b):
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert a[1] == b[1]
    assert torch.equal(a[2], b[2])
    assert a[3] == b[3]


@pytest.mark.parametrize("cls", [tcluster.Simulation, tcluster.SerfSimulation],
                         ids=["swim", "serf"])
def test_sweep_leaves_the_simulation_unmoved(cls):
    sim, twin = _own_sim(cls), _own_sim(cls)
    before = _snapshot(sim)
    res = sim.sweep(tsweep.scenario_random(N, 2, seed=3), ticks=24)
    assert res[0]["slo"]["fault_ticks"] > 0
    _assert_same(_snapshot(sim), before)
    assert sim.chaos is None
    sim.run(8, chunk=8, with_metrics=False)
    twin.run(8, chunk=8, with_metrics=False)
    _assert_same(_snapshot(sim), _snapshot(twin))


# ----------------------------------------------------------------------
# Refusals, the sink, the pure helpers
# ----------------------------------------------------------------------

def _refusal(mod, C, sim, kind):
    scens = {"empty": [],
             "dense": mod.scenario_grid(64, 2),
             "mixed": [[C.Partition(start=4, stop=12, side_a=slice(0, 32))],
                       [C.Partition(start=4, stop=12, side_a=slice(0, 32)),
                        C.ChurnWave(start=4, stop=12, nodes=slice(0, 8))]]}
    with pytest.raises(ValueError) as ei:
        mod.run_sweep(sim, scens[kind], ticks=TICKS)
    return str(ei.value)


@pytest.mark.parametrize("kind,match", [("empty", "empty"),
                                        ("dense", "view_degree"),
                                        ("mixed", "pad the short ones")])
def test_refusals_carry_the_reference_messages(formed, reference_runs, kind,
                                               match):
    _, tsim = formed["circulant"]
    if kind == "dense":
        # The reference refuses on its simulation's topology alone, so its
        # dense topology stands in for a whole dense simulation.
        jcfg, tcfg = tp.configs(n=64, view_degree=0)
        jsim = types.SimpleNamespace(
            cfg=jcfg, topo=jtopology.make_topology(jcfg, jax.random.PRNGKey(0)))
        tsim = tcluster.Simulation(tcfg, seed=0, kernel="torch", device="cpu")
        want = _refusal(jsweep, jchaos, jsim, kind)
    else:
        want = reference_runs["circulant"]["refusals"][kind]
    got = _refusal(tsweep, tchaos, tsim, kind)
    assert match in got
    assert got == want


def test_sink_counts_runs_and_scenarios():
    sim = tcluster.Simulation(TSimConfig(n=64, view_degree=VD), seed=0,
                              kernel="torch", device="cpu")
    sim.sweep(tsweep.scenario_grid(64, 2), ticks=4)
    sim.sweep(tsweep.scenario_grid(64, 3), ticks=4)
    assert sim.sink.counter_sum("sim.sweep.runs") == 2
    assert sim.sink.counter_sum("sim.sweep.scenarios") == 5


def _events(scens):
    return [[(type(e).__name__, dataclasses.astuple(e)) for e in ev]
            for ev in scens]


@pytest.mark.parametrize("n,make", [
    (256, lambda C: C.scenario_grid(256, 16)),
    (1000, lambda C: C.scenario_grid(1000, 5, start=9)),
    (N, lambda C: C.scenario_random(N, 3, seed=7)),
    (4096, lambda C: C.scenario_random(4096, 16, seed=0, start=2, max_dur=40))],
    ids=["grid16", "grid_start", "random3", "random16"])
def test_scenario_generators_match_reference(n, make):
    got = make(tsweep)
    assert _events(got) == _events(make(jsweep))
    keys = {tchaos.static_key_of(tchaos.compile_schedule(n, ev)) for ev in got}
    assert len(keys) == 1 and None not in keys


PF = {
    "circulant": {"bytes_per_tick_node": 80.0, "time_to_heal_worst": 270},
    "smallworld": {"bytes_per_tick_node": 50.0, "time_to_heal_worst": 96},
    "expander": {"bytes_per_tick_node": 81.0, "time_to_heal_worst": 60},
}


def test_pareto_helpers_match_reference():
    rows = tsweep.pareto_table(PF)
    assert rows == jsweep.pareto_table(PF)
    by = {r["family"]: r for r in rows}
    assert by["circulant"]["dominated_by"] == ["smallworld"]
    assert by["smallworld"]["dominated_by"] == by["expander"]["dominated_by"] == []
    assert tsweep.strict_dominators(PF) == ["smallworld"]
    tied = dict(PF, tied={"bytes_per_tick_node": 80.0,
                          "time_to_heal_worst": 10})
    assert tsweep.strict_dominators(tied) == jsweep.strict_dominators(tied)
    assert "tied" not in tsweep.strict_dominators(tied)
    assert tsweep.strict_dominators(PF, "absent") == []


def test_worst_case_and_wire_bytes_match_reference():
    res = [
        {"slo": {"time_to_heal": 10, "false_positive_deaths": 0,
                 "time_to_first_suspect": 3}},
        {"slo": {"time_to_heal": 40, "false_positive_deaths": 0,
                 "time_to_first_suspect": 2}},
        {"slo": {"time_to_heal": 40, "false_positive_deaths": 2,
                 "time_to_first_suspect": 1}},
    ]
    assert tsweep.worst_case(res) == jsweep.worst_case(res) == 2
    c = {"gossip_tx": 100, "gossip_msgs_tx": 300}
    want = (100 * 12 + 300 * 33) / (50 * 64)
    assert tsweep.wire_bytes_per_tick_node(c, 50, 64) == want
    assert jsweep.wire_bytes_per_tick_node(c, 50, 64) == want
    assert (tsweep.PACKET_OVERHEAD_BYTES, tsweep.MSG_BYTES) == (
        jsweep.PACKET_OVERHEAD_BYTES, jsweep.MSG_BYTES)


def test_bench_pareto_on_the_cpu():
    out = tsweep.bench_pareto(n=64, degree=VD, scenarios=2,
                              families=("circulant", "smallworld"),
                              form_ticks=8, settle=4, device="cpu",
                              kernel="torch")
    assert out["families"] == ["circulant", "smallworld"]
    assert {r["family"] for r in out["pareto"]} == set(out["families"])
    for r in out["pareto"]:
        assert r["degree"] == VD and len(r["scenarios"]) == 2
    assert out["dominates_default"] == tsweep.strict_dominators(
        {r["family"]: r for r in out["pareto"]})
