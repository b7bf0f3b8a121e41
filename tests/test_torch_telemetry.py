"""PyTorch port vs the JAX reference: the telemetry sink and the simulation's
chunk boundary (``consul_tpu_torch/utils/telemetry.py``,
``Simulation.sink``, the deferred counters).

- ``Sink``, ``to_prometheus`` and ``emit_counter_deltas`` behave as the
  reference's: the DisplayMetrics shape, nearest-rank percentiles, the
  Prometheus summary lines and the TYPE-line dedupe, zero deltas skipped,
  the same ``METRIC_NAMES``.
- ``emit_sim_metrics`` over the packed leaves of a state the reference's
  packed ``SerfSimulation`` reached records the gauges and samples the
  reference records from its unpacked view of the same state: exactly,
  but the adjustment sample (float32 sums in another order, relative
  1e-6).
- ``Simulation``: a chunk with metrics records the reference's names
  (the first chunk of each length without timing, the next with it);
  a chunk without metrics reads nothing back until ``counters`` is read,
  and then folds the same totals a metrics run does; with the sentinel on
  every chunk flushes, and a trip counts ``sim.sentinel.trips``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.models import counters as jcounters
from consul_tpu.models import layout as jlayout
from consul_tpu.models.cluster import SerfSimulation as JSerfSimulation
from consul_tpu.utils import telemetry as jtelemetry
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.utils import telemetry as ttelemetry

import torch_parity as tp


def _filled(mod):
    s = mod.Sink()
    s.set_gauge("memberlist.health.score", 0.5)
    s.incr_counter("memberlist.msg.alive", 3)
    s.incr_counter("memberlist.msg.alive", 2)
    for v in (1.0, 2.0, 3.0, 4.0):
        s.add_sample("serf.coordinate.adjustment-ms", v)
    # Two names that sanitize to one Prometheus name: the first is kept.
    s.set_gauge("serf.queue.Event-max", 1.0)
    s.set_gauge("serf.queue.Event.max", 2.0)
    return s


def test_sink_semantics_match_reference():
    got, want = _filled(ttelemetry).snapshot(), _filled(jtelemetry).snapshot()
    assert set(got) == {"Timestamp", "Gauges", "Counters", "Samples"}
    for k in ("Gauges", "Counters", "Samples"):
        assert got[k] == want[k]
    [c] = got["Counters"]
    assert c["Sum"] == 5 and c["Count"] == 2
    [sm] = got["Samples"]
    assert (sm["P50"], sm["P99"], sm["Mean"]) == (3.0, 4.0, 2.5)
    assert ttelemetry.to_prometheus(got) == jtelemetry.to_prometheus(want)
    body = ttelemetry.to_prometheus(got).splitlines()
    assert body.count("# TYPE serf_queue_Event_max gauge") == 1
    s = ttelemetry.Sink()
    assert s.counter_sum("x", 7.0) == 7.0 and s.gauge_value("y", 3.0) == 3.0
    s.measure_since("memberlist.gossip", 0.0)
    assert s.snapshot()["Samples"][0]["Count"] == 1


def test_counter_names_and_deltas_match_reference():
    assert tcounters.METRIC_NAMES == jcounters.METRIC_NAMES
    deltas = {f: (i % 3) for i, f in enumerate(tcounters.FIELDS)}
    got, want = ttelemetry.Sink(), jtelemetry.Sink()
    ttelemetry.emit_counter_deltas(got, deltas)
    jtelemetry.emit_counter_deltas(want, deltas)
    assert got.snapshot()["Counters"] == want.snapshot()["Counters"]
    assert len(got.snapshot()["Counters"]) == sum(1 for v in deltas.values() if v)


@pytest.fixture(scope="module")
def serf_state():
    jcfg, _ = tp.configs(n=256, view_degree=16)
    jsim = JSerfSimulation(jcfg, seed=4, layout="packed")
    jsim.kill(np.arange(256) >= 240)
    jsim.run(12, chunk=12, with_metrics=False)
    jsim.user_event(jnp.arange(256) < 3, 7)
    jsim.run(2, chunk=2, with_metrics=False)
    return jcfg, tp.np_tree(jsim.state)


def test_emit_sim_metrics_matches_reference(serf_state):
    jcfg, st = serf_state
    tst = convert.serf_state_from(st)
    got, want = ttelemetry.Sink(), jtelemetry.Sink()
    health = jax.tree.map(jnp.float32, (0.75, 0.125, 0.0625))
    kw = dict(rounds_per_sec=123.0, chunk_wall_s=0.5, chunk_ticks=16,
              queue_depth_warning=3)

    class H:  # the reference reads three attributes; the port a tuple's
        agreement, false_positive, undetected = health

    ttelemetry.emit_sim_metrics(
        tst.swim, got, health=H, rmse_s=torch.tensor(0.02),
        serf_state=tst, counters={"probes_sent": 5, "gossip_rx": 0}, **kw)
    jdense = jlayout.unpack(jax.tree.map(jnp.asarray, st.swim))
    jtelemetry.emit_sim_metrics(
        jdense, want, health=H, rmse_s=float(np.float32(0.02)),
        serf_state=jax.tree.map(jnp.asarray, st),
        counters={"probes_sent": 5, "gossip_rx": 0}, **kw)
    g, w = got.snapshot(), want.snapshot()
    assert g["Gauges"] == w["Gauges"]
    assert g["Counters"] == w["Counters"]
    gs = {s["Name"]: s for s in g["Samples"]}
    ws = {s["Name"]: s for s in w["Samples"]}
    assert set(gs) == set(ws) == {"memberlist.gossip", "serf.queue.Event",
                                  "serf.coordinate.adjustment-ms"}
    assert gs["memberlist.gossip"] == ws["memberlist.gossip"]
    assert gs["serf.queue.Event"] == ws["serf.queue.Event"]
    np.testing.assert_allclose(gs["serf.coordinate.adjustment-ms"]["Sum"],
                               ws["serf.coordinate.adjustment-ms"]["Sum"],
                               rtol=1e-6)
    gauges = {x["Name"]: x["Value"] for x in g["Gauges"]}
    assert gauges["serf.members.alive"] == 240.0
    assert gauges["serf.queue.Event.max"] > 0


def _sim(cls=tcluster.Simulation, n=128):
    sim = cls(TSimConfig(n=n, view_degree=16), seed=6, kernel="torch",
              device="cpu")
    sim.kill(np.arange(n) < 6)
    return sim


@pytest.mark.parametrize("cls", [tcluster.Simulation, tcluster.SerfSimulation],
                         ids=["swim", "serf"])
def test_chunk_boundary_records_reference_names(cls):
    sim = _sim(cls)
    sim.run(16, chunk=8)
    snap = sim.sink.snapshot()
    gauges = {g["Name"] for g in snap["Gauges"]}
    assert {"memberlist.health.score", "memberlist.health.score.max",
            "serf.members.alive", "serf.coordinate.resets", "sim.agreement",
            "sim.false_positive", "sim.undetected", "sim.vivaldi_rmse_ms",
            "sim.gossip_rounds_per_sec"} <= gauges
    samples = {s["Name"]: s for s in snap["Samples"]}
    # The first 8-tick chunk is recorded without timing, the second with.
    assert samples["memberlist.gossip"]["Count"] == 1
    assert samples["serf.coordinate.adjustment-ms"]["Count"] == 2
    assert ("serf.queue.Event" in samples) == (cls is tcluster.SerfSimulation)
    sums = {c["Name"]: c["Sum"] for c in snap["Counters"]}
    for f, v in sim.counters.items():
        assert sums.get(tcounters.METRIC_NAMES[f], 0) == v
    assert sim.sink.gauge_value("sim.agreement") == float(
        sim.run(1, chunk=1).agreement[-1])


def test_counters_defer_until_read():
    on, off = _sim(), _sim()
    on.run(24, chunk=8)
    off.run(24, chunk=8, with_metrics=False)
    assert len(off._pending_counters) == 3 and off.chunk_counters == []
    snap = off.counters_snapshot()
    assert off._pending_counters == [] and len(off.chunk_counters) == 3
    assert snap == on.counters and snap is not off.counters
    assert off.chunk_counters == on.chunk_counters
    sums = {c["Name"]: c["Sum"] for c in off.sink.snapshot()["Counters"]}
    assert sums["memberlist.probeNode"] == snap["probes_sent"] > 0
    # With the sentinel on, every chunk flushes.
    off.set_sentinel(True)
    off.run(16, chunk=8, with_metrics=False)
    assert off._pending_counters == [] and len(off.chunk_counters) == 5
    off.throughput(8)
    assert len(off._pending_counters) == 2


def test_sentinel_trip_counted_in_sink():
    sim = _sim()
    sim.set_sentinel(True)
    vec = sim.state.viv.vec.clone()
    vec[40] = float("nan")
    sim.state = sim.state._replace(viv=sim.state.viv._replace(vec=vec))
    with pytest.raises(tcluster.SentinelViolation) as ei:
        sim.run(4, chunk=4, with_metrics=False)
    assert ei.value.deltas["sentinel_nonfinite_coord"] > 0
    assert ei.value.dump_path is None
    assert sim.sink.counter_sum("sim.sentinel.trips") == 1
    assert sim.sink.counter_sum("sim.sentinel.nonfinite_coordinates") > 0
