"""PyTorch port vs the JAX reference: the observability plane
(``consul_tpu_torch/obs``, ``utils/debug.py``, ``runtime/watchdog.InitWatchdog``
and the spans at the port's seams).

- The tracer: the port's ``Tracer`` and the reference's, on the same
  scripted calls with their clocks pinned, give equal ``to_json()`` but
  for ``producer`` (span, complete, instant, counter, ring drops, extra
  events), and mirror equal samples into their sinks.
- ``normalize_ids`` and ``LensRecorder`` equal the reference's.
- Lens rows: ``Simulation.set_lens`` on the port's plain path (n = 256,
  K = 16, the reference's state and key ladder) equals the reference's
  lens over two chunks of 16 around a 5 % kill, for bare SWIM, serf and
  raft armed: every field exact but ``vivaldi_error``, which the port reads
  from the packed bfloat16 leaf and is held to the reference's f32 value
  rounded to bfloat16 within ``torch_parity``'s MAX_STEPS / FLOOR_S gap.
  The chunk spans, and with raft the ``raft.*`` spans and instants, equal
  the reference's, and both sinks mirror them.
- ``snapshot_packed`` equals ``snapshot`` of the unpacked state; arming
  the lens leaves the trajectory bit-equal; the lens and a mesh refuse
  each other; ``LensKernel`` refuses CPU tensors.
- The serving, watch, DCN and checkpoint seams record the reference's
  span names, categories and args for the same flows (the batchers' and
  the watch plane's device work stubbed the same on both sides: the seam
  is the host bracket).
- The black box: the environment filter, ``device_progress`` without a
  device query, the reference's keys with ``cuda`` for ``libtpu``;
  ``InitWatchdog`` writes ``blackbox.json`` after killing a child that
  never gets ready; ``capture_sim`` and ``write_bundle`` round-trip with a
  2-tick CPU profile.
"""

import json
import os
import re
import subprocess
import sys
import tarfile
import time
import types
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.models import raft as jraft_mod
from consul_tpu.models.cluster import SerfSimulation as JSerfSimulation
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.obs import blackbox as jblackbox
from consul_tpu.obs import lens as jlens
from consul_tpu.obs import trace as jtrace
from consul_tpu.ops import deltas as jdeltas
from consul_tpu.ops import raft_ops as jraft
from consul_tpu.parallel import dcn as jdcn
from consul_tpu.serving import batcher as jbatcher
from consul_tpu.serving import watch as jwatch
from consul_tpu.serving import writes as jwrites
from consul_tpu.utils import checkpoint as jckpt
from consul_tpu.utils import telemetry as jtelemetry
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch import convert
from consul_tpu_torch.config import RaftConfig as TRaftConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.obs import blackbox as tblackbox
from consul_tpu_torch.obs import lens as tlens
from consul_tpu_torch.obs import trace as ttrace
from consul_tpu_torch.ops import cuda_gossip
from consul_tpu_torch.ops import deltas as tdeltas
from consul_tpu_torch.parallel import dcn as tdcn
from consul_tpu_torch.runtime import watchdog as twd
from consul_tpu_torch.serving import batcher as tbatcher
from consul_tpu_torch.serving import watch as twatch
from consul_tpu_torch.serving import writes as twrites
from consul_tpu_torch.utils import checkpoint as tckpt
from consul_tpu_torch.utils import debug as tdebug
from consul_tpu_torch.utils import telemetry as ttelemetry

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N, K, CHUNK = 256, 16, 16
GOSSIP = dict(suspicion_mult=2, suspicion_max_timeout_mult=2)
# Evenly spaced rows, rows inside the killed range [0, 12) and rows that
# watch it.
IDS = tuple(sorted(set(range(0, N, 16)) | {5, 11, 13, 17, 250, 255}))
# Short raft timeouts, so a blackout lifts terms by STORM_TERM_JUMP
# within a chunk.
ELECTION = dict(heartbeat_ticks=1, election_ticks_min=3, election_ticks_max=5)


def _strip(events, cats):
    """Events of the given categories without their timing and thread."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in events if e.get("cat") in cats]


def _span_samples(sink, prefix):
    return {s["Name"]: s["Count"] for s in sink.snapshot()["Samples"]
            if s["Name"].startswith(prefix)}


# -- the tracer -----------------------------------------------------------

def _script(mod, sink):
    """The same calls on a fresh tracer of ``mod``, its clock pinned to
    whole milliseconds that advance by one per read."""
    tr = mod.Tracer(capacity=8)
    tr.attach_sink(sink)
    with tr.span("outer", cat="host", args={"a": 1}):
        with tr.span("inner"):
            pass
    tr.complete("raw", 10.0, 2.5, cat="cuda", args={"k": "v"}, tid=7)
    tr.instant("mark", cat="raft", args={"x": [1, 2]})
    tr.counter("node0/status", 1.0, 12.0)

    @tr.traced()
    def work():
        return 3

    @tr.traced("named", cat="io")
    def io():
        return 4

    assert work() + io() == 7
    for i in range(3):  # 10 events overflow the ring of 8
        tr.instant(f"fill{i}")
    return tr.to_json(extra_events=[{"name": "extra", "ph": "C", "pid": 2,
                                     "ts": 1.0, "args": {"value": 2.0}}])


def test_tracer_schema_matches_reference(monkeypatch):
    out = {}
    for name, mod, sink in (("ref", jtrace, jtelemetry.Sink()),
                            ("port", ttrace, ttelemetry.Sink())):
        clock = iter(np.arange(1000.0, 2000.0, 0.001).tolist())
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: next(clock)))
        out[name] = (_script(mod, sink), _span_samples(sink, "sim.obs.span"))
    (ref, ref_s), (got, got_s) = out["ref"], out["port"]
    assert got["otherData"].pop("producer") == "consul-tpu-torch obs.trace"
    ref["otherData"].pop("producer")
    assert got == ref
    assert got["otherData"]["dropped_events"] == 2
    assert got_s == ref_s == {"sim.obs.span.outer": 1, "sim.obs.span.inner": 1,
                              "sim.obs.span.raw": 1,
                              "sim.obs.span._script.<locals>.work": 1,
                              "sim.obs.span.named": 1}
    assert ttrace.SCHEMA_VERSION == jtrace.SCHEMA_VERSION


# -- the lens's host half --------------------------------------------------

@pytest.mark.parametrize("sample", [0, -3, 5, 7, N, 400, [3, 1, 2], (N - 1,),
                                    True, [-1], [N], [1, 1]])
def test_normalize_ids_matches_reference(sample):
    try:
        want = jlens.normalize_ids(N, sample)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e), match=re.escape(str(e))):
            tlens.normalize_ids(N, sample)
        return
    assert tlens.normalize_ids(N, sample) == want


def test_recorder_matches_reference():
    rng = np.random.default_rng(0)
    ids, fields = (0, 9, 31), tlens.FIELDS + tlens.RAFT_FIELDS
    assert (tlens.FIELDS, tlens.RAFT_FIELDS, tlens.LENS_PID) == (
        jlens.FIELDS, jlens.RAFT_FIELDS, jlens.LENS_PID)
    ref, got = (m.LensRecorder(ids, tick0=40, fields=fields)
                for m in (jlens, tlens))
    assert got.timelines()[1].shape == ref.timelines()[1].shape == (0, 3, 11)
    for c, (a, b) in zip((4, 2, 3), ((100.0, 180.0), (200.0, 230.0),
                                     (231.5, 400.25))):
        buf = rng.normal(size=(c, 3, 11)).astype(np.float32)
        for rec in (ref, got):
            rec.record(buf, c, a, b)
    assert got.ticks_recorded == ref.ticks_recorded == 9
    (gt, gv), (rt, rv) = got.timelines(), ref.timelines()
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_array_equal(gv, rv)
    assert got.to_json() == ref.to_json()
    assert got.to_trace_events() == ref.to_trace_events()


# -- lens rows against the reference ----------------------------------------

def _pair(kind):
    """The reference's packed simulation and the port's plain one from its
    world, topology, state and key ladder (raft: 2 groups of 3 with the
    reference's raft draws, a proposal and a storm)."""
    jcfg, tcfg = tp.configs(n=N, view_degree=K, gossip=GOSSIP)
    serf_plane = kind == "serf"
    jsim = (JSerfSimulation if serf_plane else JSimulation)(
        jcfg, seed=3, layout="packed")
    base = jsim.base_key
    st = tp.np_tree(jsim.state)
    if serf_plane:
        fn, state = tp.make_serf_draws_fn(jcfg), convert.serf_state_from(st)
        draws = lambda t: tp.to_serf_draws(fn(jax.random.fold_in(base, t)))  # noqa: E731
    else:
        fn, state = (tp.make_draws_fn(jcfg, chaos=kind == "raft"),
                     convert.packed_state_from(st))
        draws = lambda t: tp.to_tick_draws(fn(jax.random.fold_in(base, t)))  # noqa: E731
    tsim = (tcluster.SerfSimulation if serf_plane else tcluster.Simulation)(
        tcfg, seed=3, layout="packed", kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)), state=state,
        draws=draws)
    if kind == "raft":
        kw = dict(groups=2, peers=3, window=16, **ELECTION)
        jr, tr = JRaftConfig(**kw), TRaftConfig(**kw)
        planes = [jsim.set_raft(jr), tsim.set_raft(
            tr,
            draws=lambda t: convert.raft_draws_from(jraft.draw_table(jr, base, t)),
            timers=convert.raft_draws_from(jraft.timeout_draws(
                jr, jraft_mod.init_key_of(jsim), 0, jr.groups)))]
        jsim.set_chaos([jchaos.RaftStorm(start=17, stop=32, group=-1)])
        tsim.set_chaos([tchaos.RaftStorm(17, 32, group=-1)])
        for plane in planes:
            plane.propose([(0, 1, 5)], group=0)
            plane.propose([(0, 2, 6), (0, 3, 7)], group=1)
    return jsim, tsim


def _drive(sim):
    sim.run(CHUNK, chunk=CHUNK, with_metrics=False)
    mask = np.zeros(N, bool)
    mask[:N // 20] = True
    sim.kill(mask)
    sim.run(CHUNK, chunk=CHUNK, with_metrics=False)


@pytest.mark.parametrize("kind", ["swim", "serf", "raft"])
def test_lens_rows_match_reference(kind):
    jsim, tsim = _pair(kind)
    for sim, mod in ((jsim, jlens), (tsim, tlens)):
        assert sim.set_lens(list(IDS)) == IDS
        assert sim.lens.fields == (mod.FIELDS + mod.RAFT_FIELDS
                                   if kind == "raft" else mod.FIELDS)
    jtrace.get_tracer().clear()
    ttrace.get_tracer().clear()
    _drive(jsim)
    _drive(tsim)
    (jt, jv), (tt, tv) = jsim.lens.timelines(), tsim.lens.timelines()
    np.testing.assert_array_equal(tt, jt)
    assert tt.tolist() == list(range(2 * CHUNK)) and tv.shape == jv.shape
    f = {name: i for i, name in enumerate(tsim.lens.fields)}
    exact = [i for name, i in f.items() if name != "vivaldi_error"]
    np.testing.assert_array_equal(tv[..., exact], jv[..., exact])
    v = f["vivaldi_error"]
    steps, diff = tlayout.float_gap(torch.from_numpy(tv[..., v]).bfloat16(),
                                    torch.from_numpy(jv[..., v]).bfloat16())
    assert not bool(((steps > tp.MAX_STEPS) & (diff > tp.FLOOR_S)).any())
    # The window exercises the decoded cases: deaths, open suspicions and
    # probes in flight among the sampled rows.
    assert (tv[..., f["status"]] == 0).any()
    assert (tv[..., f["susp_age"]] > 0).any()
    assert (tv[..., f["probe_deadline_delta"]] >= 0).any()
    assert (tv[..., f["lamport"]] > 0).any() == (kind == "serf")
    # Spans: the chunk brackets and the raft seam, name, category and args;
    # the sinks mirror the same spans.
    cats = {"chunk", "raft"}
    got = _strip(ttrace.get_tracer().events(), cats)
    assert got == _strip(jtrace.get_tracer().events(), cats)
    names = [e["name"] for e in got]
    assert names.count("chunk") == 2
    if kind == "raft":
        assert {"raft.step", "raft.commit", "raft.election_storm"} <= set(names)
        assert (tv[..., f["raft_leader"]] >= 0).any()
    want = {k: c for k, c in _span_samples(jsim.sink, "sim.obs.span").items()
            if "xla" not in k}
    assert _span_samples(tsim.sink, "sim.obs.span") == want
    assert want["sim.obs.span.chunk"] == 2


def _plain(sim_cls, layout, lens):
    sim = sim_cls(TSimConfig(n=N, view_degree=K, packet_loss=0.01), seed=4,
                  kernel="torch", device="cpu", layout=layout)
    if lens:
        sim.set_lens(8)
    _drive(sim)
    return sim


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("cls", [tcluster.Simulation, tcluster.SerfSimulation],
                         ids=["swim", "serf"])
def test_lens_leaves_the_trajectory_unchanged(cls, layout):
    on, off = _plain(cls, layout, True), _plain(cls, layout, False)
    assert on.lens.ticks_recorded == 2 * CHUNK and off.lens is None
    assert on._t == off._t and on.counters == off.counters
    for a, b in zip(tlayout.leaves(on.state), tlayout.leaves(off.state)):
        assert torch.equal(a, b)
    assert torch.equal(on.gen.get_state(), off.gen.get_state())
    if layout == "packed":
        # The plain version of launch L decodes the packed leaves as the
        # codec does: every field equal to the dense snapshot of the
        # unpacked state (viv.error widened from the same bfloat16).
        sw = on._swim_at_rest()
        clock = on._clock_of(on.state)
        got = tlens.snapshot_packed(sw, clock, IDS)
        want = tlens.snapshot(tlayout.unpack(sw), clock, IDS)
        assert torch.equal(got, want)
        assert (got[:, 2] >= 0).any() and (got[:, 3] >= 0).any()
        assert torch.equal(torch.from_numpy(on.lens.timelines()[1][-1]),
                           tlens.snapshot_packed(sw, clock, on.lens.ids))


def test_lens_and_mesh_refuse_each_other():
    cfg = TSimConfig(n=64, view_degree=8)
    sharded = tcluster.Simulation(cfg, kernel="torch", device="cpu",
                                  mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="clear the mesh before arming it"):
        sharded.set_lens(4)
    assert sharded.set_lens(0) == () and sharded.lens is None
    sim = tcluster.Simulation(cfg, kernel="torch", device="cpu")
    sim.set_lens(4)
    sim.mesh = ["cpu"] * 2
    with pytest.raises(ValueError, match=r"set_lens\(0\) before installing"):
        sim._check_mesh()


def test_lens_kernel_refuses_cpu_tensors():
    cfg = TSimConfig(n=64, view_degree=8)
    sim = tcluster.Simulation(cfg, kernel="torch", device="cpu")
    out = torch.empty((2, 7))
    with pytest.raises(ValueError, match="snapshot_packed"):
        cuda_gossip.make_lens_kernel(cfg)(sim.state, None, (0, 1), out)
    assert cuda_gossip.LAUNCHES["lens"] == 0
    assert "lens" not in cuda_gossip.STAGES
    # The bound: per sampled row 9 B of scalars, 2K of meta and of
    # susp_delta, the id, the 28 B row, and the clock when there is one.
    assert cuda_gossip.lens_hbm_bytes(sim.state, (0, 1)) == 2 * (9 + 32 + 4 + 28)
    assert cuda_gossip.lens_hbm_bytes(sim.state, (0,), clock=object()) == 77


# -- spans at the other seams -----------------------------------------------

def _seam_flows(batcher, writes, watch, deltas, monkeypatch, frame):
    """A query pump, a write pump and a watch flip through each module's
    own classes, their device work stubbed alike."""
    sink = types.SimpleNamespace(incr_counter=lambda *a: None)
    plane = types.SimpleNamespace(sink=sink, keys=None)
    qb = batcher.QueryBatcher(plane)
    qb._run_batch = lambda qs: [len(qs)] * len(qs)
    wb = writes.WriteBatcher(plane)
    wb._run_batch = lambda ops: [len(ops)] * len(ops)
    for b, verb in ((qb, lambda: qb.submit(0, 1)), (wb, lambda: wb.submit(1, 2, 3))):
        assert verb() == 1
    wp = watch.WatchPlane(plane, k=4)
    wp.register("node", 3)
    wp.register("any")
    monkeypatch.setattr(deltas, "diff_kernel_for", lambda k: lambda *a: frame)
    wp.on_flip(("s0", "w0"), ("s1", "w1"))


def test_serving_and_watch_spans_match_reference(monkeypatch):
    def frame(mod, arr):
        vals = dict(node_ids=[3, 7, -1, -1], node_kinds=[1, 2, 0, 0],
                    svc_prev=[-1] * 4, svc_cur=[-1] * 4, n_node_changes=2,
                    kv_slots=[-1] * 4, kv_vers=[0] * 4, n_kv_changes=0,
                    apply_index=5, tick=9)
        return mod.DeltaFrame(**{f: arr(np.asarray(vals[f], np.int32))
                                 for f in mod.DeltaFrame._fields})

    out = []
    for mods, tr, arr in (((jbatcher, jwrites, jwatch, jdeltas), jtrace, np.asarray),
                          ((tbatcher, twrites, twatch, tdeltas), ttrace,
                           torch.from_numpy)):
        tr.get_tracer().clear()
        _seam_flows(*mods, monkeypatch, frame(mods[3], arr))
        out.append(_strip(tr.get_tracer().events(), {"serving"}))
    assert out[1] == out[0]
    assert [e["name"] for e in out[1]] == [
        "serving.query_pump", "serving.write_pump", "watch.on_flip"]
    assert out[1][-1]["args"] == {"delivered": 2, "shed": 0}


class _Tree(NamedTuple):
    a: object
    b: object


def test_dcn_and_checkpoint_spans_match_reference(tmp_path):
    jcfg, tcfg = tp.fed_configs(n_dc=2, nodes_per_dc=32, servers_per_dc=2,
                                lan=dict(view_degree=4))
    state = _Tree(np.arange(6, dtype=np.int32).reshape(2, 3),
                  np.ones(4, np.float32))
    out = []
    for mod, tr, ckpt, tree in (
            (jdcn, jtrace, jckpt, _Tree(*map(jax.numpy.asarray, state))),
            (tdcn, ttrace, tckpt, _Tree(*map(torch.from_numpy, state)))):
        kw = {} if mod is jdcn else dict(device="cpu", kernel="torch")
        d = mod.DcnFederation(jcfg if mod is jdcn else tcfg, n_islands=2,
                              seed=0, **kw)
        tr.get_tracer().clear()
        d.sync(ticks=16)
        d.sync(ticks=4)
        path = str(tmp_path / f"{mod.__name__}.ckpt")
        ckpt.save(path, tree)
        ckpt.restore(path, tree)
        out.append(_strip(tr.get_tracer().events(), {"dcn", "io"}))
    assert out[1] == out[0] == [
        {"name": "dcn.sync", "cat": "dcn", "ph": "X",
         "args": {"round": 1, "ticks": 16}},
        {"name": "dcn.sync", "cat": "dcn", "ph": "X",
         "args": {"round": 2, "ticks": 4}},
        {"name": "ckpt.save", "cat": "io", "ph": "X"},
        {"name": "ckpt.restore", "cat": "io", "ph": "X"}]


# -- the black box, the watchdog, the debug bundle ----------------------------

def test_blackbox_matches_reference(monkeypatch):
    keep = ("CUDA_VISIBLE_DEVICES", "NCCL_DEBUG", "TORCH_HOME",
            "PYTORCH_CUDA_ALLOC_CONF", "NVIDIA_DRIVER_CAPABILITIES")
    for k in keep + ("JAX_PLATFORMS_X", "XLA_FLAGS_X", "HOMEX", "PATHX"):
        monkeypatch.setenv(k, "1")
    env = tblackbox.capture_env()
    assert set(keep) <= set(env)
    assert all(k.startswith(tblackbox._ENV_PREFIXES) for k in env)
    assert not {"JAX_PLATFORMS_X", "XLA_FLAGS_X", "HOMEX", "PATHX"} & set(env)
    ttrace.get_tracer().instant("pre-hang.mark")
    got = tblackbox.capture(status="backend-init-hang", child_tail="tail")
    want = jblackbox.capture(status="backend-init-hang", child_tail="tail")
    assert set(got) == set(want) - {"libtpu"} | {"cuda"}
    assert got["schema_version"] == want["schema_version"] == 1
    assert got["child"] == want["child"]
    assert got["spans"][-1]["name"] == "pre-hang.mark"
    assert got["cuda"]["torch"] == torch.__version__
    assert set(got["cuda"]) >= {"torch", "cuda", "driver", "nvcc"}
    assert got["devices"]["torch_imported"] is True
    assert got["devices"]["cuda_initialized"] is False
    assert got["devices"]["devices"] == []
    assert not torch.cuda.is_initialized()


def test_init_watchdog_writes_blackbox(tmp_path):
    ttrace.get_tracer().instant("launch.child")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        watchdog = twd.InitWatchdog(init_window_s=0.2, poll_s=0.05,
                                    blackbox_dir=str(tmp_path / "bb"))
        status = watchdog.watch(
            proc, lambda: False, time.monotonic() + 30.0,
            child_tail=lambda: "phase setup\nlast child line")
    finally:
        proc.kill()
        proc.wait()
    assert status == twd.INIT_HANG
    assert watchdog.blackbox_path is not None
    with open(watchdog.blackbox_path) as f:
        box = json.load(f)
    assert box["status"] == twd.INIT_HANG
    assert isinstance(box["env"], dict) and "cuda" in box
    assert box["child"]["tail"] == "phase setup\nlast child line"
    assert "launch.child" in [e["name"] for e in box["spans"]]


def test_debug_bundle_round_trip(tmp_path):
    sim = tcluster.Simulation(TSimConfig(n=64, view_degree=8), seed=2,
                              kernel="torch", device="cpu")
    sim.set_lens(2)
    sim.run(4, chunk=4)
    trace_dir = str(tmp_path / "trace")
    files = tdebug.capture_sim(sim, profile_ticks=2, trace_dir=trace_dir)
    assert set(files) == {"host.json", "config.json", "health.json",
                          "metrics.json", "spans.json", "lens.json",
                          "profile.json"}
    assert files["host.json"]["Devices"] == "not initialized (host-side capture)"
    assert files["health.json"]["tick"] == 4
    assert files["lens.json"]["ticks"] == [0, 1, 2, 3]
    assert files["profile.json"]["ticks"] == 2
    with open(files["profile.json"]["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sim_chunk" in names
    path = tdebug.write_bundle(str(tmp_path / "bundle.tar.gz"), files,
                               extra_dirs=[trace_dir])
    with tarfile.open(path) as tar:
        assert set(tar.getnames()) >= set(files) | {"trace", "trace/trace.json"}
        lens = json.load(tar.extractfile("lens.json"))
    assert lens == json.loads(json.dumps(files["lens.json"]))
    assert os.path.getsize(path) > 0
