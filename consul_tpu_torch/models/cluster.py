"""Cluster simulation drivers (PyTorch port of the single-device part of
``consul_tpu/models/cluster.py``): chunked runs, per-chunk counters, a
per-tick metrics trace and convergence detection, for the bare SWIM tick
(``Simulation``, with fault schedules and the invariant sentinel) and the
fused serf tick (``SerfSimulation``).

Metrics come from the packed leaves: on the card launch M of the CUDA
kernel (``cuda_gossip.MetricsKernel``) writes each tick's TickTrace row
into a [C, 4] device buffer, with no host read per tick; on the CPU its
plain version does. Counters of metrics-off runs are deferred and
flushed in one batched transfer when ``counters`` is read (every chunk
while the sentinel is on); each chunk with metrics records the
reference's telemetry into ``Simulation.sink``.

``Simulation(cfg, seed)`` builds the world, topology and state on the
card and steps the packed state through the CUDA tick kernel, on the
sparse view or the dense one (``view_degree=0``, n <= 256). Pass
``device="cpu", kernel="torch"`` for the plain PyTorch path on the CPU.
Nothing falls back: ``kernel="cuda"`` without a CUDA device, or with the
dense layout, raises.

A serving plane (``serving.ServingPlane``, ``attach_serving``) is
republished at every chunk boundary and after a kill or a revive; the
projection draws nothing and writes nothing into the state.

``set_raft`` arms the batched raft tier (``ops/raft_ops.tick``, host
half ``models/raft.RaftPlane``): R groups of P peers stepped after every
gossip tick, keyed on the pre-step tick (the host copy ``_t``), with
their own draws, so arming raft leaves the gossip trajectory as it was.
Raft counters are deferred like the gossip counters; at every chunk
boundary (and after a kill or a revive) the commit pump runs before the
serving republish, so writes staged through a write-attached plane apply
only at quorum commit. Raft entries of a fault schedule (``RaftKill``,
``RaftPartition``, ``RaftStorm``) drive the raft tier's chaos lane.

``sweep`` runs S fault scenarios against the current state, each in a
lane of its own (``_run_lanes``; ``chaos/sweep.py``), and leaves the
simulation where it was.

Observability (``obs/``): every chunk runs inside
``obs.trace.chunk_annotation`` (a ``torch.profiler`` range, an NVTX range
on the card and a host ``chunk`` span, numbered by ``_chunk_seq``), and
the process tracer mirrors its span durations into ``sink``. The spans
bracket the chunk's enqueue, not its completion: the loop issues the
ticks' launches and returns without waiting for the card. ``set_lens``
arms the node lens: after every tick (and its raft tick) one [S, F] row
of the sampled nodes goes into the chunk's [C, S, F] device buffer,
through launch L (``cuda_gossip.LensKernel``) where the tick runs on the
CUDA kernel, through ``obs.lens.snapshot_packed`` / ``snapshot`` on the
plain tick, with the raft fields from ``obs.lens.raft_snapshot``; the
buffers queue on ``self.lens`` (an ``obs.lens.LensRecorder``) and reach
the host in one copy at its flush. The lens draws nothing and writes
nothing into the state.

``mesh=`` (a ``parallel.mesh.Mesh`` or a list of devices, which may
repeat: ``["cuda:0"] * 4``, ``["cpu"] * 4``) shards the node axis: the
world, topology and state are built whole on the mesh's first device
(which ``device`` must name: ``device="cpu"`` with ``["cpu"] * 4``)
from the same generator as on one device, then split into one row block
per shard (``parallel/shard_step.py``), and every chunk runs on the
sharded runner, through the sharded CUDA tick (B7) or the plain tick in
one thread per shard; counters and the one metrics row of a chunk (its
last tick's) match the one-device run's. Kills, revives, the serf verbs
and schedules are placed by row block; ``swim_state`` / ``serf_state``
gather. The raft tier, a serving plane and ``sweep`` raise on a sharded
simulation (ROADMAP A13).

Tests can hand in an initial world, topology and state (``convert.py``
carries the reference's across) and a draw source, a callable from the
tick number to its :class:`swim.TickDraws`; by default the simulation
draws from its own ``torch.Generator``, seeded from ``seed``. A tick with
a fault schedule installed needs ``TickDraws.u_pp``.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional

import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import state as sim_state
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.obs import lens as lens_obs
from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import cuda_gossip, raft_ops, topology
from consul_tpu_torch.parallel import collective as coll
from consul_tpu_torch.parallel import mesh as mesh_mod
from consul_tpu_torch.parallel import shard_step
from consul_tpu_torch.utils import checkpoint as ckpt_mod
from consul_tpu_torch.utils import metrics, telemetry


# Node pairs sampled for the per-tick RMSE (the reference's chunk body
# samples 2048).
RMSE_SAMPLES = 2048


def metric_seed(seed: int, t: int) -> int:
    """The seed of tick ``t``'s RMSE sample pairs: a mix of the
    simulation's seed and the tick number (the counterpart of the
    reference's ``fold_in(tick_key, 1)``), apart from the stream the
    tick's own draws come from."""
    x = (seed * 0x9E3779B97F4A7C15 + t + 1) % (1 << 64)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (x ^ (x >> 31)) >> 1


def _clone(tree):
    """A copy of a state tree (nested NamedTuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


class TickTrace(NamedTuple):
    """Per-tick metrics of one chunk, [C] float32 each."""

    agreement: torch.Tensor
    false_positive: torch.Tensor
    undetected: torch.Tensor
    rmse: torch.Tensor


# Stable names of the chaos SLO counters (the reference's bench keys).
SLO_KEYS = {
    "chaos_fault_ticks": "fault_ticks",
    "chaos_first_suspect_wait": "time_to_first_suspect",
    "chaos_confirm_wait": "time_to_confirm",
    "chaos_heal_wait": "time_to_heal",
    "chaos_false_deaths": "false_positive_deaths",
    "chaos_msgs_dropped": "messages_dropped",
}


class ScenarioResult(NamedTuple):
    """One run_scenario replay: ``slo`` the chaos counters under SLO_KEYS,
    ``counters`` every protocol-event delta over the window, ``trace``
    the TickTrace when metrics were on."""

    slo: dict
    counters: dict
    ticks: int
    trace: object


class SentinelViolation(RuntimeError):
    """The invariant sentinel tripped: ``mask`` has bit i set for each
    counters.SENTINEL_FIELDS[i] with a nonzero tally, ``deltas`` holds
    those tallies over the chunk, ``dump_path`` the diagnostic checkpoint
    written before raising (None without a dump directory)."""

    def __init__(self, mask: int, deltas: dict, dump_path=None):
        self.mask = mask
        self.deltas = {f: deltas.get(f, 0) for f in counters_mod.SENTINEL_FIELDS}
        self.dump_path = dump_path
        tripped = [f for f in counters_mod.SENTINEL_FIELDS if deltas.get(f, 0)]
        where = f"; diagnostic checkpoint: {dump_path}" if dump_path else ""
        super().__init__(
            f"invariant sentinel tripped (mask {mask:#x}): "
            + ", ".join(f"{f}={deltas.get(f, 0)}" for f in tripped) + where)


@dataclasses.dataclass
class Simulation:
    """Owns the world, topology and device state for one simulated DC."""

    cfg: SimConfig
    seed: int = 0
    layout: str = layout_mod.PACKED
    kernel: str = cuda_gossip.CUDA
    # The device; with a mesh, the mesh's first device.
    device: str = "cuda"
    world: Optional[topology.World] = None
    topo: Optional[topology.Topology] = None
    state: object = None
    draws: Optional[Callable[[int], swim.TickDraws]] = None
    # A node-axis mesh (parallel/mesh.Mesh or a list of devices), or None.
    mesh: object = None
    # The invariant sentinel and the directory of its diagnostic
    # checkpoint, set with set_sentinel.
    sentinel: bool = dataclasses.field(default=False, init=False)
    sentinel_dump_dir: Optional[str] = dataclasses.field(default=None,
                                                         init=False)

    # The armed lens's ids (set_lens); () while it is off.
    _lens_ids = ()

    def __post_init__(self):
        layout_mod.validate(self.cfg, self.layout)
        if self.mesh is not None:
            self._check_mesh()
        self.device = torch.device(self.device)
        cuda_gossip.validate_kernel(self.kernel, self.layout, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        # The metric pairs' generator, reseeded every tick (metric_seed).
        self._metric_gen = torch.Generator(device=self.device)
        if self.world is None:
            self.world = topology.make_world(self.cfg, self.gen, self.device)
        if self.topo is None:
            self.topo = topology.make_topology(self.cfg, self.gen, self.device)
        if self.state is None:
            self.state = self._init_state()
        self.state = (layout_mod.pack_state(self.state)
                      if self.layout == layout_mod.PACKED
                      else layout_mod.unpack_state(self.state))
        # Host copy of the tick: one device read here, none per tick.
        self._t = int(layout_mod.tick_of(self.state))
        if self.mesh is not None:
            self.state = shard_step.place(self.mesh, self.state, self.cfg.n)
        # The installed schedule placed by row block (mesh only).
        self._placed_chaos = None
        if self.draws is None:
            self.draws = self._own_draws
        # Installed fault schedule (None: none), on the simulation's device.
        self.chaos = None
        self._tick_fn = self._make_tick_fn()
        self._metrics_fn = self._make_metrics_fn()
        # Reference-named metrics recorded at chunk boundaries.
        self.sink = telemetry.Sink()
        # Cumulative counters (Python ints); metrics-off chunks queue
        # their [26] device vectors here until the next flush.
        self._counters = {f: 0 for f in counters_mod.FIELDS}
        self._pending_counters = []
        self.chunk_counters = []
        # Chunk lengths run once with metrics: the first run of each is
        # recorded without timing (the reference's warmed-shape rule).
        self._warmed = set()
        # The attached serving plane (serving.ServingPlane), or None.
        self.serving = None
        # The raft tier's host half (models/raft.RaftPlane) while armed.
        self.raft = None
        # The node lens: its LensRecorder while armed (set_lens), and the
        # row writer of the armed ids.
        self.lens = None
        self._lens_row = None
        # Chunk sequence number: the step shared by the chunk's profiler
        # range, NVTX range and host span.
        self._chunk_seq = 0
        # Span durations mirror into this simulation's sink (last attach
        # wins: one process-wide tracer).
        obs_trace.get_tracer().attach_sink(self.sink)

    # -- what the driver steps (SerfSimulation overrides these) ----------
    _serf_plane = False
    _step = staticmethod(swim.step_counted)
    _plain_tick = staticmethod(cuda_gossip.plain_tick)

    def _clock_of(self, state):
        """The serf Lamport clock the lens records (none under bare SWIM)."""
        return None

    def _own_draws(self, t):
        return swim.draw_tick(self.cfg, self.gen, self.device,
                              chaos=self.chaos is not None)

    def _check_mesh(self):
        """Normalize ``mesh`` and hold it to the rest of the arguments: the
        node count divides over its shards, ``device`` is its first
        device, and every device takes the kernel."""
        if not isinstance(self.mesh, mesh_mod.Mesh):
            self.mesh = mesh_mod.make_mesh(list(self.mesh))
        if self._lens_ids:
            raise ValueError("the node lens is single-device; "
                             "set_lens(0) before installing a mesh")
        first = self.mesh.devices[0]
        if mesh_mod.as_device(self.device) != first:
            raise ValueError(f"device={self.device!r} disagrees with the "
                             f"mesh, whose first device is {first}")
        mesh_mod.check_rows(self.cfg.n, self.mesh.size)
        if self.layout != layout_mod.PACKED:
            raise ValueError("a sharded simulation keeps the packed layout")
        for dev in self.mesh.unique_devices():
            cuda_gossip.validate_kernel(self.kernel, self.layout, dev)
        self.device = first

    def _no_mesh(self, what: str):
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a sharded simulation waits for the rest of the "
                "multi-GPU port (ROADMAP A13)")

    def _make_metrics_fn(self):
        """``metrics(i, j, row)``: the tick's TickTrace row into ``row``, a
        [4] float32 tensor. Launch M where the tick runs on the CUDA
        kernel, its plain version where it runs the plain tick (on the
        CPU or the card), both over the packed leaves; the dense layout's
        own metrics otherwise."""
        cfg, topo = self.cfg, self.topo
        if self.layout != layout_mod.PACKED:
            def dense(i, j, row):
                sw = self.swim_state
                h = metrics.health(cfg, topo, sw)
                rmse = metrics.vivaldi_rmse(cfg, self.world, sw, i, j)
                row.copy_(torch.stack([h.agreement, h.false_positive,
                                       h.undetected, rmse]))
            return dense
        if self.kernel == cuda_gossip.CUDA:
            kernel = cuda_gossip.make_metrics_kernel(cfg, topo)
            return lambda i, j, row: kernel(self.world, self._swim_at_rest(),
                                            i, j, row)
        return lambda i, j, row: row.copy_(cuda_gossip.plain_metrics(
            cfg, topo, self.world, self._swim_at_rest(), i, j))

    def _init_state(self):
        return sim_state.init(self.cfg, self.gen, self.device)

    def _make_tick_fn(self, sentinel: Optional[bool] = None):
        """``tick(world, state, draws, sched) -> (state, counters[26])``,
        with the invariant sentinel as set (``sentinel=None``) or as
        given. The tick writes fresh tensors and never its input."""
        cfg, topo = self.cfg, self.topo
        sentinel = self.sentinel if sentinel is None else sentinel
        if self.mesh is not None:
            # The sharded chunk runner (its own metrics, once per chunk).
            return shard_step.make_sharded_chunk_runner(
                cfg, topo, self.mesh, self.world, serf_plane=self._serf_plane,
                sentinel=sentinel, kernel=self.kernel)
        if self.kernel == cuda_gossip.CUDA:
            return cuda_gossip.make_tick_kernel(
                cfg, topo, serf_plane=self._serf_plane, sentinel=sentinel)
        plain, step = self._plain_tick, self._step
        if self.layout == layout_mod.PACKED:
            return lambda w, s, d, sched: plain(cfg, topo, w, s, d, sched,
                                                sentinel)

        def dense_tick(w, s, d, sched):
            s, c = step(cfg, topo, w, s, d, sched=sched, sentinel=sentinel)
            return s, counters_mod.stack(c)
        return dense_tick

    # -- state access ----------------------------------------------------
    @property
    def swim_state(self) -> sim_state.SimState:
        return layout_mod.swim_plane(self._whole())

    def _whole(self):
        """The state at rest, whole: gathered from the shards under a mesh."""
        if self.mesh is None:
            return self.state
        return shard_step.gather(self.state, self.cfg.n, self.device)

    def _swim_at_rest(self, whole=None):
        """The SWIM plane as it is stored (packed or dense), not converted."""
        whole = self._whole() if whole is None else whole
        return whole.swim if self._serf_plane else whole

    def generator_state(self) -> dict:
        """The draw generator's state, encoded for JSON (a checkpoint's
        meta carries it, so a resume draws what the run would have)."""
        raw = self.gen.get_state().numpy().tobytes()
        return {"device": self.device.type,
                "state": base64.b64encode(raw).decode("ascii")}

    def load_state(self, state, generator: Optional[dict] = None):
        """Replace the whole simulation state (a restored checkpoint's) and,
        when given, the draw generator's (:meth:`generator_state`)."""
        self._t = int(layout_mod.tick_of(state))
        self.state = (state if self.mesh is None
                      else shard_step.place(self.mesh, state, self.cfg.n))
        if generator is not None:
            if generator["device"] != self.device.type:
                raise ValueError(
                    f"the draw generator's state is a {generator['device']} "
                    f"generator's; this simulation draws on {self.device.type}")
            raw = bytearray(base64.b64decode(generator["state"]))
            self.gen.set_state(torch.frombuffer(raw, dtype=torch.uint8))

    def _to_dense(self):
        return layout_mod.unpack_state(self._whole())

    def _from_dense(self, st):
        st = layout_mod.pack_state(st) if self.layout == layout_mod.PACKED else st
        self.state = (st if self.mesh is None
                      else shard_step.place(self.mesh, st, self.cfg.n))

    def _edit(self, fn, mask):
        """Apply ``fn(dense_state, mask) -> dense_state`` (a row-local edit:
        a kill, a revive, a serf verb) to the state; under a mesh to each
        shard's block with its rows of ``mask`` (the reference's
        ``_place_node`` funnel), inside the shard's row context so that
        ``collective.rows`` gives global ids, the edited blocks copied back
        into their adjacent placement (``shard_step.adjoin``)."""
        mask = self._mask(mask)
        if self.mesh is None:
            self._from_dense(fn(self._to_dense(), mask))
            return
        r, n = self.mesh.size, self.cfg.n
        masks = shard_step.place(self.mesh, mask, n)
        blocks = []
        for d, blk in enumerate(self.state):
            with coll.node_axis(r, n, d):
                st = fn(layout_mod.unpack_state(blk), masks[d])
            blocks.append(layout_mod.pack_state(st))
        self.state = shard_step.adjoin(self.mesh, blocks, n)

    def set_swim_state(self, st: sim_state.SimState):
        """Replace the SWIM plane with a dense SimState."""
        self._from_dense(st)

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(mask, dtype=torch.bool).to(self.device)

    # -- serving plane ---------------------------------------------------
    def attach_serving(self, plane, writes: bool = False,
                       kv_slots: int = 256, **write_kw):
        """Attach a serving plane (consul_tpu_torch/serving): it publishes a
        snapshot now and again at every chunk boundary, after a kill and a
        revive. With ``writes=True`` the write path and the watch plane
        come up too (``plane.attach_writes``): batched catalog/KV/session
        writes apply between chunks, become visible at flips, and every
        flip carries the monotone apply index."""
        self._no_mesh("a serving plane")
        plane.attach(self)
        if writes:
            plane.attach_writes(kv_slots=kv_slots, **write_kw)

    def publish_serving(self):
        """Republish the serving snapshot from the current state (nothing
        without a plane). The projection copies what it reads and draws
        nothing, so it moves neither the state nor any generator, and a
        published snapshot outlives the ticks that follow. With the raft
        tier armed, the commit pump runs first: quorum-committed
        proposals apply to the write state here, so the flip is
        consistent as of the committed prefix."""
        if self.raft is not None:
            self.raft.pump()
        if self.serving is not None:
            self.serving.publish(self)

    # -- raft tier -------------------------------------------------------
    def set_raft(self, groups=None, draws=None, timers=None, **kw):
        """Arm (or clear, with None) the batched raft tier for the ticks
        that follow: ``groups`` is a group count (the other RaftConfig
        knobs in ``kw``) or a RaftConfig. Arming builds a fresh
        :class:`~consul_tpu_torch.models.raft.RaftPlane`; ``draws`` (tick
        -> [R, P] int32 timeouts) and ``timers`` (the initial [R, P]
        timeouts) replace its own draws, as ``Simulation.draws`` does the
        gossip tick's. Returns the RaftPlane (None when cleared)."""
        from consul_tpu_torch.config import RaftConfig
        from consul_tpu_torch.models import raft as raft_mod

        if groups is not None:
            self._no_mesh("the raft tier")
        if groups is None:
            self.raft = None
            self._restart_lens()
            return None
        rcfg = (groups if isinstance(groups, RaftConfig)
                else RaftConfig(groups=int(groups), **kw))
        self.raft = raft_mod.RaftPlane(self, rcfg, draws=draws, timers=timers)
        self._restart_lens()
        return self.raft

    # -- node lens -------------------------------------------------------
    def set_lens(self, sample) -> tuple:
        """Arm (or clear, with ``0`` / empty) the node lens for the ticks
        that follow: ``sample`` is an int count (evenly spaced ids) or an
        id list (``obs.lens.normalize_ids``). Arming starts a fresh
        :class:`~consul_tpu_torch.obs.lens.LensRecorder` at the live
        tick, with the raft fields while the raft tier is armed. Returns
        the resolved id tuple."""
        ids = lens_obs.normalize_ids(self.cfg.n, sample)
        if ids and self.mesh is not None:
            raise ValueError("the node lens is single-device; clear "
                             "the mesh before arming it")
        self._lens_ids = ids
        self._restart_lens()
        return ids

    def _restart_lens(self):
        """A fresh recorder and row writer for the armed ids, with the raft
        fields while raft is armed (its field layout changes with raft)."""
        ids = self._lens_ids
        if not ids:
            self.lens, self._lens_row = None, None
            return
        fields = lens_obs.FIELDS + (lens_obs.RAFT_FIELDS
                                    if self.raft is not None else ())
        self.lens = lens_obs.LensRecorder(ids, tick0=self._t, fields=fields)
        self._lens_row = self._make_lens_row(ids)

    def _make_lens_row(self, ids):
        """``row(state, rst, out)``: the lens row of ``state`` (as stored)
        into ``out``, an [S, F] float32 row of the chunk's buffer: launch L
        where the tick runs on the CUDA kernel, its plain version
        (``snapshot_packed``) on the plain packed tick, ``snapshot`` on the
        dense layout; then the raft columns of ``rst`` unless it is None."""
        idx = torch.tensor(ids, dtype=torch.int64, device=self.device)
        width = len(lens_obs.FIELDS)
        if self.kernel == cuda_gossip.CUDA:
            kernel = cuda_gossip.make_lens_kernel(self.cfg)

            def swim_row(state, out):
                kernel(self._swim_at_rest(state), self._clock_of(state), ids,
                       out)
        else:
            snap = (lens_obs.snapshot_packed if self.layout == layout_mod.PACKED
                    else lens_obs.snapshot)

            def swim_row(state, out):
                out.copy_(snap(self._swim_at_rest(state), self._clock_of(state),
                               idx))

        def row(state, rst, out):
            swim_row(state, out[:, :width])
            if rst is not None:
                out[:, width:].copy_(lens_obs.raft_snapshot(rst, idx))
        return row

    # -- fault injection -------------------------------------------------
    def kill(self, mask):
        self._edit(sim_state.kill, mask)
        self.publish_serving()

    def revive(self, mask, cold: bool = False):
        self._edit(lambda st, m: sim_state.revive(self.cfg, st, m, cold=cold),
                   mask)
        self.publish_serving()

    def set_chaos(self, sched):
        """Install (or clear, with None) a fault schedule for the ticks
        that follow: a compiled ChaosSchedule or a sequence of entries
        (compiled here). An empty schedule is none. Raft entries drive the
        raft tier's chaos lane; a schedule that holds only those still
        runs the gossip tick's chaos variant, as the reference's does."""
        if sched is not None and not isinstance(sched, chaos_mod.ChaosSchedule):
            sched = chaos_mod.compile_schedule(self.cfg.n, sched)
        sched = chaos_mod.or_none(sched)
        self.chaos = (None if sched is None
                      else chaos_mod.to_device(sched, self.device))

    def set_sentinel(self, on: bool, dump_dir: Optional[str] = None):
        """Toggle the invariant sentinel for the ticks that follow: every
        chunk's counters are flushed, and a nonzero sentinel tally raises
        SentinelViolation, after writing a diagnostic checkpoint of the
        state into ``dump_dir`` when one is set."""
        if dump_dir is not None:
            self.sentinel_dump_dir = dump_dir
        if bool(on) != self.sentinel:
            self.sentinel = bool(on)
            self._tick_fn = self._make_tick_fn()

    def _check_sentinel(self, deltas):
        if not self.sentinel:
            return
        mask = counters_mod.violation_mask(deltas)
        if not mask:
            return
        self.sink.incr_counter("sim.sentinel.trips", 1)
        dump = None
        if self.sentinel_dump_dir:
            dump = ckpt_mod.diagnostic_dump_path(self.sentinel_dump_dir,
                                                 self._t)
            try:
                os.makedirs(self.sentinel_dump_dir, exist_ok=True)
                ckpt_mod.save(dump, self._whole(), meta={
                    "reason": "sentinel", "mask": mask,
                    "deltas": {f: int(deltas.get(f, 0))
                               for f in counters_mod.SENTINEL_FIELDS},
                    "t": self._t, "n": self.cfg.n})
            except (OSError, ValueError):
                dump = None  # the diagnostic must not mask the trip
        raise SentinelViolation(mask, deltas, dump)

    def run_scenario(self, events, ticks=None, chunk: int = 64,
                     with_metrics: bool = False, settle: int = 64):
        """Replay a relative fault schedule from the current tick: compile
        ``events``, rebase them onto the live tick, run ``ticks`` ticks
        (default: the last stop plus ``settle``), uninstall, and return a
        ScenarioResult with the chaos counters under SLO_KEYS."""
        sched = chaos_mod.compile_schedule(self.cfg.n, events)
        if ticks is None:
            stops = [int(e.stop) for e in events]
            ticks = (max(stops) if stops else 0) + settle
        prev = self.chaos
        self.set_chaos(chaos_mod.shift_schedule(sched, self._t))
        before = dict(self.counters)
        try:
            trace = self.run(ticks, chunk=chunk, with_metrics=with_metrics)
        finally:
            self.chaos = prev
        deltas = {f: self.counters[f] - before[f] for f in counters_mod.FIELDS}
        return ScenarioResult(slo={SLO_KEYS[f]: deltas[f] for f in SLO_KEYS},
                              counters=deltas, ticks=ticks, trace=trace)

    def sweep(self, scenarios, *, ticks=None, chunk: int = 32,
              settle: int = 64):
        """Run S fault scenarios against the current state, each in a lane
        of its own (``chaos/sweep.run_sweep``): the simulation does not
        advance, and each lane's counters equal a solo
        :meth:`run_scenario` replay from the same state and draw
        generator. Returns one row per scenario, in input order.
        ``chunk`` is taken for the reference's signature and not used."""
        from consul_tpu_torch.chaos import sweep as sweep_mod

        self._no_mesh("a sweep")
        return sweep_mod.run_sweep(self, scenarios, ticks=ticks, chunk=chunk,
                                   settle=settle)

    def _run_lanes(self, scheds, ticks: int):
        """Step one lane per schedule (compiled, shifted onto ``_t``, on the
        device) for ``ticks`` ticks from copies of the live state, with the
        sentinel off. Tick outer, lane inner: every lane takes the tick's
        one draw bundle, drawn as a schedule-armed tick draws it (with
        ``u_pp``), and with raft armed the tick's one raft draw. Returns
        ``(states, counters [S, 26] int64, raft)``, raft being None or
        ``(raft states, raft counters [S, 8] int32)``, all on the device;
        nothing is read back. The state, ``_t``, the draw generator, the
        counters and the raft plane are as they were before."""
        self._no_mesh("a sweep")
        tick = self._make_tick_fn(sentinel=False)
        lanes = len(scheds)
        states = [_clone(self.state) for _ in range(lanes)]
        # int64: a 1M-node lane sends more than 2**31 messages within ~1,000
        # ticks; the int32 tick counters add up exactly here, as a solo
        # replay's chunks do on the host.
        cnt = torch.zeros((lanes, len(counters_mod.FIELDS)), dtype=torch.int64,
                          device=self.device)
        raft = self.raft
        if raft is not None:
            rsts = [_clone(raft.take_state()) for _ in range(lanes)]
            rcnt = torch.zeros((lanes, len(raft_ops.FIELDS)),
                               dtype=torch.int32, device=self.device)
        # The draw generator is a running stream: the lanes' draws must not
        # move it, so a sweep leaves the trajectory where it was.
        gen_state = self.gen.get_state()
        # Installed for the ticks' draws only: the simulation's own draws
        # add u_pp while a schedule is installed, as a solo replay's do.
        prev = self.chaos
        self.chaos = scheds[0]
        try:
            for t in range(self._t, self._t + ticks):
                d = self.draws(t)
                rd = raft.draws(t) if raft is not None else None
                for s, sched in enumerate(scheds):
                    states[s], cv = tick(self.world, states[s], d, sched)
                    cnt[s] += cv
                    if raft is not None:
                        rsts[s], rc = raft_ops.tick(raft.rcfg, rsts[s], t, rd,
                                                    sched)
                        rcnt[s] += raft_ops.counters_stack(rc)
        finally:
            self.chaos = prev
            self.gen.set_state(gen_state)
        return states, cnt, (None if raft is None else (rsts, rcnt))

    # -- execution -------------------------------------------------------
    def _exec_chunk(self, c: int, with_metrics: bool):
        """Run ``c`` ticks inside the chunk's observability bracket
        (``obs.trace.chunk_annotation``, step ``_chunk_seq``); returns
        (counters[26] int32, TickTrace|None), both on the device. With raft
        armed, the raft tick follows each gossip tick and the chunk's [8]
        raft counters queue on the RaftPlane. With the lens armed, the
        chunk's [C, S, F] lens buffer queues on ``self.lens`` with the
        chunk's host window. Under a mesh the trace has one row, the last
        tick's. The bracket spans the enqueue: nothing here waits for the
        card."""
        tr = obs_trace.get_tracer()
        t0_us = tr.now_us()
        step = self._chunk_seq
        self._chunk_seq += 1
        lens = self.lens
        with obs_trace.chunk_annotation(step, c, self.device):
            if self.mesh is not None:
                return self._exec_sharded_chunk(c, with_metrics)
            lbuf = None if lens is None else torch.empty(
                (c, len(lens.ids), len(lens.fields)), dtype=torch.float32,
                device=self.device)
            out = self._exec_ticks(c, with_metrics, lbuf)
        if lens is not None:
            lens.record(lbuf, c, t0_us, tr.now_us())
        return out

    def _exec_ticks(self, c: int, with_metrics: bool, lbuf):
        """The one-device loop of :meth:`_exec_chunk`: ``c`` ticks, the
        lens row of tick k into ``lbuf[k]`` unless ``lbuf`` is None."""
        cnt = torch.zeros((len(counters_mod.FIELDS),), dtype=torch.int32,
                          device=self.device)
        trace = (torch.empty((c, 4), dtype=torch.float32, device=self.device)
                 if with_metrics else None)
        raft = self.raft
        if raft is not None:
            rst = raft.take_state()
            rcnt = torch.zeros((len(raft_ops.FIELDS),), dtype=torch.int32,
                               device=self.device)
        for k in range(c):
            d = self.draws(self._t)
            self.state, cv = self._tick_fn(self.world, self.state, d, self.chaos)
            cnt = cnt + cv
            if raft is not None:
                # Keyed on the pre-step tick, as the reference's is.
                rst, rc = raft_ops.tick(raft.rcfg, rst, self._t,
                                        raft.draws(self._t), self.chaos)
                rcnt = rcnt + raft_ops.counters_stack(rc)
            if lbuf is not None:
                self._lens_row(self.state, rst if raft is not None else None,
                               lbuf[k])
            if with_metrics:
                # The pairs come from a generator of their own, so metrics
                # never move the trajectory.
                self._metric_gen.manual_seed(metric_seed(self.seed, self._t))
                ij = metrics.rmse_samples(self.cfg, self._metric_gen,
                                          RMSE_SAMPLES, self.device)
                self._metrics_fn(*ij, trace[k])
            self._t += 1
        if raft is not None:
            raft.state = rst
            raft.absorb(rcnt)
        if not with_metrics:
            return cnt, None
        return cnt, TickTrace(*trace.t().contiguous())

    def _sched_blocks(self):
        """The installed schedule, placed by row block (cached per
        schedule)."""
        if self.chaos is None:
            return None
        if self._placed_chaos is None or self._placed_chaos[0] is not self.chaos:
            self._placed_chaos = (self.chaos, shard_step.place_schedule(
                self.mesh, self.chaos, self.cfg.n))
        return self._placed_chaos[1]

    def _exec_sharded_chunk(self, c: int, with_metrics: bool):
        """``c`` ticks on the sharded runner; metrics (one row) on the final
        state with the pairs the one-device run's last row takes."""
        pairs = None
        if with_metrics:
            self._metric_gen.manual_seed(metric_seed(self.seed, self._t + c - 1))
            pairs = metrics.rmse_samples(self.cfg, self._metric_gen,
                                         RMSE_SAMPLES, self.device)
        self.state, cnt, trace = self._tick_fn.run(
            self.state, self.draws, self._t, c, self._sched_blocks(), pairs)
        self._t += c
        return cnt, trace

    def run(self, ticks: int, chunk: int = 64, with_metrics: bool = True):
        """Advance ``ticks`` ticks; returns the concatenated TickTrace (None
        when metrics are off). A chunk without metrics reads nothing back:
        its counters wait for the next flush (every chunk while the
        sentinel is on)."""
        traces = []
        remaining = ticks
        while remaining > 0:
            c = min(chunk, remaining)
            t0 = time.perf_counter()
            cnt, trace = self._exec_chunk(c, with_metrics)
            if with_metrics:
                traces.append(trace)
                self._record_chunk(trace, cnt, c, t0)
            else:
                self._pending_counters.append(cnt)
                if self.sentinel:
                    self._flush_counters()
            self.publish_serving()
            remaining -= c
        if not with_metrics:
            return None
        return TickTrace(*(torch.cat(x) for x in zip(*traces)))

    def run_until_converged(self, max_ticks: int, chunk: int = 64,
                            rmse_target_s: Optional[float] = None,
                            require_agreement: float = 1.0,
                            stable_chunks: int = 1):
        """Run until membership agreement (and optionally Vivaldi RMSE)
        hold for ``stable_chunks`` consecutive chunks. Returns
        (converged, ticks_used, last_trace)."""
        used = 0
        streak = 0
        trace = None
        while used < max_ticks:
            c = min(chunk, max_ticks - used)
            t0 = time.perf_counter()
            cnt, trace = self._exec_chunk(c, True)
            self._record_chunk(trace, cnt, c, t0)
            self.publish_serving()
            used += c
            ok = float(trace.agreement[-1]) >= require_agreement
            if ok and rmse_target_s is not None:
                ok = float(trace.rmse[-1]) <= rmse_target_s
            streak = streak + 1 if ok else 0
            if streak >= stable_chunks:
                return True, used, trace
        return False, used, trace

    def throughput(self, ticks: int = 256) -> float:
        """Ticks per wall-clock second without metrics, after one warm
        chunk of the same length."""
        for timed in (False, True):
            if timed:
                t0 = time.perf_counter()
            cnt, _ = self._exec_chunk(ticks, False)
            self._pending_counters.append(cnt)
            for dev in (self.mesh.unique_devices() if self.mesh is not None
                        else [self.device]):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        rate = ticks / (time.perf_counter() - t0)
        self.publish_serving()
        return rate

    # -- counters and telemetry ------------------------------------------
    @property
    def counters(self):
        """Cumulative protocol-event totals (Python ints by field name),
        after flushing the deferred chunks."""
        self._flush_counters()
        return self._counters

    def counters_snapshot(self) -> dict:
        """A copy of :attr:`counters`, safe to serialize."""
        return dict(self.counters)

    def _flush_counters(self, extra=None):
        """One batched device -> host transfer of every deferred chunk's
        counters and, with ``extra``, the current chunk's, whose deltas
        are returned unfolded. Each chunk's deltas join
        ``chunk_counters``; the deferred ones fold as one sum."""
        pending = self._pending_counters
        if not pending and extra is None:
            return None
        self._pending_counters = []
        rows = torch.stack(pending + ([] if extra is None else [extra])).tolist()
        fields = counters_mod.FIELDS
        if pending:
            self.chunk_counters += [dict(zip(fields, r)) for r in rows[:len(pending)]]
            total = [sum(col) for col in zip(*rows[:len(pending)])]
            self._fold_counter_deltas(dict(zip(fields, total)))
        return None if extra is None else dict(zip(fields, rows[-1]))

    def _fold_counter_deltas(self, deltas: dict):
        for f, v in deltas.items():
            self._counters[f] += v
        telemetry.emit_counter_deltas(self.sink, deltas)
        self._check_sentinel(deltas)

    def _record_chunk(self, trace: TickTrace, cnt, ticks: int, t0: float):
        """Fold one chunk with metrics: its counters (with any deferred
        ones, one transfer) and the reference's telemetry of the chunk
        boundary (one more). The first chunk of each length is recorded
        without timing, as the reference's first run of a program shape
        is (it compiles there; here it builds the kernel)."""
        deltas = self._flush_counters(extra=cnt)
        key = (ticks, True)
        if key in self._warmed:
            wall_s: Optional[float] = time.perf_counter() - t0
        else:
            self._warmed.add(key)
            wall_s = None
        for f, v in deltas.items():
            self._counters[f] += v
        self.chunk_counters.append(deltas)
        last = TickTrace(*(x[-1] for x in trace))
        whole = self._whole()
        telemetry.emit_sim_metrics(
            self._swim_at_rest(whole), self.sink, health=last,
            rmse_s=last.rmse,
            rounds_per_sec=(ticks / wall_s if wall_s else None),
            chunk_wall_s=wall_s, chunk_ticks=ticks,
            serf_state=whole if self._serf_plane else None,
            queue_depth_warning=self.cfg.serf.queue_depth_warning,
            counters=deltas)
        self._check_sentinel(deltas)

    # -- inspection ------------------------------------------------------

    def health(self) -> metrics.HealthMetrics:
        return metrics.health(self.cfg, self.topo, self.swim_state)

    def rmse(self, seed: int = 99) -> float:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        i, j = metrics.rmse_samples(self.cfg, gen, 4096, self.device)
        return float(metrics.vivaldi_rmse(self.cfg, self.world,
                                          self.swim_state, i, j))


@dataclasses.dataclass
class SerfSimulation(Simulation):
    """The full-stack driver: ``serf.step_counted`` (SWIM + events +
    queries + reap) instead of the bare SWIM tick, with the serf verbs.
    Metrics and convergence read the SWIM plane. ``draws`` maps the tick
    number to a :class:`serf.SerfDraws` (``draw_serf_tick(..., chaos=True)``
    while a schedule is installed); by default the simulation draws from
    its own generator. ``kernel="cuda"`` runs the serf variant of the CUDA
    tick kernel; ``set_chaos``, ``run_scenario`` and ``set_sentinel`` are
    Simulation's, over the serf tick."""

    _serf_plane = True
    _step = staticmethod(serf.step_counted)
    _plain_tick = staticmethod(cuda_gossip.plain_serf_tick)

    def _own_draws(self, t):
        return serf.draw_serf_tick(self.cfg, self.gen, self.device,
                                   chaos=self.chaos is not None)

    def _clock_of(self, state):
        return state.clock

    def _init_state(self):
        return serf.init(self.cfg, self.gen, self.device)

    def set_swim_state(self, st: sim_state.SimState):
        self._from_dense(self._to_dense()._replace(swim=st))

    # -- serf verbs (on the dense SWIM plane; the edit re-packs) ----------
    def user_event(self, mask, name: int):
        self._edit(lambda st, m: serf.user_event(self.cfg, st, m, name), mask)

    def query(self, mask, name: int):
        self._edit(lambda st, m: serf.query(self.cfg, st, m, name), mask)

    def leave(self, mask):
        self._edit(lambda st, m: serf.leave(self.cfg, st, m), mask)

    def kill(self, mask):
        self._edit(lambda st, m: st._replace(swim=sim_state.kill(st.swim, m)),
                   mask)
        self.publish_serving()

    def revive(self, mask, cold: bool = False):
        self._edit(lambda st, m: st._replace(swim=sim_state.revive(
            self.cfg, st.swim, m, cold=cold)), mask)
        self.publish_serving()

    def rejoin(self, node: int, rep):
        """Warm restart of ``node`` from a replayed snapshot
        (``models/snapshot.rejoin``; a ``snapshot.Replay``)."""
        from consul_tpu_torch.models import snapshot

        self._no_mesh("a snapshot rejoin")
        self._from_dense(snapshot.rejoin(self.cfg, self.topo, self._to_dense(),
                                         node, rep))
        self.publish_serving()

    @property
    def serf_state(self) -> serf.SerfState:
        """The whole state with a dense SWIM plane (the read-outs of
        models/serf.py take this)."""
        return self._to_dense()


# The configuration of the reference's tick kernel that runs the oracle's
# step: reachable there only through ``set_kernel("pallas")`` on
# ReferenceSerfSimulation, and not ported (PERF.md's kernel table, B8).
B8_UNPORTED = ("step_fn=serf.step_reference_counted inside the tick kernel "
               "(consul_tpu/ops/pallas_gossip.py:145, B8)")


def plain_reference_serf_tick(cfg: SimConfig, topo, world, packed, draws,
                              sched=None, sentinel: bool = False):
    """The pre-fusion tick on the packed layout:
    ``unpack_state -> serf.step_reference_counted -> pack_state`` and the
    stacked [26] int32 counters."""
    state, cnt = serf.step_reference_counted(
        cfg, topo, world, layout_mod.unpack_state(packed), draws,
        sched=sched, sentinel=sentinel)
    return layout_mod.pack_state(state), counters_mod.stack(cnt)


@dataclasses.dataclass
class ReferenceSerfSimulation(SerfSimulation):
    """SerfSimulation on the pre-fusion tick (``serf.step_reference_counted``,
    reference cluster.py:1161-1169): the event/query plane runs as its own
    sweep after the SWIM tick. The oracle the fused tick is held to, not a
    production path. It runs as plain PyTorch (``kernel="torch"``), on the
    card by default; ``kernel="cuda"`` raises, naming the configuration
    that would run it there (B8, not ported), and a mesh raises too.

    ``draws`` maps the tick number to a :class:`serf.ReferenceSerfDraws`.
    By default the fused tick's numbers come from the simulation's
    generator, exactly as a ``SerfSimulation`` of the same seed draws them
    (so both see the same SWIM draws), and the event sweep's columns and
    loss draws from a second generator seeded from ``seed``."""

    kernel: str = cuda_gossip.TORCH

    _step = staticmethod(serf.step_reference_counted)
    _plain_tick = staticmethod(plain_reference_serf_tick)

    def __post_init__(self):
        if self.kernel == cuda_gossip.CUDA:
            raise ValueError(
                "ReferenceSerfSimulation runs as plain PyTorch only: "
                f"{B8_UNPORTED} is not ported; pass kernel='torch'")
        if self.mesh is not None:
            raise ValueError("ReferenceSerfSimulation runs on one device "
                             "(the sharded serf runner steps the fused tick)")
        self._ev_gen = torch.Generator(device=torch.device(self.device))
        self._ev_gen.manual_seed(metric_seed(self.seed, -2))
        super().__post_init__()

    def _own_draws(self, t):
        return serf.draw_reference_tick(self.cfg, self.gen, self._ev_gen,
                                        self.device,
                                        chaos=self.chaos is not None)

    def generator_state(self) -> dict:
        """Both draw generators' states: the SWIM draws' and the event
        sweep's, so a resume draws what the run would have."""
        enc = super().generator_state()
        enc["event_state"] = base64.b64encode(
            self._ev_gen.get_state().numpy().tobytes()).decode("ascii")
        return enc

    def load_state(self, state, generator: Optional[dict] = None):
        """Simulation.load_state, with the event sweep's generator put back
        too; a generator state without it is refused (it would resume the
        event draws from wherever they stand)."""
        if generator is not None and "event_state" not in generator:
            raise ValueError("the draw generator's state lacks the event "
                             "sweep's generator (not a "
                             "ReferenceSerfSimulation's)")
        super().load_state(state, generator)
        if generator is not None:
            raw = bytearray(base64.b64decode(generator["event_state"]))
            self._ev_gen.set_state(torch.frombuffer(raw, dtype=torch.uint8))

    def _run_lanes(self, scheds, ticks: int):
        """Simulation._run_lanes, with the event sweep's generator put back
        too, so a sweep leaves the trajectory where it was."""
        ev_state = self._ev_gen.get_state()
        try:
            return super()._run_lanes(scheds, ticks)
        finally:
            self._ev_gen.set_state(ev_state)
