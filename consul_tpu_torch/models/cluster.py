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
from consul_tpu_torch.ops import cuda_gossip, topology
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
    device: str = "cuda"
    world: Optional[topology.World] = None
    topo: Optional[topology.Topology] = None
    state: object = None
    draws: Optional[Callable[[int], swim.TickDraws]] = None
    # The invariant sentinel and the directory of its diagnostic
    # checkpoint, set with set_sentinel.
    sentinel: bool = dataclasses.field(default=False, init=False)
    sentinel_dump_dir: Optional[str] = dataclasses.field(default=None,
                                                         init=False)

    def __post_init__(self):
        layout_mod.validate(self.cfg, self.layout)
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
        if self.draws is None:
            self.draws = self._own_draws
        # Installed fault schedule (None: none), on the simulation's device.
        self.chaos = None
        self._tick_fn = self._make_tick_fn()
        self._metrics_fn = self._make_metrics_fn()
        # Host copy of the tick: one device read here, none per tick.
        self._t = int(layout_mod.tick_of(self.state))
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

    # -- what the driver steps (SerfSimulation overrides these) ----------
    _serf_plane = False
    _step = staticmethod(swim.step_counted)
    _plain_tick = staticmethod(cuda_gossip.plain_tick)

    def _own_draws(self, t):
        return swim.draw_tick(self.cfg, self.gen, self.device,
                              chaos=self.chaos is not None)

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

    def _make_tick_fn(self):
        """``tick(world, state, draws, sched) -> (state, counters[26])``."""
        cfg, topo, sentinel = self.cfg, self.topo, self.sentinel
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
        return layout_mod.swim_plane(self.state)

    def _swim_at_rest(self):
        """The SWIM plane as it is stored (packed or dense), not converted."""
        return self.state.swim if self._serf_plane else self.state

    def generator_state(self) -> dict:
        """The draw generator's state, encoded for JSON (a checkpoint's
        meta carries it, so a resume draws what the run would have)."""
        raw = self.gen.get_state().numpy().tobytes()
        return {"device": self.device.type,
                "state": base64.b64encode(raw).decode("ascii")}

    def load_state(self, state, generator: Optional[dict] = None):
        """Replace the whole simulation state (a restored checkpoint's) and,
        when given, the draw generator's (:meth:`generator_state`)."""
        self.state = state
        self._t = int(layout_mod.tick_of(state))
        if generator is not None:
            if generator["device"] != self.device.type:
                raise ValueError(
                    f"the draw generator's state is a {generator['device']} "
                    f"generator's; this simulation draws on {self.device.type}")
            raw = bytearray(base64.b64decode(generator["state"]))
            self.gen.set_state(torch.frombuffer(raw, dtype=torch.uint8))

    def _to_dense(self):
        return layout_mod.unpack_state(self.state)

    def _from_dense(self, st):
        self.state = (layout_mod.pack_state(st)
                      if self.layout == layout_mod.PACKED else st)

    def set_swim_state(self, st: sim_state.SimState):
        """Replace the SWIM plane with a dense SimState."""
        self._from_dense(st)

    def _mask(self, mask) -> torch.Tensor:
        return torch.as_tensor(mask, dtype=torch.bool).to(self.device)

    # -- fault injection -------------------------------------------------
    def kill(self, mask):
        self._from_dense(sim_state.kill(self.swim_state, self._mask(mask)))

    def revive(self, mask, cold: bool = False):
        self._from_dense(sim_state.revive(self.cfg, self.swim_state,
                                          self._mask(mask), cold=cold))

    def set_chaos(self, sched):
        """Install (or clear, with None) a fault schedule for the ticks
        that follow: a compiled ChaosSchedule or a sequence of entries
        (compiled here). An empty schedule is none. Raft entries raise:
        the raft tier that reads them is not ported (ROADMAP A16)."""
        if sched is not None and not isinstance(sched, chaos_mod.ChaosSchedule):
            sched = chaos_mod.compile_schedule(self.cfg.n, sched)
        if sched is not None and chaos_mod.has_raft_events(sched):
            raise NotImplementedError(
                "the schedule holds raft events; the raft tier is not "
                "ported (ROADMAP A16)")
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
                ckpt_mod.save(dump, self.state, meta={
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

    # -- execution -------------------------------------------------------
    def _exec_chunk(self, c: int, with_metrics: bool):
        """Run ``c`` ticks; returns (counters[26] int32, TickTrace|None),
        both on the device."""
        cnt = torch.zeros((len(counters_mod.FIELDS),), dtype=torch.int32,
                          device=self.device)
        trace = (torch.empty((c, 4), dtype=torch.float32, device=self.device)
                 if with_metrics else None)
        for k in range(c):
            d = self.draws(self._t)
            self.state, cv = self._tick_fn(self.world, self.state, d, self.chaos)
            cnt = cnt + cv
            if with_metrics:
                # The pairs come from a generator of their own, so metrics
                # never move the trajectory.
                self._metric_gen.manual_seed(metric_seed(self.seed, self._t))
                ij = metrics.rmse_samples(self.cfg, self._metric_gen,
                                          RMSE_SAMPLES, self.device)
                self._metrics_fn(*ij, trace[k])
            self._t += 1
        if not with_metrics:
            return cnt, None
        return cnt, TickTrace(*trace.t().contiguous())

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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return ticks / (time.perf_counter() - t0)

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
        telemetry.emit_sim_metrics(
            self._swim_at_rest(), self.sink, health=last, rmse_s=last.rmse,
            rounds_per_sec=(ticks / wall_s if wall_s else None),
            chunk_wall_s=wall_s, chunk_ticks=ticks,
            serf_state=self.state if self._serf_plane else None,
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

    def _init_state(self):
        return serf.init(self.cfg, self.gen, self.device)

    def set_swim_state(self, st: sim_state.SimState):
        self._from_dense(self._to_dense()._replace(swim=st))

    # -- serf verbs (on the dense SWIM plane; _from_dense re-packs) ------
    def user_event(self, mask, name: int):
        self._from_dense(serf.user_event(self.cfg, self._to_dense(),
                                         self._mask(mask), name))

    def query(self, mask, name: int):
        self._from_dense(serf.query(self.cfg, self._to_dense(),
                                    self._mask(mask), name))

    def leave(self, mask):
        self._from_dense(serf.leave(self.cfg, self._to_dense(),
                                    self._mask(mask)))

    def kill(self, mask):
        st = self._to_dense()
        self._from_dense(st._replace(
            swim=sim_state.kill(st.swim, self._mask(mask))))

    def revive(self, mask, cold: bool = False):
        st = self._to_dense()
        self._from_dense(st._replace(
            swim=sim_state.revive(self.cfg, st.swim, self._mask(mask),
                                  cold=cold)))

    @property
    def serf_state(self) -> serf.SerfState:
        """The whole state with a dense SWIM plane (the read-outs of
        models/serf.py take this)."""
        return self._to_dense()
