"""Federated game day: the full stack under one composed drill (PyTorch
port of ``consul_tpu/gameday/harness.py``).

One run exercises every claim at once: a ``Simulation`` with the raft
tier armed and the serving write path and watch plane attached takes
sustained mixed R:W:Watch traffic while a composed fault timeline
(Partition + ChurnWave + a leader-killing RaftKill on ONE compiled
schedule) plays through the middle of it, a DCN-federated leg of islands
heals link faults on its WAN tier, and the phase clock walks

    warmup -> steady -> fault -> heal -> drain

sampling per-class latency throughout. The output is one SLO verdict
(``gameday/slo.py``): per-class p99s, ``lost_writes`` (must be 0: every
acknowledged ledger write reads back after the drain, and the
X-Consul-Index samples are monotone across the leader-kill window),
``max_time_to_heal_ticks`` (the chaos heal counter's delta over the fault
and heal phases), watch delivery lag, and shed / reject counts.

On the card the phases run the CUDA tick: warmup and steady its bare
variant, fault and heal its schedule variant (the raft lane rides the
same schedule), the DCN leg the bare variant on the islands' LAN pools
and the dense one on their WAN pool. ``GamedayConfig(device="cpu",
kernel="torch")`` runs the plain PyTorch path on the CPU.

Traffic drives either host front end: the threaded one (``QueryBatcher``
/ ``WriteBatcher`` direct) or the async event loop
(``serving/frontend.py``), the same ops through the same batchers. In
async mode an optional multi-process client swarm (``gameday/swarm.py``)
also drives the HTTP surface over sockets.

Resume: with ``resume_dir`` set, the harness checkpoints the simulation
state, its draw generator and the write state at drained phase boundaries
(after warmup, steady and heal; never inside a fault window, and only with
no raft proposal in flight, so the raft log can be rebuilt empty) through
``utils/checkpoint``, with a JSON manifest of completed phases, latency
samples and the acknowledged write ledger. A rerun with the same config
resumes from the last completed boundary. The raft log is not
checkpointed: boundaries are drained, so an empty rebuilt log and a fresh
election are equivalent for the verdict (the reference's narrowing).

The port's heavy modules load inside the functions that use them, as
the reference's do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Optional

from consul_tpu_torch.gameday import slo as slo_mod

# Phase boundaries eligible for a resume checkpoint: never between
# fault and heal (the chaos windows must replay whole), and drain
# completing means the run is done.
_SAVE_AFTER = ("warmup", "steady", "heal")

_LEDGER_PREFIX = "gameday/ledger/"


@dataclasses.dataclass(frozen=True)
class GamedayConfig:
    """One game day's shape: the reference's defaults (n = 4096, 2 DCN
    islands, 1,024 watchers), on the card unless ``device`` / ``kernel``
    say otherwise (``device="cpu", kernel="torch"``: the plain path)."""

    n: int = 4096
    seed: int = 0
    view_degree: int = 16
    services: int = 8
    kv_slots: int = 512
    # Raft tier: window 0 = auto-size to the planned write volume
    # (the bounded on-device log admits at most ``window`` client
    # entries per group per run — the no-InstallSnapshot narrowing).
    raft_groups: int = 4
    raft_peers: int = 3
    raft_window: int = 0
    # DCN federation leg: islands of a small WAN-federated cluster
    # healing link faults alongside the main sim's fault window.
    # < 2 disables the leg.
    dcn_islands: int = 2
    dcn_nodes_per_dc: int = 64
    dcn_servers_per_dc: int = 2
    # Watch plane: watchers spread over service labels plus a kv
    # prefix pool; the queue bound is kept small so shed accounting
    # is exercised, not just possible.
    watchers: int = 1024
    watch_queue: int = 8
    watch_k: int = 64
    # Traffic mix.
    ratio: str = "90:9:1"
    read_batch: int = 256
    k: int = 8
    ledger_per_round: int = 4
    wait_s: float = 0.25          # per-round blocking-query bound
    # Phase clock.
    chunk: int = 32
    warmup_ticks: int = 64
    ticks_per_round: int = 32
    steady_rounds: int = 4
    fault_rounds: int = 6
    heal_rounds: int = 4
    drain_rounds: int = 4
    # Composed chaos shape (fractions of n).
    partition_frac: float = 0.25
    churn_frac: float = 0.05
    # Host frontend: "threaded" (batcher-direct) or "async" (the
    # event-loop frontend) — parity-pinned paths over one kernel set.
    frontend: str = "threaded"
    admission: str = "shed_oldest"
    max_pending: int = 4096
    # Client swarm (async frontend only): OS processes driving the
    # real HTTP surface over sockets. 0 disables.
    swarm_procs: int = 0
    swarm_requests: int = 64
    # Preemption-safe resume.
    resume_dir: Optional[str] = None
    thresholds: Optional[slo_mod.SloThresholds] = None
    # Where the simulation, the plane and the DCN leg run.
    device: str = "cuda"
    kernel: str = "cuda"

    @property
    def traffic_rounds(self) -> int:
        return self.steady_rounds + self.fault_rounds + self.heal_rounds

    def resolved_window(self) -> int:
        if self.raft_window:
            return int(self.raft_window)
        from consul_tpu_torch.serving.mixed import parse_ratio

        r, w_share, _ = parse_ratio(self.ratio)
        write_batch = max(1, round(self.read_batch * w_share / r))
        total = (self.traffic_rounds
                 * (write_batch + self.ledger_per_round)
                 + self.drain_rounds + 8)
        per_group = -(-total // max(1, self.raft_groups))
        w = 32
        while w < per_group * 2 + 8:
            w *= 2
        return min(w, 8192)

    def ident(self) -> str:
        """Shape fingerprint a resume manifest must match — every
        field that changes tensor shapes or the phase plan."""
        keys = ("n", "seed", "view_degree", "services", "kv_slots",
                "raft_groups", "raft_peers", "watchers", "watch_queue",
                "watch_k", "ratio", "read_batch", "k",
                "ledger_per_round", "chunk", "warmup_ticks",
                "ticks_per_round", "steady_rounds", "fault_rounds",
                "heal_rounds", "drain_rounds", "partition_frac",
                "churn_frac")
        parts = [f"{k}={getattr(self, k)}" for k in keys]
        parts.append(f"window={self.resolved_window()}")
        return ";".join(parts)


# ----------------------------------------------------------------------
# Traffic drivers: one op contract, two host frontends.
# ----------------------------------------------------------------------

class _ThreadedDriver:
    """The classic path: pre-assembled batches straight into the
    batchers, blocking queries through WatchPlane.wait_index."""

    name = "threaded"

    def __init__(self, sim, plane):
        self.sim = sim
        self.plane = plane

    def read_batch(self, ops):
        return self.plane.batcher.execute(ops)

    def write_batch(self, ops):
        return self.plane.writes.execute(ops)

    def wait_index(self, min_index: int, wait_s: float) -> int:
        return self.plane.watch.wait_index(min_index, wait_s)

    def owned_threads(self) -> int:
        return 0

    def close(self) -> None:
        pass


class _AsyncDriver:
    """The event-loop frontend: the same ops as futures, multiplexed
    on ONE owned thread; blocking queries park as loop timers."""

    name = "async"

    def __init__(self, sim, plane):
        from consul_tpu_torch.serving.frontend import AsyncFrontend

        self.sim = sim
        self.plane = plane
        self.frontend = AsyncFrontend(plane).start()

    def read_batch(self, ops):
        futs = [self.frontend.submit_read(m, s, a) for m, s, a in ops]
        return [f.result(60.0) for f in futs]

    def write_batch(self, ops):
        futs = [self.frontend.submit_write(o, t, a) for o, t, a in ops]
        return [f.result(60.0) for f in futs]

    def wait_index(self, min_index: int, wait_s: float) -> int:
        return self.frontend.wait_index(min_index, wait_s).result(
            wait_s + 30.0)

    def owned_threads(self) -> int:
        return self.frontend.owned_threads()

    def close(self) -> None:
        self.frontend.close()


# ----------------------------------------------------------------------
# Resume plumbing.
# ----------------------------------------------------------------------

def _manifest_path(d: str) -> str:
    return os.path.join(d, "gameday_manifest.json")


def _load_resume(cfg: GamedayConfig) -> Optional[dict]:
    if not cfg.resume_dir:
        return None
    path = _manifest_path(cfg.resume_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if man.get("ident") != cfg.ident():
        return None
    return man


def _save_resume(cfg: GamedayConfig, sim, plane, man: dict) -> bool:
    """Checkpoint the state, its draw generator, the write state and the
    manifest at a drained phase boundary. Returns False (and saves
    nothing) when raft still has proposals in flight: a resume point must
    be rebuildable with an empty raft log."""
    from consul_tpu_torch.utils import checkpoint as ckpt_mod

    if sim.raft is not None and sim.raft.inflight:
        return False
    os.makedirs(cfg.resume_dir, exist_ok=True)
    ckpt_mod.save(os.path.join(cfg.resume_dir, "gameday_state.ckpt"),
                  sim.state, meta={"ident": cfg.ident(),
                                   "generator": sim.generator_state()})
    ckpt_mod.save(os.path.join(cfg.resume_dir, "gameday_writes.ckpt"),
                  plane.write_state, meta={"ident": cfg.ident()})
    man = dict(man)
    man["ident"] = cfg.ident()
    man["keys"] = [plane.keys.key_of(s) for s in range(len(plane.keys))]
    tmp = _manifest_path(cfg.resume_dir) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(man, f)
    os.replace(tmp, _manifest_path(cfg.resume_dir))
    return True


def _restore_resume(cfg: GamedayConfig, sim, plane, man: dict) -> None:
    from consul_tpu_torch.utils import checkpoint as ckpt_mod

    path = os.path.join(cfg.resume_dir, "gameday_state.ckpt")
    sim.load_state(ckpt_mod.restore(path, sim.state),
                   generator=ckpt_mod.read_meta(path)["generator"])
    # restore() reads the file and copies to the device: do that outside
    # write_lock and swap the reference under it.
    restored = ckpt_mod.restore(
        os.path.join(cfg.resume_dir, "gameday_writes.ckpt"),
        plane.write_state)
    with plane.write_lock:
        plane.write_state = restored
    for key in man.get("keys", []):
        plane.keys.slot_for(key, create=True)
    sim.publish_serving()


def _simulation(cfg: GamedayConfig):
    """The game day's simulation: the bare SWIM driver at the config's
    shape and seed, on its device and kernel."""
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster as cluster_mod

    return cluster_mod.Simulation(
        SimConfig(n=cfg.n, view_degree=cfg.view_degree), seed=cfg.seed,
        device=cfg.device, kernel=cfg.kernel)


class _Stop(Exception):
    """Internal: unwind the phase clock after a preemption trip."""


# ----------------------------------------------------------------------
# The soak itself.
# ----------------------------------------------------------------------

def run_gameday(cfg: GamedayConfig, *, trap=None, emit=None) -> dict:
    """Run (or resume) one game day; returns the SLO verdict dict.

    ``trap`` is an optional :class:`~consul_tpu_torch.runtime.policy.
    SignalTrap`: when it fires, the harness stops at the next round
    boundary with a partial, failing verdict (``preempted: true``); the
    resume artifacts already on disk (``resume_dir``) let the next
    invocation continue from the last completed boundary. ``emit``
    (optional callable) receives one progress dict per phase."""
    from consul_tpu_torch.chaos import schedule as chaos_mod
    from consul_tpu_torch.config import RaftConfig
    from consul_tpu_torch.models import cluster as cluster_mod
    from consul_tpu_torch.obs import trace as obs_trace
    from consul_tpu_torch.ops import deltas as deltas_mod
    from consul_tpu_torch.serving import MODE_NEAREST, ServingPlane
    from consul_tpu_torch.serving.batcher import latency_pcts as _pcts
    from consul_tpu_torch.serving.mixed import parse_ratio

    t_start = time.monotonic()
    say = emit if emit is not None else (lambda rec: None)
    r_share, w_share, _watch_share = parse_ratio(cfg.ratio)
    write_batch = max(1, round(cfg.read_batch * w_share / r_share))

    sim = _simulation(cfg)
    sink = sim.sink
    sim.set_raft(RaftConfig(groups=cfg.raft_groups, peers=cfg.raft_peers,
                            window=cfg.resolved_window()))
    plane = ServingPlane(k=cfg.k, buckets=(cfg.read_batch,),
                         num_services=cfg.services, device=cfg.device)
    sim.attach_serving(plane, writes=True, kv_slots=cfg.kv_slots,
                       max_pending=cfg.max_pending, policy=cfg.admission,
                       watch_k=cfg.watch_k, watch_queue=cfg.watch_queue)

    # -- resume state ---------------------------------------------------
    man = _load_resume(cfg)
    completed: list = list(man["completed"]) if man else []
    records: dict = dict(man["records"]) if man else {}
    acked: dict = ({int(s): int(v) for s, v in man["acked"]}
                   if man else {})
    seq = int(man["seq"]) if man else 0
    apply_samples: list = list(man["apply_samples"]) if man else []
    if man:
        _restore_resume(cfg, sim, plane, man)
        sink.incr_counter("sim.gameday.resumes", 1)
        say({"gameday": "resume", "completed": list(completed)})

    # -- watch plane population ----------------------------------------
    svc_width = max(cfg.services, 1)
    hooks = [plane.watch.register("service", i % svc_width)
             for i in range(max(1, cfg.watchers))]
    kv_hook = plane.watch.register("kv_prefix", "gameday/")
    lag_probe = plane.watch.register("any")

    driver = (_AsyncDriver(sim, plane) if cfg.frontend == "async"
              else _ThreadedDriver(sim, plane))

    # -- accumulators (replayed phases preload them) --------------------
    read_lats: list = []
    write_lats: list = []
    flip_lats: list = []
    chaos_deltas: Optional[dict] = None
    dcn_report: Optional[dict] = None
    swarm_report: Optional[dict] = None
    for ph in completed:
        rec = records.get(ph, {})
        read_lats += rec.get("read_lats", [])
        write_lats += rec.get("write_lats", [])
        flip_lats += rec.get("flip_lats", [])
        if "chaos" in rec:
            chaos_deltas = rec["chaos"]
        if "dcn" in rec:
            dcn_report = rec["dcn"]
        if "swarm" in rec:
            swarm_report = rec["swarm"]

    preempted = False
    verdict_extra: dict = {}

    def _tripped() -> bool:
        return trap is not None and getattr(trap, "fired", None) is not None

    def _manifest() -> dict:
        return {"completed": completed, "records": records,
                "acked": sorted(acked.items()), "seq": seq,
                "apply_samples": apply_samples}

    def _ledger_ops() -> tuple[list, list]:
        nonlocal seq
        ops, entries = [], []
        for _ in range(cfg.ledger_per_round):
            key = f"{_LEDGER_PREFIX}{seq}"
            slot = plane.keys.slot_for(key, create=True)
            if slot < 0:
                break  # slot table full — size kv_slots to the plan
            val = seq & 0x7FFFFFFF
            ops.append((deltas_mod.OP_KV_PUT, slot, val))
            entries.append((seq, val))
            seq += 1
        return ops, entries

    def _mix_ops(rng) -> list:
        ops = []
        for _ in range(write_batch):
            roll = rng.random()
            node = rng.randrange(cfg.n)
            if roll < 0.5:
                ops.append((deltas_mod.OP_REGISTER, node,
                            rng.randrange(svc_width)))
            elif roll < 0.75:
                slot = plane.keys.slot_for(
                    f"gameday/kv/{rng.randrange(64)}", create=True)
                if slot >= 0:
                    ops.append((deltas_mod.OP_KV_PUT, slot,
                                rng.randrange(1000)))
            else:
                ops.append((deltas_mod.OP_DEREGISTER, node, -1))
        return ops

    def _traffic_round(rng) -> None:
        """One soak round: read batch, write batch (mix + ledger),
        sim ticks (flips + commit pump ride the chunk boundary), one
        explicit flip, one blocking query, one index sample."""
        read_ops = [(MODE_NEAREST, rng.randrange(cfg.n), -1)
                    for _ in range(cfg.read_batch)]
        t0 = time.perf_counter()
        driver.read_batch(read_ops)
        read_lats.append(time.perf_counter() - t0)
        sink.incr_counter("sim.gameday.reads", len(read_ops))

        led_ops, led_entries = _ledger_ops()
        ops = _mix_ops(rng) + led_ops
        t0 = time.perf_counter()
        results = driver.write_batch(ops)
        write_lats.append(time.perf_counter() - t0)
        sink.incr_counter("sim.gameday.writes", len(ops))
        if led_entries:
            for (s, v), res in zip(led_entries,
                                   results[-len(led_entries):]):
                if res is not None and (
                        res.applied or res.status == "proposed"):
                    acked[s] = v

        sim.run(cfg.ticks_per_round, chunk=cfg.chunk, with_metrics=False)
        t0 = time.perf_counter()
        sim.publish_serving()
        flip_lats.append(time.perf_counter() - t0)
        prev = apply_samples[-1] if apply_samples else 0
        idx = driver.wait_index(prev, cfg.wait_s)
        apply_samples.append(int(idx))
        sink.incr_counter("sim.gameday.rounds", 1)

    def _finish_phase(name: str, rec: dict) -> None:
        completed.append(name)
        records[name] = rec
        sink.incr_counter("sim.gameday.phases", 1)
        if cfg.resume_dir and name in _SAVE_AFTER:
            _save_resume(cfg, sim, plane, _manifest())
        say({"gameday": name,
             **{k: v for k, v in rec.items() if not isinstance(v, list)}})

    def _run_rounds(name: str, rounds: int, extras=None) -> None:
        """Run one traffic phase; raises _Stop on preemption."""
        nonlocal preempted
        rng = random.Random(f"{cfg.seed}:{name}")
        r0, w0, f0 = len(read_lats), len(write_lats), len(flip_lats)
        t0 = time.monotonic()
        with obs_trace.span(f"gameday.{name}", cat="gameday",
                            args={"rounds": rounds}):
            for _ in range(rounds):
                if _tripped():
                    preempted = True
                    raise _Stop()
                _traffic_round(rng)
        rec = {
            "rounds": rounds,
            "wall_s": round(time.monotonic() - t0, 2),
            "read_lats": read_lats[r0:],
            "write_lats": write_lats[w0:],
            "flip_lats": flip_lats[f0:],
        }
        if extras:
            rec.update(extras)
        _finish_phase(name, rec)

    # ------------------------------------------------------------------
    # Phase clock.
    # ------------------------------------------------------------------
    try:
        # warmup: form the cluster, elect leaders, warm every
        # executable (read bucket, write batch, flip + diff) so the
        # timed phases measure steady state, not compiles.
        if "warmup" not in completed:
            if _tripped():
                preempted = True
                raise _Stop()
            with obs_trace.span("gameday.warmup", cat="gameday",
                                args={"ticks": cfg.warmup_ticks}):
                t0 = time.monotonic()
                sim.run(cfg.warmup_ticks, chunk=cfg.chunk,
                        with_metrics=False)
                rng = random.Random(f"{cfg.seed}:warm")
                driver.read_batch(
                    [(MODE_NEAREST, rng.randrange(cfg.n), -1)
                     for _ in range(cfg.read_batch)])
                driver.write_batch(_mix_ops(rng))
                sim.run(cfg.chunk, chunk=cfg.chunk, with_metrics=False)
                sim.publish_serving()
            read_lats.clear()
            write_lats.clear()
            flip_lats.clear()
            _finish_phase("warmup", {
                "ticks": cfg.warmup_ticks,
                "wall_s": round(time.monotonic() - t0, 2)})

        # steady: clean-path traffic (plus the client swarm when an
        # async HTTP surface is up).
        if "steady" not in completed:
            swarm_handle = None
            swarm_mod = None
            if (cfg.frontend == "async" and cfg.swarm_procs > 0
                    and isinstance(driver, _AsyncDriver)):
                from consul_tpu_torch.gameday import swarm as swarm_mod

                host, port = driver.frontend.serve_http()
                swarm_handle = swarm_mod.start_swarm(
                    host, port, procs=cfg.swarm_procs,
                    requests=cfg.swarm_requests, seed=cfg.seed)
            try:
                _run_rounds("steady", cfg.steady_rounds)
            finally:
                if swarm_handle is not None:
                    swarm_report = swarm_mod.collect_swarm(swarm_handle)
                    sink.incr_counter("sim.gameday.swarm_requests",
                                      int(swarm_report.get("requests",
                                                           0)))
                    if "steady" in completed:
                        records["steady"]["swarm"] = swarm_report

        # fault + heal: install the composed chaos timeline and keep
        # traffic running straight through it. Windows end inside the
        # fault phase; the schedule stays installed through heal so
        # post-lift heal counters accumulate under the same program,
        # then unhooks (run_scenario's discipline). No resume point
        # between the two — the windows replay whole.
        if "heal" not in completed:
            fault_ticks = cfg.fault_rounds * cfg.ticks_per_round
            events = _composed_events(cfg, fault_ticks)
            sched = chaos_mod.shift_schedule(
                chaos_mod.compile_schedule(cfg.n, events), sim._t)
            before = sim.counters_snapshot()
            sim.set_chaos(sched)
            try:
                extras = {}
                if cfg.dcn_islands >= 2:
                    dcn_report = _dcn_leg(cfg)
                    extras["dcn"] = dcn_report
                if "fault" not in completed:
                    _run_rounds("fault", cfg.fault_rounds, extras=extras)
                _run_rounds("heal", cfg.heal_rounds)
            finally:
                sim.set_chaos(None)
            after = sim.counters_snapshot()
            chaos_deltas = {
                cluster_mod.SLO_KEYS[f]: after[f] - before[f]
                for f in cluster_mod.SLO_KEYS}
            records["heal"]["chaos"] = chaos_deltas
            if cfg.resume_dir:
                _save_resume(cfg, sim, plane, _manifest())

        # drain: stop offering traffic, pump until every in-flight
        # raft proposal commits, then flush one marker write so the
        # final flip carries a fresh delta to the lag probe.
        if "drain" not in completed:
            if _tripped():
                preempted = True
                raise _Stop()
            t0 = time.monotonic()
            with obs_trace.span("gameday.drain", cat="gameday"):
                tries = max(1, cfg.drain_rounds) * 4
                while (sim.raft is not None and sim.raft.inflight
                       and tries > 0 and not _tripped()):
                    sim.run(cfg.ticks_per_round, chunk=cfg.chunk,
                            with_metrics=False)
                    sim.publish_serving()
                    tries -= 1
                drained = sim.raft is None or sim.raft.inflight == 0
                slot = plane.keys.slot_for("gameday/drain-marker",
                                           create=True)
                if slot >= 0 and drained:
                    driver.write_batch([(deltas_mod.OP_KV_PUT, slot, 1)])
                    sim.run(cfg.ticks_per_round, chunk=cfg.chunk,
                            with_metrics=False)
                    sim.publish_serving()
                    drained = sim.raft is None or sim.raft.inflight == 0
            apply_samples.append(int(plane.apply_index))
            _finish_phase("drain", {
                "drained": drained,
                "wall_s": round(time.monotonic() - t0, 2)})
            verdict_extra["drained"] = drained
            # A completed soak retires its resume point — the next
            # run with this directory starts a fresh round instead of
            # skipping to the end of this one.
            if cfg.resume_dir:
                try:
                    os.remove(_manifest_path(cfg.resume_dir))
                except OSError:
                    pass
        else:
            verdict_extra["drained"] = records["drain"].get("drained",
                                                            True)
    except _Stop:
        pass
    finally:
        for h in hooks:
            plane.watch.unregister(h)
        plane.watch.unregister(kv_hook)
        live_threads = driver.owned_threads()
        driver.close()

    # ------------------------------------------------------------------
    # Verdict assembly.
    # ------------------------------------------------------------------
    drained = bool(verdict_extra.get("drained", False))
    lost, misses, regressions = _audit_writes(
        plane, acked, apply_samples, drained=drained and not preempted)
    if lost:
        sink.incr_counter("sim.gameday.lost_writes", lost)
    final_index = int(plane.apply_index)
    lag = (max(0, final_index - int(lag_probe.index))
           if not preempted else None)
    plane.watch.unregister(lag_probe)

    rp50, rp99 = _pcts(read_lats)
    wp50, wp99 = _pcts(write_lats)
    fp50, fp99 = _pcts(flip_lats)
    wstats = plane.writes.stats() if plane.writes is not None else {}
    watchstats = plane.watch.stats() if plane.watch is not None else {}

    measured = {
        "p99_read_ms": rp99 if read_lats else None,
        "p99_write_ms": wp99 if write_lats else None,
        "p99_watch_ms": fp99 if flip_lats else None,
        "lost_writes": lost if not preempted else None,
        "max_time_to_heal_ticks": (chaos_deltas or {}).get("time_to_heal"),
        "watch_delivery_lag": lag,
        "shed": (int(wstats.get("shed", 0))
                 + int(watchstats.get("watch_shed", 0))),
        "rejected": int(wstats.get("rejected", 0)),
    }
    verdict = slo_mod.evaluate(measured, cfg.thresholds)
    if preempted:
        verdict["pass"] = False
        verdict["violations"].append("preempted mid-soak (resumable)")
    verdict.update({
        "preempted": preempted,
        "phases": list(completed),
        "frontend": driver.name,
        "frontend_threads": live_threads,
        "p50_read_ms": rp50,
        "p50_write_ms": wp50,
        "p50_watch_ms": fp50,
        "ledger": {"written": seq, "acked": len(acked),
                   "readback_misses": misses,
                   "index_regressions": regressions},
        "apply_index": final_index,
        "watchers": int(watchstats.get("watchers", 0)),
        "deliveries": int(watchstats.get("deltas", 0)),
        "flips": int(watchstats.get("flips", 0)),
        "chaos": chaos_deltas,
        "dcn": dcn_report,
        "swarm": swarm_report,
        "raft": sim.raft.summary() if sim.raft is not None else None,
        "wall_s": round(time.monotonic() - t_start, 2),
        "n": cfg.n,
        "drained": drained,
    })
    say({"gameday": "verdict", "pass": verdict["pass"],
         "violations": verdict["violations"]})
    return verdict


def _composed_events(cfg: GamedayConfig, window: int) -> list:
    """The composed fault timeline, relative to the fault phase start:
    a partition over the first half, a churn wave pulsing through the
    middle, and a leader-kill window (every group, whoever leads) over
    the first half — all riding ONE compiled schedule."""
    from consul_tpu_torch.chaos import schedule as chaos_mod

    half = max(4, window // 2)
    return [
        chaos_mod.Partition(
            start=2, stop=half,
            side_a=slice(0, max(2, int(cfg.n * cfg.partition_frac)))),
        chaos_mod.ChurnWave(
            start=max(2, window // 4), stop=max(6, 3 * window // 4),
            nodes=slice(0, max(1, int(cfg.n * cfg.churn_frac))),
            period=8, down_ticks=4),
        chaos_mod.RaftKill(start=2, stop=half, group=-1, peer=-1),
    ]


def _dcn_leg(cfg: GamedayConfig) -> dict:
    """The federation leg: a small multi-island WAN-federated cluster
    heals injected DCN link faults (timeout one way, drop the other)
    while the main sim rides its own fault window. Reported into the
    verdict; the DCN tier's own counters carry the detail."""
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models.federation import FederationConfig
    from consul_tpu_torch.parallel import dcn as dcn_mod
    from consul_tpu_torch.utils.telemetry import Sink

    snk = Sink()
    fed = dcn_mod.DcnFederation(
        FederationConfig(
            n_dc=cfg.dcn_islands, nodes_per_dc=cfg.dcn_nodes_per_dc,
            servers_per_dc=cfg.dcn_servers_per_dc,
            lan=SimConfig(n=cfg.dcn_nodes_per_dc, view_degree=8)),
        n_islands=cfg.dcn_islands, seed=cfg.seed, sink=snk,
        link_policy=dcn_mod.LinkPolicy(retry_max=3, queue_bound=4),
        device=cfg.device, kernel=cfg.kernel)
    fed.inject_link_faults([
        dcn_mod.LinkFault(src=0, dst=1, start=1, stop=4, kind="timeout"),
        dcn_mod.LinkFault(src=1, dst=0, start=1, stop=4),
    ])
    fed.run(16 * 12, sync_every=16, chunk=16)
    return {
        "islands": cfg.dcn_islands,
        "converged": bool(fed.replicas_agree()),
        "heals": int(snk.counter_sum("sim.dcn.heals")),
        "retries": int(snk.counter_sum("sim.dcn.retries")),
        "link_down_ticks": int(
            snk.counter_sum("sim.dcn.link_down_ticks")),
        "queue_peak": int(fed.queue_peak()),
    }


def _audit_writes(plane, acked: dict, apply_samples: list, *,
                  drained: bool) -> tuple[int, int, int]:
    """The lost-writes audit: every acknowledged ledger entry must
    read back with its value and a real ModifyIndex, and the
    X-Consul-Index samples must be monotone across the whole soak
    (leader kill included). Returns (lost, readback_misses,
    index_regressions); an un-drained run counts every acked entry
    unaccounted — the harness fails loudly, never optimistically."""
    misses = 0
    for s, v in acked.items():
        row = plane.kv_get(f"{_LEDGER_PREFIX}{s}")
        if row is None or int(row["Value"]) != v \
                or int(row["ModifyIndex"]) <= 0:
            misses += 1
    regressions = sum(
        1 for a, b in zip(apply_samples, apply_samples[1:]) if b < a)
    if not drained:
        misses = max(misses, len(acked))
    return misses + regressions, misses, regressions
