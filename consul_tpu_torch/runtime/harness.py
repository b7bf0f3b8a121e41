"""The resilient run loop (PyTorch port of
``consul_tpu/runtime/harness.py``): chunked execution with
checkpoint/resume, preemption handling and the invariant sentinel.

The guarantee: kill -9 the process mid-run, rerun the same call, and the
final state is bit-identical to an uninterrupted run. Three properties
make that hold:

- the port draws every tick's random numbers from one stateful
  ``torch.Generator`` (the reference keys each tick by ``fold_in(base_key,
  t)`` instead), so every checkpoint's meta carries that generator's
  state (``Simulation.generator_state``) and a resume restores it with
  the state, whose ``t`` leaf sets the tick;
- the chaos schedule's tick offset (``chaos_t0``) and digest ride in the
  meta, so the resumed run rebases the same schedule to the same ticks,
  and a checkpoint from another schedule is not resumed;
- saves are atomic and digest-verified (utils/checkpoint).

A checkpoint without the generator's state (the reference's) names no
draw stream the port can continue: ``run_resilient`` refuses it as a
resume point, while ``checkpoint.restore`` (or ``restore_tree`` and
``convert.py``) still loads it as a state.

Multi-GPU placement (``mesh=``, ``elastic=``) waits for the mesh port
(ROADMAP A13) and raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models.cluster import SLO_KEYS
from consul_tpu_torch.runtime.policy import CheckpointPolicy, SignalTrap
from consul_tpu_torch.runtime.watchdog import HeartbeatMonitor
from consul_tpu_torch.utils import checkpoint as ckpt_mod


class Preempted(RuntimeError):
    """The run stopped early on a trapped termination signal, after
    saving a resume point. Carries the report."""

    def __init__(self, report: "RunReport"):
        self.report = report
        super().__init__(
            f"preempted at tick {report.ticks_done}/{report.ticks_asked} "
            f"(checkpoint: {report.checkpoint_path})")


@dataclasses.dataclass
class RunReport:
    """What one resilient run did."""

    ticks_asked: int
    ticks_done: int
    resumed_from_tick: int
    preempted: bool
    checkpoint_path: Optional[str]
    ckpt_failures: int
    counters: dict
    slo: Optional[dict]
    hang_status: Optional[str] = None
    hang_checkpoint: Optional[str] = None
    # Set when the resume point was a dense-layout checkpoint restored
    # into a packed run ({"widened_from": ..., "widened_to": ...}).
    widened: Optional[dict] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


state_layout_digest = ckpt_mod.state_layout_digest


def _scenario_meta(sim, tag: str, ticks: int, t0: int, done: int,
                   sched_digest: str) -> dict:
    return {
        "tag": tag,
        "n": sim.cfg.n,
        "seed": sim.seed,
        "kind": type(sim).__name__,
        "ticks": ticks,
        "t0": t0,
        "ticks_done": done,
        "chaos_t0": t0,
        "schedule_digest": sched_digest,
        "state_layout": state_layout_digest(sim.state, sim.cfg.n),
        "mesh_devices": 1,
        # The port's draw stream: what a resume needs to draw what the
        # run would have drawn.
        "generator": sim.generator_state(),
    }


def hang_dump_path(dump_dir: str, t: int) -> str:
    """Where the heartbeat monitor drops the mid-run-hang diagnostic
    checkpoint."""
    return os.path.join(dump_dir, f"hang_diag_t{int(t)}.ckpt")


diagnostic_dump_path = ckpt_mod.diagnostic_dump_path


def _resume_point(sim, policy, ident: dict, sink):
    """``(state, meta, widened)`` of the policy's checkpoint when it names
    this trajectory, else ``(None, None, None)``. A checkpoint of this
    trajectory that the port cannot continue raises, saying why. The meta
    comes from the checkpoint's manifest, which the save replaces with the
    leaves in one rename, never from the sidecar that follows it."""
    meta0 = policy.read_meta()
    if not (meta0 is not None
            and all(meta0.get(k) == v for k, v in ident.items())):
        return None, None, None
    if "generator" not in meta0:
        raise RuntimeError(
            f"checkpoint {policy.path} matches this trajectory but carries "
            "no draw generator state (a reference checkpoint: its draws are "
            "keyed by tick, the port's come from one stateful generator), "
            "so no resume can draw what the run would have drawn. Restore "
            "it as a state (utils/checkpoint.restore, or restore_tree and "
            "convert.py) and start a new run from it.")
    n = sim.cfg.n
    layout_now = state_layout_digest(sim.state, n)
    saved_layout = meta0.get("state_layout")
    if saved_layout == layout_now:
        state, meta = policy.load(sim.state, match=ident)
        return state, meta, None
    dense_tpl = (layout_mod.unpack_state(sim.state)
                 if layout_mod.is_packed(sim.state) else None)
    if dense_tpl is not None and saved_layout == state_layout_digest(dense_tpl, n):
        state, widened = ckpt_mod.restore_widened(
            policy.path, dense_tpl, layout_mod.pack_state, n)
        if sink is not None:
            sink.incr_counter("sim.runtime.widened_restores", 1)
        return state, meta0, widened
    raise RuntimeError(
        f"checkpoint {policy.path} matches this trajectory but was written "
        f"by an incompatible state layout ({saved_layout} vs {layout_now}): "
        "it cannot be resumed into this program. Retire it (delete the "
        ".ckpt/.meta.json pair) or rerun with the build that wrote it.")


def run_resilient(sim, ticks: int, *, chunk: int = 64,
                  with_metrics: bool = False,
                  events: Optional[Sequence] = None,
                  policy: Optional[CheckpointPolicy] = None,
                  sentinel: bool = False,
                  sentinel_dump_dir: Optional[str] = None,
                  heartbeat_s: Optional[float] = None,
                  hang_dump_dir: Optional[str] = None,
                  mesh=None, elastic: bool = False) -> RunReport:
    """Advance ``sim`` by ``ticks`` ticks (with ``events`` as a chaos
    schedule rebased onto the start tick, like ``run_scenario``): resume
    from ``policy``'s checkpoint when one of this trajectory exists, save
    at every due chunk boundary, save and raise :class:`Preempted` on
    SIGTERM, and retire the checkpoint on completion. With ``sentinel``
    a violation raises SentinelViolation after a diagnostic checkpoint
    in ``sentinel_dump_dir``. ``heartbeat_s`` arms a per-chunk deadline
    (HeartbeatMonitor) whose hang writes the last completed state into
    ``hang_dump_dir`` (default: ``sentinel_dump_dir``, then the policy's
    directory). The report's counters cover the ticks this call ran."""
    if mesh is not None or elastic:
        raise NotImplementedError("mesh placement and elastic resume wait "
                                  "for the multi-GPU port (ROADMAP A13)")
    if sentinel:
        sim.set_sentinel(True, sentinel_dump_dir)
    sched = (chaos_mod.compile_schedule(sim.cfg.n, events)
             if events else None)
    sched_digest = chaos_mod.digest_of(sched)
    t0 = sim._t
    done = 0
    sink = (policy.sink if policy is not None else None) \
        or getattr(sim, "sink", None)
    if policy is not None and policy.trap is None:
        policy.trap = SignalTrap()

    widened = None
    if policy is not None:
        ident = {"tag": policy.tag, "n": sim.cfg.n, "seed": sim.seed,
                 "kind": type(sim).__name__, "ticks": ticks,
                 "schedule_digest": sched_digest}
        state, meta, widened = _resume_point(sim, policy, ident, sink)
        if state is not None:
            sim.load_state(state, meta["generator"])
            t0 = int(meta["t0"])
            done = int(meta["ticks_done"])
    resumed_from = done

    prev_sched = sim.chaos
    if sched is not None:
        sim.set_chaos(chaos_mod.shift_schedule(sched, t0))
    before = dict(sim.counters)

    monitor = None
    hang_ckpt: list = [None]  # the monitor thread writes, the report reads
    if heartbeat_s:
        dump_dir = hang_dump_dir or sentinel_dump_dir or (
            policy.directory if policy is not None else None)

        def _on_hang(status, hung_done, last):
            if policy is not None:
                policy.request()  # save if the main thread unblocks
            if dump_dir is None or last is None:
                return
            last_state, last_meta = last
            os.makedirs(dump_dir, exist_ok=True)
            path = hang_dump_path(dump_dir, t0 + hung_done)
            ckpt_mod.save(path, last_state,
                          meta=dict(last_meta, classification=status))
            hang_ckpt[0] = path

        monitor = HeartbeatMonitor(heartbeat_s, on_hang=_on_hang,
                                   sink=sink).start()

    def _report(preempted: bool) -> RunReport:
        after = sim.counters
        deltas = {f: after[f] - before[f] for f in counters_mod.FIELDS}
        return RunReport(
            ticks_asked=ticks, ticks_done=done,
            resumed_from_tick=resumed_from, preempted=preempted,
            checkpoint_path=policy.path if policy is not None else None,
            ckpt_failures=policy.failures if policy is not None else 0,
            counters=deltas,
            slo=({SLO_KEYS[f]: deltas[f] for f in SLO_KEYS}
                 if sched is not None else None),
            hang_status=monitor.status if monitor is not None else None,
            hang_checkpoint=hang_ckpt[0], widened=widened)

    def _meta():
        return _scenario_meta(sim, policy.tag if policy is not None
                              else "hang", ticks, t0, done, sched_digest)

    trap = policy.trap if policy is not None else SignalTrap()
    try:
        with trap:
            if policy is not None:
                policy.mark_run_start()
            since_save = 0
            while done < ticks:
                c = min(chunk, ticks - done)
                sim.run(c, chunk=c, with_metrics=with_metrics)
                done += c
                since_save += c
                if monitor is not None:
                    # The finished chunk, mirrored to the host: a wedged
                    # card cannot serve a copy after the fact.
                    monitor.beat(done, (ckpt_mod.to_host(sim.state), _meta()))
                if policy is None:
                    continue
                if trap.fired is not None:
                    policy.try_save(sim.state, _meta())
                    raise Preempted(_report(preempted=True))
                if done < ticks and policy.due(since_save):
                    if policy.try_save(sim.state, _meta()):
                        since_save = 0
    finally:
        if monitor is not None:
            monitor.stop()
        sim.set_chaos(prev_sched)
    if policy is not None:
        policy.retire()
    return _report(preempted=False)
