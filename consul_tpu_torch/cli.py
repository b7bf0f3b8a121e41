"""The port's command line: the reference's simulation verbs (PyTorch
port of ``consul_tpu/cli.py:709-1267`` and their parser entries).

    python -m consul_tpu_torch.cli run --n 1048576 --view-degree 32
    python -m consul_tpu_torch.cli chaos --n 4096 --partition 4,16,0.3
    python -m consul_tpu_torch.cli chaos --n 4096 --sweep 8
    python -m consul_tpu_torch.cli trace --n 65536 --trace-dir traces
    python -m consul_tpu_torch.cli serve-bench --n 65536 --queries 4096
    python -m consul_tpu_torch.cli gameday --n 4096
    python -m consul_tpu_torch.cli prewarm --n 65536 --kinds swim,serf

Every verb runs on the card through the CUDA tick kernel unless asked for
the CPU: ``--device cpu --kernel torch`` runs the plain version there.
``--kernel`` takes ``cuda`` or ``torch``, and the reference's ``pallas``
and ``xla`` as their aliases; ``--kernel cuda`` without a card exits 2,
and nothing falls back. Each verb prints one JSON line. ``run`` and
``chaos`` drive ``runtime.run_resilient``: with ``--ckpt-dir`` a SIGTERM
saves a resume point and exits 75, and rerunning the same command
continues the trajectory bit-identically; a tripped sentinel exits 2.

``run --elastic`` and ``chaos --elastic`` run over the largest mesh the
surviving devices support and re-shard a resumed checkpoint onto it (on
the CPU the one device); ``chaos --sweep`` runs over the default mesh.
``gameday`` runs on one device group, as the reference's ``run_gameday``
takes no mesh.

``--layout auto`` and ``--budget`` ask the memory planner
(``runtime/membudget.py``) for the layout, the chunk and the cohort plan;
a population beyond the device's budget runs cohort-streamed
(``models/cluster.StreamedSimulation``), and ``run`` and ``chaos`` print
``memory_plan`` and ``streamed: true``. The CUDA tick takes only the
packed layout, so under ``--kernel cuda`` the planner is asked for it
(``--layout auto`` plans packed); under ``--kernel torch`` ``auto`` is
passed through as the reference passes it.

Not here yet: the host verbs (``agent``, ``members``, ``kv`` ..., ROADMAP
A21).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

KERNEL_CHOICES = ("cuda", "torch", "pallas", "xla")


def _fail(flag: str, msg: str):
    print(f"{flag}: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _device_of(args) -> str:
    """``--device``, checked: a CUDA device must be visible."""
    import torch

    device = getattr(args, "device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        kernel = getattr(args, "kernel", "cuda")
        _fail(f"--kernel {kernel}" if kernel in ("cuda", "pallas")
              else f"--device {device}",
              "kernel='cuda' needs a CUDA device, and none is visible; "
              "pass --device cpu --kernel torch to run the plain version")
    return device


def _mesh_from_args(args, n: int):
    """The default mesh of a local run: the largest elastic mesh over the
    visible cards when more than one is visible (``--devices`` /
    ``--n-dc`` override), none on one card or on the CPU."""
    import torch

    from consul_tpu_torch.parallel import mesh as mesh_mod

    on_cpu = torch.device(getattr(args, "device", "cuda")).type == "cpu"
    try:
        return mesh_mod.default_mesh(
            n, device_count=getattr(args, "devices", None),
            n_dc=getattr(args, "n_dc", 1) or 1,
            devices=[] if on_cpu else None)
    except ValueError as e:
        _fail("--devices / --n-dc", str(e))


def _survivors(args) -> list:
    """The devices an ``--elastic`` run meshes over: the visible cards
    (``--devices`` truncates them), on the CPU the one device."""
    import torch

    from consul_tpu_torch.parallel import mesh as mesh_mod

    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cpu":
        return [device]
    devices = mesh_mod.visible_devices()
    count = getattr(args, "devices", None)
    return devices[:count] if count else devices


def _plan_layout(args, kernel: str) -> str:
    """The layout the planner is asked for: ``--layout``, with ``auto``
    narrowed to packed under the CUDA tick (it takes no other)."""
    from consul_tpu_torch.ops import cuda_gossip

    layout = getattr(args, "layout", None) or "packed"
    if layout == "auto" and kernel == cuda_gossip.CUDA:
        return "packed"
    return layout


def _plan_from_args(args, cfg, kind: str, mesh, kernel: str, device):
    """The memory plan of a local run (reference cli.py:722-746), or None
    when neither ``--layout auto`` nor ``--budget`` asks for one. A
    population beyond the budget over a mesh replans on one device: the
    cohort-streamed regime."""
    budget = getattr(args, "budget", None)
    if getattr(args, "layout", None) != "auto" and budget is None:
        return None
    from consul_tpu_torch.runtime import membudget

    kw = dict(layout=_plan_layout(args, kernel), budget=budget or "auto",
              chunk=getattr(args, "chunk", None), device=device)
    try:
        if mesh is not None and mesh.size > 1:
            try:
                return membudget.plan(cfg, kind, mesh=mesh, **kw)
            except ValueError:
                pass  # beyond the budget over the mesh: stream on one device
        return membudget.plan(cfg, kind, **kw)
    except ValueError as e:
        _fail("--layout / --budget", str(e))


def _build_sim(args):
    """Build the simulation a local-run verb drives (reference cli.py:
    748-829): the compile cache, the view degree, the engine, the memory
    plan, the mesh, the lens, the raft tier and the prewarm. Returns
    ``(sim, plan)``: ``plan`` is None unless ``--layout auto`` or
    ``--budget`` asked for one, and ``plan.streamed`` means ``sim`` is a
    ``StreamedSimulation`` (cohorts through one device: no mesh, lens,
    raft tier or prewarm)."""
    from consul_tpu_torch.config import SimConfig, clamp_view_degree
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.utils import compile_cache

    if getattr(args, "compile_cache", None):
        compile_cache.enable(args.compile_cache)
    else:
        compile_cache.maybe_enable_from_env()
    try:
        vd = clamp_view_degree(args.n, args.view_degree)
    except ValueError as e:
        _fail("--view-degree", str(e))
    cfg = SimConfig(n=args.n, view_degree=vd,
                    topo_family=getattr(args, "family", "circulant"),
                    topo_param=getattr(args, "family_param", 0.0))
    kernel = cuda_gossip.canonical_kernel(getattr(args, "kernel", "cuda"))
    device = _device_of(args)
    mesh = _mesh_from_args(args, args.n)
    plan = _plan_from_args(args, cfg, "serf" if args.serf else "swim", mesh,
                           kernel, device)
    layout = plan.layout if plan is not None else _plan_layout(args, kernel)
    try:
        cuda_gossip.validate_kernel(kernel, layout, device)
    except ValueError as e:
        _fail("--kernel", str(e))
    if plan is not None and plan.streamed:
        if int(getattr(args, "lens", 0) or 0):
            _fail("--lens", "the node lens needs a resident population; "
                  "cohort-streamed runs cannot record it")
        if int(getattr(args, "raft_groups", 0) or 0):
            _fail("--raft-groups", "the raft tier rides the resident run; "
                  "cohort-streamed runs cannot arm it")
        scls = (cluster.StreamedSerfSimulation if args.serf
                else cluster.StreamedSimulation)
        return scls(cfg, cohort_n=plan.cohort_n, seed=args.seed,
                    layout=plan.layout, chunk=plan.chunk, device=device,
                    kernel=kernel), plan
    cls = cluster.SerfSimulation if args.serf else cluster.Simulation
    sim = cls(cfg, seed=args.seed, mesh=mesh, layout=layout, kernel=kernel,
              device=mesh.devices[0] if mesh is not None else device)
    lens_n = int(getattr(args, "lens", 0) or 0)
    if lens_n:
        if mesh is not None:
            _fail("--lens", "the node lens is single-device; drop the mesh "
                  "flags to use it")
        sim.set_lens(lens_n)
    raft_groups = int(getattr(args, "raft_groups", 0) or 0)
    if raft_groups:
        sim.set_raft(raft_groups, peers=int(getattr(args, "raft_peers", 5)))
    if getattr(args, "prewarm", False):
        from consul_tpu_torch.utils import prewarm as prewarm_mod

        chunk = getattr(args, "chunk", 32)
        for with_metrics in (False, True):
            prewarm_mod.prewarm_simulation(sim, chunk, with_metrics)
    return sim, plan


def _streamed_report(args, sim, extra: dict, summary: dict) -> int:
    """Print a cohort-streamed run's JSON line (reference cli.py:
    1128-1135): the plan, the pass summary, ``streamed: true`` and the
    counters."""
    out = dict(extra, **summary, streamed=True,
               counters=sim.counters_snapshot())
    trace_path = _export_trace(args, sim)
    if trace_path:
        out["trace"] = trace_path
    print(json.dumps(out))
    return 0


def _export_trace(args, sim=None):
    """Write the flight-recorder artifact (obs/trace.py's Chrome trace,
    the armed lens's timelines merged in) under ``--trace-dir``; returns
    its path, or None without one."""
    tdir = getattr(args, "trace_dir", None)
    if not tdir:
        return None
    from consul_tpu_torch.obs import trace as obs_trace

    lens = getattr(sim, "lens", None) if sim is not None else None
    extra = lens.to_trace_events() if lens is not None else None
    return obs_trace.get_tracer().export(os.path.join(tdir, "trace.json"),
                                         extra_events=extra)


def _ckpt_policy(args, sim, default_tag: str):
    """The checkpoint policy of ``--ckpt-dir``, or None without one."""
    if not getattr(args, "ckpt_dir", None):
        return None
    from consul_tpu_torch.runtime import CheckpointPolicy

    return CheckpointPolicy(directory=args.ckpt_dir,
                            tag=args.ckpt_tag or default_tag,
                            every_ticks=args.ckpt_every_ticks,
                            min_interval_s=args.ckpt_interval_s,
                            sink=sim.sink)


def _state_digest(sim) -> str:
    """sha256 of the final state's bytes, leaf by leaf in flatten order
    (one host copy): two runs that end in the same state print the same
    digest."""
    import hashlib

    import torch

    from consul_tpu_torch.models import layout

    h = hashlib.sha256()
    for leaf in layout.leaves(sim._whole()):
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _run_resilient_cmd(args, sim, events, ticks, extra: dict) -> int:
    """Drive one local simulation through runtime.run_resilient and print
    one JSON line. SIGTERM mid-run saves a resume point and exits 75
    (rerunning the same command continues the trajectory); a tripped
    sentinel exits 2 with the violation and the diagnostic checkpoint's
    path."""
    from consul_tpu_torch.runtime import (Preempted, SentinelViolation,
                                          run_resilient)

    if args.dcn_retry_max is not None:
        # The process-wide LinkPolicy default: any DCN federation this
        # run builds inherits the bound (parallel/dcn).
        import dataclasses

        from consul_tpu_torch.parallel import dcn as dcn_mod

        dcn_mod.DEFAULT_LINK_POLICY = dataclasses.replace(
            dcn_mod.DEFAULT_LINK_POLICY, retry_max=args.dcn_retry_max)
    policy = _ckpt_policy(args, sim, f"{args.cmd}_{args.n}_seed{args.seed}")
    try:
        report = run_resilient(
            sim, ticks, chunk=args.chunk, events=events, policy=policy,
            sentinel=args.sentinel, sentinel_dump_dir=args.sentinel_dump_dir,
            heartbeat_s=args.heartbeat_s or None, elastic=args.elastic,
            devices=_survivors(args) if args.elastic else None)
    except Preempted as e:
        print(json.dumps(dict(extra, **e.report.to_json())))
        return 75
    except SentinelViolation as e:
        print(json.dumps(dict(
            extra, sentinel_tripped=True, violation_mask=e.mask,
            violations={k: int(v) for k, v in e.deltas.items() if v},
            diagnostic_checkpoint=e.dump_path)))
        return 2
    out = dict(extra, ticks=report.ticks_done, slo=report.slo,
               counters=report.counters,
               resumed_from_tick=report.resumed_from_tick,
               ckpt_failures=report.ckpt_failures,
               reshards=report.reshards, hang_status=report.hang_status)
    if getattr(sim, "raft", None) is not None:
        sim.raft.pump()
        out["raft"] = dict(sim.raft.summary(),
                           counters=sim.raft.counters_snapshot())
    if args.state_digest:
        out["state_digest"] = _state_digest(sim)
    trace_path = _export_trace(args, sim)
    if trace_path:
        out["trace"] = trace_path
    print(json.dumps(out))
    return 0


def _one_group(args, what: str):
    """Refuse a verb over a mesh of more than one device group: asked for
    with ``--devices`` / ``--n-dc``, or the default over several cards
    (the game day: the reference's ``run_gameday`` takes no mesh)."""
    devices = getattr(args, "devices", None)
    wide = (devices or 1) > 1 or (getattr(args, "n_dc", 1) or 1) > 1
    if not wide and devices is None:
        wide = _mesh_from_args(args, args.n) is not None
    if wide:
        _fail(what, "it runs on one device group, as the reference's "
              "run_gameday takes no mesh; pass --devices 1")


def _chaos_events(args) -> list:
    """The fault schedule of ``chaos``' flags (reference cli.py:938-998);
    the default scenario is a 70 / 30 partition that heals."""
    from consul_tpu_torch import chaos as chaos_mod

    n = args.n

    def frac_nodes(frac):
        return slice(0, max(1, int(n * frac)))

    events = []
    for spec in args.partition or []:
        start, stop, frac = spec.split(",")
        events.append(chaos_mod.Partition(
            start=int(start), stop=int(stop), side_a=frac_nodes(float(frac))))
    for spec in args.link_loss or []:
        f = spec.split(",")
        na = max(1, int(n * float(f[2])))
        nb = max(1, int(n * float(f[3])))
        events.append(chaos_mod.LinkLoss(
            start=int(f[0]), stop=int(f[1]), a=slice(0, na),
            b=slice(na, na + nb), fwd=float(f[4]),
            rev=float(f[5]) if len(f) > 5 else 0.0))
    for spec in args.churn or []:
        start, stop, frac = spec.split(",")
        events.append(chaos_mod.ChurnWave(
            start=int(start), stop=int(stop), nodes=frac_nodes(float(frac))))
    for spec in args.degrade or []:
        f = spec.split(",")
        events.append(chaos_mod.Degrade(
            start=int(f[0]), stop=int(f[1]), nodes=frac_nodes(float(f[2])),
            tx_loss=float(f[3]), rx_loss=float(f[4]) if len(f) > 4 else 0.0))
    raft_events = []
    for spec in args.raft_kill or []:
        f = spec.split(",")
        raft_events.append(chaos_mod.RaftKill(
            start=int(f[0]), stop=int(f[1]),
            group=int(f[2]) if len(f) > 2 else -1,
            peer=int(f[3]) if len(f) > 3 else -1))
    for spec in args.raft_partition or []:
        f = spec.split(",")
        raft_events.append(chaos_mod.RaftPartition(
            start=int(f[0]), stop=int(f[1]), cut=int(f[2]),
            group=int(f[3]) if len(f) > 3 else -1))
    for spec in args.raft_storm or []:
        f = spec.split(",")
        raft_events.append(chaos_mod.RaftStorm(
            start=int(f[0]), stop=int(f[1]),
            group=int(f[2]) if len(f) > 2 else -1))
    if raft_events and not getattr(args, "raft_groups", 0):
        _fail("--raft-kill/--raft-partition/--raft-storm",
              "they act on the raft tier; arm it with --raft-groups R")
    events.extend(raft_events)
    if not events:
        events = [chaos_mod.Partition(start=4, stop=16,
                                      side_a=frac_nodes(0.3))]
    return events


def cmd_chaos(args) -> int:
    """Run a fault-schedule scenario on a local simulation (reference
    cli.py:921-1020) through runtime.run_resilient and print the SLO
    counters as one JSON line; ``--sweep S`` runs S scenarios per family
    instead (:func:`_cmd_chaos_sweep`)."""
    if args.sweep > 0:
        return _cmd_chaos_sweep(args)
    events = _chaos_events(args)
    sim, plan = _build_sim(args)
    ticks = max(int(e.stop) for e in events) + args.settle
    extra = {"n": args.n}
    if plan is not None:
        extra["memory_plan"] = plan.to_dict()
    if plan is not None and plan.streamed:
        # Form, then replay the schedule inside every cohort, shifted past
        # the forming (a streamed simulation has no harness to rebase it).
        import dataclasses

        sim.run(args.form_ticks)
        sim.set_chaos([dataclasses.replace(e, start=e.start + args.form_ticks,
                                           stop=e.stop + args.form_ticks)
                       for e in events])
        return _streamed_report(args, sim, extra, sim.run(ticks))
    sim.run(args.form_ticks, chunk=args.chunk, with_metrics=False)
    return _run_resilient_cmd(args, sim, events, ticks, extra)


def _cmd_chaos_sweep(args) -> int:
    """``chaos --sweep S`` (reference cli.py:1023-1070): S scenarios per
    view-graph family, each in a lane of its own (chaos/sweep.py), and
    the per-family worst cases and the bandwidth-against-convergence
    Pareto table as one JSON line."""
    from consul_tpu_torch.chaos import sweep as sweep_mod
    from consul_tpu_torch.topo import FAMILIES

    if args.families:
        if args.families.strip() == "all":
            families = [f for f in sorted(FAMILIES)
                        if f != "hier" or args.n % 8 == 0]
        else:
            families = [f.strip() for f in args.families.split(",")
                        if f.strip()]
    else:
        families = [args.family]
    unknown = [f for f in families if f not in FAMILIES]
    if unknown:
        _fail("--families", f"unknown famil{'ies' if len(unknown) > 1 else 'y'}"
              f" {', '.join(unknown)}; registered: {', '.join(sorted(FAMILIES))}")
    scens = (sweep_mod.scenario_grid(args.n, args.sweep)
             if args.sweep_mode == "grid"
             else sweep_mod.scenario_random(args.n, args.sweep,
                                            seed=args.sweep_seed))
    per_family = {}
    for fam in families:
        fam_args = argparse.Namespace(**vars(args))
        fam_args.family = fam
        sim, _ = _build_sim(fam_args)
        sim.run(args.form_ticks, chunk=args.chunk, with_metrics=False)
        per_family[fam] = sweep_mod.family_sweep(
            sim, scens, chunk=args.chunk, settle=args.settle)
    print(json.dumps({
        "n": args.n,
        "sweep": args.sweep,
        "mode": args.sweep_mode,
        "families": families,
        "pareto": sweep_mod.pareto_table(per_family),
        "dominates_default": sweep_mod.strict_dominators(per_family),
    }))
    return 0


def cmd_gameday(args) -> int:
    """Run the game-day soak (consul_tpu_torch/gameday; reference
    cli.py:1072-1110) and print its SLO verdict as one JSON line. SIGTERM
    mid-soak saves at the last drained phase boundary (with
    ``--resume-dir``) and exits 75; exit 0 = SLO pass, 1 = fail."""
    from consul_tpu_torch.gameday import GamedayConfig, run_gameday
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.runtime.policy import SignalTrap

    kernel = cuda_gossip.canonical_kernel(args.kernel)
    device = _device_of(args)
    _one_group(args, "gameday")
    try:
        cuda_gossip.validate_kernel(kernel, "packed", device)
    except ValueError as e:
        _fail("--kernel", str(e))
    cfg = GamedayConfig(
        n=args.n, seed=args.seed, view_degree=args.view_degree,
        watchers=args.watchers, watch_queue=args.watch_queue,
        ratio=args.ratio, read_batch=args.read_batch,
        raft_groups=args.raft_groups, raft_peers=args.raft_peers,
        dcn_islands=args.dcn_islands, frontend=args.frontend,
        warmup_ticks=args.warmup_ticks, ticks_per_round=args.ticks_per_round,
        steady_rounds=args.steady_rounds, fault_rounds=args.fault_rounds,
        heal_rounds=args.heal_rounds, drain_rounds=args.drain_rounds,
        partition_frac=args.partition_frac, churn_frac=args.churn_frac,
        swarm_procs=args.swarm_procs, swarm_requests=args.swarm_requests,
        resume_dir=args.resume_dir, device=device, kernel=kernel)
    say = ((lambda rec: print(json.dumps(rec), file=sys.stderr))
           if args.verbose else None)
    with SignalTrap() as trap:
        verdict = run_gameday(cfg, trap=trap, emit=say)
    print(json.dumps(verdict))
    if trap.fired is not None:
        return 75
    return 0 if verdict.get("pass") else 1


def cmd_run(args) -> int:
    """Advance a local simulation under the resilient harness (reference
    cli.py:1113-1137; no fault schedule: ``chaos`` is the faulted verb)
    and print the run report as one JSON line. With ``--layout auto`` /
    ``--budget`` the JSON carries the plan under ``memory_plan``; a
    population beyond the budget runs cohort-streamed and prints
    ``streamed: true``."""
    sim, plan = _build_sim(args)
    extra = {"n": args.n}
    if plan is not None:
        extra["memory_plan"] = plan.to_dict()
    if plan is not None and plan.streamed:
        return _streamed_report(args, sim, extra, sim.run(args.ticks))
    return _run_resilient_cmd(args, sim, None, args.ticks, extra)


def cmd_prewarm(args) -> int:
    """Build the kernels' library into the compile cache and warm every
    requested (n, kind, chunk, schedule) signature (utils/prewarm.py;
    reference cli.py:1140-1178); prints the summary as one JSON line.
    ``--layout auto`` warms each (n, kind)'s memory plan's signature
    (``MemoryPlan.prewarm_args``) and adds the plans as ``memory_plans``."""
    import torch

    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.parallel import mesh as mesh_mod
    from consul_tpu_torch.utils import prewarm as prewarm_mod

    device = _device_of(args)
    mesh = None
    if args.mesh:
        dims = [int(x) for x in args.mesh.lower().split("x")]
        if len(dims) not in (1, 2):
            _fail(f"--mesh {args.mesh!r}", "want NODES or DCxNODES")
        n_dc, per_dc = (1, dims[0]) if len(dims) == 1 else dims
        devices = ([] if torch.device(device).type == "cpu"
                   else mesh_mod.visible_devices())
        if len(devices) < n_dc * per_dc:
            _fail(f"--mesh {args.mesh}", f"{len(devices)} device(s) visible")
        mesh = mesh_mod.make_mesh(devices[:n_dc * per_dc], n_dc=n_dc)
    ns = [int(x) for x in args.n.split(",") if x]
    kinds = tuple(x.strip() for x in args.kinds.split(",") if x.strip())
    calls = [dict(ns=ns, kinds=kinds,
                  chunks=[int(x) for x in args.chunks.split(",") if x],
                  layout=args.layout)]
    plans = None
    if args.layout == "auto":
        # One plan per (n, kind); each warms its plan's signature.
        from consul_tpu_torch.config import SimConfig, clamp_view_degree
        from consul_tpu_torch.runtime import membudget

        kernel = cuda_gossip.canonical_kernel(args.kernel)
        try:
            plans = [membudget.plan(
                SimConfig(n=n, view_degree=clamp_view_degree(n, args.view_degree),
                          topo_family=args.family,
                          topo_param=args.family_param),
                kind, layout=_plan_layout(args, kernel), device=device)
                for n in ns for kind in kinds]
        except ValueError as e:
            _fail("--layout auto", str(e))
        calls = [p.prewarm_args() for p in plans]
    try:
        summaries = [prewarm_mod.prewarm(
            **call, mesh=mesh, device_count=args.devices, n_dc=args.n_dc,
            chaos=args.chaos, seed=args.seed, view_degree=args.view_degree,
            sentinel=args.sentinel, cache_dir=args.compile_cache,
            family=args.family, family_param=args.family_param,
            sweep=args.sweep, sweep_chunk=args.sweep_chunk,
            raft_groups=args.raft_groups, raft_peers=args.raft_peers,
            kernel=args.kernel, device=device) for call in calls]
    except ValueError as e:
        _fail("prewarm", str(e))
    summary = summaries[0]
    if len(summaries) > 1:
        cache = {}
        for sm in summaries:
            for k, v in sm["cache"].items():
                counted = isinstance(v, int) and not isinstance(v, bool)
                cache[k] = cache.get(k, 0) + v if counted else v
        summary = {"signatures": [x for sm in summaries
                                  for x in sm["signatures"]],
                   "compiled": sum(sm["compiled"] for sm in summaries),
                   "cache": cache,
                   "wall_s": round(sum(sm["wall_s"] for sm in summaries), 3)}
    if plans is not None:
        summary["memory_plans"] = [p.to_dict() for p in plans]
    print(json.dumps(summary))
    return 0


def cmd_serve_bench(args) -> int:
    """Benchmark the serving plane against a local simulation (reference
    cli.py:1181-1245): form a cluster, attach a ServingPlane and drive
    batched NearestN queries through its QueryBatcher, or with
    ``--mixed`` the read / write / watch mix; one JSON line with
    bench.py's serving keys."""
    import random
    import time

    from consul_tpu_torch.serving import MODE_NEAREST, ServingPlane

    sim, _ = _build_sim(args)
    sim.run(args.form_ticks, chunk=args.chunk, with_metrics=False)
    # Plain serve-bench keeps the unlabeled plane; --mixed wants a
    # service space for register churn and watch fan-out.
    services = args.services or (8 if args.mixed else 0)
    plane = ServingPlane(k=args.k, buckets=(args.batch,),
                         num_services=services, device=sim.device)
    sim.attach_serving(plane, writes=bool(args.mixed), kv_slots=args.kv_slots)
    rng = random.Random(args.seed)

    if args.mixed:
        from consul_tpu_torch.serving.mixed import run_mixed

        mixed = run_mixed(sim, plane, ratio=args.mixed,
                          rounds=args.mixed_rounds, read_batch=args.batch,
                          watchers=args.watchers, seed=args.seed)
        out = dict(plane.stats())
        out.update({"n": args.n, "k": args.k, "batch": args.batch,
                    "mixed": mixed})
    else:
        def make_batch(b: int):
            return [(MODE_NEAREST, rng.randrange(args.n), -1)
                    for _ in range(b)]

        # One warm batch outside the timed region, its latency dropped.
        plane.batcher.execute(make_batch(args.batch))
        plane.batcher.latencies_s.clear()
        total = 0
        t0 = time.perf_counter()
        while total < args.queries:
            b = min(args.batch, args.queries - total)
            plane.batcher.execute(make_batch(b))
            total += b
        wall = time.perf_counter() - t0
        out = dict(plane.stats())
        out.update({"n": args.n, "k": args.k, "batch": args.batch,
                    "queries": total, "wall_s": round(wall, 3),
                    "queries_per_sec_per_chip": round(total / wall, 1)})
    trace_path = _export_trace(args, sim)
    if trace_path:
        out["trace"] = trace_path
    print(json.dumps(out))
    return 0


def cmd_trace(args) -> int:
    """Flight-record a short local run (reference cli.py:1247-1266): arm
    the node lens, advance the simulation and write the trace artifact;
    one JSON line with its path."""
    sim, _ = _build_sim(args)
    trace = sim.run(args.ticks, chunk=args.chunk)
    path = _export_trace(args, sim)
    print(json.dumps({
        "n": args.n,
        "ticks": args.ticks,
        "lens_ids": list(sim.lens.ids) if sim.lens is not None else [],
        "agreement": (float(trace.agreement[-1]) if trace is not None
                      else None),
        "trace": path,
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m consul_tpu_torch.cli",
        description="consul-tpu's PyTorch/CUDA port: local simulation verbs")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="where the run's tensors live: cuda (default; "
                             "the kernel runs there) or cpu (with --kernel "
                             "torch)")

    def add_resilience_flags(sp):
        sp.add_argument("--ckpt-dir", default=None,
                        help="checkpoint directory; enables resume: rerun "
                             "the same command after a kill to continue "
                             "the trajectory bit-identically")
        sp.add_argument("--ckpt-tag", default=None,
                        help="checkpoint name (default: derived from "
                             "verb/n/seed)")
        sp.add_argument("--ckpt-interval-s", type=float, default=120.0,
                        help="minimum wall seconds between saves")
        sp.add_argument("--ckpt-every-ticks", type=int, default=0,
                        help="tick bound between save checks (0: wall "
                             "pacing only)")
        sp.add_argument("--sentinel", action="store_true",
                        help="arm the invariant sentinel (exit 2 on a "
                             "violation)")
        sp.add_argument("--sentinel-dump-dir", default=None,
                        help="where a sentinel trip dumps its diagnostic "
                             "checkpoint")
        sp.add_argument("--elastic", action="store_true",
                        help="run over the largest mesh the surviving "
                             "devices support, and re-shard a resumed "
                             "checkpoint onto it")
        sp.add_argument("--heartbeat-s", type=float, default=0.0,
                        help="per-chunk heartbeat deadline in seconds "
                             "(0: off)")
        sp.add_argument("--dcn-retry-max", type=int, default=None,
                        help="bound on consecutive DCN link retries "
                             "(parallel/dcn LinkPolicy)")
        sp.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="directory the kernels' library is built "
                             "into (or CONSUL_TPU_COMPILE_CACHE)")
        sp.add_argument("--state-digest", action="store_true",
                        help="add the final state's sha256 to the report "
                             "(a resumed run prints an uninterrupted "
                             "run's)")

    def add_mesh_flags(sp):
        sp.add_argument("--devices", type=int, default=None,
                        help="number of cards to mesh over (default: all "
                             "visible; 1 pins one device)")
        sp.add_argument("--n-dc", type=int, default=1,
                        help="fold a dc axis into the mesh")
        sp.add_argument("--prewarm", action="store_true",
                        help="build the kernels and warm this run's chunk "
                             "shapes before t0 (see the prewarm verb)")

    def add_obs_flags(sp, lens_default: int = 0):
        sp.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="write the trace artifact (host spans, chunk "
                             "markers, lens timelines) under DIR")
        sp.add_argument("--lens", type=int, default=lens_default,
                        metavar="N",
                        help="record N evenly spaced nodes' per-tick "
                             "observables (obs/lens.py; 0 = off)")

    def add_layout_flags(sp):
        sp.add_argument("--layout", choices=("auto", "dense", "packed"),
                        default="packed",
                        help="per-node state layout: packed (default; the "
                             "kernel's), dense (with --kernel torch), or "
                             "auto (the memory planner picks; packed under "
                             "--kernel cuda)")
        sp.add_argument("--budget", default=None, metavar="BYTES",
                        help="per-device memory budget, e.g. 8GB or 512MiB "
                             "(the memory planner; a population beyond it "
                             "runs cohort-streamed)")
        sp.add_argument("--kernel", choices=KERNEL_CHOICES, default="cuda",
                        help="tick engine: cuda (the CUDA tick kernel, "
                             "default) or torch (its plain version); pallas "
                             "and xla are their aliases")
        add_device_flag(sp)

    def add_family_flags(sp):
        sp.add_argument("--family", default="circulant",
                        help="view-graph family: circulant (default), "
                             "expander, smallworld, hier "
                             "(consul_tpu_torch/topo/families.py)")
        sp.add_argument("--family-param", type=float, default=0.0,
                        help="family parameter (0 = the family's default)")

    def add_raft_flags(sp):
        sp.add_argument("--raft-groups", type=int, default=0, metavar="R",
                        help="arm the batched raft tier with R groups "
                             "(0 = off)")
        sp.add_argument("--raft-peers", type=int, default=5, metavar="P",
                        help="peers per raft group (odd)")

    rn = sub.add_parser(
        "run", help="advance a local simulation under the resilient harness")
    rn.add_argument("--n", type=int, default=1024)
    rn.add_argument("--seed", type=int, default=0)
    rn.add_argument("--view-degree", type=int, default=16)
    add_family_flags(rn)
    rn.add_argument("--ticks", type=int, default=256)
    rn.add_argument("--chunk", type=int, default=32)
    rn.add_argument("--serf", action="store_true",
                    help="run the full serf step (event/query plane)")
    add_resilience_flags(rn)
    add_mesh_flags(rn)
    add_layout_flags(rn)
    add_obs_flags(rn)
    add_raft_flags(rn)

    tr = sub.add_parser(
        "trace", help="flight-record a short local run: host spans, chunk "
                      "markers and per-node lens timelines in one file")
    tr.add_argument("--n", type=int, default=1024)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--view-degree", type=int, default=16)
    add_family_flags(tr)
    tr.add_argument("--ticks", type=int, default=256)
    tr.add_argument("--chunk", type=int, default=32)
    tr.add_argument("--serf", action="store_true",
                    help="trace the full serf step (event/query plane)")
    # The lens is single-device: the default mesh is pinned off.
    tr.add_argument("--devices", type=int, default=1, help=argparse.SUPPRESS)
    tr.add_argument("--trace-dir", default="traces", metavar="DIR",
                    help="artifact directory (default: ./traces)")
    tr.add_argument("--lens", type=int, default=8, metavar="N",
                    help="record N evenly spaced nodes' per-tick "
                         "observables (obs/lens.py; 0 = off)")
    add_raft_flags(tr)
    tr.add_argument("--kernel", choices=KERNEL_CHOICES, default="cuda",
                    help="tick engine (cuda or torch)")
    add_device_flag(tr)

    sv = sub.add_parser(
        "serve-bench", help="benchmark the serving plane (batched NearestN "
                            "reads straight from the simulation tensors)")
    sv.add_argument("--n", type=int, default=4096)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--view-degree", type=int, default=16)
    add_family_flags(sv)
    sv.add_argument("--form-ticks", type=int, default=64,
                    help="ticks to form the cluster before serving")
    sv.add_argument("--chunk", type=int, default=32)
    sv.add_argument("--queries", type=int, default=65536,
                    help="total queries to serve in the timed region")
    sv.add_argument("--batch", type=int, default=512,
                    help="batch bucket size")
    sv.add_argument("--k", type=int, default=8,
                    help="result width (top-k nearest per query)")
    sv.add_argument("--serf", action="store_true",
                    help="serve over the full serf simulation")
    sv.add_argument("--mixed", nargs="?", const="90:9:1", default=None,
                    metavar="R:W:WATCH",
                    help="run the mixed read/write/watch workload at this "
                         "ratio (flag alone = 90:9:1)")
    sv.add_argument("--mixed-rounds", type=int, default=32,
                    help="interleaved rounds for --mixed")
    sv.add_argument("--services", type=int, default=0,
                    help="synthetic service label count (0: unlabeled, or "
                         "8 under --mixed)")
    sv.add_argument("--kv-slots", type=int, default=256,
                    help="device KV slot capacity (--mixed)")
    sv.add_argument("--watchers", type=int, default=8,
                    help="registered service watchers (--mixed)")
    sv.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory the kernels' library is built into")
    sv.add_argument("--kernel", choices=KERNEL_CHOICES, default="cuda",
                    help="tick engine (cuda or torch)")
    add_device_flag(sv)
    add_mesh_flags(sv)
    add_obs_flags(sv)

    ch = sub.add_parser(
        "chaos", help="run a fault-schedule scenario locally, print SLO JSON")
    ch.add_argument("--n", type=int, default=1024)
    ch.add_argument("--seed", type=int, default=0)
    ch.add_argument("--view-degree", type=int, default=16)
    add_family_flags(ch)
    ch.add_argument("--form-ticks", type=int, default=64,
                    help="ticks to form the cluster before the faults")
    ch.add_argument("--chunk", type=int, default=32)
    ch.add_argument("--settle", type=int, default=64,
                    help="post-lift window for the heal probe")
    ch.add_argument("--serf", action="store_true",
                    help="run the full serf step (event/query plane)")
    ch.add_argument("--partition", action="append", metavar="START,STOP,FRAC")
    ch.add_argument("--link-loss", action="append",
                    metavar="START,STOP,FRAC_A,FRAC_B,FWD[,REV]")
    ch.add_argument("--churn", action="append", metavar="START,STOP,FRAC")
    ch.add_argument("--degrade", action="append",
                    metavar="START,STOP,FRAC,TX[,RX]")
    ch.add_argument("--raft-kill", action="append",
                    metavar="START,STOP[,GROUP[,PEER]]",
                    help="freeze a raft peer for the window (group -1 = "
                         "every group, peer -1 = the leader at each tick); "
                         "needs --raft-groups")
    ch.add_argument("--raft-partition", action="append",
                    metavar="START,STOP,CUT[,GROUP]",
                    help="split a raft group's peers at seat CUT; needs "
                         "--raft-groups")
    ch.add_argument("--raft-storm", action="append",
                    metavar="START,STOP[,GROUP]",
                    help="total message blackout of a raft group; needs "
                         "--raft-groups")
    ch.add_argument("--sweep", type=int, default=0, metavar="S",
                    help="run S scenarios per family, each in a lane of its "
                         "own (chaos/sweep.py), and print the Pareto table")
    ch.add_argument("--sweep-mode", choices=("grid", "random"), default="grid",
                    help="scenario search: partition fraction x duration "
                         "grid, or seeded random compound scenarios")
    ch.add_argument("--sweep-seed", type=int, default=0,
                    help="seed for --sweep-mode random")
    ch.add_argument("--families", default=None, metavar="F1,F2,...",
                    help="view-graph families to sweep (default: --family; "
                         "'all' = every registered family that fits n)")
    add_resilience_flags(ch)
    add_mesh_flags(ch)
    add_layout_flags(ch)
    add_obs_flags(ch)
    add_raft_flags(ch)

    gd = sub.add_parser(
        "gameday", help="run the game-day soak (composed chaos, live "
                        "traffic, watchers, DCN leg) and print the verdict")
    gd.add_argument("--n", type=int, default=4096)
    gd.add_argument("--seed", type=int, default=0)
    gd.add_argument("--view-degree", type=int, default=16)
    gd.add_argument("--watchers", type=int, default=1024,
                    help="registered watchers on the reduction tree")
    gd.add_argument("--watch-queue", type=int, default=8,
                    help="per-watcher bounded delivery queue")
    gd.add_argument("--ratio", default="90:9:1", metavar="R:W:WATCH",
                    help="read:write:watch traffic mix per round")
    gd.add_argument("--read-batch", type=int, default=256)
    gd.add_argument("--raft-groups", type=int, default=4)
    gd.add_argument("--raft-peers", type=int, default=3)
    gd.add_argument("--dcn-islands", type=int, default=2,
                    help="DCN federation islands for the WAN leg (0 skips "
                         "the leg)")
    gd.add_argument("--frontend", choices=("threaded", "async"),
                    default="threaded",
                    help="host frontend: threaded or the one-event-loop "
                         "async frontend (serving/frontend.py)")
    gd.add_argument("--warmup-ticks", type=int, default=64)
    gd.add_argument("--ticks-per-round", type=int, default=32)
    gd.add_argument("--steady-rounds", type=int, default=4)
    gd.add_argument("--fault-rounds", type=int, default=6)
    gd.add_argument("--heal-rounds", type=int, default=4)
    gd.add_argument("--drain-rounds", type=int, default=4)
    gd.add_argument("--partition-frac", type=float, default=0.25,
                    help="fraction of nodes on the cut side of the "
                         "composed partition")
    gd.add_argument("--churn-frac", type=float, default=0.05,
                    help="fraction of nodes in the churn wave")
    gd.add_argument("--swarm-procs", type=int, default=0,
                    help="HTTP client swarm processes against the async "
                         "frontend's listener (0 = off)")
    gd.add_argument("--swarm-requests", type=int, default=64,
                    help="requests per swarm process")
    gd.add_argument("--resume-dir", default=None, metavar="DIR",
                    help="preemption resume directory: SIGTERM saves at the "
                         "last drained phase boundary and exits 75")
    gd.add_argument("--verbose", action="store_true",
                    help="stream per-phase progress JSON to stderr")
    gd.add_argument("--kernel", choices=KERNEL_CHOICES, default="cuda",
                    help="tick engine (cuda or torch)")
    gd.add_argument("--devices", type=int, default=None,
                    help="cards to run over (one device group: the "
                         "reference's run_gameday takes no mesh)")
    add_device_flag(gd)

    pw = sub.add_parser(
        "prewarm", help="build the kernels into the compile cache and warm "
                        "the chunk shapes a later run takes")
    pw.add_argument("--n", default="4096", help="comma-separated node counts")
    pw.add_argument("--kinds", default="swim",
                    help="comma list of step kinds: swim,serf,serf_reference")
    pw.add_argument("--chunks", default="32",
                    help="comma-separated chunk sizes")
    pw.add_argument("--mesh", default=None, metavar="[DCx]NODES",
                    help="device grid to warm for, e.g. 4 or 2x2")
    pw.add_argument("--devices", type=int, default=None,
                    help="devices for the default mesh (1 = one device)")
    pw.add_argument("--n-dc", type=int, default=1)
    pw.add_argument("--chaos", action="store_true",
                    help="also warm the schedule variant on the default "
                         "one-partition scenario")
    pw.add_argument("--sentinel", action="store_true",
                    help="warm the sentinel-armed variants")
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--view-degree", type=int, default=16)
    add_family_flags(pw)
    pw.add_argument("--sweep", type=int, default=0, metavar="S",
                    help="also warm a sweep lane of S scenarios' shape")
    pw.add_argument("--sweep-chunk", type=int, default=32)
    pw.add_argument("--raft-groups", type=int, default=0, metavar="R",
                    help="also arm the raft tier (R groups)")
    pw.add_argument("--raft-peers", type=int, default=5, metavar="P")
    pw.add_argument("--layout", choices=("auto", "dense", "packed"),
                    default="packed", help="state layout to warm")
    pw.add_argument("--kernel", choices=KERNEL_CHOICES, default="cuda",
                    help="tick engine to warm (cuda or torch)")
    pw.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory the kernels' library is built into "
                         "(or CONSUL_TPU_COMPILE_CACHE)")
    add_device_flag(pw)
    return p


COMMANDS = {"run": cmd_run, "trace": cmd_trace, "chaos": cmd_chaos,
            "gameday": cmd_gameday, "serve-bench": cmd_serve_bench,
            "prewarm": cmd_prewarm}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return COMMANDS[args.cmd](args)
    except SystemExit as e:
        return int(e.code or 0)


if __name__ == "__main__":
    sys.exit(main())
