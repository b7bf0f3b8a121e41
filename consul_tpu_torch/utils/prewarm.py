"""Prewarm: build and warm the device path off the critical path (PyTorch
port of ``consul_tpu/utils/prewarm.py``).

The reference AOT-compiles every chunk-program signature into JAX's
persistent compile cache, so that a later ``run`` starts with
``compile_s ~ 0``. The port compiles one thing, the tick kernel's shared
library (``ops/cuda_gossip.build``, cached on disk in
``utils/compile_cache``'s directory), and the rest of a cold start is
the card's: the CUDA context, the kernels' module load, the caching
allocator's first blocks and the occupancy queries of each launch's
first call. :func:`prewarm_simulation` pays all of it by running one
chunk of the run's shape on a copy of the state, then puts back
everything that chunk moved (the state and tick, both draw generators,
the counters, the sink, the chunk sequence, ``cuda_gossip.LAUNCHES``), so
a prewarmed run is bit-equal to a cold one. :func:`prewarm` does that for
every requested (n, kind, chunk, metrics, schedule) signature and
reports what the builds resolved to.

CUDA-graph capture of a chunk and of the raft step (ROADMAP A20) would
change how the main path runs, not warm it, and is not here.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from consul_tpu_torch.ops import cuda_gossip
from consul_tpu_torch.utils import compile_cache, telemetry


def _scratch_state(sim):
    """A copy of ``sim``'s state as it is stored (by row block under a
    mesh: the gathered whole placed anew)."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.parallel import shard_step

    if sim.mesh is None:
        return cluster._clone(sim.state)
    return shard_step.place(sim.mesh, sim._whole(), sim.cfg.n)


def _sync(sim):
    devices = sim.mesh.unique_devices() if sim.mesh is not None else [sim.device]
    for dev in devices:
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)


def prewarm_simulation(sim, chunk: int, with_metrics: bool) -> float:
    """Warm ``sim``'s path for ``Simulation.run(ticks, chunk,
    with_metrics)``: build the kernel's library (``kernel="cuda"``) and
    run one ``chunk``-tick chunk of that shape, with the installed
    schedule and sentinel, on a copy of the state, without the raft tier,
    the node lens or the serving plane. Then the state and tick, the draw
    generators, the counters, the sink (and the tracer's), the chunk
    sequence and the launch counts are put back. Returns the wall
    seconds."""
    from consul_tpu_torch.obs import trace as obs_trace

    t0 = time.perf_counter()
    if sim.kernel == cuda_gossip.CUDA:
        cuda_gossip.build()
    tracer = obs_trace.get_tracer()
    gens = [g for g in (sim.gen, getattr(sim, "_ev_gen", None)) if g is not None]
    saved = dict(
        state=sim.state, t=sim._t, gens=[g.get_state() for g in gens],
        counters=dict(sim._counters), pending=list(sim._pending_counters),
        chunks=list(sim.chunk_counters), sink=sim.sink,
        tracer_sink=tracer._sink, warmed=set(sim._warmed),
        seq=sim._chunk_seq, lens=(sim.lens, sim._lens_row), raft=sim.raft,
        launches=dict(cuda_gossip.LAUNCHES),
        sharded=dict(cuda_gossip.SHARDED_LAUNCHES),
        kernel_launches=getattr(sim._tick_fn, "launches", None))
    try:
        sim.state = _scratch_state(sim)
        sim.sink = telemetry.Sink()
        tracer.attach_sink(sim.sink)
        sim.lens, sim._lens_row, sim.raft = None, None, None
        sim._exec_chunk(chunk, with_metrics)
        _sync(sim)
    finally:
        sim.state, sim._t = saved["state"], saved["t"]
        for g, st in zip(gens, saved["gens"]):
            g.set_state(st)
        sim._counters = saved["counters"]
        sim._pending_counters = saved["pending"]
        sim.chunk_counters = saved["chunks"]
        sim.sink = saved["sink"]
        tracer.attach_sink(saved["tracer_sink"])
        sim._warmed = saved["warmed"]
        sim._chunk_seq = saved["seq"]
        sim.lens, sim._lens_row = saved["lens"]
        sim.raft = saved["raft"]
        cuda_gossip.LAUNCHES.update(saved["launches"])
        cuda_gossip.SHARDED_LAUNCHES.update(saved["sharded"])
        if saved["kernel_launches"] is not None:
            sim._tick_fn.launches = saved["kernel_launches"]
    return time.perf_counter() - t0


def _prewarm_sweep(sim, n: int, sweep: int) -> float:
    """One tick of a one-lane sweep of ``scenario_grid(n, sweep)``'s shape
    (the lanes' tick: the schedule variant with the sentinel off);
    ``_run_lanes`` leaves the simulation as it was, and the launch counts
    are put back."""
    from consul_tpu_torch.chaos import sweep as sweep_mod

    t0 = time.perf_counter()
    launches = dict(cuda_gossip.LAUNCHES)
    try:
        scheds, _ = sweep_mod.compile_scenarios(
            sim, sweep_mod.scenario_grid(n, sweep))
        sim._run_lanes(scheds[:1], 1)
        _sync(sim)
    finally:
        cuda_gossip.LAUNCHES.update(launches)
    return time.perf_counter() - t0


def _mesh_shape(mesh) -> Optional[list]:
    return None if mesh is None else [int(x) for x in mesh.shape]


def prewarm(ns: Sequence[int], kinds: Sequence[str] = ("swim",),
            chunks: Sequence[int] = (64,),
            metrics_modes: Sequence[bool] = (False, True),
            mesh=None, device_count: Optional[int] = None, n_dc: int = 1,
            chaos: bool = False, seed: int = 0, view_degree: int = 16,
            sentinel: bool = False, cache_dir: Optional[str] = None,
            layout: str = "packed", family: str = "circulant",
            family_param: float = 0.0, sweep: int = 0,
            sweep_chunk: int = 32, raft_groups: int = 0,
            raft_peers: int = 5, kernel: str = cuda_gossip.CUDA,
            device: str = "cuda") -> dict:
    """Warm every (n, kind, chunk, metrics, schedule) signature and return
    the reference's summary: ``signatures`` (one dict each, with its wall
    seconds), ``compiled`` (their count), ``cache`` (the builds' hit and
    miss movement, ``compile_cache.stats_delta``) and ``wall_s``.

    ``kinds`` take ``swim``, ``serf`` and ``serf_reference`` (the
    pre-fusion oracle, B8 on the card). ``mesh`` overrides the default
    (``parallel.mesh.default_mesh`` over the visible cards, with
    ``device_count`` / ``n_dc``; none on the CPU). ``chaos=True`` also
    warms the schedule variant on the default one-partition scenario,
    ``sweep=S`` a sweep lane of ``scenario_grid(n, S)``'s shape,
    ``raft_groups=R`` arms the raft tier first (its step is eager
    PyTorch: it warms with the chunk). ``kernel`` takes the reference's
    ``pallas`` / ``xla`` as aliases."""
    from consul_tpu_torch import chaos as chaos_api
    from consul_tpu_torch.config import SimConfig, clamp_view_degree
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.parallel import mesh as mesh_mod

    if cache_dir:
        compile_cache.enable(cache_dir)
    else:
        compile_cache.maybe_enable_from_env()
    classes = {"swim": cluster.Simulation, "serf": cluster.SerfSimulation,
               "serf_reference": cluster.ReferenceSerfSimulation}
    for kind in kinds:
        if kind not in classes:
            raise ValueError(f"unknown kind {kind!r} "
                             f"({'|'.join(classes)})")
    kernel = cuda_gossip.canonical_kernel(kernel)
    on_cpu = torch.device(device).type == "cpu"
    before = compile_cache.stats()
    t_start = time.perf_counter()
    signatures = []
    for n in ns:
        m = mesh if mesh is not None else mesh_mod.default_mesh(
            n, device_count=device_count, n_dc=n_dc,
            devices=[] if on_cpu else None)
        dev = m.devices[0] if m is not None else device
        for kind in kinds:
            cfg = SimConfig(n=n, view_degree=clamp_view_degree(n, view_degree),
                            topo_family=family, topo_param=family_param)
            sim = classes[kind](cfg, seed=seed, mesh=m, layout=layout,
                                kernel=kernel, device=dev)
            sim.set_sentinel(sentinel)
            if raft_groups > 0:
                sim.set_raft(raft_groups, peers=raft_peers)
            schedules = [None]
            if chaos:
                schedules.append([chaos_api.Partition(
                    start=4, stop=16, side_a=slice(0, max(1, n // 3)))])
            common = {"n": int(n), "kind": kind, "mesh": _mesh_shape(m),
                      "layout": layout, "kernel": kernel, "device": str(dev),
                      "raft_groups": int(raft_groups)}
            for sched in schedules:
                sim.set_chaos(sched)
                for chunk in chunks:
                    for with_metrics in metrics_modes:
                        wall = prewarm_simulation(sim, chunk, with_metrics)
                        signatures.append(dict(
                            common, chunk=int(chunk),
                            with_metrics=bool(with_metrics),
                            chaos=sched is not None, family=family,
                            wall_s=round(wall, 3)))
            if sweep > 0:
                sim.set_chaos(None)
                wall = _prewarm_sweep(sim, n, sweep)
                signatures.append(dict(
                    common, chunk=int(sweep_chunk), with_metrics=False,
                    chaos=True, family="*", sweep=int(sweep),
                    wall_s=round(wall, 3)))
    return {
        "signatures": signatures,
        "compiled": len(signatures),
        "cache": compile_cache.stats_delta(before),
        "wall_s": round(time.perf_counter() - t_start, 3),
    }
