"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA tick kernel from ``consul_tpu_torch/csrc``, holds it
against its plain PyTorch version at the bench's default shape, at a
ragged size and at the main path's own shape, drives the port's main
path (a 1,048,576-node, K = 32 view converging after a 5 % mass kill)
through ``Simulation``, and prints one JSON line per phase, the kernel
table, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. It
needs a CUDA H100 and the rest of the repository; without either it
fails before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

# HBM rate of the card the bound is stated for: NVIDIA's data sheet for
# the H100 SXM (80 GB HBM3, 3.35 TB/s at its full 700 W).
H100_SXM_BYTES_PER_S = 3.35e12

# The packed layout's float leaves round to bfloat16 (Vivaldi) or to the
# x256 float8 codec (RTT and adjustment windows) every tick. The kernel
# and the plain version do the same f32 operations, but may sum Vivaldi's
# short reductions in another order, so a last-bit difference can flip a
# rounding, and 32 ticks can carry it on. An element passes if it is at
# most MAX_STEPS storage steps (ulps) from the plain version's, or if the
# decoded values differ by at most FLOOR_S seconds: height_min, the
# smallest height Vivaldi keeps, the floor for values that cross zero.
# The step limit is one above the largest seen (PERF.md).
MAX_STEPS = 3
FLOOR_S = 1e-5
FLOAT_LEAVES = ("vec", "height", "error", "adjustment", "adj_samples", "lat_buf")

# The main path: the reference bench's north star (bench.py:152-154, 1044).
MAIN_N = 1_048_576
# Parity runs: the bench's default shape and a ragged size no block size
# divides (with 1 % packet loss), and the main path's own configuration.
PARITY = ((65536, 0.01), (50000, 0.01), (MAIN_N, 0.0))
PARITY_TICKS = 32
PARITY_MAX_WARM = 4096


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def mem_rate(name: str) -> float:
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return H100_SXM_BYTES_PER_S
    raise RuntimeError(f"no memory rate on record for {name!r}: the bound is "
                       "stated for the H100 SXM")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_breakdown(fn, reps: int):
    """Device ms per call of each CUDA kernel that ``fn`` launches, by
    name, from the profiler; "not measured" if it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if ev.key.startswith("k_") and us:
            out[ev.key] = us / 1000.0 / reps
    return out or "not measured"


def parity(n: int, packet_loss: float, ticks: int, seed: int):
    """Kernel vs plain version from one state with one draw bundle per
    tick: discrete packed leaves and counters equal on every tick, float
    leaves within MAX_STEPS / FLOOR_S. The window opens just after the
    first deaths of a 5 % kill, with another 2.5 % just back from a stall,
    so that suspicion, death and refutation all fire in it."""
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import layout, state as sim_state, swim
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    cfg = SimConfig(n=n, view_degree=32, packet_loss=packet_loss)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack(sim_state.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo)
    deaths = FIELDS.index("deaths_declared")

    def step(st):
        return tick(world, st, swim.draw_tick(cfg, gen, dev))

    # Warm up through the kernel (the window compares from whatever state
    # it reaches): 32 ticks, kill 5 %, run on until the suspicions of the
    # dead reach their Lifeguard timeout and deaths fire as a wave (n/1000
    # in one tick, not a stray false positive of the packet loss). Then
    # stall another 2.5 % for 8 ticks (down, then up at the same
    # incarnation, as after a long pause): they are suspected and refute
    # inside the window.
    for _ in range(32):
        st, _ = step(st)
    kill = torch.zeros(n, dtype=torch.bool, device=dev)
    kill[: n // 20] = True
    st = layout.pack(sim_state.kill(layout.unpack(st), kill))
    warm = 32
    while True:
        st, c = step(st)
        warm += 1
        if int(c[deaths]) >= max(1, n // 1000) or warm >= PARITY_MAX_WARM:
            break
    pause = torch.zeros_like(kill)
    pause[n // 2: n // 2 + n // 40] = True
    st = layout.pack(sim_state.kill(layout.unpack(st), pause))
    for _ in range(8):
        st, _ = step(st)
    sw = layout.unpack(st)
    st = layout.pack(sw._replace(alive_truth=sw.alive_truth | pause))
    for _ in range(2):
        st, _ = step(st)
    warm += 10

    kp, pp = st, st
    totals = torch.zeros(len(FIELDS), dtype=torch.int64)
    bad = []
    gaps = {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
    for t in range(ticks):
        d = swim.draw_tick(cfg, gen, dev)
        kp, kc = tick(world, kp, d)
        pp, pc = cuda_gossip.plain_tick(cfg, topo, world, pp, d)
        torch.cuda.synchronize()
        if not torch.equal(kc, pc):
            bad.append(f"tick {t} counters {kc.tolist()} != {pc.tolist()}")
        totals += pc.cpu().to(torch.int64)
        pairs = list(zip(kp._fields[:-1], kp[:-1], pp[:-1])) + [
            ("viv." + f, a, b) for f, a, b in zip(kp.viv._fields, kp.viv, pp.viv)]
        for name, a, b in pairs:
            base = name.split(".")[-1]
            if base in FLOAT_LEAVES:
                steps, diff = layout.float_gap(a, b)
                g = gaps[base]
                # Steps are reported where the floor does not cover them.
                g["steps"] = max(g["steps"], int(torch.where(
                    diff > FLOOR_S, steps, torch.zeros_like(steps)).max()))
                g["abs"] = max(g["abs"], float(diff.max()))
                nbad = int(((steps > MAX_STEPS) & (diff > FLOOR_S)).sum())
                if nbad:
                    bad.append(f"tick {t} {name}: {nbad} elements beyond "
                               f"{MAX_STEPS} steps and {FLOOR_S} s")
            elif not torch.equal(a, b):
                nbad = int((a != b).sum()) if a.dim() else 1
                bad.append(f"tick {t} {name}: {nbad} elements differ")
        if bad:
            break
    fired = {f: int(totals[FIELDS.index(f)]) for f in (
        "suspicions_started", "deaths_declared", "refutations",
        "probe_timeouts", "pushpull_merges")}
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, ticks=ticks,
                warm=warm, mismatches=bad[:5], float_gaps=gaps,
                counters_in_window=fired)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, layout, swim
    from consul_tpu_torch.ops import cuda_gossip

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "mem_rate_bytes_per_s": rate})

    info = cuda_gossip.build()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": round(info.seconds, 3),
          "library": os.path.relpath(info.path), "ptxas": regs})

    failed = []
    max_abs = 0.0
    for n, loss in PARITY:
        t0 = time.perf_counter()
        res = parity(n, loss, PARITY_TICKS, seed=7)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = not res["mismatches"] and all(
            res["counters_in_window"][f] > 0
            for f in ("suspicions_started", "deaths_declared", "refutations"))
        max_abs = max([max_abs] + [g["abs"] for g in res["float_gaps"].values()])
        emit({"phase": "kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"kernel_parity n={n}")
    if failed:
        emit({"phase": "failed", "failed": failed})
        return 1

    # Main path: the north-star cell through the user's entry points.
    cfg = SimConfig(n=MAIN_N, view_degree=32)
    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda")
    setup_s = time.perf_counter() - t0
    for k in cuda_gossip.LAUNCHES:
        cuda_gossip.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    mask = torch.zeros(cfg.n, dtype=torch.bool)
    mask[: cfg.n // 20] = True
    sim.kill(mask)
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_gossip.LAUNCHES)
    total_launches = sum(launches.values())
    agreement = float(trace.agreement[-1])
    rmse_ms = float(trace.rmse[-1]) * 1000.0
    finite = bool(torch.isfinite(trace.rmse).all()) and bool(
        torch.isfinite(layout.unpack(sim.state).viv.vec).all())
    emit({"phase": "main_path", "n": cfg.n, "k": cfg.degree,
          "converged": converged, "ticks_after_kill": used,
          "ticks_total": sim._t, "agreement": agreement, "rmse_ms": rmse_ms,
          "wall_s": round(wall, 3), "setup_s": round(setup_s, 3),
          "launches": launches, "counters": sim.counters,
          "bytes_per_node": layout.bytes_per_node(sim.state, cfg.n)})
    if not (converged and agreement == 1.0 and total_launches > 0 and finite):
        emit({"phase": "failed", "failed": ["main_path"]})
        return 1

    # Kernel timing at the main path's shapes, on its final state.
    tick = cuda_gossip.make_tick_kernel(cfg, sim.topo)
    d = swim.draw_tick(cfg, sim.gen, sim.device)
    st = sim.state
    ms = cuda_ms(lambda: tick(sim.world, st, d), 20)
    plain_ms = cuda_ms(lambda: cuda_gossip.plain_tick(cfg, sim.topo, sim.world,
                                                      st, d), 3)
    stages = launch_breakdown(lambda: tick(sim.world, st, d), 5)
    contract = cuda_gossip.tick_hbm_bytes_per_node(st, sim.world)
    bound_ms = contract * cfg.n / rate * 1e3
    buffers = tick.buffer_bytes_per_node(sim.world, st, d)
    emit({"phase": "timing", "ms_per_tick": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "contract_bytes_per_node": contract,
          "buffer_bytes_per_node": buffers,
          "buffer_bytes_per_s": buffers * cfg.n / (ms * 1e-3),
          "ms_by_launch": stages})

    print(json.dumps({"kernels": [{
        "name": "gossip_tick", "route": "cuda",
        "source": "consul_tpu_torch/csrc/gossip_tick.cu",
        "replaces": "consul_tpu/ops/pallas_gossip.py:145",
        "launches": total_launches, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
