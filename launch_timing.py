"""Per-launch device times of the CUDA tick kernel on fixed states.

Run from the root of a checkout, on one NVIDIA card:

    python3 launch_timing.py [--reps N] [--states NAME,NAME,...]

It imports ``consul_tpu_torch`` from the directory it is run from, builds
that checkout's kernel, makes the states below from seeds through that
kernel, and times every launch of one tick on each (the profiler's
device time per launch, and CUDA events for the whole tick), and launch
M (the TickTrace row) on each state's SWIM plane. The states
are ones that any kernel equal to the plain version bit for bit reaches,
so running this script from two checkouts (``cd other && python3
/path/to/launch_timing.py``) times two versions of the kernel on the same
inputs; alternate them in one call (A, B, A, B) to compare. Each state is
timed twice, in a first pass over all of them and again in a second, so
an effect of what ran before shows as a difference between the passes.

States, at n = 1,048,576 and K = 32 unless noted, each 32 ticks old when
a 5 % kill lands (the serf ones also fire an event storm from 4 live
rows, a query and a leave then), then 64 ticks on:
- ``bare``: the SWIM tick;
- ``serf``: the serf tick;
- ``serf_chaos``: the serf tick with the sentinel under a partition, a
  churn wave, a lossy link and a degraded block opened at the kill;
- ``chaos``: the SWIM tick with the sentinel under that schedule (launch
  P, then A, B and C reading its row word and record);
- ``dense_serf``: the serf tick on the dense view, n = 256 (K = 255);
- ``dense_chaos``, ``dense_serf_chaos``: the SWIM and the serf tick on the
  dense view at n = 256 with the sentinel under that schedule;
- ``wan``: the SWIM tick on the dense view at n = 12 (K = 11), the shape
  of the federation's WAN pool;
- ``lan_250k``: the SWIM tick at n = 250,000, the shape of one of the
  federation's LAN pools.
The first four are timed unless ``--states`` names others. The ticks
on the dense view and at n = 12 are bound by the wrapper's host work, so
their CUDA-event time over back-to-back ticks is that work's.

Each pass also times a launch that does no work (a one-element add,
its profiler device time): the floor of the launch-bound launches.

Prints one JSON line per state and pass, the card's name and power limit
as ``nvidia-smi`` gives them, and a last JSON line with every reading.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

MAIN_N = 1_048_576
DENSE_N = 256
WARM, AFTER = 32, 64
STATES = ("bare", "serf", "serf_chaos", "dense_serf", "dense_chaos",
          "dense_serf_chaos", "wan", "lan_250k", "chaos")
DEFAULT_STATES = STATES[:4]


def make_state(name: str):
    """(tick kernel, world, state, draw, schedule) of one named state."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import SerfConfig, SimConfig
    from consul_tpu_torch.models import layout, serf, state as sim_state, swim
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    n = {"wan": 12, "lan_250k": 250_000}.get(
        name, DENSE_N if name.startswith("dense") else MAIN_N)
    serf_plane = "serf" in name
    chaos_on = name.endswith("chaos")
    cfg = SimConfig(n=n, view_degree=0 if n <= DENSE_N else 32,
                    packet_loss=0.01, serf=SerfConfig(query_relay_factor=2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=serf_plane,
                                        sentinel=chaos_on)

    def draw():
        if serf_plane:
            return serf.draw_serf_tick(cfg, gen, dev, chaos=chaos_on)
        return swim.draw_tick(cfg, gen, dev, chaos=chaos_on)

    def rows(rs):
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        m[rs] = True
        return m

    init = serf.init(cfg, gen, dev) if serf_plane else sim_state.init(cfg, gen, dev)
    st = layout.pack_state(init)
    for _ in range(WARM):
        st, _ = tick(world, st, serf.draw_serf_tick(cfg, gen, dev)
                     if serf_plane else swim.draw_tick(cfg, gen, dev))
    d = layout.unpack_state(st)
    dead = torch.arange(n, device=dev) < n // 20
    sched = None
    if serf_plane:
        d = d._replace(swim=sim_state.kill(d.swim, dead))
        d = serf.user_event(cfg, d, rows([n // 20 + 1 + (n // 8) * j
                                          for j in range(4)]), 1)
        d = serf.query(cfg, d, rows([n // 2 + 3]), 3)
        d = serf.leave(cfg, d, rows([3 * n // 4 + 11]))
    else:
        d = sim_state.kill(d, dead)
    st = layout.pack_state(d)
    if chaos_on:
        events = [chaos.Partition(0, 4 * AFTER, side_a=slice(0, n // 4)),
                  chaos.ChurnWave(0, 4 * AFTER, nodes=slice(n // 2, n // 2 + n // 20),
                                  period=16, down_ticks=8),
                  chaos.LinkLoss(0, 4 * AFTER, a=slice(n // 4, 3 * n // 8),
                                 b=slice(3 * n // 8, n // 2), fwd=0.8, rev=0.2),
                  chaos.Degrade(0, 4 * AFTER, nodes=slice(n - n // 8, n),
                                tx_loss=0.4)]
        sched = chaos.shift_schedule(chaos.compile_schedule(n, events, dev),
                                     int(layout.tick_of(st)))
    for _ in range(AFTER):
        st, _ = tick(world, st, draw(), sched)
    torch.cuda.synchronize()
    return tick, world, st, draw(), sched


def _events_ms(fn, count: int) -> float:
    """ms per call of ``fn`` by CUDA events over ``count`` back-to-back
    calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def _device_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name
    (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if ev.key.startswith("k_") and us:
            out[ev.key.split("(")[0]] = us / 1000.0 / reps
    return out


def floor_ms(reps: int = 200) -> dict:
    """Device ms of a launch that does no work: the profiler's mean over
    ``reps`` one-element adds in one session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            x.add_(1.0)
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == DeviceType.CUDA]
    if not us:
        return {"ms": "not measured", "launches": 0}
    return {"ms": sum(us) / len(us) / 1000.0, "launches": len(us),
            "ms_min": min(us) / 1000.0}


def time_state(tick, world, st, d, sched, reps):
    """ms per launch (profiler device time, by kernel name) and ms per
    tick (CUDA events over 20 ticks) of the tick on one state; and launch
    M (the TickTrace row, 2,048 RMSE pairs from a seed) on the state's
    SWIM plane, its device ms (profiler) and ms per launch by events."""
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.utils import metrics

    def fn():
        tick(world, st, d, sched)

    ms = _events_ms(fn, 20)
    launches = _device_ms(fn, reps)
    mk = cuda_gossip.make_metrics_kernel(tick.cfg, tick.topo)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    i, j = metrics.rmse_samples(tick.cfg, gen, 2048, "cuda")
    out = torch.empty(4, device="cuda")
    sw = st.swim if tick.serf else st

    def m():
        mk(world, sw, i, j, out)

    m_ms_events = _events_ms(m, 50)
    m_dev = _device_ms(m, 4 * reps)
    return dict(ms_per_tick=ms, ms_by_launch=launches or "not measured",
                metrics_ms=m_dev.get("k_metrics", "not measured"),
                metrics_ms_events=m_ms_events)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--states", default=",".join(DEFAULT_STATES),
                    help=f"comma-separated, of {', '.join(STATES)}")
    args = ap.parse_args()
    names = args.states.split(",")
    bad = [x for x in names if x not in STATES]
    if bad:
        ap.error(f"unknown states {bad}")
    if not torch.cuda.is_available():
        print("launch_timing: no CUDA device", file=sys.stderr)
        return 2
    from consul_tpu_torch.ops import cuda_gossip

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    info = cuda_gossip.build()
    tree = os.getcwd()
    states = {name: make_state(name) for name in names}
    readings = []
    for pass_ in (1, 2):
        floor = dict(tree=tree, floor_pass=pass_, launch_floor=floor_ms())
        readings.append(floor)
        print(json.dumps(floor), flush=True)
        for name, (tick, world, st, d, sched) in states.items():
            res = dict(tree=tree, state=name, pass_=pass_,
                       **time_state(tick, world, st, d, sched, args.reps))
            readings.append(res)
            print(json.dumps(res), flush=True)
    print(smi, flush=True)
    print(json.dumps({"tree": tree, "build_s": round(info.seconds, 3),
                      "library": os.path.relpath(info.path, tree),
                      "device": torch.cuda.get_device_name(0),
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
