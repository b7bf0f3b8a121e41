"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA tick kernel from ``consul_tpu_torch/csrc`` and holds
its variants against their plain PyTorch versions: the bare SWIM tick at
the bench's default shape, at a ragged size and at the main path's own
shape; the serf variant at 65,536 nodes, at 20,000 nodes with query
relays (int16 origins), at the main path's shape and at 2,097,153 nodes
(the murmur dedup signature), each window carrying an event storm, an
open query and a leave; the chaos + sentinel variant at 65,536 nodes and
at the main path's shape, each window under a schedule with every fault
family overlapping and with corruption for the sentinel to find, then
the sentinel alone at both sizes, and an SLO window at the main path's
shape in which the game day's composed timeline starts on a whole
cluster and lifts, so every SLO counter moves; the serf + chaos +
sentinel variant in such windows at 65,536, 20,000 (relays without loss)
and 1,048,576 nodes, with events, a query across the partition and a
leave in flight; and every variant on the dense view (the complete
graph, n = 256); and tie-and-wrap windows (every probing row wrapping,
tied budgets and tied reshuffle draws) for the bare and the serf + chaos
+ sentinel variants at 1,048,576 nodes and the bare and serf variants on
the dense view; and serf stress windows for the serf and serf + chaos +
sentinel variants at 1,048,576 nodes and on the dense view (events
spread over more Lamport times than the dedup ring holds, more origins
at one Lamport time than a bucket holds, overflowing queues, one key from
many origins, a relayed query under loss). It drives the port's main
paths through their entry points: ``Simulation`` (a 1,048,576-node,
K = 32 view converging after a 5 % mass kill), ``SerfSimulation`` (the same, plus a live event storm
and an open query, with fresh events every 512 ticks), ``Simulation``
and ``SerfSimulation`` with the sentinel on through ``run_scenario``
(the game day's composed partition + churn timeline with a lossy link
and a degraded block) and on to convergence, and each variant on the
dense view at n = 256. It times each variant at 1M (and the dense ones
at 256). Every main path's metrics run through launch M of the same
source (the TickTrace row of a tick from the packed leaves), which
``metrics_parity`` holds against its plain version on every main path's
final state, the chaos paths' states at window tick 50, the dense states
and a state with NaN coordinates, and ``metrics_timing`` times (alone,
and a tick with metrics against one without on the SWIM and serf
paths). ``resilient`` runs ``run_resilient`` at 1M for 256 ticks,
preempted by SIGTERM at tick 128 and resumed in a fresh ``Simulation``,
against an uninterrupted run, bit for bit. It prints one JSON line per
phase, the kernel table, the card's name and power limit, and a last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. It needs a CUDA H100 and the
rest of the repository; without either it fails before printing a
result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import torch

# HBM rate of the card the bound is stated for: NVIDIA's data sheet for
# the H100 SXM (80 GB HBM3, 3.35 TB/s at its full 700 W).
H100_SXM_BYTES_PER_S = 3.35e12

# The packed layout's float leaves round to bfloat16 (Vivaldi) or to the
# x256 float8 codec (RTT and adjustment windows) every tick, so a
# last-bit difference in f32 can flip a rounding, and a window can carry
# it on. The kernel and the plain version do the same f32 operations in
# the same order (the plain version adds Vivaldi's sums as a left fold,
# vivaldi.fold_sum, as the kernel does), and on the H100 every float leaf
# has come out bit-equal (PERF.md). An element passes if it is at most
# MAX_STEPS storage steps (ulps) from the plain version's, or if the
# decoded values differ by at most FLOOR_S seconds: height_min, the
# smallest height Vivaldi keeps, the floor for values that cross zero.
# The step limit was set one above the largest gap seen while the plain
# version still summed in the library's order.
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
# Serf variant parity: (n, packet loss, query_relay_factor, ticks).
# 20,000 nodes is ragged, keeps int16 origins and runs the relay path;
# 2,097,153 is the smallest n whose dedup signature is the murmur hash
# (serf._EXACT_SIG_MAX_N), over a 16-tick window (a leave still goes
# quiet inside it) to bound the run's time at twice the main path's size.
SERF_PARITY = ((65536, 0.01, 0, PARITY_TICKS), (20000, 0.01, 2, PARITY_TICKS),
               (MAIN_N, 0.0, 0, PARITY_TICKS), ((1 << 21) + 1, 0.0, 0, 16))
# The serf main path: events fired at the kill from 4 live rows (4 is
# seen_width: more same-ltime origins per bucket drop by design), and
# fresh ones every 512 ticks (bench.py:1133-1135).
SERF_EVENTS = 4
SERF_SLICE = 512
# Chaos + sentinel variant parity: (n, packet loss), 32-tick windows under
# every fault family open across them; then each family alone at 65,536
# nodes, and none (the sentinel alone) at 65,536 and at the main path's
# shape, in 8-tick windows.
CHAOS_PARITY = ((65536, 0.01), (MAIN_N, 0.0))
CHAOS_FAMILIES = (("none", 65536), ("partition", 65536), ("link", 65536),
                  ("churn", 65536), ("degrade", 65536), ("none", MAIN_N))
# The SLO window at the main path's shape: no mass kill, so the cluster is
# whole when the composed timeline (slo_events) starts at window tick
# SLO_START and lifts SLO_FAULT ticks later, well inside the window. The
# suspicion timeouts are cut to 30..60 ticks at 1M (suspicion_mult 1, max
# 2x), so a fault is suspected, then confirmed while it lasts, leaves
# deaths of reachable rows behind as it lifts, and then heals.
SLO_TICKS = 128
SLO_START = 4
SLO_FAULT = 48
# The chaos main path's composed timeline over a 192-tick window: the game
# day's partition and churn wave (consul_tpu/gameday/harness.py:673-690 at
# window 192, partition_frac 0.25, churn_frac 0.05; its raft kill left out,
# the raft tier is not ported), plus a lossy link and a degraded block
# shaped like tests/test_chaos.py:63-70, so every term of pair_ok bites.
CHAOS_WINDOW = 192
# The tick of the window whose state chaos_timing times: every entry open.
CHAOS_TIMED_TICK = 50
# Serf + chaos + sentinel variant parity: (n, packet loss,
# query_relay_factor, ticks, fault ticks). Each window opens on a whole
# cluster with events, a query and a leave in flight under slo_events
# from window tick SLO_START for the fault ticks, suspicion cut as in the
# SLO window (its timeout is then 24, 22 and 30 ticks at these sizes). A
# window is long enough for a suspicion to time out while the fault lasts
# and for the lifted fault to leave stale suspicions to heal. 20,000 nodes
# runs the relayed responses without loss: a schedule runs them.
SERF_CHAOS_PARITY = ((65536, 0.01, 2, 64, 36), (20000, 0.0, 2, 64, 36),
                     (MAIN_N, 0.0, 0, SLO_TICKS, SLO_FAULT))
# The dense view (view_degree 0: the complete graph, K = N - 1 = 255) under
# each variant: (name, serf plane, schedule and sentinel).
DENSE_N = 256
DENSE_TICKS = 32
DENSE_VARIANTS = (("dense", False, False), ("dense_chaos", False, True),
                  ("dense_serf", True, False), ("dense_serf_chaos", True, True))
# The tie-and-wrap windows: (name, n, serf plane, schedule and sentinel),
# TIE_TICKS ticks each from a formed state in which every active row's
# probe is due with its cursor at the last column (every probing row
# wraps and reshuffles), the view's remaining budgets take three values
# (the top-P peel ties) and each bundle's perm_u is cut to sixteenths (the
# reshuffle ties): the shapes where a warp's tie-breaks could part from
# the plain version's. The schedule's fault opens at the window's start.
TIE_TICKS = 4
TIE_WINDOWS = (("bare", MAIN_N, False, False),
               ("serf_chaos", MAIN_N, True, True),
               ("dense", DENSE_N, False, False),
               ("dense_serf", DENSE_N, True, False))
# The serf stress windows, for serf_post: (name, n, schedule and
# sentinel), STRESS_TICKS ticks each (1 % packet loss, query_relay_factor
# 2) from a state 32 ticks old into which stress_events fires its storm;
# under a schedule (and the sentinel) slo_events from the window's first
# tick, suspicion cut as in the SLO window.
# Launch M against its plain version: the three health values bit-equal,
# the RMSE within RMSE_RTOL relative (both sum 2,048 pairs' err^2 in
# float32, in different orders) or NaN on both sides.
RMSE_RTOL = 1e-6
METRIC_PAIRS = 2048
# Ticks of each timed run with and without metrics (off, on, on, off).
METRICS_TIMED_TICKS = 32
# The resilient phase: ticks, chunk, and the tick of the SIGTERM.
RESILIENT_TICKS = 256
RESILIENT_CHUNK = 64
RESILIENT_STOP = 128
STRESS_TICKS = 24
STRESS_WINDOWS = (("serf", MAIN_N, False), ("serf_chaos", MAIN_N, True),
                  ("dense_serf", DENSE_N, False),
                  ("dense_serf_chaos", DENSE_N, True))


def emit(obj):
    print(json.dumps(obj), flush=True)


def tick_launches(launches) -> int:
    """Launches of the tick's stages in a LAUNCHES snapshot (all but M)."""
    from consul_tpu_torch.ops import cuda_gossip

    return sum(launches[k] for k in cuda_gossip.STAGES)


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


def warm_to_deaths(n, step, st, kill_rows, unpack, pack, kill):
    """Warm up through the kernel: 32 ticks, kill ``kill_rows``, run on
    until the suspicions of the dead reach their Lifeguard timeout and
    deaths fire as a wave (n/1000 in one tick, not a stray false positive
    of the packet loss). Returns (state, ticks)."""
    from consul_tpu_torch.models.counters import FIELDS

    deaths = FIELDS.index("deaths_declared")
    for _ in range(32):
        st, _ = step(st)
    st = pack(kill(unpack(st), kill_rows))
    warm = 32
    while True:
        st, c = step(st)
        warm += 1
        if int(c[deaths]) >= max(1, n // 1000) or warm >= PARITY_MAX_WARM:
            return st, warm


def compare_packed(kp, pp, t, gaps, bad):
    """Kernel vs plain packed SWIM plane of one tick: discrete leaves
    equal, float leaves within MAX_STEPS / FLOOR_S (gaps record the
    largest seen)."""
    from consul_tpu_torch.models import layout

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


def compare_window(tick, plain, world, st, draw, ticks, sched=None):
    """Kernel vs plain version from one state with one draw bundle per
    tick (``draw()``): all 26 counters and every discrete packed leaf (and
    every serf leaf of a SerfState) equal on every tick, float leaves
    within MAX_STEPS / FLOOR_S. Returns (the plain side's last state,
    counter totals, mismatches, float gaps)."""
    from consul_tpu_torch.models import serf
    from consul_tpu_torch.models.counters import FIELDS

    serf_plane = isinstance(st, serf.SerfState)
    kp, pp = st, st
    totals = torch.zeros(len(FIELDS), dtype=torch.int64)
    bad = []
    gaps = {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
    for t in range(ticks):
        d = draw()
        kp, kc = tick(world, kp, d, sched)
        pp, pc = plain(world, pp, d, sched)
        torch.cuda.synchronize()
        if not torch.equal(kc, pc):
            bad.append(f"tick {t} counters {kc.tolist()} != {pc.tolist()}")
        totals += pc.cpu().to(torch.int64)
        if serf_plane:
            compare_packed(kp.swim, pp.swim, t, gaps, bad)
            for name in serf.SerfState._fields[1:]:
                a, b = getattr(kp, name), getattr(pp, name)
                if not torch.equal(a, b):
                    bad.append(f"tick {t} {name}: {int((a != b).sum())} "
                               "elements differ")
        else:
            compare_packed(kp, pp, t, gaps, bad)
        if bad:
            break
    return pp, totals, bad, gaps


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

    def step(st):
        return tick(world, st, swim.draw_tick(cfg, gen, dev))

    # Then stall another 2.5 % for 8 ticks (down, then up at the same
    # incarnation, as after a long pause): they are suspected and refute
    # inside the window.
    kill = torch.zeros(n, dtype=torch.bool, device=dev)
    kill[: n // 20] = True
    st, warm = warm_to_deaths(n, step, st, kill, layout.unpack, layout.pack,
                              sim_state.kill)
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

    _, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, _: cuda_gossip.plain_tick(cfg, topo, w, s, d),
        world, st, lambda: swim.draw_tick(cfg, gen, dev), ticks)
    fired = {f: int(totals[FIELDS.index(f)]) for f in (
        "suspicions_started", "deaths_declared", "refutations",
        "probe_timeouts", "pushpull_merges")}
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, ticks=ticks,
                warm=warm, mismatches=bad[:5], float_gaps=gaps,
                counters_in_window=fired)


def serf_parity(n: int, packet_loss: float, relay: int, ticks: int, seed: int):
    """The serf variant against plain_serf_tick from one state with one
    SerfDraws per tick: every discrete packed leaf, every serf leaf and
    all 26 counters equal on every tick, float leaves within MAX_STEPS /
    FLOOR_S. The window opens after the deaths wave of a 5 % kill, with an
    event storm (8 rounds of events from 4 live rows: 32 events over 8
    ltimes, more than a queue holds), an open query and a leave issued at
    its start, so deliveries, query acks, the quiet leave (15 ticks in)
    and all three serf intent counters fall inside it."""
    from consul_tpu_torch.config import SerfConfig, SimConfig
    from consul_tpu_torch.models import layout, serf, state as sim_state
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    cfg = SimConfig(n=n, view_degree=32, packet_loss=packet_loss,
                    serf=SerfConfig(query_relay_factor=relay))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack_state(serf.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True)

    def step(st):
        return tick(world, st, serf.draw_serf_tick(cfg, gen, dev))

    def kill(s, rows):
        return s._replace(swim=sim_state.kill(s.swim, rows))

    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    dead[: n // 20] = True
    st, warm = warm_to_deaths(n, step, st, dead, layout.unpack_state,
                              layout.pack_state, kill)
    q_row, leaver = n // 3 + 101, n // 3 + 211
    st, q_slot = fire_in_flight(cfg, st, [n // 3 + 7 * j for j in range(4)],
                                q_row, leaver)

    pp, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, _: cuda_gossip.plain_serf_tick(cfg, topo, w, s, d),
        world, st, lambda: serf.draw_serf_tick(cfg, gen, dev), ticks)
    window = {f: int(totals[FIELDS.index(f)]) for f in (
        "serf_intents_queued", "serf_intents_retx", "serf_intents_dropped",
        "deaths_declared")}
    window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, relay_factor=relay,
                ticks=ticks, warm=warm, mismatches=bad[:5], float_gaps=gaps,
                in_window=window)


def fire_in_flight(cfg, packed, origins, q_row, leaver):
    """On a packed SerfState: 8 rounds of user events from ``origins`` (8
    ltimes, more than a queue holds), a query from ``q_row`` and a leave
    of ``leaver``. Returns (packed state, the query's slot)."""
    from consul_tpu_torch.models import layout, serf

    n, dev = cfg.n, packed.clock.device
    dense = layout.unpack_state(packed)
    for r in range(8):
        dense = serf.user_event(cfg, dense, _rows(n, origins, dev), 16 + r)
    dense = serf.query(cfg, dense, _rows(n, [q_row], dev), 3)
    q_slot = serf.newest_query_slot(dense, q_row)
    dense = serf.leave(cfg, dense, _rows(n, [leaver], dev))
    return layout.pack_state(dense), q_slot


def serf_in_window(st, pp, q_row, q_slot, leaver):
    """What the serf plane did over a window from ``st`` to ``pp``: events
    delivered, the query's acks (and responses) against the live nodes
    that could answer it, and whether the leave went quiet."""
    live = int(((pp.swim.flags & 3) == 1).sum())
    acks = int(pp.q_acks[q_row, q_slot]) - int(st.q_acks[q_row, q_slot])
    return dict(
        delivered=int(pp.ev_delivered.to(torch.int64).sum()
                      - st.ev_delivered.to(torch.int64).sum()),
        query_acks=acks, query_resps=int(pp.q_resps[q_row, q_slot]),
        live_responders=live - 1, acks_missing=live - 1 - acks,
        leave_quiet=int(bool(pp.swim.flags[leaver] & 2)
                        and int(pp.leave_at[leaver]) == -1))


def chaos_events(chaos, n, window, family="all"):
    """The chaos parity window's schedule: two overlapping Partitions, two
    overlapping LinkLosses (the first as tests/test_chaos.py:65-66), a
    ChurnWave over 5 % of rows whose kill and revive edges both fall in
    the window, and two overlapping Degrades on the last n/8 rows; or one
    family of them alone, or none."""
    events = [
        chaos.Partition(0, window, slice(0, n // 4)),
        chaos.Partition(0, window, slice(n // 8, 3 * n // 8)),
        chaos.LinkLoss(0, window, slice(0, n // 8), slice(n // 8, n // 4),
                       fwd=0.8, rev=0.2),
        chaos.LinkLoss(0, window, slice(0, n // 4), slice(n // 8, n // 2),
                       fwd=0.3, rev=0.6),
        chaos.ChurnWave(2, window, slice(n // 2, n // 2 + n // 20), period=8,
                        down_ticks=4),
        chaos.Degrade(0, window, slice(n - n // 8, n), tx_loss=0.4),
        chaos.Degrade(0, window, slice(n - n // 4, n), tx_loss=0.1,
                      rx_loss=0.2),
    ]
    pick = {"all": slice(0, 7), "none": slice(0, 0), "partition": slice(0, 2),
            "link": slice(2, 4), "churn": slice(4, 5), "degrade": slice(5, 7)}
    return events[pick[family]]


def slo_events(chaos, n, fault=SLO_FAULT):
    """The SLO window's schedule: the game day's composed partition +
    churn timeline (as chaos_main_path's, on a ``fault``-tick fault that
    the churn leaves 8 ticks early), with the lossy link and the degraded
    block, all from window tick SLO_START."""
    a, b = SLO_START, SLO_START + fault
    return [
        chaos.Partition(a, b, side_a=slice(0, n // 4)),
        chaos.ChurnWave(a, b - 8, nodes=slice(n // 2, n // 2 + n // 20),
                        period=8, down_ticks=4),
        chaos.LinkLoss(a, b, a=slice(n // 4, 3 * n // 8),
                       b=slice(3 * n // 8, n // 2), fwd=0.8, rev=0.2),
        chaos.Degrade(a, b, nodes=slice(n - n // 8, n), tx_loss=0.4),
    ]


def corrupt(packed, n, k):
    """Corruption for the sentinel: NaN coordinates on three live rows, a
    pending probe column past K on a live row (its next missed probe
    overwrites it) and on row 10 (the packed layout saturates own_inc at
    65535, so an incarnation past MAX_INCARNATION cannot be stored), a
    SUSPECT cell whose timer is armed but whose accuser mask is zero on a
    live row, and a NaN in the first written RTT slot of a live row, which
    the median filter sorts above every sample. Nothing reachable lowers a
    view key or an incarnation within a tick (every write is a join or a
    promotion), so sentinel_monotonic stays 0."""
    base, dev = n // 3, packed.meta.device
    # Edited on host copies: CUDA has no bitwise ops on uint16.
    vec = packed.viv.vec.cpu()
    vec[base: base + 3] = float("nan")
    pcol, pfail = packed.pending_col.cpu(), packed.pending_fail_delta.cpu()
    for row in (base + 10, 10):
        pcol[row] = k + 3
        pfail[row] = 30000
    meta, sdelta = packed.meta.cpu(), packed.susp_delta.cpu()
    seen = packed.susp_seen.cpu()
    meta[base + 20, 0] = (int(meta[base + 20, 0]) & 0xFFFC) | 1
    sdelta[base + 20, 0] = 0
    seen[base + 20, 0] = 0
    # 0x7F is float8_e4m3fn's NaN.
    lbuf = packed.lat_buf.cpu().view(torch.uint8)
    cnt = packed.lat_cnt[base + 30].cpu().to(torch.int32)
    cols = torch.nonzero(cnt).flatten()
    if not len(cols):
        raise RuntimeError(f"row {base + 30} has no RTT sample to corrupt")
    lbuf[base + 30, int(cols[0]), 0] = 0x7F
    return packed._replace(
        viv=packed.viv._replace(vec=vec.to(dev)), pending_col=pcol.to(dev),
        pending_fail_delta=pfail.to(dev), meta=meta.to(dev),
        susp_delta=sdelta.to(dev), susp_seen=seen.to(dev),
        lat_buf=lbuf.view(torch.float8_e4m3fn).to(dev))


def chaos_parity(n: int, packet_loss: float, ticks: int, seed: int,
                 family: str = "all"):
    """The chaos + sentinel variant against plain_tick(sched,
    sentinel=True) from one state with one draw bundle per tick: discrete
    packed leaves and all 26 counters equal on every tick, float leaves
    within MAX_STEPS / FLOOR_S and NaN in the same places, with corrupt()
    applied at the window's start. The window opens after
    the deaths wave of a 5 % kill, under chaos_events open across it (or
    one ``family`` of it); with ``family="slo"`` it opens on a whole
    cluster 32 ticks old, under slo_events, with suspicion timeouts cut
    to suspicion_mult 1."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SimConfig
    from consul_tpu_torch.models import layout, state as sim_state, swim
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    slo = family == "slo"
    gossip = (GossipConfig(suspicion_mult=1, suspicion_max_timeout_mult=2)
              if slo else GossipConfig())
    cfg = SimConfig(n=n, view_degree=32, packet_loss=packet_loss,
                    gossip=gossip)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack(sim_state.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, sentinel=True)

    def step(st):
        return tick(world, st, swim.draw_tick(cfg, gen, dev))

    if slo:
        for _ in range(32):
            st, _ = step(st)
        warm, events = 32, slo_events(chaos, n)
    else:
        kill = torch.zeros(n, dtype=torch.bool, device=dev)
        kill[: n // 20] = True
        st, warm = warm_to_deaths(n, step, st, kill, layout.unpack,
                                  layout.pack, sim_state.kill)
        events = chaos_events(chaos, n, ticks + 8, family)
    sched = chaos.shift_schedule(chaos.compile_schedule(n, events, dev),
                                 int(st.t))
    st = corrupt(st, n, cfg.degree)
    _, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, sc: cuda_gossip.plain_tick(cfg, topo, w, s, d, sc,
                                                         sentinel=True),
        world, st, lambda: swim.draw_tick(cfg, gen, dev, chaos=True), ticks,
        sched)
    window = {f: int(totals[FIELDS.index(f)]) for f in FIELDS
              if f.startswith(("chaos_", "sentinel_")) or f in (
                  "deaths_declared", "refutations", "suspicions_started")}
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, ticks=ticks,
                family=family, warm=warm, mismatches=bad[:5], float_gaps=gaps,
                in_window=window)


def chaos_ok(res) -> bool:
    """No mismatch, the corruption found, and, under every family, the
    faults really bit; in the SLO window every SLO counter moved."""
    w = res["in_window"]
    need = ["sentinel_range", "sentinel_suspicion", "sentinel_nonfinite_coord",
            "sentinel_nonfinite_rtt"]
    if res["family"] in ("all", "slo"):
        need += ["chaos_msgs_dropped", "chaos_fault_ticks"]
    if res["family"] == "slo":
        need += ["chaos_first_suspect_wait", "chaos_confirm_wait",
                 "chaos_heal_wait", "chaos_false_deaths"]
    ok = not res["mismatches"] and all(w[f] > 0 for f in need)
    if res["family"] == "all":
        ok = ok and (w["chaos_false_deaths"] > 0 or w["deaths_declared"] > 0)
    return ok


def chaos_main_events(chaos, n):
    """The chaos main path's composed timeline over CHAOS_WINDOW ticks."""
    return [
        chaos.Partition(2, 96, side_a=slice(0, n // 4)),
        chaos.ChurnWave(48, 144, nodes=slice(0, int(n * 0.05)), period=8,
                        down_ticks=4),
        chaos.LinkLoss(2, CHAOS_WINDOW, a=slice(n // 4, 3 * n // 8),
                       b=slice(3 * n // 8, n // 2), fwd=0.8, rev=0.2),
        chaos.Degrade(2, CHAOS_WINDOW, nodes=slice(n - n // 8, n), tx_loss=0.4),
    ]


def snapshot_at(sim, tick, snap):
    """Wrap ``sim.draws`` to keep a copy of the state as it stands when
    tick ``tick`` is drawn (in ``snap["state"]``); returns the own draws
    to restore."""
    own = sim.draws

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(*[clone(y) for y in x])

    def draws(t):
        if t == tick:
            snap["state"] = clone(sim.state)
        return own(t)

    sim.draws = draws
    return own


def chaos_main_path(cfg):
    """The chaos north star through Simulation: the sentinel on, 64 ticks
    to form, run_scenario over the composed timeline (CHAOS_WINDOW ticks
    plus 64 to settle), then run_until_converged. A sentinel trip is a
    failure. Also keeps the state at window tick CHAOS_TIMED_TICK for
    chaos_timing."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster, counters, layout
    from consul_tpu_torch.ops import cuda_gossip

    n = cfg.n
    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda")
    sim.set_sentinel(True)
    setup_s = time.perf_counter() - t0
    reset_launches()
    stages = {}
    t0 = time.perf_counter()
    sim.run(64, chunk=64, with_metrics=False)
    torch.cuda.synchronize()
    stages["form"] = {"ticks": 64, "wall_s": round(time.perf_counter() - t0, 3)}
    form_launches = dict(cuda_gossip.LAUNCHES)
    events = chaos_main_events(chaos, n)
    t_window = sim._t
    snap = {}
    own_draws = snapshot_at(sim, t_window + CHAOS_TIMED_TICK, snap)
    t0 = time.perf_counter()
    res = sim.run_scenario(events, chunk=64, settle=64)
    torch.cuda.synchronize()
    stages["scenario"] = {"ticks": res.ticks,
                          "wall_s": round(time.perf_counter() - t0, 3)}
    sim.draws = own_draws
    scenario_launches = dict(cuda_gossip.LAUNCHES)
    t0 = time.perf_counter()
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    stages["converge"] = {"ticks": used,
                          "wall_s": round(time.perf_counter() - t0, 3)}
    launches = dict(cuda_gossip.LAUNCHES)
    agreement = float(trace.agreement[-1])
    finite = bool(torch.isfinite(trace.rmse).all()) and bool(
        torch.isfinite(layout.unpack(sim.state).viv.vec).all())
    mask = counters.violation_mask(sim.counters)
    out = dict(n=n, k=cfg.degree, slo=res.slo, scenario_counters=res.counters,
               stages=stages, converged=converged, ticks_after_scenario=used,
               ticks_total=sim._t, agreement=agreement,
               rmse_ms=float(trace.rmse[-1]) * 1000.0,
               wall_s=round(sum(v["wall_s"] for v in stages.values()), 3),
               setup_s=round(setup_s, 3), sentinel_mask=mask,
               launches=launches, scenario_launches=scenario_launches,
               form_launches=form_launches,
               bytes_per_node=layout.bytes_per_node(sim.state, n))
    ok = (converged and agreement == 1.0 and finite and mask == 0
          and all(v > 0 for k, v in scenario_launches.items()
                  if k not in ("serf_post", "metrics"))
          and launches["metrics"] > 0
          and res.slo["fault_ticks"] > 0 and res.slo["messages_dropped"] > 0)
    sched = chaos.shift_schedule(
        chaos.compile_schedule(n, events, sim.device), t_window)
    return sim, snap["state"], sched, out, ok


def serf_chaos_parity(n: int, packet_loss: float, relay: int, ticks: int,
                      fault: int, seed: int):
    """The serf + chaos + sentinel variant against plain_serf_tick(sched,
    sentinel=True), compared as compare_window does. The window opens on a
    whole cluster 32 ticks old (no mass kill: with dead rows every SLO
    indicator reads settled), with an event storm from both sides of the
    partition, a query from its side A (some responders sit across it), a
    leave and corrupt() in flight, under slo_events over ``fault`` ticks
    from window tick SLO_START, suspicion cut to suspicion_mult 1."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SerfConfig, SimConfig
    from consul_tpu_torch.models import layout, serf
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    cfg = SimConfig(n=n, view_degree=32, packet_loss=packet_loss,
                    gossip=GossipConfig(suspicion_mult=1,
                                        suspicion_max_timeout_mult=2),
                    serf=SerfConfig(query_relay_factor=relay))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack_state(serf.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True,
                                        sentinel=True)
    for _ in range(32):
        st, _ = tick(world, st, serf.draw_serf_tick(cfg, gen, dev))
    # Origins on both sides of the partition (rows 0..n/4), clear of the
    # churned, lossy and degraded blocks; the query from side A.
    q_row, leaver = n // 8 + 101, 3 * n // 4 + 11
    origins = [n // 8 + 7 * j for j in range(2)] + [
        5 * n // 8 + 7 * j for j in range(2)]
    st, q_slot = fire_in_flight(cfg, st, origins, q_row, leaver)
    st = st._replace(swim=corrupt(st.swim, n, cfg.degree))
    sched = chaos.shift_schedule(chaos.compile_schedule(
        n, slo_events(chaos, n, fault), dev), int(st.swim.t))
    pp, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, sc: cuda_gossip.plain_serf_tick(
            cfg, topo, w, s, d, sc, sentinel=True),
        world, st, lambda: serf.draw_serf_tick(cfg, gen, dev, chaos=True),
        ticks, sched)
    window = {f: int(totals[FIELDS.index(f)]) for f in FIELDS
              if f.startswith(("chaos_", "sentinel_", "serf_")) or f in (
                  "deaths_declared", "refutations", "suspicions_started")}
    window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, relay_factor=relay,
                ticks=ticks, fault_ticks=fault, mismatches=bad[:5],
                float_gaps=gaps, in_window=window)


def serf_chaos_ok(res) -> bool:
    """No mismatch; the schedule dropped legs and every SLO counter moved;
    events were queued, retransmitted and delivered; the query was acked,
    but not by every live node (the partition kept some acks from its
    origin); the leave went quiet; the corruption was found, and no clock
    went back (none can: a clock moves only through the witness max)."""
    w = res["in_window"]
    need = ("chaos_msgs_dropped", "chaos_first_suspect_wait",
            "chaos_confirm_wait", "chaos_heal_wait", "chaos_false_deaths",
            "serf_intents_queued", "serf_intents_retx", "delivered",
            "query_acks", "acks_missing", "leave_quiet", "sentinel_range",
            "sentinel_suspicion", "sentinel_nonfinite_coord",
            "sentinel_nonfinite_rtt")
    return (not res["mismatches"] and all(w[f] > 0 for f in need)
            and w["sentinel_monotonic"] == 0)


def dense_events(chaos, n):
    """The dense windows' schedule, from tick 2 to 14: a partition of
    rows 0..n/4, a lossy link, a degraded block and one churn pulse that
    holds 5 % of the rows down for the 12 ticks."""
    return [chaos.Partition(2, 14, side_a=slice(0, n // 4)),
            chaos.ChurnWave(2, 14, nodes=slice(n // 2, n // 2 + n // 20),
                            period=32, down_ticks=12),
            chaos.LinkLoss(2, 14, a=slice(n // 4, 3 * n // 8),
                           b=slice(3 * n // 8, n // 2), fwd=0.8, rev=0.2),
            chaos.Degrade(2, 14, nodes=slice(n - n // 8, n), tx_loss=0.4)]


def dense_parity(name: str, serf_plane: bool, chaos_on: bool, seed: int, rate):
    """One variant on the dense view (n = DENSE_N, K = n - 1) against its
    plain version over DENSE_TICKS ticks, compared as compare_window
    does. Without a schedule the window opens after the deaths wave of a
    5 % kill with another 2.5 % just back from a stall (as parity's); with
    one (and the sentinel) on a whole cluster 32 ticks old under
    dense_events, whose churn pulse is the 5 % kill, suspicion cut to
    suspicion_mult 1. The serf variants carry events, a query and a leave.
    Also times the variant on the window's last state."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SimConfig
    from consul_tpu_torch.models import layout, serf, state as sim_state, swim
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    n, dev = DENSE_N, torch.device("cuda")
    gossip = (GossipConfig(suspicion_mult=1, suspicion_max_timeout_mult=2)
              if chaos_on else GossipConfig())
    cfg = SimConfig(n=n, view_degree=0, packet_loss=0.01, gossip=gossip)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    assert topo.dense and topo.degree == n - 1
    init = serf.init if serf_plane else sim_state.init
    st = layout.pack_state(init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=serf_plane,
                                        sentinel=chaos_on)
    plain_fn = cuda_gossip.plain_serf_tick if serf_plane else cuda_gossip.plain_tick

    def draw(sched_on):
        if serf_plane:
            return serf.draw_serf_tick(cfg, gen, dev, chaos=sched_on)
        return swim.draw_tick(cfg, gen, dev, chaos=sched_on)

    def step(s):
        return tick(world, s, draw(False))

    def edit_swim(s, fn):
        sw = layout.unpack_state(s)
        if serf_plane:
            return layout.pack_state(sw._replace(swim=fn(sw.swim)))
        return layout.pack_state(fn(sw))

    rows = torch.arange(n, device=dev)
    if chaos_on:
        for _ in range(32):
            st, _ = step(st)
        warm = 32
        sched = chaos.shift_schedule(chaos.compile_schedule(
            n, dense_events(chaos, n), dev), int(layout.tick_of(st)))
    else:
        dead = rows < n // 20
        st, warm = warm_to_deaths(
            n, step, st, dead, lambda s: s, lambda s: s,
            lambda s, m: edit_swim(s, lambda sw: sim_state.kill(sw, m)))
        pause = (rows >= n // 2) & (rows < n // 2 + n // 40)
        st = edit_swim(st, lambda sw: sim_state.kill(sw, pause))
        for _ in range(8):
            st, _ = step(st)
        st = edit_swim(st, lambda sw: sw._replace(
            alive_truth=sw.alive_truth | pause))
        warm += 8
        sched = None
    if serf_plane:
        q_row, leaver = n // 8 + 5, 3 * n // 4 + 1
        st, q_slot = fire_in_flight(cfg, st, [n // 8, 5 * n // 8 + 3], q_row,
                                    leaver)

    def plain(w, s, d, sc):
        return plain_fn(cfg, topo, w, s, d, sc, sentinel=chaos_on)

    pp, totals, bad, gaps = compare_window(
        tick, plain, world, st, lambda: draw(sched is not None), DENSE_TICKS,
        sched)
    window = {f: int(totals[FIELDS.index(f)]) for f in (
        "suspicions_started", "deaths_declared", "refutations",
        "chaos_msgs_dropped", "chaos_first_suspect_wait", "chaos_confirm_wait",
        "chaos_heal_wait", "chaos_false_deaths", "serf_intents_queued")}
    need = ["suspicions_started", "deaths_declared", "refutations"]
    if chaos_on:
        need += ["chaos_first_suspect_wait", "chaos_confirm_wait",
                 "chaos_heal_wait"]
    if serf_plane:
        window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
        need += ["delivered", "query_acks"]
    ok = not bad and all(window[f] > 0 for f in need)
    timing = time_kernel(
        tick, lambda w, s, d: plain(w, s, d, sched), world, pp, draw(chaos_on),
        cuda_gossip.tick_hbm_bytes_per_node(pp, world, sched), n, rate,
        sched=sched)
    return dict(variant=name, n=n, k=cfg.degree, ticks=DENSE_TICKS, warm=warm,
                mismatches=bad[:5], float_gaps=gaps, in_window=window,
                ok=ok), timing


def tie_and_wrap(sw, k):
    """A packed SWIM plane with every probe due (next_probe_delta 0) at
    the last column and each view cell's remaining budget set to 0, 2 or
    5 by (row + column) mod 3, so every row holds all three values, each
    tied across a third of its columns; meta is edited on a host copy
    (CUDA has no bitwise ops on uint16)."""
    n = sw.meta.shape[0]
    meta = sw.meta.cpu().to(torch.int32)
    cell = torch.arange(n)[:, None] + torch.arange(k)[None, :]
    budget = torch.tensor([0, 2, 5], dtype=torch.int32)[cell % 3]
    meta = (meta & ~(63 << 2)) | (budget << 2)
    return sw._replace(next_probe_delta=torch.zeros_like(sw.next_probe_delta),
                       probe_ptr=torch.full_like(sw.probe_ptr, k - 1),
                       meta=meta.to(torch.uint16).to(sw.meta.device))


def tie_wrap_parity(name: str, n: int, serf_plane: bool, chaos_on: bool,
                    seed: int):
    """A variant against its plain version over TIE_TICKS ticks from a
    state 32 ticks old put through tie_and_wrap, with perm_u cut to
    multiples of 1/16 in every bundle; under a schedule (and the sentinel)
    slo_events from the window's first tick, suspicion cut as in the SLO
    window. Passes only if every packed and serf leaf and all 26 counters
    are equal on every tick, every float leaf bit for bit, and some rows
    wrapped."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SimConfig
    from consul_tpu_torch.models import layout, serf, state as sim_state, swim
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    gossip = (GossipConfig(suspicion_mult=1, suspicion_max_timeout_mult=2)
              if chaos_on else GossipConfig())
    dense = n == DENSE_N
    cfg = SimConfig(n=n, view_degree=0 if dense else 32,
                    packet_loss=0.01 if dense else 0.0, gossip=gossip)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    init = serf.init if serf_plane else sim_state.init
    st = layout.pack_state(init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=serf_plane,
                                        sentinel=chaos_on)
    plain_fn = cuda_gossip.plain_serf_tick if serf_plane else cuda_gossip.plain_tick

    def draw(sched_on):
        if serf_plane:
            d = serf.draw_serf_tick(cfg, gen, dev, chaos=sched_on)
            return d._replace(swim=d.swim._replace(
                perm_u=torch.floor(d.swim.perm_u * 16.0) / 16.0))
        d = swim.draw_tick(cfg, gen, dev, chaos=sched_on)
        return d._replace(perm_u=torch.floor(d.perm_u * 16.0) / 16.0)

    for _ in range(32):
        st, _ = tick(world, st, draw(False))
    t0 = int(layout.tick_of(st))
    sched = (chaos.shift_schedule(chaos.compile_schedule(
        n, slo_events(chaos, n), dev), t0 - SLO_START) if chaos_on else None)
    if serf_plane:
        st = st._replace(swim=tie_and_wrap(st.swim, cfg.degree))
    else:
        st = tie_and_wrap(st, cfg.degree)
    wrapped = [0]

    def plain(w, s, d, sc):
        out, cnt = plain_fn(cfg, topo, w, s, d, sc, sentinel=chaos_on)
        si, so = (s.swim, out.swim) if serf_plane else (s, out)
        wrapped[0] += int(((so.probe_ptr == 0) & (si.probe_ptr > 0)).sum())
        return out, cnt

    _, totals, bad, gaps = compare_window(
        tick, plain, world, st, lambda: draw(sched is not None), TIE_TICKS,
        sched)
    from consul_tpu_torch.models.counters import FIELDS
    window = {f: int(totals[FIELDS.index(f)]) for f in (
        "probes_sent", "gossip_msgs_tx", "chaos_msgs_dropped")}
    bit_equal = all(g["abs"] == 0.0 and g["steps"] == 0 for g in gaps.values())
    return dict(variant=name, n=n, k=cfg.degree, ticks=TIE_TICKS,
                wrapped_rows=wrapped[0], mismatches=bad[:5], float_gaps=gaps,
                in_window=window,
                ok=not bad and bit_equal and wrapped[0] > 0)


def stress_events(cfg, packed):
    """On a packed SerfState whose event clocks are all still 1: 8 origins
    spread over the ring fire one event of one name at Lamport time 1
    (equal keys from 8 origins, twice seen_width: buckets fill), 2 more
    fire 24 events each (their queues keep the last 8, Lamport times
    17..24, so buckets are taken over and floors rise, and receivers'
    queues overflow), and a row opens a query (relayed, with loss, so
    many responses add onto one origin slot). Returns (state, query row,
    its slot)."""
    from consul_tpu_torch.models import layout, serf

    n, dev = cfg.n, packed.clock.device
    dense = layout.unpack_state(packed)
    dense = serf.user_event(cfg, dense,
                            _rows(n, [(n // 8) * j + 5 for j in range(8)], dev), 1)
    storm = _rows(n, [n // 3 + 1, 2 * n // 3 + 1], dev)
    for k in range(24):
        dense = serf.user_event(cfg, dense, storm, 2 + k)
    q_row = n // 2 + 9
    dense = serf.query(cfg, dense, _rows(n, [q_row], dev), 3)
    return layout.pack_state(dense), q_row, serf.newest_query_slot(dense, q_row)


def stress_hits(s, out):
    """The dedup and queue branches one serf tick from ``s`` to ``out``
    took: buckets taken over from an older Lamport time, floors raised,
    full buckets, and queues holding one key from two origins."""
    def i64(x):  # uint32 has no comparisons in PyTorch
        return x.to(torch.int64)

    key, org = i64(out.ev_key), out.ev_origin
    same = ((key[:, :, None] == key[:, None, :]) & (key[:, :, None] > 0)
            & (org[:, :, None] != org[:, None, :]))
    lt0 = i64(s.ev_bkt_lt)
    return dict(
        takeovers=int(((i64(out.ev_bkt_lt) != lt0) & (lt0 > 0)).sum()),
        floor_bumps=int((i64(out.ev_floor) > i64(s.ev_floor)).sum()),
        full_bucket_rows=int((out.ev_bkt_sig.view(torch.int32) != 0)
                             .all(-1).any(-1).sum()),
        same_key_rows=int(same.flatten(1).any(1).sum()))


def serf_stress_parity(name: str, n: int, chaos_on: bool, seed: int):
    """A serf variant against plain_serf_tick over STRESS_TICKS ticks from
    stress_events' storm, compared as compare_window does. Passes only if
    every packed and serf leaf and all 26 counters are equal on every
    tick, every float leaf bit for bit, and each branch was hit: bucket
    takeovers and floor bumps, full buckets, queues holding one key from
    two origins, queue evictions (serf_intents_dropped) and relayed query
    responses adding onto the origin's slot."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SerfConfig, SimConfig
    from consul_tpu_torch.models import layout, serf
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    gossip = (GossipConfig(suspicion_mult=1, suspicion_max_timeout_mult=2)
              if chaos_on else GossipConfig())
    cfg = SimConfig(n=n, view_degree=0 if n == DENSE_N else 32,
                    packet_loss=0.01, gossip=gossip,
                    serf=SerfConfig(query_relay_factor=2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack_state(serf.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True,
                                        sentinel=chaos_on)
    for _ in range(32):
        st, _ = tick(world, st, serf.draw_serf_tick(cfg, gen, dev))
    st, q_row, q_slot = stress_events(cfg, st)
    sched = None
    if chaos_on:
        t0 = int(layout.tick_of(st))
        events = dense_events(chaos, n) if n == DENSE_N else slo_events(chaos, n)
        sched = chaos.shift_schedule(chaos.compile_schedule(n, events, dev),
                                     t0 - (2 if n == DENSE_N else SLO_START))
    hits = {}

    def plain(w, s, d, sc):
        out, cnt = cuda_gossip.plain_serf_tick(cfg, topo, w, s, d, sc,
                                               sentinel=chaos_on)
        for k, v in stress_hits(s, out).items():
            hits[k] = hits.get(k, 0) + v
        return out, cnt

    pp, totals, bad, gaps = compare_window(
        tick, plain, world, st,
        lambda: serf.draw_serf_tick(cfg, gen, dev, chaos=chaos_on),
        STRESS_TICKS, sched)
    hits["intents_dropped"] = int(totals[FIELDS.index("serf_intents_dropped")])
    hits["query_acks"] = int(pp.q_acks[q_row, q_slot])
    bit_equal = all(g["abs"] == 0.0 and g["steps"] == 0 for g in gaps.values())
    return dict(variant=name, n=n, k=cfg.degree, ticks=STRESS_TICKS,
                relay_factor=2, mismatches=bad[:5], float_gaps=gaps,
                hits=hits,
                ok=not bad and bit_equal and all(v > 0 for v in hits.values()))


def dense_main_path():
    """The dense view through the entry points, each variant: Simulation
    or SerfSimulation(SimConfig(n=DENSE_N), kernel="cuda") (view_degree 0,
    the default: the complete graph), 64 ticks to form, then a 5 % kill,
    or with the sentinel on run_scenario over dense_events, then
    run_until_converged. The serf variants fire an event from a live row
    after the fault; its coverage is read at the end. Returns the runs'
    results and, by variant, (cfg, topology, world, final packed SWIM
    plane) for metrics_parity."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, counters, serf
    from consul_tpu_torch.ops import cuda_gossip

    n = DENSE_N
    out, finals = {}, {}
    for name, serf_plane, chaos_on in DENSE_VARIANTS:
        cls = cluster.SerfSimulation if serf_plane else cluster.Simulation
        t0 = time.perf_counter()
        sim = cls(SimConfig(n=n), seed=3)
        sim.set_sentinel(chaos_on)
        reset_launches()
        sim.run(64, chunk=64, with_metrics=False)
        slo = None
        if chaos_on:
            slo = sim.run_scenario(dense_events(chaos, n), chunk=32,
                                   settle=32).slo
        else:
            sim.kill(torch.arange(n) < n // 20)
        origin = n // 8 + 3
        if serf_plane:
            lt = int(sim.state.event_clock[origin])
            sim.user_event(_rows(n, [origin], "cpu"), 9)
        converged, used, trace = sim.run_until_converged(max_ticks=4096,
                                                         chunk=64)
        torch.cuda.synchronize()
        res = dict(n=n, k=sim.cfg.degree, dense=sim.topo.dense,
                   converged=converged, ticks_total=sim._t,
                   agreement=float(trace.agreement[-1]),
                   wall_s=round(time.perf_counter() - t0, 3),
                   launches=dict(cuda_gossip.LAUNCHES), slo=slo,
                   sentinel_mask=counters.violation_mask(sim.counters))
        if serf_plane:
            res["coverage"] = float(serf.event_coverage(
                sim.cfg, sim.serf_state, serf.make_event_key(lt, 9), origin))
        res["ok"] = (converged and res["agreement"] == 1.0 and sim.topo.dense
                     and res["sentinel_mask"] == 0
                     and res["launches"]["probe_send"] > 0
                     and res["launches"]["metrics"] > 0
                     and (res["launches"]["chaos_pre"] > 0) == chaos_on
                     and (res["launches"]["serf_post"] > 0) == serf_plane
                     and res.get("coverage", 1.0) == 1.0)
        out[name] = res
        finals[name] = (sim.cfg, sim.topo, sim.world, sim._swim_at_rest())
    return out, finals


def metrics_case(name, cfg, topo, world, packed, seed, nan_rows=None):
    """Launch M against its plain version (cuda_gossip.plain_metrics) on
    one packed SWIM plane, over METRIC_PAIRS pairs drawn from ``seed``:
    the health values bit-equal, the RMSE within RMSE_RTOL or NaN on both
    sides. With ``nan_rows`` (rows holding NaN coordinates) the first pair
    is the first live one of them and a live row, and both RMSEs must be
    NaN."""
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.utils import metrics

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    i, j = metrics.rmse_samples(cfg, gen, METRIC_PAIRS, "cuda")
    if nan_rows is not None:
        alive = (packed.flags & 1).bool().cpu()
        i[0] = next(r for r in nan_rows if alive[r])
        j[0] = next(r for r in range(cfg.n) if alive[r] and r not in nan_rows)
    out = torch.empty(4, device="cuda")
    cuda_gossip.make_metrics_kernel(cfg, topo)(world, packed, i, j, out)
    want = cuda_gossip.plain_metrics(cfg, topo, world, packed, i, j)
    torch.cuda.synchronize()
    got, ref = out.tolist(), want.tolist()
    both_nan = math.isnan(got[3]) and math.isnan(ref[3])
    rel = 0.0 if both_nan else (abs(got[3] - ref[3]) / abs(ref[3]) if ref[3]
                                else abs(got[3]))
    ok = bool(torch.equal(out[:3], want[:3])) and (
        both_nan or (math.isfinite(got[3]) and math.isfinite(ref[3])
                     and rel <= RMSE_RTOL))
    if nan_rows is not None:
        ok = ok and both_nan
    err = max([abs(a - b) for a, b in zip(got[:3], ref[:3])]
              + [0.0 if both_nan else abs(got[3] - ref[3])])
    return dict(name=name, n=cfg.n, k=cfg.degree, kernel=got, plain=ref,
                rmse_rel=rel, max_abs_err=err, ok=ok)


def tick_with_and_without_metrics(sim):
    """Device ms per tick (CUDA events around whole runs, so host stalls
    count) of ``sim.run`` without and with metrics, in turns off, on, on,
    off, METRICS_TIMED_TICKS ticks each."""
    out = {False: [], True: []}
    for on in (False, True, True, False):
        ms = cuda_ms(lambda: sim.run(METRICS_TIMED_TICKS,
                                     chunk=METRICS_TIMED_TICKS,
                                     with_metrics=on), 1)
        out[on].append(ms / METRICS_TIMED_TICKS)
    off, on = (sum(out[k]) / 2 for k in (False, True))
    return {"off_ms": out[False], "on_ms": out[True], "ratio": on / off}


def _leaf_bits(x):
    return x.detach().reshape(-1).view(torch.uint8)


def resilient_phase(cfg):
    """run_resilient at the main path's shape: RESILIENT_TICKS ticks
    uninterrupted, then the same call with a CheckpointPolicy whose
    SignalTrap takes a SIGTERM sent at tick RESILIENT_STOP (it saves and
    raises Preempted), then the same call again in a fresh Simulation,
    which resumes from the checkpoint. Passes when the resumed run ends
    with every packed leaf bit-equal to the uninterrupted one's and
    retires its checkpoint."""
    from consul_tpu_torch import runtime as rt
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.utils import checkpoint as ckpt

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "resilient")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ref = cluster.Simulation(cfg, seed=1)
    ref.kill(torch.arange(cfg.n) < cfg.n // 20)
    rt.run_resilient(ref, RESILIENT_TICKS, chunk=RESILIENT_CHUNK)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    timing = {}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timing[name] = time.perf_counter() - t
            return out
        return run

    sim = cluster.Simulation(cfg, seed=1)
    sim.kill(torch.arange(cfg.n) < cfg.n // 20)
    pol = rt.CheckpointPolicy(directory=d, tag="resilient_1m",
                              min_interval_s=1e9, trap=rt.SignalTrap())
    pol.save = timed("save_s", pol.save)
    real_run = sim.run

    def run_then_sigterm(*a, **kw):
        out = real_run(*a, **kw)
        if sim._t == RESILIENT_STOP:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    sim.run = run_then_sigterm
    preempted = None
    try:
        rt.run_resilient(sim, RESILIENT_TICKS, chunk=RESILIENT_CHUNK,
                         policy=pol)
    except rt.Preempted as e:
        preempted = e.report
    size = os.path.getsize(pol.path) if os.path.exists(pol.path) else 0
    del sim
    torch.cuda.empty_cache()
    fresh = cluster.Simulation(cfg, seed=1)
    fresh.kill(torch.arange(cfg.n) < cfg.n // 20)
    pol2 = rt.CheckpointPolicy(directory=d, tag="resilient_1m",
                               min_interval_s=1e9)
    pol2.load = timed("restore_s", pol2.load)
    rep = rt.run_resilient(fresh, RESILIENT_TICKS, chunk=RESILIENT_CHUNK,
                           policy=pol2)
    torch.cuda.synchronize()
    pairs = list(zip(ckpt.flatten(ref.state), ckpt.flatten(fresh.state)))
    differ = [p for (p, a), (_, b) in pairs
              if not torch.equal(_leaf_bits(a), _leaf_bits(b))]
    res = dict(n=cfg.n, ticks=RESILIENT_TICKS, chunk=RESILIENT_CHUNK,
               preempted_at=None if preempted is None else preempted.ticks_done,
               resumed_from=rep.resumed_from_tick, ticks_done=rep.ticks_done,
               checkpoint_bytes=size, save_s=timing.get("save_s"),
               restore_s=timing.get("restore_s"),
               uninterrupted_s=round(ref_s, 3), leaves=len(pairs),
               leaves_differing=differ, t=int(fresh.state.t),
               retired=not os.path.exists(pol2.path))
    res["ok"] = (res["preempted_at"] == RESILIENT_STOP
                 and rep.resumed_from_tick == RESILIENT_STOP
                 and rep.ticks_done == RESILIENT_TICKS and not differ
                 and size > 0 and res["retired"]
                 and fresh._t == ref._t == RESILIENT_TICKS)
    shutil.rmtree(d, ignore_errors=True)
    return res


def _rows(n, rows, dev):
    m = torch.zeros(n, dtype=torch.bool, device=dev)
    m[rows] = True
    return m


def time_kernel(tick, plain, world, st, d, bytes_per_node, n, rate, sched=None):
    """Device ms per tick of the kernel and of its plain version (CUDA
    events), ms by launch (profiler), the tick's bytes bound and each
    launch's (cuda_gossip.launch_hbm_bytes_per_node on this tick's
    inputs and output)."""
    from consul_tpu_torch.ops import cuda_gossip

    ms = cuda_ms(lambda: tick(world, st, d, sched), 20)
    plain_ms = cuda_ms(lambda: plain(world, st, d), 3)
    stages = launch_breakdown(lambda: tick(world, st, d, sched), 5)
    bound_ms = bytes_per_node * n / rate * 1e3
    buffers = tick.buffer_bytes_per_node(world, st, d, sched)
    out, _ = tick(world, st, d, sched)
    ran = [k for k in cuda_gossip.STAGES
           if (k != "chaos_pre" or sched is not None)
           and (k != "serf_post" or tick.serf)]
    launch_bytes = {"k_" + k: cuda_gossip.launch_hbm_bytes_per_node(
        k, st, world, d, sched, cfg=tick.cfg, out=out) for k in ran}
    return dict(ms_per_tick=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                contract_bytes_per_node=bytes_per_node,
                buffer_bytes_per_node=buffers,
                buffer_bytes_per_s=buffers * n / (ms * 1e-3),
                ms_by_launch=stages,
                launch_bytes_per_node=launch_bytes,
                bound_ms_by_launch={k: v * n / rate * 1e3
                                    for k, v in launch_bytes.items()})


def serf_chaos_main_path(cfg):
    """The new path of this slice through SerfSimulation: the sentinel on,
    64 ticks to form, 4 user events from live rows and a query from a
    live row, all on the partition's side A (an event must cross before
    the partition starts at window tick 2 to reach both sides, and one
    from side A, a quarter of the ring, all but surely does), then
    run_scenario over the chaos main path's timeline (CHAOS_WINDOW ticks
    plus 64 to settle), then 4 fresh events from live rows and
    run_until_converged. Passes when it converges with agreement 1.0, the
    fresh events' coverage is 1.0 and the sentinel mask is 0. The events
    fired into the fault are reported, not held to 1.0: a partition that
    starts while an event spreads leaves a residual of members that never
    hear it (their holders spend the retransmit budget on legs the
    partition drops, and nothing re-sends a spent event), in the
    reference as here (PERF.md). Also keeps the state at window
    tick CHAOS_TIMED_TICK."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster, counters, layout, serf
    from consul_tpu_torch.ops import cuda_gossip

    n = cfg.n
    t0 = time.perf_counter()
    sim = cluster.SerfSimulation(cfg, seed=0, layout="packed", kernel="cuda")
    sim.set_sentinel(True)
    setup_s = time.perf_counter() - t0
    reset_launches()
    stages = {}
    t0 = time.perf_counter()
    sim.run(64, chunk=64, with_metrics=False)
    torch.cuda.synchronize()
    stages["form"] = {"ticks": 64, "wall_s": round(time.perf_counter() - t0, 3)}
    # Clear of the churned rows 0..n/20.
    origins = [n // 20 + 1 + (n // 16) * j for j in range(SERF_EVENTS)]
    fired = [(int(sim.state.event_clock[r]), 1, r) for r in origins]
    sim.user_event(_rows(n, origins, "cpu"), 1)
    q_row = n // 8 + 3
    sim.query(_rows(n, [q_row], "cpu"), 3)
    q_slot = serf.newest_query_slot(sim.state, q_row)
    snap = {}
    own_draws = snapshot_at(sim, sim._t + CHAOS_TIMED_TICK, snap)
    t_window = sim._t
    t0 = time.perf_counter()
    res = sim.run_scenario(chaos_main_events(chaos, n), chunk=64, settle=64)
    torch.cuda.synchronize()
    stages["scenario"] = {"ticks": res.ticks,
                          "wall_s": round(time.perf_counter() - t0, 3)}
    sim.draws = own_draws
    fresh = [r + n // 2 for r in origins]
    fired += [(int(sim.state.event_clock[r]), 2, r) for r in fresh]
    sim.user_event(_rows(n, fresh, "cpu"), 2)
    t0 = time.perf_counter()
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    stages["converge"] = {"ticks": used,
                          "wall_s": round(time.perf_counter() - t0, 3)}
    launches = dict(cuda_gossip.LAUNCHES)
    state = sim.serf_state
    coverage = [dict(ltime=lt, name=name, origin=r,
                     fired="into the fault" if name == 1 else "after it",
                     coverage=float(serf.event_coverage(
                         cfg, state, serf.make_event_key(lt, name), r)))
                for lt, name, r in fired]
    agreement = float(trace.agreement[-1])
    finite = bool(torch.isfinite(trace.rmse).all()) and bool(
        torch.isfinite(state.swim.viv.vec).all())
    mask = counters.violation_mask(sim.counters)
    out = dict(n=n, k=cfg.degree, slo=res.slo, scenario_counters=res.counters,
               stages=stages, converged=converged, ticks_after_scenario=used,
               ticks_total=sim._t, agreement=agreement,
               rmse_ms=float(trace.rmse[-1]) * 1000.0,
               wall_s=round(sum(v["wall_s"] for v in stages.values()), 3),
               setup_s=round(setup_s, 3), sentinel_mask=mask,
               coverage=coverage,
               query={"origin": q_row, "slot": q_slot,
                      "acks": int(state.q_acks[q_row, q_slot]),
                      "resps": int(state.q_resps[q_row, q_slot]),
                      "live_nodes": int((state.swim.alive_truth
                                         & ~state.swim.left).sum())},
               launches=launches,
               bytes_per_node=layout.bytes_per_node(sim.state, n))
    ok = (converged and agreement == 1.0 and finite and mask == 0
          and all(c["coverage"] == 1.0 for c in coverage if c["name"] == 2)
          and all(v > 0 for v in launches.values())
          and res.slo["fault_ticks"] > 0 and res.slo["messages_dropped"] > 0)
    sched = chaos.shift_schedule(
        chaos.compile_schedule(n, chaos_main_events(chaos, n), sim.device),
        t_window)
    return sim, snap["state"], sched, out, ok


def serf_main_path(cfg):
    """The serf north star through SerfSimulation: 64 warm ticks, a 5 %
    kill, 4 user events from live rows and a query from a live row, then
    convergence in 512-tick slices with fresh events at each new slice."""
    from consul_tpu_torch.models import cluster, layout, serf
    from consul_tpu_torch.ops import cuda_gossip

    n = cfg.n
    t0 = time.perf_counter()
    sim = cluster.SerfSimulation(cfg, seed=0)
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    dead = torch.zeros(n, dtype=torch.bool)
    dead[: n // 20] = True
    sim.kill(dead)
    # Origins are live rows (the bench fires from rows it just killed,
    # bench.py:1111-1116, so its events never leave them).
    origins = [n // 20 + 1 + (n // 8) * j for j in range(SERF_EVENTS)]
    fired = []

    def fire(name):
        clocks = sim.state.event_clock
        for r in origins:
            fired.append((int(clocks[r]), name, r))
        sim.user_event(_rows(n, origins, "cpu"), name)

    fire(1)
    q_row = n // 2 + 3
    sim.query(_rows(n, [q_row], "cpu"), 3)
    q_slot = serf.newest_query_slot(sim.state, q_row)
    used, converged, trace, slice_idx = 0, False, None, 0
    while used < 4096 and not converged:
        if slice_idx:
            fire(2 + slice_idx)
        slice_idx += 1
        converged, u, trace = sim.run_until_converged(
            max_ticks=min(SERF_SLICE, 4096 - used), chunk=128)
        used += u
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_gossip.LAUNCHES)
    state = sim.serf_state
    coverage = [dict(ltime=lt, name=name, origin=r,
                     coverage=float(serf.event_coverage(
                         cfg, state, serf.make_event_key(lt, name), r)))
                for lt, name, r in fired]
    agreement = float(trace.agreement[-1])
    finite = bool(torch.isfinite(trace.rmse).all()) and bool(
        torch.isfinite(state.swim.viv.vec).all())
    res = dict(n=n, k=cfg.degree, converged=converged, ticks_after_kill=used,
               ticks_total=sim._t, agreement=agreement,
               rmse_ms=float(trace.rmse[-1]) * 1000.0, wall_s=round(wall, 3),
               setup_s=round(setup_s, 3), launches=launches,
               counters=sim.counters, coverage=coverage,
               query={"origin": q_row, "slot": q_slot,
                      "acks": int(state.q_acks[q_row, q_slot]),
                      "resps": int(state.q_resps[q_row, q_slot]),
                      "live_nodes": int((state.swim.alive_truth
                                         & ~state.swim.left).sum())},
               bytes_per_node=layout.bytes_per_node(sim.state, n))
    ok = (converged and agreement == 1.0 and tick_launches(launches) > 0
          and launches["metrics"] > 0 and finite)
    return sim, res, ok


def reset_launches():
    from consul_tpu_torch.ops import cuda_gossip

    for k in cuda_gossip.LAUNCHES:
        cuda_gossip.LAUNCHES[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, layout, serf, swim
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.utils import metrics

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
    max_abs = {k: 0.0 for k in (
        "gossip_tick", "gossip_tick_serf", "gossip_tick_chaos",
        "gossip_tick_sentinel", "gossip_tick_serf_chaos")}
    max_abs.update({"gossip_tick_" + v[0]: 0.0 for v in DENSE_VARIANTS})

    def fold_abs(name, res):
        max_abs[name] = max([max_abs[name]] + [
            g["abs"] for g in res["float_gaps"].values()])
    for n, loss in PARITY:
        t0 = time.perf_counter()
        res = parity(n, loss, PARITY_TICKS, seed=7)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = not res["mismatches"] and all(
            res["counters_in_window"][f] > 0
            for f in ("suspicions_started", "deaths_declared", "refutations"))
        fold_abs("gossip_tick", res)
        emit({"phase": "kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"kernel_parity n={n}")
    for n, loss, relay, ticks in SERF_PARITY:
        t0 = time.perf_counter()
        res = serf_parity(n, loss, relay, ticks, seed=11)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = not res["mismatches"] and all(
            res["in_window"][f] > 0 for f in (
                "serf_intents_queued", "serf_intents_retx",
                "serf_intents_dropped", "delivered", "query_acks",
                "leave_quiet"))
        fold_abs("gossip_tick_serf", res)
        emit({"phase": "serf_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"serf_kernel_parity n={n}")
    for n, loss in CHAOS_PARITY:
        t0 = time.perf_counter()
        res = chaos_parity(n, loss, PARITY_TICKS, seed=13)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = chaos_ok(res)
        fold_abs("gossip_tick_chaos", res)
        emit({"phase": "chaos_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"chaos_kernel_parity n={n}")
    windows = ([(MAIN_N, 0.0, SLO_TICKS, 19, "slo")]
               + [(n, 0.01 if n < MAIN_N else 0.0, 8, 17, family)
                  for family, n in CHAOS_FAMILIES])
    for n, loss, ticks, seed, family in windows:
        t0 = time.perf_counter()
        res = chaos_parity(n, loss, ticks, seed=seed, family=family)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = chaos_ok(res)
        fold_abs("gossip_tick_sentinel" if family == "none"
                 else "gossip_tick_chaos", res)
        emit({"phase": "chaos_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"chaos_kernel_parity n={n} family={family}")
    for n, loss, relay, ticks, fault in SERF_CHAOS_PARITY:
        t0 = time.perf_counter()
        res = serf_chaos_parity(n, loss, relay, ticks, fault, seed=23)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = serf_chaos_ok(res)
        fold_abs("gossip_tick_serf_chaos", res)
        emit({"phase": "serf_chaos_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"serf_chaos_kernel_parity n={n}")
    dense_t = {}
    for variant, serf_plane, chaos_on in DENSE_VARIANTS:
        t0 = time.perf_counter()
        res, dense_t[variant] = dense_parity(variant, serf_plane, chaos_on,
                                             seed=29, rate=rate)
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs("gossip_tick_" + variant, res)
        emit({"phase": "dense_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"dense_kernel_parity {variant}")
    emit({"phase": "dense_timing", "n": DENSE_N, **dense_t})
    rows_of = {"bare": "gossip_tick", "serf_chaos": "gossip_tick_serf_chaos",
               "dense": "gossip_tick_dense", "dense_serf": "gossip_tick_dense_serf"}
    for variant, n, serf_plane, chaos_on in TIE_WINDOWS:
        t0 = time.perf_counter()
        res = tie_wrap_parity(variant, n, serf_plane, chaos_on, seed=31)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs(rows_of[variant], res)
        emit({"phase": "tie_wrap_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"tie_wrap_kernel_parity {variant}")
    stress_rows = {"serf": "gossip_tick_serf", "serf_chaos": "gossip_tick_serf_chaos",
                   "dense_serf": "gossip_tick_dense_serf",
                   "dense_serf_chaos": "gossip_tick_dense_serf_chaos"}
    for variant, n, chaos_on in STRESS_WINDOWS:
        t0 = time.perf_counter()
        res = serf_stress_parity(variant, n, chaos_on, seed=37)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs(stress_rows[variant], res)
        emit({"phase": "serf_stress_kernel_parity", **res})
        if not res["ok"]:
            failed.append(f"serf_stress_kernel_parity {variant}")
    if failed:
        emit({"phase": "failed", "failed": failed})
        return 1

    # Main path: the north-star cell through the user's entry points.
    cfg = SimConfig(n=MAIN_N, view_degree=32)
    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda")
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    mask = torch.zeros(cfg.n, dtype=torch.bool)
    mask[: cfg.n // 20] = True
    sim.kill(mask)
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_gossip.LAUNCHES)
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
    if not (converged and agreement == 1.0 and tick_launches(launches) > 0
            and launches["metrics"] > 0
            and finite):
        emit({"phase": "failed", "failed": ["main_path"]})
        return 1
    swim_launches = tick_launches(launches)
    m_launches = launches["metrics"]

    # Kernel timing at the main path's shapes, on its final state.
    tick = cuda_gossip.make_tick_kernel(cfg, sim.topo)
    d = swim.draw_tick(cfg, sim.gen, sim.device)
    swim_t = time_kernel(
        tick, lambda w, s, dd: cuda_gossip.plain_tick(cfg, sim.topo, w, s, dd),
        sim.world, sim.state, d,
        cuda_gossip.tick_hbm_bytes_per_node(sim.state, sim.world), cfg.n, rate)
    emit({"phase": "timing", **swim_t})
    # Launch M on the SWIM path's final state: parity, its time per launch
    # against its bound and its plain version's, then a tick with metrics
    # against one without.
    m_cases = [metrics_case("swim_final", cfg, sim.topo, sim.world,
                            sim.state, seed=41)]
    mk = cuda_gossip.make_metrics_kernel(cfg, sim.topo)
    mgen = torch.Generator(device="cuda")
    mgen.manual_seed(43)
    mi, mj = metrics.rmse_samples(cfg, mgen, METRIC_PAIRS, "cuda")
    mout = torch.empty(4, device="cuda")
    # "ms" is the kernel's own device time (profiler; None when the
    # profiler records none); "ms_events" is CUDA events around
    # back-to-back calls, the wrapper's host work included.
    m_call = lambda: mk(sim.world, sim.state, mi, mj, mout)  # noqa: E731
    m_prof = launch_breakdown(m_call, 20)
    m_t = {"ms_events": cuda_ms(m_call, 50),
           "plain_ms": cuda_ms(lambda: cuda_gossip.plain_metrics(
               cfg, sim.topo, sim.world, sim.state, mi, mj), 5),
           "bytes": cuda_gossip.metrics_hbm_bytes(sim.state, sim.world,
                                                  METRIC_PAIRS)}
    m_dev = m_prof if isinstance(m_prof, dict) else {}
    m_t["ms"] = next((v for k, v in m_dev.items() if k.startswith("k_metrics")),
                     None)
    m_t["bound_ms"] = m_t["bytes"] / rate * 1e3
    m_ticks = {"swim": tick_with_and_without_metrics(sim)}
    del sim, tick, d, mk
    torch.cuda.empty_cache()

    # The chaos main path, and the chaos + sentinel variant's timing on its
    # state at window tick CHAOS_TIMED_TICK under the same schedule.
    csim, cstate, csched, res, ok = chaos_main_path(cfg)
    emit({"phase": "chaos_main_path", **res})
    if not ok:
        emit({"phase": "failed", "failed": ["chaos_main_path"]})
        return 1
    # The scenario's ticks ran the chaos + sentinel variant; forming and
    # converging ran the sentinel variant without a schedule.
    m_launches += res["launches"]["metrics"]
    form, scen, final = (tick_launches(res[k]) for k in (
        "form_launches", "scenario_launches", "launches"))
    chaos_launches, sentinel_launches = scen - form, form + final - scen
    ctick = cuda_gossip.make_tick_kernel(cfg, csim.topo, sentinel=True)
    d = swim.draw_tick(cfg, csim.gen, csim.device, chaos=True)
    chaos_t = time_kernel(
        ctick,
        lambda w, s, dd: cuda_gossip.plain_tick(cfg, csim.topo, w, s, dd,
                                                csched, sentinel=True),
        csim.world, cstate, d,
        cuda_gossip.tick_hbm_bytes_per_node(cstate, csim.world, csched),
        cfg.n, rate, sched=csched)
    emit({"phase": "chaos_timing", "window_tick": CHAOS_TIMED_TICK,
          "t": int(cstate.t), **chaos_t})
    # The sentinel variant without a schedule, on the converged state.
    d = swim.draw_tick(cfg, csim.gen, csim.device)
    sentinel_t = time_kernel(
        ctick,
        lambda w, s, dd: cuda_gossip.plain_tick(cfg, csim.topo, w, s, dd,
                                                sentinel=True),
        csim.world, csim.state, d,
        cuda_gossip.tick_hbm_bytes_per_node(csim.state, csim.world), cfg.n,
        rate)
    emit({"phase": "sentinel_timing", "t": int(csim.state.t), **sentinel_t})
    m_cases += [
        metrics_case("chaos_window", cfg, csim.topo, csim.world, cstate, seed=47),
        metrics_case("chaos_final", cfg, csim.topo, csim.world, csim.state,
                     seed=53),
        metrics_case("chaos_window_nan", cfg, csim.topo, csim.world,
                     corrupt(cstate, cfg.n, cfg.degree), seed=59,
                     nan_rows=range(cfg.n // 3, cfg.n // 3 + 3))]
    del csim, ctick, cstate, csched, d
    torch.cuda.empty_cache()

    # The serf main path and the serf variant's timing on its final state.
    ssim, res, ok = serf_main_path(cfg)
    emit({"phase": "serf_main_path", **res})
    if not ok:
        emit({"phase": "failed", "failed": ["serf_main_path"]})
        return 1
    serf_launches = tick_launches(res["launches"])
    m_launches += res["launches"]["metrics"]
    stick = cuda_gossip.make_tick_kernel(cfg, ssim.topo, serf_plane=True)
    d = serf.draw_serf_tick(cfg, ssim.gen, ssim.device)
    serf_t = time_kernel(
        stick,
        lambda w, s, dd: cuda_gossip.plain_serf_tick(cfg, ssim.topo, w, s, dd),
        ssim.world, ssim.state, d,
        cuda_gossip.tick_hbm_bytes_per_node(ssim.state, ssim.world), cfg.n, rate)
    emit({"phase": "serf_timing", **serf_t})
    m_cases.append(metrics_case("serf_final", cfg, ssim.topo, ssim.world,
                                ssim.state.swim, seed=61))
    m_ticks["serf"] = tick_with_and_without_metrics(ssim)
    del ssim, stick, d
    torch.cuda.empty_cache()

    # This slice's path: serf with the composed timeline and the sentinel,
    # and its variant's timing inside the fault window under the schedule.
    xsim, xstate, xsched, res, ok = serf_chaos_main_path(cfg)
    emit({"phase": "serf_chaos_main_path", **res})
    if not ok:
        emit({"phase": "failed", "failed": ["serf_chaos_main_path"]})
        return 1
    serf_chaos_launches = tick_launches(res["launches"])
    m_launches += res["launches"]["metrics"]
    xtick = cuda_gossip.make_tick_kernel(cfg, xsim.topo, serf_plane=True,
                                         sentinel=True)
    d = serf.draw_serf_tick(cfg, xsim.gen, xsim.device, chaos=True)
    serf_chaos_t = time_kernel(
        xtick,
        lambda w, s, dd: cuda_gossip.plain_serf_tick(cfg, xsim.topo, w, s, dd,
                                                     xsched, sentinel=True),
        xsim.world, xstate, d,
        cuda_gossip.tick_hbm_bytes_per_node(xstate, xsim.world, xsched), cfg.n,
        rate, sched=xsched)
    emit({"phase": "serf_chaos_timing", "window_tick": CHAOS_TIMED_TICK,
          "t": int(xstate.swim.t), **serf_chaos_t})
    m_cases += [
        metrics_case("serf_chaos_window", cfg, xsim.topo, xsim.world,
                     xstate.swim, seed=67),
        metrics_case("serf_chaos_final", cfg, xsim.topo, xsim.world,
                     xsim.state.swim, seed=71)]
    del xsim, xtick, xstate, xsched, d
    torch.cuda.empty_cache()

    # The dense view through the entry points, each variant.
    dense_runs, dense_finals = dense_main_path()
    emit({"phase": "dense_main_path", **dense_runs})
    if not all(r["ok"] for r in dense_runs.values()):
        emit({"phase": "failed", "failed": ["dense_main_path"]})
        return 1
    m_launches += sum(r["launches"]["metrics"] for r in dense_runs.values())
    m_cases += [metrics_case(v + "_final", *dense_finals[v], seed=73)
                for v, _, _ in DENSE_VARIANTS]

    # Launch M against its plain version on every state above.
    emit({"phase": "metrics_parity", "rtol_rmse": RMSE_RTOL,
          "cases": m_cases})
    if not all(c["ok"] for c in m_cases):
        emit({"phase": "failed", "failed": ["metrics_parity"]})
        return 1
    emit({"phase": "metrics_timing", "n": MAIN_N, "pairs": METRIC_PAIRS,
          "launch": m_t, "tick_ms": m_ticks,
          "main_path_metrics_launches": m_launches})

    # run_resilient at 1M: preempted, resumed, bit-equal.
    res = resilient_phase(cfg)
    emit({"phase": "resilient", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["resilient"]})
        return 1

    def row(name, config, launches, t):
        return {"name": name, "route": "cuda",
                "source": "consul_tpu_torch/csrc/gossip_tick.cu",
                "replaces": "consul_tpu/ops/pallas_gossip.py:145",
                "config": config, "launches": launches,
                "max_abs_err": max_abs[name], "ms": t["ms_per_tick"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "ms_by_launch": t["ms_by_launch"],
                "bound_ms_by_launch": t["bound_ms_by_launch"]}

    steps = {False: "swim.step_counted", True: "serf.step_counted (extra_tx)"}
    dense_rows = [
        row("gossip_tick_" + v, f"step_fn={steps[sp]}, "
            + ("sched=<dense_events>, sentinel=True" if ch
               else "sched=None, sentinel=False")
            + f", dense (K = {DENSE_N - 1}), packed",
            tick_launches(dense_runs[v]["launches"]), dense_t[v])
        for v, sp, ch in DENSE_VARIANTS]
    print(json.dumps({"kernels": [
        row("gossip_tick", "step_fn=swim.step_counted, sched=None, "
            "sentinel=False, sparse, packed", swim_launches, swim_t),
        row("gossip_tick_serf", "step_fn=serf.step_counted (extra_tx), "
            "sched=None, sentinel=False, sparse, packed", serf_launches,
            serf_t),
        row("gossip_tick_chaos", "step_fn=swim.step_counted, sched=<composed>, "
            "sentinel=True, sparse, packed", chaos_launches, chaos_t),
        row("gossip_tick_sentinel", "step_fn=swim.step_counted, sched=None, "
            "sentinel=True, sparse, packed", sentinel_launches, sentinel_t),
        row("gossip_tick_serf_chaos", "step_fn=serf.step_counted (extra_tx), "
            "sched=<composed> or None, sentinel=True, sparse, packed",
            serf_chaos_launches, serf_chaos_t)] + dense_rows + [
        {"name": "gossip_metrics", "route": "cuda",
         "source": "consul_tpu_torch/csrc/gossip_tick.cu",
         "replaces": "consul_tpu/models/cluster.py:263",
         "config": "launch M: the TickTrace row from the packed leaves, "
                   f"{METRIC_PAIRS} RMSE pairs (not a TPU kernel: the "
                   "reference's metrics tail of the chunk body)",
         "launches": m_launches,
         "max_abs_err": max(c["max_abs_err"] for c in m_cases),
         "ms": m_t["ms"], "ms_events": m_t["ms_events"],
         "plain_ms": m_t["plain_ms"],
         "bound_ms": m_t["bound_ms"], "bound_by": "bytes",
         "library_ms": None}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
