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
cluster and lifts, so every SLO counter moves; launch P alone
(``p_parity``: ``k_chaos_pre``'s row word and record bit-equal to
``plain_chaos_pre`` on every tick of the composed timeline's window at
1M, from before its first entry to after its last, through churn edges
both ways, and of a 97-entry timeline at 65,536 nodes whose masks take
four words a row; on the one-device kernel and on B7 at 4 shards in one
group and in a group per shard); the serf + chaos +
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
many origins, a relayed query under loss); and B8, the pre-fusion serf
tick in the kernel (``variant="serf_reference"``: A-C bare, then E1 and
E2), against ``plain_reference_serf_tick`` bit for bit in ``b8_parity``'s
windows (1M quiet with 3 events, a query and a leave; 1M under a link
loss with the sentinel, 2 relays and 1 % loss; the dense view with and
without a schedule; the stress and tie-and-wrap states at 65,536 and
dense), timed by ``b8_timing`` on the quiet 1M window. It drives the port's main
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
against an uninterrupted run, bit for bit. The serving phases run the
serving plane over a live 1M ``Simulation``: ``serving_parity`` (NearestN
on a fresh simulation answers the lowest live ids; every query mode on the
card against the CPU; after the mixed run, the write state and every watch
frame against the numpy oracles; a write-attached plane leaves the
trajectory bit-equal), ``serving`` (32 batches of 1,024 NearestN queries
at k = 8, bench.py:750-785) and ``serving_mixed`` (``run_mixed`` at 90:9:1,
bench.py:795-805). The raft phases run the raft tier (``set_raft``) over
a live 1M ``Simulation``: ``raft_parity`` (16x5 and 4x3 groups, 256 ticks
under a leader kill, a partition and a storm: every raft field and
counter on the card equal to ``raft_ops.tick`` replayed on the CPU from
the same draw tensors at every chunk boundary, the chaos masks equal to
their numpy twin, the gossip trajectory with raft bit-equal to one
without, and the bare kernel's chaos variant under the raft-only
schedule bit-equal to ``plain_tick``), ``raft_main_path`` (the bench's
raft flow, bench.py:482-554: ticks/s, elections/s under a storm, commit
latency), ``raft_serving`` (``run_mixed`` at 90:9:1 through the raft
write gate, then the leader-kill drill of tests/test_raft_device.py:
308-366 at 1M) and ``raft_timing`` (ms/tick with and without raft, the
raft step's device time, launches and host syncs). The sweep phases run
the scenario-sweep plane (``chaos/sweep.py``): ``sweep_parity`` (five
lanes at 65,536 nodes through the kernel against the plain tick on each
view-graph family, bit for bit, and once more on ``SerfSimulation``),
``sweep_main_path`` (``bench_pareto`` at 1M: 16 partition lanes on each
family, the Pareto table, lane-ticks/s, peak memory, host syncs, and on
circulant lane 0 and the worst lane against their solo replays),
``sweep_serf``, ``sweep_raft`` (raft 16x5 armed) and
``sweep_bench_shape`` (the bench's n = 1,024). The federation phases
run the port's ``Federation`` and ``DcnFederation``:
``federation_parity`` (4 DCs x 65,536 nodes, then the main path's 4 x
250,000, each with the 12-server WAN pool, kernel against plain from one
formed state for 40 LAN ticks with 16 WAN fires, bit for bit),
``federation_main_path`` (BASELINE.json's fifth config, 4 x 250,000: a
non-server kill that stays in dc0, dc3 killed and seen dead on the WAN,
the port's Router order equal to the true DC order on a fault-free
federation of the same seed, LAN ticks/s, peak bytes, host
syncs, the LAN launch sets and the WAN tick timed apart) and
``dcn_drill`` (bench.py's drill through the port, kernel against plain
and its link envelope against the CPU's, then at 2 x 250,000 with the
sync's ms a round, kernel against plain). The sharded call (B7, the
tick once per node-axis shard, on ``["cuda:0"] * R``) runs beside the
B1 windows at 65,536 and 50,000 nodes, the chaos + sentinel, serf and
serf + chaos + sentinel windows at 65,536, two dense variants and the
bare tie-and-wrap window at 1M, under two groupings of the shards: the
default (the card's shards in one device group, one launch set a stage,
no exchange) and one group per shard (the launches, exchanges, tally
scratch and SLO fold a mesh of one card per shard runs):
``sharded_kernel_parity`` holds it at 2 and 4 shards bit for bit to the
one-device kernel on every tick, and the sharded plain runner (one
thread per shard) to it for the first ticks; ``sharded_timing`` times it
at 1M under both groupings (launches and copies a tick, the exchanges
and the launch sets apart, beside B1 on the same state) and
``sharded_main_path`` drives the 1M SWIM main path through
``Simulation(mesh=["cuda:0"] * 4)``, which must converge on the
one-device run's tick with bit-equal counters and state, in the
one-device launch set a tick with no copy (wall and peak bytes beside
the one-device run's). The mesh's planes (ROADMAP A13) follow on 4
shards of the card under both groupings, from the main path's state
after its kill and held to the one-device ``Simulation`` of the same
seed: ``sharded_raft`` (raft 16 x 5, group-sharded, and 6 x 5,
replicated, under ``raft_parity``'s leader-kill drill for 256 ticks:
every gossip and raft leaf and counter bit-equal, ms a tick with raft),
``sharded_serving`` (1,024 NearestN queries at k = 8 through the
two-stage top-k: ids equal, rtts within 1e-6 relative; a write batch
and a flip: apply index and KV reads equal; batch ms and peak
temporaries), ``sharded_sweep`` (lanes 0, 5, 10 and 15 of
``bench_pareto``'s grid for 128 ticks: counters and lane states
bit-equal, the simulation unmoved; ms a lane-tick) and
``elastic_drill`` (``run_resilient`` preempted at tick 256 of 512 on 4
shards, resumed on 2 shards and with ``elastic=True`` over the one
card: the uninterrupted run's state digest, one reshard each).
``federation_wan_timing`` takes the WAN pool's per-launch times from
``launch_timing.py --states wan`` in a fresh process. ``metrics_timing`` times launch M at 1M and on
the dense view (n = 256). The observability phases (ROADMAP A18):
``lens_parity`` holds launch L (the node-lens row, ``LensKernel``)
against ``obs.lens.snapshot_packed`` bit for bit after every tick of a
32-tick window on four states (the SWIM path's after a kill, serf, chaos +
sentinel, dense at n = 256) at ``normalize_ids(n, 64)`` plus rows 1 and
n - 1; ``lens_main_path`` drives the 1M SWIM main path with
``set_lens(64)`` armed, which must converge on the unarmed run's tick
with bit-equal state and counters, one L launch a tick, and no host
sync in a metrics-off chunk; ``trace_capture`` reads the ``cuda.build``
span of this run's build (exactly one when this run compiled the
library, none when it loaded a library an earlier run had built), exports a traced run with the lens's counter
tracks and checks its schema and chunk spans, then runs
``utils/debug.capture_sim`` with an 8-tick ``torch.profiler`` profile
whose trace must hold every tick launch, L and the ``sim_chunk`` range;
``lens_timing`` times L alone and a tick with the lens against one
without on the SWIM and serf paths (at most 1.1x); ``blackbox_live``
captures the CUDA-init black box in this process. The game day's slice
(ROADMAP A10, A19) runs after the federation phases:
``serf_reference_parity`` (``SerfSimulation`` on B4 against the
pre-fusion oracle ``ReferenceSerfSimulation`` on B8, from one seed at
1M: tests/test_serf_fused.py's scenarios with origins scaled to n, until
full coverage; the SWIM plane bit-equal, delivered counts, Lamport
floors and SLO counters equal; E1 and E2 launched once a tick; the plain
oracle's replay of the window bit-equal to the oracle's state; each
one's ms a tick; ``kernel="cuda"`` on the CPU refused), ``snapshot_rejoin`` (the serf
snapshotter on a seat of the 1M serf state, then a warm rejoin in fewer
ticks than a cold restart), ``frontend_parity`` (``AsyncFrontend`` over a
live 1M plane against the batchers, a blocking wait woken by a flip, an
HTTP round trip on 127.0.0.1) and ``gameday_main_path`` (``run_gameday``
at 1M with the async front end and a 4-process swarm, then the threaded
one: the SLO verdict, lost writes 0, B1, B2 and B5 launched). Then
``cli_main_path`` runs the port's CLI verbs as a user would, each
``python -m consul_tpu_torch.cli`` in a process of its own at 1M
(``prewarm``, ``run --prewarm``, ``trace``, ``chaos --sweep``,
``serve-bench``, ``gameday``), and a SIGTERM drill: ``run --ckpt-dir``
stopped after its first checkpoint exits 75, the rerun resumes and ends
in an uninterrupted run's state. Then the federation on a mesh and the
beyond-memory tier (ROADMAP A13 item 4, A12b): ``federation_mesh``
(``Federation(mesh=)`` at 4 x 250,000 on ``["cuda:0"] * 8`` as a (2, 4)
(dc, nodes) mesh, every DC through a sharded tick of its own: the main
path's flow in one group a row and the parity window in a group per
shard, each bit-equal to the one-device federation at every chunk
boundary), ``dcn_meshes`` (``DcnFederation(meshes=)``, 4 x 250,000 on
two islands of (2, 2) meshes, under both groupings and bench.py's drill
faults, bit-equal to the meshless run with the same envelope) and
``streamed`` (``StreamedSimulation`` at 8,388,608 SWIM nodes under an
8 GB budget in two passes of 64 ticks, and ``StreamedSerfSimulation`` at
2,097,152 under 16 GB in one pass of 16: the plan equal to the
reference planner's, checked cohorts bit-equal to a resident simulation
fed the cohort's state, world and draws, the device peak within the
plan's resident bytes, the copies' overlap with the ticks). Then the
transport seam and the server core (ROADMAP A21's first part):
``wire_host`` (the native LZW library built under the kernels' build
directory and equal to the pure-Python codec past the 4,095-code reset;
the port's codec writing the reference's golden frames, one a message
family; whether ``cryptography`` is there), ``bridge_main_path`` (one
scripted agent on a 1M ``Simulation`` through B1: it takes a dead
holder's seat by the trackers' vote, joins by push-pull, learns its
neighbours, its coordinate converges against the planted RTTs, and when
it stops answering its trackers hold it suspect and then dead; 32 agents
on adjacent seats of a 1M ``SerfSimulation`` through B4: all stay alive,
an agent's event reaches every live sim node and the other agents, a sim
query collects the fleet's acks and answers; each run's first 16
bridged ticks beside a plain-tick twin on the card, the packed state
bit-equal and every agent's packets byte-equal at every tick, the first
run of the kernel's external-seat branches; ms a bridged tick split into
the tick, the row gathers and write-backs, the bridge's host step and the
agents, device-to-host bytes a step, peak bytes) and
``raft_lockstep_oracle`` (raft 16 x 5 on a 1M ``Simulation`` under
``raft_events``, so its gossip ticks run B2: every RaftState field and
the cumulative counters equal to the port's ``LockstepRaftOracle``, fed
the recorded draws, at every chunk boundary; the oracle's ms a tick
beside the card's). It prints one JSON line per phase (the timing lines' ``ms_by_launch`` give P, A, B
and C under the schedule; ``federation_wan_timing`` carries the launch
floor, a one-element add's device time, from its child process),
the kernel table, the card's name and power limit, and a last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. It needs a CUDA H100 and the
rest of the repository; without either it fails before printing a
result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import shutil
import signal
import subprocess
import sys
import time

import torch

# The sharded call (B7) on one card: shard counts of the parity windows
# and the timing, the main path's shard count, and the ticks of each
# window on which the sharded plain runner is held to B7 as well.
SHARDS = (2, 4)
SHARD_MAIN = 4
SHARD_PLAIN_TICKS = 8
# The dense variants held sharded (the plain runner's threads dominate
# a dense window's time).
SHARD_DENSE = ("dense", "dense_serf_chaos")
# The mesh's planes (ROADMAP A13 items 1, 2, 3 and 5) at the main path's
# shape on MESH_SHARDS shards of the one card: the raft shapes (R x P:
# group-sharded over 4 shards, then replicated) and their drill's ticks,
# the sweep's lanes of bench_pareto's grid and their ticks, the elastic
# drill's ticks and its preemption tick, and its checkpoint directory.
MESH_SHARDS = 4
MESH_RAFT = ((16, 5), (6, 5))
MESH_RAFT_TICKS = 256
MESH_SWEEP_LANES = (0, 5, 10, 15)
MESH_SWEEP_TICKS = 128
MESH_ELASTIC_TICKS = 512
MESH_ELASTIC_STOP = 256
MESH_DIR = os.path.join("build", "mesh_planes")
# B7's groupings of the shards on the one card: "device", the default
# (every shard of the card in one group: one launch set, no exchange), and
# "shard", one group per shard (what a mesh of one card per shard runs).
GROUPINGS = ("device", "shard")


def group_of(mesh, grouping: str):
    """The grouping named ``grouping`` of ``mesh`` (GROUPINGS)."""
    from consul_tpu_torch.parallel import mesh as mesh_mod

    return (mesh_mod.device_groups(mesh) if grouping == "device"
            else mesh_mod.shard_groups(mesh))

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
# Launch P alone (k_chaos_pre) against plain_chaos_pre, bit for bit: (name,
# n, timeline, ticks formed, window ticks). The composed timeline's window
# runs from before its first entry opens to after its last one closes,
# through every churn edge both ways; the wide one (wide_events) takes its
# masks over four bit words a row. Each window runs on the one-device
# kernel and on B7 at P_SHARDS shards under both groupings.
P_WINDOWS = (("composed_1m", MAIN_N, "composed", 32, CHAOS_WINDOW + 2),
             ("wide_64k", 65536, "wide", 8, 40))
P_SHARDS = 4
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
# The serving phases (bench.py:736-815) over a live 1M Simulation: NearestN
# at k = 8 in batches of 1,024 after one 128-tick chunk, a warm batch and 32
# timed ones from random.Random(0) sources; then run_mixed at 90:9:1, 16
# rounds, read batch 1,024, 8 watchers, 8 services, 256 KV slots, seed 0.
# serving_parity holds the card against the CPU on SERVING_QUERIES queries
# of each mode: ids, counts and tick equal, rtts within SERVING_RTOL
# relative, after checking that each NEAREST row's k-th and (k+1)-th
# distances differ by more than that.
SERVING_K = 8
SERVING_BATCH = 1024
SERVING_REPS = 32
SERVING_CHUNK = 128
SERVING_QUERIES = 64
SERVING_RTOL = 1e-6
MIXED_ROUNDS = 16
MIXED_SERVICES = 8
MIXED_KV_SLOTS = 256
MIXED_WATCHERS = 8
# The raft tier (bench.py:482-554; tests/test_raft_device.py): the bench
# ladder's shapes, each group one Consul server set (3 or 5 servers), with
# the reference's default timings and a 32-entry log window.
RAFT_SHAPES = ((16, 5), (4, 3))
RAFT_WINDOW = 32
RAFT_PARITY_TICKS = 256
RAFT_PARITY_CHUNK = 32
RAFT_TRAJECTORY_TICKS = 128
RAFT_GOSSIP_WINDOW = 8
# Client entries proposed on every group at the start of these chunks.
RAFT_PARITY_PROPOSALS = {1: 3, 4: 5}
RAFT_CHUNK = 8
RAFT_TIMED_TICKS = 32
# The leader-kill drill's group (tests/test_raft_device.py:308-366): one
# group of 5 with the reference test's short timeouts, re-elected within
# 48 ticks of the kill's start.
DRILL_RAFT = dict(peers=5, window=16, election_ticks_min=6,
                  election_ticks_max=12)
DRILL_BOUND_TICKS = 48
STRESS_TICKS = 24
# B8's windows against its plain version (b8_parity): (name, n, stimulus,
# schedule + sentinel, relay factor, packet loss); 1M and the dense view at
# DENSE_N; the stress and tie-and-wrap states at 65,536 and dense.
B8_TICKS = 32
# B8's own launches (E1, E2), which no other variant runs.
B8_STAGES = ("ref_send", "ref_intake")
B8_WINDOWS = (("quiet_1m", MAIN_N, "quiet", False, 0, 0.0),
              ("link_loss_1m", MAIN_N, "quiet", True, 2, 0.01),
              ("dense", DENSE_N, "quiet", False, 2, 0.01),
              ("dense_chaos", DENSE_N, "quiet", True, 2, 0.01),
              ("stress", 65536, "stress", False, 2, 0.01),
              ("stress_chaos", 65536, "stress", True, 2, 0.01),
              ("stress_dense", DENSE_N, "stress", False, 2, 0.01),
              ("tie_wrap", 65536, "tie_wrap", True, 2, 0.01),
              ("tie_wrap_dense", DENSE_N, "tie_wrap", False, 0, 0.01))
STRESS_WINDOWS = (("serf", MAIN_N, False), ("serf_chaos", MAIN_N, True),
                  ("dense_serf", DENSE_N, False),
                  ("dense_serf_chaos", DENSE_N, True))
# Scenario sweeps (ROADMAP A17; consul_tpu/chaos/sweep.py, bench.py:556-590).
# Parity: five lanes at 65,536 nodes on each view-graph family, formed
# SWEEP_FORM ticks, settling SWEEP_PARITY_SETTLE after the last stop; then
# at MAIN_N the main path's own lane shape (one Partition slot): its first
# and last grid lanes, settling SWEEP_PARITY_MAIN_SETTLE, since the plain
# tick takes ~0.1 s a lane-tick there. The main path: the bench's
# topology phase at 1M, 16 grid lanes settling SWEEP_SETTLE ticks: the
# longest heal of a 1M grid lane in a 2,048-tick window was 452 ticks
# (H100, 700 W; sweep_main_path(cfg, settle=2048)), so 512 lets every
# lane heal inside the window. The bench's own shape runs at n = 1,024 as
# BENCH_SWEEP.
SWEEP_PARITY_N = 65536
SWEEP_FORM = 64
SWEEP_PARITY_SETTLE = 32
SWEEP_PARITY_MAIN_SETTLE = 12
SWEEP_FAMILIES = ("circulant", "expander", "smallworld", "hier")
SWEEP_LANES = 16
SWEEP_SETTLE = 512
# A sweep reads its counters back once, at its end.
SWEEP_SYNCS = 1
SWEEP_SERF_LANES = 8
SWEEP_SERF_SETTLE = 64
SWEEP_RAFT_TICKS = 32
BENCH_SWEEP = dict(n=1024, degree=16, scenarios=16, settle=192)
# The federation and the DCN tier (ROADMAP A14; consul_tpu/models/
# federation.py, consul_tpu/parallel/dcn.py), LAN view K = 32 as the main
# path's. Parity, at 4 DCs x 65,536 nodes and at the main path's own 4 x
# 250,000 (250,000 = 7,812 x 32 + 16: the last warp tile half filled), each
# with the WAN pool (4 x 3 servers, the dense view K = 11): formed
# FED_PARITY_FORM ticks through the kernel, then
# a 5 % kill of dc0's other nodes and dc1's server 0, FED_PARITY_SETTLE
# ticks more, then FED_PARITY_TICKS LAN ticks (16 of them fire the WAN
# tick) through the kernel and the plain tick from one state with one draw
# bundle per tick. The main path: BASELINE.json's fifth config, 4 DCs x
# 250,000 nodes, formed FED_FORM ticks, a non-server node of dc0 killed and
# dc3 killed whole, then FED_AFTER ticks (tests/test_federation.py's flow).
FED_PARITY = dict(n_dc=4, nodes_per_dc=65536, servers_per_dc=3)
FED_PARITY_FORM = 60
FED_PARITY_SETTLE = 20
FED_PARITY_TICKS = 40
FED_MAIN = dict(n_dc=4, nodes_per_dc=250_000, servers_per_dc=3)
FED_FORM = 60
FED_AFTER = 780
FED_CHUNK = 32
FED_TIMED_TICKS = 32
FED_VIEW = 32
# bench.py's DCN drill (:641-676): 2 DCs x 64 nodes, 2 servers, K = 8, two
# islands, the link 0 -> 1 timing out and 1 -> 0 dropping over sync rounds
# [1, 4), DCN_ROUNDS rounds of DCN_SYNC ticks; then the same faults at
# 2 islands x 1 DC x 250,000 nodes (K = 32).
DCN_DRILL = dict(n_dc=2, nodes_per_dc=64, servers_per_dc=2)
DCN_DRILL_VIEW = 8
DCN_BIG = dict(n_dc=2, nodes_per_dc=250_000, servers_per_dc=2)
DCN_ROUNDS = 12
DCN_SYNC = 16
DCN_COUNTERS = ("retries", "link_down_ticks", "send_timeouts", "retx_dropped",
                "heals", "link_degraded")
# The federation on a (dc, nodes) mesh of the card (ROADMAP A13 item 4):
# FED_MAIN over ["cuda:0"] * 8 as a (2, 4) mesh (2 DCs a row, 4 shards of
# 62,500 rows a DC); the DCN tier's islands each a (2, 2) mesh of the card,
# 4 DCs x 250,000 (3 servers), under bench.py's drill faults.
FED_MESH_DEVICES, FED_MESH_ROWS = 8, 2
DCN_MESH = dict(n_dc=4, nodes_per_dc=250_000, servers_per_dc=3)
DCN_MESH_DEVICES, DCN_MESH_ROWS = 4, 2
# Cohort streaming (ROADMAP A12b): SWIM at 8,388,608 nodes (K = 32, packed)
# under an 8 GB budget (the reference's planner: 8 cohorts of 1,048,576,
# chunk 64, 5,276,434,434 resident bytes), two passes of 64 ticks; serf at
# 2,097,152 under 16 GB (2 cohorts, 10,209,984,522 bytes), one pass of 16.
STREAM_SWIM = dict(n=8_388_608, budget="8GB", cohort_n=1_048_576, chunk=64,
                   resident_bytes=5_276_434_434, passes=2, ticks=64,
                   check=(0, 7))
STREAM_SERF = dict(n=2_097_152, budget="16GB", cohort_n=1_048_576, chunk=64,
                   resident_bytes=10_209_984_522, passes=1, ticks=16,
                   check=(1,))

# The observability plane (obs/): the node lens's sampled rows on the main
# path (normalize_ids(n, LENS_S)) and, for launch L against its plain
# version, those plus rows 1 and n - 1, over LENS_WINDOW ticks a state;
# the ticks of each run of the with / without the lens timing; the traced
# run (LENS_TRACE_IDS rows, LENS_TRACE_CHUNKS chunks of LENS_TRACE_CHUNK)
# and the debug bundle's profiled ticks, written under TRACE_DIR (removed
# after). The limit on a tick with the lens over one without.
LENS_S = 64
LENS_WINDOW = 32
LENS_TIMED_TICKS = 32
LENS_TICK_RATIO_MAX = 1.1
LENS_TRACE_IDS = 8
LENS_TRACE_CHUNKS = 4
LENS_TRACE_CHUNK = 32
PROFILE_TICKS = 8
TRACE_DIR = os.path.join("build", "trace_capture")

# The game day's slice (ROADMAP A10, A19). serf_reference_parity: the
# fused serf tick (B4) against the pre-fusion oracle from one seed, in
# tests/test_serf_fused.py:54-59's scenarios with origins scaled to n,
# each until every fired event covers every live node, within ORACLE_MAX
# ticks, read every ORACLE_CHUNK ticks; the fault scenario's link loss
# over ORACLE_FAULT ticks. snapshot_rejoin: the observed seat, SNAP_CHUNKS
# observed chunks, the ticks the cluster gets to notice the crash, the
# limit on the ticks to a full view. frontend_parity: NEAREST reads and
# writes through both paths. The game day at 1M, and the threaded front
# end's run at GAMEDAY_THREADED_N.
ORACLE_SEED = 3
ORACLE_MAX = 512
ORACLE_CHUNK = 32
ORACLE_FAULT = 32
SNAP_NODE = 10
SNAP_CHUNKS = 4
SNAP_CHUNK = 32
SNAP_NOTICE = 256
SNAP_LIMIT = 400
FRONTEND_READS = 256
FRONTEND_WRITES = 64
GAMEDAY_N = MAIN_N
GAMEDAY_THREADED_N = MAIN_N
SNAP_DIR = os.path.join("build", "snapshot_rejoin")
# The CLI phase's artifacts (removed after it) and its SIGTERM drill's
# length at 1M.
CLI_DIR = os.path.join("build", "cli_main_path")
CLI_DRILL_TICKS = 1024


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


# What launch_breakdown saw: sessions that recorded none of our kernels,
# with the device events they did record (the WAN line carries it).
PROFILE_MISSES = []


def launch_breakdown(fn, reps: int):
    """Device ms of each CUDA kernel that ``fn`` launches, by name: the
    mean over the launches the profiler recorded (its device events; a
    session can miss the first kernel launched in it), from one session of
    ``reps`` calls; "not measured" if it records none of our ``k_*``
    kernels (the session joins PROFILE_MISSES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count, seen = {}, {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        seen.append(ev.name.split("(")[0])
        if ev.name.startswith("k_"):
            us[ev.name] = us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            count[ev.name] = count.get(ev.name, 0) + 1
    if us:
        return {k: v / 1000.0 / count[k] for k, v in us.items()}
    PROFILE_MISSES.append({"device_events": len(seen),
                           "names": sorted(set(seen))[:8],
                           "reserved_bytes": torch.cuda.memory_reserved()})
    return "not measured"


# The WAN pool's launches (A, B, C), each of which its profile must time.
WAN_LAUNCHES = ("k_probe_send", "k_receive", "k_pushpull")


def wan_launch_profile() -> dict:
    """Device ms of each launch of the WAN pool's tick (n = 12, K = 11),
    profiled in a fresh child process: ``launch_timing.py --states wan``
    from this checkout, the mean of its two passes (ROADMAP K1: in a whole
    run the profiler in this process records no device event there); and
    the launch floor that child measures each pass (launch_timing.floor_ms:
    a one-element add), the yardstick of these launch-bound launches.
    Returns ``{"ms_by_launch": ..., "launch_floor_ms": ..., "passes": ...,
    "rc": ...}``."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "launch_timing.py", "--states",
                           "wan"], cwd=here, capture_output=True, text=True,
                          timeout=600)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    passes = [r for r in lines if "pass_" in r]
    got = [p["ms_by_launch"] for p in passes
           if isinstance(p.get("ms_by_launch"), dict)]
    ms = ({k: sum(g[k] for g in got if k in g) / sum(k in g for g in got)
           for k in sorted(set().union(*got))} if got else "not measured")
    floors = [r["launch_floor"]["ms"] for r in lines if "floor_pass" in r
              and isinstance(r["launch_floor"]["ms"], float)]
    return {"ms_by_launch": ms,
            "launch_floor_ms": floors or "not measured",
            "passes": len(passes), "rc": proc.returncode,
            "stderr_tail": proc.stderr[-400:] if proc.returncode else ""}


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


def _bits(x):
    """A tensor's elements as integers of its width (floats by their bits,
    so that NaN equals NaN)."""
    if x.is_floating_point():
        return x.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[x.element_size()])
    return x


def tree_diff(a, b, prefix=""):
    """Leaves of two state trees that differ in any bit."""
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(_bits(a), _bits(b)) else [prefix or "."]
    out = []
    for f, x, y in zip(a._fields, a, b):
        out += tree_diff(x, y, f"{prefix}.{f}" if prefix else f)
    return out


class ShardCheck:
    """The sharded call (B7) at each shard count of ``shards``, on
    ``["cuda:0"] * R``, beside a window's one-device kernel, under each
    grouping of GROUPINGS: the default (the shards of the one card in one
    group: one launch set a stage, no exchange) and one group per shard
    (the launches, exchanges, tally scratch and SLO fold of a mesh of one
    card per shard). From the window's start state, the same draw bundle
    each tick, B7's gathered state and summed counters bit-equal to the
    one-device kernel's on every tick; and for the first
    SHARD_PLAIN_TICKS ticks the sharded plain runner (one thread per shard
    on the card) against B7 under the default grouping, as compare_window
    holds the kernel to its plain version."""

    def __init__(self, tick, world, st, sched, shards, plain=True):
        from consul_tpu_torch.models import serf
        from consul_tpu_torch.ops import cuda_gossip
        from consul_tpu_torch.parallel import mesh as mesh_mod, shard_step

        cfg, topo = tick.cfg, tick.topo
        self.n, self.serf = cfg.n, isinstance(st, serf.SerfState)
        self.plain = plain
        self.runs = {}
        for r in shards:
            mesh = mesh_mod.make_mesh(["cuda:0"] * r)
            for grouping in GROUPINGS:
                k7 = cuda_gossip.ShardedTickKernel(
                    cfg, topo, mesh, serf_plane=tick.serf,
                    sentinel=tick.sentinel, groups=group_of(mesh, grouping))
                k7.set_world(world)
                with_plain = plain and grouping == "device"
                runner = (shard_step.make_sharded_chunk_runner(
                    cfg, topo, mesh, world, serf_plane=tick.serf,
                    sentinel=tick.sentinel, kernel="torch")
                    if with_plain else None)
                sb = (None if sched is None else shard_step.place_schedule(
                    mesh, sched, cfg.n, groups=k7.groups))
                blocks = shard_step.place(mesh, st, cfg.n, groups=k7.groups)
                key = str(r) if grouping == "device" else f"{r}/{grouping}"
                self.runs[key] = dict(
                    k7=k7, runner=runner, sched=sb, kb=blocks, pb=list(blocks),
                    bad=[], gaps={f: {"steps": 0, "abs": 0.0}
                                  for f in FLOAT_LEAVES},
                    launches=0, copies=0, groups=len(k7.groups))

    def step(self, t, d, kp, kc):
        from consul_tpu_torch.models import serf
        from consul_tpu_torch.parallel import shard_step

        dev = torch.device("cuda", 0)
        for key, run in self.runs.items():
            if run["bad"]:
                continue
            run["kb"], cv = run["k7"](run["kb"], d, run["sched"])
            whole = shard_step.gather(run["kb"], self.n, dev)
            cnt = sum(c.to(torch.int64) for c in cv)
            diff = tree_diff(kp, whole)
            if diff:
                run["bad"].append(f"tick {t}: B7 x{key} differs from the "
                                  f"one-device kernel in {diff[:4]}")
            if not torch.equal(cnt, kc.to(torch.int64)):
                run["bad"].append(f"tick {t}: B7 x{key} counters {cnt.tolist()} "
                                  f"!= {kc.tolist()}")
            if run["runner"] is not None and t < SHARD_PLAIN_TICKS:
                run["pb"], pc, _ = run["runner"].run(
                    run["pb"], lambda _t: d, 0, 1, run["sched"])
                pw = shard_step.gather(run["pb"], self.n, dev)
                if self.serf:
                    compare_packed(whole.swim, pw.swim, t, run["gaps"], run["bad"])
                    for name in serf.SerfState._fields[1:]:
                        if not torch.equal(getattr(whole, name), getattr(pw, name)):
                            run["bad"].append(f"tick {t} x{key} plain {name} differs")
                else:
                    compare_packed(whole, pw, t, run["gaps"], run["bad"])
                if not torch.equal(pc.to(torch.int64), cnt):
                    run["bad"].append(f"tick {t} x{key} plain counters "
                                      f"{pc.tolist()} != {cnt.tolist()}")
            run["launches"] = run["k7"].launches
            run["copies"] = run["k7"].copies

    def result(self):
        return {key: dict(mismatches=run["bad"][:5], float_gaps_plain=run["gaps"],
                          groups=run["groups"], b7_launches=run["launches"],
                          b7_copies=run["copies"],
                          plain_ticks=(SHARD_PLAIN_TICKS
                                       if run["runner"] is not None else 0))
                for key, run in self.runs.items()}

    def ok(self):
        return all(not run["bad"] for run in self.runs.values())


def compare_window(tick, plain, world, st, draw, ticks, sched=None,
                   shards=(), sharded=None, shard_plain=True):
    """Kernel vs plain version from one state with one draw bundle per
    tick (``draw()``): all 26 counters and every discrete packed leaf (and
    every serf leaf of a SerfState) equal on every tick, float leaves
    within MAX_STEPS / FLOOR_S. With ``shards`` a ShardCheck runs B7 at
    those shard counts beside the kernel and puts its result into the
    dict ``sharded`` ("ok" and "shards"). Returns (the plain side's last
    state, counter totals, mismatches, float gaps)."""
    from consul_tpu_torch.models import serf
    from consul_tpu_torch.models.counters import FIELDS

    serf_plane = isinstance(st, serf.SerfState)
    kp, pp = st, st
    totals = torch.zeros(len(FIELDS), dtype=torch.int64)
    bad = []
    gaps = {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
    check = ShardCheck(tick, world, st, sched, shards, shard_plain) if shards else None
    for t in range(ticks):
        d = draw()
        kp, kc = tick(world, kp, d, sched)
        pp, pc = plain(world, pp, d, sched)
        if check is not None:
            check.step(t, d, kp, kc)
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
    if check is not None:
        sharded.update(ok=check.ok() and not bad, shards=check.result())
    return pp, totals, bad, gaps


def parity(n: int, packet_loss: float, ticks: int, seed: int, shards=()):
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

    sharded = {}
    _, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, _: cuda_gossip.plain_tick(cfg, topo, w, s, d),
        world, st, lambda: swim.draw_tick(cfg, gen, dev), ticks,
        shards=shards, sharded=sharded)
    fired = {f: int(totals[FIELDS.index(f)]) for f in (
        "suspicions_started", "deaths_declared", "refutations",
        "probe_timeouts", "pushpull_merges")}
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, ticks=ticks,
                warm=warm, mismatches=bad[:5], float_gaps=gaps,
                counters_in_window=fired, sharded=sharded)


def serf_parity(n: int, packet_loss: float, relay: int, ticks: int, seed: int,
                shards=()):
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

    sharded = {}
    pp, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, _: cuda_gossip.plain_serf_tick(cfg, topo, w, s, d),
        world, st, lambda: serf.draw_serf_tick(cfg, gen, dev), ticks,
        shards=shards, sharded=sharded)
    window = {f: int(totals[FIELDS.index(f)]) for f in (
        "serf_intents_queued", "serf_intents_retx", "serf_intents_dropped",
        "deaths_declared")}
    window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, relay_factor=relay,
                ticks=ticks, warm=warm, mismatches=bad[:5], float_gaps=gaps,
                in_window=window, sharded=sharded)


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
                 family: str = "all", shards=()):
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
    sharded = {}
    _, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, sc: cuda_gossip.plain_tick(cfg, topo, w, s, d, sc,
                                                         sentinel=True),
        world, st, lambda: swim.draw_tick(cfg, gen, dev, chaos=True), ticks,
        sched, shards=shards, sharded=sharded)
    window = {f: int(totals[FIELDS.index(f)]) for f in FIELDS
              if f.startswith(("chaos_", "sentinel_")) or f in (
                  "deaths_declared", "refutations", "suspicions_started")}
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, ticks=ticks,
                family=family, warm=warm, mismatches=bad[:5], float_gaps=gaps,
                in_window=window, sharded=sharded)


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


def wide_events(chaos, n):
    """A timeline past one mask word a row: 20 partitions, 20 lossy
    links, 34 churn waves and 3 degraded blocks (97 mask bits), their
    windows opening and closing within 32 ticks."""
    return ([chaos.Partition(1 + i % 5, 9 + i % 7, slice(i * 7, n // 2))
             for i in range(20)]
            + [chaos.LinkLoss(i % 4, 10 + i % 3, slice(0, n // 4 + i),
                              slice(n // 4, n // 2 - i), fwd=0.1 * (i % 9),
                              rev=0.05 * (i % 5)) for i in range(20)]
            + [chaos.ChurnWave(i % 6, 12 + i % 5,
                               slice(n // 2 + 64 * i, n // 2 + 64 * i + 512),
                               period=3 + i % 4, down_ticks=1 + i % 2)
               for i in range(34)]
            + [chaos.Degrade(1, 20, slice(n - n // 8, n), tx_loss=0.4),
               chaos.Degrade(2, 24, slice(n - n // 4, n), tx_loss=0.3,
                             rx_loss=0.2),
               chaos.Degrade(3, 30, slice(n - n // 4, n), tx_loss=0.7,
                             rx_loss=0.1)])


def p_parity(name: str, n: int, timeline: str, form: int, window: int,
             seed: int):
    """Launch P alone (TickKernel.chaos_pre, and ShardedTickKernel's at
    P_SHARDS shards in one device group and in a group per shard) against
    cuda_gossip.plain_chaos_pre on every tick of a window under the
    ``timeline`` schedule: the word and the record bit-equal on every
    tick. The window's state advances through the one-device kernel (and
    each B7 run through its own tick); the churn edges counted from the
    plain side, both ways, must be nonzero, and the schedule's masks must
    have been packed once for each run's placement."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import layout, state as sim_state, swim
    from consul_tpu_torch.ops import cuda_gossip, topology
    from consul_tpu_torch.parallel import mesh as mesh_mod, shard_step

    dev = torch.device("cuda")
    cfg = SimConfig(n=n, view_degree=32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack(sim_state.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo)
    for _ in range(form):
        st, _ = tick(world, st, swim.draw_tick(cfg, gen, dev))
    events = (chaos_main_events(chaos, n) if timeline == "composed"
              else wide_events(chaos, n))
    sched = chaos.shift_schedule(chaos.compile_schedule(n, events, dev),
                                 int(st.t))
    packs0 = cuda_gossip.MASK_CACHE.packs
    mesh = mesh_mod.make_mesh(["cuda:0"] * P_SHARDS)
    runs = {}
    for grouping in GROUPINGS:
        k7 = cuda_gossip.ShardedTickKernel(cfg, topo, mesh,
                                           groups=group_of(mesh, grouping))
        k7.set_world(world)
        runs[grouping] = dict(
            k7=k7, blocks=shard_step.place(mesh, st, n, groups=k7.groups),
            sched=shard_step.place_schedule(mesh, sched, n, groups=k7.groups),
            bad=[])
    bad, kills, revives = [], 0, 0
    t0 = int(st.t)
    for k in range(window):
        d = swim.draw_tick(cfg, gen, dev, chaos=True)
        pw, pr = cuda_gossip.plain_chaos_pre(st, sched, t0 + k)
        word, rec = tick.chaos_pre(world, st, d, sched)
        if not (torch.equal(word, pw) and torch.equal(rec, pr)):
            bad.append(k)
        for run in runs.values():
            parts = run["k7"].chaos_pre(run["blocks"], d, run["sched"])
            if not (torch.equal(torch.cat([w for w, _ in parts]), pw)
                    and torch.equal(torch.cat([r for _, r in parts]), pr)):
                run["bad"].append(k)
            run["blocks"], _ = run["k7"](run["blocks"], d, run["sched"])
        up = (st.flags.to(torch.int32) & 1) == 1
        kills += int((up & ((pw & 1) == 0)).sum())
        revives += int(((pw & 0x80) != 0).sum())
        st, _ = tick(world, st, d, sched)
    torch.cuda.synchronize()
    packs = cuda_gossip.MASK_CACHE.packs - packs0
    res = dict(name=name, n=n, timeline=timeline, ticks=window,
               mask_words=cuda_gossip.mask_words(sched), mismatch_ticks=bad[:8],
               kill_edges=kills, revive_edges=revives, mask_packs=packs,
               sharded={g: dict(groups=len(r["k7"].groups),
                                mismatch_ticks=r["bad"][:8])
                        for g, r in runs.items()})
    # One pack for the one-device schedule, one for each group's rows of
    # each placement (a placed schedule is a copy).
    want_packs = 1 + sum(len(r["k7"].groups) for r in runs.values())
    res["ok"] = (not bad and all(not r["bad"] for r in runs.values())
                 and kills > 0 and revives > 0 and packs == want_packs)
    return res


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
                  if k not in ("serf_post", "metrics", "lens") + B8_STAGES)
          and launches["metrics"] > 0
          and res.slo["fault_ticks"] > 0 and res.slo["messages_dropped"] > 0)
    sched = chaos.shift_schedule(
        chaos.compile_schedule(n, events, sim.device), t_window)
    return sim, snap["state"], sched, out, ok


def serf_chaos_parity(n: int, packet_loss: float, relay: int, ticks: int,
                      fault: int, seed: int, shards=()):
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
    sharded = {}
    pp, totals, bad, gaps = compare_window(
        tick, lambda w, s, d, sc: cuda_gossip.plain_serf_tick(
            cfg, topo, w, s, d, sc, sentinel=True),
        world, st, lambda: serf.draw_serf_tick(cfg, gen, dev, chaos=True),
        ticks, sched, shards=shards, sharded=sharded)
    window = {f: int(totals[FIELDS.index(f)]) for f in FIELDS
              if f.startswith(("chaos_", "sentinel_", "serf_")) or f in (
                  "deaths_declared", "refutations", "suspicions_started")}
    window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
    return dict(n=n, k=cfg.degree, packet_loss=packet_loss, relay_factor=relay,
                ticks=ticks, fault_ticks=fault, mismatches=bad[:5],
                float_gaps=gaps, in_window=window, sharded=sharded)


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


def dense_parity(name: str, serf_plane: bool, chaos_on: bool, seed: int, rate,
                 shards=()):
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

    sharded = {}
    pp, totals, bad, gaps = compare_window(
        tick, plain, world, st, lambda: draw(sched is not None), DENSE_TICKS,
        sched, shards=shards, sharded=sharded)
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
                ok=ok, sharded=sharded), timing


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
                    seed: int, shards=(), shard_plain=True):
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

    sharded = {}
    _, totals, bad, gaps = compare_window(
        tick, plain, world, st, lambda: draw(sched is not None), TIE_TICKS,
        sched, shards=shards, sharded=sharded, shard_plain=shard_plain)
    from consul_tpu_torch.models.counters import FIELDS
    window = {f: int(totals[FIELDS.index(f)]) for f in (
        "probes_sent", "gossip_msgs_tx", "chaos_msgs_dropped")}
    bit_equal = all(g["abs"] == 0.0 and g["steps"] == 0 for g in gaps.values())
    return dict(variant=name, n=n, k=cfg.degree, ticks=TIE_TICKS,
                wrapped_rows=wrapped[0], mismatches=bad[:5], float_gaps=gaps,
                in_window=window, sharded=sharded,
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


def b8_parity(name: str, n: int, stimulus: str, chaos_on: bool, seed: int,
              relay: int = 0, loss: float = 0.0, ticks: int = B8_TICKS):
    """B8 against plain_reference_serf_tick from one state with one
    ReferenceSerfDraws per tick (compare_window), over ``ticks`` ticks
    from a state formed through B8 for 32 ticks (n = DENSE_N: the dense
    view; else K = 32). ``stimulus``: "quiet" fires 3 events and opens a
    query (and a leave) at the window's start; "stress" is
    stress_events' storm (bucket takeovers, full buckets, one key from
    many origins, queue evictions, a relayed query); "tie_wrap" also puts
    the SWIM plane through tie_and_wrap with perm_u cut to multiples of
    1/16. ``chaos_on``: a link-loss schedule (dense_events on the dense
    view) with the sentinel. Passes only if every packed and serf leaf
    and all 26 counters are equal on every tick, every float leaf bit for
    bit, and the serf plane moved (events queued, sent and delivered;
    under a schedule legs dropped)."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import GossipConfig, SerfConfig, SimConfig
    from consul_tpu_torch.models import layout, serf
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip, topology

    dev = torch.device("cuda")
    dense = n == DENSE_N
    gossip = (GossipConfig(suspicion_mult=1, suspicion_max_timeout_mult=2)
              if chaos_on else GossipConfig())
    cfg = SimConfig(n=n, view_degree=0 if dense else 32, packet_loss=loss,
                    gossip=gossip, serf=SerfConfig(query_relay_factor=relay))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ev_gen = torch.Generator(device=dev)
    ev_gen.manual_seed(seed + 1)
    world = topology.make_world(cfg, gen, dev)
    topo = topology.make_topology(cfg, gen, dev)
    st = layout.pack_state(serf.init(cfg, gen, dev))
    tick = cuda_gossip.make_tick_kernel(cfg, topo, variant="serf_reference",
                                        sentinel=chaos_on)

    def plain(w, s, d, sc):
        return cuda_gossip.plain_reference_serf_tick(cfg, topo, w, s, d, sc,
                                                     sentinel=chaos_on)

    def draw(sched_on):
        d = serf.draw_reference_tick(cfg, gen, ev_gen, dev, chaos=sched_on)
        if stimulus == "tie_wrap":
            d = d._replace(swim=d.swim._replace(
                perm_u=torch.floor(d.swim.perm_u * 16.0) / 16.0))
        return d

    for _ in range(32):
        st, _ = tick(world, st, draw(False))
    q_row, q_slot, leaver = None, None, 3 * n // 4 + 11
    if stimulus == "stress":
        st, q_row, q_slot = stress_events(cfg, st)
    else:
        q_row = n // 8 + 101 if not dense else n // 8 + 5
        origins = [n // 8, 97 * n // 4096 + 1, n - 1]
        dn = layout.unpack_state(st)
        for j, row in enumerate(origins):
            dn = serf.user_event(cfg, dn, _rows(n, [row], dev), 11 + j)
        dn = serf.query(cfg, dn, _rows(n, [q_row], dev), 3)
        q_slot = serf.newest_query_slot(dn, q_row)
        dn = serf.leave(cfg, dn, _rows(n, [leaver], dev))
        st = layout.pack_state(dn)
    if stimulus == "tie_wrap":
        st = st._replace(swim=tie_and_wrap(st.swim, cfg.degree))
    sched = None
    if chaos_on:
        events = (dense_events(chaos, n) if dense else [chaos.LinkLoss(
            0, ticks, a=slice(0, n // 8), b=slice(n // 2, n), fwd=0.5,
            rev=0.5)])
        sched = chaos.shift_schedule(chaos.compile_schedule(n, events, dev),
                                     int(layout.tick_of(st)))
    pp, totals, bad, gaps = compare_window(
        tick, plain, world, st, lambda: draw(sched is not None), ticks, sched)
    window = {f: int(totals[FIELDS.index(f)]) for f in FIELDS
              if f.startswith(("serf_", "sentinel_")) or f in (
                  "chaos_msgs_dropped", "deaths_declared", "probes_sent")}
    window.update(serf_in_window(st, pp, q_row, q_slot, leaver))
    need = ["serf_intents_queued", "serf_intents_retx", "delivered",
            "query_acks"] + (["chaos_msgs_dropped"] if chaos_on else [])
    bit_equal = all(g["abs"] == 0.0 and g["steps"] == 0 for g in gaps.values())
    return dict(window=name, n=n, k=cfg.degree, stimulus=stimulus,
                chaos=chaos_on, sentinel=chaos_on, relay_factor=relay,
                packet_loss=loss, ticks=ticks, mismatches=bad[:5],
                float_gaps=gaps, in_window=window, bit_equal=bit_equal,
                ok=not bad and bit_equal and all(window[f] > 0 for f in need)
                and window.get("sentinel_monotonic", 0) == 0,
                _state=(cfg, topo, world, pp, sched, tick, plain, draw))


def b8_timing(res, rate):
    """B8 timed (time_kernel) on a b8_parity window's last state, under
    its schedule; the bound is the tick's state contract plus the sweep's
    payload, written by E1 and read by E2."""
    from consul_tpu_torch.ops import cuda_gossip

    cfg, topo, world, pp, sched, tick, plain, draw = res["_state"]
    contract = (cuda_gossip.tick_hbm_bytes_per_node(pp, world, sched)
                + cuda_gossip.sweep_payload_bytes_per_node(cfg))
    return time_kernel(tick, lambda w, s, d: plain(w, s, d, sched), world, pp,
                       draw(sched is not None), contract, cfg.n, rate,
                       sched=sched)


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


def metrics_timing(cfg, topo, world, packed, rate, seed):
    """Launch M on one packed state with METRIC_PAIRS pairs: "ms", the
    kernel's own device time (profiler; None when it records none);
    "ms_events", CUDA events around back-to-back calls, the wrapper's host
    work included; its plain version's ms; and the bound, metrics_hbm_bytes
    over the card's memory rate."""
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.utils import metrics

    mk = cuda_gossip.make_metrics_kernel(cfg, topo)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    i, j = metrics.rmse_samples(cfg, gen, METRIC_PAIRS, "cuda")
    out = torch.empty(4, device="cuda")

    def call():
        return mk(world, packed, i, j, out)
    prof = launch_breakdown(call, 20)
    res = {"ms_events": cuda_ms(call, 50),
           "plain_ms": cuda_ms(lambda: cuda_gossip.plain_metrics(
               cfg, topo, world, packed, i, j), 5),
           "bytes": cuda_gossip.metrics_hbm_bytes(packed, world, METRIC_PAIRS)}
    dev = prof if isinstance(prof, dict) else {}
    res["ms"] = next((v for k, v in dev.items() if k.startswith("k_metrics")),
                     None)
    res["bound_ms"] = res["bytes"] / rate * 1e3
    return res


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


def op_breakdown(fn):
    """Device ms of one call of ``fn`` by PyTorch op (each kernel's time
    under the innermost ``aten::`` op that launched it, from the
    profiler), largest first; "not measured" if it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if ev.key.startswith("aten::") and us:
            out[ev.key] = out.get(ev.key, 0.0) + us / 1000.0
    return dict(sorted(out.items(), key=lambda kv: -kv[1])) or "not measured"


def _host_copy(snap):
    from consul_tpu_torch.ops import serving

    return serving.Snapshot(*[x.cpu() for x in snap[:6]], snap.tick.cpu())


def _ids(results):
    return [[node for node, _ in r.nodes] for r in results]


def serving_parity_reads(cfg):
    """serving_parity (a) and (b). (a) On a fresh Simulation (tick 0, every
    distance equal) NEAREST from 64 sources answers ids 0..7; after killing
    rows 0..n/20-1, the 8 lowest live ids. (b) After SERVING_CHUNK more
    ticks, SERVING_QUERIES queries of each mode (half with a service
    filter) through ``ops/serving.execute`` on the card and on the CPU over
    the same snapshot copied to the host: ids, counts and tick equal, rtts
    within SERVING_RTOL relative, once every NEAREST row's k-th and
    (k+1)-th distances (a CPU run at k + 1) are more than SERVING_RTOL
    apart."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import serving
    from consul_tpu_torch.serving import ServingPlane

    t0 = time.perf_counter()
    n, k = cfg.n, SERVING_K
    sim = cluster.Simulation(cfg, seed=0)
    plane = ServingPlane(k=k, buckets=(SERVING_QUERIES,),
                         num_services=MIXED_SERVICES)
    sim.attach_serving(plane)
    rng = random.Random(1)
    srcs = [rng.randrange(n) for _ in range(SERVING_QUERIES)]
    dead = n // 20
    fresh = _ids(plane.nearest_many(srcs))
    sim.kill(torch.arange(n) < dead)
    killed = _ids(plane.nearest_many(srcs))
    tie_ok = (all(ids == list(range(k)) for ids in fresh)
              and all(ids == list(range(dead, dead + k)) for ids in killed))

    sim.run(SERVING_CHUNK, chunk=SERVING_CHUNK, with_metrics=False)
    snap = plane.snapshot()
    modes = (serving.MODE_NEAREST, serving.MODE_DIST, serving.MODE_CATALOG,
             serving.MODE_HEALTH, serving.MODE_NOOP)
    q = []
    for m in modes:
        for j in range(SERVING_QUERIES):
            if m == serving.MODE_DIST:
                arg = rng.randrange(n)
            else:
                arg = -1 if j % 2 == 0 else rng.randrange(MIXED_SERVICES)
            q.append((m, rng.randrange(n), arg))
    q = torch.tensor(q, dtype=torch.int32).t().contiguous()
    card = [x.cpu() for x in serving.execute(k, snap, *q.cuda())[:3]]
    host_snap = _host_copy(snap)
    host = serving.execute(k, host_snap, *q)
    near = q[0] == serving.MODE_NEAREST
    wide = serving.execute(k + 1, host_snap, *(x[near] for x in q))
    full = wide[2] > k
    r_k, r_k1 = wide[1][full, k - 1], wide[1][full, k]
    gap = ((r_k1 - r_k) / r_k).min().item() if bool(full.any()) else None
    gap_ok = gap is not None and gap > SERVING_RTOL
    inf_ok = torch.equal(torch.isinf(card[1]), torch.isinf(host[1]))
    fin = torch.isfinite(host[1])
    rel = ((card[1][fin] - host[1][fin]).abs() / host[1][fin].abs()).max().item()
    read_ok = (torch.equal(card[0], host[0]) and torch.equal(card[2], host[2])
               and int(snap.tick) == int(host[3]) and inf_ok
               and rel <= SERVING_RTOL)
    res = dict(part="ab", n=n, k=k, tie_sources=len(srcs),
               tie_fresh_ok=all(ids == list(range(k)) for ids in fresh),
               tie_killed_first=killed[0], tick=int(snap.tick),
               queries=int(q.shape[1]), nearest_rows_full=int(full.sum()),
               min_gap_rel_k_k1=gap, ids_equal=torch.equal(card[0], host[0]),
               counts_equal=torch.equal(card[2], host[2]),
               rtt_max_rel_err=rel, rtol=SERVING_RTOL,
               counts_by_mode={str(m): int(host[2][q[0] == m].sum())
                               for m in modes},
               seconds=round(time.perf_counter() - t0, 3))
    res["ok"] = tie_ok and gap_ok and read_ok
    return res


def serving_phase(cfg, rate):
    """The bench's serving phase (bench.py:750-785) through the entry
    points: one SERVING_CHUNK-tick chunk on a fresh Simulation, a
    ServingPlane(k=8, buckets=(1024,)) attached, a warm batch, then
    SERVING_REPS timed batches of 1,024 NEAREST queries from
    random.Random(0) sources. Reports q/s, p50/p99 batch ms, padding waste,
    the peak of one batch's temporaries, and the batch's bytes bound (the
    snapshot read once) at the card's memory rate."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import serving
    from consul_tpu_torch.serving import MODE_NEAREST, ServingPlane

    n = cfg.n
    t0 = time.perf_counter()
    qsim = cluster.Simulation(cfg, seed=0)
    qsim.run(SERVING_CHUNK, chunk=SERVING_CHUNK, with_metrics=False)
    plane = ServingPlane(k=SERVING_K, buckets=(SERVING_BATCH,))
    qsim.attach_serving(plane)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    srng = random.Random(0)

    def batch():
        return [(MODE_NEAREST, srng.randrange(n), -1)
                for _ in range(SERVING_BATCH)]

    t_warm = time.perf_counter()
    plane.batcher.execute(batch())
    warm_s = time.perf_counter() - t_warm
    plane.batcher.latencies_s.clear()
    batches0 = plane.batcher.batches
    t1 = time.perf_counter()
    for _ in range(SERVING_REPS):
        plane.batcher.execute(batch())
    wall = time.perf_counter() - t1
    st = plane.stats()
    one = batch()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plane.batcher.execute(one)
    peak = torch.cuda.max_memory_allocated() - base
    by_op = op_breakdown(lambda: plane.batcher.execute(batch()))
    snap = plane.snapshot()
    nbytes = serving.snapshot_bytes(snap)
    res = dict(n=n, batch=SERVING_BATCH, k=SERVING_K,
               queries=SERVING_REPS * SERVING_BATCH,
               queries_per_sec=SERVING_REPS * SERVING_BATCH / wall,
               wall_s=wall, warm_s=warm_s, setup_s=setup_s,
               p50_batch_ms=st["p50_batch_ms"], p99_batch_ms=st["p99_batch_ms"],
               padding_waste_pct=st["padding_waste_pct"],
               block_rows=serving.block_rows(n, snap.vec.shape[1],
                                             SERVING_BATCH),
               peak_temp_bytes=peak, temp_budget_bytes=serving.TEMP_BUDGET_BYTES,
               bound_bytes=nbytes, bound_ms=nbytes / rate * 1e3,
               bound_by="bytes", tick=int(snap.tick), device_ms_by_op=by_op)
    res["ok"] = (st["batches"] - batches0 == SERVING_REPS and peak <= (4 << 30)
                 and int(snap.tick) == SERVING_CHUNK)
    return qsim, res


def serving_mixed_phase(qsim):
    """run_mixed at the bench's configuration (bench.py:795-805) on the
    serving phase's Simulation. It records, on the host only (so the
    timed flips allocate nothing for the check), every write batch
    applied, the host frame of every flip with the number of batches
    applied before it, each flip's host time, the card memory the
    allocator reserved during it, and the pauses of Python's cyclic
    garbage collector (all, and those inside each flip). Then
    serving_parity (c): the write state equals apply_writes_reference
    replayed on the host over those batches, field by field, and each
    frame equals diff_snapshots_reference on the flip's two write states
    (that replay, cut at the flip) and the snapshot's live mask, which
    the mix leaves unchanged (it runs no tick)."""
    from types import SimpleNamespace

    from consul_tpu_torch.ops import deltas
    from consul_tpu_torch.serving import ServingPlane
    from consul_tpu_torch.serving.mixed import run_mixed

    t0 = time.perf_counter()
    plane = ServingPlane(k=SERVING_K, buckets=(SERVING_BATCH,),
                         num_services=MIXED_SERVICES)
    qsim.attach_serving(plane, writes=True, kv_slots=MIXED_KV_SLOTS)
    ws0 = deltas.WriteState(*[x.cpu().numpy() for x in plane.write_state])
    snap0 = plane.snapshot()
    live = SimpleNamespace(live=snap0.live.cpu().numpy(), tick=int(snap0.tick))
    batches, flips, pauses, gc_t0 = [], [], [], [0.0]
    real_execute, real_on_flip = plane.writes.execute, plane.watch.on_flip

    def execute(ops):
        batches.append(list(ops))
        return real_execute(ops)

    def on_flip(prev, cur):
        n0, r0, t = len(pauses), torch.cuda.memory_reserved(), time.perf_counter()
        real_on_flip(prev, cur)
        flips.append(dict(
            s=time.perf_counter() - t, batches=len(batches),
            frame=plane.watch.last_frame,
            gc_s=sum(p for _, p in pauses[n0:]),
            grew=torch.cuda.memory_reserved() - r0))

    def gc_pause(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - gc_t0[0]))

    plane.writes.execute, plane.watch.on_flip = execute, on_flip
    gc.callbacks.append(gc_pause)
    try:
        mixed = run_mixed(qsim, plane, ratio="90:9:1", rounds=MIXED_ROUNDS,
                          read_batch=SERVING_BATCH, watchers=MIXED_WATCHERS,
                          seed=0)
    finally:
        gc.callbacks.remove(gc_pause)
    torch.cuda.synchronize()
    mixed["setup_and_run_s"] = time.perf_counter() - t0
    slowest = max(flips, key=lambda f: f["s"])
    mixed["flip_host"] = dict(
        ms=[f["s"] * 1e3 for f in flips],
        reserved_growth_bytes=[f["grew"] for f in flips],
        gc_ms_inside=[f["gc_s"] * 1e3 for f in flips],
        slowest_ms=slowest["s"] * 1e3, gc_pauses=len(pauses),
        gc_gen2=sum(g == 2 for g, _ in pauses),
        gc_max_pause_ms=max((p for _, p in pauses), default=0.0) * 1e3)

    t1 = time.perf_counter()
    states = [ws0]
    for ops in batches:
        states.append(deltas.apply_writes_reference(
            states[-1],
            deltas.WriteBatch(*torch.tensor(ops, dtype=torch.int32).t()))[0])
    fields_differ = [f for f, a, b in zip(deltas.WriteState._fields,
                                          plane.write_state, states[-1])
                     if not (a.cpu().numpy() == b).all()]
    frames_differ, before = [], 0
    for i, f in enumerate(flips):
        want = deltas.diff_snapshots_reference(
            plane.watch.k, live, states[before], live, states[f["batches"]])
        if not all((a == b).all() for a, b in zip(f["frame"], want)):
            frames_differ.append(i)
        before = f["batches"]
    changes = [int(f["frame"].n_node_changes) for f in flips]
    check = dict(part="c", write_batches=len(batches),
                 writes=sum(len(b) for b in batches),
                 apply_index=int(plane.write_state.apply_index),
                 state_fields_differing=fields_differ, flips=len(flips),
                 frames_differing=frames_differ,
                 node_changes_per_flip=changes,
                 kv_changes_per_flip=[int(f["frame"].n_kv_changes)
                                      for f in flips],
                 seconds=round(time.perf_counter() - t1, 3))
    check["ok"] = (not fields_differ and not frames_differ
                   and len(flips) == MIXED_ROUNDS + 1 and len(batches) > 0
                   and check["apply_index"] > 0 and sum(changes) > 0
                   and plane.tick == live.tick)
    mixed["ok"] = (mixed["read"]["count"] == MIXED_ROUNDS * SERVING_BATCH
                   and mixed["watch"]["deliveries"] > 0)
    plane.close()
    return mixed, check


def serving_trajectory(cfg):
    """serving_parity (d): SERVING_CHUNK ticks from one seed with a
    write-attached plane (writes and reads between the chunks) and without
    one end on bit-equal packed leaves and generator states."""
    from consul_tpu_torch.models import cluster, layout
    from consul_tpu_torch.ops import deltas
    from consul_tpu_torch.serving import ServingPlane

    t0 = time.perf_counter()
    sims = []
    for attach in (False, True):
        sim = cluster.Simulation(cfg, seed=2)
        if attach:
            plane = ServingPlane(k=SERVING_K, buckets=(SERVING_QUERIES,),
                                 num_services=MIXED_SERVICES)
            sim.attach_serving(plane, writes=True, kv_slots=MIXED_KV_SLOTS)
        for c in range(2):
            if attach:
                slot = plane.keys.slot_for(f"t/{c}", create=True)
                plane.writes.execute([(deltas.OP_REGISTER, 5 + c, 3),
                                      (deltas.OP_KV_PUT, slot, 7 + c)])
                plane.nearest_many(range(SERVING_QUERIES))
            sim.run(SERVING_CHUNK // 2, chunk=SERVING_CHUNK // 2,
                    with_metrics=False)
        torch.cuda.synchronize()
        sims.append(sim)
    a, b = sims
    leaves = list(zip(layout.leaves(a.state), layout.leaves(b.state)))
    differ = [i for i, (x, y) in enumerate(leaves)
              if not torch.equal(_leaf_bits(x), _leaf_bits(y))]
    gen_equal = bool(a.gen.get_state().equal(b.gen.get_state()))
    res = dict(part="d", n=cfg.n, ticks=SERVING_CHUNK, leaves=len(leaves),
               leaves_differing=differ, generator_equal=gen_equal,
               flips=plane.watch.flips, apply_index=plane.apply_index,
               t=(a._t, b._t), seconds=round(time.perf_counter() - t0, 3))
    res["ok"] = (not differ and gen_equal and a._t == b._t == SERVING_CHUNK
                 and plane.apply_index > 0)
    return res


def _rows(n, rows, dev):
    m = torch.zeros(n, dtype=torch.bool, device=dev)
    m[rows] = True
    return m


def time_kernel(tick, plain, world, st, d, bytes_per_node, n, rate, sched=None,
                profile=True):
    """Device ms per tick of the kernel and of its plain version (CUDA
    events), ms by launch (profiler; None with ``profile=False``), the
    tick's bytes bound and each launch's
    (cuda_gossip.launch_hbm_bytes_per_node on this tick's inputs and
    output)."""
    from consul_tpu_torch.ops import cuda_gossip

    ms = cuda_ms(lambda: tick(world, st, d, sched), 20)
    plain_ms = cuda_ms(lambda: plain(world, st, d), 3)
    stages = (launch_breakdown(lambda: tick(world, st, d, sched), 5)
              if profile else None)
    bound_ms = bytes_per_node * n / rate * 1e3
    buffers = tick.buffer_bytes_per_node(world, st, d, sched)
    out, _ = tick(world, st, d, sched)
    ran = [k for k, _ in tick._stages(sched)]
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
          and all(v > 0 for k, v in launches.items()
                  if k not in ("lens",) + B8_STAGES)
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


def raft_events(chaos):
    """raft_parity's schedule: the leaders of every group killed, a 2|3
    cut of every group, then a storm on every group."""
    return [chaos.RaftKill(start=48, stop=80, group=-1, peer=-1),
            chaos.RaftPartition(start=112, stop=160, cut=2, group=-1),
            chaos.RaftStorm(start=192, stop=224, group=-1)]


def raft_parity(cfg, groups, peers, seed, twin):
    """The raft tier on the card against the CPU: RAFT_PARITY_TICKS ticks
    of a 1M Simulation with set_raft(groups, peers) under raft_events,
    proposals at two chunk boundaries; then raft_ops.tick replayed on the
    CPU from the card's draw tensors (recorded as the ticks ran) and the
    same schedule. Every RaftState field and the cumulative RaftCounters
    equal at every chunk boundary; chaos_masks on the card equal
    chaos_masks_reference at every tick. With ``twin``, a second
    Simulation without raft under the same schedule runs first: at tick
    RAFT_TRAJECTORY_TICKS the packed leaves and generators of both are
    bit-equal, and the bare kernel's chaos variant (the raft-only
    schedule: zero slots in every node family) is held against plain_tick
    over RAFT_GOSSIP_WINDOW ticks from the twin's state."""
    import numpy as np

    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster, layout, swim
    from consul_tpu_torch.ops import cuda_gossip, raft_ops

    t0 = time.perf_counter()
    events = raft_events(chaos)
    res = dict(groups=groups, peers=peers, window=RAFT_WINDOW, n=cfg.n,
               ticks=RAFT_PARITY_TICKS, chunk=RAFT_PARITY_CHUNK)
    if twin:
        other = cluster.Simulation(cfg, seed=seed)
        other.set_chaos(events)
        other.run(RAFT_TRAJECTORY_TICKS, chunk=RAFT_PARITY_CHUNK,
                  with_metrics=False)
    sim = cluster.Simulation(cfg, seed=seed)
    plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
    sim.set_chaos(events)
    timers = plane.state.timer.cpu()
    own, draws = plane.draws, []

    def record(t):
        d = own(t)
        draws.append(d)
        return d
    plane.draws = record
    snaps = []
    for c in range(RAFT_PARITY_TICKS // RAFT_PARITY_CHUNK):
        for g in range(groups):
            if c in RAFT_PARITY_PROPOSALS:
                plane.propose([(0, 0, 0)] * RAFT_PARITY_PROPOSALS[c], group=g)
        sim.run(RAFT_PARITY_CHUNK, chunk=RAFT_PARITY_CHUNK, with_metrics=False)
        snaps.append(([x.cpu() for x in plane.state],
                      plane.counters_snapshot()))
        if twin and sim._t == RAFT_TRAJECTORY_TICKS:
            pairs = list(zip(layout.leaves(sim.state),
                             layout.leaves(other.state)))
            res["trajectory"] = dict(
                ticks=sim._t, leaves=len(pairs),
                leaves_differing=[i for i, (a, b) in enumerate(pairs)
                                  if not torch.equal(_leaf_bits(a),
                                                     _leaf_bits(b))],
                generator_equal=bool(sim.gen.get_state().equal(
                    other.gen.get_state())))
    torch.cuda.synchronize()
    res["card_s"] = round(time.perf_counter() - t0, 3)
    res["summary"] = plane.summary()
    res["counters"] = plane.counters_snapshot()
    res["inflight"] = plane.inflight

    rcfg = plane.rcfg
    sched = chaos.compile_schedule(cfg.n, events)
    gids = np.arange(groups)
    gids_dev = torch.arange(groups, dtype=torch.int32, device=sim.device)
    rst = raft_ops.init(rcfg, timers)
    total = torch.zeros(len(raft_ops.FIELDS), dtype=torch.int64)
    bad, mask_bad = [], []
    for t in range(RAFT_PARITY_TICKS):
        c = t // RAFT_PARITY_CHUNK
        if t % RAFT_PARITY_CHUNK == 0 and c in RAFT_PARITY_PROPOSALS:
            rst = rst._replace(next_seq=rst.next_seq
                               + RAFT_PARITY_PROPOSALS[c])
        want = raft_ops.chaos_masks_reference(events, t, rst.role.numpy(),
                                              gids)
        got = raft_ops.chaos_masks(sim.chaos, t, rst.role.to(sim.device),
                                   gids_dev)
        if not all(np.array_equal(g.cpu().numpy(), w)
                   for g, w in zip(got, want)):
            mask_bad.append(t)
        rst, rc = raft_ops.tick(rcfg, rst, t, draws[t].cpu(), sched)
        total += raft_ops.counters_stack(rc)
        if (t + 1) % RAFT_PARITY_CHUNK == 0:
            card, cnt = snaps[c]
            bad += [f"tick {t + 1} {f}" for f, a, b in zip(
                raft_ops.RaftState._fields, card, rst)
                if not (a.dtype == b.dtype and torch.equal(a, b))]
            if cnt != dict(zip(raft_ops.FIELDS, total.tolist())):
                bad.append(f"tick {t + 1} counters {cnt} != {total.tolist()}")
    res.update(mismatches=bad[:20], mask_mismatch_ticks=mask_bad[:20],
               seconds_cpu_replay=round(time.perf_counter() - t0
                                        - res["card_s"], 3))
    s = res["summary"]
    res["ok"] = (not bad and not mask_bad and res["inflight"] == 0
                 and all(x >= 0 for x in s["leaders"])
                 and s["committed_clients"] == [sum(
                     RAFT_PARITY_PROPOSALS.values())] * groups
                 and res["counters"]["elections_won"] > groups
                 and res["counters"]["term_changes"] > 0)
    if twin:
        tr = res["trajectory"]
        tick = cuda_gossip.make_tick_kernel(cfg, other.topo)
        _, _, wbad, gaps = compare_window(
            tick, lambda w, st, d, sc: cuda_gossip.plain_tick(
                cfg, other.topo, w, st, d, sc),
            other.world, other.state,
            lambda: swim.draw_tick(cfg, other.gen, other.device, chaos=True),
            RAFT_GOSSIP_WINDOW, sched=other.chaos)
        res["raft_only_schedule_window"] = dict(
            ticks=RAFT_GOSSIP_WINDOW, t=other._t, mismatches=wbad[:20],
            float_gaps=gaps,
            node_slots=[int(getattr(other.chaos, f).shape[0]) for f in (
                "part_start", "ll_start", "cw_start", "dg_start")],
            raft_slots=int(other.chaos.rk_kind.shape[0]))
        res["float_gaps"] = gaps
        res["ok"] = (res["ok"] and not wbad and not tr["leaves_differing"]
                     and tr["generator_equal"])
        del other, tick
    res["seconds"] = round(time.perf_counter() - t0, 3)
    return res


def raft_main_path(cfg, groups, peers):
    """The bench's raft flow (bench.py:482-554) at 1M through the entry
    points: set_raft(groups, peers), 4 chunks of RAFT_CHUNK ticks to form,
    16 steady chunks (ticks/s on the host clock, synchronized), a
    RaftStorm scenario over 4 chunks with 2 of settling (elections/s),
    then 8 single-write proposals, each run in chunks until its ticket
    commits (commit latency in ticks, at chunk resolution). Counts the
    tick kernel's launches without a schedule and under the storm's
    raft-only one. Passes if every proposal commits and every group has a
    leader at the end."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip

    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0)
    plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
    reset_launches()
    sim.run(4 * RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    torch.cuda.synchronize()
    form_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    steady = 16 * RAFT_CHUNK
    sim.run(steady, chunk=RAFT_CHUNK, with_metrics=False)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t1
    bare = tick_launches(cuda_gossip.LAUNCHES)
    before = plane.counters_snapshot()["elections_started"]
    t1 = time.perf_counter()
    scen = sim.run_scenario([chaos.RaftStorm(start=2, stop=2 + 4 * RAFT_CHUNK)],
                            chunk=RAFT_CHUNK, settle=2 * RAFT_CHUNK)
    torch.cuda.synchronize()
    storm_s = time.perf_counter() - t1
    storm = tick_launches(cuda_gossip.LAUNCHES) - bare
    elections = plane.counters_snapshot()["elections_started"] - before
    lat = []
    for i in range(8):
        tk = plane.propose([(0, 0, i)])
        ticks = 0
        while not tk.done.is_set() and ticks < 32 * RAFT_CHUNK:
            sim.run(RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
            ticks += RAFT_CHUNK
        lat.append(ticks if tk.done.is_set() else None)
    torch.cuda.synchronize()
    bare = tick_launches(cuda_gossip.LAUNCHES) - storm
    s = plane.summary()
    done = sorted(x for x in lat if x is not None)
    res = dict(groups=groups, peers=peers, window=RAFT_WINDOW, n=cfg.n,
               chunk=RAFT_CHUNK, ticks_per_s=steady / steady_s,
               steady_ticks=steady, steady_s=steady_s,
               ms_per_tick=steady_s / steady * 1e3, form_s=form_s,
               storm_ticks=scen.ticks, elections=elections,
               elections_per_s=elections / storm_s, storm_s=storm_s,
               commit_ticks=lat,
               commit_ticks_p50=done[len(done) // 2] if done else None,
               commit_ticks_p99=done[-1] if done else None,
               summary=s, counters=plane.counters_snapshot(),
               tick_launches_bare=bare, tick_launches_raft_schedule=storm,
               ticks_total=sim._t, wall_s=time.perf_counter() - t0)
    res["ok"] = (len(done) == 8 and all(x >= 0 for x in s["leaders"])
                 and elections > 0 and bare > 0 and storm > 0)
    return res


def raft_serving(cfg):
    """A write-attached ServingPlane(k=8, buckets=(1024,), num_services=8)
    over a 1M Simulation with raft 4x3: 4 chunks to elect, then run_mixed
    at 90:9:1 (the serving_mixed phase's configuration). Every write
    answers ``proposed`` and the apply index does not move during the
    mix (it runs no tick); the pump applies the committed tickets at the
    chunks that follow (commit latency in ticks). The log window follows
    the reference game day's rule for the planned write volume
    (consul_tpu/gameday/harness.py:126-139): 32 entries hold no 64-write
    batch. Then the leader-kill drill (tests/test_raft_device.py:308-366)
    on a fresh 1M Simulation with one group of 5: elect, commit 6
    acknowledged writes, kill the leader, a new leader at a higher term
    within DRILL_BOUND_TICKS, every acknowledged write read back at the
    next flip, one more write committed after the failover."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.serving import ServingPlane
    from consul_tpu_torch.serving.mixed import run_mixed

    t0 = time.perf_counter()
    groups, peers = 4, 3
    write_batch = max(1, round(SERVING_BATCH * 9 / 90))
    per_group = -(-((MIXED_ROUNDS + 1) * write_batch + 8) // groups)
    window = 32
    while window < 2 * per_group + 8:
        window *= 2
    reset_launches()
    sim = cluster.Simulation(cfg, seed=0)
    plane = ServingPlane(k=SERVING_K, buckets=(SERVING_BATCH,),
                         num_services=MIXED_SERVICES)
    sim.attach_serving(plane, writes=True, kv_slots=MIXED_KV_SLOTS)
    rplane = sim.set_raft(groups, peers=peers, window=window)
    sim.run(4 * RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    statuses = {}
    real_execute = plane.writes.execute

    def execute(ops):
        out = real_execute(ops)
        for r in out:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        return out
    plane.writes.execute = execute
    index0 = plane.apply_index
    mixed = run_mixed(sim, plane, ratio="90:9:1", rounds=MIXED_ROUNDS,
                      read_batch=SERVING_BATCH, watchers=MIXED_WATCHERS,
                      seed=0)
    index_mixed = plane.apply_index
    inflight = rplane.inflight
    ticks = 0
    while rplane.inflight and ticks < 64 * RAFT_CHUNK:
        sim.run(RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
        ticks += RAFT_CHUNK
    torch.cuda.synchronize()
    s = rplane.summary()
    res = dict(n=cfg.n, groups=groups, peers=peers, window=window,
               write_statuses=statuses, apply_index_before=index0,
               apply_index_after_mix=index_mixed,
               tickets_after_mix=inflight, commit_ticks=ticks,
               apply_index_committed=plane.apply_index,
               writes_applied=plane.writes.writes, summary=s,
               mixed=mixed)
    mixed_ok = (set(statuses) == {"proposed"} and index_mixed == index0
                and inflight > 0 and rplane.inflight == 0
                and plane.apply_index == index0 + sum(statuses.values())
                and mixed["read"]["count"] == MIXED_ROUNDS * SERVING_BATCH)
    plane.close()
    del sim, plane, rplane
    torch.cuda.empty_cache()

    sim = cluster.Simulation(cfg, seed=5)
    plane = ServingPlane(k=SERVING_K, buckets=(SERVING_BATCH,),
                         num_services=MIXED_SERVICES)
    sim.attach_serving(plane, writes=True, kv_slots=64)
    rplane = sim.set_raft(1, **DRILL_RAFT)
    sim.run(3 * RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    acks = [plane.kv_put(f"drill/{i}", 100 + i).status for i in range(6)]
    for _ in range(24):
        if rplane.inflight == 0:
            break
        sim.run(RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    acked_index = plane.apply_index
    before = rplane.summary()
    t_kill = sim._t
    bare = tick_launches(cuda_gossip.LAUNCHES)
    sim.set_chaos([chaos.RaftKill(start=t_kill + 2, stop=t_kill + 20, group=0,
                                  peer=-1)])
    reelected = None
    for k in range(DRILL_BOUND_TICKS // RAFT_CHUNK):
        sim.run(RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
        now = rplane.summary()
        if (reelected is None and now["leaders"][0] >= 0
                and now["terms"][0] > before["terms"][0]):
            reelected = sim._t - t_kill
    sim.set_chaos(None)
    under_kill = tick_launches(cuda_gossip.LAUNCHES) - bare
    after = rplane.summary()
    read_back = [(plane.kv_get(f"drill/{i}") or {}).get("Value")
                 for i in range(6)]
    post = plane.kv_put("drill/post", 999).status
    for _ in range(24):
        if rplane.inflight == 0:
            break
        sim.run(RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    post_value = (plane.kv_get("drill/post") or {}).get("Value")
    drill = dict(acks=acks, acked_index=acked_index, before=before,
                 after=after, reelected_after_ticks=reelected,
                 bound_ticks=DRILL_BOUND_TICKS, read_back=read_back,
                 apply_index=plane.apply_index, post=post,
                 post_value=post_value, ticks_total=sim._t)
    drill_ok = (acks == ["proposed"] * 6 and before["leaders"][0] >= 0
                and before["committed_clients"][0] == 6
                and reelected is not None and reelected <= DRILL_BOUND_TICKS
                and after["committed_clients"][0] >= 6
                and read_back == [100 + i for i in range(6)]
                and plane.apply_index >= acked_index and post == "proposed"
                and post_value == 999)
    plane.close()
    res.update(drill=drill, tick_launches_raft_schedule=under_kill,
               tick_launches_bare=tick_launches(cuda_gossip.LAUNCHES)
               - under_kill, seconds=round(time.perf_counter() - t0, 3))
    res["ok"] = mixed_ok and drill_ok
    return res


def device_kernels(fn, reps: int):
    """(device ms per call, kernel launches per call) of ``fn`` from the
    profiler's device events; (None, None) if it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        return None, None
    return (sum(e.time_range.elapsed_us() for e in ks) / 1000.0 / reps,
            len(ks) / reps)


def sync_count(fn) -> int:
    """Host synchronizations ``fn`` makes, counted as the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` (not its notice that the
    mode is a prototype)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def raft_timing(cfg):
    """ms per tick at 1M with raft 16x5 and without (CUDA events over
    RAFT_TIMED_TICKS-tick chunks, in turns: without, with, with,
    without) and the host's time to enqueue such a chunk (host clock, no
    wait: near the event time, the host is the bound); the raft step of one tick alone (its draw, the tick, the
    counter add, as _exec_chunk runs them): device ms and launches
    (profiler) and CUDA-event ms; the host synchronizations of the raft
    step (RAFT_TIMED_TICKS of them) and of a whole chunk with raft."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import raft_ops

    sim = cluster.Simulation(cfg, seed=0)
    sim.run(64, chunk=64, with_metrics=False)
    groups, peers = RAFT_SHAPES[0]

    def chunk():
        sim._exec_chunk(RAFT_TIMED_TICKS, False)
    ms = {"without": [], "with": []}
    host_ms = {"without": [], "with": []}
    for armed in (False, True, True, False):
        if armed:
            sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
        else:
            sim.set_raft(None)
        key = "with" if armed else "without"
        ms[key].append(cuda_ms(chunk, 2) / RAFT_TIMED_TICKS)
        # The host's share: enqueueing a chunk, without waiting for it.
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        chunk()
        host_ms[key].append((time.perf_counter() - h0) * 1e3
                            / RAFT_TIMED_TICKS)
        torch.cuda.synchronize()
    plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
    sim.run(RAFT_TIMED_TICKS, chunk=RAFT_TIMED_TICKS, with_metrics=False)
    box = {"rst": plane.take_state(),
           "cnt": torch.zeros(len(raft_ops.FIELDS), dtype=torch.int32,
                              device=sim.device)}
    t = sim._t

    def step():
        rst, rc = raft_ops.tick(plane.rcfg, box["rst"], t, plane.draws(t),
                                None)
        box["rst"] = rst
        box["cnt"] = box["cnt"] + raft_ops.counters_stack(rc)
    # Events before the profiler: a profiled run may leave its tracing
    # hooks on the launches that follow.
    step_ms = cuda_ms(step, RAFT_TIMED_TICKS)
    dev_ms, launches = device_kernels(step, RAFT_TIMED_TICKS)
    res = dict(n=cfg.n, groups=groups, peers=peers, window=RAFT_WINDOW,
               ticks=RAFT_TIMED_TICKS, ms_per_tick_without=ms["without"],
               ms_per_tick_with=ms["with"],
               host_enqueue_ms_per_tick_without=host_ms["without"],
               host_enqueue_ms_per_tick_with=host_ms["with"],
               raft_step_device_ms=dev_ms, raft_step_launches=launches,
               raft_step_ms_events=step_ms,
               raft_step_syncs=sync_count(
                   lambda: [step() for _ in range(RAFT_TIMED_TICKS)]),
               chunk_syncs_with_raft=sync_count(chunk),
               # The counter's control: one read back to the host.
               sync_control=sync_count(lambda: box["cnt"].sum().item()))
    res["ok"] = (res["raft_step_syncs"] == 0 and res["sync_control"] >= 1
                 and launches is not None
                 and all(x > 0 for x in ms["with"] + ms["without"]))
    return res


def sweep_lanes(chaos, sweep, n):
    """sweep_parity's lanes: scenario_random(n, 4, seed=7) (a Partition, a
    ChurnWave and a Degrade in each lane) and the first scenario_grid lane
    padded to their shape with no-op entries (an empty ChurnWave, a
    Degrade without loss), as run_sweep's refusal asks."""
    grid = sweep.scenario_grid(n, 1)[0]
    p = grid[0]
    return sweep.scenario_random(n, 4, seed=7) + [grid + [
        chaos.ChurnWave(start=p.start, stop=p.stop, nodes=slice(0, 0)),
        chaos.Degrade(start=p.start, stop=p.stop, nodes=slice(0, n // 10),
                      tx_loss=0.0)]]


def main_path_lanes(chaos, sweep, n):
    """sweep_parity's lanes at MAIN_N: the first and the last of the main
    path's scenario_grid lanes (the smallest, shortest partition and the
    largest, longest), in the main path's slot shape."""
    grid = sweep.scenario_grid(n, SWEEP_LANES)
    return [grid[0], grid[-1]]


def _named_leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [x for f, sub in zip(tree._fields, tree)
            for x in _named_leaves(sub, f"{prefix}.{f}" if prefix else f)]


def _lane_bits(x):
    return x.reshape(-1).view(torch.uint8)


def lanes_diverge(ka, pa):
    """The first (lane, leaf) whose bits differ between two lists of lane
    states, or None."""
    for lane, (a, b) in enumerate(zip(ka, pa)):
        for (name, x), (_, y) in zip(_named_leaves(a), _named_leaves(b)):
            if not torch.equal(_lane_bits(x), _lane_bits(y)):
                return lane, name
    return None


def sweep_parity(n, family, serf_plane, seed, lanes=sweep_lanes,
                 settle=SWEEP_PARITY_SETTLE):
    """The lanes of a sweep through the CUDA tick kernel against the plain
    tick on the card, on one view-graph family: form SWEEP_FORM ticks
    through the kernel (for serf, then fire an event from a live row
    before the fault), copy the simulation into a kernel="torch" twin
    (same world, topology, state and generator state), and run the
    ``lanes`` scenarios, ``settle`` ticks past their last stop, on both
    (the lane runner under run_sweep). Every lane's
    counters and every lane's final packed state bit-equal; on a
    mismatch, the first diverging tick by bisection over the window."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.chaos import sweep
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.models.counters import FIELDS

    cls = cluster.SerfSimulation if serf_plane else cluster.Simulation
    cfg = SimConfig(n=n, view_degree=32, topo_family=family)
    sim = cls(cfg, seed=seed)
    sim.run(SWEEP_FORM, chunk=SWEEP_FORM, with_metrics=False)
    if serf_plane:
        sim.user_event(_rows(n, [n // 3], sim.device), 9)
    plain = cls(cfg, seed=seed, kernel="torch", world=sim.world,
                topo=sim.topo, state=sim.state)
    plain.load_state(sim.state, sim.generator_state())
    scens = lanes(chaos, sweep, n)
    scheds, ticks = sweep.compile_scenarios(sim, scens, settle=settle)

    def both(k):
        ks, kc, _ = sim._run_lanes(scheds, k)
        ps, pc, _ = plain._run_lanes(scheds, k)
        torch.cuda.synchronize()
        bad = lanes_diverge(ks, ps)
        if bad is None and not torch.equal(kc, pc):
            bad = (int((kc != pc).any(dim=1).nonzero()[0]), "counters")
        return bad, pc
    bad, cnt = both(ticks)
    first = None
    if bad is not None:
        lo, hi = 1, ticks
        while lo < hi:
            mid = (lo + hi) // 2
            if both(mid)[0] is None:
                lo = mid + 1
            else:
                hi = mid
        lane, leaf = both(lo)[0]
        first = {"lane": lane, "leaf": leaf, "tick": lo - 1}
    rows = cnt.cpu().tolist()
    col = {f: [r[FIELDS.index(f)] for r in rows] for f in (
        "chaos_fault_ticks", "chaos_msgs_dropped", "chaos_heal_wait",
        "deaths_declared")}
    res = dict(n=n, k=cfg.degree, family=family, serf=serf_plane,
               lanes=len(scens), ticks=ticks, form=SWEEP_FORM,
               bit_equal=bad is None, first_divergence=first, in_lanes=col)
    res["ok"] = (bad is None and all(x > 0 for x in col["chaos_fault_ticks"])
                 and sum(col["chaos_msgs_dropped"]) > 0)
    return res


def _unmoved(sim, before):
    """The simulation's state bits, tick, generator state and counters
    equal ``before`` (a ``_sim_point``)."""
    now = _sim_point(sim)
    return (lanes_diverge([now[0]], [before[0]]) is None
            and now[1:] == before[1:])


def _sim_point(sim):
    from consul_tpu_torch.models.cluster import _clone

    return (_clone(sim._whole()), sim._t, sim.generator_state(),
            dict(sim.counters))


def _replay_equal(sim, point, events, row, chunk=32):
    """Replay one sweep lane solo: load the simulation's state and
    generator state from ``point`` and run_scenario over the sweep's
    window; True if every counter (and with raft, every raft summary field
    and counter) equals the lane's row."""
    from consul_tpu_torch.models.cluster import _clone

    sim.load_state(_clone(point[0]), point[2])
    raft = sim.raft
    if raft is not None:
        raft.state = _clone(point[4])
        before = raft.counters_snapshot()
    r = sim.run_scenario(events, ticks=row["ticks"], chunk=chunk)
    ok = r.counters == row["counters"] and r.slo == row["slo"]
    if raft is not None:
        after = raft.counters_snapshot()
        got = dict(raft.summary(), counters={
            f: after[f] - before[f] for f in after})
        ok = ok and got == row["raft"]
    return ok


def _railed(slos, scens, ticks):
    """Lanes whose time_to_heal equals the window's end: no tick after
    the fault lifted without a wrong suspicion."""
    return sum(r["time_to_heal"] == ticks - ev[0].stop
               for r, ev in zip(slos, scens))


def measured_pareto(table, railed):
    """The Pareto rows without their lanes, each marked with whether its
    worst heal is only a lower bound (a lane railed), and with the
    dominance claims that rest on measured axes only: o dominates r only
    if no lane of o railed (bytes are never capped, and a railed r's heal
    only grows past its bound)."""
    exact = {r["family"] for r in table if railed[r["family"]] == 0}
    return [dict({k: v for k, v in r.items() if k != "scenarios"},
                  heal_worst_is_lower_bound=railed[r["family"]] > 0,
                  dominated_by_measured=[o for o in r["dominated_by"]
                                         if o in exact])
            for r in table]


def sweep_main_path(cfg, settle=SWEEP_SETTLE):
    """bench_pareto at the main path's shape (bench.py:556-590): 16
    scenario_grid lanes, ``settle`` ticks past the last stop, on each
    family (one call a family, wall on the host clock), with every lane's
    heal and the lanes that railed; then on circulant the same sweep
    through Simulation.sweep on a simulation formed as bench_pareto forms
    it: its rows give the same Pareto row, it makes SWEEP_SYNCS host
    syncs, the simulation is unmoved, and lane 0 and the worst lane equal
    their solo run_scenario replays. Lane-ticks/s and the peak memory are
    read on that sweep."""
    from consul_tpu_torch.chaos import sweep
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip

    scens = sweep.scenario_grid(cfg.n, SWEEP_LANES)
    ticks = max(ev[0].stop for ev in scens) + settle
    per_family, walls, railed, heals = {}, {}, {}, {}
    launches = {"bare": 0, "chaos": 0}
    for fam in SWEEP_FAMILIES:
        before = dict(cuda_gossip.LAUNCHES)
        t0 = time.perf_counter()
        out = sweep.bench_pareto(n=cfg.n, degree=cfg.degree,
                                 scenarios=SWEEP_LANES, families=(fam,),
                                 mode="grid", settle=settle)
        torch.cuda.synchronize()
        walls[fam] = time.perf_counter() - t0
        row = out["pareto"][0]
        per_family[fam] = {k: v for k, v in row.items()
                           if k not in ("family", "dominated_by")}
        railed[fam] = _railed(row["scenarios"], scens, ticks)
        heals[fam] = [r["time_to_heal"] for r in row["scenarios"]]
        d = {k: cuda_gossip.LAUNCHES[k] - before[k] for k in before}
        launches["chaos"] += 4 * d["chaos_pre"]
        launches["bare"] += tick_launches(d) - 4 * d["chaos_pre"]
        torch.cuda.empty_cache()
    table = sweep.pareto_table(per_family)

    sim = cluster.Simulation(cfg, seed=0)
    sim.run(64, chunk=32, with_metrics=False)
    point = _sim_point(sim)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    before = dict(cuda_gossip.LAUNCHES)
    box = {}
    t0 = time.perf_counter()
    syncs = sync_count(lambda: box.update(rows=sim.sweep(
        scens, settle=settle)))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    d = {k: cuda_gossip.LAUNCHES[k] - before[k] for k in before}
    launches["chaos"] += tick_launches(d)
    rows = box["rows"]
    unmoved = _unmoved(sim, point)
    worst = sweep.worst_case(rows)
    circ = per_family["circulant"]
    same_row = (circ["worst_scenario"] == worst
                and [r["time_to_heal"] for r in circ["scenarios"]]
                == [r["slo"]["time_to_heal"] for r in rows])
    replays = {str(i): _replay_equal(sim, point, scens[i], rows[i])
               for i in sorted({0, worst})}
    lane_ticks = SWEEP_LANES * ticks
    dominators = sweep.strict_dominators(per_family)
    res = dict(n=cfg.n, k=cfg.degree, lanes=SWEEP_LANES, ticks=ticks,
               settle=settle, families=list(SWEEP_FAMILIES),
               pareto=measured_pareto(table, railed),
               dominates_default=dominators,
               dominates_default_measured=[f for f in dominators
                                           if railed[f] == 0],
               wall_s_by_family=walls, railed_by_family=railed,
               heal_by_family=heals,
               sweep_wall_s=wall, lane_ticks=lane_ticks,
               lane_ticks_per_s=lane_ticks / wall,
               ms_per_lane_tick=wall / lane_ticks * 1e3,
               peak_bytes=peak, bytes_before_sweep=base_mem,
               host_syncs=syncs, worst_lane=worst, replays_equal=replays,
               circulant_row_reproduced=same_row, sim_unmoved=unmoved,
               tick_launches=launches)
    res["ok"] = (all(replays.values()) and unmoved and same_row
                 and syncs == SWEEP_SYNCS and len(table) == len(SWEEP_FAMILIES)
                 and all(r["bytes_per_tick_node"] > 0 for r in table))
    return res


def sweep_serf(cfg):
    """SerfSimulation at the main path's shape: an event fired from a live
    row, then SWEEP_SERF_LANES scenario_grid lanes settling
    SWEEP_SERF_SETTLE ticks through the serf kernel; the worst lane equals
    its solo replay and the simulation is unmoved."""
    from consul_tpu_torch.chaos import sweep
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip

    sim = cluster.SerfSimulation(cfg, seed=0)
    sim.run(64, chunk=32, with_metrics=False)
    sim.user_event(_rows(cfg.n, [cfg.n // 3], sim.device), 9)
    scens = sweep.scenario_grid(cfg.n, SWEEP_SERF_LANES)
    point = _sim_point(sim)
    torch.cuda.reset_peak_memory_stats()
    before = dict(cuda_gossip.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sim.sweep(scens, settle=SWEEP_SERF_SETTLE)
    wall = time.perf_counter() - t0
    d = {k: cuda_gossip.LAUNCHES[k] - before[k] for k in before}
    unmoved = _unmoved(sim, point)
    worst = sweep.worst_case(rows)
    replay = _replay_equal(sim, point, scens[worst], rows[worst])
    lane_ticks = len(scens) * rows[0]["ticks"]
    res = dict(n=cfg.n, lanes=len(scens), ticks=rows[0]["ticks"],
               sweep_wall_s=wall, lane_ticks_per_s=lane_ticks / wall,
               ms_per_lane_tick=wall / lane_ticks * 1e3,
               peak_bytes=torch.cuda.max_memory_allocated(),
               slo=[r["slo"] for r in rows], worst_lane=worst,
               replay_equal=replay, sim_unmoved=unmoved,
               tick_launches={"serf_chaos": tick_launches(d)})
    res["ok"] = (replay and unmoved and d["serf_post"] == lane_ticks
                 and d["chaos_pre"] == lane_ticks)
    return res


def sweep_raft(cfg):
    """Raft 16x5 armed at the main path's shape (raft_main_path's set-up),
    two lanes over SWEEP_RAFT_TICKS ticks: a storm and a leader kill. The
    rows carry raft; each lane equals its solo replay on every raft
    summary field and counter; the live plane and the simulation are
    unmoved. ms per lane-tick with raft."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip

    groups, peers = RAFT_SHAPES[0]
    sim = cluster.Simulation(cfg, seed=0)
    plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
    sim.run(4 * RAFT_CHUNK, chunk=RAFT_CHUNK, with_metrics=False)
    scens = [[chaos.RaftStorm(start=2, stop=18)],
             [chaos.RaftKill(start=2, stop=14, group=0, peer=-1)]]
    point = _sim_point(sim) + (cluster._clone(plane.take_state()),)
    base = (plane.summary(), plane.counters_snapshot())
    before = dict(cuda_gossip.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sim.sweep(scens, ticks=SWEEP_RAFT_TICKS)
    wall = time.perf_counter() - t0
    d = {k: cuda_gossip.LAUNCHES[k] - before[k] for k in before}
    plane_unmoved = (plane.summary(), plane.counters_snapshot()) == base
    unmoved = _unmoved(sim, point[:4])
    replays = [_replay_equal(sim, point, ev, row, chunk=RAFT_CHUNK)
               for ev, row in zip(scens, rows)]
    lane_ticks = len(scens) * SWEEP_RAFT_TICKS
    res = dict(n=cfg.n, groups=groups, peers=peers, window=RAFT_WINDOW,
               lanes=len(scens), ticks=SWEEP_RAFT_TICKS, sweep_wall_s=wall,
               ms_per_lane_tick=wall / lane_ticks * 1e3,
               raft=[r.get("raft") for r in rows], replays_equal=replays,
               plane_unmoved=plane_unmoved, sim_unmoved=unmoved,
               tick_launches={"chaos": tick_launches(d)})
    res["ok"] = (all("raft" in r for r in rows) and all(replays)
                 and plane_unmoved and unmoved
                 and rows[0]["raft"]["counters"]["elections_started"] > 0)
    return res


def sweep_bench_shape():
    """bench_pareto at the bench's own shape (bench.py:567-586): wall on
    the host clock, forming included, and the host ms per lane-tick
    (the wrappers' host work sets the pace at this size)."""
    from consul_tpu_torch.chaos import sweep
    from consul_tpu_torch.ops import cuda_gossip

    before = dict(cuda_gossip.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep.bench_pareto(**BENCH_SWEEP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: cuda_gossip.LAUNCHES[k] - before[k] for k in before}
    lane_ticks = d["chaos_pre"]
    scens = sweep.scenario_grid(BENCH_SWEEP["n"], BENCH_SWEEP["scenarios"])
    ticks = max(ev[0].stop for ev in scens) + BENCH_SWEEP["settle"]
    railed = {r["family"]: _railed(r["scenarios"], scens, ticks)
              for r in out["pareto"]}
    res = dict(BENCH_SWEEP, wall_s=wall, lane_ticks=lane_ticks,
               ms_per_lane_tick=wall / max(1, lane_ticks) * 1e3,
               pareto=measured_pareto(out["pareto"], railed),
               railed_by_family=railed,
               dominates_default=out["dominates_default"],
               dominates_default_measured=[
                   f for f in out["dominates_default"] if railed[f] == 0],
               tick_launches={"chaos": 4 * lane_ticks,
                              "bare": tick_launches(d) - 4 * lane_ticks})
    res["ok"] = (len(out["pareto"]) == 4 and lane_ticks > 0
                 and all(len(r["scenarios"]) == BENCH_SWEEP["scenarios"]
                         for r in out["pareto"]))
    return res


def _fed_cfg(kw, view):
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models.federation import FederationConfig

    return FederationConfig(lan=SimConfig(view_degree=view), **kw)


def _fed_pools(st):
    """A FederationState's pools in order: the LAN pools, then the WAN."""
    return [*st.lan, st.wan]


def federation_parity(seed: int, kw: dict):
    """Federation(kernel="cuda") against Federation(kernel="torch") at the
    size ``kw`` from one formed state, one draw bundle per LAN tick on both sides (the WAN
    bundle read on fire ticks): every pool's discrete leaves and every
    counter of every DC and of the WAN pool equal after every tick, float
    leaves within MAX_STEPS / FLOOR_S. Gaps are kept apart for the LAN
    pools (B1) and the WAN pool (the dense view, n = 12)."""
    from consul_tpu_torch.models import federation, swim
    from consul_tpu_torch.models.cluster import _clone
    from consul_tpu_torch.models.counters import FIELDS

    cfg = _fed_cfg(kw, FED_VIEW)
    n, s = cfg.nodes_per_dc, cfg.servers_per_dc
    fk = federation.Federation(cfg, seed=seed)
    fk.run(FED_PARITY_FORM, chunk=FED_CHUNK)
    rows = torch.arange(n)
    fk.kill(0, (rows >= s) & (rows < s + n // 20))
    fk.kill(1, rows == 0)
    fk.run(FED_PARITY_SETTLE, chunk=FED_CHUNK)
    st = fk.state
    fp = federation.Federation(
        cfg, seed=seed, kernel="torch", lan_topo=fk.lan_topo,
        wan_topo=fk.wan_topo, lan_world=fk.lan_world, wan_world=fk.wan_world,
        state=st._replace(lan=tuple(_clone(x) for x in st.lan),
                          wan=_clone(st.wan)))
    base = fk.counters()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    bad = []
    gaps = {p: {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
            for p in ("lan", "wan")}
    wan_t0 = int(fk.state.wan.t)
    launches0 = (fk._lan_tick.launches, fk._wan_tick.launches)
    for t in range(FED_PARITY_TICKS):
        bundle = ([swim.draw_tick(cfg.lan, gen, "cuda") for _ in range(cfg.n_dc)],
                  swim.draw_tick(cfg.wan, gen, "cuda"))
        for f in (fk, fp):
            f.draws = lambda _t, b=bundle: b
            f.run(1)
        torch.cuda.synchronize()
        for i, (kp, pp) in enumerate(zip(_fed_pools(fk.state),
                                         _fed_pools(fp.state))):
            where = "wan" if i == cfg.n_dc else "lan"
            compare_packed(kp, pp, t, gaps[where], bad)
        ck, cp = fk.counters(), fp.counters()
        moved = [{f: a[f] - b[f] for f in FIELDS}
                 for a, b in zip(ck["lan"] + [ck["wan"]],
                                 base["lan"] + [base["wan"]])]
        if moved != cp["lan"] + [cp["wan"]]:
            bad.append(f"tick {t} counters differ")
        if fk.state.wan_accum_ms != fp.state.wan_accum_ms:
            bad.append(f"tick {t} WAN accumulator differs")
        if bad:
            break
    cp = fp.counters()
    lan_sum = {f: sum(c[f] for c in cp["lan"]) for f in FIELDS}
    fires = int(fk.state.wan.t) - wan_t0
    res = dict(n_dc=cfg.n_dc, nodes_per_dc=n, k=cfg.lan.degree,
               n_wan=cfg.n_wan, k_wan=cfg.wan.degree, ticks=FED_PARITY_TICKS,
               wan_fire_ticks=fires, mismatches=bad[:10],
               float_gaps_lan=gaps["lan"], float_gaps_wan=gaps["wan"],
               lan_counters_in_window=lan_sum, wan_counters_in_window=cp["wan"],
               kernel_launches={"lan": fk._lan_tick.launches - launches0[0],
                                "wan": fk._wan_tick.launches - launches0[1]})
    res["ok"] = (not bad and fires == FED_PARITY_TICKS * 2 // 5
                 and lan_sum["suspicions_started"] > 0
                 and cp["wan"]["probes_sent"] > 0)
    return res


def _wan_rmse_s(fed):
    """RMS error, in seconds, of the WAN coordinates' distance
    (server/rtt.compute_distance) against the true RTT over every ordered
    pair of WAN servers."""
    from consul_tpu_torch.ops import topology
    from consul_tpu_torch.server import rtt

    cfg = fed.cfg
    n, s = cfg.n_wan, cfg.servers_per_dc
    coords = [fed.wan_server_coord(*divmod(i, s)) for i in range(n)]
    pos = fed.wan_world.pos.cpu()
    height = fed.wan_world.height.cpu()
    world = topology.World(pos=pos, height=height)
    err = [rtt.compute_distance(coords[i], coords[j])
           - float(topology.true_rtt(world, i, j))
           for i in range(n) for j in range(n) if i != j]
    return math.sqrt(sum(e * e for e in err) / len(err))


def router_check(fed):
    """The port's Router (server/router.py) over the WAN coordinates: its
    get_datacenters_by_distance against true_dc_distance_order(0), and
    whether every pair of DCs whose true site distances from dc0 differ by
    more than the WAN coordinates' RMS error is in the true order."""
    from consul_tpu_torch.server.router import Router

    cfg = fed.cfg
    r = Router("dc0")
    for dc in range(cfg.n_dc):
        for srv in range(cfg.servers_per_dc):
            r.add_server(f"srv{srv}.dc{dc}", f"dc{dc}",
                         coord=fed.wan_server_coord(dc, srv))
    got = [int(d[2:]) for d in r.get_datacenters_by_distance()]
    want = fed.true_dc_distance_order(0)
    sites = fed.wan_world.pos[::cfg.servers_per_dc].cpu()
    true_s = [float(x) for x in torch.linalg.norm(sites - sites[0], dim=1)]
    rmse = _wan_rmse_s(fed)
    rank = {dc: i for i, dc in enumerate(got)}
    pairs = [(a, b) for a in range(cfg.n_dc) for b in range(cfg.n_dc)
             if true_s[a] + rmse < true_s[b]]
    return dict(router_order=got, true_order=want, router_equal=got == want,
                true_site_distance_ms=[x * 1e3 for x in true_s],
                wan_rmse_ms=rmse * 1e3, resolvable_pairs=len(pairs),
                resolvable_in_order=all(rank[a] < rank[b] for a, b in pairs),
                route_dc1=r.find_route("dc1"))


def federation_main_path(rate):
    """BASELINE.json's fifth config through Federation: 4 DCs x 250,000
    nodes (K = 32) and the WAN pool (12 servers, K = 11), formed FED_FORM
    ticks, a non-server node of dc0 killed and dc3 killed whole, then
    FED_AFTER ticks in FED_CHUNK-tick chunks (host syncs counted): every
    LAN pool's health, dc3's servers as dc0 sees them on the WAN, the
    port's Router order, LAN ticks/s, peak bytes; then ms per LAN tick on
    the host clock over FED_TIMED_TICKS ticks and by CUDA events for the
    four LAN launch sets and the WAN tick apart (the WAN tick's row:
    time_kernel on its final state)."""
    from consul_tpu_torch.models import federation, layout, swim
    from consul_tpu_torch.ops import cuda_gossip

    cfg = _fed_cfg(FED_MAIN, FED_VIEW)
    n = cfg.nodes_per_dc
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fed = federation.Federation(cfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    fed.run(FED_FORM, chunk=FED_CHUNK)
    fed.kill(0, torch.arange(n) == 10)
    fed.kill_dc(3)
    torch.cuda.synchronize()
    form_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syncs = sync_count(lambda: fed.run(FED_AFTER, chunk=FED_CHUNK))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_gossip.LAUNCHES)
    lan_k, wan_k = fed._lan_tick, fed._wan_tick
    kl = {"lan": lan_k.launches, "wan": wan_k.launches}
    lan = []
    for dc in range(cfg.n_dc):
        h = fed.lan_health(dc)
        lan.append({k: float(getattr(h, k)) for k in h._fields})
    wh = fed.wan_health()
    wan = {k: float(getattr(wh, k)) for k in wh._fields}
    dc3 = [m["status"] for m in fed.wan_members_seen_by(0) if m["dc"] == "dc3"]
    router = router_check(fed)
    finite = all(bool(torch.isfinite(p.viv.vec.float()).all())
                 for p in _fed_pools(fed.state))
    # Timing: the host clock over a chunk, CUDA events for the LAN launch
    # sets and the WAN tick on the final state.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    d_lan = [swim.draw_tick(cfg.lan, gen, "cuda") for _ in range(cfg.n_dc)]
    d_wan = swim.draw_tick(cfg.wan, gen, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed.run(FED_TIMED_TICKS, chunk=FED_TIMED_TICKS)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / FED_TIMED_TICKS * 1e3
    lan_ms = cuda_ms(lambda: [lan_k(fed.lan_world[i], fed.state.lan[i],
                                    d_lan[i]) for i in range(cfg.n_dc)], 10)
    wan_t = time_kernel(
        wan_k, lambda w, st, dd: cuda_gossip.plain_tick(cfg.wan, fed.wan_topo,
                                                        w, st, dd),
        fed.wan_world, fed.state.wan, d_wan,
        cuda_gossip.tick_hbm_bytes_per_node(fed.state.wan, fed.wan_world),
        cfg.n_wan, rate, profile=False)
    child = wan_launch_profile()
    wan_t["ms_by_launch"] = child.pop("ms_by_launch")
    wan_t["ms_by_launch_from"] = dict(
        child, script="launch_timing.py --states wan (a fresh process)",
        state="launch_timing.py's own state of the WAN shape (n = 12, "
              "K = 11), not this federation's WAN pool")
    # K1: the WAN line must carry A / B / C.
    wan_profiled = child["rc"] == 0 and isinstance(
        wan_t["ms_by_launch"], dict) and all(
        k in wan_t["ms_by_launch"] for k in WAN_LAUNCHES)
    wan_ms = cuda_ms(lambda: wan_k(fed.wan_world, fed.state.wan, d_wan), 20)
    res = dict(n_dc=cfg.n_dc, nodes_per_dc=n, k=cfg.lan.degree,
               n_wan=cfg.n_wan, k_wan=cfg.wan.degree, form_ticks=FED_FORM,
               ticks_after_kill=FED_AFTER, chunk=FED_CHUNK,
               setup_s=setup_s, form_s=form_s, wall_s=wall,
               lan_ticks_per_s=FED_AFTER / wall,
               ms_per_lan_tick_run=wall / FED_AFTER * 1e3,
               ms_per_lan_tick_host=host_ms,
               ms_lan_launch_sets_events=lan_ms,
               ms_wan_tick_events=wan_ms,
               wan_fire_share=2 / 5,
               peak_bytes=peak - base_bytes, host_syncs=syncs,
               bytes_per_node=layout.bytes_per_node(fed.state.lan[0], n),
               lan=lan, wan=wan, dc3_seen_by_dc0=dc3, router=router,
               wan_ticks=int(fed.state.wan.t), launches=launches,
               kernel_launches=kl, counters=fed.counters(),
               wan_profiled=wan_profiled)
    # The kill stays local: dc0 declares its node dead with no false
    # positive (its viewers' suspicions time out over up to ~650 ticks at
    # this size, so not every one has yet), dc1 and dc2 untouched, the WAN
    # whole apart from dc3.
    cnt = res["counters"]
    local = (lan[0]["live_nodes"] == n - 1 and lan[0]["false_positive"] == 0.0
             and cnt["lan"][0]["deaths_declared"] > 0
             and all(lan[i]["live_nodes"] == n and lan[i]["agreement"] == 1.0
                     and cnt["lan"][i]["suspicions_started"] == 0
                     for i in (1, 2))
             and lan[3]["live_nodes"] == 0)
    res["stays_local"] = local
    # The learned WAN coordinates order the DCs on a federation of the same
    # seed that runs as long with no fault: tests/test_federation.py's order
    # check (:79-80) at config 5, the Router's order equal to
    # true_dc_distance_order(0). The order after the kill above is reported
    # only: dc3's coordinates froze when it died, FED_FORM ticks in.
    formed = federation.Federation(cfg, seed=0)
    formed.run(FED_FORM + FED_AFTER, chunk=FED_CHUNK)
    res["router_formed"] = router_check(formed)
    kl["lan"] += formed._lan_tick.launches
    kl["wan"] += formed._wan_tick.launches
    del formed
    res["ok"] = (local and dc3 and all(x == "dead" for x in dc3)
                 and wan["agreement"] == 1.0 and wan["undetected"] == 0.0
                 and res["router_formed"]["router_equal"]
                 and res["router_formed"]["route_dc1"] is not None
                 and syncs == 0 and finite and kl["lan"] > 0 and kl["wan"] > 0
                 and wan_profiled)
    return res, wan_t


def _dcn_view(d):
    """The DCN tier's envelope: the sink's sim.dcn.* counters and every
    link's (attempt, down_until, degraded, queue_peak, queue depth)."""
    return dict(
        counters={c: d.sink.counter_sum("sim.dcn." + c) for c in DCN_COUNTERS},
        links={f"{a}->{b}": [ls.attempt, ls.down_until, ls.degraded,
                             ls.queue_peak, len(ls.queue)]
               for (a, b), ls in d._links.items()})


def dcn_run(kw, view, device, kernel, meshes=None, groups=None):
    """DcnFederation.run over DCN_ROUNDS rounds of DCN_SYNC ticks under
    bench.py's link faults (each island on ``meshes[k]`` when given), with
    each sync timed (host clock, after the islands' work has finished)
    and replicas_agree read after it."""
    from consul_tpu_torch.parallel import dcn
    from consul_tpu_torch.utils.telemetry import Sink

    cfg = _fed_cfg(kw, view)
    d = dcn.DcnFederation(cfg, n_islands=2, seed=0, sink=Sink(),
                          link_policy=dcn.LinkPolicy(retry_max=3, queue_bound=4),
                          meshes=meshes, groups=groups, device=device,
                          kernel=kernel)
    d.inject_link_faults([
        dcn.LinkFault(src=0, dst=1, start=1, stop=4, kind="timeout"),
        dcn.LinkFault(src=1, dst=0, start=1, stop=4)])
    sync_ms, agree = [], []
    sync = d.sync

    def timed_sync(ticks=1):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync(ticks)
        if device == "cuda":
            torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        agree.append(d.replicas_agree())

    d.sync = timed_sync
    t0 = time.perf_counter()
    d.run(DCN_ROUNDS * DCN_SYNC, sync_every=DCN_SYNC, chunk=DCN_SYNC)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return d, dict(wall_s=wall, sync_ms=sync_ms, agree_by_round=agree,
                   **_dcn_view(d), queue_peak=d.queue_peak(),
                   queue_bound=d.link_policy.queue_bound,
                   replicas_agree=d.replicas_agree())


def _dcn_launches(d):
    return {"lan": sum(i._lan_tick.launches for i in d.islands),
            "wan": sum(i._wan_tick.launches for i in d.islands)}


def dcn_drill():
    """bench.py's DCN drill on the card, and its link envelope against the
    same drill on the CPU's plain path (the envelope does not depend on
    the gossip); then the same faults at 2 islands x 250,000 nodes with
    the sync's ms per round, held against its plain twin on the card."""
    d, res = dcn_run(DCN_DRILL, DCN_DRILL_VIEW, "cuda", "cuda")
    # The plain tick on the card draws what the kernel's run drew (each
    # island's generator, seeded alike): every pool equal at the end.
    p, plain = dcn_run(DCN_DRILL, DCN_DRILL_VIEW, "cuda", "torch")
    bad = []
    gaps = {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
    for k, (a, b) in enumerate(zip(d.islands, p.islands)):
        for x, y in zip(_fed_pools(a.state), _fed_pools(b.state)):
            compare_packed(x, y, f"island {k} end", gaps, bad)
        if a.counters() != b.counters():
            bad.append(f"island {k} counters differ")
    res["plain_mismatches"] = bad[:10]
    res["plain_float_gaps"] = gaps
    del p
    _, cpu = dcn_run(DCN_DRILL, DCN_DRILL_VIEW, "cpu", "torch")
    res["envelope_equals_cpu"] = (
        (res["counters"], res["links"]) == (cpu["counters"], cpu["links"])
        and res["agree_by_round"] == cpu["agree_by_round"]
        and (plain["counters"], plain["links"]) == (cpu["counters"],
                                                    cpu["links"]))
    res["kernel_launches"] = _dcn_launches(d)
    res.update(n_dc=DCN_DRILL["n_dc"], nodes_per_dc=DCN_DRILL["nodes_per_dc"],
               k=DCN_DRILL_VIEW, islands=2, rounds=DCN_ROUNDS,
               sync_every=DCN_SYNC)
    del d
    big_d, big = dcn_run(DCN_BIG, FED_VIEW, "cuda", "cuda")
    big["kernel_launches"] = _dcn_launches(big_d)
    # Its plain twin on the card, as for the small drill.
    big_p, big_plain = dcn_run(DCN_BIG, FED_VIEW, "cuda", "torch")
    big_bad = []
    big_gaps = {f: {"steps": 0, "abs": 0.0} for f in FLOAT_LEAVES}
    for k, (a, b) in enumerate(zip(big_d.islands, big_p.islands)):
        for x, y in zip(_fed_pools(a.state), _fed_pools(b.state)):
            compare_packed(x, y, f"island {k} end", big_gaps, big_bad)
        if a.counters() != b.counters():
            big_bad.append(f"island {k} counters differ")
    big["plain_mismatches"] = big_bad[:10]
    big["plain_float_gaps"] = big_gaps
    big["envelope_equals_plain"] = (
        (big["counters"], big["links"], big["agree_by_round"])
        == (big_plain["counters"], big_plain["links"],
            big_plain["agree_by_round"]))
    del big_p
    big.update(n_dc=DCN_BIG["n_dc"],
               nodes_per_dc=DCN_BIG["nodes_per_dc"], k=FED_VIEW,
               n_wan=big_d.cfg.n_wan, k_wan=big_d.cfg.wan.degree)
    del big_d

    def ok(r):
        return (r["replicas_agree"] and r["queue_peak"] <= r["queue_bound"]
                and r["counters"]["heals"] == 2 and r["counters"]["retries"] > 0
                and not r["agree_by_round"][2]
                and r["kernel_launches"]["lan"] > 0
                and r["kernel_launches"]["wan"] > 0)

    res["ok"] = ok(res) and res["envelope_equals_cpu"] and not bad
    big["ok"] = ok(big) and big["envelope_equals_plain"] and not big_bad
    return res, big


def fed_diff(a, b) -> list:
    """Leaves of two whole FederationStates that differ in any bit, by
    pool."""
    bad = [] if a.wan_accum_ms == b.wan_accum_ms else ["wan_accum_ms"]
    for i, (x, y) in enumerate(zip(_fed_pools(a), _fed_pools(b))):
        where = "wan" if i == len(a.lan) else f"lan{i}"
        bad += [f"{where}.{leaf}" for leaf in tree_diff(x, y)]
    return bad


def _fed_mesh_launches(fed) -> dict:
    """A meshed federation's launches: B7 (its DCs' sharded ticks, the
    exchange copies apart) and the WAN pool's (B1 on the dense view)."""
    return {"b7": sum(k.launches for k in fed._lan_ticks),
            "copies": sum(k.copies for k in fed._lan_ticks),
            "wan": fed._wan_tick.launches}


def _fed_tick_ms(fed, ticks: int) -> dict:
    """ms per LAN tick of ``fed.run(ticks)``: the host clock (from a
    synchronized start to the end of the enqueue, and to the card's end)
    and CUDA events around it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fed.run(ticks, chunk=ticks)
    enqueue = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"ms_host": wall / ticks * 1e3, "ms_enqueue": enqueue / ticks * 1e3,
            "ms_events": start.elapsed_time(end) / ticks}


def host_profile(fn, per: int, top: int = 12) -> dict:
    """``cProfile`` of ``fn`` (synchronized at its end): the ``top``
    functions by cumulative host time, in ms per ``per`` (cProfile's own
    cost on every Python call included, so shares, not times, carry)."""
    import cProfile
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][3])[:top]
    return {f"{os.path.basename(f)}:{line}({name})": v[3] / per * 1e3
            for (f, line, name), v in rows}


def federation_mesh():
    """Federation(mesh=) at FED_MAIN's width on ["cuda:0"] * 8 as a (2, 4)
    (dc, nodes) mesh: each DC's 250,000 rows in 4 shards of its row,
    every LAN tick through the DC's sharded tick (B7), the WAN pool whole
    on the card. Under the row's device groups (one group: one launch set
    a DC a LAN tick) federation_main_path's flow (FED_FORM ticks, a
    non-server kill in dc0, dc3 killed whole, FED_AFTER ticks in
    FED_CHUNK chunks); under one group per shard (the exchanges of a mesh
    of one card per shard) federation_parity's window (FED_PARITY_FORM
    ticks, a 5 % kill in dc0 and dc1's server 0, FED_PARITY_SETTLE +
    FED_PARITY_TICKS ticks). Each against the one-device Federation of
    the same seed at every chunk boundary: every pool's leaves bit for
    bit and counters() equal. ms a LAN tick on the host clock and by CUDA
    events beside the one-device federation's, launches and exchange
    copies a LAN tick, peak bytes above the phase's baseline, host syncs
    in each run (none after the first), and a host profile of a LAN tick,
    meshed and on one device."""
    from consul_tpu_torch.models import federation
    from consul_tpu_torch.parallel import mesh as mesh_mod

    cfg = _fed_cfg(FED_MAIN, FED_VIEW)
    n, s = cfg.nodes_per_dc, cfg.servers_per_dc
    mesh = mesh_mod.make_mesh(["cuda:0"] * FED_MESH_DEVICES, n_dc=FED_MESH_ROWS)
    row = mesh_mod.row_mesh(mesh, 0)
    out = {"n_dc": cfg.n_dc, "nodes_per_dc": n, "k": cfg.lan.degree,
           "n_wan": cfg.n_wan, "mesh": list(mesh.shape),
           "rows_per_shard": n // row.size, "runs": {}}
    rows = torch.arange(n)
    flows = {
        "device": (None, [(FED_FORM, lambda f: (f.kill(0, rows == 10),
                                                f.kill_dc(3)))]
                   + [(FED_CHUNK, None)] * (FED_AFTER // FED_CHUNK)
                   + [(FED_AFTER % FED_CHUNK, None)]),
        "shard": (mesh_mod.shard_groups(row),
                  [(FED_PARITY_FORM, lambda f: (
                      f.kill(0, (rows >= s) & (rows < s + n // 20)),
                      f.kill(1, rows == 0))),
                   (FED_PARITY_SETTLE, None), (FED_PARITY_TICKS, None)]),
    }
    ok = True
    for grouping, (groups, steps) in flows.items():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        fed = federation.Federation(cfg, seed=0, mesh=mesh, groups=groups)
        one = federation.Federation(cfg, seed=0)
        bad, syncs, ticks = [], [], 0
        for c, (ticks_c, edit) in enumerate(steps):
            if not ticks_c:
                continue
            syncs.append(sync_count(lambda: fed.run(ticks_c, chunk=ticks_c)))
            one.run(ticks_c, chunk=ticks_c)
            ticks += ticks_c
            if edit is not None:
                edit(fed)
                edit(one)
            diff = fed_diff(fed.whole_state(), one.state)
            if fed.counters() != one.counters():
                diff.append("counters")
            bad += [f"chunk {c}: {d}" for d in diff]
            if bad:
                break
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = _fed_mesh_launches(fed)
        global_counts = {"launches": dict(cuda_gossip_counts()[0]),
                         "sharded_launches": dict(cuda_gossip_counts()[1])}
        timed = _fed_tick_ms(fed, FED_TIMED_TICKS)
        one_timed = _fed_tick_ms(one, FED_TIMED_TICKS)
        # Where a LAN tick's host time goes, meshed and on one device.
        profiles = {"mesh": host_profile(
            lambda: fed.run(FED_TIMED_TICKS), FED_TIMED_TICKS),
            "one_device": host_profile(
            lambda: one.run(FED_TIMED_TICKS), FED_TIMED_TICKS)}
        lan = fed.lan_health(0)
        res = dict(groups=[list(g) for g in fed.groups], ticks=ticks,
                   mismatches=bad[:10], host_syncs_by_run=syncs,
                   peak_bytes=peak,
                   b7_launches=launches["b7"],
                   b7_launches_per_lan_tick=launches["b7"] / ticks,
                   exchange_copies_per_lan_tick=launches["copies"] / ticks,
                   wan_launches=launches["wan"], counts=global_counts,
                   ms_per_lan_tick=timed, ms_per_lan_tick_one_device=one_timed,
                   host_ms_per_lan_tick_cprofile=profiles,
                   dc0_live_nodes=float(lan.live_nodes),
                   counters_dc0=fed.counters()["lan"][0])
        # The first run holds the kernels' one-time set-up (the WAN
        # kernel's dense tables read the topology once); later runs sync
        # nothing.
        res["ok"] = (not bad and sum(syncs[1:]) == 0 and launches["b7"] > 0
                     and launches["wan"] > 0
                     and global_counts["sharded_launches"]["probe_send"] > 0
                     and (launches["copies"] > 0) == (grouping == "shard"))
        out["runs"][grouping] = res
        ok = ok and res["ok"]
        del fed, one
        torch.cuda.empty_cache()
    out["ok"] = ok
    return out


def cuda_gossip_counts():
    from consul_tpu_torch.ops import cuda_gossip

    return cuda_gossip.LAUNCHES, cuda_gossip.SHARDED_LAUNCHES


def dcn_meshes():
    """DcnFederation(meshes=) at DCN_MESH's width (4 DCs x 250,000, 3
    servers, 2 islands), each island a (2, 2) mesh of the card, under
    bench.py's drill faults (DCN_ROUNDS rounds of DCN_SYNC ticks) and
    both groupings, against the meshless run of the same seed and faults:
    every island's pools bit for bit and counters equal, the link
    envelope and replicas_agree round by round equal, and the replicas
    agree after the heal. The sync's ms a round of each."""
    from consul_tpu_torch.parallel import mesh as mesh_mod

    reset_launches()
    flat_d, flat = dcn_run(DCN_MESH, FED_VIEW, "cuda", "cuda")
    out = {"n_dc": DCN_MESH["n_dc"], "nodes_per_dc": DCN_MESH["nodes_per_dc"],
           "k": FED_VIEW, "islands": 2, "rounds": DCN_ROUNDS,
           "sync_every": DCN_SYNC, "meshless_sync_ms": flat["sync_ms"],
           "runs": {}}
    ok = True
    for grouping in GROUPINGS:
        meshes = [mesh_mod.make_mesh(["cuda:0"] * DCN_MESH_DEVICES,
                                     n_dc=DCN_MESH_ROWS) for _ in range(2)]
        row = mesh_mod.row_mesh(meshes[0], 0)
        groups = None if grouping == "device" else mesh_mod.shard_groups(row)
        d, res = dcn_run(DCN_MESH, FED_VIEW, "cuda", "cuda", meshes=meshes,
                         groups=groups)
        bad = []
        for k, (a, b) in enumerate(zip(d.islands, flat_d.islands)):
            bad += [f"island {k} {x}" for x in fed_diff(a.whole_state(),
                                                        b.state)]
            if a.counters() != b.counters():
                bad.append(f"island {k} counters")
        launches = [_fed_mesh_launches(i) for i in d.islands]
        res.update(mismatches=bad[:10],
                   envelope_equal=((res["counters"], res["links"],
                                    res["agree_by_round"])
                                   == (flat["counters"], flat["links"],
                                       flat["agree_by_round"])),
                   b7_launches=sum(x["b7"] for x in launches),
                   exchange_copies=sum(x["copies"] for x in launches),
                   wan_launches=sum(x["wan"] for x in launches))
        res["ok"] = (not bad and res["envelope_equal"] and res["replicas_agree"]
                     and res["counters"]["heals"] == 2
                     and not res["agree_by_round"][2]
                     and res["b7_launches"] > 0 and res["wan_launches"] > 0)
        out["runs"][grouping] = res
        ok = ok and res["ok"]
        del d
        torch.cuda.empty_cache()
    out["counts"] = {"launches": dict(cuda_gossip_counts()[0]),
                     "sharded_launches": dict(cuda_gossip_counts()[1])}
    del flat_d
    torch.cuda.empty_cache()
    out["ok"] = ok and out["counts"]["sharded_launches"]["probe_send"] > 0
    return out


def _interval(ev, base, a, b):
    return (base.elapsed_time(ev[a]), base.elapsed_time(ev[b]))


def _overlap(x, y) -> float:
    return max(0.0, min(x[1], y[1]) - max(x[0], y[0]))


def stream_timeline(events) -> dict:
    """Upload, compute and drain of each cohort (ms, from its CUDA events
    on the copy and compute streams) and how much of each copy overlaps a
    cohort's ticks."""
    base = events[0]["upload_start"]
    up, comp, down = [], [], []
    for ev in events:
        up.append(_interval(ev, base, "upload_start", "upload_end"))
        comp.append(_interval(ev, base, "compute_start", "compute_end"))
        down.append(_interval(ev, base, "drain_start", "drain_end"))
    over_up = [sum(_overlap(u, c) for c in comp) for u in up]
    over_down = [sum(_overlap(d, c) for c in comp) for d in down]
    return {"upload_ms": [b - a for a, b in up],
            "compute_ms": [b - a for a, b in comp],
            "drain_ms": [b - a for a, b in down],
            "upload_overlapping_compute_ms": over_up,
            "drain_overlapping_compute_ms": over_down,
            "pass_ms_events": comp[-1][1] if comp else 0.0}


def streamed_case(kind: str, spec: dict):
    """StreamedSimulation (or StreamedSerfSimulation) at ``spec['n']``
    nodes under its budget: the port's plan must equal the reference
    planner's numbers; ``passes`` passes of ``ticks`` ticks, cohorts
    through the CUDA tick; the cohorts in ``check`` bit-equal (state and
    counters) to a resident Simulation (SerfSimulation) of the cohort's
    size fed the cohort's initial state, world and draw generator; the
    device peak above the phase's baseline within the plan's resident
    bytes; the pass wall against cohorts x ticks x the resident tick."""
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, serf, swim
    from consul_tpu_torch.runtime import membudget

    cfg = SimConfig(n=spec["n"], view_degree=FED_VIEW)
    plan = membudget.plan(cfg, kind, layout="packed", budget=spec["budget"])
    res = {"kind": kind, "n": cfg.n, "k": cfg.degree, "budget": spec["budget"],
           "plan": plan.to_dict()}
    plan_ok = (plan.streamed and plan.cohort_n == spec["cohort_n"]
               and plan.chunk == spec["chunk"]
               and plan.resident_bytes == spec["resident_bytes"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    scls = (cluster.StreamedSerfSimulation if kind == "serf"
            else cluster.StreamedSimulation)
    t0 = time.perf_counter()
    sim = scls(cfg, cohort_n=plan.cohort_n, seed=0, layout=plan.layout,
               chunk=plan.chunk)
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0
    start = {i: (cluster._map(torch.clone, sim.cohort_state(i)),
                 sim.gens[i].get_state()) for i in spec["check"]}
    passes = []
    per_cohort = [{f: 0 for f in sim.counters} for _ in range(sim.cohorts)]
    for p in range(spec["passes"]):
        sim.events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = sim.run(spec["ticks"])
        wall = time.perf_counter() - t0
        line = dict(wall_s=wall, summary_wall_s=summary["wall_s"],
                    **stream_timeline(sim.events))
        passes.append(line)
        for i, row in enumerate(sim.cohort_counters):
            for f, v in row.items():
                per_cohort[i][f] += v
    sim.events = None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(cuda_gossip_counts()[0])
    kernel_launches = sim._tick_fn.launches
    res.update(cohorts=sim.cohorts, cohort_n=sim.cohort_n,
               passes=passes, peak_bytes=peak,
               resident_bytes_model=sim.resident_bytes(),
               pinned_host_bytes=sim.archive_bytes(),
               launches=launches, kernel_launches=kernel_launches)
    # The resident twins: each checked cohort as one resident simulation.
    rcls = cluster.SerfSimulation if kind == "serf" else cluster.Simulation
    draw = serf.draw_serf_tick if kind == "serf" else swim.draw_tick
    bad, tick_ms = [], None
    total = spec["passes"] * spec["ticks"]
    for i, (st, gstate) in start.items():
        g = torch.Generator(device="cuda")
        g.set_state(gstate)
        ccfg = sim.cohort_cfg
        twin = rcls(ccfg, seed=0, topo=sim.topo, world=sim._world_of(i),
                    state=cluster._map(lambda x: x.to("cuda"), st),
                    draws=lambda _t, g=g, ccfg=ccfg: draw(ccfg, g, "cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin.run(total, chunk=plan.chunk, with_metrics=False)
        torch.cuda.synchronize()
        if tick_ms is None:
            tick_ms = (time.perf_counter() - t0) / total * 1e3
        got = cluster._map(lambda x: x.to("cuda"), sim.cohort_state(i))
        diff = tree_diff(got, twin._whole())
        bad += [f"cohort {i}: {x}" for x in diff]
        if twin.counters != per_cohort[i]:
            bad.append(f"cohort {i}: counters")
        del twin, got
    res["mismatches"] = bad[:10]
    res["resident_ms_per_tick"] = tick_ms
    res["pass_wall_predicted_s"] = sim.cohorts * spec["ticks"] * tick_ms / 1e3
    res["plan_ok"] = plan_ok
    res["ok"] = (plan_ok and not bad and peak <= plan.resident_bytes
                 and kernel_launches > 0 and tick_launches(launches) > 0
                 and all(c["probes_sent"] > 0 for c in per_cohort))
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_timing(cfg, world, topo, state, draws, rate):
    """B7 on the main path's state at 1M, at each shard count of SHARDS
    and under each grouping of GROUPINGS, on one card: launches and
    exchange copies a tick, ms a tick (CUDA events over back-to-back
    calls), the device's own time and operations a tick (profiler), the
    exchanges and the launch sets apart (event marks inside the call), and
    the bound: the tick's least bytes (tick_hbm_bytes_per_node) plus the
    exchanges' under that grouping (exchange_bytes_per_node); each
    launch's least bytes are kept as a breakdown. Beside them, in the same
    call, the one-device kernel's ms a tick on the same state and draws
    (B1) and the sharded plain runner's ms at each shard count."""
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.parallel import mesh as mesh_mod, shard_step

    n = cfg.n
    tick = cuda_gossip.make_tick_kernel(cfg, topo)
    out = {"b1_ms_per_tick": cuda_ms(lambda: tick(world, state, draws), 20)}
    tick_pn = cuda_gossip.tick_hbm_bytes_per_node(state, world)
    stages = [k for k in cuda_gossip.STAGES
              if k not in ("chaos_pre", "serf_post") + B8_STAGES]
    whole_out = tick(world, state, draws)[0]
    bytes_pn = {k: cuda_gossip.launch_hbm_bytes_per_node(
        k, state, world, draws, cfg=cfg, out=whole_out) for k in stages}
    del whole_out
    for r in SHARDS:
        mesh = mesh_mod.make_mesh(["cuda:0"] * r)
        for grouping in GROUPINGS:
            groups = group_of(mesh, grouping)
            k7 = cuda_gossip.ShardedTickKernel(cfg, topo, mesh, groups=groups)
            k7.set_world(world)
            blocks = shard_step.place(mesh, state, n, groups=groups)
            launches, copies = k7.launches, k7.copies
            k7(blocks, draws)
            per_tick = dict(launches=k7.launches - launches,
                            copies=k7.copies - copies)
            ms = cuda_ms(lambda: k7(blocks, draws), 20)
            # The device's own time a tick (kernels and copies, profiler),
            # apart from the host's: back-to-back calls wait on the host
            # when it is the slower side.
            dev_ms, dev_ops = device_kernels(lambda: k7(blocks, draws), 5)
            k7.events = []
            for _ in range(10):
                k7(blocks, draws)
            torch.cuda.synchronize()
            parts = {}
            marks = k7.events
            k7.events = None
            for (label, a), (_, b) in zip(marks, marks[1:]):
                if label != "end":
                    parts[label] = parts.get(label, 0.0) + a.elapsed_time(b) / 10
            exch_pn = {k: cuda_gossip.exchange_bytes_per_node(
                k, state, cfg=cfg, groups=groups) for k in stages}
            bound_ms = (tick_pn + sum(exch_pn.values())) * n / rate * 1e3
            res = dict(
                groups=len(groups), per_tick=per_tick, ms_per_tick=ms,
                device_ms=dev_ms, device_ops=dev_ops, bound_ms=bound_ms,
                ms_exchange=sum(v for k, v in parts.items()
                                if k.startswith("exchange")),
                ms_launches=sum(v for k, v in parts.items()
                                if k.startswith("launch")),
                ms_by_part=parts, tick_bytes_per_node=tick_pn,
                bytes_per_node=bytes_pn, exchange_bytes_per_node=exch_pn)
            if grouping == "device":
                runner = shard_step.make_sharded_chunk_runner(
                    cfg, topo, mesh, world, kernel="torch")
                res["plain_ms"] = cuda_ms(
                    lambda: runner.run(blocks, lambda _t: draws, 0, 1), 2)
                del runner
            out[str(r) if grouping == "device" else f"{r}/{grouping}"] = res
            del k7, blocks
            torch.cuda.empty_cache()
    return out


def b7_ticks_of(launches) -> int:
    """B7's tick launches in a SHARDED_LAUNCHES snapshot (its SLO folds
    apart)."""
    return sum(v for k, v in launches.items() if k != "slo_fold")


def sharded_main_path(cfg, ref):
    """The main path through Simulation(mesh=["cuda:0"] * SHARD_MAIN): the
    same seed, 64 ticks, a 5 % kill, run_until_converged(4096, chunk=128),
    every tick through B7 (the card's shards in one device group); it must
    converge at the one-device run's tick (``ref``) with bit-equal
    counters and final state. Reports wall and ms a tick on the host
    clock and peak bytes beside the one-device run's, B7's launches and
    exchange copies (a tick and in all) and host syncs per chunk (with
    metrics and without)."""
    from consul_tpu_torch.models import cluster, layout
    from consul_tpu_torch.ops import cuda_gossip

    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda",
                             mesh=["cuda:0"] * SHARD_MAIN)
    setup_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    mask = torch.zeros(cfg.n, dtype=torch.bool)
    mask[: cfg.n // 20] = True
    sim.kill(mask)
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    b7 = dict(cuda_gossip.SHARDED_LAUNCHES)
    copies = sim._tick_fn._tick.copies
    launches = dict(cuda_gossip.LAUNCHES)
    diff = tree_diff(ref["state"], sim._whole())
    counters_equal = sim.counters == ref["counters"]
    syncs = {"with_metrics": sync_count(lambda: sim.run(128, chunk=128)),
             "without_metrics": sync_count(
                 lambda: sim.run(128, chunk=128, with_metrics=False))}
    sim.counters  # flush the deferred chunk
    b7_ticks = b7_ticks_of(b7)
    res = dict(n=cfg.n, k=cfg.degree, shards=SHARD_MAIN, converged=converged,
               ticks_after_kill=used, ticks_one_device=ref["used"],
               ticks_total=ref["t"], agreement=float(trace.agreement[-1]),
               rmse_ms=float(trace.rmse[-1]) * 1000.0,
               state_bit_equal=not diff, differing_leaves=diff[:5],
               counters_equal=counters_equal, wall_s=round(wall, 3),
               ms_per_tick=wall * 1e3 / ref["t"], setup_s=round(setup_s, 3),
               peak_bytes=peak, peak_over_start_bytes=peak - start_bytes,
               one_device=dict(wall_s=round(ref["wall"], 3),
                               ms_per_tick=ref["wall"] * 1e3 / ref["t"],
                               peak_bytes=ref["peak"],
                               peak_over_start_bytes=ref["peak_over_start"]),
               groups=len(sim._tick_fn._tick.groups),
               b7_launches_per_tick=b7_ticks_of(b7) / ref["t"],
               b7_copies=copies, b7_launches=b7, launches=launches,
               host_syncs_per_chunk=syncs,
               bytes_per_node=layout.bytes_per_node(sim._whole(), cfg.n))
    # One device group: the one-device launch set a tick, no exchange.
    res["ok"] = (converged and used == ref["used"] and not diff
                 and counters_equal and b7_ticks == 3 * ref["t"]
                 and copies == 0 and launches["metrics"] > 0)
    world, topo, state = sim.world, sim.topo, sim._whole()
    del sim
    torch.cuda.empty_cache()
    return res, (world, topo, state)


def mesh_base(cfg, device="cuda", kernel="cuda"):
    """The mesh_planes phases' starting point: the one-device Simulation
    of seed 0 after 64 ticks and the 5 % kill (the main path's), as its
    world, topology, packed state and generator state. ``device="cpu",
    kernel="torch"`` rehearses the phases on the CPU at a small n."""
    from consul_tpu_torch.models import cluster

    sim = cluster.Simulation(cfg, seed=0, device=device, kernel=kernel)
    sim.run(64, chunk=64, with_metrics=False)
    sim.kill(torch.arange(cfg.n) < cfg.n // 20)
    _sync(sim.device)
    return dict(cfg=cfg, world=sim.world, topo=sim.topo,
                state=cluster._clone(sim.state), device=sim.device,
                kernel=kernel, generator=sim.generator_state(), t=sim._t)


def mesh_twin(base, grouping, shards=MESH_SHARDS):
    """A Simulation at ``base``'s point: on one device (``grouping``
    None) or on ``shards`` shards of cuda:0 under ``grouping``
    (GROUPINGS)."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.parallel import mesh as mesh_mod

    dev = base["device"]
    mesh = (None if grouping is None
            else mesh_mod.make_mesh([dev] * shards))
    sim = cluster.Simulation(
        base["cfg"], seed=0, world=base["world"], topo=base["topo"],
        state=cluster._clone(base["state"]), mesh=mesh, device=dev,
        kernel=base["kernel"],
        groups=None if mesh is None else group_of(mesh, grouping))
    sim.load_state(cluster._clone(base["state"]), base["generator"])
    return sim


def _events_ms(fn, device) -> float:
    """ms of one call of ``fn`` by CUDA events (the host clock, with the
    work waited for, off the card)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sharded_raft(base):
    """The raft tier on the sharded Simulation: for each of MESH_RAFT
    (R = 16 x 5, group-sharded over 4 shards, and R = 6 x 5, replicated),
    raft_parity's leader-kill drill (raft_events, shifted onto the live
    tick) and its proposals over MESH_RAFT_TICKS ticks in chunks of
    RAFT_PARITY_CHUNK, on one device and on 4 shards under each grouping
    from the same point; every gossip and raft leaf, the gossip and raft
    counters and the raft summary of each sharded run equal the
    one-device run's. Then ms a tick with raft (CUDA events over one more
    chunk), and B7's launches in the drill."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import layout
    from consul_tpu_torch.ops import cuda_gossip

    cfg = base["cfg"]
    out = []
    launches = 0
    for groups, peers in MESH_RAFT:
        runs = {}
        for grouping in (None,) + GROUPINGS:
            sim = mesh_twin(base, grouping)
            plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
            sim.set_chaos(chaos.shift_schedule(chaos.compile_schedule(
                cfg.n, raft_events(chaos)), sim._t))
            reset_launches()
            t0 = time.perf_counter()
            for c in range(MESH_RAFT_TICKS // RAFT_PARITY_CHUNK):
                for g in range(groups):
                    if c in RAFT_PARITY_PROPOSALS:
                        plane.propose([(0, 0, 0)] * RAFT_PARITY_PROPOSALS[c],
                                      group=g)
                sim.run(RAFT_PARITY_CHUNK, chunk=RAFT_PARITY_CHUNK,
                        with_metrics=False)
            _sync(sim.device)
            wall = time.perf_counter() - t0
            b7 = b7_ticks_of(cuda_gossip.SHARDED_LAUNCHES)
            launches += b7
            ms = _events_ms(lambda: sim.run(
                RAFT_PARITY_CHUNK, chunk=RAFT_PARITY_CHUNK,
                with_metrics=False), sim.device) / RAFT_PARITY_CHUNK
            runs[grouping or "one_device"] = dict(
                state=sim._whole(), raft=plane.whole_state(),
                counters=dict(sim.counters),
                raft_counters=plane.counters_snapshot(),
                summary=plane.summary(), wall_s=round(wall, 3),
                ms_per_tick=ms, b7_launches=b7,
                sharded=None if plane.arm is None else plane.arm.sharded)
            del sim, plane
            _empty_cache()
        one = runs.pop("one_device")
        res = dict(groups=groups, peers=peers, window=RAFT_WINDOW,
                   ticks=MESH_RAFT_TICKS, shards=MESH_SHARDS,
                   summary=one["summary"], raft_counters=one["raft_counters"],
                   ms_per_tick_one_device=one["ms_per_tick"])
        ok = (one["raft_counters"]["elections_won"] > groups
              and all(x >= 0 for x in one["summary"]["leaders"]))
        for name, r in runs.items():
            diff = tree_diff(one["state"], r["state"])
            rdiff = [f for f, a, b in zip(one["raft"]._fields, one["raft"],
                                          r["raft"]) if not torch.equal(a, b)]
            eq = dict(state_bit_equal=not diff, differing_leaves=diff[:5],
                      raft_differing=rdiff,
                      counters_equal=r["counters"] == one["counters"],
                      raft_counters_equal=(r["raft_counters"]
                                           == one["raft_counters"]),
                      summary_equal=r["summary"] == one["summary"])
            res[name] = dict(eq, ms_per_tick=r["ms_per_tick"],
                             wall_s=r["wall_s"], b7_launches=r["b7_launches"],
                             group_sharded=r["sharded"])
            ok = ok and not diff and not rdiff and all(
                v for k, v in eq.items() if k.endswith("equal")) and (
                r["b7_launches"] > 0 or base["kernel"] != "cuda") and (
                r["sharded"] == (groups % MESH_SHARDS == 0))
        res["ok"] = ok
        out.append(res)
    return out, launches


def sharded_serving(base):
    """The serving plane on the sharded Simulation at the state after the
    5 % kill: a write-attached ServingPlane(k=SERVING_K,
    buckets=(SERVING_BATCH,)) on one device and on 4 shards under each
    grouping; SERVING_BATCH NEAREST queries from random.Random(0) sources
    (ids equal, rtts within SERVING_RTOL relative), then one write batch
    (MIXED_SERVICES registrations and KV puts) and a flip (one chunk):
    the apply index and every KV read equal. Batch ms (CUDA events over
    SERVING_REPS // 4 batches), the peak of one batch's temporaries, and
    B7's launches in the flips."""
    import numpy as np

    from consul_tpu_torch.ops import cuda_gossip, serving
    from consul_tpu_torch.serving import MODE_NEAREST, ServingPlane

    n = base["cfg"].n
    dev = base["device"]
    srng = random.Random(0)
    queries = [(MODE_NEAREST, srng.randrange(n), -1)
               for _ in range(SERVING_BATCH)]
    runs = {}
    launches = 0
    for grouping in (None,) + GROUPINGS:
        sim = mesh_twin(base, grouping)
        plane = ServingPlane(k=SERVING_K, buckets=(SERVING_BATCH,),
                             num_services=MIXED_SERVICES, device=dev)
        sim.attach_serving(plane, writes=True, kv_slots=MIXED_KV_SLOTS)
        got = plane.batcher.execute(queries)
        reps = max(1, SERVING_REPS // 4)
        ms = _events_ms(lambda: [plane.batcher.execute(queries)
                                 for _ in range(reps)], dev) / reps
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            plane.batcher.execute(queries)
            peak = torch.cuda.max_memory_allocated() - start
        for i in range(MIXED_SERVICES):
            plane.register(i * 7 + 1, i)
            plane.kv_put(f"k{i}", 100 + i)
        reset_launches()
        sim.run(RAFT_PARITY_CHUNK, chunk=RAFT_PARITY_CHUNK, with_metrics=False)
        _sync(dev)
        launches += b7_ticks_of(cuda_gossip.SHARDED_LAUNCHES)
        snap = plane.snapshot()
        runs[grouping or "one_device"] = dict(
            ids=np.stack([r.ids for r in got]),
            rtts=np.stack([r.rtts for r in got]),
            count=[r.count for r in got], apply_index=plane.apply_index,
            kv=[plane.kv_get(f"k{i}") for i in range(MIXED_SERVICES)],
            health=plane.health_nodes(1).nodes[:SERVING_K],
            batch_ms=ms, peak_temp_bytes=peak,
            executor=getattr(plane.kernel(), "func", plane.kernel()).__name__,
            parts=len(getattr(snap, "parts", [snap])),
            snapshot_bytes=serving.snapshot_bytes(snap))
        plane.close()
        del sim, plane, snap
        _empty_cache()
    one = runs.pop("one_device")
    res = dict(n=n, batch=SERVING_BATCH, k=SERVING_K, shards=MESH_SHARDS,
               rtol=SERVING_RTOL, batch_ms_one_device=one["batch_ms"],
               peak_temp_bytes_one_device=one["peak_temp_bytes"],
               apply_index=one["apply_index"],
               temp_budget_bytes=serving.TEMP_BUDGET_BYTES)
    ok = one["apply_index"] == 2 * MIXED_SERVICES and all(
        v is not None for v in one["kv"])
    for name, r in runs.items():
        ids_equal = bool(np.array_equal(r["ids"], one["ids"]))
        fin = np.isfinite(one["rtts"])
        rel = float(np.max(np.abs(r["rtts"][fin] - one["rtts"][fin])
                           / np.maximum(np.abs(one["rtts"][fin]), 1e-30),
                           initial=0.0))
        res[name] = dict(ids_equal=ids_equal, max_rel_rtt=rel,
                         inf_equal=bool(np.array_equal(
                             np.isinf(r["rtts"]), ~fin)),
                         count_equal=r["count"] == one["count"],
                         apply_index_equal=r["apply_index"] == one["apply_index"],
                         kv_equal=r["kv"] == one["kv"],
                         health_equal=r["health"] == one["health"],
                         batch_ms=r["batch_ms"],
                         peak_temp_bytes=r["peak_temp_bytes"],
                         executor=r["executor"], parts=r["parts"])
        ok = ok and ids_equal and rel <= SERVING_RTOL and all(
            res[name][k] for k in ("inf_equal", "count_equal",
                                   "apply_index_equal", "kv_equal",
                                   "health_equal")) and (
            r["executor"] == "execute_sharded" and (
                r["peak_temp_bytes"] is None
                or r["peak_temp_bytes"] <= serving.TEMP_BUDGET_BYTES + (1 << 30)))
    res["ok"] = ok
    return res, launches


def sharded_sweep(base):
    """A sweep on the sharded Simulation: lanes MESH_SWEEP_LANES of
    bench_pareto's SWEEP_LANES-lane grid for MESH_SWEEP_TICKS ticks from
    the state after the kill, on one device and on 4 shards under each
    grouping (the lane runner under run_sweep); every lane's counters and
    final state equal the one-device sweep's and the simulation is unmoved.
    ms a lane-tick (host clock around the lanes, synchronized), B7's
    launches (the chaos variant, sentinel off)."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.chaos import sweep
    from consul_tpu_torch.models.counters import FIELDS
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.parallel import shard_step

    n = base["cfg"].n
    grid = sweep.scenario_grid(n, SWEEP_LANES)
    scens = [grid[i] for i in MESH_SWEEP_LANES]
    runs = {}
    launches = 0
    for grouping in (None,) + GROUPINGS:
        sim = mesh_twin(base, grouping)
        before = _sim_point(sim)
        scheds, _ = sweep.compile_scenarios(sim, scens)
        reset_launches()
        _sync(sim.device)
        t0 = time.perf_counter()
        states, cnt, _ = sim._run_lanes(scheds, MESH_SWEEP_TICKS)
        _sync(sim.device)
        wall = time.perf_counter() - t0
        b7 = b7_ticks_of(cuda_gossip.SHARDED_LAUNCHES)
        launches += b7
        if grouping is not None:
            states = [shard_step.gather(x, n, sim.device) for x in states]
        runs[grouping or "one_device"] = dict(
            states=states, cnt=cnt.cpu(), unmoved=_unmoved(sim, before),
            ms_per_lane_tick=wall * 1e3 / (MESH_SWEEP_TICKS * len(scens)),
            b7_launches=b7, chaos_pre=cuda_gossip.SHARDED_LAUNCHES["chaos_pre"])
        del sim
        _empty_cache()
    one = runs.pop("one_device")
    rows = one["cnt"].tolist()
    res = dict(n=n, lanes=list(MESH_SWEEP_LANES), ticks=MESH_SWEEP_TICKS,
               shards=MESH_SHARDS,
               ms_per_lane_tick_one_device=one["ms_per_lane_tick"],
               fault_ticks=[r[FIELDS.index("chaos_fault_ticks")] for r in rows],
               msgs_dropped=[r[FIELDS.index("chaos_msgs_dropped")]
                             for r in rows])
    ok = one["unmoved"] and all(x > 0 for x in res["fault_ticks"])
    for name, r in runs.items():
        bad = lanes_diverge(r["states"], one["states"])
        res[name] = dict(counters_equal=bool(torch.equal(r["cnt"], one["cnt"])),
                         lanes_bit_equal=bad is None, first_bad=bad,
                         unmoved=r["unmoved"],
                         ms_per_lane_tick=r["ms_per_lane_tick"],
                         b7_launches=r["b7_launches"],
                         chaos_pre_launches=r["chaos_pre"])
        ok = ok and res[name]["counters_equal"] and bad is None and (
            r["unmoved"] and (r["chaos_pre"] > 0 or base["kernel"] != "cuda"))
    res["ok"] = ok
    return res, launches


def elastic_drill(base):
    """run_resilient(mesh=, elastic=) at 1M: MESH_ELASTIC_TICKS ticks after
    the kill, uninterrupted on one device; then, under each grouping, on 4
    shards preempted (SIGTERM) at tick MESH_ELASTIC_STOP of the run, and
    resumed twice from that checkpoint: on 2 shards (the "device" grouping
    through run_resilient(mesh=), the "shard" one through a simulation
    placed under it) and with elastic=True over ["cuda:0"] (one device).
    Every resume ends with the uninterrupted run's state digest, reshards
    == 1 and sim.runtime.reshards == 1; the checkpoint's meta says
    mesh_devices 4. Returns the line and B7's launches in the drill. It
    writes under MESH_DIR and removes it."""
    from consul_tpu_torch import cli as cli_mod
    from consul_tpu_torch import runtime as rt
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.parallel import mesh as mesh_mod
    from consul_tpu_torch.utils import checkpoint as ckpt

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), MESH_DIR)
    shutil.rmtree(d, ignore_errors=True)
    ref = mesh_twin(base, None)
    t0 = time.perf_counter()
    rt.run_resilient(ref, MESH_ELASTIC_TICKS, chunk=RESILIENT_CHUNK)
    _sync(ref.device)
    res = dict(n=base["cfg"].n, ticks=MESH_ELASTIC_TICKS,
               stop=MESH_ELASTIC_STOP, shards=MESH_SHARDS,
               uninterrupted_s=round(time.perf_counter() - t0, 3),
               digest=cli_mod._state_digest(ref))
    del ref
    _empty_cache()
    ok = True
    reset_launches()

    def policy(tag):
        return rt.CheckpointPolicy(directory=d, tag=tag, min_interval_s=1e9,
                                   trap=rt.SignalTrap())
    for grouping in GROUPINGS:
        tag = f"elastic_{grouping}"
        sim = mesh_twin(base, grouping)
        real_run, stop = sim.run, sim._t + MESH_ELASTIC_STOP

        def run_then_sigterm(*a, _sim=sim, _real=real_run, **kw):
            out = _real(*a, **kw)
            if _sim._t == stop:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        sim.run = run_then_sigterm
        preempted = None
        t0 = time.perf_counter()
        try:
            rt.run_resilient(sim, MESH_ELASTIC_TICKS, chunk=RESILIENT_CHUNK,
                             policy=policy(tag))
        except rt.Preempted as e:
            preempted = e.report.ticks_done
        save_run_s = time.perf_counter() - t0
        del sim
        _empty_cache()
        path = policy(tag).path
        meta = ckpt.read_meta(path) or {}
        kept = path + ".copy"
        shutil.copy(path, kept)
        r = dict(preempted_at=preempted, mesh_devices=meta.get("mesh_devices"),
                 checkpoint_bytes=os.path.getsize(path),
                 preempted_run_s=round(save_run_s, 3))
        good = preempted == MESH_ELASTIC_STOP and meta.get("mesh_devices") == 4
        for resume in ("2_shards", "elastic_one_device"):
            if resume == "elastic_one_device":
                shutil.copy(kept, path)
                sim = mesh_twin(base, None)
                kw = dict(elastic=True, devices=[base["device"]])
            elif grouping == "device":
                sim = mesh_twin(base, None)
                kw = dict(mesh=mesh_mod.make_mesh([base["device"]] * 2))
            else:
                sim = mesh_twin(base, grouping, shards=2)
                kw = {}
            t0 = time.perf_counter()
            rep = rt.run_resilient(sim, MESH_ELASTIC_TICKS,
                                   chunk=RESILIENT_CHUNK, policy=policy(tag),
                                   **kw)
            _sync(sim.device)
            digest = cli_mod._state_digest(sim)
            r[resume] = dict(
                reshards=rep.reshards,
                sink_reshards=sim.sink.counter_sum("sim.runtime.reshards"),
                resumed_from=rep.resumed_from_tick,
                width=1 if sim.mesh is None else sim.mesh.size,
                digest_equal=digest == res["digest"],
                seconds=round(time.perf_counter() - t0, 3))
            good = good and rep.reshards == 1 and r[resume]["sink_reshards"] == 1 \
                and r[resume]["digest_equal"] \
                and rep.resumed_from_tick == MESH_ELASTIC_STOP
            del sim
            _empty_cache()
        r["ok"] = good
        res[grouping] = r
        ok = ok and good
    shutil.rmtree(d, ignore_errors=True)
    res["ok"] = ok
    return res, b7_ticks_of(cuda_gossip.SHARDED_LAUNCHES)


def _empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def mesh_planes(cfg, device="cuda", kernel="cuda"):
    """ROADMAP A13 items 1, 2, 3 and 5 at 1M on MESH_SHARDS shards of the
    one card, each phase under both groupings and held to the one-device
    Simulation of the same seed: sharded_raft, sharded_serving,
    sharded_sweep, elastic_drill. Returns the phases' lines, B7's
    launches in them and their seconds."""
    base = mesh_base(cfg, device, kernel)
    lines, launches = [], 0
    t0 = time.perf_counter()
    raft, n = sharded_raft(base)
    launches += n
    lines += [dict(phase="sharded_raft", **r) for r in raft]
    for phase, fn in (("sharded_serving", sharded_serving),
                      ("sharded_sweep", sharded_sweep),
                      ("elastic_drill", elastic_drill)):
        t1 = time.perf_counter()
        res, n = fn(base)
        launches += n
        res["seconds"] = round(time.perf_counter() - t1, 3)
        lines.append(dict(phase=phase, **res))
    del base
    _empty_cache()
    return lines, launches, round(time.perf_counter() - t0, 3)


def lens_ids(n: int) -> tuple:
    """The lens parity's rows: normalize_ids(n, LENS_S), rows 1 and n - 1."""
    from consul_tpu_torch.obs import lens

    return tuple(sorted(set(lens.normalize_ids(n, LENS_S)) | {1, n - 1}))


def lens_window(name: str, sim, kill_frac: int = 0):
    """Launch L against its plain version (obs.lens.snapshot_packed) on
    ``sim``'s packed state after each of LENS_WINDOW ticks, each run
    through the simulation's own CUDA tick (one tick a chunk), at
    lens_ids(n): the rows bit for bit. With ``kill_frac`` the first
    n // kill_frac rows are killed before the window. Also counts the
    sampled rows that are dead, hold a suspicion, have a probe in flight
    or a nonzero Lamport clock (the decoded cases the window reached)."""
    from consul_tpu_torch.obs import lens
    from consul_tpu_torch.ops import cuda_gossip

    n = sim.cfg.n
    if kill_frac:
        sim.kill(torch.arange(n) < n // kill_frac)
    ids = lens_ids(n)
    kernel = cuda_gossip.make_lens_kernel(sim.cfg)
    out = torch.empty((len(ids), 7), device="cuda")
    bad, err = 0, 0.0
    seen = torch.zeros(4, dtype=torch.int64, device="cuda")
    t0 = sim._t
    for _ in range(LENS_WINDOW):
        sim.run(1, chunk=1, with_metrics=False)
        packed, clock = sim._swim_at_rest(), sim._clock_of(sim.state)
        kernel(packed, clock, ids, out)
        want = lens.snapshot_packed(packed, clock, ids)
        bad += int((out.view(torch.int32) != want.view(torch.int32))
                   .any(1).sum())
        err = max(err, float(torch.nan_to_num((out - want).abs()).max()))
        seen += torch.stack([(want[:, 0] == 0).sum(), (want[:, 2] >= 0).sum(),
                             (want[:, 3] >= 0).sum(), (want[:, 4] > 0).sum()])
    torch.cuda.synchronize()
    return dict(state=name, n=n, k=sim.cfg.degree, window=[t0, sim._t],
                ids=list(ids), mismatched_rows=bad, max_abs_err=err,
                row_ticks=dict(zip(("dead", "suspicion_open", "probe_in_flight",
                                    "lamport_nonzero"), seen.tolist())),
                ok=bad == 0)


def lens_parity(cfg):
    """lens_window on four states: the SWIM path's after a 5 % kill, the
    serf path's after an event storm (its Lamport clock nonzero), the
    chaos + sentinel variant's inside the parity schedule, and the dense
    view's at n = DENSE_N after a 5 % kill."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster

    n = cfg.n
    out = []
    sim = cluster.Simulation(cfg, seed=5)
    sim.run(64, chunk=64, with_metrics=False)
    out.append(lens_window("swim_after_kill", sim, kill_frac=20))
    del sim
    sim = cluster.SerfSimulation(cfg, seed=7)
    sim.run(32, chunk=32, with_metrics=False)
    sim.user_event(_rows(n, range(n // 3, n // 3 + 64), "cpu"), 5)
    sim.leave(_rows(n, [n // 2 + 1], "cpu"))
    out.append(lens_window("serf", sim))
    del sim
    sim = cluster.Simulation(cfg, seed=9)
    sim.set_sentinel(True)
    sim.set_chaos(chaos_events(chaos, n, 64))
    sim.run(16, chunk=16, with_metrics=False)
    out.append(lens_window("chaos_sentinel", sim))
    del sim
    sim = cluster.Simulation(SimConfig(n=DENSE_N), seed=11)
    sim.run(32, chunk=32, with_metrics=False)
    out.append(lens_window("dense", sim, kill_frac=20))
    del sim
    torch.cuda.empty_cache()
    return out


def lens_main_path(cfg, ref):
    """The SWIM north star (as main_path: seed 0, 64 ticks, a 5 % kill,
    run_until_converged(4096, chunk=128)) with set_lens(LENS_S) armed: it
    must converge on the unarmed run's tick (``ref``) with bit-equal state
    and counters, record every tick, and launch L once a tick; then a
    metrics-off chunk with the lens armed must make no host sync. Returns
    the result and the simulation."""
    import numpy as np

    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip

    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda")
    ids = sim.set_lens(LENS_S)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    mask = torch.zeros(cfg.n, dtype=torch.bool)
    mask[: cfg.n // 20] = True
    sim.kill(mask)
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_gossip.LAUNCHES)
    diff = tree_diff(ref["state"], sim.state)
    counters_equal = sim.counters == ref["counters"]
    recorded = sim.lens.ticks_recorded
    t_run = sim._t
    syncs = sync_count(lambda: sim.run(128, chunk=128, with_metrics=False))
    sim.counters  # flush the deferred chunk
    ticks, vals = sim.lens.timelines()
    res = dict(n=cfg.n, k=cfg.degree, lens_ids=len(ids), converged=converged,
               ticks_after_kill=used, ticks_unarmed=ref["used"],
               ticks_total=t_run, state_bit_equal=not diff,
               differing_leaves=diff[:5], counters_equal=counters_equal,
               ticks_recorded=recorded, lens_launches=launches["lens"],
               tick_launches=tick_launches(launches),
               host_syncs_metrics_off_chunk=syncs,
               ticks_recorded_after=sim.lens.ticks_recorded,
               finite=bool(np.isfinite(vals).all()),
               dead_at_end=int((vals[-1, :, 0] == 0).sum()),
               wall_s=round(wall, 3), wall_unarmed_s=round(ref["wall"], 3))
    res["ok"] = (converged and used == ref["used"] and not diff
                 and counters_equal and recorded == t_run
                 and launches["lens"] == t_run and syncs == 0
                 and res["ticks_recorded_after"] == t_run + 128
                 and ticks[-1] == t_run + 127 and res["finite"])
    return res, sim


def lens_launch_timing(sim, rate):
    """Launch L on ``sim``'s packed state at its armed ids: "ms", its own
    device time (profiler; None when it records none); "ms_events", CUDA
    events around back-to-back calls, the wrapper's host work included;
    its plain version's ms; and the bound, lens_hbm_bytes over the card's
    memory rate."""
    from consul_tpu_torch.obs import lens
    from consul_tpu_torch.ops import cuda_gossip

    ids = sim.lens.ids
    packed, clock = sim._swim_at_rest(), sim._clock_of(sim.state)
    kernel = cuda_gossip.make_lens_kernel(sim.cfg)
    idx = torch.tensor(ids, device="cuda")
    out = torch.empty((len(ids), 7), device="cuda")

    def call():
        return kernel(packed, clock, ids, out)
    prof = launch_breakdown(call, 20)
    res = {"s": len(ids), "ms_events": cuda_ms(call, 50),
           "plain_ms": cuda_ms(lambda: lens.snapshot_packed(packed, clock, idx),
                               5),
           "bytes": cuda_gossip.lens_hbm_bytes(packed, ids, clock)}
    dev = prof if isinstance(prof, dict) else {}
    res["ms"] = next((v for k, v in dev.items() if k.startswith("k_lens")), None)
    res["bound_ms"] = res["bytes"] / rate * 1e3
    return res


def tick_with_and_without_lens(sim):
    """Device ms per tick (CUDA events around whole runs) of ``sim.run``
    without metrics, with set_lens(LENS_S) armed and without, in turns
    off, on, on, off, LENS_TIMED_TICKS ticks each."""
    out = {False: [], True: []}
    for on in (False, True, True, False):
        sim.set_lens(LENS_S if on else 0)
        ms = cuda_ms(lambda: sim.run(LENS_TIMED_TICKS, chunk=LENS_TIMED_TICKS,
                                     with_metrics=False), 1)
        out[on].append(ms / LENS_TIMED_TICKS)
    sim.set_lens(0)
    off, on = (sum(out[k]) / 2 for k in (False, True))
    return {"off_ms": out[False], "on_ms": out[True], "ratio": on / off}


def _kernel_counts(pairs):
    """Launches by kernel name (the part before its argument list), from
    (name, launches) pairs."""
    counts = {}
    for name, c in pairs:
        base = name.split("(")[0]
        counts[base] = counts.get(base, 0) + c
    return counts


def profile_per_tick(events, ticks: int):
    """Where ``ticks`` profiled ticks' time went, from the Chrome trace's
    events: device ms a tick by kernel (summed durations), the tick's own
    launches (A, B, C), L and the rest (the draw bundle's and counters'
    kernels) apart, the device window a tick (first kernel start to last
    kernel end) and the device's idle share in it, and the host's
    ``sim_chunk`` range a tick (its enqueue window, profiler overhead
    included)."""
    ks = [e for e in events if e.get("cat") == "kernel"]
    by = {}
    for e in ks:
        base = e["name"].split("(")[0]
        by[base] = by.get(base, 0.0) + e["dur"] / 1e3 / ticks
    busy = sum(by.values())
    window = (max(e["ts"] + e["dur"] for e in ks)
              - min(e["ts"] for e in ks)) / 1e3 / ticks
    tick = sum(by.get(k, 0.0) for k in ("k_probe_send", "k_receive",
                                        "k_pushpull"))
    lens = by.get("k_lens", 0.0)
    host = [e["dur"] / 1e3 / ticks for e in events
            if e.get("name") == "sim_chunk" and e.get("cat") == "user_annotation"]
    return dict(by_kernel={k: round(v, 5) for k, v in sorted(
                    by.items(), key=lambda kv: -kv[1])},
                tick_launches_ms=tick, lens_ms=lens,
                other_kernels_ms=busy - tick - lens, device_busy_ms=busy,
                device_window_ms=window, idle_share=1.0 - busy / window,
                host_sim_chunk_ms=host[0] if host else None)


def trace_capture(sim, build_spans, compiled):
    """The tracer on the card: the ``cuda.build`` spans read right after
    this run's build, one if it compiled (``compiled``) and none if it
    loaded an earlier build; a run of LENS_TRACE_CHUNKS chunks with the lens
    armed (LENS_TRACE_IDS rows), exported with its counter tracks, read
    back: the schema, one ``chunk`` span a chunk with consecutive steps,
    a track per (row, field); then utils/debug.capture_sim with
    PROFILE_TICKS profiled ticks, whose Chrome trace must hold each tick
    launch and L once a tick and the ``sim_chunk`` range. TRACE_DIR is
    removed after."""
    from consul_tpu_torch.obs import trace as obs_trace
    from consul_tpu_torch.utils import debug

    tr = obs_trace.get_tracer()
    res = {"build_spans": build_spans, "compiled": compiled}
    try:
        ids = sim.set_lens(LENS_TRACE_IDS)
        tr.clear()
        seq0 = sim._chunk_seq
        sim.run(LENS_TRACE_CHUNKS * LENS_TRACE_CHUNK, chunk=LENS_TRACE_CHUNK,
                with_metrics=False)
        path = tr.export(os.path.join(TRACE_DIR, "sim.json"),
                         extra_events=sim.lens.to_trace_events())
        with open(path) as f:
            doc = json.load(f)
        evs = doc["traceEvents"]
        chunks = [e for e in evs if e.get("name") == "chunk"]
        tracks = {e["name"] for e in evs
                  if e.get("cat") == "lens" and e.get("ph") == "C"}
        want = {f"node{i}/{f}" for i in ids for f in sim.lens.fields}
        res.update(trace_bytes=os.path.getsize(path), events=len(evs),
                   other=doc.get("otherData"),
                   chunk_spans=len(chunks),
                   chunk_steps=[e["args"]["step"] for e in chunks],
                   chunk_ms=[round(e["dur"] / 1e3, 3) for e in chunks],
                   lens_tracks=len(tracks))
        schema = (set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
                  and doc["otherData"]["schema_version"] == 1
                  and doc["otherData"]["producer"] == obs_trace.PRODUCER
                  and doc["otherData"]["dropped_events"] == 0)
        t0 = time.perf_counter()
        files = debug.capture_sim(sim, profile_ticks=PROFILE_TICKS,
                                  trace_dir=os.path.join(TRACE_DIR, "profile"))
        res["capture_s"] = round(time.perf_counter() - t0, 3)
        with open(files["profile.json"]["trace"]) as f:
            prof = json.load(f)["traceEvents"]
        kernels = _kernel_counts(files["profile.json"]["kernels"].items())
        res.update(profile_kernels=kernels,
                   profile_per_tick=profile_per_tick(prof, PROFILE_TICKS),
                   sim_chunk_ranges=sum(e.get("name") == "sim_chunk"
                                        for e in prof),
                   bundle=sorted(files),
                   health=files["health.json"])
        launched = ("k_probe_send", "k_receive", "k_pushpull", "k_lens")
        built_ok = (len(build_spans) == 1 and build_spans[0]["dur"] > 0
                    if compiled else not build_spans)
        res["ok"] = (built_ok
                     and schema and len(chunks) == LENS_TRACE_CHUNKS
                     and res["chunk_steps"] == list(range(
                         seq0, seq0 + LENS_TRACE_CHUNKS))
                     and tracks == want
                     and all(kernels.get(k) == PROFILE_TICKS
                             for k in launched)
                     and res["sim_chunk_ranges"] >= 1
                     and "lens.json" in files)
    finally:
        sim.set_lens(0)
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    return res


def blackbox_live():
    """obs.blackbox.capture in this process, the card up: CUDA initialized
    and the card's name among the devices, the environment only the
    bring-up prefixes, torch's and nvcc's versions found."""
    from consul_tpu_torch.obs import blackbox

    box = blackbox.capture()
    dev = box["devices"]
    res = dict(devices=dev, cuda=box["cuda"], env_keys=sorted(box["env"]),
               spans=len(box["spans"]), keys=sorted(box))
    res["ok"] = (dev["torch_imported"] and dev["cuda_initialized"]
                 and torch.cuda.get_device_name(0) in dev["devices"]
                 and all(k.startswith(blackbox._ENV_PREFIXES)
                         for k in box["env"])
                 and box["cuda"]["torch"] == torch.__version__
                 and bool(box["cuda"]["nvcc"]))
    return res


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _scaled_origins(n):
    """tests/test_serf_fused.py:54-59's origins (rows 0, 97 and N - 1 of
    N = 4096; the query from row 9) scaled to ``n``."""
    events = [(0, 11), (97 * n // 4096, 42), (n - 1, 7)]
    return events, (9 * n // 4096, 3)


def _covered(sim, keys):
    from consul_tpu_torch.models import serf

    st = sim.serf_state
    return [float(serf.event_coverage(sim.cfg, st, k, o)) for k, o in keys]


def serf_reference_parity(cfg, with_chaos, device="cuda", kernel="cuda"):
    """SerfSimulation (the fused tick; B4 on the card) against
    ReferenceSerfSimulation (the pre-fusion oracle; B8 on the card) from
    one seed, so both take the same SWIM draws: three events and an open
    query with chaos off, or the events alone under a link-loss window
    over an eighth of the cluster. Both run in ORACLE_CHUNK-tick steps
    until every fired event covers every live node on both (at most
    ORACLE_MAX ticks). Then the SWIM plane must be bit-equal, and the
    per-node delivered counts, event_clock, ev_floor, q_floor and the SLO
    counters equal; the oracle's ticks launch E1 and E2, never D. The
    plain oracle (``kernel="torch"`` on the same device) then replays
    the oracle's window from the same seed, and its state must equal the
    oracle's bit for bit. ms a tick of each by the host clock over the
    window (ends synchronized); the plain oracle's is ``plain_ms``. On
    the card ``kernel="cuda"`` on the CPU must raise."""
    from consul_tpu_torch import chaos
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, serf
    from consul_tpu_torch.ops import cuda_gossip

    n = cfg.n
    events, query = _scaled_origins(n)
    fused = cluster.SerfSimulation(cfg, seed=ORACLE_SEED, device=device,
                                   kernel=kernel)
    oracle = cluster.ReferenceSerfSimulation(cfg, seed=ORACLE_SEED,
                                             device=device, kernel=kernel)
    plain = cluster.ReferenceSerfSimulation(cfg, seed=ORACLE_SEED,
                                            device=device, kernel="torch")
    refused = True
    if torch.device(device).type == "cuda":
        try:
            cluster.ReferenceSerfSimulation(SimConfig(n=64, view_degree=8),
                                            device="cpu", kernel="cuda")
            refused = False
        except ValueError as e:
            refused = "needs a CUDA device" in str(e)
    fired = []
    for sim in (fused, oracle, plain):
        keys = []
        for row, name in events:
            keys.append((int(serf.make_event_key(int(sim.state.event_clock[row]),
                                                 name)), row))
            sim.user_event(_rows(n, [row], "cpu"), name)
        if not with_chaos:
            sim.query(_rows(n, [query[0]], "cpu"), query[1])
        fired.append(keys)
    fault = [chaos.LinkLoss(start=1, stop=13, a=slice(0, n // 8),
                            b=slice(n // 2, n), fwd=0.5, rev=0.5)]
    walls, cover, used = {}, {}, 0

    def step(name, sim, first):
        _sync(device)
        t0 = time.perf_counter()
        if with_chaos and first:
            sim.run_scenario(fault, ticks=ORACLE_FAULT, chunk=ORACLE_CHUNK)
        else:
            sim.run(ORACLE_CHUNK, chunk=ORACLE_CHUNK, with_metrics=False)
        _sync(device)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0

    reset_launches()
    while used < ORACLE_MAX:
        for name, sim in (("fused", fused), ("oracle", oracle)):
            step(name, sim, used == 0)
        used += ORACLE_FAULT if with_chaos and used == 0 else ORACLE_CHUNK
        cover = {"fused": _covered(fused, fired[0]),
                 "oracle": _covered(oracle, fired[0])}
        if all(c == 1.0 for v in cover.values() for c in v):
            break
    launches = dict(cuda_gossip.LAUNCHES)
    replayed = 0
    while replayed < used:
        step("plain", plain, replayed == 0)
        replayed += ORACLE_FAULT if with_chaos and replayed == 0 else ORACLE_CHUNK
    plain_diff = tree_diff(oracle.state, plain.state)
    a, b = fused.serf_state, oracle.serf_state
    swim_diff = tree_diff(fused.state.swim, oracle.state.swim)
    equal = {f: torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))
             for f in ("ev_delivered", "event_clock", "ev_floor", "q_floor")}
    slo = [{f: sim.counters[f] for f in cluster.SLO_KEYS}
           for sim in (fused, oracle)]
    res = dict(n=n, k=cfg.degree, scenario="chaos_events" if with_chaos
               else "quiet_query", ticks=used, coverage=cover,
               swim_leaves_differing=swim_diff, equal=equal,
               slo=slo[0], slo_equal=slo[0] == slo[1],
               delivered_total=int(a.ev_delivered.to(torch.int64).sum()),
               fused_ms_per_tick=walls["fused"] / used * 1e3,
               oracle_ms_per_tick=walls["oracle"] / used * 1e3,
               plain_ms=walls["plain"] / used * 1e3,
               oracle_wall_s=walls["oracle"], plain_wall_s=walls["plain"],
               oracle_plain_leaves_differing=plain_diff, launches=launches,
               cuda_on_cpu_refused=refused)
    if not with_chaos:
        qkey = int(serf.make_event_key(int(a.query_clock[query[0]]) - 1,
                                       query[1], True))
        res["query_coverage"] = [float(serf.event_coverage(cfg, st, qkey,
                                                           query[0]))
                                 for st in (a, b)]
    ok = (not swim_diff and all(equal.values()) and res["slo_equal"]
          and all(c == 1.0 for v in cover.values() for c in v) and refused
          and all(c == 1.0 for c in res.get("query_coverage", []))
          and not plain_diff)
    if with_chaos:
        ok = ok and slo[0]["chaos_msgs_dropped"] > 0
    if torch.device(device).type == "cuda":
        # Both ticks launch P in the fault window; the fused one D, the
        # oracle's E1 and E2, one each a tick.
        ok = ok and (launches["serf_post"] == used
                     and launches["ref_send"] == used
                     and launches["ref_intake"] == used
                     and launches["chaos_pre"] == (
                         2 * ORACLE_FAULT if with_chaos else 0))
    res["ok"] = ok
    return res


def _full_view_ticks(sim, node, limit):
    """Ticks until every column of ``node``'s view reads ALIVE (one row
    copy a tick), or limit + 1."""
    from consul_tpu_torch.models import snapshot
    from consul_tpu_torch.ops import merge

    for i in range(limit):
        sim.run(1, chunk=1, with_metrics=False)
        statuses, _ = snapshot._seat_row(sim.state, node)
        if all(x == merge.ALIVE for x in statuses):
            return i + 1
    return limit + 1


def snapshot_rejoin(cfg, device="cuda", kernel="cuda"):
    """The serf snapshotter on the serf state: SNAP_NODE observed every
    chunk (the file's bytes and ms per observe, each ending in its one
    row copy), then killed, SNAP_NOTICE ticks for the cluster to notice,
    and restarted from the same state and generator twice: cold (3 join
    seeds) and warm (``SerfSimulation.rejoin`` from the replayed file).
    The warm node's view reads all ALIVE in fewer ticks than the cold
    one's (reference tests/test_snapshot.py:124), and its clocks resume
    at the recorded floors."""
    from consul_tpu_torch.models import cluster, snapshot
    from consul_tpu_torch.ops import cuda_gossip

    n, node = cfg.n, SNAP_NODE
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    os.makedirs(SNAP_DIR, exist_ok=True)
    path = os.path.join(SNAP_DIR, "serf.snapshot")
    sim = cluster.SerfSimulation(cfg, seed=5, device=device, kernel=kernel)
    reset_launches()
    snap = snapshot.Snapshotter(path, node)
    observe_ms = []
    for _ in range(SNAP_CHUNKS):
        sim.run(SNAP_CHUNK, chunk=SNAP_CHUNK, with_metrics=False)
        _sync(device)
        t0 = time.perf_counter()
        snap.observe(cfg, sim.topo, sim.state)
        observe_ms.append((time.perf_counter() - t0) * 1e3)
    snap.close()
    rep = snapshot.replay(path)
    sim.kill(_rows(n, [node], "cpu"))
    sim.run(SNAP_NOTICE, chunk=64, with_metrics=False)
    crashed, gen = cluster._clone(sim.state), sim.gen.get_state()
    sim.revive(_rows(n, [node], "cpu"), cold=True)
    cold = _full_view_ticks(sim, node, SNAP_LIMIT)
    sim.load_state(crashed)
    sim.gen.set_state(gen)
    sim.rejoin(node, rep)
    _, clocks = snapshot._seat_row(sim.state, node)
    warm = _full_view_ticks(sim, node, SNAP_LIMIT)
    launches = dict(cuda_gossip.LAUNCHES)
    res = dict(n=n, k=cfg.degree, node=node, file_bytes=os.path.getsize(path),
               alive_recorded=len(rep.alive), clocks_recorded=[
                   rep.clock, rep.event_clock, rep.query_clock],
               clocks_after_rejoin=clocks, observe_ms=observe_ms,
               ms_per_observe=sum(observe_ms) / len(observe_ms),
               cold_ticks=cold, warm_ticks=warm, launches=launches)
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    res["ok"] = (warm < cold and len(rep.alive) == cfg.degree
                 and clocks[0] >= rep.clock and clocks[1] >= rep.event_clock)
    if torch.device(device).type == "cuda":
        res["ok"] = res["ok"] and launches["serf_post"] > 0
    return res


def frontend_parity(cfg, device="cuda", kernel="cuda"):
    """AsyncFrontend over a live plane against the batchers direct: two
    simulations of one seed with write-attached planes; FRONTEND_WRITES
    writes (registrations, KV puts, deregistrations) through the front end
    on one and straight into the write batcher on the other give the same
    results, apply index and KV readback; FRONTEND_READS NEAREST reads and
    the catalog and health reads through the front end equal the batcher's
    on the same plane and on the twin; a blocking wait_index wakes on a
    flip; an HTTP PUT / GET round trip through serve_http on 127.0.0.1;
    one owned thread."""
    import http.client
    import random as _random

    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip, deltas
    from consul_tpu_torch.ops import serving as kernels
    from consul_tpu_torch.serving import AsyncFrontend, ServingPlane

    n = cfg.n
    reset_launches()
    stacks = []
    for _ in range(2):
        sim = cluster.Simulation(cfg, seed=9, device=device, kernel=kernel)
        plane = ServingPlane(k=8, buckets=(64, FRONTEND_READS), num_services=8,
                             device=device)
        sim.attach_serving(plane, writes=True, kv_slots=256)
        sim.run(64, chunk=32, with_metrics=False)
        stacks.append((sim, plane))
    (sim_a, plane_a), (sim_b, plane_b) = stacks
    rng = _random.Random(11)
    writes = []
    for i in range(FRONTEND_WRITES):
        roll = rng.random()
        if roll < 0.5:
            writes.append((deltas.OP_REGISTER, rng.randrange(n), rng.randrange(8)))
        elif roll < 0.8:
            writes.append((deltas.OP_KV_PUT, i % 16, rng.randrange(1000)))
        else:
            writes.append((deltas.OP_DEREGISTER, rng.randrange(n), -1))
    for i in range(16):
        for plane in (plane_a, plane_b):
            plane.keys.slot_for(f"fe/{i}", create=True)
    fe = AsyncFrontend(plane_a).start()
    res = dict(n=n, k=cfg.degree)
    try:
        t0 = time.perf_counter()
        got_w = [f.result(60.0) for f in
                 [fe.submit_write(o, t, a) for o, t, a in writes]]
        res["write_ms"] = (time.perf_counter() - t0) * 1e3
        want_w = plane_b.writes.execute(writes)
        sim_a.publish_serving()
        sim_b.publish_serving()
        reads = [(kernels.MODE_NEAREST, rng.randrange(n), -1)
                 for _ in range(FRONTEND_READS - 8)]
        reads += [(kernels.MODE_NEAREST, rng.randrange(n), s) for s in range(4)]
        reads += [(kernels.MODE_CATALOG, 0, s) for s in (-1, 3)]
        reads += [(kernels.MODE_HEALTH, 0, s) for s in (-1, 5)]
        t0 = time.perf_counter()
        got_r = [f.result(60.0) for f in
                 [fe.submit_read(m, s, a) for m, s, a in reads]]
        res["read_ms"] = (time.perf_counter() - t0) * 1e3
        direct_a = plane_a.batcher.execute(reads)
        direct_b = plane_b.batcher.execute(reads)

        def same(x, y):
            return all(int(p.count) == int(q.count)
                       and (p.ids == q.ids).all() and (p.rtts == q.rtts).all()
                       for p, q in zip(x, y)) and len(x) == len(y)

        res["writes_equal"] = got_w == want_w
        res["reads_equal_same_plane"] = same(got_r, direct_a)
        res["reads_equal_twin"] = same(got_r, direct_b)
        res["apply_index"] = [plane_a.apply_index, plane_b.apply_index]
        res["kv_equal"] = all(plane_a.kv_get(f"fe/{i}") == plane_b.kv_get(f"fe/{i}")
                              for i in range(16))
        # A blocking wait woken by a flip.
        cur = plane_a.apply_index
        parked = fe.wait_index(cur, 30.0)
        time.sleep(0.05)
        early = parked.done()
        plane_a.writes.execute([(deltas.OP_REGISTER, 1, 2)])
        t0 = time.perf_counter()
        sim_a.publish_serving()
        woke = parked.result(30.0)
        res["wait_index"] = dict(before=cur, woke_at=woke, early=early,
                                 wake_ms=(time.perf_counter() - t0) * 1e3)
        # One HTTP round trip on 127.0.0.1.
        host, port = fe.serve_http("127.0.0.1", 0)
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("PUT", "/v1/kv/fe/http", body="7")
        put = conn.getresponse().read()
        sim_a.publish_serving()
        conn.request("GET", "/v1/kv/fe/http")
        resp = conn.getresponse()
        rows = json.loads(resp.read())
        res["http"] = dict(put=put.decode(), value=rows[0]["Value"],
                           index=int(resp.getheader("X-Consul-Index")))
        conn.close()
        res["owned_threads"] = fe.owned_threads()
        res["stats"] = fe.stats()
    finally:
        fe.close()
    res["launches"] = dict(cuda_gossip.LAUNCHES)
    res["ok"] = (res["writes_equal"] and res["reads_equal_same_plane"]
                 and res["reads_equal_twin"] and res["kv_equal"]
                 and res["apply_index"][0] == res["apply_index"][1] > 0
                 and not res["wait_index"]["early"]
                 and res["wait_index"]["woke_at"] > cur
                 and res["http"]["put"] == "true" and res["http"]["value"] == 7
                 and res["owned_threads"] == 1)
    if torch.device(device).type == "cuda":
        res["ok"] = res["ok"] and tick_launches(res["launches"]) > 0
    return res


def gameday_run(n, frontend, swarm_procs, device="cuda", kernel="cuda"):
    """run_gameday at ``n`` (the reference's defaults otherwise) with the
    kernel objects it builds kept: the main simulation's tick and the DCN
    leg's islands. Returns (verdict, accounting): wall per phase, the
    launches by configuration (B1 the main simulation's ticks without a
    schedule and the islands' LAN pools, B2 its ticks under the composed
    schedule, B5 the islands' WAN pools), whether every tick ran on the
    CUDA kernel, host syncs and peak bytes."""
    from consul_tpu_torch.gameday import GamedayConfig, harness, run_gameday
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.parallel import dcn

    made = {"sims": [], "feds": []}
    make_sim, dcn_init = harness._simulation, dcn.DcnFederation.__init__

    def keep_sim(cfg):
        sim = make_sim(cfg)
        made["sims"].append(sim)
        return sim

    def keep_fed(self, *a, **k):
        dcn_init(self, *a, **k)
        made["feds"].append(self)

    phases, marks = {}, {}

    def note(rec):
        name = rec.get("gameday")
        if name in ("warmup", "steady", "fault", "heal", "drain"):
            phases[name] = rec.get("wall_s")
            marks[name] = dict(cuda_gossip.LAUNCHES)

    cfg = GamedayConfig(n=n, view_degree=32, frontend=frontend,
                        swarm_procs=swarm_procs, device=device, kernel=kernel)
    harness._simulation, dcn.DcnFederation.__init__ = keep_sim, keep_fed
    cuda = torch.device(device).type == "cuda"
    try:
        reset_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        box = {}
        t0 = time.perf_counter()
        run = lambda: box.update(v=run_gameday(cfg, emit=note))  # noqa: E731
        syncs = sync_count(run) if cuda else (run() or 0)
        wall = time.perf_counter() - t0
    finally:
        harness._simulation, dcn.DcnFederation.__init__ = make_sim, dcn_init
    v = box["v"]
    sim = made["sims"][0]
    islands = [i for f in made["feds"] for i in f.islands]
    main_ticks = getattr(sim._tick_fn, "launches", 0)
    b2 = 4 * cuda_gossip.LAUNCHES["chaos_pre"]
    acc = dict(wall_s=wall, wall_s_by_phase=phases, host_syncs=syncs,
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
               launches=dict(cuda_gossip.LAUNCHES),
               launches_by_phase=marks,
               b1_main=main_ticks - b2, b2=b2,
               b1_islands=sum(getattr(i._lan_tick, "launches", 0)
                              for i in islands),
               b5_wan=sum(getattr(i._wan_tick, "launches", 0) for i in islands),
               on_kernel=isinstance(sim._tick_fn, cuda_gossip.TickKernel)
               and all(isinstance(i._lan_tick, cuda_gossip.TickKernel)
                       and isinstance(i._wan_tick, cuda_gossip.TickKernel)
                       for i in islands))
    return v, acc


def gameday_ok(v, acc, cuda=True):
    """The game day's gates: the SLO verdict passes with lost_writes 0,
    the index monotone (no regression across the RaftKill window), heal
    within its threshold, watch lag 0 at drain; on the card B1, B2 and B5
    launched and every tick on the kernel."""
    ok = (v["pass"] and v["lost_writes"] == 0
          and v["ledger"]["index_regressions"] == 0
          and v["max_time_to_heal_ticks"] is not None
          and v["max_time_to_heal_ticks"]
          <= v["thresholds"]["max_time_to_heal_ticks"]
          and v["watch_delivery_lag"] == 0 and v["drained"]
          and v["dcn"] is not None and v["dcn"]["converged"])
    if cuda:
        ok = ok and acc["on_kernel"] and min(
            acc["b1_main"], acc["b2"], acc["b1_islands"], acc["b5_wan"]) > 0
    return ok


def gameday_main_path():
    """The game day at 1M (reference defaults otherwise, the 2-island DCN
    leg included) with the async front end and a 4-process HTTP swarm,
    then with the threaded front end at GAMEDAY_THREADED_N."""
    out = {}
    for name, n, fe, procs in (("async", GAMEDAY_N, "async", 4),
                               ("threaded", GAMEDAY_THREADED_N, "threaded", 0)):
        v, acc = gameday_run(n, fe, procs)
        torch.cuda.empty_cache()
        keep = ("pass", "violations", "p99_read_ms", "p99_write_ms",
                "p99_watch_ms", "p50_read_ms", "p50_write_ms", "p50_watch_ms",
                "lost_writes", "max_time_to_heal_ticks", "watch_delivery_lag",
                "shed", "rejected", "thresholds", "phases", "frontend",
                "frontend_threads", "ledger", "apply_index", "watchers",
                "deliveries", "flips", "chaos", "dcn", "swarm", "raft",
                "wall_s", "n", "drained")
        out[name] = dict({k: v[k] for k in keep}, **acc)
        out[name]["ok"] = gameday_ok(v, acc)
    out["async"]["ok"] = (out["async"]["ok"]
                          and out["async"]["frontend_threads"] == 1
                          and out["async"]["swarm"]["failed"] == 0)
    return out


def cli(args, timeout=300):
    """``python -m consul_tpu_torch.cli *args`` from the checkout's root:
    (exit code, its last stdout line as JSON or None, wall s, stderr
    tail)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "consul_tpu_torch.cli"] + [str(a) for a in args]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       cwd=root)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1]) if lines else None
    except ValueError:
        out = None
    return p.returncode, out, wall, p.stderr[-1500:]


def cli_sigterm_drill(n: int):
    """``run`` at ``n`` nodes with a checkpoint directory, SIGTERM-ed once
    its first checkpoint is on disk: it must exit 75; the same command run
    again resumes and exits 0, and its final state digest must equal an
    uninterrupted run's."""
    import glob

    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(CLI_DIR, "drill")
    shutil.rmtree(os.path.join(root, ckpt), ignore_errors=True)
    base = ["run", "--n", n, "--view-degree", 32, "--ticks", CLI_DRILL_TICKS,
            "--chunk", 64, "--state-digest"]
    args = base + ["--ckpt-dir", ckpt, "--ckpt-every-ticks", 256,
                   "--ckpt-interval-s", 0]
    cmd = [sys.executable, "-m", "consul_tpu_torch.cli"] + [str(a) for a in args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    sent = None
    try:
        while proc.poll() is None and time.perf_counter() - t0 < 300:
            if glob.glob(os.path.join(root, ckpt, "*.ckpt")):
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter() - t0
                break
            time.sleep(0.05)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = stdout.strip().splitlines()
    first = json.loads(lines[-1]) if lines else None
    rc_resume, resumed, wall_resume, _ = cli(args)
    rc_whole, whole, wall_whole, _ = cli(base)
    shutil.rmtree(os.path.join(root, ckpt), ignore_errors=True)
    ok = (proc.returncode == 75 and rc_resume == 0 and rc_whole == 0
          and resumed is not None and whole is not None
          and resumed["resumed_from_tick"] > 0
          and resumed["state_digest"] == whole["state_digest"])
    return dict(n=n, ticks=CLI_DRILL_TICKS, sigterm_after_s=sent,
                rc_interrupted=proc.returncode, rc_resumed=rc_resume,
                rc_uninterrupted=rc_whole,
                stopped_at_tick=(first or {}).get("ticks_done"),
                resumed_from_tick=(resumed or {}).get("resumed_from_tick"),
                digest_equal=bool(resumed and whole and resumed.get(
                    "state_digest") == whole.get("state_digest")),
                wall_s_resumed=wall_resume, wall_s_uninterrupted=wall_whole,
                stderr_tail=stderr[-600:] if proc.returncode != 75 else "",
                ok=ok)


def cli_main_path():
    """The port's CLI verbs through ``python -m consul_tpu_torch.cli`` on
    the card, each at 1M nodes (K = 32) where its main path is 1M:
    prewarm, run (prewarmed), trace, chaos --sweep, serve-bench and the
    game day; each must exit 0 with its report's keys, then the SIGTERM
    drill (cli_sigterm_drill)."""
    n, trace_dir = MAIN_N, os.path.join(CLI_DIR, "trace")
    verbs = [
        ("prewarm", ["prewarm", "--n", n, "--view-degree", 32, "--kinds",
                     "swim,serf_reference", "--chunks", 64]),
        ("run", ["run", "--n", n, "--view-degree", 32, "--ticks", 256,
                 "--chunk", 64, "--prewarm"]),
        ("trace", ["trace", "--n", n, "--view-degree", 32, "--ticks", 64,
                   "--chunk", 32, "--lens", 8, "--trace-dir", trace_dir]),
        ("chaos_sweep", ["chaos", "--n", n, "--view-degree", 32, "--sweep",
                         4, "--settle", 64]),
        ("serve_bench", ["serve-bench", "--n", n, "--view-degree", 32,
                         "--queries", 4096, "--batch", 1024]),
        ("gameday", ["gameday", "--n", n, "--view-degree", 32]),
    ]
    need = {"prewarm": ("signatures", "compiled", "cache", "wall_s"),
            "run": ("ticks", "slo", "counters", "resumed_from_tick",
                    "ckpt_failures", "reshards", "hang_status"),
            "trace": ("ticks", "lens_ids", "agreement", "trace"),
            "chaos_sweep": ("sweep", "families", "pareto",
                            "dominates_default"),
            "serve_bench": ("queries", "wall_s", "queries_per_sec_per_chip"),
            "gameday": ("pass", "lost_writes")}
    res, ok = {}, True
    for name, args in verbs:
        rc, out, wall, err = cli(args)
        keys_ok = out is not None and all(k in out for k in need[name])
        r = dict(rc=rc, wall_s=wall, keys_ok=keys_ok)
        if out is not None:
            if name == "prewarm":
                r.update(compiled=out["compiled"], cache=out["cache"])
            elif name == "run":
                r.update(ticks=out["ticks"],
                         probes_sent=out["counters"]["probes_sent"])
            elif name == "trace":
                r.update(agreement=out["agreement"], lens=len(out["lens_ids"]),
                         trace_file=os.path.exists(out["trace"]))
            elif name == "chaos_sweep":
                r.update(pareto=out["pareto"])
            elif name == "serve_bench":
                r.update(queries=out["queries"],
                         queries_per_sec=out["queries_per_sec_per_chip"])
            elif name == "gameday":
                r.update({k: out.get(k) for k in (
                    "pass", "lost_writes", "max_time_to_heal_ticks")})
        if rc != 0 or not keys_ok:
            r["stderr_tail"] = err
        res[name] = r
        ok = ok and rc == 0 and keys_ok
    t0 = time.perf_counter()
    res["sigterm_drill"] = cli_sigterm_drill(n)
    res["sigterm_drill"]["seconds"] = round(time.perf_counter() - t0, 3)
    res["ok"] = (ok and res["sigterm_drill"]["ok"]
                 and res["trace"].get("trace_file", False)
                 and res["run"].get("probes_sent", 0) > 0
                 and res["prewarm"].get("compiled") == 4)
    return res


# ----------------------------------------------------------------------
# The transport seam and the server core (ROADMAP A21, first part)
# ----------------------------------------------------------------------

# Golden frames, one per message family, as the reference's codec
# (consul_tpu/wire/codec.py) writes them.
WIRE_GOLDEN = {
    "ping": "0082a44e6f6465a573696d2d33a55365714e6f01",
    "ack": "0282a75061796c6f6164ac000102030405060708090a0ba55365714e6fcd012c",
    "alive": "0486a441646472a573696d2d37ab496e6361726e6174696f6e02a44d657461a0"
             "a44e6f6465a573696d2d37a4506f7274cd1f0aa356736ea6010501020504",
    "suspect": "0383a446726f6da573696d2d31ab496e6361726e6174696f6ece00011170a4"
               "4e6f6465a573696d2d39",
    "dead": "0583a446726f6da573696d2d32ab496e6361726e6174696f6e03a44e6f6465a5"
            "73696d2d39",
    "compound_crc": "0c9a2f414a0702001400290082a44e6f6465a573696d2d33a5536571"
                    "4e6f010383a446726f6da573696d2d31ab496e6361726e6174696f6e"
                    "ce00011170a44e6f6465a573696d2d39",
    "compressed": "0982a4416c676f00a3427566da0077070600a000c007801200049172f286"
                  "4c995273d2b46931a3d49432711a0620608854103264e4449cd8e2c6aa24"
                  "6ec68491e3260c9d346fdc0820d5a40c9d30a0183a842891e20d5250dec8"
                  "a1d3ec83825156e6b83115a04000010508141844ca889c376d4852948152"
                  "254b9730650ed8f9706b8b1c0101",
    "push_pull": "0683a44a6f696ec3a54e6f64657301ac5573657253746174654c656e0287"
                 "a441646472a573696d2d34ab496e6361726e6174696f6e01a44d657461a0"
                 "a44e616d65a573696d2d34a4506f7274cd1f0aa5537461746500a356736e"
                 "a60105010205047573",
    "serf_event": "080384a24343c3a54c54696d6509a44e616d65a66465706c6f79a7506179"
                  "6c6f6164a27633",
    "serf_query": "08048aa441646472a573696d2d30a746696c7465727390a5466c616773"
                  "01a24944cd080ba54c54696d6504a44e616d65a777686f2d686173a750"
                  "61796c6f6164a16ba4506f7274cd1f0aab52656c6179466163746f7200"
                  "a754696d656f7574cf000000012a05f200",
    "serf_response": "080585a5466c61677300a446726f6da673696d2d3634a24944cd080b"
                     "a54c54696d6504a75061796c6f6164a6616e73776572",
}
VSN = [1, 5, 1, 2, 5, 4]
LZW_SIZES = ((0, 2), (1, 2), (300, 3), (9000, 4), (30000, 256), (60000, 16))


def golden_frames(codec, M):
    """The port's codec writing WIRE_GOLDEN's frames."""
    ping = codec.encode_message(M.PING, {"SeqNo": 1, "Node": "sim-3"})
    alive = codec.encode_message(M.ALIVE, {
        "Incarnation": 2, "Node": "sim-7", "Addr": b"sim-7", "Port": 7946,
        "Meta": b"", "Vsn": bytes(VSN)})
    suspect = codec.encode_message(M.SUSPECT, {
        "Incarnation": 70000, "Node": "sim-9", "From": "sim-1"})
    dead = codec.encode_message(M.DEAD, {"Incarnation": 3, "Node": "sim-9",
                                         "From": "sim-2"})
    q = {"LTime": 4, "ID": 2059}
    return {
        "ping": ping,
        "ack": codec.encode_message(M.ACK_RESP, {
            "SeqNo": 300, "Payload": bytes(range(12))}),
        "alive": alive, "suspect": suspect, "dead": dead,
        "compound_crc": codec.encode_packet([ping, suspect], crc=True),
        "compressed": codec.encode_packet([ping, alive, dead], compress=True),
        "push_pull": codec.encode_push_pull([{
            "Name": "sim-4", "Addr": b"sim-4", "Port": 7946, "Meta": b"",
            "Incarnation": 1, "State": 0, "Vsn": bytes(VSN)}],
            user_state=b"us", join=True),
        "serf_event": codec.encode_serf_message(codec.SERF_USER_EVENT, {
            "LTime": 9, "Name": "deploy", "Payload": b"v3", "CC": True}),
        "serf_query": codec.encode_serf_message(codec.SERF_QUERY, dict(
            q, Addr=b"sim-0", Port=7946, Filters=[], Flags=1, RelayFactor=0,
            Timeout=5_000_000_000, Name="who-has", Payload=b"k")),
        "serf_response": codec.encode_serf_message(
            codec.SERF_QUERY_RESPONSE, dict(q, From="sim-64", Flags=0,
                                            Payload=b"answer")),
    }


def wire_host():
    """The host codec on the card's machine: the native LZW library built
    under the kernels' build directory and equal to the pure-Python codec
    on seeded inputs past the 4,095-code reset; the port's codec
    reproducing WIRE_GOLDEN and decoding each frame; whether the
    ``cryptography`` package is there (gossip encryption needs it)."""
    import numpy as np

    from consul_tpu_torch.utils import compile_cache
    from consul_tpu_torch.wire import codec, keyring, lzw
    from consul_tpu_torch.wire.codec import MessageType as M

    t0 = time.perf_counter()
    native = lzw.native_available()
    built_s = time.perf_counter() - t0
    path = lzw.library_path()
    rng = np.random.default_rng(11)
    lzw_bad = []
    for n, alphabet in LZW_SIZES:
        data = bytes(rng.integers(0, alphabet, n).astype(np.uint8))
        packed = lzw.compress_py(data)
        if not (native and lzw.compress(data) == packed
                and lzw.decompress(packed) == data):
            lzw_bad.append(n)
    frames = golden_frames(codec, M)
    bad = [k for k, v in frames.items() if v.hex() != WIRE_GOLDEN[k]]
    decoded = 0
    for k, v in frames.items():
        if k == "push_pull":
            codec.decode_push_pull(v)
        elif k.startswith("serf_"):
            codec.decode_serf_message(codec.decode_message(v)[1]["Raw"])
        else:
            codec.decode_packet(v)
        decoded += 1
    res = dict(native=native, library=os.path.relpath(path),
               library_in_build_dir=(os.path.dirname(path)
                                     == compile_cache.build_dir()
                                     and os.path.exists(path)),
               native_load_s=round(built_s, 3), lzw_sizes=[n for n, _ in
                                                           LZW_SIZES],
               lzw_mismatch=lzw_bad, golden=len(frames), golden_mismatch=bad,
               decoded=decoded, cryptography=keyring.HAVE_CRYPTOGRAPHY)
    res["ok"] = (native and res["library_in_build_dir"] and not lzw_bad
                 and not bad and decoded == len(WIRE_GOLDEN))
    return res


class BridgeAgent:
    """A scripted memberlist/serf client on a bridge transport (numpy
    only): joins by push-pull, probes one random alive member every
    ``probe_every`` ticks and updates a scalar Vivaldi coordinate from the
    RTT, answers pings while ``answer`` is set, gossips its own aliveness,
    and acks and answers serf queries. Every packet it gets is logged."""

    def __init__(self, transport, cfg, incarnation=1, seed=0, probe_every=1):
        import numpy as np

        self.t, self.cfg = transport, cfg
        self.name, _ = transport.final_advertise_addr()
        self.inc = incarnation
        self.members = {}
        v = cfg.vivaldi
        self.vec = np.zeros(v.dimensionality)
        self.height, self.error = v.height_min, v.vivaldi_error_max
        self.pending, self.seq = {}, 0
        self.rng = np.random.default_rng(seed)
        self.probe_every, self.ticks = probe_every, 0
        self.answer = True
        self.rtt_log, self.log = [], []
        self.events_seen, self.queries_answered = [], []

    def alive_members(self):
        from consul_tpu_torch.wire import bridge

        return sorted(n for n, (_, s) in self.members.items()
                      if s == bridge.WIRE_ALIVE)

    def _merge(self, name, inc, state):
        from consul_tpu_torch.wire import bridge

        if name == self.name:
            if state != bridge.WIRE_ALIVE and inc >= self.inc:
                self.inc = inc + 1
            return
        cur = self.members.get(name)
        if cur is None or (inc, state) > cur:
            self.members[name] = (inc, state)

    def start_join(self, addr):
        from consul_tpu_torch.wire import bridge, codec

        self._join = self.t.dial_timeout(addr)
        me = {"Name": self.name, "Addr": self.name.encode(), "Port": 7946,
              "Meta": b"", "Incarnation": self.inc,
              "State": bridge.WIRE_ALIVE, "Vsn": VSN}
        self._join.send(codec.encode_stream_frame(
            codec.encode_push_pull([me], join=True), None))

    def finish_join(self):
        from consul_tpu_torch.wire import codec

        _, states, _ = codec.decode_push_pull(
            codec.decode_stream_frame(self._join.recv(timeout=1.0), None))
        for s in states:
            self._merge(s["Name"], s["Incarnation"], s["State"])

    def _viv(self, other, rtt):
        import numpy as np

        v = self.cfg.vivaldi
        diff = self.vec - np.asarray(other["Vec"], np.float64)
        norm = float(np.sqrt(diff @ diff))
        dist = norm + self.height + other["Height"]
        weight = self.error / max(self.error + other["Error"], 1e-6)
        wrong = abs(dist - rtt) / rtt
        self.error = min(v.vivaldi_error_max, v.vivaldi_ce * weight * wrong
                         + self.error * (1 - v.vivaldi_ce * weight))
        force = v.vivaldi_cc * weight * (rtt - dist)
        if norm > 1e-9:
            unit = diff / norm
            self.height = max(v.height_min, self.height
                              + (self.height + other["Height"]) * force / dist)
        else:
            unit = self.rng.uniform(-0.5, 0.5, diff.shape)
            unit /= np.sqrt(unit @ unit)
        self.vec = self.vec + unit * force

    def estimate(self, other) -> float:
        import numpy as np

        d = self.vec - np.asarray(other["Vec"], np.float64)
        return float(np.sqrt(d @ d)) + self.height + other["Height"]

    def tick(self):
        from consul_tpu_torch.wire import codec
        from consul_tpu_torch.wire.codec import MessageType as M

        while not self.t.packet_ch.empty():
            pkt = self.t.packet_ch.get()
            self.log.append((pkt.buf, pkt.from_addr, pkt.timestamp))
            try:
                msgs = codec.decode_packet(pkt.buf)
            except ValueError:
                continue
            for mtype, body in msgs:
                self._handle(mtype, body, pkt)
        self.ticks += 1
        alive = self.alive_members()
        if self.ticks % self.probe_every or not alive or not self.answer:
            return
        peer = alive[self.rng.integers(len(alive))]
        self.seq += 1
        ping = codec.encode_message(M.PING, {"SeqNo": self.seq, "Node": peer})
        self.pending[self.seq] = (self.t.write_to(
            codec.encode_packet([ping]), peer + ":7946"), peer)
        for _ in range(self.cfg.gossip.gossip_nodes):
            tgt = alive[self.rng.integers(len(alive))]
            msg = codec.encode_message(M.ALIVE, {
                "Incarnation": self.inc, "Node": self.name,
                "Addr": self.name.encode(), "Port": 7946, "Meta": b"",
                "Vsn": VSN})
            self.t.write_to(codec.encode_packet([msg]), tgt + ":7946")

    def _handle(self, mtype, body, pkt):
        from consul_tpu_torch.wire import bridge, codec
        from consul_tpu_torch.wire.codec import MessageType as M

        if mtype == M.PING and self.answer:
            ack = codec.encode_message(M.ACK_RESP, {
                "SeqNo": body["SeqNo"], "Payload": bridge.encode_coordinate(
                    self.vec, self.height, self.error, 0.0)})
            self.t.write_to(codec.encode_packet([ack]), pkt.from_addr)
        elif mtype == M.ACK_RESP:
            pend = self.pending.pop(body["SeqNo"], None)
            coord = bridge.decode_coordinate(body.get("Payload", b""))
            if pend is not None and coord is not None \
                    and pkt.timestamp > pend[0]:
                rtt = pkt.timestamp - pend[0]
                self.rtt_log.append((pend[1], rtt, coord))
                self._viv(coord, rtt)
        elif mtype in (M.ALIVE, M.SUSPECT, M.DEAD):
            self._merge(body["Node"], body["Incarnation"],
                        {M.ALIVE: bridge.WIRE_ALIVE,
                         M.SUSPECT: bridge.WIRE_SUSPECT,
                         M.DEAD: bridge.WIRE_DEAD}[mtype])
        elif mtype == M.USER and self.answer:
            stype, sbody = codec.decode_serf_message(body["Raw"])
            if stype == codec.SERF_USER_EVENT:
                self.events_seen.append(str(sbody["Name"]))
            elif stype == codec.SERF_QUERY:
                qid = int(sbody["ID"])
                if qid in self.queries_answered:
                    return
                self.queries_answered.append(qid)
                origin = codec.as_bytes(sbody["Addr"]).decode()
                for flags, payload in ((1, b""), (0, self.name.encode())):
                    self.t.write_to(codec.encode_packet([
                        codec.encode_serf_message(codec.SERF_QUERY_RESPONSE, {
                            "LTime": sbody["LTime"], "ID": qid,
                            "From": self.name, "Flags": flags,
                            "Payload": payload})]), origin + ":7946")


BRIDGE_SEED = 21
BRIDGE_SEAT = 500_000
BRIDGE_FORM = 512          # ticks before the agent attaches
BRIDGE_JOIN = 256          # bridged ticks with the agent answering
BRIDGE_DOWN_MAX = 2048     # bridged ticks to wait for the majority's DEAD
BRIDGE_WINDOW = 16         # kernel against plain, seats attached
BRIDGE_TIMED = 32
BRIDGE_RMSE_S = 0.015      # tests/test_bridge.py's bound
FLEET_SEATS = tuple(range(64, 96))
FLEET_FORM = 64
FLEET_TICKS = 256


class BridgeSide:
    """A simulation with its bridge and agents, stepped tick by tick, with
    the host-clock split of the steps in ``split``: the tick, the bridge's
    host step, the agents' own work, and (out of the last two) the row
    gathers and write-backs (``unpack_s``)."""

    def __init__(self, sim):
        from consul_tpu_torch.wire.bridge import PacketBridge

        self.sim = sim
        self.br = PacketBridge(sim)
        self.agents = {}
        self.split = {"tick_s": 0.0, "step_s": 0.0, "agents_s": 0.0,
                      "unpack_s": 0.0, "ticks": 0}

    def _rows_s(self):
        return self.br.stats["fetch_s"] + self.br.stats["write_s"]

    def step(self, sync=False):
        t0 = time.perf_counter()
        self.sim.run(1, chunk=1, with_metrics=False)
        if sync:
            _sync(self.sim.device)
        t1 = time.perf_counter()
        u0 = self._rows_s()
        self.br.step()
        if sync:
            _sync(self.sim.device)
        t2 = time.perf_counter()
        u1 = self._rows_s()
        for a in self.agents.values():
            a.tick()
        t3 = time.perf_counter()
        u2 = self._rows_s()
        sp = self.split
        sp["tick_s"] += t1 - t0
        sp["step_s"] += t2 - t1 - (u1 - u0)
        sp["agents_s"] += t3 - t2 - (u2 - u1)
        sp["unpack_s"] += u2 - u0
        sp["ticks"] += 1

    def timed(self, ticks: int) -> dict:
        """``ticks`` synchronized steps: ms a bridged tick by host clock and
        its split, and the device-to-host bytes a step."""
        split0, d2h0 = dict(self.split), self.br.stats["d2h_bytes"]
        t0 = time.perf_counter()
        for _ in range(ticks):
            self.step(sync=True)
        wall = time.perf_counter() - t0
        ms = {k: (self.split[k + "_s"] - split0[k + "_s"]) / ticks * 1e3
              for k in ("tick", "step", "agents", "unpack")}
        return {"ms_per_bridged_tick": wall / ticks * 1e3,
                "ms_tick": ms["tick"], "ms_unpack_repack": ms["unpack"],
                "ms_bridge_host_step": ms["step"],
                "ms_agents": ms["agents"],
                "d2h_bytes_per_step": (self.br.stats["d2h_bytes"] - d2h0)
                / ticks, "timed_ticks": ticks}


def no_agent_timing(sim, ticks=BRIDGE_TIMED) -> dict:
    """A bridged tick with no agent attached (the reference's overhead
    yardstick, tests/test_bridge_scale.py:140-165): ``ticks`` synchronized
    steps of ``sim`` under a bridge holding no seat. Reported, not gated."""
    side = BridgeSide(sim)
    side.step(sync=True)
    t = side.timed(ticks)
    return {"no_agent_ms_per_bridged_tick": t["ms_per_bridged_tick"],
            "no_agent_ms_tick": t["ms_tick"]}


def plain_twin(sim, cls):
    """A simulation on the same device stepping the plain tick from a copy
    of ``sim``'s world, topology, state and generator."""
    from consul_tpu_torch.models import cluster

    twin = cls(sim.cfg, seed=sim.seed, kernel="torch", device=sim.device,
               world=sim.world, topo=sim.topo, state=cluster._clone(sim.state))
    twin.gen.set_state(sim.gen.get_state())
    return twin


def _swim_rest(sim):
    return sim.state.swim if hasattr(sim.state, "swim") else sim.state


def seat_up(sim, seat) -> bool:
    """``seat``'s ground truth, read off the state at rest."""
    sw = _swim_rest(sim)
    if hasattr(sw, "flags"):
        return bool(sw.flags[seat] & 1)
    return bool(sw.alive_truth[seat])


def seat_beliefs(sim, seat):
    """(incarnation, status) of ``seat`` held by each live tracker (seat at
    column j of row seat - off[j]), read from the packed rows."""
    from consul_tpu_torch.models import layout

    n, off = sim.cfg.n, sim.topo.off_host
    rows = torch.tensor([(seat - o) % n for o in off], device=sim.device)
    cols = torch.arange(len(off), device=sim.device)
    sw = _swim_rest(sim)
    if isinstance(sw, layout.PackedSimState):
        inc = sw.view_inc.view(torch.int16)[rows, cols].to(torch.int64) & 0xFFFF
        st = sw.meta.view(torch.int16)[rows, cols].to(torch.int64) & 3
        alive = (sw.flags[rows] & 1) != 0
    else:
        key = sw.view_key[rows, cols]
        inc, st, alive = key >> 2, key & 3, sw.alive_truth[rows]
    inc, st, alive = inc.tolist(), st.tolist(), alive.tolist()
    return [(i, s) for i, s, a in zip(inc, st, alive) if a]


def _majority(b, pred) -> bool:
    return bool(b) and 2 * sum(1 for x in b if pred(*x)) > len(b)


def lockstep_window(pair, ticks):
    """Step both sides ``ticks`` times: after every tick the packed state of
    the plain side bit-equal to the kernel side's, and every agent's packet
    log byte-equal. Returns (mismatches, packets compared)."""
    kern, plain = pair
    bad, packets = [], 0
    for i in range(ticks):
        for side in pair:
            side.step()
        diff = tree_diff(kern.sim.state, plain.sim.state)
        if diff:
            bad.append(f"tick +{i + 1}: {diff[:4]}")
        for seat, a in kern.agents.items():
            b = plain.agents[seat]
            if a.log != b.log:
                bad.append(f"tick +{i + 1}: packets of seat {seat}")
            packets += len(a.log)
    return bad, packets


def bridge_swim(cfg, device="cuda", kernel="cuda", seat=BRIDGE_SEAT,
                form=BRIDGE_FORM, join=BRIDGE_JOIN, down_max=BRIDGE_DOWN_MAX,
                window=BRIDGE_WINDOW):
    """(a) One scripted agent on a Simulation through B1: the seat's holder
    killed before forming, the agent takes the seat over by the trackers'
    vote, joins by push-pull to seat + 1, learns its neighbours, its
    coordinate converges against the planted RTTs (RMSE of its estimates
    to the peers it probed last), the seat's trackers hold it alive at its
    new incarnation; then it stops answering and the trackers mark it
    suspect and then dead. The first ``window`` bridged ticks run beside a
    plain-tick twin (kernel against plain with a seat attached)."""
    import numpy as np

    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip, merge, topology
    from consul_tpu_torch.wire import bridge

    n = cfg.n
    sim = cluster.Simulation(cfg, seed=BRIDGE_SEED, device=device,
                             kernel=kernel)
    sim.kill(_rows(n, [seat], device))
    reset_launches()
    t0 = time.perf_counter()
    sim.run(form, chunk=64, with_metrics=False)
    while not _majority(seat_beliefs(sim, seat),
                        lambda inc, st: st != merge.ALIVE):
        sim.run(64, chunk=64, with_metrics=False)
    form_s = time.perf_counter() - t0
    bare = no_agent_timing(sim)
    pair = [BridgeSide(sim), BridgeSide(plain_twin(sim, cluster.Simulation))]
    for side in pair:
        side.agents[seat] = BridgeAgent(side.br.attach(seat), cfg,
                                        incarnation=2, seed=3)
        side.agents[seat].start_join(bridge.seat_addr((seat + 1) % n))
    wbad, packets = lockstep_window(pair, 1)
    for side in pair:
        side.agents[seat].finish_join()
    more, p2 = lockstep_window(pair, window - 1)
    wbad += more
    side = pair[0]
    del pair[1]
    agent = side.agents[seat]
    side.step(sync=True)
    timing = side.timed(BRIDGE_TIMED)
    for _ in range(join - window - BRIDGE_TIMED - 1):
        side.step()
    joined = seat_beliefs(sim, seat)
    # The agent's RTT estimates to the peers it probed last, against the
    # planted world (the reference test's RMSE, at one node's scale).
    errs = [agent.estimate(c) - float(topology.true_rtt(sim.world, seat,
                                                          bridge.addr_to_seat(p)))
            for p, _, c in agent.rtt_log[-64:]]
    rmse = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
    mirror = float(torch.linalg.norm(_swim_rest(sim).viv.vec[seat].float()))
    members = len(agent.alive_members())
    agent.answer = False
    t_quiet, t_down, t_suspect, t_dead = sim._t, None, None, None
    while sim._t - t_quiet < down_max:
        side.step()
        if (sim._t - t_quiet) % 8:
            continue
        if t_down is None and not seat_up(sim, seat):
            t_down = sim._t - t_quiet
        b = seat_beliefs(sim, seat)
        if t_suspect is None and any(st != merge.ALIVE for _, st in b):
            t_suspect = sim._t - t_quiet
        if _majority(b, lambda inc, st: st == merge.DEAD):
            t_dead = sim._t - t_quiet
            break
    _sync(sim.device)
    launches = dict(cuda_gossip.LAUNCHES)
    res = dict(n=n, k=cfg.degree, seat=seat, form_ticks=form, form_s=round(
        form_s, 3), window=window, window_mismatches=wbad[:20],
        window_packets=packets + p2, members_learned=members,
        joined_alive_inc2=_majority(joined, lambda inc, st: (
            st == merge.ALIVE and inc >= 2)),
        rtts=len(agent.rtt_log), rmse_ms=rmse * 1e3,
        seat_coordinate_norm=mirror,
        ticks_to_ground_truth_down=t_down, ticks_to_first_suspect=t_suspect,
        ticks_to_majority_dead=t_dead, ticks_total=sim._t,
        tick_launches=tick_launches(launches), **timing, **bare,
        agent_over_no_agent=timing["ms_per_bridged_tick"]
        / bare["no_agent_ms_per_bridged_tick"])
    res["ok"] = (not wbad and members >= cfg.degree
                 and res["joined_alive_inc2"] and rmse < BRIDGE_RMSE_S
                 and mirror > 0
                 and t_down is not None and t_suspect is not None
                 and t_dead is not None and t_suspect <= t_dead
                 and (kernel != "cuda" or res["tick_launches"] > 0))
    return res


def bridge_fleet(cfg, device="cuda", kernel="cuda", seats=FLEET_SEATS,
                 form=FLEET_FORM, ticks=FLEET_TICKS, window=BRIDGE_WINDOW):
    """(b) 32 scripted agents on adjacent seats of a SerfSimulation through
    B4 (tests/test_bridge_scale.py's fleet at the main path's width): an
    agent's event and a sim query from row 0 fired together; the first
    ``window`` bridged ticks beside a plain-tick twin (kernel against
    plain with seats attached), then the kernel run alone. Every agent
    stays alive under organic probing (ground truth up, no tracker holds
    it dead), the event reaches every live sim node and the other agents,
    and the query collects the fleet's acks and answers."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip, merge
    from consul_tpu_torch.wire import bridge, codec

    n = cfg.n
    sim = cluster.SerfSimulation(cfg, seed=BRIDGE_SEED + 1, device=device,
                                 kernel=kernel)
    reset_launches()
    sim.run(form, chunk=form, with_metrics=False)
    bare = no_agent_timing(sim)
    pair = [BridgeSide(sim),
            BridgeSide(plain_twin(sim, cluster.SerfSimulation))]
    for side in pair:
        for i, s in enumerate(seats):
            side.agents[s] = BridgeAgent(side.br.attach(s, replace=True), cfg,
                                         seed=100 + i, probe_every=5)
        ev = codec.encode_serf_message(codec.SERF_USER_EVENT, {
            "LTime": 50, "Name": "fleet-deploy", "Payload": b"x", "CC": True})
        side.agents[seats[0]].t.write_to(codec.encode_packet([ev]),
                                         bridge.seat_addr(0))
        side.sim.query(_rows(n, [0], device), 31)
    d0 = sim.state.ev_delivered.clone()
    qid = int(sim.state.q_open_key[0].to(torch.int64)[0])
    wbad, packets = lockstep_window(pair, window)
    del pair[1]
    side = pair[0]
    side.step(sync=True)
    timing = side.timed(BRIDGE_TIMED)
    for _ in range(ticks - window - BRIDGE_TIMED - 1):
        side.step()
    _sync(sim.device)
    launches = dict(cuda_gossip.LAUNCHES)
    st = sim.state
    seat_mask = _rows(n, list(seats), device)
    sw = st.swim
    if hasattr(sw, "flags"):
        up, left = (sw.flags & 1) != 0, (sw.flags & 2) != 0
    else:
        up, left = sw.alive_truth, sw.left
    active = up & ~left & ~seat_mask
    gained = (st.ev_delivered - d0)[active]
    dead_held = sum(1 for s in seats for _, b in seat_beliefs(sim, s)
                    if b == merge.DEAD)
    heard = sum("fleet-deploy" in a.events_seen
                for s, a in side.agents.items() if s != seats[0])
    q = side.br.query_status(0, qid)
    summary = None if q is None else dict(
        open=q["open"], acks_total=q["acks_total"],
        responses_total=q["responses_total"],
        agent_acks=len(q["agent_acks"]),
        agent_responses=len(q["agent_responses"]),
        payloads_are_names=all(v == k.encode() for k, v in
                               q["agent_responses"].items()))
    res = dict(n=n, k=cfg.degree, agents=len(seats), window=window,
               window_mismatches=wbad[:20], window_packets=packets,
               seats_up=bool(up[seat_mask].all()), trackers_holding_dead=
               dead_held, event_min_gain=int(gained.min()),
               event_reached=int((gained > 0).sum()),
               live_sim_nodes=int(active.sum()), agents_heard=heard,
               query=summary, answered=sum(qid in a.queries_answered
                                     for a in side.agents.values()),
               ticks_total=sim._t, tick_launches=tick_launches(launches),
               **timing, **bare, agents_over_no_agent=timing[
                   "ms_per_bridged_tick"] / bare["no_agent_ms_per_bridged_tick"])
    res["ok"] = (not wbad and res["seats_up"] and dead_held == 0
                 and res["event_min_gain"] >= 1
                 and heard >= (len(seats) - 1) * 3 // 4 and q is not None
                 and summary["agent_acks"] >= len(seats) * 3 // 4
                 and summary["agent_responses"] >= len(seats) * 3 // 4
                 and summary["payloads_are_names"]
                 and q["responses_total"] >= n - len(seats) - 2
                 and (kernel != "cuda" or res["tick_launches"] > 0))
    return res


def bridge_main_path(n=MAIN_N, device="cuda", kernel="cuda", **kw):
    """The transport seam at the main path's width: ``bridge_swim`` (B1)
    and ``bridge_fleet`` (B4), each with its kernel-against-plain window;
    the peak device memory of each."""
    from consul_tpu_torch.config import SimConfig

    cfg = SimConfig(n=n, view_degree=32)
    out = {}
    for name, fn in (("swim", bridge_swim), ("serf", bridge_fleet)):
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn(cfg, device=device, kernel=kernel, **kw.get(name, {}))
        res["seconds"] = round(time.perf_counter() - t0, 3)
        if device != "cpu":
            res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out[name] = res
    return out


def raft_lockstep_oracle(cfg, groups=16, peers=5, seed=5, device="cuda",
                         kernel="cuda"):
    """The card's raft tier against the port's own LockstepRaftOracle
    (server/raft.py: the six sub-phases as scalar loops, sharing no
    tensor code): a 1M Simulation with set_raft(groups, peers) under
    raft_events (so the gossip ticks run the chaos variant, B2), the
    draw tensors recorded as the plane consumes them, proposals at
    RAFT_PARITY_PROPOSALS' chunk boundaries mirrored as the oracle's
    bumps. Every RaftState field and the cumulative counters equal at
    every chunk boundary; the oracle's seconds a tick beside the card's."""
    import numpy as np

    from consul_tpu_torch import chaos
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip, raft_ops
    from consul_tpu_torch.server.raft import LockstepRaftOracle

    events = raft_events(chaos)
    sim = cluster.Simulation(cfg, seed=seed, device=device, kernel=kernel)
    plane = sim.set_raft(groups, peers=peers, window=RAFT_WINDOW)
    sim.set_chaos(events)
    own, draws = plane.draws, {}

    def record(t):
        draws[t] = own(t)
        return draws[t]
    plane.draws = record
    oracle = LockstepRaftOracle(plane.rcfg, plane.state.timer, draws.
                                __getitem__, events=events)
    reset_launches()
    card_s = oracle_s = 0.0
    bad = []
    for c in range(RAFT_PARITY_TICKS // RAFT_PARITY_CHUNK):
        for g in range(groups):
            if c in RAFT_PARITY_PROPOSALS:
                plane.propose([(0, 0, 0)] * RAFT_PARITY_PROPOSALS[c], group=g)
                oracle.bump(g, RAFT_PARITY_PROPOSALS[c])
        t0 = time.perf_counter()
        sim.run(RAFT_PARITY_CHUNK, chunk=RAFT_PARITY_CHUNK, with_metrics=False)
        _sync(sim.device)
        t1 = time.perf_counter()
        oracle.run(range(c * RAFT_PARITY_CHUNK, (c + 1) * RAFT_PARITY_CHUNK))
        t2 = time.perf_counter()
        card_s += t1 - t0
        oracle_s += t2 - t1
        want = oracle.snapshot()
        for f in raft_ops.RaftState._fields:
            got = getattr(plane.state, f).cpu().numpy().astype(np.int64)
            if not np.array_equal(got, want[f].astype(np.int64)):
                bad.append(f"tick {sim._t} {f}")
        cnt = plane.counters_snapshot()
        if cnt != oracle.cnt:
            bad.append(f"tick {sim._t} counters {cnt} != {oracle.cnt}")
    launches = dict(cuda_gossip.LAUNCHES)
    s = plane.summary()
    ticks = RAFT_PARITY_TICKS
    res = dict(groups=groups, peers=peers, window=RAFT_WINDOW, n=cfg.n,
               ticks=ticks, chunk=RAFT_PARITY_CHUNK, mismatches=bad[:20],
               boundaries=ticks // RAFT_PARITY_CHUNK,
               counters=plane.counters_snapshot(), summary=s,
               card_ms_per_tick=card_s / ticks * 1e3,
               oracle_ms_per_tick=oracle_s / ticks * 1e3,
               tick_launches=tick_launches(launches))
    res["ok"] = (not bad and res["counters"]["elections_won"] > groups
                 and res["counters"]["term_changes"] > 0
                 and all(x >= 0 for x in s["leaders"])
                 and (kernel != "cuda" or res["tick_launches"] > 0))
    return res


# The server tier on the tick (ROADMAP A21 item 1): the observer seats the
# three servers stand on, the view columns of seat 0 whose rows die, the
# mass kill elsewhere, and the coordinate seats.
SERVER_SEATS = (0, 1, 2)
SERVER_VICTIM_COLS = (3, 11, 19)
SERVER_KILL_FRAC = 20          # 1/20 = 5 %
SERVER_FORM = 64
SERVER_WINDOW = 16             # kernel against plain, member lists
SERVER_DETECT_MAX = 8192
SERVER_COORD_SEATS = 1024
SERVER_REL = 1e-6


def _merged_members(lists):
    """The servers' serf member lists merged by status precedence (a
    member any observer holds failed, left or reaped is no longer alive)."""
    rank = {"alive": 0, "failed": 1, "left": 2, "reap": 3}
    out = {}
    for members in lists:
        for m in members:
            cur = out.get(m["name"])
            if cur is None or rank[m["status"]] > rank[cur["status"]]:
                out[m["name"]] = m
    return [out[k] for k in sorted(out)]


def _timed_ms(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def server_membership(cfg, device="cuda", kernel="cuda", seed=31,
                      form=SERVER_FORM, window=SERVER_WINDOW,
                      detect_max=SERVER_DETECT_MAX):
    """(a) and (b): a packed SerfSimulation through B4 formed for ``form``
    ticks; three of seat 0's view neighbours and a 5 % mass kill away from
    the servers' views; ``window`` ticks beside a plain-tick twin with
    ``members_from_sim`` of the three server seats equal every tick; then
    the kernel alone until seat 0 holds the three dead. The three lists
    feed LanEventHandler on the leader of a 3-server ServerCluster
    (members join first, then the observed states, as
    tests/test_serf_plumbing.py:108-133), and the catalog holds serfHealth
    critical for the three and passing for every member seen alive."""
    import numpy as np

    from consul_tpu_torch.models import cluster, coalesce
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.server import endpoints, serf_plumbing

    n = cfg.n
    sim = cluster.SerfSimulation(cfg, seed=seed, layout="packed",
                                 device=device, kernel=kernel)
    reset_launches()
    sim.run(form, chunk=form, with_metrics=False)
    off = sim.topo.off_host
    victims = sorted((0 + off[c]) % n for c in SERVER_VICTIM_COLS)
    seen = {(s + o) % n for s in SERVER_SEATS for o in off} | set(SERVER_SEATS)
    rng = np.random.default_rng(seed)
    mass = rng.choice(n, n // SERVER_KILL_FRAC, replace=False)
    mass = sorted(set(mass.tolist()) - seen)
    sim.kill(_rows(n, victims + mass, sim.device))
    def lists(s):
        return [serf_plumbing.members_from_sim(cfg, s.topo, s.state, o)
                for o in SERVER_SEATS]

    def raw(s):
        return [serf_plumbing._observer_row(s.state, o) for o in SERVER_SEATS]

    twin = plain_twin(sim, cluster.SerfSimulation)
    wbad = []
    for i in range(window):
        for s in (sim, twin):
            s.run(1, chunk=1, with_metrics=False)
        # The lists map SUSPECT to alive, so the gathered rows (view_key,
        # down_since, t) are held equal too.
        rows_equal = all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and a[2] == b[2] for a, b in zip(raw(sim), raw(twin)))
        if not rows_equal or lists(sim) != lists(twin):
            wbad.append(f"tick +{i + 1}")
    del twin
    d0 = serf_plumbing.STATS["d2h_bytes"]
    _, mfs_ms = _timed_ms(lambda: serf_plumbing.members_from_sim(
        cfg, sim.topo, sim.state, 0), sim.device)
    row_bytes = serf_plumbing.STATS["d2h_bytes"] - d0
    detect_t0 = sim._t
    while True:
        by = {m["name"]: m["status"] for m in lists(sim)[0]}
        if all(by.get(f"sim-{v}") == "failed" for v in victims):
            break
        if sim._t - detect_t0 >= detect_max:
            break
        sim.run(64, chunk=64, with_metrics=False)
    _sync(sim.device)
    detect_ticks = sim._t - detect_t0
    launches = tick_launches(cuda_gossip.LAUNCHES)
    merged = _merged_members(lists(sim))
    c = endpoints.ServerCluster(3, seed=43)
    leader = c.wait_converged()
    h = serf_plumbing.LanEventHandler(leader, c)
    h.handle_events([coalesce.Event(coalesce.MEMBER_JOIN, name=m["name"])
                     for m in merged])
    c.step(120)
    events = [coalesce.Event(coalesce.MEMBER_JOIN if m["status"] == "alive"
                             else coalesce.MEMBER_FAILED, name=m["name"])
              for m in merged]
    _, reconcile_ms = _timed_ms(lambda: h.handle_events(events), "cpu")
    c.step(120)
    h.handle_events([])
    c.step(120)
    checks = {ch["node"]: ch["status"] for ch in leader.store.checks()
              if ch["check_id"] == "serfHealth"}
    alive = [m["name"] for m in merged if m["status"] == "alive"]
    res = dict(n=n, k=cfg.degree, observers=list(SERVER_SEATS),
               victims=victims, mass_killed=len(mass), window=window,
               window_mismatches=wbad[:20], detect_ticks=detect_ticks,
               members=len(merged), members_alive=len(alive),
               victims_critical=[checks.get(f"sim-{v}") == "critical"
                                 for v in victims],
               alive_passing=sum(checks.get(a) == "passing" for a in alive),
               members_from_sim_ms=mfs_ms,
               members_from_sim_d2h_bytes=row_bytes,
               reconcile_ms=reconcile_ms, tick_launches=launches,
               ticks_total=sim._t)
    res["ok"] = (not wbad and all(res["victims_critical"])
                 and res["alive_passing"] == len(alive) and len(alive) > 0
                 and row_bytes < 1024
                 and (kernel != "cuda" or launches > 0))
    return res


def server_coordinates(cfg, device="cuda", kernel="cuda", seed=0,
                       seats=SERVER_COORD_SEATS):
    """(c): the SWIM north star (64 ticks, a 5 % kill,
    run_until_converged) through B1, then ``sync_coordinates`` of
    ``seats`` rows spread over the state into a 3-server ServerCluster
    (each registered with a service first) and ``flush_coordinates``;
    every coordinate lands. ``Catalog.ListNodes near=`` and
    ``Health.ServiceNodes near=`` through ``leader.attach_serving(plane)``
    return the host sort's order (``server/rtt.sort_nodes_by_distance``),
    position by position within SERVER_REL relative in rtt, and the
    plane's batcher served them."""
    from consul_tpu_torch.models import cluster
    from consul_tpu_torch.ops import cuda_gossip
    from consul_tpu_torch.server import endpoints, rtt, serf_plumbing
    from consul_tpu_torch.serving import ServingPlane

    n = cfg.n
    sim = cluster.Simulation(cfg, seed=seed, layout="packed", device=device,
                             kernel=kernel)
    reset_launches()
    sim.run(64, chunk=64)
    sim.kill(_rows(n, list(range(n // SERVER_KILL_FRAC)), sim.device))
    converged, used, _ = sim.run_until_converged(max_ticks=4096, chunk=128)
    _sync(sim.device)
    launches = tick_launches(cuda_gossip.LAUNCHES)
    rows = [i * (n // seats) + (n // seats) // 2 for i in range(seats)]
    c = endpoints.ServerCluster(3, seed=44)
    leader = c.wait_converged()
    for r in rows:
        leader.rpc("Catalog.Register", node=f"sim-{r}", address=f"sim-{r}",
                   service={"id": "web", "service": "web"})
    c.step(200)
    d0 = serf_plumbing.STATS["d2h_bytes"]
    staged, sync_ms = _timed_ms(lambda: serf_plumbing.sync_coordinates(
        sim, leader, rows), sim.device)
    sync_bytes = serf_plumbing.STATS["d2h_bytes"] - d0
    leader.flush_coordinates()
    c.step(200)
    stored = {r["node"] for r in leader.store.coordinates()}
    plane = ServingPlane(k=16, device=sim.device)
    src = f"sim-{rows[0]}"
    calls = (("Catalog.ListNodes", {}), ("Health.ServiceNodes",
                                         {"service": "web"}))
    sets = rtt.coord_sets_from_store(leader.store.coordinates())
    reads = {}
    for method, kw in calls:
        leader.serving = None
        host = leader.rpc(method, near=src, **kw)["value"]
        leader.attach_serving(plane)
        leader.rpc(method, near=src, **kw)   # publishes the snapshot
        q0 = plane.batcher.queries
        card, ms = _timed_ms(lambda: leader.rpc(method, near=src, **kw)
                             ["value"], sim.device)
        h_rtt = [rtt.compute_distance(sets[src][""], sets[r["node"]][""])
                 for r in host]
        c_rtt = [rtt.compute_distance(sets[src][""], sets[r["node"]][""])
                 for r in card]
        gap = max((abs(a - b) / max(abs(a), 1e-12)
                   for a, b in zip(h_rtt, c_rtt)), default=0.0)
        h_names = [r["node"] for r in host]
        c_names = [r["node"] for r in card]
        # Two nodes may change places only where their host rtts are
        # bit-equal (a tie the host sort breaks by its own order).
        ties_only = sorted(h_names) == sorted(c_names) and all(
            a == b or ha == ca
            for a, b, ha, ca in zip(h_names, c_names, h_rtt, c_rtt))
        reads[method] = dict(rows=len(card), ms=ms,
                             order_equal=c_names == h_names,
                             order_equal_but_ties=ties_only,
                             max_rel_rtt_gap=gap,
                             batcher_queries=plane.batcher.queries - q0)
    leader.serving = None
    res = dict(n=n, k=cfg.degree, converged=converged, ticks_after_kill=used,
               seats=seats, staged=staged, stored=len(stored),
               sync_coordinates_ms=sync_ms, sync_d2h_bytes=sync_bytes,
               reads=reads, batcher_queries=plane.batcher.queries,
               tick_launches=launches, ticks_total=sim._t)
    res["ok"] = (converged and staged == seats and len(stored) == seats
                 and all(r["rows"] == seats and r["max_rel_rtt_gap"]
                         <= SERVER_REL and r["batcher_queries"] > 0
                         and r["order_equal_but_ties"]
                         for r in reads.values())
                 and plane.batcher.queries > 0
                 and (kernel != "cuda" or launches > 0))
    return res


def server_main_path(n=MAIN_N, device="cuda", kernel="cuda", **kw):
    """The servers' control plane fed by the tick at the main path's width
    (ROADMAP A21 item 1): ``server_membership`` (B4) and
    ``server_coordinates`` (B1), each with its peak device memory."""
    from consul_tpu_torch.config import SimConfig

    cfg = SimConfig(n=n, view_degree=32)
    out = {}
    for name, fn in (("membership", server_membership),
                     ("coordinates", server_coordinates)):
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn(cfg, device=device, kernel=kernel, **kw.get(name, {}))
        res["seconds"] = round(time.perf_counter() - t0, 3)
        if device != "cpu":
            res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out[name] = res
    return out


def reset_launches():
    from consul_tpu_torch.ops import cuda_gossip

    for k in cuda_gossip.LAUNCHES:
        cuda_gossip.LAUNCHES[k] = 0
    for k in cuda_gossip.SHARDED_LAUNCHES:
        cuda_gossip.SHARDED_LAUNCHES[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models import cluster, layout, serf, swim
    from consul_tpu_torch.obs import trace as obs_trace
    from consul_tpu_torch.ops import cuda_gossip

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "mem_rate_bytes_per_s": rate})

    # The build is traced: read its cuda.build span now, before the
    # bounded ring turns over.
    info = cuda_gossip.build()
    build_spans = [e for e in obs_trace.get_tracer().events()
                   if e["name"] == "cuda.build"]
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": round(info.seconds, 3),
          "compiled": info.compiled,
          "library": os.path.relpath(info.path), "ptxas": regs,
          "cuda_build_spans": build_spans})

    failed = []
    max_abs = {k: 0.0 for k in (
        "gossip_tick", "gossip_tick_serf", "gossip_tick_chaos",
        "gossip_tick_sentinel", "gossip_tick_serf_chaos")}
    max_abs.update({"gossip_tick_" + v[0]: 0.0 for v in DENSE_VARIANTS})
    max_abs["gossip_tick_wan_dense"] = 0.0

    def fold_abs(name, res):
        max_abs[name] = max([max_abs[name]] + [
            g["abs"] for g in res["float_gaps"].values()])

    # B7 beside the windows below: its phase lines, and the largest float
    # gap of the sharded plain runner against it.
    max_abs["gossip_tick_sharded"] = 0.0

    def note_sharded(config, res):
        sh = res.get("sharded")
        if not sh:
            return
        emit({"phase": "sharded_kernel_parity", "config": config,
              "n": res["n"], **sh})
        for r in sh["shards"].values():
            max_abs["gossip_tick_sharded"] = max(
                [max_abs["gossip_tick_sharded"]]
                + [g["abs"] for g in r["float_gaps_plain"].values()])
        if not sh["ok"]:
            failed.append(f"sharded_kernel_parity {config} n={res['n']}")
    for n, loss in PARITY:
        t0 = time.perf_counter()
        res = parity(n, loss, PARITY_TICKS, seed=7,
                     shards=SHARDS if n < MAIN_N else ())
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = not res["mismatches"] and all(
            res["counters_in_window"][f] > 0
            for f in ("suspicions_started", "deaths_declared", "refutations"))
        fold_abs("gossip_tick", res)
        sharded = res.pop("sharded")
        emit({"phase": "kernel_parity", **res})
        note_sharded("B1", dict(res, sharded=sharded))
        if not res["ok"]:
            failed.append(f"kernel_parity n={n}")
    for n, loss, relay, ticks in SERF_PARITY:
        t0 = time.perf_counter()
        res = serf_parity(n, loss, relay, ticks, seed=11,
                          shards=SHARDS if n == 65536 else ())
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = not res["mismatches"] and all(
            res["in_window"][f] > 0 for f in (
                "serf_intents_queued", "serf_intents_retx",
                "serf_intents_dropped", "delivered", "query_acks",
                "leave_quiet"))
        fold_abs("gossip_tick_serf", res)
        sharded = res.pop("sharded")
        emit({"phase": "serf_kernel_parity", **res})
        note_sharded("B4", dict(res, sharded=sharded))
        if not res["ok"]:
            failed.append(f"serf_kernel_parity n={n}")
    for n, loss in CHAOS_PARITY:
        t0 = time.perf_counter()
        res = chaos_parity(n, loss, PARITY_TICKS, seed=13,
                           shards=SHARDS if n == 65536 else ())
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = chaos_ok(res)
        fold_abs("gossip_tick_chaos", res)
        sharded = res.pop("sharded")
        emit({"phase": "chaos_kernel_parity", **res})
        note_sharded("B2+B3", dict(res, sharded=sharded))
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
    # Launch P alone against its plain version (the row word and record
    # that every later launch reads).
    for i, (name_w, n, timeline, form, window) in enumerate(P_WINDOWS):
        t0 = time.perf_counter()
        res = p_parity(name_w, n, timeline, form, window, seed=83 + i)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "p_parity", **res})
        if not res["ok"]:
            failed.append(f"p_parity {name_w}")
    for n, loss, relay, ticks, fault in SERF_CHAOS_PARITY:
        t0 = time.perf_counter()
        res = serf_chaos_parity(n, loss, relay, ticks, fault, seed=23,
                                shards=SHARDS if n == 65536 else ())
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        res["ok"] = serf_chaos_ok(res)
        fold_abs("gossip_tick_serf_chaos", res)
        sharded = res.pop("sharded")
        emit({"phase": "serf_chaos_kernel_parity", **res})
        note_sharded("B6", dict(res, sharded=sharded))
        if not res["ok"]:
            failed.append(f"serf_chaos_kernel_parity n={n}")
    dense_t = {}
    for variant, serf_plane, chaos_on in DENSE_VARIANTS:
        t0 = time.perf_counter()
        res, dense_t[variant] = dense_parity(
            variant, serf_plane, chaos_on, seed=29, rate=rate,
            shards=SHARDS if variant in SHARD_DENSE else ())
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs("gossip_tick_" + variant, res)
        sharded = res.pop("sharded")
        emit({"phase": "dense_kernel_parity", **res})
        note_sharded("B5 " + variant, dict(res, sharded=sharded))
        if not res["ok"]:
            failed.append(f"dense_kernel_parity {variant}")
    emit({"phase": "dense_timing", "n": DENSE_N, **dense_t})
    rows_of = {"bare": "gossip_tick", "serf_chaos": "gossip_tick_serf_chaos",
               "dense": "gossip_tick_dense", "dense_serf": "gossip_tick_dense_serf"}
    for variant, n, serf_plane, chaos_on in TIE_WINDOWS:
        t0 = time.perf_counter()
        res = tie_wrap_parity(variant, n, serf_plane, chaos_on, seed=31,
                              shards=(SHARD_MAIN,) if variant == "bare" else (),
                              shard_plain=False)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs(rows_of[variant], res)
        sharded = res.pop("sharded")
        emit({"phase": "tie_wrap_kernel_parity", **res})
        note_sharded("B1 tie-and-wrap", dict(res, sharded=sharded))
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
    # B8, the pre-fusion serf tick in the kernel, against its plain version
    # in every window of B8_WINDOWS; timed on the quiet 1M window's state.
    max_abs["gossip_tick_serf_reference"] = 0.0
    b8_t = None
    for name_w, n, stimulus, chaos_on, relay, loss in B8_WINDOWS:
        t0 = time.perf_counter()
        res = b8_parity(name_w, n, stimulus, chaos_on, seed=41, relay=relay,
                        loss=loss)
        if name_w == "quiet_1m" and res["ok"]:
            b8_t = b8_timing(res, rate)
        del res["_state"]
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        fold_abs("gossip_tick_serf_reference", res)
        emit({"phase": "b8_parity", **res})
        if not res["ok"]:
            failed.append(f"b8_parity {name_w}")
    if b8_t is not None:
        emit({"phase": "b8_timing", **b8_t})
    if failed:
        emit({"phase": "failed", "failed": failed})
        return 1

    # Main path: the north-star cell through the user's entry points.
    cfg = SimConfig(n=MAIN_N, view_degree=32)
    t0 = time.perf_counter()
    sim = cluster.Simulation(cfg, seed=0, layout="packed", kernel="cuda")
    setup_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim.run(64, chunk=64)
    mask = torch.zeros(cfg.n, dtype=torch.bool)
    mask[: cfg.n // 20] = True
    sim.kill(mask)
    converged, used, trace = sim.run_until_converged(max_ticks=4096, chunk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cuda_gossip.LAUNCHES)
    agreement = float(trace.agreement[-1])
    rmse_ms = float(trace.rmse[-1]) * 1000.0
    finite = bool(torch.isfinite(trace.rmse).all()) and bool(
        torch.isfinite(layout.unpack(sim.state).viv.vec).all())
    emit({"phase": "main_path", "n": cfg.n, "k": cfg.degree,
          "converged": converged, "ticks_after_kill": used,
          "ticks_total": sim._t, "agreement": agreement, "rmse_ms": rmse_ms,
          "wall_s": round(wall, 3), "setup_s": round(setup_s, 3),
          "peak_bytes": peak, "peak_over_start_bytes": peak - start_bytes,
          "launches": launches, "counters": sim.counters,
          "bytes_per_node": layout.bytes_per_node(sim.state, cfg.n)})
    if not (converged and agreement == 1.0 and tick_launches(launches) > 0
            and launches["metrics"] > 0
            and finite):
        emit({"phase": "failed", "failed": ["main_path"]})
        return 1
    swim_launches = tick_launches(launches)
    m_launches = launches["metrics"]
    main_ref = dict(used=used, t=sim._t, counters=dict(sim.counters),
                    state=cluster._clone(sim.state), wall=wall, peak=peak,
                    peak_over_start=peak - start_bytes)

    # Kernel timing at the main path's shapes, on its final state.
    tick = cuda_gossip.make_tick_kernel(cfg, sim.topo)
    d = swim.draw_tick(cfg, sim.gen, sim.device)
    swim_t = time_kernel(
        tick, lambda w, s, dd: cuda_gossip.plain_tick(cfg, sim.topo, w, s, dd),
        sim.world, sim.state, d,
        cuda_gossip.tick_hbm_bytes_per_node(sim.state, sim.world), cfg.n, rate)
    emit({"phase": "timing", **swim_t})
    b7_t = sharded_timing(cfg, sim.world, sim.topo, sim.state, d, rate)
    emit({"phase": "sharded_timing", "n": cfg.n, **b7_t})
    # Launch M on the SWIM path's final state: parity, its time per launch
    # against its bound and its plain version's, then a tick with metrics
    # against one without.
    m_cases = [metrics_case("swim_final", cfg, sim.topo, sim.world,
                            sim.state, seed=41)]
    m_t = metrics_timing(cfg, sim.topo, sim.world, sim.state, rate, seed=43)
    m_ticks = {"swim": tick_with_and_without_metrics(sim)}
    lens_ticks = {"swim": tick_with_and_without_lens(sim)}
    del sim, tick, d
    torch.cuda.empty_cache()

    # The main path in 4 shards on the one card, through B7 (ROADMAP A13,
    # first part), held to the one-device run above.
    t0 = time.perf_counter()
    shard_res, _ = sharded_main_path(cfg, main_ref)
    shard_res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "sharded_main_path", **shard_res})
    torch.cuda.empty_cache()
    if not shard_res["ok"]:
        emit({"phase": "failed", "failed": ["sharded_main_path"]})
        return 1

    # The planes on the mesh (ROADMAP A13 items 1, 2, 3 and 5): raft,
    # serving, a sweep and the elastic drill on 4 shards of the card under
    # both groupings, each held to the one-device Simulation.
    mesh_lines, mesh_launches, mesh_s = mesh_planes(cfg)
    for line in mesh_lines:
        emit(line)
    emit({"phase": "mesh_planes", "seconds": mesh_s,
          "b7_launches": mesh_launches})
    if not all(line["ok"] for line in mesh_lines):
        emit({"phase": "failed", "failed": [
            line["phase"] for line in mesh_lines if not line["ok"]]})
        return 1

    # The observability plane (ROADMAP A18): launch L against its plain
    # version on four states, the SWIM main path with the lens armed held
    # to the unarmed run above, L's time, the tracer and the debug
    # bundle's profile on that simulation.
    t0 = time.perf_counter()
    windows = lens_parity(cfg)
    lens_err = max(w["max_abs_err"] for w in windows)
    emit({"phase": "lens_parity", "seconds": round(time.perf_counter() - t0, 3),
          "windows": windows})
    if not all(w["ok"] for w in windows):
        emit({"phase": "failed", "failed": ["lens_parity"]})
        return 1
    t0 = time.perf_counter()
    res, lsim = lens_main_path(cfg, main_ref)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "lens_main_path", **res})
    del main_ref
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["lens_main_path"]})
        return 1
    lens_launches = res["lens_launches"]
    lens_t = lens_launch_timing(lsim, rate)
    t0 = time.perf_counter()
    res = trace_capture(lsim, build_spans, info.compiled)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "trace_capture", **res})
    del lsim
    torch.cuda.empty_cache()
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["trace_capture"]})
        return 1

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
    lens_ticks["serf"] = tick_with_and_without_lens(ssim)
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
    m_dense_t = metrics_timing(*dense_finals["dense"], rate, seed=79)

    # Launch M against its plain version on every state above.
    emit({"phase": "metrics_parity", "rtol_rmse": RMSE_RTOL,
          "cases": m_cases})
    if not all(c["ok"] for c in m_cases):
        emit({"phase": "failed", "failed": ["metrics_parity"]})
        return 1
    emit({"phase": "metrics_timing", "n": MAIN_N, "pairs": METRIC_PAIRS,
          "launch": m_t, "launch_dense": dict(n=DENSE_N, **m_dense_t),
          "tick_ms": m_ticks, "main_path_metrics_launches": m_launches})
    # Launch L alone on the lens main path's final state, and a tick with
    # the lens armed against one without on the SWIM and serf paths.
    emit({"phase": "lens_timing", "n": MAIN_N, "launch": lens_t,
          "tick_ms": lens_ticks, "ratio_max": LENS_TICK_RATIO_MAX,
          "main_path_lens_launches": lens_launches})
    if not all(t["ratio"] <= LENS_TICK_RATIO_MAX for t in lens_ticks.values()):
        emit({"phase": "failed", "failed": ["lens_timing"]})
        return 1

    # run_resilient at 1M: preempted, resumed, bit-equal.
    res = resilient_phase(cfg)
    emit({"phase": "resilient", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["resilient"]})
        return 1

    # The serving plane over the live 1M simulation (bench.py:736-815):
    # reads card against CPU and the tie, the serving and mixed phases (the
    # tick kernel's launches counted from the serving phase's first tick to
    # the mixed run's last flip), the write/watch check on the mixed run,
    # then the trajectory with and without a plane.
    t_serving = time.perf_counter()
    res = serving_parity_reads(cfg)
    torch.cuda.empty_cache()
    emit({"phase": "serving_parity", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["serving_parity (a, b)"]})
        return 1
    reset_launches()
    qsim, res = serving_phase(cfg, rate)
    emit({"phase": "serving", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["serving"]})
        return 1
    mixed, check = serving_mixed_phase(qsim)
    serving_launches = tick_launches(cuda_gossip.LAUNCHES)
    mixed["tick_launches"] = serving_launches
    emit({"phase": "serving_mixed", "n": cfg.n, **mixed})
    emit({"phase": "serving_parity", **check})
    del qsim
    torch.cuda.empty_cache()
    if not (mixed["ok"] and serving_launches > 0):
        emit({"phase": "failed", "failed": ["serving_mixed"]})
        return 1
    if not check["ok"]:
        emit({"phase": "failed", "failed": ["serving_parity (c)"]})
        return 1
    res = serving_trajectory(cfg)
    torch.cuda.empty_cache()
    res["serving_phases_s"] = round(time.perf_counter() - t_serving, 3)
    emit({"phase": "serving_parity", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["serving_parity (d)"]})
        return 1

    # The raft tier (ROADMAP A16) over the 1M simulation: card against
    # CPU (and the gossip trajectory with and without raft, and the
    # kernel under a raft-only schedule), the bench's flow for both
    # shapes, the write gate under the mix and the leader-kill drill, the
    # raft tick's cost. Tick launches of these paths join the bare and
    # chaos rows.
    t_raft = time.perf_counter()
    raft_launches = {"bare": 0, "raft_schedule": 0}
    for i, (g, p) in enumerate(RAFT_SHAPES):
        res = raft_parity(cfg, g, p, seed=43 + i, twin=i == 0)
        torch.cuda.empty_cache()
        if "float_gaps" in res:
            fold_abs("gossip_tick_chaos", res)
        emit({"phase": "raft_parity", **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [f"raft_parity {g}x{p}"]})
            return 1
    for g, p in RAFT_SHAPES:
        res = raft_main_path(cfg, g, p)
        torch.cuda.empty_cache()
        emit({"phase": "raft_main_path", **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [f"raft_main_path {g}x{p}"]})
            return 1
        raft_launches["bare"] += res["tick_launches_bare"]
        raft_launches["raft_schedule"] += res["tick_launches_raft_schedule"]
    res = raft_serving(cfg)
    torch.cuda.empty_cache()
    emit({"phase": "raft_serving", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["raft_serving"]})
        return 1
    raft_launches["bare"] += res["tick_launches_bare"]
    raft_launches["raft_schedule"] += res["tick_launches_raft_schedule"]
    res = raft_timing(cfg)
    torch.cuda.empty_cache()
    res["raft_phases_s"] = round(time.perf_counter() - t_raft, 3)
    res["tick_launches"] = raft_launches
    emit({"phase": "raft_timing", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["raft_timing"]})
        return 1

    # Scenario sweeps (ROADMAP A17): the lanes through the kernel against
    # the plain tick on every family, then bench_pareto at 1M, the serf
    # and raft sweeps and the bench's own shape. Their lanes run the
    # chaos variants with the sentinel off (B2, B6); forming runs B1.
    t_sweep = time.perf_counter()
    cases = [(f, False) for f in SWEEP_FAMILIES] + [("circulant", True)]
    for i, (n, (family, serf_plane)) in enumerate(
            [(SWEEP_PARITY_N, c) for c in cases]
            + [(MAIN_N, c) for c in cases]):
        t0 = time.perf_counter()
        if n == MAIN_N:
            res = sweep_parity(n, family, serf_plane, seed=59 + i,
                               lanes=main_path_lanes,
                               settle=SWEEP_PARITY_MAIN_SETTLE)
        else:
            res = sweep_parity(n, family, serf_plane, seed=59 + i)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "sweep_parity", **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [
                f"sweep_parity {n} {family}"
                + (" serf" if serf_plane else "")]})
            return 1
    sweep_launches = {"bare": 0, "chaos": 0, "serf_chaos": 0}
    for phase, fn in (("sweep_main_path", lambda: sweep_main_path(cfg)),
                      ("sweep_serf", lambda: sweep_serf(cfg)),
                      ("sweep_raft", lambda: sweep_raft(cfg)),
                      ("sweep_bench_shape", sweep_bench_shape)):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": phase, **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [phase]})
            return 1
        for k, v in res["tick_launches"].items():
            sweep_launches[k] += v
    emit({"phase": "sweep_phases", "seconds": round(
        time.perf_counter() - t_sweep, 3), "tick_launches": sweep_launches})

    # The federation and the DCN tier (ROADMAP A14): every DC's LAN pool
    # through the kernel (B1), the WAN pool through it on the dense view
    # (n = 12, K = 11; the DCN drill's n = 4, K = 3), against the plain
    # tick, then BASELINE.json's fifth config and bench.py's DCN drill.
    t_fed = time.perf_counter()
    for kw in (FED_PARITY, FED_MAIN):
        t0 = time.perf_counter()
        res = federation_parity(61, kw)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        max_abs["gossip_tick"] = max([max_abs["gossip_tick"]] + [
            g["abs"] for g in res["float_gaps_lan"].values()])
        max_abs["gossip_tick_wan_dense"] = max(
            [max_abs["gossip_tick_wan_dense"]]
            + [g["abs"] for g in res["float_gaps_wan"].values()])
        emit({"phase": "federation_parity", **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": ["federation_parity"]})
            return 1
    t0 = time.perf_counter()
    res, wan_t = federation_main_path(rate)
    torch.cuda.empty_cache()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "federation_main_path", **res})
    emit({"phase": "federation_wan_timing", **wan_t,
          "profile_misses": PROFILE_MISSES})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["federation_main_path"]})
        return 1
    fed_launches = dict(res["kernel_launches"])
    t0 = time.perf_counter()
    drill, big = dcn_drill()
    torch.cuda.empty_cache()
    drill["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "dcn_drill", **drill})
    emit({"phase": "dcn_drill_250k", **big})
    if not (drill["ok"] and big["ok"]):
        emit({"phase": "failed", "failed": ["dcn_drill"]})
        return 1
    for name in ("gossip_tick", "gossip_tick_wan_dense"):
        max_abs[name] = max([max_abs[name]] + [
            g["abs"] for r in (drill, big)
            for g in r["plain_float_gaps"].values()])
    for r in (drill, big):
        for k in fed_launches:
            fed_launches[k] += r["kernel_launches"][k]
    emit({"phase": "federation_phases", "seconds": round(
        time.perf_counter() - t_fed, 3), "kernel_launches": fed_launches})

    # The game day's slice (ROADMAP A10, A19): the fused serf tick (B4)
    # against the pre-fusion oracle, the snapshotter's warm rejoin, the
    # async front end against the batchers, then the game day itself.
    # Each phase zeroes the counts before it drives its path.
    t_gd = time.perf_counter()
    gd_launches = {"bare": 0, "chaos": 0, "serf": 0, "serf_chaos": 0,
                   "wan": 0, "serf_reference": 0}
    oracle_ms, oracle_plain_ms = [], []
    for with_chaos in (False, True):
        t0 = time.perf_counter()
        res = serf_reference_parity(cfg, with_chaos)
        torch.cuda.empty_cache()
        res["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "serf_reference_parity", **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [
                "serf_reference_parity " + res["scenario"]]})
            return 1
        oracle_ms.append(res["oracle_ms_per_tick"])
        oracle_plain_ms.append(res["plain_ms"])
        # Each path ran the fault window's ticks with P: the fused twin 5
        # launches a tick there and 4 elsewhere; the oracle on B8 6 and 5.
        lc = res["launches"]
        b8 = 5 * lc["ref_send"] + lc["chaos_pre"] // 2
        gd_launches["serf_reference"] += b8
        chaos_ticks = lc["chaos_pre"] // 2
        gd_launches["serf_chaos"] += 5 * chaos_ticks
        gd_launches["serf"] += tick_launches(lc) - b8 - 5 * chaos_ticks
    t0 = time.perf_counter()
    res = snapshot_rejoin(cfg)
    torch.cuda.empty_cache()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "snapshot_rejoin", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["snapshot_rejoin"]})
        return 1
    gd_launches["serf"] += tick_launches(res["launches"])
    t0 = time.perf_counter()
    res = frontend_parity(cfg)
    torch.cuda.empty_cache()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "frontend_parity", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["frontend_parity"]})
        return 1
    gd_launches["bare"] += tick_launches(res["launches"])
    t0 = time.perf_counter()
    runs = gameday_main_path()
    for name, r in runs.items():
        emit({"phase": "gameday_main_path", "run": name, **r})
        gd_launches["bare"] += r["b1_main"] + r["b1_islands"]
        gd_launches["chaos"] += r["b2"]
        gd_launches["wan"] += r["b5_wan"]
    if not all(r["ok"] for r in runs.values()):
        emit({"phase": "failed", "failed": ["gameday_main_path"]})
        return 1
    emit({"phase": "gameday_phases", "seconds": round(
        time.perf_counter() - t_gd, 3), "tick_launches": gd_launches,
        "oracle_ms_per_tick": oracle_ms,
        "plain_oracle_ms_per_tick": oracle_plain_ms})

    # The port's CLI (ROADMAP A19's remainder, A20's prewarm): every sim
    # verb through ``python -m consul_tpu_torch.cli`` at 1M, then the
    # SIGTERM drill.
    t0 = time.perf_counter()
    res = cli_main_path()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "cli_main_path", **res})
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["cli_main_path"]})
        return 1

    # The CUDA-init black box, captured live.
    res = blackbox_live()
    emit({"phase": "blackbox_live", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["blackbox_live"]})
        return 1

    # The federation on a (dc, nodes) mesh of the card and the DCN tier on
    # meshes (ROADMAP A13 item 4), then cohort streaming (A12b). Each
    # phase zeroes the counts before it drives its path.
    new_launches = {"b7": 0, "wan": 0, "swim": 0, "serf": 0, "chaos": 0}
    t0 = time.perf_counter()
    res = federation_mesh()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "federation_mesh", "nvidia_smi": nvidia_smi(), **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["federation_mesh"]})
        return 1
    for r in res["runs"].values():
        new_launches["b7"] += r["b7_launches"]
        new_launches["wan"] += r["wan_launches"]
    t0 = time.perf_counter()
    res = dcn_meshes()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "dcn_meshes", "nvidia_smi": nvidia_smi(), **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["dcn_meshes"]})
        return 1
    for r in res["runs"].values():
        new_launches["b7"] += r["b7_launches"]
        new_launches["wan"] += r["wan_launches"]
    for kind, spec in (("swim", STREAM_SWIM), ("serf", STREAM_SERF)):
        t0 = time.perf_counter()
        res = streamed_case(kind, spec)
        res["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "streamed", "nvidia_smi": nvidia_smi(), **res})
        if not res["ok"]:
            emit({"phase": "failed", "failed": [f"streamed {kind}"]})
            return 1
        new_launches[kind] += res["kernel_launches"]

    # The transport seam with agents attached (B1, B4) and the card's raft
    # tier against the port's own lockstep oracle (B2) (ROADMAP A21, first
    # part). Each phase zeroes the counts before it drives its path.
    t0 = time.perf_counter()
    res = wire_host()
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "wire_host", **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["wire_host"]})
        return 1
    runs = bridge_main_path()
    for kind, r in runs.items():
        emit({"phase": "bridge_main_path", "plane": kind,
              "nvidia_smi": nvidia_smi(), **r})
        new_launches[kind] += r["tick_launches"]
    if not all(r["ok"] for r in runs.values()):
        emit({"phase": "failed", "failed": ["bridge_main_path"]})
        return 1
    t0 = time.perf_counter()
    res = raft_lockstep_oracle(SimConfig(n=MAIN_N, view_degree=32))
    res["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "raft_lockstep_oracle", "nvidia_smi": nvidia_smi(), **res})
    if not res["ok"]:
        emit({"phase": "failed", "failed": ["raft_lockstep_oracle"]})
        return 1
    new_launches["chaos"] += res["tick_launches"]

    # The servers' control plane on the tick (ROADMAP A21 item 1): member
    # rows of the serf plane (B4) into the raft-backed catalog, Vivaldi
    # rows of the SWIM plane (B1) into Coordinate.Update and ?near= reads
    # on the card. Each part zeroes the counts before it drives its path.
    runs = server_main_path()
    for kind, r in runs.items():
        emit({"phase": "server_main_path", "part": kind,
              "nvidia_smi": nvidia_smi(), **r})
    new_launches["serf"] += runs["membership"]["tick_launches"]
    new_launches["swim"] += runs["coordinates"]["tick_launches"]
    if not all(r["ok"] for r in runs.values()):
        emit({"phase": "failed", "failed": ["server_main_path"]})
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
            "sentinel=False, sparse, packed (SWIM path, the raft paths, "
            "the sweeps' forming, every DC's LAN pool of the federation "
            "and the DCN islands, the front end's planes, the game "
            "day's warmup, steady and drain and its DCN islands, the "
            "streamed SWIM cohorts, the bridged Simulation with an "
            "agent attached, and the server tier's coordinate run)",
            swim_launches + raft_launches["bare"] + sweep_launches["bare"]
            + fed_launches["lan"] + gd_launches["bare"]
            + new_launches["swim"], swim_t),
        row("gossip_tick_serf", "step_fn=serf.step_counted (extra_tx), "
            "sched=None, sentinel=False, sparse, packed (serf path; the "
            "oracle's fused twin, the snapshot rejoin, the streamed "
            "serf cohorts, the bridged fleet of 32 agents and the server "
            "tier's membership run)",
            serf_launches + gd_launches["serf"] + new_launches["serf"],
            serf_t),
        row("gossip_tick_chaos", "step_fn=swim.step_counted, sched=<composed>, "
            "sentinel=True (chaos path); sched=<raft-only>, sentinel=False "
            "(raft paths and the raft lockstep oracle's run); "
            "sched=<sweep lane>, sentinel=False, families "
            "circulant, expander, smallworld, hier (sweeps); "
            "sched=<composed with RaftKill>, sentinel=False (the game day's "
            "fault and heal), sparse, packed",
            chaos_launches + raft_launches["raft_schedule"]
            + sweep_launches["chaos"] + gd_launches["chaos"]
            + new_launches["chaos"], chaos_t),
        row("gossip_tick_sentinel", "step_fn=swim.step_counted, sched=None, "
            "sentinel=True, sparse, packed", sentinel_launches, sentinel_t),
        row("gossip_tick_serf_chaos", "step_fn=serf.step_counted (extra_tx), "
            "sched=<composed> or None, sentinel=True (serf chaos path); "
            "sched=<sweep lane>, sentinel=False, circulant (serf sweep); "
            "sched=<link loss>, sentinel=False (the oracle's fused twin), "
            "sparse, packed",
            serf_chaos_launches + sweep_launches["serf_chaos"]
            + gd_launches["serf_chaos"], serf_chaos_t),
        row("gossip_tick_serf_reference", "B8: step_fn="
            "serf.step_reference_counted (the pre-fusion oracle: A-C bare, "
            "then E1 ref_send and E2 ref_intake), sched=None or <link loss>, "
            "sentinel=False, sparse, packed: ReferenceSerfSimulation on the "
            "card (timed on the quiet 1M window's state; windows also under "
            "a schedule with the sentinel, dense, stress and tie-and-wrap)",
            gd_launches["serf_reference"], b8_t)] + dense_rows + [
        row("gossip_tick_wan_dense", "step_fn=swim.step_counted, sched=None, "
            "sentinel=False, dense, packed: the federation's WAN pool (n = "
            f"{FED_MAIN['n_dc'] * FED_MAIN['servers_per_dc']}, K = "
            f"{FED_MAIN['n_dc'] * FED_MAIN['servers_per_dc'] - 1}, timed) and "
            "the DCN islands' (n = 4, K = 3); one partly filled warp tile, "
            "so launch-bound (the game day's DCN islands, and the meshed "
            "federation's and the DCN meshes' WAN pools too)",
            fed_launches["wan"] + gd_launches["wan"] + new_launches["wan"],
            wan_t)] + [
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
         "library_ms": None},
        {"name": "gossip_lens", "route": "cuda",
         "source": "consul_tpu_torch/csrc/gossip_tick.cu",
         "replaces": "consul_tpu/obs/lens.py:88",
         "config": f"launch L: the node-lens row of S = {lens_t['s']} sampled "
                   "nodes from the packed leaves, once a tick with the lens "
                   "armed (not a TPU kernel: the reference's XLA gathers in "
                   "its chunk scan)",
         "launches": lens_launches, "max_abs_err": lens_err,
         "ms": lens_t["ms"], "ms_events": lens_t["ms_events"],
         "plain_ms": lens_t["plain_ms"], "bound_ms": lens_t["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "gossip_tick_sharded", "route": "cuda",
         "source": "consul_tpu_torch/csrc/gossip_tick.cu",
         "replaces": "consul_tpu/ops/pallas_gossip.py:145",
         "config": f"B7: the tick once per node-axis shard (the reference's "
                   f"shard_map call, consul_tpu/parallel/shard_step.py:253), "
                   f"{SHARD_MAIN} shards of the 1M SWIM main path on one card "
                   "in one device group (one launch set a stage, no "
                   "exchange), and the mesh's planes (raft, serving, the "
                   "sweep lanes' chaos variant with the sentinel off, the "
                   "elastic drill) under both groupings; the LAN pools of "
                   "the federation on a (2, 4) mesh and of the DCN islands "
                   "on (2, 2) meshes, one kernel a DC; timed at "
                   f"{SHARD_MAIN} shards (ms_by_shards: each of "
                   f"{list(SHARDS)}, and '/shard' one group per shard, "
                   "mirrors exchanged between launches)",
         "launches": b7_ticks_of(shard_res["b7_launches"]) + mesh_launches
         + new_launches["b7"],
         "max_abs_err": max_abs["gossip_tick_sharded"],
         "ms": b7_t[str(SHARD_MAIN)]["ms_per_tick"],
         "plain_ms": b7_t[str(SHARD_MAIN)]["plain_ms"],
         "bound_ms": b7_t[str(SHARD_MAIN)]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "b1_ms": b7_t["b1_ms_per_tick"],
         "ms_by_shards": {r: {k: t[k] for k in (
             "per_tick", "ms_per_tick", "device_ms", "ms_exchange",
             "ms_launches", "plain_ms", "bound_ms") if k in t}
             for r, t in b7_t.items() if isinstance(t, dict)}}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
