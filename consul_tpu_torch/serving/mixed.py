"""Mixed read/write/watch serving benchmark driver (PyTorch port of
``consul_tpu/serving/mixed.py``, the shared driver of the mixed phase).

Drives the three serving classes against one sim-attached plane in
interleaved rounds at a fixed R:W:Watch ratio: each round executes one
read batch (QueryBatcher), the round's share of writes (WriteBatcher),
and one snapshot flip (``sim.publish_serving``) whose delta fan-out
feeds the registered watchers. Each class's q/s is its op count over the
wall time spent inside that class's calls, with p50/p99 over the
per-call latencies, under one stable JSON shape:

``{"ratio", "read": {count, qps_per_chip, p50_ms, p99_ms},
   "write": {...}, "watch": {flips, deliveries, watchers, ...}}``

Each class's time ends with its results on the host (the batchers copy
their results back), and a flip ends with its frame on the host, so no
class's time leaves device work queued for the next one.
"""

from __future__ import annotations

import random
import time

from consul_tpu_torch.ops import deltas
from consul_tpu_torch.ops.serving import MODE_NEAREST
from consul_tpu_torch.serving.batcher import latency_pcts


def parse_ratio(spec: str) -> tuple[int, int, int]:
    """``"90:9:1"`` -> (90, 9, 1); the read share must be positive."""
    parts = [int(x) for x in str(spec).split(":")]
    if len(parts) != 3 or min(parts) < 0 or parts[0] <= 0:
        raise ValueError(
            f"--mixed wants R:W:WATCH with positive reads, got {spec!r}")
    return parts[0], parts[1], parts[2]


def run_mixed(sim, plane, *, ratio: str = "90:9:1", rounds: int = 16,
              read_batch: int = 256, watchers: int = 8,
              seed: int = 0) -> dict:
    """Run the mixed workload; returns the stable result dict. The plane
    must already be sim-attached with writes (``plane.attach_writes``);
    one read batch, one write batch and one flip + diff run before the
    timed rounds."""
    r, w_share, watch_share = parse_ratio(ratio)
    n = sim.cfg.n
    rng = random.Random(seed)
    write_batch = max(1, round(read_batch * w_share / r))
    # Watch class: `watchers` registered watchers fed by one flip per
    # round, spread over the service keys (floor one watcher).
    n_watchers = max(1, watchers if watch_share else 1)
    svc_width = max(plane.num_services, 1)
    hooks = [plane.watch.register("service", i % svc_width)
             for i in range(n_watchers)]
    kv_hook = plane.watch.register("kv_prefix", "bench/")

    def read_ops():
        return [(MODE_NEAREST, rng.randrange(n), -1)
                for _ in range(read_batch)]

    def write_ops():
        ops = []
        for _ in range(write_batch):
            roll = rng.random()
            node = rng.randrange(n)
            if roll < 0.5:
                ops.append((deltas.OP_REGISTER, node,
                            rng.randrange(svc_width)))
            elif roll < 0.75:
                slot = plane.keys.slot_for(
                    f"bench/{rng.randrange(64)}", create=True)
                ops.append((deltas.OP_KV_PUT, slot, rng.randrange(1000)))
            else:
                ops.append((deltas.OP_DEREGISTER, node, -1))
        return ops

    # Warm every path out of the timed region.
    plane.batcher.execute(read_ops())
    plane.writes.execute(write_ops())
    sim.publish_serving()
    plane.batcher.latencies_s.clear()
    plane.writes.latencies_s.clear()

    read_t = write_t = watch_t = 0.0
    reads = writes = 0
    flip_lats = []
    deliveries0 = plane.watch.deltas
    t_all = time.perf_counter()
    for _ in range(max(1, rounds)):
        t0 = time.perf_counter()
        plane.batcher.execute(read_ops())
        read_t += time.perf_counter() - t0
        reads += read_batch

        t0 = time.perf_counter()
        plane.writes.execute(write_ops())
        write_t += time.perf_counter() - t0
        writes += write_batch

        t0 = time.perf_counter()
        sim.publish_serving()   # flip + diff + watch fan-out
        dt = time.perf_counter() - t0
        watch_t += dt
        flip_lats.append(dt)
    wall = time.perf_counter() - t_all
    deliveries = plane.watch.deltas - deliveries0

    rp50, rp99 = latency_pcts(plane.batcher.latencies_s)
    wp50, wp99 = latency_pcts(plane.writes.latencies_s)
    fp50, fp99 = latency_pcts(flip_lats)
    for h in hooks:
        plane.watch.unregister(h)
    plane.watch.unregister(kv_hook)
    return {
        "ratio": f"{r}:{w_share}:{watch_share}",
        "rounds": rounds,
        "wall_s": round(wall, 3),
        "apply_index": plane.apply_index,
        "read": {
            "count": reads,
            "qps_per_chip": round(reads / read_t, 1) if read_t else 0.0,
            "p50_ms": rp50, "p99_ms": rp99,
        },
        "write": {
            "count": writes,
            "qps_per_chip": round(writes / write_t, 1) if write_t else 0.0,
            "p50_ms": wp50, "p99_ms": wp99,
            "rejected": plane.writes.rejected,
            "shed": plane.writes.shed,
        },
        "watch": {
            "watchers": n_watchers + 1,
            "flips": len(flip_lats),
            "deliveries": deliveries,
            "qps_per_chip": (round(deliveries / watch_t, 1) if watch_t
                             else 0.0),
            "p50_ms": fp50, "p99_ms": fp99,
        },
    }
