"""Multi-process client swarm for the game day's HTTP surface (the port's
copy of ``consul_tpu/gameday/swarm.py``).

Each worker is an OS process (``python -m consul_tpu_torch.gameday.swarm
HOST PORT REQUESTS SEED``) driving the async front end's socket listener
with stdlib ``http.client``: catalog reads, health lookups, KV puts and
short blocking queries (``?index=`` + ``?wait=``), and printing ONE JSON
stats line on stdout. The parent (:func:`start_swarm` /
:func:`collect_swarm`) spawns N workers with ``subprocess.Popen`` and folds
their lines into one report. Workers are plain subprocesses so that the
traffic arrives over real sockets from outside the serving process. Their
import chain (this module and ``consul_tpu_torch/gameday/__init__.py``)
holds no ``torch``.

The swarm drives the HTTP surface only; the DNS surface is not served by
the async front end.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time


def worker(host: str, port: int, requests: int, seed: int) -> dict:
    """One swarm worker's request loop (runs in the child process).
    Mix: ~60% reads (catalog/health), ~20% KV puts, ~20% short
    blocking queries riding the last seen X-Consul-Index."""
    import http.client

    rng = random.Random(seed)
    pid = os.getpid()
    ok = failed = blocking = 0
    lats = []
    last_index = 0
    conn = http.client.HTTPConnection(host, port, timeout=30)
    for i in range(requests):
        roll = rng.random()
        if roll < 0.3:
            path = "/v1/catalog/nodes"
        elif roll < 0.6:
            path = f"/v1/health/service/{rng.randrange(8)}"
        elif roll < 0.8:
            path = f"/v1/kv/swarm/{pid}/{i}"
        else:
            blocking += 1
            path = (f"/v1/kv/swarm/{pid}/blk"
                    f"?index={last_index}&wait=50ms")
        t0 = time.perf_counter()
        try:
            if "/v1/kv/" in path and "?" not in path:
                conn.request("PUT", path, body=str(i))
            else:
                conn.request("GET", path)
            resp = conn.getresponse()
            resp.read()
            idx = resp.getheader("X-Consul-Index")
            if idx is not None:
                last_index = max(last_index, int(idx))
            if resp.status < 500:
                ok += 1
            else:
                failed += 1
        except (OSError, http.client.HTTPException):
            failed += 1
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=30)
        lats.append(time.perf_counter() - t0)
    conn.close()
    lats.sort()
    return {
        "pid": pid,
        "requests": ok + failed,
        "ok": ok,
        "failed": failed,
        "blocking": blocking,
        "last_index": last_index,
        "p50_ms": round(lats[len(lats) // 2] * 1e3, 3) if lats else 0.0,
        "p99_ms": round(
            lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3, 3)
        if lats else 0.0,
    }


def start_swarm(host: str, port: int, *, procs: int, requests: int,
                seed: int = 0) -> list:
    """Spawn the worker processes (non-blocking); returns the handle
    list :func:`collect_swarm` folds. Workers inherit the current
    interpreter, environment and working directory; ``torch`` is never
    imported on their path."""
    out = []
    for j in range(max(1, procs)):
        out.append(subprocess.Popen(
            [sys.executable, "-m", "consul_tpu_torch.gameday.swarm",
             host, str(port), str(requests), str(seed + j)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
    return out


def collect_swarm(handles: list, timeout_s: float = 120.0) -> dict:
    """Join every worker and fold the per-process stats lines into one
    report. A worker that dies or times out counts its whole quota as
    failed — the swarm never under-reports trouble."""
    procs = requests = ok = failed = blocking = 0
    p99s = []
    last_index = 0
    for p in handles:
        procs += 1
        try:
            stdout, _ = p.communicate(timeout=timeout_s)
            line = stdout.strip().splitlines()[-1] if stdout.strip() \
                else "{}"
            st = json.loads(line)
        except (subprocess.TimeoutExpired, ValueError, IndexError):
            p.kill()
            p.wait()
            st = {}
        if not st or p.returncode != 0:
            failed += 1
            continue
        requests += int(st.get("requests", 0))
        ok += int(st.get("ok", 0))
        failed += int(st.get("failed", 0))
        blocking += int(st.get("blocking", 0))
        last_index = max(last_index, int(st.get("last_index", 0)))
        p99s.append(float(st.get("p99_ms", 0.0)))
    return {
        "procs": procs,
        "requests": requests,
        "ok": ok,
        "failed": failed,
        "blocking": blocking,
        "last_index": last_index,
        "p99_ms": max(p99s) if p99s else 0.0,
    }


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4:
        print(json.dumps({"error": "usage: swarm HOST PORT REQS SEED"}))
        return 2
    host, port, requests, seed = (argv[0], int(argv[1]), int(argv[2]),
                                  int(argv[3]))
    print(json.dumps(worker(host, port, requests, seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
