"""QueryBatcher: collect concurrent read requests into fixed-shape padded
batches and run each batch as one call of ``ops/serving.execute``
(PyTorch port of ``consul_tpu/serving/batcher.py``).

Batch sizes are bucketed (default 1/8/64/512): a request that arrives
alone pays one small-bucket call, requests that arrive together share
one, and padding slots run as MODE_NOOP (count 0, no ids), their cost
surfaced through the ``sim.serving.padded_slots`` counter and the
``padding_waste_pct`` stat. Each batch makes one host-to-device copy of
its queries and one device-to-host copy of its four results, never one
per query.

Concurrency model: there is no background thread. ``submit()`` parks
the caller up to ``max_wait_s``; whoever's wait expires first pumps
every pending request into one batch and fans the results back to the
other waiters. ``execute()`` is the synchronous path for callers that
already hold a whole batch (the bench, row sorting). Batches run on the
callers' threads while the simulation's chunk loop runs on its own; on
the card both enqueue on the default stream, so a batch issued after a
flip reads the snapshot that flip published, completed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import serving as kernels


class ServingClosedError(RuntimeError):
    """The serving plane (or one of its batchers) has been closed: parked
    waiters are woken with this, and new submits are rejected with it."""


class ServingOverloadError(RuntimeError):
    """Admission control rejected a submit: the bounded pending queue is
    full and the batcher's policy is ``reject`` (callers retry with
    backoff; the ``shed_oldest`` policy drops the oldest waiter instead
    and admits the new one)."""


class QueryResult(NamedTuple):
    """One query's answer: ``ids[i]``/``rtts[i]`` for i < count are the
    result rows (node indices and estimated RTT seconds, +inf for
    eligible-but-unknown coordinates); slots at and past ``count`` hold
    id -1 / rtt +inf. ``tick`` is the snapshot tick the answer is
    consistent as of."""

    ids: np.ndarray    # [k] int32
    rtts: np.ndarray   # [k] float32
    count: int
    tick: int


def results_to_host(ids, rtts, count, tick):
    """The four results of one batch as numpy, in one device-to-host copy:
    (ids [B, k] int32, rtts [B, k] float32, count [B] int32, tick int)."""
    b, k = ids.shape
    tick_t = torch.as_tensor(tick, dtype=torch.int32, device=ids.device)
    flat = torch.cat([ids.reshape(-1), rtts.reshape(-1).view(torch.int32),
                      count.reshape(-1), tick_t.reshape(1)]).cpu().numpy()
    bk = b * k
    return (flat[:bk].reshape(b, k), flat[bk:2 * bk].view(np.float32).reshape(b, k),
            flat[2 * bk:2 * bk + b], int(flat[-1]))


def latency_pcts(samples) -> tuple[float, float]:
    """(p50, p99) of latencies in seconds, in ms rounded to 3 places."""
    lats = sorted(samples)
    if not lats:
        return 0.0, 0.0
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    return round(p50 * 1e3, 3), round(p99 * 1e3, 3)


class _Waiter:
    __slots__ = ("mode", "src", "arg", "done", "result", "error")

    def __init__(self, mode: int, src: int, arg: int):
        self.mode = mode
        self.src = src
        self.arg = arg
        self.done = threading.Event()
        self.result: Optional[QueryResult] = None
        self.error: Optional[Exception] = None


def bucket_for(buckets: Sequence[int], b: int) -> int:
    """The smallest bucket that holds ``b`` (the largest when none does)."""
    for cap in buckets:
        if cap >= b:
            return cap
    return buckets[-1]


class QueryBatcher:
    """Packs (mode, src, arg) queries into padded bucketed batches and
    executes them against ``plane.snapshot()``."""

    def __init__(self, plane, k: int = 16,
                 buckets: Sequence[int] = (1, 8, 64, 512),
                 max_wait_s: float = 0.002):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.plane = plane
        self.k = int(k)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._pending: list[_Waiter] = []
        self._closed = False
        # Plain-int counters mirror the sink emissions so stats() works
        # without a sink attached.
        self.batches = 0
        self.queries = 0
        self.padded_slots = 0
        self.latencies_s: deque[float] = deque(maxlen=4096)

    # -- synchronous batched path ---------------------------------------
    def execute(self, queries: Sequence[tuple[int, int, int]]
                ) -> list[QueryResult]:
        """Run a caller-assembled batch; oversize inputs are chunked at the
        largest bucket. One call and one host copy per chunk."""
        out: list[QueryResult] = []
        for i in range(0, len(queries), self.max_batch):
            out.extend(self._run_batch(queries[i:i + self.max_batch]))
        return out

    def _run_batch(self, queries: Sequence[tuple[int, int, int]]
                   ) -> list[QueryResult]:
        snap = self.plane.snapshot()
        t0 = time.perf_counter()
        b = len(queries)
        bucket = bucket_for(self.buckets, b)
        qs = np.empty((3, bucket), dtype=np.int32)
        qs[0] = kernels.MODE_NOOP
        qs[1] = 0
        qs[2] = -1
        if b:
            qs[:, :b] = np.asarray(queries, dtype=np.int32).T
        dq = torch.from_numpy(qs).to(kernels.device_of(snap))
        kernel = getattr(self.plane, "kernel", None)
        kernel = kernel() if kernel is not None else kernels.kernel_for(self.k)
        h_ids, h_rtts, h_count, tick = results_to_host(
            *kernel(snap, dq[0], dq[1], dq[2]))

        pad = bucket - b
        # execute() runs on caller threads concurrently with pump(): the
        # counters need the lock, taken after the host copy.
        with self._lock:
            self.latencies_s.append(time.perf_counter() - t0)
            self.batches += 1
            self.queries += b
            self.padded_slots += pad
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.batches", 1)
            sink.incr_counter("sim.serving.queries", b)
            if pad:
                sink.incr_counter("sim.serving.padded_slots", pad)
        return [QueryResult(h_ids[j], h_rtts[j], int(h_count[j]), tick)
                for j in range(b)]

    # -- concurrent submit / fan-out path -------------------------------
    def submit(self, mode: int, src: int, arg: int = -1,
               timeout_s: float = 10.0) -> QueryResult:
        """Enqueue one query and block for its result. Concurrent
        submitters coalesce: each parks up to ``max_wait_s`` and the first
        to time out (or to fill the largest bucket) pumps the whole
        pending set as one batch, fanning results back."""
        w = _Waiter(int(mode), int(src), int(arg))
        with self._lock:
            if self._closed:
                raise ServingClosedError("serving plane is closed")
            self._pending.append(w)
            full = len(self._pending) >= self.max_batch
        if full:
            self.pump()
        deadline = time.monotonic() + timeout_s
        while not w.done.wait(self.max_wait_s):
            if time.monotonic() >= deadline:
                raise TimeoutError("serving query timed out")
            self.pump()
        if w.error is not None:
            raise w.error
        return w.result

    def pump(self) -> int:
        """Drain pending waiters (up to one max bucket) into one batch;
        returns how many were served."""
        with self._lock:
            batch = self._pending[:self.max_batch]
            del self._pending[:len(batch)]
        if not batch:
            return 0
        try:
            with obs_trace.span("serving.query_pump", cat="serving",
                                args={"n": len(batch)}):
                results = self._run_batch([(w.mode, w.src, w.arg)
                                           for w in batch])
        except Exception as e:  # noqa: BLE001 - handed to every waiter
            for w in batch:
                w.error = e
                w.done.set()
            raise
        for w, r in zip(batch, results):
            w.result = r
            w.done.set()
        return len(batch)

    # -- shutdown: wake every parked waiter, reject every new submit ----
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent: mark closed, fail parked waiters with
        :class:`ServingClosedError`, reject new submits."""
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, []
        for w in pending:
            w.error = ServingClosedError("serving plane closed while "
                                         "query was pending")
            w.done.set()

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        p50, p99 = latency_pcts(self.latencies_s)
        slots = self.queries + self.padded_slots
        return {
            "batches": self.batches,
            "queries": self.queries,
            "padded_slots": self.padded_slots,
            "padding_waste_pct": round(100.0 * self.padded_slots
                                       / max(1, slots), 2),
            "p50_batch_ms": p50,
            "p99_batch_ms": p99,
        }
