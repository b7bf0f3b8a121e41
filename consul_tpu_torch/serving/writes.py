"""WriteBatcher: coalesce concurrent catalog/KV/session writes into
fixed-shape batches with admission control (PyTorch port of
``consul_tpu/serving/writes.py``).

The write-side sibling of :class:`~consul_tpu_torch.serving.batcher.
QueryBatcher` — the same bucketed park-and-pump shape (no background
thread: ``submit()`` parks up to ``max_wait_s`` and whoever expires
first pumps every pending write as one batch) — but a batch is a
:class:`~consul_tpu_torch.ops.deltas.WriteBatch` applied to the plane's
:class:`~consul_tpu_torch.ops.deltas.WriteState` by ``apply_writes`` on
the state's device. Applied writes become visible to readers ONLY at
the next snapshot flip (``ServingPlane.publish``): the batcher advances
the *pending* write state, the flip captures it, and the response's
``index`` tells the caller which ``X-Consul-Index`` its effect is
consistent as of.

Admission control: the pending queue is bounded at ``max_pending``.
Policy ``reject`` refuses the NEW submit with
:class:`ServingOverloadError`; policy ``shed_oldest`` completes the
OLDEST parked waiter with a ``shed`` result and admits the new one.
Both count — ``sim.serving.{writes,write_batches,rejected,shed}`` — so
saturation is visible, never silent.

String KV keys live on the host in :class:`KeyTable` (stable key ->
slot allocation, bounded by the write state's slot axis).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import deltas
from consul_tpu_torch.serving.batcher import (ServingClosedError,
                                              ServingOverloadError,
                                              bucket_for, latency_pcts)


class WriteResult(NamedTuple):
    """One write's outcome. ``index`` is the apply index assigned to the
    op (for ``applied`` results, the snapshot index the write becomes
    visible at); ``status`` is ``applied`` / ``rejected`` (invalid op,
    e.g. an out-of-range target) / ``shed`` (dropped by admission control
    before it was applied) / ``proposed`` (staged on the raft tier, index
    -1: the applied result lands on the RaftTicket at quorum commit)."""

    applied: bool
    index: int
    status: str


class KeyTable:
    """Stable host-side string-key -> slot allocation. Slots are never
    recycled (a deleted key keeps its slot, so a later re-put diffs as the
    same watch target); allocation past ``slots`` returns -1 and the plane
    surfaces it as overload."""

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._by_key: dict[str, int] = {}
        self._by_slot: list[str] = []
        self._lock = threading.Lock()

    def slot_for(self, key: str, create: bool = False) -> int:
        with self._lock:
            i = self._by_key.get(key, -1)
            if i < 0 and create and len(self._by_slot) < self.slots:
                i = len(self._by_slot)
                self._by_key[key] = i
                self._by_slot.append(key)
            return i

    def key_of(self, slot: int) -> Optional[str]:
        if 0 <= slot < len(self._by_slot):
            return self._by_slot[slot]
        return None

    def __len__(self) -> int:
        return len(self._by_slot)


class _WriteWaiter:
    __slots__ = ("op", "target", "arg", "done", "result", "error")

    def __init__(self, op: int, target: int, arg: int):
        self.op = op
        self.target = target
        self.arg = arg
        self.done = threading.Event()
        self.result: Optional[WriteResult] = None
        self.error: Optional[Exception] = None


class WriteBatcher:
    """Packs (op, target, arg) writes into padded bucketed batches and
    applies each as one ``deltas.apply_writes`` call against
    ``plane.write_state``."""

    def __init__(self, plane, buckets: Sequence[int] = (1, 8, 64),
                 max_wait_s: float = 0.002, max_pending: int = 1024,
                 policy: str = "reject"):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        if policy not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.plane = plane
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self.max_pending = int(max_pending)
        self.policy = policy
        self._lock = threading.Lock()
        self._pending: list[_WriteWaiter] = []
        self._closed = False
        # Plain-int counters mirror the sink emissions.
        self.writes = 0
        self.write_batches = 0
        self.rejected = 0
        self.shed = 0
        self.padded_slots = 0
        self.latencies_s: deque[float] = deque(maxlen=4096)

    # -- synchronous batched path ---------------------------------------
    def execute(self, ops: Sequence[tuple[int, int, int]]
                ) -> list[WriteResult]:
        """Apply a caller-assembled batch of (op, target, arg); oversize
        inputs chunk at the largest bucket. One call and one host copy
        per chunk."""
        out: list[WriteResult] = []
        for i in range(0, len(ops), self.max_batch):
            out.extend(self._run_batch(ops[i:i + self.max_batch]))
        return out

    def _run_batch(self, ops: Sequence[tuple[int, int, int]]
                   ) -> list[WriteResult]:
        # With the raft tier armed (models/raft.py) the batch becomes a
        # proposal: the gate stages it on a raft group and answers
        # ``proposed``; the commit pump calls ``_apply_batch`` only once a
        # quorum holds the entries, so the apply index (X-Consul-Index)
        # moves strictly at quorum commit.
        gate = self.plane.raft_gate
        if gate is not None:
            return gate.stage(self, ops)
        return self._apply_batch(ops)

    def _apply_batch(self, ops: Sequence[tuple[int, int, int]]
                     ) -> list[WriteResult]:
        t0 = time.perf_counter()
        b = len(ops)
        bucket = bucket_for(self.buckets, b)
        host = np.empty((3, bucket), dtype=np.int32)
        host[0] = deltas.OP_NOOP
        host[1] = 0
        host[2] = -1
        if b:
            host[:, :b] = np.asarray(ops, dtype=np.int32).T
        dev = torch.from_numpy(host).to(self.plane.write_state.service.device)
        batch = deltas.WriteBatch(op=dev[0], target=dev[1], arg=dev[2])
        # The plane serializes batches against flips: apply_writes consumes
        # the CURRENT pending state and installs its successor under the
        # plane's write lock.
        with self.plane.write_lock:
            new_ws, applied, idx = deltas.apply_writes(
                self.plane.write_state, batch)
            self.plane.write_state = new_ws
        out = torch.cat([applied.to(torch.int32), idx]).cpu().numpy()
        h_applied, h_idx = out[:bucket].astype(bool), out[bucket:]

        n_applied = int(h_applied[:b].sum())
        pad = bucket - b
        # _apply_batch runs from caller threads; the counters share
        # self._lock with submit()'s admission bookkeeping. The host copy
        # above stays outside it.
        with self._lock:
            self.latencies_s.append(time.perf_counter() - t0)
            self.writes += n_applied
            self.rejected += b - n_applied
            self.write_batches += 1
            self.padded_slots += pad
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.write_batches", 1)
            if n_applied:
                sink.incr_counter("sim.serving.writes", n_applied)
            if b - n_applied:
                sink.incr_counter("sim.serving.rejected", b - n_applied)
        # Cumulative counters["writes_applied"] IS the apply index.
        self.plane.fold_write_counters(n_applied)

        return [WriteResult(applied=bool(h_applied[j]), index=int(h_idx[j]),
                            status="applied" if h_applied[j] else "rejected")
                for j in range(b)]

    def count_rejected(self, n: int = 1) -> None:
        """Record ``n`` rejections decided outside the batcher (e.g. a full
        KV slot table) under the counter lock."""
        with self._lock:
            self.rejected += n

    # -- concurrent submit / fan-out path with admission control --------
    def submit(self, op: int, target: int, arg: int = -1,
               timeout_s: float = 10.0) -> WriteResult:
        """Enqueue one write and block for its outcome. Concurrent
        submitters coalesce exactly like QueryBatcher.submit; a full
        pending queue triggers the admission policy instead of unbounded
        growth."""
        w = _WriteWaiter(int(op), int(target), int(arg))
        to_shed: Optional[_WriteWaiter] = None
        sink = getattr(self.plane, "sink", None)
        with self._lock:
            if self._closed:
                raise ServingClosedError("serving write plane is closed")
            if len(self._pending) >= self.max_pending:
                if self.policy == "reject":
                    self.rejected += 1
                    if sink is not None:
                        sink.incr_counter("sim.serving.rejected", 1)
                    raise ServingOverloadError(
                        f"write queue full ({self.max_pending} pending, "
                        "policy=reject)")
                to_shed = self._pending.pop(0)
                self.shed += 1
            self._pending.append(w)
            full = len(self._pending) >= self.max_batch
        if to_shed is not None:
            if sink is not None:
                sink.incr_counter("sim.serving.shed", 1)
            to_shed.result = WriteResult(applied=False, index=0,
                                         status="shed")
            to_shed.done.set()
        if full:
            self.pump()
        deadline = time.monotonic() + timeout_s
        while not w.done.wait(self.max_wait_s):
            if time.monotonic() >= deadline:
                raise TimeoutError("serving write timed out")
            self.pump()
        if w.error is not None:
            raise w.error
        return w.result

    def pump(self) -> int:
        """Drain pending waiters (up to one max bucket) into one apply;
        returns how many were served."""
        with self._lock:
            batch = self._pending[:self.max_batch]
            del self._pending[:len(batch)]
        if not batch:
            return 0
        try:
            with obs_trace.span("serving.write_pump", cat="serving",
                                args={"n": len(batch)}):
                results = self._run_batch([(w.op, w.target, w.arg)
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

    # -- shutdown (the QueryBatcher.close discipline) -------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, []
        for w in pending:
            w.error = ServingClosedError("serving plane closed while "
                                         "write was pending")
            w.done.set()

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        p50, p99 = latency_pcts(self.latencies_s)
        return {
            "writes": self.writes,
            "write_batches": self.write_batches,
            "rejected": self.rejected,
            "shed": self.shed,
            "padded_slots": self.padded_slots,
            "p50_batch_ms": p50,
            "p99_batch_ms": p99,
        }
