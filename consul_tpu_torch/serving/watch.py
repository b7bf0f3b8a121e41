"""Watch/streaming plane: blocking queries and watches served as deltas
between consecutive snapshot flips (PyTorch port of
``consul_tpu/serving/watch.py``).

Every flip of a write-attached :class:`ServingPlane` runs one fixed-shape
diff (``ops/deltas.diff_snapshots``) over the (snapshot, write-state)
pair either side of the flip — changed service membership, health
transitions, KV slot changes — and one device-to-host copy brings the
frame to the host. Fan-out then walks a two-level tree: changes
aggregate into (kind, key) groups first — one event per group per flip,
however many rows contributed — and only branches with registered
watchers are visited, so dispatch costs O(groups + matches), never
O(changes x watchers).

The frame's ``apply_index`` is the apply index the new snapshot is
consistent as of; :meth:`WatchPlane.wait_index` is the blocking-query
primitive (return at once when the index has advanced past the caller's,
wait for a flip otherwise, never return a smaller index than called
with).

Backpressure: each watcher's queue is bounded; a full queue drops the
OLDEST event (the newest delta matters most) and counts it into
``sim.serving.shed``. Registered watchers and delivered deltas count
into ``sim.serving.watchers`` / ``sim.serving.deltas``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional

from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import deltas
from consul_tpu_torch.serving.batcher import ServingClosedError

# Watch kinds. "service"/"node"/"kv" take a key (service label, node id,
# exact key string); "kv_prefix" takes a string prefix; "any" receives
# every group's event.
KINDS = ("service", "node", "kv", "kv_prefix", "any")


class WatchEvent(NamedTuple):
    """One aggregated delivery: everything that changed for this watcher's
    (kind, key) branch in one flip. ``index`` is the apply index the delta
    is consistent as of; ``truncated`` marks a frame whose change count
    exceeded the frame width K (re-read instead of trusting the id list
    to be complete)."""

    kind: str
    key: object
    index: int
    tick: int
    changes: tuple        # node rows: (id, kindmask); kv rows: (key, ver)
    truncated: bool


class Watcher:
    """One registered watch: a bounded queue of :class:`WatchEvent` plus a
    condition to park on. ``poll`` returns the next event (None on
    timeout or plane close)."""

    def __init__(self, kind: str, key, max_queue: int):
        self.kind = kind
        self.key = key
        self.queue: deque[WatchEvent] = deque(maxlen=max_queue)
        self.dropped = 0
        self.index = 0          # last delivered apply index
        self.cond = threading.Condition()
        self.closed = False

    def _offer(self, ev: WatchEvent) -> bool:
        """Append under the watcher's lock; returns False when the bounded
        queue evicted its oldest entry (shed)."""
        with self.cond:
            shed = len(self.queue) == self.queue.maxlen
            if shed:
                self.dropped += 1
            self.queue.append(ev)
            self.index = ev.index
            self.cond.notify_all()
        return not shed

    def poll(self, timeout_s: float = 5.0) -> Optional[WatchEvent]:
        deadline = time.monotonic() + timeout_s
        with self.cond:
            while not self.queue and not self.closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self.cond.wait(left)
            return self.queue.popleft() if self.queue else None


class WatchPlane:
    def __init__(self, plane, k: int = 64, max_queue: int = 256):
        self.plane = plane
        self.k = int(k)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        # Two-level tree: kind -> key -> watcher group. The per-kind counts
        # let dispatch skip whole kinds with no registrations.
        self._tree: dict[str, dict] = {kind: {} for kind in KINDS}
        self._kind_counts: dict[str, int] = {kind: 0 for kind in KINDS}
        self._closed = False
        # The apply index of the CURRENT flip, advanced by on_flip under
        # _index_cond.
        self.apply_index = 0
        self._index_cond = threading.Condition()
        # Plain-int counters mirroring the sink emissions.
        self.watchers = 0
        self.deltas = 0
        self.shed = 0
        self.flips = 0
        self.truncated_frames = 0
        # The last flip's frame as the host received it (numpy DeltaFrame).
        self.last_frame = None

    # -- registration ----------------------------------------------------
    def register(self, kind: str, key=None) -> Watcher:
        if kind not in KINDS:
            raise ValueError(f"unknown watch kind {kind!r} "
                             f"(want one of {KINDS})")
        with self._lock:
            if self._closed:
                raise ServingClosedError("watch plane is closed")
            w = Watcher(kind, key, self.max_queue)
            self._tree[kind].setdefault(key, []).append(w)
            self._kind_counts[kind] += 1
            self.watchers += 1
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.watchers", 1)
        return w

    def unregister(self, w: Watcher) -> None:
        with self._lock:
            group = self._tree.get(w.kind, {}).get(w.key)
            if group and w in group:
                group.remove(w)
                self._kind_counts[w.kind] -= 1
                if not group:
                    del self._tree[w.kind][w.key]

    # -- flip fan-out ----------------------------------------------------
    def on_flip(self, prev_pair, cur_pair) -> None:
        """Called by the plane after every snapshot flip with the
        (snapshot, write-state) pairs either side. Runs the diff, copies
        the frame to the host once, advances the blocking index, and
        dispatches through the tree, all inside one ``watch.on_flip``
        span."""
        if prev_pair is None:
            # First flip: nothing to diff — just learn the index.
            self._advance(int(cur_pair[1].apply_index))
            return
        tr = obs_trace.get_tracer()
        t0_us = tr.now_us()
        h = deltas.frame_to_host(
            deltas.diff_kernel_for(self.k)(*prev_pair, *cur_pair))
        self.last_frame = h
        index = int(h.apply_index)
        tick = int(h.tick)
        n_nodes = int(h.n_node_changes)
        n_kv = int(h.n_kv_changes)
        truncated = n_nodes > self.k or n_kv > self.k
        # on_flip runs on whichever thread published, while register and
        # stats read the counters from others.
        with self._lock:
            self.flips += 1
            if truncated:
                self.truncated_frames += 1

        # Level 1: aggregate changed rows into (kind, key) branches — one
        # event per branch regardless of row count.
        groups: dict[tuple, list] = {}
        for j in range(min(n_nodes, self.k)):
            nid = int(h.node_ids[j])
            if nid < 0:
                continue
            row = (nid, int(h.node_kinds[j]))
            groups.setdefault(("node", nid), []).append(row)
            sp, sc = int(h.svc_prev[j]), int(h.svc_cur[j])
            if sp >= 0:
                groups.setdefault(("service", sp), []).append(row)
            if sc >= 0 and sc != sp:
                groups.setdefault(("service", sc), []).append(row)
            groups.setdefault(("any", None), []).append(row)
        keys = getattr(self.plane, "keys", None)
        with self._lock:
            prefixes = (list(self._tree["kv_prefix"])
                        if self._kind_counts["kv_prefix"] else [])
        for j in range(min(n_kv, self.k)):
            slot = int(h.kv_slots[j])
            if slot < 0:
                continue
            key = keys.key_of(slot) if keys is not None else None
            key = key if key is not None else f"slot:{slot}"
            row = (key, int(h.kv_vers[j]))
            groups.setdefault(("kv", key), []).append(row)
            groups.setdefault(("any", None), []).append(row)
            for pfx in prefixes:
                if key.startswith(pfx):
                    groups.setdefault(("kv_prefix", pfx), []).append(row)

        # Level 2: deliver each branch's one event to its watchers.
        delivered = 0
        shed = 0
        for (kind, key), rows in groups.items():
            with self._lock:
                if not self._kind_counts[kind]:
                    continue
                group = list(self._tree[kind].get(key, ()))
            if not group:
                continue
            ev = WatchEvent(kind=kind, key=key, index=index, tick=tick,
                            changes=tuple(rows), truncated=truncated)
            for w in group:
                delivered += 1
                if not w._offer(ev):
                    shed += 1
        with self._lock:
            self.deltas += delivered
            self.shed += shed
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            if delivered:
                sink.incr_counter("sim.serving.deltas", delivered)
            if shed:
                sink.incr_counter("sim.serving.shed", shed)
        self._advance(index)
        # Explicit timing: the fan-out counts ride along as args (they
        # exist only once delivery finished).
        tr.complete("watch.on_flip", t0_us, tr.now_us() - t0_us,
                    cat="serving", args={"delivered": delivered, "shed": shed})

    def _advance(self, index: int) -> None:
        with self._index_cond:
            if index > self.apply_index:
                self.apply_index = index
            self._index_cond.notify_all()

    # -- blocking-query primitive (the ?index= contract) ----------------
    def wait_index(self, min_index: int = 0, wait_s: float = 10.0) -> int:
        """Park until the apply index exceeds ``min_index`` (or the wait
        expires). Returns at once when it already has. Never returns a
        smaller index than it was called with, and never less than 1
        (the reference blockingQuery floor)."""
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._index_cond:
            while self.apply_index <= min_index and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._index_cond.wait(left)
            return max(self.apply_index, min_index, 1)

    # -- shutdown --------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._closed = True
            watchers = [w for kinds in self._tree.values()
                        for group in kinds.values() for w in group]
        for w in watchers:
            with w.cond:
                w.closed = True
                w.cond.notify_all()
        with self._index_cond:
            self._index_cond.notify_all()

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        return {
            "watchers": self.watchers,
            "deltas": self.deltas,
            "watch_shed": self.shed,
            "flips": self.flips,
            "truncated_frames": self.truncated_frames,
            "apply_index": self.apply_index,
        }
