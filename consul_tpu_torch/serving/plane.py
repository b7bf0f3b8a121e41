"""ServingPlane: double-buffered snapshots + high-level reads (PyTorch
port of ``consul_tpu/serving/plane.py``).

The plane owns two snapshot slots and an index to the current one;
``publish`` projects live state into the idle slot and then swaps the
index. Readers that grabbed the previous snapshot keep using it: a
snapshot owns its tensors (``ops/serving.project`` copies what it
reads), so a reader's view stays coherent as of its tick while the
simulation and later publishes race ahead.

Two sources can feed a plane (one per instance, never both):

* **sim** — attached to a ``models/cluster.py`` Simulation, which
  republishes at every chunk boundary (``publish_serving``). Queries
  address nodes by simulation index, on the simulation's device.
* **host** — built from server-store coordinate rows (``publish_coords``)
  on the plane's ``device``; this backs catalog/health ``?near=``
  sorting and prepared-query NearestN. Queries address nodes by name.
  Coordinate sets with named segments fall back to the host
  ``server/rtt.py`` path (the snapshot models one default-segment
  coordinate per node).

The plane computes on the device of the snapshot it holds; nothing moves
to the CPU, or from it, on its own. Under a sharded simulation (a mesh
of more than one shard) the snapshot is projected block by block and
stays placed (``ops/serving.ShardedSnapshot``, one part per device
group, the labels placed by node block), and ``kernel()`` is the
two-stage top-k (``ops/serving.sharded_kernel_for``). The write path's
state and the watch plane's diff stay whole on the mesh's first device,
where the reference places their [N] leaves by block (a placement
narrowing, ROADMAP C).
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.ops import deltas
from consul_tpu_torch.ops import serving as kernels
from consul_tpu_torch.serving.batcher import (QueryBatcher, QueryResult,
                                              ServingOverloadError)


class NearestResult(NamedTuple):
    """A NearestN answer with ids resolved to the plane's addressing
    (simulation indices or node names)."""

    nodes: list          # [(node, rtt_s)] ascending RTT, len == count
    count: int
    tick: int


class ServingPlane:
    def __init__(self, k: int = 16,
                 buckets: Sequence[int] = (1, 8, 64, 512),
                 max_wait_s: float = 0.002, sink=None,
                 num_services: int = 0, device="cuda"):
        self.k = int(k)
        self.sink = sink
        # Synthetic service labels for sim mode: node i -> service
        # i mod num_services (0/1 = one unlabeled service).
        self.num_services = int(num_services)
        # Where host-coordinate snapshots live; a sim-attached plane uses
        # the simulation's device.
        self.device = torch.device(device)
        self.batcher = QueryBatcher(self, k=k, buckets=buckets,
                                    max_wait_s=max_wait_s)
        # Double buffer: write the idle slot, then swap the index.
        self._slots: list = [None, None]
        self._cur = -1
        self._source: Optional[str] = None  # "sim" | "host"
        self._service_labels = None  # cached synthetic labels (sim mode)
        self._labels_key = None      # (n, device, mesh, groups) of the cache
        # The attached simulation's mesh and device groups at the last
        # publish (None: one device).
        self._mesh = None
        self._groups = None
        self.cache_hits = 0
        self._sim = None
        self._closed = False
        # Write path (attach_writes): the PENDING WriteState the
        # WriteBatcher advances between flips, the (snapshot, write-state)
        # pair captured AT the current flip (what readers and the watch
        # diff see), and the host-side key table.
        self.write_state = None
        self.write_lock = threading.Lock()
        self.writes = None   # WriteBatcher
        self.watch = None    # WatchPlane
        self.keys = None     # KeyTable
        self._flip_pair = None  # (Snapshot, WriteState) as of last flip
        # Host-mode name table (publish_coords).
        self._names: tuple[str, ...] = ()
        self._name_idx: dict[str, int] = {}
        self._host_fp = None
        self._host_version = 0
        self._host_usable: dict[str, bool] = {}

    # -- snapshot publication -------------------------------------------
    def snapshot(self) -> kernels.Snapshot:
        if self._cur < 0:
            raise RuntimeError("serving plane has no published snapshot")
        return self._slots[self._cur]

    @property
    def tick(self) -> int:
        return int(self.snapshot().tick)

    def _flip(self, snap: kernels.Snapshot) -> None:
        idle = 1 - self._cur if self._cur >= 0 else 0
        self._slots[idle] = snap
        self._cur = idle

    def attach(self, sim) -> None:
        """Bind to a Simulation: adopt its sink, register on the sim so the
        chunk loop republishes, and publish now."""
        if self._source == "host":
            raise RuntimeError("plane already serves host coordinates")
        self._source = "sim"
        self._sim = sim
        if self.sink is None:
            self.sink = getattr(sim, "sink", None)
        sim.serving = self
        self.publish(sim)

    def publish(self, sim) -> None:
        """Project the sim's SWIM plane, as it is stored (packed or dense),
        into the idle buffer and swap: under a mesh of more than one shard
        block by block (the shards' blocks as placed, never gathered).
        Called at chunk boundaries."""
        mesh = getattr(sim, "mesh", None)
        if mesh is not None and mesh.size > 1:
            self._mesh, self._groups = mesh, sim.groups
            self.publish_state([sim._swim_at_rest(b) for b in sim.state])
            return
        self._mesh = self._groups = None
        self.publish_state(sim._swim_at_rest())

    def publish_state(self, state) -> None:
        """Project ``state`` (a SWIM plane, or under the plane's mesh the
        list of its shards' blocks) with the current labels and flip."""
        sharded = isinstance(state, list)
        n = (sum(b.viv.height.shape[0] for b in state) if sharded
             else state.viv.height.shape[0])
        device = (self._mesh.devices[0] if sharded
                  else state.viv.height.device)
        if self.write_state is not None:
            # Write plane attached: snapshot labels come from the write
            # state, so a write becomes visible to readers exactly here,
            # at the flip. The pending state is captured under the lock
            # against concurrent batches.
            with self.write_lock:
                ws = self.write_state
            labels = deltas.labels_of(ws)
            if sharded:
                labels = self._place_labels(labels, n)
            snap = self._project(state, labels, n)
            self._flip(snap)
            prev = self._flip_pair
            self._flip_pair = (snap, ws)
            if self.watch is not None:
                self.watch.on_flip(prev, self._flip_pair)
            return
        self._flip(self._project(
            state, self._synthetic_labels(n, device, sharded), n))

    def _project(self, state, labels, n: int):
        if isinstance(state, list):
            return kernels.project_sharded(self._mesh, self._groups, state,
                                           labels, n)
        return kernels.project(state, labels)

    def _place_labels(self, labels: torch.Tensor, n: int) -> list:
        """[N] labels placed by node block under the plane's mesh."""
        from consul_tpu_torch.parallel import mesh as mesh_mod

        return mesh_mod.split(self._mesh, labels, n, groups=self._groups)

    def _synthetic_labels(self, n: int, device, sharded: bool = False):
        """Cached sim-mode service labels (node i -> i mod num_services),
        placed by node block under the plane's mesh."""
        from consul_tpu_torch.parallel import mesh as mesh_mod

        key = (n, device, mesh_mod.mesh_key(self._mesh) if sharded else None,
               self._groups if sharded else None)
        if self._service_labels is None or self._labels_key != key:
            labels = torch.arange(n, dtype=torch.int32, device=device)
            if self.num_services > 1:
                labels = labels % self.num_services
            else:
                labels = torch.zeros_like(labels)
            self._service_labels = (self._place_labels(labels, n) if sharded
                                    else labels)
            self._labels_key = key
        return self._service_labels

    def kernel(self):
        """The batch executor the QueryBatcher runs: the two-stage top-k
        (``ops/serving.sharded_kernel_for``) when the attached simulation
        runs on a mesh of more than one shard that divides the node axis
        (reference plane.py:175-188), else the single-device
        ``ops/serving.execute``, both at the plane's k."""
        snap = self.snapshot() if self._cur >= 0 else None
        if isinstance(snap, kernels.ShardedSnapshot):
            mesh = snap.mesh
            if mesh.size > 1 and snap.n % mesh.size == 0:
                return kernels.sharded_kernel_for(self.k, mesh)
        return kernels.kernel_for(self.k)

    # -- write path + watch plane (serving/writes.py, watch.py) ---------
    def attach_writes(self, kv_slots: int = 256,
                      buckets: Sequence[int] = (1, 8, 64),
                      max_wait_s: float = 0.002, max_pending: int = 1024,
                      policy: str = "reject", watch_k: int = 64,
                      watch_queue: int = 256) -> None:
        """Attach the write path + watch plane to a sim-backed plane: the
        initial WriteState (every sim seat registered with its synthetic
        label, so no read changes until the first write) on the sim's
        device, and a republish so the first flip carries it."""
        from consul_tpu_torch.serving.watch import WatchPlane
        from consul_tpu_torch.serving.writes import KeyTable, WriteBatcher

        if self._source != "sim" or self._sim is None:
            raise RuntimeError(
                "write plane needs a sim-attached serving plane "
                "(host-coordinate planes serve reads only)")
        if self.write_state is not None:
            raise RuntimeError("write plane already attached")
        sim = self._sim
        n = sim.cfg.n
        labels = np.arange(n, dtype=np.int32) % max(self.num_services, 1)
        self.write_state = deltas.place(
            deltas.init_state(n, kv_slots, service=labels), sim.device)
        self.keys = KeyTable(kv_slots)
        self.writes = WriteBatcher(self, buckets=buckets,
                                   max_wait_s=max_wait_s,
                                   max_pending=max_pending, policy=policy)
        self.watch = WatchPlane(self, k=watch_k, max_queue=watch_queue)
        self.publish(sim)

    def has_writes(self) -> bool:
        return self.write_state is not None

    @property
    def raft_gate(self):
        """The attached sim's RaftPlane while its raft tier is armed
        (``Simulation.set_raft``) and the write path is up: the
        WriteBatcher then stages batches as raft proposals and the commit
        pump applies them at quorum commit (serving/writes.py
        ``_run_batch``). None routes writes straight to apply_writes."""
        if self._sim is None or self.write_state is None:
            return None
        return self._sim.raft

    @property
    def apply_index(self) -> int:
        """The apply index the CURRENT flip is consistent as of (0 before
        the first write-attached flip): the HTTP tier's X-Consul-Index."""
        return self.watch.apply_index if self.watch is not None else 0

    def fold_write_counters(self, n_applied: int) -> None:
        """Fold applied-write tallies into the attached sim's counters:
        cumulative ``counters['writes_applied']`` equals the apply index
        (and reaches the sink under counters.METRIC_NAMES)."""
        if n_applied and self._sim is not None:
            fold = getattr(self._sim, "_fold_counter_deltas", None)
            if fold is not None:
                fold({"writes_applied": int(n_applied)})

    # -- host-friendly write/read verbs (sim addressing) ----------------
    def register(self, node: int, service: int, **kw):
        """Catalog register: label ``node`` with ``service``. Visible to
        reads at the next flip; the result carries the apply index that
        flip will be consistent as of."""
        return self.writes.submit(deltas.OP_REGISTER, node, service, **kw)

    def deregister(self, node: int, **kw):
        return self.writes.submit(deltas.OP_DEREGISTER, node, **kw)

    def kv_put(self, key: str, value: int, **kw):
        """KV put: one int32 payload word per string key (the ops/deltas.py
        narrowing). A full slot table is an admission failure."""
        slot = self.keys.slot_for(key, create=True)
        if slot < 0:
            self.writes.count_rejected()
            if self.sink is not None:
                self.sink.incr_counter("sim.serving.rejected", 1)
            raise ServingOverloadError(
                f"kv slot table full ({self.keys.slots} slots)")
        return self.writes.submit(deltas.OP_KV_PUT, slot, int(value), **kw)

    def kv_delete(self, key: str, **kw):
        from consul_tpu_torch.serving.writes import WriteResult

        slot = self.keys.slot_for(key)
        if slot < 0:
            return WriteResult(applied=False, index=0, status="rejected")
        return self.writes.submit(deltas.OP_KV_DELETE, slot, **kw)

    def session_create(self, node: int, session_id: int, **kw):
        return self.writes.submit(deltas.OP_SESSION_CREATE, node,
                                  int(session_id), **kw)

    def session_destroy(self, node: int, **kw):
        return self.writes.submit(deltas.OP_SESSION_DESTROY, node, **kw)

    def kv_get(self, key: str):
        """One KV slot AS OF THE CURRENT FLIP (a write between flips is not
        visible yet): ``{"Key", "Value", "ModifyIndex"}`` or None."""
        slot = self.keys.slot_for(key) if self.keys is not None else -1
        if slot < 0 or self._flip_pair is None:
            return None
        _, ws = self._flip_pair
        used, val, ver = torch.stack([
            ws.kv_used[slot].to(torch.int32), ws.kv_val[slot],
            ws.kv_ver[slot]]).tolist()
        if not used:
            return None
        return {"Key": key, "Value": val, "ModifyIndex": ver}

    def node_entry(self, node: int):
        """One node's catalog row as of the current flip:
        ``{"Node", "Service", "Registered", "Session", "Live"}``."""
        if self._flip_pair is None:
            return None
        snap, ws = self._flip_pair
        n = ws.service.shape[0]
        if not 0 <= int(node) < n:
            return None
        svc, reg, ses, live = torch.stack([
            ws.service[node], ws.registered[node].to(torch.int32),
            ws.session[node], snap.live[node].to(torch.int32)]).tolist()
        return {"Node": int(node), "Service": svc, "Registered": bool(reg),
                "Session": ses, "Live": bool(live)}

    # -- shutdown --------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent: close the query batcher, the write batcher and the
        watch plane — wake every parked waiter, reject every new submit
        with ServingClosedError."""
        self._closed = True
        self.batcher.close()
        if self.writes is not None:
            self.writes.close()
        if self.watch is not None:
            self.watch.close()

    # -- host-coordinate publication (server store rows) ----------------
    @staticmethod
    def _flatten(cset: dict) -> Optional[dict]:
        # Snapshots model one default-segment coordinate per node; anything
        # else falls back to rtt.py's pairwise intersect() on the host.
        if set(cset) == {""}:
            return cset[""]
        return None

    def publish_coords(self, coord_sets: dict) -> bool:
        """Build/refresh a snapshot from per-node coordinate sets
        (``rtt.coord_sets_from_store`` shape) on the plane's device.
        Returns False — leaving any prior snapshot untouched — when the
        sets use segment shapes the snapshot does not model."""
        if self._source == "sim":
            raise RuntimeError("plane already serves a simulation")
        flat: dict[str, dict] = {}
        fp = []
        for name in sorted(coord_sets):
            c = self._flatten(coord_sets[name])
            if c is None:
                return False
            flat[name] = c
            fp.append((name, tuple(c.get("vec", ())),
                       float(c.get("height", 0.0)),
                       float(c.get("adjustment", 0.0))))
        fp = tuple(fp)
        if fp == self._host_fp:
            return True

        names = tuple(flat)
        dims = [len(c.get("vec", ())) for c in flat.values()]
        # The modal dimensionality hosts the snapshot; off-dimension nodes
        # are "unknown" (sort_rows falls back when the SOURCE itself is
        # off-dimension, where host math would still be finite).
        d = max(set(dims), key=dims.count) if dims else 1
        d = max(d, 1)
        # The node axis pads to a power of two, so snapshot shapes stay
        # stable as membership grows.
        n_pad = max(4, 1 << (max(len(names), 1) - 1).bit_length())
        vec = np.zeros((n_pad, d), dtype=np.float32)
        height = np.zeros(n_pad, dtype=np.float32)
        adj = np.zeros(n_pad, dtype=np.float32)
        known = np.zeros(n_pad, dtype=bool)
        live = np.zeros(n_pad, dtype=bool)
        usable: dict[str, bool] = {}
        for i, (name, c) in enumerate(flat.items()):
            v = c.get("vec", ())
            ok = (len(v) == d and all(math.isfinite(x) for x in v)
                  and math.isfinite(c.get("height", 0.0))
                  and math.isfinite(c.get("adjustment", 0.0)))
            usable[name] = ok
            live[i] = True
            if ok:
                vec[i] = np.asarray(v, dtype=np.float32)
                height[i] = c.get("height", 0.0)
                adj[i] = c.get("adjustment", 0.0)
                known[i] = True
        # Concurrent publishers bump the version under write_lock; the
        # copies to the device below use the captured value outside it.
        with self.write_lock:
            self._names = names
            self._name_idx = {name: i for i, name in enumerate(names)}
            self._host_fp = fp
            self._host_usable = usable
            self._host_version += 1
            version = self._host_version
        dev = self.device
        self._source = "host"
        self._flip(kernels.Snapshot(
            vec=torch.from_numpy(vec).to(dev),
            height=torch.from_numpy(height).to(dev),
            adjustment=torch.from_numpy(adj).to(dev),
            known=torch.from_numpy(known).to(dev),
            live=torch.from_numpy(live).to(dev),
            service=torch.zeros(n_pad, dtype=torch.int32, device=dev),
            tick=version))
        return True

    # -- high-level reads ------------------------------------------------
    def _to_idx(self, node) -> int:
        if isinstance(node, str):
            return self._name_idx.get(node, -1)
        return int(node)

    def _from_idx(self, i: int):
        if self._source == "host" and 0 <= i < len(self._names):
            return self._names[i]
        return i

    def _resolve(self, res: QueryResult) -> NearestResult:
        nodes = [(self._from_idx(int(res.ids[j])), float(res.rtts[j]))
                 for j in range(min(res.count, len(res.ids)))
                 if int(res.ids[j]) >= 0]
        return NearestResult(nodes=nodes, count=res.count, tick=res.tick)

    def nearest(self, src, service: int = -1,
                timeout_s: float = 10.0) -> NearestResult:
        """Top-k live nodes by estimated RTT from ``src`` (batched with
        concurrent callers via the QueryBatcher)."""
        res = self.batcher.submit(kernels.MODE_NEAREST, self._to_idx(src),
                                  service, timeout_s=timeout_s)
        return self._resolve(res)

    def nearest_many(self, sources: Sequence,
                     service: int = -1) -> list[NearestResult]:
        """One caller, many sources: a single pre-assembled batch."""
        qs = [(kernels.MODE_NEAREST, self._to_idx(s), service)
              for s in sources]
        return [self._resolve(r) for r in self.batcher.execute(qs)]

    def node_distance(self, a, b, timeout_s: float = 10.0) -> float:
        """Estimated RTT seconds between two nodes; +inf when either side
        is unknown (the rtt.compute_distance rule)."""
        res = self.batcher.submit(kernels.MODE_DIST, self._to_idx(a),
                                  self._to_idx(b), timeout_s=timeout_s)
        if res.count < 1:
            return math.inf
        return float(res.rtts[0])

    def catalog_nodes(self, service: int = -1,
                      timeout_s: float = 10.0) -> NearestResult:
        """Registered nodes (id order, optionally one service label)."""
        res = self.batcher.submit(kernels.MODE_CATALOG, 0, service,
                                  timeout_s=timeout_s)
        return self._resolve(res)

    def health_nodes(self, service: int = -1,
                     timeout_s: float = 10.0) -> NearestResult:
        """Live (health-passing) nodes, id order."""
        res = self.batcher.submit(kernels.MODE_HEALTH, 0, service,
                                  timeout_s=timeout_s)
        return self._resolve(res)

    # -- host row sorting (?near= and prepared-query NearestN) ----------
    def sort_rows(self, coord_sets: dict, source: str, rows: list,
                  node_key: str = "node") -> list:
        """Drop-in for ``rtt.sort_nodes_by_distance``: same contract
        (stable sort, unknown coordinates last, rows unchanged for an
        unknown source) with the distances from one batch — one MODE_DIST
        slot per row. Falls back to the host path whenever the snapshot
        cannot represent the inputs exactly."""
        from consul_tpu_torch.server import rtt

        if not coord_sets.get(source) or len(rows) <= 1:
            return list(rows)
        if not self.publish_coords(coord_sets):
            return rtt.sort_nodes_by_distance(coord_sets, source, rows,
                                              node_key=node_key)
        si = self._name_idx.get(source, -1)
        if si < 0 or not self._host_usable.get(source, False):
            # Off-dimension / non-finite source: host math can still yield
            # finite same-dimension distances — defer to it.
            return rtt.sort_nodes_by_distance(coord_sets, source, rows,
                                              node_key=node_key)
        qs = [(kernels.MODE_DIST, si,
               self._name_idx.get(row.get(node_key), -1)) for row in rows]
        keys = [float(r.rtts[0]) if r.count >= 1 else math.inf
                for r in self.batcher.execute(qs)]
        order = sorted(range(len(rows)), key=keys.__getitem__)
        return [rows[i] for i in order]

    # -- cache front (any cache with register_type / get_typed) ---------
    def register_cache_type(self, cache, name: str = "serving-nearest",
                            ttl_s: float = 0.5) -> None:
        """Register the batched path as a cache type: the fetcher IS a
        serving query, so repeated NearestN reads within the TTL cost no
        batch."""

        def factory(src=0, service=-1):
            def fetch(min_index: int, wait_s: float) -> dict:
                res = self.nearest(src, service=service)
                return {"index": res.tick,
                        "value": {"nodes": res.nodes, "count": res.count,
                                  "tick": res.tick}}

            return fetch

        cache.register_type(name, factory, ttl_s=ttl_s, refresh=False)

    def cached_nearest(self, cache, src, service: int = -1,
                       name: str = "serving-nearest") -> dict:
        """NearestN through the cache, counting hits into
        ``sim.serving.cache_hits``."""
        before = cache.metrics["hits"]
        val = cache.get_typed(name, src=self._to_idx(src), service=service)
        if cache.metrics["hits"] > before:
            self.note_cache_hit()
        return val

    def note_cache_hit(self) -> None:
        with self.write_lock:
            self.cache_hits += 1
        if self.sink is not None:
            self.sink.incr_counter("sim.serving.cache_hits", 1)

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        out = self.batcher.stats()
        out["cache_hits"] = self.cache_hits
        # Flat keys, one scalar each (the reference feeds them to gauges).
        if self.writes is not None:
            for k, v in self.writes.stats().items():
                out[k if k.startswith("write") else f"write_{k}"] = v
        if self.watch is not None:
            out.update(self.watch.stats())
        return out
