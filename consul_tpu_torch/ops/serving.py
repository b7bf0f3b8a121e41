"""Batched read-plane ops: masked top-k NearestN, node distance, and
health/catalog lookups over a published snapshot (PyTorch port of
``consul_tpu/ops/serving.py``).

This is the device tier of the serving plane (``serving/``): the host
``QueryBatcher`` packs concurrent requests into fixed-shape padded
batches and each batch runs here as one call — a broadcast Vivaldi
distance, a mode/eligibility mask and one top-k per query. The
reference vmaps one query and lets XLA fuse the batch; eager PyTorch
materialises every intermediate, so :func:`execute` scores the batch a
block of queries at a time, each block's ``[b, N]`` temporaries held to
``TEMP_BUDGET_BYTES`` (``block_rows``). It is plain PyTorch on the
snapshot's device, like the reference's plain ``jnp`` + ``lax.top_k``.

Distances are :func:`consul_tpu_torch.ops.vivaldi.distance`. Ties go to
the lower id, as ``lax.top_k`` breaks them (``torch.topk`` makes no such
promise): each key is made unique as its float32 bits, mapped to an
order-preserving integer, shifted left 32 and OR-ed with the node id,
and the top-k runs over that int64. A fresh simulation has every
coordinate at the origin, so every distance ties and NEAREST answers
the k lowest live ids.

Snapshots are projections of live simulation state published at chunk
boundaries (``Simulation.publish_serving``): :func:`project` copies
what it reads, so a reader holding a snapshot keeps its tick while the
simulation ticks on, and it draws nothing and writes nothing into the
state.

Under a mesh the snapshot stays placed (:class:`ShardedSnapshot`, one
part per device group, :func:`project_sharded`) and a batch runs the
reference's two-stage top-k (:func:`execute_sharded`): each part scores
its rows with global ids and keeps its own k best, and the candidates,
gathered shard-major onto the first device, merge under the same unique
key, so the answer is :func:`execute`'s on the whole snapshot.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from consul_tpu_torch.models.layout import PackedSimState
from consul_tpu_torch.ops import vivaldi

# Query modes. NOOP fills padding slots (all-false eligibility, so a
# padded slot returns count 0 and no ids).
MODE_NOOP = 0
MODE_NEAREST = 1   # live nodes (optionally one service), RTT order
MODE_DIST = 2      # single node distance: arg = target node index
MODE_CATALOG = 3   # all registered nodes (optionally one service), id order
MODE_HEALTH = 4    # live nodes (optionally one service), id order

# Sort-key sentinels. UNKNOWN orders after every real distance but before
# PAD, so eligible nodes without coordinates keep their place at the back
# (host parity: rtt unknown -> inf, sorts last, stable) while ineligible
# and padding rows never surface.
_UNKNOWN_KEY = 1e30
_PAD_KEY = float(np.finfo(np.float32).max)

# Bytes of one block's temporaries per (query, node) cell, at their peak
# inside vivaldi.distance: the [b, N, D] difference and its square (8D
# bytes) with the [b, N] fold accumulators and masks (16). execute picks
# the block's query count so the peak stays under TEMP_BUDGET_BYTES.
TEMP_BUDGET_BYTES = 2 << 30


def temp_bytes_per_cell(dim: int) -> int:
    return 8 * dim + 16


def block_rows(n: int, dim: int, batch: int) -> int:
    """Queries scored together, so that a block's temporaries stay within
    ``TEMP_BUDGET_BYTES`` at node count ``n`` and coordinate width ``dim``."""
    per_row = max(1, n) * temp_bytes_per_cell(dim)
    return max(1, min(batch, TEMP_BUDGET_BYTES // per_row))


class Snapshot(NamedTuple):
    """Projection of one simulation tick; every tensor owns its memory.

    All tensors share the node axis N. ``known`` marks finite Vivaldi
    state (a pair with an unknown side answers +inf, the rtt.py rule);
    ``live`` gates NEAREST/HEALTH eligibility; ``service`` is an int32
    label per node (queries filter with arg, -1 = any); ``tick`` is the
    tick the whole snapshot is consistent as of, a 0-d int32 tensor (a
    host int for host-coordinate snapshots is accepted too).
    """

    vec: torch.Tensor         # [N, D] float32 Vivaldi position
    height: torch.Tensor      # [N] float32
    adjustment: torch.Tensor  # [N] float32
    known: torch.Tensor       # [N] bool — finite coordinate state
    live: torch.Tensor        # [N] bool — alive and not left
    service: torch.Tensor     # [N] int32 service label
    tick: Union[torch.Tensor, int]


def project(state, service: torch.Tensor) -> Snapshot:
    """Project a SWIM plane into a read snapshot.

    ``state`` is a dense ``SimState`` or a ``PackedSimState``. From the
    packed state it reads only ``viv.vec``, ``viv.height`` and
    ``viv.adjustment`` (bfloat16, widened exactly to float32) and the
    liveness flag bits, never unpacking the rest. Every output is a
    fresh tensor (``service`` is the caller's and is never written), so
    the next tick cannot change a published snapshot.
    """
    viv = state.viv
    f32 = torch.float32
    vec = viv.vec.to(f32, copy=True)
    height = viv.height.to(f32, copy=True)
    adjustment = viv.adjustment.to(f32, copy=True)
    known = (torch.isfinite(vec).all(dim=-1) & torch.isfinite(height)
             & torch.isfinite(adjustment))
    if isinstance(state, PackedSimState):
        flags = state.flags
        live = ((flags & 1) != 0) & ((flags & 2) == 0)
    else:
        live = state.alive_truth & ~state.left
    return Snapshot(vec=vec, height=height, adjustment=adjustment,
                    known=known, live=live, service=service,
                    tick=state.t.to(torch.int32, copy=True))


def _order_bits(key: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order is the floats' order: the bits,
    with the magnitude bits of negative values flipped."""
    bits = key.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def smallest_k(key: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` smallest float32 keys of each row of ``key``
    [b, N], ascending, equal keys in ascending ``ids`` ([N] int64) order:
    the top-k of the unique int64 ``order_bits(key) << 32 | id``."""
    return torch.topk(_composite(key, ids), k, dim=1, largest=False,
                      sorted=True).indices


def _composite(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The unique int64 sort key ``order_bits(key) << 32 | id``."""
    return (_order_bits(key).to(torch.int64) << 32) | ids


def _score_block(snap: Snapshot, vec_dm, kk: int, m, src, a, idx, idx64):
    """One block of queries (``m``, ``a`` are [b, 1] int64, ``src`` the
    sources' ``(vec [b, 1, D], height, adjustment, known [b, 1])``):
    returns (positions [b, kk] int64, their composite keys [b, kk] int64,
    dist [b, N] f32, count [b] int32).
    ``idx`` / ``idx64`` are the snapshot's rows' global ids. ``vec_dm``
    is ``snap.vec`` stored dimension-major, so the [b, N, D] difference
    comes out dimension-major too and each term of ``vivaldi.fold_sum``
    reads a contiguous [b, N] slice."""
    s_vec, s_height, s_adj, s_known = src
    dist = vivaldi.distance(
        s_vec, s_height, s_adj,
        vec_dm[None], snap.height[None], snap.adjustment[None])
    pair_known = s_known & snap.known[None]
    dist = torch.where(pair_known, dist, float("inf"))
    svc_ok = (a < 0) | (snap.service[None] == a)
    elig = torch.where(
        m == MODE_DIST, idx[None] == a,
        torch.where(m == MODE_CATALOG, svc_ok,
                    torch.where((m == MODE_NEAREST) | (m == MODE_HEALTH),
                                snap.live[None] & svc_ok, False)))
    by_dist = (m == MODE_NEAREST) | (m == MODE_DIST)
    key = torch.where(
        by_dist,
        torch.where(torch.isfinite(dist), dist, _UNKNOWN_KEY),
        idx.to(torch.float32)[None])
    key = torch.where(elig, key, _PAD_KEY)
    top = torch.topk(_composite(key, idx64), kk, dim=1, largest=False,
                     sorted=True)
    return top.indices, top.values, dist, elig.sum(dim=1, dtype=torch.int32)


def _candidates(k: int, part: Snapshot, r0: int, mode, src, arg):
    """Stage 1 on one part, the rows ``[r0, r0 + rows)`` of the node axis
    on the part's device: each query's ``min(k, rows)`` smallest unique
    keys, a block of queries at a time so that the block's temporaries
    stay under ``TEMP_BUDGET_BYTES``. ``mode`` / ``arg`` are [B] int64,
    ``src`` the sources' ``(vec [B, D], height, adjustment, known)``.
    Returns (keys [B, kk] int64, global ids [B, kk] int32, rtts [B, kk]
    f32, count [B] int32) on the part's device."""
    dev = part.vec.device
    rows, dim = part.vec.shape
    b_all = int(mode.shape[0])
    kk = min(k, rows)
    gid = torch.arange(r0, r0 + rows, dtype=torch.int32, device=dev)
    gid64 = gid.to(torch.int64)
    mode, arg = mode.to(dev), arg.to(dev)
    src = [x.to(dev) for x in src]
    vec_dm = part.vec.t().contiguous().t()
    keys = torch.empty((b_all, kk), dtype=torch.int64, device=dev)
    ids = torch.empty((b_all, kk), dtype=torch.int32, device=dev)
    rtts = torch.empty((b_all, kk), dtype=torch.float32, device=dev)
    count = torch.empty(b_all, dtype=torch.int32, device=dev)
    step = block_rows(rows, dim, b_all)
    for q0 in range(0, b_all, step):
        q1 = min(b_all, q0 + step)
        pos, comp, dist, cnt = _score_block(
            part, vec_dm, kk, mode[q0:q1, None],
            tuple(x[q0:q1, None] for x in src), arg[q0:q1, None], gid, gid64)
        keys[q0:q1] = comp
        ids[q0:q1] = gid[pos]
        rtts[q0:q1] = dist.gather(1, pos)
        count[q0:q1] = cnt
    return keys, ids, rtts, count


def _merge(k: int, n: int, cands: list, dev):
    """Stage 2: the parts' candidates (in part order) merged on ``dev``
    under their unique keys, so ties break toward the lower global id;
    the counts sum. Slots at and past a query's count come back as id -1
    / rtt +inf. Returns (ids [B, k] int32, rtts [B, k] f32, count [B]
    int32)."""
    keys, cid, crtt = (torch.cat([c[i].to(dev) for c in cands], dim=1)
                       for i in range(3))
    count = cands[0][3].to(dev)
    for c in cands[1:]:
        count = count + c[3].to(dev)
    kf = min(k, n)
    pos = torch.topk(keys, kf, dim=1, largest=False, sorted=True).indices
    valid = torch.arange(kf, device=dev)[None] < count[:, None]
    b_all = count.shape[0]
    ids = torch.full((b_all, k), -1, dtype=torch.int32, device=dev)
    rtts = torch.full((b_all, k), float("inf"), dtype=torch.float32,
                      device=dev)
    ids[:, :kf] = torch.where(valid, cid.gather(1, pos), -1)
    rtts[:, :kf] = torch.where(valid, crtt.gather(1, pos), float("inf"))
    return ids, rtts, count


def _batch(dev, n: int, mode, src, arg):
    """The batch as int64 on ``dev``, ``src`` wrapped and clamped as the
    reference's gather indexes (a negative source counts from the end)."""
    mode, src, arg = (x.to(dev, torch.int64) for x in (mode, src, arg))
    return mode, torch.where(src < 0, src + n, src).clamp(0, n - 1), arg


def execute(k: int, snap: Snapshot, mode: torch.Tensor, src: torch.Tensor,
            arg: torch.Tensor):
    """One padded batch on the snapshot's device: ``mode``/``src``/``arg``
    are [B] integer tensors; returns ``(ids [B, k] int32, rtts [B, k]
    float32, count [B] int32, tick)``.

    Per query: the Vivaldi distance from ``src`` to every node, the
    mode's eligibility mask, then the k smallest sort keys, ties to the
    lower id. Slots at and past ``count`` come back as id -1 / rtt +inf.
    A negative ``src`` counts from the end and an out-of-range one is
    clamped, as the reference's gather indexes. This is
    :func:`execute_sharded` with one part.
    """
    n, dev = snap.vec.shape[0], snap.vec.device
    mode, src, arg = _batch(dev, n, mode, src, arg)
    coords = (snap.vec[src], snap.height[src], snap.adjustment[src],
              snap.known[src])
    ids, rtts, count = _merge(k, n, [_candidates(k, snap, 0, mode, coords,
                                                 arg)], dev)
    return ids, rtts, count, snap.tick


def snapshot_bytes(snap) -> int:
    """Bytes of a snapshot's node-axis tensors: what one batch must read
    at least once (the coordinates, N x (D + 3) x 4, plus the masks and
    labels); a sharded snapshot's over its parts."""
    if isinstance(snap, ShardedSnapshot):
        return sum(snapshot_bytes(p) for p in snap.parts)
    return sum(int(x.numel()) * x.element_size() for x in snap[:6])


def device_of(snap) -> torch.device:
    """The device a batch against ``snap`` is handed in on (a sharded
    snapshot's first device)."""
    if isinstance(snap, ShardedSnapshot):
        return snap.device
    return snap.vec.device


class ShardedSnapshot:
    """A snapshot placed on a mesh (reference: a Snapshot whose [N] leaves
    are sharded over the node axis): ``parts`` holds one
    :class:`Snapshot` per device group of ``groups``, of the group's rows
    ``[g[0] * rows, (g[-1] + 1) * rows)`` on the group's device, ``rows``
    being the rows of one shard; ``tick`` is shard 0's tick. ``live``, the
    whole [N] liveness mask on the first device, is made on first read for
    the write and watch planes, whose state stays whole there."""

    def __init__(self, mesh, groups, parts, n: int, tick):
        self.mesh, self.groups, self.parts = mesh, tuple(groups), list(parts)
        self.n, self.rows, self.tick = n, n // mesh.size, tick
        self.device = mesh.devices[0]
        self._live = None

    def row_ranges(self) -> list:
        """Each part's [first, end) global rows."""
        return [(g[0] * self.rows, (g[-1] + 1) * self.rows)
                for g in self.groups]

    @property
    def live(self) -> torch.Tensor:
        if self._live is None:
            self._live = torch.cat([p.live.to(self.device)
                                    for p in self.parts])
        return self._live


def project_sharded(mesh, groups, planes: list, labels: list,
                    n: int) -> ShardedSnapshot:
    """Project a placed SWIM plane (``planes``: one block per shard, packed
    or dense) into a :class:`ShardedSnapshot`, block by block with each
    block's labels (``labels``: per-shard [rows] int32, placed by block),
    joined per device group on the group's device. Nothing is gathered
    across devices."""
    parts = []
    for g in groups:
        snaps = [project(planes[d], labels[d]) for d in g]
        if len(snaps) == 1:
            parts.append(snaps[0])
            continue
        parts.append(Snapshot(
            *(torch.cat([getattr(x, f) for x in snaps])
              for f in Snapshot._fields[:6]), tick=snaps[0].tick))
    return ShardedSnapshot(mesh, groups, parts, n, parts[0].tick)


def place_snapshot(mesh, snap: Snapshot, groups=None) -> ShardedSnapshot:
    """A whole snapshot placed on ``mesh``: each device group's rows of
    every node-axis tensor copied onto the group's device (what
    :func:`project_sharded` makes from a placed state)."""
    from consul_tpu_torch.parallel import mesh as mesh_mod

    groups = mesh_mod.check_groups(mesh, groups)
    n = snap.vec.shape[0]
    b = mesh_mod.check_rows(n, mesh.size)
    parts = [Snapshot(*(x[g[0] * b:(g[-1] + 1) * b].to(
        mesh.devices[g[0]], copy=True) for x in snap[:6]), tick=snap.tick)
        for g in groups]
    return ShardedSnapshot(mesh, groups, parts, n, snap.tick)


def execute_sharded(k: int, mesh, snap: ShardedSnapshot, mode: torch.Tensor,
                    src: torch.Tensor, arg: torch.Tensor):
    """The two-stage top-k over a :class:`ShardedSnapshot` (reference
    ``ops/serving._execute_sharded``, :149-265), with :func:`execute`'s
    signature and result.

    Stage 0: each query's source coordinates come from the one part that
    holds the source row (selected, not summed, so they are its values
    bit for bit). Stage 1: each part scores its rows, a block of queries
    at a time under ``TEMP_BUDGET_BYTES`` on its device, with the global
    ids, and keeps its ``min(k, rows)`` smallest unique keys
    (``order_bits(key) << 32 | id``). Stage 2: the candidates, gathered
    shard-major onto the first device, merge under the same key, so ties
    break toward the lower global id and the answer is :func:`execute`'s
    on the whole snapshot; the counts sum. A part cannot lose a global
    winner: a row it cuts has ``k`` better keys in the part itself."""
    if not isinstance(snap, ShardedSnapshot):
        raise TypeError("execute_sharded takes a ShardedSnapshot; a whole "
                        "snapshot runs execute")
    if len(snap.mesh.devices) != len(mesh.devices) or any(
            a != b for a, b in zip(snap.mesh.devices, mesh.devices)):
        raise ValueError("the snapshot is placed on another mesh")
    n, dev0 = snap.n, snap.device
    mode, src, arg = _batch(dev0, n, mode, src, arg)
    # Stage 0: the source rows' coordinates, from their parts.
    coords = None
    for part, (r0, r1) in zip(snap.parts, snap.row_ranges()):
        own = (src >= r0) & (src < r1)
        li = (src - r0).clamp(0, r1 - r0 - 1).to(part.vec.device)
        got = [x[li].to(dev0) for x in (part.vec, part.height,
                                         part.adjustment, part.known)]
        coords = got if coords is None else [
            torch.where(own[:, None] if g.dim() > 1 else own, g, c)
            for g, c in zip(got, coords)]
    cands = [_candidates(k, part, r0, mode, coords, arg)
             for part, (r0, _) in zip(snap.parts, snap.row_ranges())]
    ids, rtts, count = _merge(k, n, cands, dev0)
    return ids, rtts, count, snap.tick


# One callable per (result width k, mesh fingerprint or None) (the
# reference memoizes one jit object per pair; here there is nothing to
# compile).
_KERNEL_CACHE: dict = {}


def kernel_for(k: int, mesh=None):
    """The batch executor for result width ``k``: :func:`execute`, or over
    ``mesh`` :func:`execute_sharded` with both bound (the batcher's
    executor while the attached simulation runs on a mesh)."""
    from consul_tpu_torch.parallel.mesh import mesh_key

    key = (k, None if mesh is None else mesh_key(mesh))
    fn = _KERNEL_CACHE.get(key)
    if fn is None:
        fn = _KERNEL_CACHE[key] = (
            functools.partial(execute, k) if mesh is None
            else functools.partial(execute_sharded, k, mesh))
    return fn


def sharded_kernel_for(k: int, mesh):
    """The two-stage executor over ``mesh`` (the reference's name for
    ``kernel_for(k, mesh)``)."""
    return kernel_for(k, mesh)
