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
    comp = (_order_bits(key).to(torch.int64) << 32) | ids
    return torch.topk(comp, k, dim=1, largest=False, sorted=True).indices


def _score_block(snap: Snapshot, vec_dm, kk: int, m, s, a, idx, idx64):
    """One block of queries (``m``, ``s``, ``a`` are [b, 1] int64):
    returns (positions [b, kk] int64, dist [b, N] f32, count [b] int32).
    ``vec_dm`` is ``snap.vec`` stored dimension-major, so the [b, N, D]
    difference comes out dimension-major too and each term of
    ``vivaldi.fold_sum`` reads a contiguous [b, N] slice."""
    dist = vivaldi.distance(
        snap.vec[s], snap.height[s], snap.adjustment[s],
        vec_dm[None], snap.height[None], snap.adjustment[None])
    pair_known = snap.known[s] & snap.known[None]
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
    pos = smallest_k(key, idx64, kk)
    return pos, dist, elig.sum(dim=1, dtype=torch.int32)


def execute(k: int, snap: Snapshot, mode: torch.Tensor, src: torch.Tensor,
            arg: torch.Tensor):
    """One padded batch on the snapshot's device: ``mode``/``src``/``arg``
    are [B] integer tensors; returns ``(ids [B, k] int32, rtts [B, k]
    float32, count [B] int32, tick)``.

    Per query: the Vivaldi distance from ``src`` to every node, the
    mode's eligibility mask, then the k smallest sort keys, ties to the
    lower id. Slots at and past ``count`` come back as id -1 / rtt +inf.
    A negative ``src`` counts from the end and an out-of-range one is
    clamped, as the reference's gather indexes.
    """
    n, dim = snap.vec.shape
    dev = snap.vec.device
    b_all = int(mode.shape[0])
    kk = min(k, n)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    idx64 = idx.to(torch.int64)
    mode, src, arg = (x.to(dev, torch.int64) for x in (mode, src, arg))
    src = torch.where(src < 0, src + n, src).clamp(0, n - 1)
    ids = torch.full((b_all, k), -1, dtype=torch.int32, device=dev)
    rtts = torch.full((b_all, k), float("inf"), dtype=torch.float32,
                      device=dev)
    count = torch.empty(b_all, dtype=torch.int32, device=dev)
    slot = torch.arange(kk, device=dev)
    vec_dm = snap.vec.t().contiguous().t()
    step = block_rows(n, dim, b_all)
    for r0 in range(0, b_all, step):
        r1 = min(b_all, r0 + step)
        pos, dist, cnt = _score_block(snap, vec_dm, kk, mode[r0:r1, None],
                                      src[r0:r1, None], arg[r0:r1, None],
                                      idx, idx64)
        valid = slot[None] < cnt[:, None]
        ids[r0:r1, :kk] = torch.where(valid, pos.to(torch.int32), -1)
        rtts[r0:r1, :kk] = torch.where(valid, dist.gather(1, pos),
                                       float("inf"))
        count[r0:r1] = cnt
    return ids, rtts, count, snap.tick


def snapshot_bytes(snap: Snapshot) -> int:
    """Bytes of a snapshot's node-axis tensors: what one batch must read
    at least once (the coordinates, N x (D + 3) x 4, plus the masks and
    labels)."""
    return sum(int(x.numel()) * x.element_size() for x in snap[:6])


# One callable per result width k (the reference memoizes one jit object
# per k; here there is nothing to compile).
_KERNEL_CACHE: dict[int, object] = {}


def kernel_for(k: int):
    """The batch executor for result width ``k``: ``execute`` with k bound."""
    fn = _KERNEL_CACHE.get(k)
    if fn is None:
        fn = _KERNEL_CACHE[k] = functools.partial(execute, k)
    return fn
