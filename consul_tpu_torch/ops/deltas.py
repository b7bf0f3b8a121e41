"""Write-path and watch-delta ops: batched catalog/KV/session writes
applied on the device, and per-flip snapshot diffs for watchers (PyTorch
port of ``consul_tpu/ops/deltas.py``).

This is the device tier of the serving write plane
(``serving/writes.py`` / ``watch.py``), the write-side twin of
``ops/serving.py``. The host ``WriteBatcher`` coalesces concurrent
register/deregister, KV put/delete and session ops into fixed-shape
:class:`WriteBatch` tensors, and each batch runs as one call of
:func:`apply_writes`. A monotone raft-style **apply index** lives in
:class:`WriteState`; every applied op gets the next index, and every
snapshot flip carries the index it is consistent as of.

Batch semantics (the raft-log contract): ops apply in batch order, each
applied op is assigned ``apply_index + (its 1-based rank among applied
ops)``, and within one batch the last writer to a node or slot wins —
what a sequential host replay of the same log produces. The host
references :func:`apply_writes_reference` / :func:`diff_snapshots_reference`
are that replay (plain numpy, copies of the reference's oracles); the
tests hold the tensor versions to them exactly.

Last writer wins by rank, not by scatter order: ``index_put_`` and
``scatter_`` with duplicate targets keep an arbitrary writer on CUDA, so
each family takes ``scatter_reduce(amax)`` of the applied rows' 1-based
ranks per target — a result independent of order — and gathers the op,
argument and op index at the winning row. Changed rows compact by a
top-k over unique integer keys (id where changed, n + id elsewhere), so
they come out in ascending id order on any device.

Narrowings, as the reference has them: the KV models one int32 payload
word per key slot (the host ``KeyTable`` owns string-key -> slot
allocation), and sessions are one id per node with no KV lock coupling.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# Write ops. NOOP fills padding slots (never applied, never indexed).
OP_NOOP = 0
OP_REGISTER = 1         # target = node, arg = service label (>= 0)
OP_DEREGISTER = 2       # target = node
OP_KV_PUT = 3           # target = kv slot, arg = int32 payload word
OP_KV_DELETE = 4        # target = kv slot
OP_SESSION_CREATE = 5   # target = node, arg = session id (>= 0)
OP_SESSION_DESTROY = 6  # target = node

# Delta kinds for changed-node rows (bitmask).
CHANGE_SERVICE = 1      # service membership changed (label/registration)
CHANGE_WENT_LIVE = 2    # health transition dead -> live
CHANGE_WENT_DEAD = 4    # health transition live -> dead


class WriteState(NamedTuple):
    """Write-side state, node axis N + KV slot axis S.

    ``service``/``registered`` are the catalog truth the serving plane
    publishes as snapshot labels at every flip (a registered node's label
    is its service; an unregistered node reads as -1). ``apply_index`` is
    the monotone raft-style index: bumped once per applied op, stamped on
    every flip, surfaced as ``X-Consul-Index``.
    """

    service: torch.Tensor      # [N] int32 service label
    registered: torch.Tensor   # [N] bool
    session: torch.Tensor      # [N] int32 session id, -1 = none
    kv_used: torch.Tensor      # [S] bool
    kv_val: torch.Tensor       # [S] int32 payload word
    kv_ver: torch.Tensor       # [S] int32 apply index of last mutation
    apply_index: torch.Tensor  # [] int32 monotone apply index


class WriteBatch(NamedTuple):
    """One fixed-shape coalesced batch: ``op``/``target``/``arg`` are [B]
    int32, padding slots are OP_NOOP."""

    op: torch.Tensor
    target: torch.Tensor
    arg: torch.Tensor


class DeltaFrame(NamedTuple):
    """One flip-to-flip delta, fixed shape [K] (+ [] counts), all int32.

    ``node_ids`` holds the first K changed node ids ascending (-1 pad);
    ``node_kinds`` is the CHANGE_* bitmask per row; ``svc_prev`` /
    ``svc_cur`` are the service labels either side of the flip (-1 =
    unregistered), so watchers of both the old and the new label can be
    routed. ``kv_slots``/``kv_vers`` list the first K changed KV slots
    with their new version. Counts may exceed K — the watch plane marks
    such frames truncated rather than capping silently.
    """

    node_ids: torch.Tensor        # [K]
    node_kinds: torch.Tensor      # [K] CHANGE_* bitmask
    svc_prev: torch.Tensor        # [K]
    svc_cur: torch.Tensor         # [K]
    n_node_changes: torch.Tensor  # []
    kv_slots: torch.Tensor        # [K]
    kv_vers: torch.Tensor         # [K]
    n_kv_changes: torch.Tensor    # []
    apply_index: torch.Tensor     # [] the newer flip's index
    tick: torch.Tensor            # [] the newer snapshot's tick


def init_state(n: int, kv_slots: int, service=None) -> WriteState:
    """Host-built initial WriteState (numpy; :func:`place` puts it on a
    device). Every sim seat starts registered with its synthetic service
    label, so attaching a write plane changes no read until the first
    write lands."""
    if service is None:
        service = np.zeros(n, dtype=np.int32)
    return WriteState(
        service=np.asarray(service, dtype=np.int32),
        registered=np.ones(n, dtype=bool),
        session=np.full(n, -1, dtype=np.int32),
        kv_used=np.zeros(kv_slots, dtype=bool),
        kv_val=np.zeros(kv_slots, dtype=np.int32),
        kv_ver=np.zeros(kv_slots, dtype=np.int32),
        apply_index=np.int32(0),
    )


def place(ws: WriteState, device) -> WriteState:
    """A host WriteState (numpy leaves) as tensors on ``device``."""
    return WriteState(*[torch.as_tensor(np.asarray(x)).to(device)
                        for x in ws])


def apply_writes(ws: WriteState, batch: WriteBatch):
    """One coalesced batch; returns ``(new_state, applied [B] bool,
    index [B] int32)``.

    ``applied[i]`` is False for NOOP padding, out-of-range targets and
    register / session-create without an argument; ``index[i]`` is the
    apply index assigned to op i (the state's index after op i —
    unchanged for unapplied rows). The input state is not written.
    """
    n = ws.service.shape[0]
    s = ws.kv_used.shape[0]
    op, tgt, arg = batch.op, batch.target, batch.arg
    dev = op.device

    node_op = ((op == OP_REGISTER) | (op == OP_DEREGISTER)
               | (op == OP_SESSION_CREATE) | (op == OP_SESSION_DESTROY))
    kv_op = (op == OP_KV_PUT) | (op == OP_KV_DELETE)
    needs_arg = (op == OP_REGISTER) | (op == OP_SESSION_CREATE)
    in_range = torch.where(node_op, (tgt >= 0) & (tgt < n),
                           (tgt >= 0) & (tgt < s))
    applied = (node_op | kv_op) & in_range & (~needs_arg | (arg >= 0))

    # Per-op assigned index: apply_index + 1-based rank among applied.
    opidx = ws.apply_index + torch.cumsum(applied.to(torch.int32), 0,
                                          dtype=torch.int32)
    rank = torch.arange(1, op.shape[0] + 1, dtype=torch.int32, device=dev)

    def family(width, in_family):
        """Per target: whether an applied op of the family addressed it,
        and the op, argument and op index of the last one that did."""
        sel = applied & in_family
        last = torch.zeros(width, dtype=torch.int32, device=dev)
        if width:
            last.scatter_reduce_(0, torch.where(sel, tgt, 0).to(torch.int64),
                                 torch.where(sel, rank, 0), reduce="amax")
        bi = (last - 1).clamp(min=0).to(torch.int64)
        return last > 0, op[bi], arg[bi], opidx[bi]

    # Catalog family: register/deregister -> service + registered.
    has, fop, farg, _ = family(
        n, (op == OP_REGISTER) | (op == OP_DEREGISTER))
    service = torch.where(has & (fop == OP_REGISTER), farg, ws.service)
    service = torch.where(has & (fop == OP_DEREGISTER), -1, service)
    registered = torch.where(has, fop == OP_REGISTER, ws.registered)

    # Session family: one id per node (no KV lock coupling).
    has, fop, farg, _ = family(
        n, (op == OP_SESSION_CREATE) | (op == OP_SESSION_DESTROY))
    session = torch.where(has & (fop == OP_SESSION_CREATE), farg, ws.session)
    session = torch.where(has & (fop == OP_SESSION_DESTROY), -1, session)

    # KV family: slot-addressed put/delete; version = the mutating op's
    # index (deletes bump it too, the state-store table-index rule).
    has, fop, farg, fidx = family(s, kv_op)
    kv_val = torch.where(has & (fop == OP_KV_PUT), farg, ws.kv_val)
    kv_used = torch.where(has, fop == OP_KV_PUT, ws.kv_used)
    kv_ver = torch.where(has, fidx, ws.kv_ver)

    new = WriteState(
        service=service, registered=registered, session=session,
        kv_used=kv_used, kv_val=kv_val, kv_ver=kv_ver,
        apply_index=ws.apply_index + applied.sum(dtype=torch.int32))
    return new, applied, opidx


def labels_of(ws: WriteState) -> torch.Tensor:
    """Snapshot service labels from write state: a registered node's label
    is its service, an unregistered node reads -1 (filtered out of every
    service-addressed query)."""
    return torch.where(ws.registered, ws.service, -1)


def _compact(changed: torch.Tensor, k: int):
    """First k set indices of a bool mask, ascending, -1 padded, plus the
    total count (may exceed k) and the valid-slot mask: the top-k of the
    unique keys ``id`` where changed, ``n + id`` elsewhere."""
    n = changed.shape[0]
    dev = changed.device
    kk = min(k, n)  # top-k caps at the axis length; pad back out to k
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.where(changed, idx, idx + n)
    ids = torch.topk(key, kk, largest=False, sorted=True).indices
    count = changed.sum(dtype=torch.int32)
    valid = torch.arange(k, device=dev) < torch.clamp(count, max=kk)
    ids = torch.cat([ids.to(torch.int32),
                     torch.full((k - kk,), -1, dtype=torch.int32, device=dev)])
    return torch.where(valid, ids, -1), count, valid


def diff_snapshots(k: int, prev_snap, prev_ws: WriteState, cur_snap,
                   cur_ws: WriteState) -> DeltaFrame:
    """Everything that changed between two consecutive flips, as one
    fixed-shape frame: changed service membership (label or registration),
    health transitions (the snapshot's ``live`` bit) and KV slot changes
    (version or liveness)."""
    svc_prev = labels_of(prev_ws)
    svc_cur = labels_of(cur_ws)
    svc_changed = svc_prev != svc_cur
    went_live = cur_snap.live & ~prev_snap.live
    went_dead = prev_snap.live & ~cur_snap.live
    node_changed = svc_changed | went_live | went_dead

    ids, n_nodes, valid = _compact(node_changed, k)
    safe = ids.clamp(min=0).to(torch.int64)
    i32 = torch.int32
    kinds = (svc_changed[safe].to(i32) * CHANGE_SERVICE
             + went_live[safe].to(i32) * CHANGE_WENT_LIVE
             + went_dead[safe].to(i32) * CHANGE_WENT_DEAD)

    kv_changed = ((prev_ws.kv_ver != cur_ws.kv_ver)
                  | (prev_ws.kv_used != cur_ws.kv_used))
    slots, n_kv, kv_valid = _compact(kv_changed, k)
    kv_safe = slots.clamp(min=0).to(torch.int64)

    return DeltaFrame(
        node_ids=ids,
        node_kinds=torch.where(valid, kinds, 0),
        svc_prev=torch.where(valid, svc_prev[safe], -1),
        svc_cur=torch.where(valid, svc_cur[safe], -1),
        n_node_changes=n_nodes,
        kv_slots=slots,
        kv_vers=torch.where(kv_valid, cur_ws.kv_ver[kv_safe], 0),
        n_kv_changes=n_kv,
        apply_index=cur_ws.apply_index,
        tick=torch.as_tensor(cur_snap.tick, dtype=i32, device=ids.device),
    )


# One callable per frame width k (the reference memoizes one jit object
# per k).
_DIFF_CACHE: dict[int, object] = {}


def diff_kernel_for(k: int):
    """The flip differ for frame width ``k``."""
    fn = _DIFF_CACHE.get(k)
    if fn is None:
        fn = _DIFF_CACHE[k] = functools.partial(diff_snapshots, k)
    return fn


def frame_to_host(frame: DeltaFrame) -> DeltaFrame:
    """A frame's fields as numpy (int32 arrays, 0-d for the counts), in
    one device-to-host copy."""
    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in frame])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for x in frame:
        size = x.numel()
        out.append(flat[at:at + size].reshape(tuple(x.shape)))
        at += size
    return DeltaFrame(*out)


# ----------------------------------------------------------------------
# Host references (copies of the reference's oracles): plain numpy,
# sequential per-op replay in state-store style. apply_writes and
# diff_snapshots are held to these exactly.
# ----------------------------------------------------------------------

def apply_writes_reference(ws: WriteState, batch: WriteBatch):
    """Sequential host replay of one batch: ops in order, one global
    modify index per applied op, last writer wins by construction.
    Returns the same ``(new_state, applied, index)`` triple as
    :func:`apply_writes`, numpy-typed."""
    service = np.array(ws.service, dtype=np.int32, copy=True)
    registered = np.array(ws.registered, dtype=bool, copy=True)
    session = np.array(ws.session, dtype=np.int32, copy=True)
    kv_used = np.array(ws.kv_used, dtype=bool, copy=True)
    kv_val = np.array(ws.kv_val, dtype=np.int32, copy=True)
    kv_ver = np.array(ws.kv_ver, dtype=np.int32, copy=True)
    index = int(ws.apply_index)
    n, s = len(service), len(kv_used)

    ops = np.asarray(batch.op, dtype=np.int32)
    tgts = np.asarray(batch.target, dtype=np.int32)
    args = np.asarray(batch.arg, dtype=np.int32)
    applied = np.zeros(len(ops), dtype=bool)
    opidx = np.zeros(len(ops), dtype=np.int32)

    for i, (op, tgt, arg) in enumerate(zip(ops, tgts, args)):
        ok = False
        if op in (OP_REGISTER, OP_DEREGISTER,
                  OP_SESSION_CREATE, OP_SESSION_DESTROY):
            ok = 0 <= tgt < n and (
                op not in (OP_REGISTER, OP_SESSION_CREATE) or arg >= 0)
            if ok:
                index += 1
                if op == OP_REGISTER:
                    service[tgt], registered[tgt] = arg, True
                elif op == OP_DEREGISTER:
                    service[tgt], registered[tgt] = -1, False
                elif op == OP_SESSION_CREATE:
                    session[tgt] = arg
                else:
                    session[tgt] = -1
        elif op in (OP_KV_PUT, OP_KV_DELETE):
            ok = 0 <= tgt < s
            if ok:
                index += 1
                if op == OP_KV_PUT:
                    kv_used[tgt], kv_val[tgt] = True, arg
                else:
                    kv_used[tgt] = False
                kv_ver[tgt] = index
        applied[i] = ok
        opidx[i] = index

    new = WriteState(service=service, registered=registered,
                     session=session, kv_used=kv_used, kv_val=kv_val,
                     kv_ver=kv_ver, apply_index=np.int32(index))
    return new, applied, opidx


def diff_snapshots_reference(k: int, prev_snap, prev_ws, cur_snap,
                             cur_ws) -> DeltaFrame:
    """Host replay of the flip diff: same frame, numpy-typed."""
    svc_prev = np.where(np.asarray(prev_ws.registered),
                        np.asarray(prev_ws.service), -1).astype(np.int32)
    svc_cur = np.where(np.asarray(cur_ws.registered),
                       np.asarray(cur_ws.service), -1).astype(np.int32)
    prev_live = np.asarray(prev_snap.live)
    cur_live = np.asarray(cur_snap.live)
    svc_changed = svc_prev != svc_cur
    went_live = cur_live & ~prev_live
    went_dead = prev_live & ~cur_live
    node_changed = svc_changed | went_live | went_dead

    ids = np.flatnonzero(node_changed).astype(np.int32)
    n_nodes = len(ids)
    ids = ids[:k]
    node_ids = np.full(k, -1, dtype=np.int32)
    node_ids[:len(ids)] = ids
    kinds = np.zeros(k, dtype=np.int32)
    kinds[:len(ids)] = (svc_changed[ids] * CHANGE_SERVICE
                        + went_live[ids] * CHANGE_WENT_LIVE
                        + went_dead[ids] * CHANGE_WENT_DEAD)
    sp = np.full(k, -1, dtype=np.int32)
    sc = np.full(k, -1, dtype=np.int32)
    sp[:len(ids)] = svc_prev[ids]
    sc[:len(ids)] = svc_cur[ids]

    kv_changed = (np.asarray(prev_ws.kv_ver) != np.asarray(cur_ws.kv_ver)) \
        | (np.asarray(prev_ws.kv_used) != np.asarray(cur_ws.kv_used))
    kslots = np.flatnonzero(kv_changed).astype(np.int32)
    n_kv = len(kslots)
    kslots = kslots[:k]
    kv_slots = np.full(k, -1, dtype=np.int32)
    kv_slots[:len(kslots)] = kslots
    kv_vers = np.zeros(k, dtype=np.int32)
    kv_vers[:len(kslots)] = np.asarray(cur_ws.kv_ver)[kslots]

    return DeltaFrame(
        node_ids=node_ids, node_kinds=kinds, svc_prev=sp, svc_cur=sc,
        n_node_changes=np.int32(n_nodes), kv_slots=kv_slots,
        kv_vers=kv_vers, n_kv_changes=np.int32(n_kv),
        apply_index=np.asarray(cur_ws.apply_index, dtype=np.int32),
        tick=np.asarray(cur_snap.tick, dtype=np.int32),
    )
