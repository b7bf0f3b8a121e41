"""The node lens (PyTorch port of ``consul_tpu/obs/lens.py``): one node's
life, replayed out of the batch.

Counters answer "how many false suspicions happened"; they cannot answer
"why was node X falsely suspected at tick 4017". The lens is that
narrative for S sampled node ids: after every tick one ``[S, F]`` f32
row of per-node observables is written into the chunk's ``[C, S, F]``
device buffer, with no read back, and the buffers reach the host in ONE
copy at :meth:`LensRecorder.flush`.

Fields (the order of the F axis; every value is an integer or a bfloat16
that f32 holds exactly, but the serf clock past 2**24):

  ======================  =============================================
  field                   meaning (source leaf)
  ======================  =============================================
  status                  ground truth: 0 dead / 1 alive / 2 leaving /
                          3 left  (alive_truth, leaving, left)
  incarnation             the node's own incarnation (own_inc)
  susp_age                ticks since the OLDEST active suspicion this
                          node holds; -1 when none (susp_start)
  probe_deadline_delta    ticks until the outstanding probe window
                          closes; -1 when no probe in flight
                          (pending_fail_tick, pending_col)
  lamport                 serf membership Lamport clock; 0 under bare
                          SWIM (SerfState.clock)
  vivaldi_error           Vivaldi confidence estimate (viv.error)
  msgs_tx                 queued broadcast transmits remaining
                          (tx_left row sum + own_tx)
  ======================  =============================================

Three row functions: :func:`snapshot` on a dense ``SimState`` (the
reference's), :func:`snapshot_packed` on a ``PackedSimState`` (the plain
version of the CUDA launch L, ``cuda_gossip.LensKernel``, which the
simulation runs on the card), and :func:`raft_snapshot` for the raft fields.
The packed rows read what the packed state holds: ``viv.error`` rests in
bfloat16 (the reference's lens reads the f32 working state before its
repack), and the saturating encodings (``susp_delta`` at 65534,
``pending_fail_delta`` i16, ``own_inc`` u16) report their saturated
values.

Export renders each sampled node's fields as Perfetto counter tracks
("C" events under a ``node-lens`` process) in the same Chrome trace-event
file as the host spans; tick timestamps interpolate linearly across the
enclosing chunk's host span.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

# Field order is the order of the [.., F] axis (the reference's).
FIELDS = ("status", "incarnation", "susp_age", "probe_deadline_delta",
          "lamport", "vivaldi_error", "msgs_tx")

# Appended when the raft tier is armed: lens slot s tracks raft group
# ``ids[s] mod R``: the group's max term, seat 0's role, the leader id the
# summary sees (-1 = none) and the group's max commit index.
RAFT_FIELDS = ("raft_term", "raft_role", "raft_leader", "raft_commit")

# Perfetto process id grouping the lens counter tracks apart from the
# host-span pid (the host tracer uses os.getpid()).
LENS_PID = 2

# The packed codec's sentinels (models/layout.py).
_NO_SUSP = 65535
_NO_COL = 255


def normalize_ids(n: int, sample: Union[int, Sequence[int]]) -> tuple:
    """Resolve a lens request to an id tuple: an int S picks S evenly
    spaced node ids (deterministic: same S, same ids); an iterable passes
    through validated."""
    if isinstance(sample, bool):
        raise TypeError("lens sample must be an int count or id list")
    if isinstance(sample, int):
        if sample <= 0:
            return ()
        s = min(sample, n)
        stride = n // s
        ids = tuple(i * stride for i in range(s))
    else:
        ids = tuple(int(i) for i in sample)
    for i in ids:
        if not 0 <= i < n:
            raise ValueError(f"lens node id {i} outside [0, {n})")
    if len(set(ids)) != len(ids):
        raise ValueError("lens node ids must be distinct")
    return ids


def _index(ids, device) -> torch.Tensor:
    """The ids as an int64 index tensor on ``device`` (passed through
    when they already are one, as the simulation's cached index is)."""
    if isinstance(ids, torch.Tensor):
        return ids
    return torch.tensor(ids, dtype=torch.int64, device=device)


def _u16(leaf, idx):
    """Rows ``idx`` of a uint16 leaf, as int32 (CUDA has no indexing of
    uint16: the bits are gathered as int16 and widened)."""
    return leaf.view(torch.int16)[idx].to(torch.int32) & 0xFFFF


def _lamport(clock, idx, s: int, device):
    if clock is None:
        return torch.zeros((s,), dtype=torch.float32, device=device)
    # uint32 at rest: gathered as int32 bits, widened without a sign.
    return ((clock.view(torch.int32)[idx].to(torch.int64) & 0xFFFFFFFF)
            .to(torch.float32))


def snapshot(sw, clock, ids) -> torch.Tensor:
    """One lens row, ``[S, 7]`` f32, from the dense SWIM plane ``sw`` (and
    the serf Lamport ``clock`` when the simulation has one) at ``ids``."""
    idx = _index(ids, sw.own_inc.device)
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=idx.device)
    status = torch.where(
        sw.left[idx], 3 * one,
        torch.where(sw.leaving[idx], 2 * one,
                    torch.where(sw.alive_truth[idx], one, 0 * one)))
    inc = sw.own_inc[idx].to(f32)
    ss = sw.susp_start[idx]                      # [S, K]
    active = ss >= 0
    oldest = torch.where(active, ss, torch.full_like(ss, 2 ** 31 - 1)).amin(1)
    susp_age = torch.where(active.any(1), (sw.t - oldest).to(f32), -one)
    probing = sw.pending_col[idx] >= 0
    probe = torch.where(probing, (sw.pending_fail_tick[idx] - sw.t).to(f32),
                        -one)
    lamport = _lamport(clock, idx, idx.numel(), idx.device)
    viv_err = sw.viv.error[idx].to(f32)
    msgs = (sw.tx_left[idx].sum(1) + sw.own_tx[idx]).to(f32)
    return torch.stack([status, inc, susp_age, probe, lamport, viv_err, msgs],
                       dim=1)


def snapshot_packed(packed, clock, ids) -> torch.Tensor:
    """One lens row, ``[S, 7]`` f32, decoded from a ``PackedSimState`` as
    the packed codec decodes it: status from the flag bits (alive 1, left
    2, leaving 4), ``own_inc``, the max of ``susp_delta`` over the cells
    that hold a suspicion (-1 when none), ``pending_fail_delta`` where a
    probe column is pending (-1 otherwise), the serf clock (0 without),
    ``viv.error`` widened from bfloat16, and the ``tx_left`` bits of
    ``meta`` summed with ``own_tx``. The plain version of launch L
    (``cuda_gossip.LensKernel``); it runs on the CPU and on the card."""
    idx = _index(ids, packed.flags.device)
    i32, f32 = torch.int32, torch.float32
    flags = packed.flags[idx].to(i32)
    status = torch.where(
        (flags & 2) != 0, 3,
        torch.where((flags & 4) != 0, 2, torch.where((flags & 1) != 0, 1, 0)))
    inc = _u16(packed.own_inc, idx)
    sd = _u16(packed.susp_delta, idx)            # [S, K]
    susp_age = torch.where(sd != _NO_SUSP, sd, -1).amax(1)
    probe = torch.where(packed.pending_col[idx].to(i32) != _NO_COL,
                        packed.pending_fail_delta[idx].to(i32), -1)
    lamport = _lamport(clock, idx, idx.numel(), idx.device)
    viv_err = packed.viv.error[idx].to(f32)
    msgs = ((_u16(packed.meta, idx) >> 2) & 63).sum(1) + packed.own_tx[idx].to(i32)
    return torch.stack([status.to(f32), inc.to(f32), susp_age.to(f32),
                        probe.to(f32), lamport, viv_err, msgs.to(f32)], dim=1)


def raft_snapshot(rst, ids) -> torch.Tensor:
    """The raft lens columns, ``[S, 4]`` f32: lens slot s on raft group
    ``ids[s] mod R`` (plain PyTorch, as the raft step is)."""
    from consul_tpu_torch.ops import raft_ops

    r_count = rst.term.shape[0]
    g = _index(ids, rst.term.device) % r_count
    f32 = torch.float32
    term = rst.term[g].amax(1).to(f32)
    role = rst.role[g, 0].to(f32)
    _, leader_g, commit_g, _ = raft_ops.summary(rst)
    return torch.stack([term, role, leader_g[g].to(f32),
                        commit_g[g].to(f32)], dim=1)


class LensRecorder:
    """Host half of the lens: per-chunk ``[C, S, F]`` device buffers queue
    here (references only, no transfer) and reach the host in ONE copy at
    :meth:`flush` (one ``torch.cat``, one ``.cpu()``), so a chunk reads
    nothing back.

    Each chunk records its host window (tracer-relative microseconds) so
    export can interpolate a timestamp per tick and the node timelines
    land inside the matching ``chunk`` span."""

    def __init__(self, ids: tuple, tick0: int = 0,
                 fields: tuple = FIELDS):
        self.ids = tuple(ids)
        self.fields = tuple(fields)
        self._next_tick = int(tick0)
        self._pending: list = []   # (tick0, ticks, t0_us, t1_us, dev buf)
        self._chunks: list = []    # same tuples with host numpy buffers

    def record(self, buf, ticks: int,
               t0_us: float = 0.0, t1_us: float = 0.0) -> None:
        """Queue one chunk's device buffer (no transfer here)."""
        self._pending.append(
            (self._next_tick, int(ticks), float(t0_us), float(t1_us), buf))
        self._next_tick += int(ticks)

    def flush(self) -> None:
        """One device -> host copy for every queued chunk."""
        if not self._pending:
            return
        bufs = [torch.as_tensor(p[4]) for p in self._pending]
        host = torch.cat(bufs).cpu().numpy()
        at = 0
        for (t0, ticks, a, b, _), buf in zip(self._pending, bufs):
            n = buf.shape[0]
            self._chunks.append((t0, ticks, a, b, host[at:at + n]))
            at += n
        self._pending = []

    @property
    def ticks_recorded(self) -> int:
        self_len = sum(p[1] for p in self._pending)
        return self_len + sum(c[1] for c in self._chunks)

    def timelines(self):
        """``(ticks [T] i32, values [T, S, F] f32)``: the whole recording
        as host numpy arrays (flushes first)."""
        self.flush()
        if not self._chunks:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, len(self.ids), len(self.fields)),
                             np.float32))
        ticks = np.concatenate([
            np.arange(t0, t0 + n, dtype=np.int32)
            for t0, n, _, _, _ in self._chunks])
        vals = np.concatenate([np.asarray(h, np.float32)
                               for _, _, _, _, h in self._chunks])
        return ticks, vals

    def to_json(self) -> dict:
        """The bundle-able summary (debug bundle ``lens.json``)."""
        ticks, vals = self.timelines()
        return {
            "ids": list(self.ids),
            "fields": list(self.fields),
            "ticks": [int(t) for t in ticks],
            "values": [[[float(v) for v in node] for node in row]
                       for row in vals],
        }

    def to_trace_events(self) -> list:
        """Perfetto counter tracks: one "C" series per (node, field),
        timestamps interpolated across each chunk's host window. Plain
        event dicts for ``Tracer.export``'s ``extra_events``: they merge
        into the host-span file without evicting ring entries."""
        self.flush()
        events: list = [
            {"name": "process_name", "ph": "M", "pid": LENS_PID,
             "args": {"name": "node-lens"}},
        ]
        for t0, nticks, a, b, h in self._chunks:
            step_us = (b - a) / max(1, nticks)
            for j in range(nticks):
                ts = a + step_us * j
                for s, nid in enumerate(self.ids):
                    for f, field in enumerate(self.fields):
                        events.append({
                            "name": f"node{nid}/{field}", "cat": "lens",
                            "ph": "C", "ts": round(ts, 3),
                            "pid": LENS_PID,
                            "args": {"value": float(h[j, s, f])},
                        })
        return events
