"""Declarative fault schedules compiled to device tensors (PyTorch port of
``consul_tpu/chaos/schedule.py``).

  host description              device form (one ChaosSchedule of tensors)
  -----------------------------------------------------------------------
  Partition(start, stop, A)  -> part_start/stop [P] + part_side [N, P]
  LinkLoss(start, stop,      -> ll_start/stop/fwd/rev [L] +
    A, B, fwd, rev)             ll_a/ll_b [N, L]
  ChurnWave(start, stop,     -> cw_start/stop/period/down [C] +
    nodes, period, down)        cw_mask [N, C]
  Degrade(start, stop,       -> dg_start/stop/tx/rx [D] +
    nodes, tx, rx)              dg_mask [N, D]

The leaves keep the reference's dtypes (int32 ticks, float32 rates, bool
masks), so a schedule crosses into the CUDA tick kernel as it is. Every
delivery leg of the tick keeps its uniform draw and only its threshold
changes: a leg src -> dst survives with probability

  (1 - base_loss) * q_tx(src) * q_rx(dst)
    * prod_l (1 - fwd_l)^[src in A_l][dst in B_l]
    * (1 - rev_l)^[src in B_l][dst in A_l]

and is cut when src and dst sit on different sides of an active
Partition (:func:`pair_ok`). The survival products are taken slot by
slot in a fixed order, the reference's: a one-ulp difference in a
threshold flips a draw.

The raft entries compile into the ``rk_*`` lane as in the reference, which
the raft tier's chaos masks read (``ops/raft_ops.chaos_masks``); a
schedule that holds only raft entries is not empty, so the gossip tick
runs its chaos variant under it, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.parallel import collective as coll

# Partition colors and link-side bitfields are bitmasks over the slots;
# they ride the reference's f32 probe gather, exact below 2^24.
MAX_PARTITIONS = 20
MAX_LINKS = 20
MAX_RAFT_EVENTS = 20


# ----------------------------------------------------------------------
# Host-side schedule entries.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Partition:
    """Full partition over [start, stop): nodes in ``side_a`` reach only
    each other; everyone else forms side B."""

    start: int
    stop: int
    side_a: object  # node ids, bool mask, or slice


@dataclasses.dataclass(frozen=True)
class LinkLoss:
    """Extra loss on A->B (``fwd``) and on B->A (``rev``) over
    [start, stop)."""

    start: int
    stop: int
    a: object
    b: object
    fwd: float
    rev: float = 0.0


@dataclasses.dataclass(frozen=True)
class ChurnWave:
    """Kill/revive pulses: over [start, stop) the masked nodes are down
    whenever ``(t - start) mod period < down_ticks``; ``period=0`` is one
    pulse over the whole window. Revives are warm."""

    start: int
    stop: int
    nodes: object
    period: int = 0
    down_ticks: int = 0


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Lossy nodes over [start, stop): legs they send lose an extra
    ``tx_loss``, legs they receive an extra ``rx_loss``."""

    start: int
    stop: int
    nodes: object
    tx_loss: float = 0.0
    rx_loss: float = 0.0


@dataclasses.dataclass(frozen=True)
class RaftKill:
    """Freeze raft peer ``peer`` of group ``group`` over [start, stop)."""

    start: int
    stop: int
    group: int = -1
    peer: int = -1


@dataclasses.dataclass(frozen=True)
class RaftPartition:
    """Split a raft group's peers at ``cut`` over [start, stop)."""

    start: int
    stop: int
    cut: int
    group: int = -1


@dataclasses.dataclass(frozen=True)
class RaftStorm:
    """Total in-group raft message blackout over [start, stop)."""

    start: int
    stop: int
    group: int = -1


# ----------------------------------------------------------------------
# The compiled schedule.
# ----------------------------------------------------------------------

class ChaosSchedule(NamedTuple):
    """Tick-indexed fault schedule as tensors: per-entry scalars [slots],
    node masks [N, slots] (node axis first)."""

    part_start: torch.Tensor  # [P] int32
    part_stop: torch.Tensor   # [P] int32
    part_side: torch.Tensor   # [N, P] bool — True = side A
    ll_start: torch.Tensor    # [L] int32
    ll_stop: torch.Tensor     # [L] int32
    ll_fwd: torch.Tensor      # [L] float32 — extra loss A->B
    ll_rev: torch.Tensor      # [L] float32 — extra loss B->A
    ll_a: torch.Tensor        # [N, L] bool
    ll_b: torch.Tensor        # [N, L] bool
    cw_start: torch.Tensor    # [C] int32
    cw_stop: torch.Tensor     # [C] int32
    cw_period: torch.Tensor   # [C] int32
    cw_down: torch.Tensor     # [C] int32
    cw_mask: torch.Tensor     # [N, C] bool
    dg_start: torch.Tensor    # [D] int32
    dg_stop: torch.Tensor     # [D] int32
    dg_tx: torch.Tensor       # [D] float32
    dg_rx: torch.Tensor       # [D] float32
    dg_mask: torch.Tensor     # [N, D] bool
    rk_kind: torch.Tensor     # [R] int32 (1 kill, 2 partition, 3 storm)
    rk_group: torch.Tensor    # [R] int32, -1 = every group
    rk_arg: torch.Tensor      # [R] int32 (kill: peer|-1; partition: cut)
    rk_start: torch.Tensor    # [R] int32
    rk_stop: torch.Tensor     # [R] int32


class NodeTerms(NamedTuple):
    """Per-node chaos terms at one tick: the partition-side bitfield
    ``color`` (two nodes talk iff their colors are equal), the active
    LinkLoss side bitfields, and the Degrade survival products."""

    color: torch.Tensor   # [N] int32
    a_bits: torch.Tensor  # [N] int32
    b_bits: torch.Tensor  # [N] int32
    q_tx: torch.Tensor    # [N] float32
    q_rx: torch.Tensor    # [N] float32


def _as_mask(nodes, n: int) -> np.ndarray:
    if isinstance(nodes, slice):
        m = np.zeros(n, bool)
        m[nodes] = True
        return m
    if isinstance(nodes, torch.Tensor):
        nodes = nodes.cpu().numpy()
    a = np.asarray(nodes)
    if a.dtype == np.bool_:
        if a.shape != (n,):
            raise ValueError(f"bool mask must be [{n}], got {a.shape}")
        return a.copy()
    m = np.zeros(n, bool)
    m[a.astype(np.int64)] = True
    return m


def _check_window(e, kind: str):
    if not (0 <= e.start < e.stop):
        raise ValueError(f"{kind} needs 0 <= start < stop, got "
                         f"[{e.start}, {e.stop})")


def _check_rate(v: float, what: str):
    if not (0.0 <= v <= 1.0):
        raise ValueError(f"{what} must be in [0, 1], got {v}")


def compile_schedule(n: int, events: Sequence = (), device="cpu") -> ChaosSchedule:
    """Compile host-side entries into one ChaosSchedule on ``device``.
    Start/stop ticks are relative to an origin the caller picks later
    (:func:`shift_schedule`)."""
    events = list(events)
    parts = [e for e in events if isinstance(e, Partition)]
    links = [e for e in events if isinstance(e, LinkLoss)]
    churn = [e for e in events if isinstance(e, ChurnWave)]
    degr = [e for e in events if isinstance(e, Degrade)]
    rafts = [e for e in events
             if isinstance(e, (RaftKill, RaftPartition, RaftStorm))]
    if len(parts) + len(links) + len(churn) + len(degr) + len(rafts) != len(events):
        raise TypeError("events must be Partition/LinkLoss/ChurnWave/"
                        "Degrade/RaftKill/RaftPartition/RaftStorm")
    if len(parts) > MAX_PARTITIONS:
        raise ValueError(f"at most {MAX_PARTITIONS} Partition entries")
    if len(links) > MAX_LINKS:
        raise ValueError(f"at most {MAX_LINKS} LinkLoss entries")
    if len(rafts) > MAX_RAFT_EVENTS:
        raise ValueError(f"at most {MAX_RAFT_EVENTS} raft events")
    for e in parts:
        _check_window(e, "Partition")
    for e in links:
        _check_window(e, "LinkLoss")
        _check_rate(e.fwd, "LinkLoss.fwd")
        _check_rate(e.rev, "LinkLoss.rev")
    for e in churn:
        _check_window(e, "ChurnWave")
        if e.period < 0 or e.down_ticks < 0:
            raise ValueError("ChurnWave period/down_ticks must be >= 0")
    for e in degr:
        _check_window(e, "Degrade")
        _check_rate(e.tx_loss, "Degrade.tx_loss")
        _check_rate(e.rx_loss, "Degrade.rx_loss")
    for e in rafts:
        _check_window(e, type(e).__name__)
        if isinstance(e, RaftPartition) and e.cut < 1:
            raise ValueError("RaftPartition.cut must be >= 1")

    def i32(xs):
        return torch.from_numpy(np.asarray(xs, np.int32).reshape(-1)).to(device)

    def f32(xs):
        return torch.from_numpy(np.asarray(xs, np.float32).reshape(-1)).to(device)

    def masks(entries, pick):
        cols = [_as_mask(pick(e), n) for e in entries]
        out = np.stack(cols, axis=1) if cols else np.zeros((n, 0), bool)
        return torch.from_numpy(np.ascontiguousarray(out)).to(device)

    # A ChurnWave without a period is one pulse over its whole window.
    cw_period = [e.period if e.period > 0 else e.stop - e.start for e in churn]
    cw_down = [e.down_ticks if e.period > 0 else e.stop - e.start for e in churn]
    rk_kind = [{RaftKill: 1, RaftPartition: 2, RaftStorm: 3}[type(e)]
               for e in rafts]
    rk_arg = [e.peer if isinstance(e, RaftKill)
              else e.cut if isinstance(e, RaftPartition) else 0 for e in rafts]
    return ChaosSchedule(
        part_start=i32([e.start for e in parts]),
        part_stop=i32([e.stop for e in parts]),
        part_side=masks(parts, lambda e: e.side_a),
        ll_start=i32([e.start for e in links]),
        ll_stop=i32([e.stop for e in links]),
        ll_fwd=f32([e.fwd for e in links]),
        ll_rev=f32([e.rev for e in links]),
        ll_a=masks(links, lambda e: e.a),
        ll_b=masks(links, lambda e: e.b),
        cw_start=i32([e.start for e in churn]),
        cw_stop=i32([e.stop for e in churn]),
        cw_period=i32(cw_period),
        cw_down=i32(cw_down),
        cw_mask=masks(churn, lambda e: e.nodes),
        dg_start=i32([e.start for e in degr]),
        dg_stop=i32([e.stop for e in degr]),
        dg_tx=f32([e.tx_loss for e in degr]),
        dg_rx=f32([e.rx_loss for e in degr]),
        dg_mask=masks(degr, lambda e: e.nodes),
        rk_kind=i32(rk_kind),
        rk_group=i32([e.group for e in rafts]),
        rk_arg=i32(rk_arg),
        rk_start=i32([e.start for e in rafts]),
        rk_stop=i32([e.stop for e in rafts]),
    )


def empty(n: int, device="cpu") -> ChaosSchedule:
    return compile_schedule(n, (), device)


def is_empty(sched: ChaosSchedule) -> bool:
    """No slot in any family (the schedule-free tick)."""
    return all(x.shape[0] == 0 for x in (
        sched.part_start, sched.ll_start, sched.cw_start, sched.dg_start,
        sched.rk_kind))


def or_none(sched: Optional[ChaosSchedule]) -> Optional[ChaosSchedule]:
    """The schedule a tick runs under: None for None or an empty one."""
    return None if sched is None or is_empty(sched) else sched


def static_key_of(sched: Optional[ChaosSchedule]):
    """The slot counts of a compiled schedule, family by family; None for
    None or an empty schedule. Schedules of one key run the same tick
    variant, so the lanes of a sweep must share one (``chaos/sweep``)."""
    if sched is None or is_empty(sched):
        return None
    return ("chaos", sched.part_start.shape[0], sched.ll_start.shape[0],
            sched.cw_start.shape[0], sched.dg_start.shape[0],
            sched.rk_kind.shape[0])


def to_device(sched: ChaosSchedule, device) -> ChaosSchedule:
    return ChaosSchedule(*(x.to(device) for x in sched))


def digest_of(sched: Optional[ChaosSchedule]) -> str:
    """Hex SHA-256 over every leaf's dtype, shape and bytes in field
    order, as the reference digests its numpy leaves; ``"none"`` for
    None or an empty schedule."""
    if or_none(sched) is None:
        return "none"
    h = hashlib.sha256()
    for leaf in sched:
        arr = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def shift_schedule(sched: ChaosSchedule, dt) -> ChaosSchedule:
    """Rebase every start/stop by ``dt`` ticks (values only)."""
    dt = int(dt)
    return sched._replace(
        part_start=sched.part_start + dt, part_stop=sched.part_stop + dt,
        ll_start=sched.ll_start + dt, ll_stop=sched.ll_stop + dt,
        cw_start=sched.cw_start + dt, cw_stop=sched.cw_stop + dt,
        dg_start=sched.dg_start + dt, dg_stop=sched.dg_stop + dt,
        rk_start=sched.rk_start + dt, rk_stop=sched.rk_stop + dt,
    )


# ----------------------------------------------------------------------
# Per-tick evaluation.
# ----------------------------------------------------------------------

def _active(start, stop, t):
    return (t >= start) & (t < stop)


def _bitfield(mask, on):
    """Row-wise sum of 1 << slot over the masked active slots (int32)."""
    w = torch.ones_like(on, dtype=torch.int32) << torch.arange(
        on.shape[0], dtype=torch.int32, device=on.device)
    hit = mask & on[None, :]
    return torch.sum(torch.where(hit, w[None, :], torch.zeros_like(w)[None, :]),
                     dim=1).to(torch.int32)


def _slot_product(on, rate):
    """prod over the slots, in slot order, of (1 - rate) where on else 1:
    the left fold of the reference's jnp.prod."""
    q = torch.ones(on.shape[0], dtype=torch.float32, device=on.device)
    for d in range(on.shape[1]):
        q = q * torch.where(on[:, d], 1.0 - rate[d], torch.ones_like(q))
    return q


def node_terms(sched: ChaosSchedule, t) -> NodeTerms:
    """The five per-node transport scalars at tick ``t``."""
    nloc = sched.part_side.shape[0]
    dev = sched.part_side.device
    zeros = torch.zeros((nloc,), dtype=torch.int32, device=dev)
    ones = torch.ones((nloc,), dtype=torch.float32, device=dev)
    color = (_bitfield(sched.part_side, _active(sched.part_start,
                                                sched.part_stop, t))
             if sched.part_start.shape[0] else zeros)
    if sched.ll_start.shape[0]:
        l_act = _active(sched.ll_start, sched.ll_stop, t)
        a_bits = _bitfield(sched.ll_a, l_act)
        b_bits = _bitfield(sched.ll_b, l_act)
    else:
        a_bits, b_bits = zeros, zeros.clone()
    if sched.dg_start.shape[0]:
        on = sched.dg_mask & _active(sched.dg_start, sched.dg_stop, t)[None, :]
        q_tx = _slot_product(on, sched.dg_tx)
        q_rx = _slot_product(on, sched.dg_rx)
    else:
        q_tx, q_rx = ones, ones.clone()
    return NodeTerms(color, a_bits, b_bits, q_tx, q_rx)


def down_at(sched: ChaosSchedule, t) -> torch.Tensor:
    """[N] bool: the nodes a ChurnWave holds down at tick ``t``."""
    nloc = sched.part_side.shape[0]
    if sched.cw_start.shape[0] == 0:
        return torch.zeros((nloc,), dtype=torch.bool, device=sched.cw_mask.device)
    act = _active(sched.cw_start, sched.cw_stop, t)
    phase = (t - sched.cw_start) % torch.clamp(sched.cw_period, min=1)
    down = act & (phase < sched.cw_down)
    return torch.any(sched.cw_mask & down[None, :], dim=1)


def fault_started(sched: ChaosSchedule, t) -> torch.Tensor:
    """[] bool: has a reachability fault (Partition/ChurnWave) begun by
    tick ``t``? Heal time only counts after one existed."""
    started = torch.zeros((), dtype=torch.bool, device=sched.part_start.device)
    if sched.part_start.shape[0]:
        started = started | torch.any(sched.part_start <= t)
    if sched.cw_start.shape[0]:
        started = started | torch.any(sched.cw_start <= t)
    return started


# ----------------------------------------------------------------------
# Pairwise deliverability.
# ----------------------------------------------------------------------

def _link_survival(sched: ChaosSchedule, src: NodeTerms, dst: NodeTerms):
    q = torch.ones_like(src.q_tx)
    fwd_hit = src.a_bits & dst.b_bits
    rev_hit = src.b_bits & dst.a_bits
    for li in range(sched.ll_start.shape[0]):
        bit = 1 << li
        q = q * torch.where((fwd_hit & bit) != 0, 1.0 - sched.ll_fwd[li],
                            torch.ones_like(q))
        q = q * torch.where((rev_hit & bit) != 0, 1.0 - sched.ll_rev[li],
                            torch.ones_like(q))
    return q


def _survival(sched: ChaosSchedule, src: NodeTerms, dst: NodeTerms):
    return src.q_tx * dst.q_rx * _link_survival(sched, src, dst)


def pair_ok(sched: ChaosSchedule, src: NodeTerms, dst: NodeTerms, u,
            base_loss: float, round_trip: bool = False) -> torch.Tensor:
    """One delivery leg src -> dst against its existing uniform ``u``:
    survives iff both share a partition side and ``u`` clears the
    combined threshold. ``round_trip`` composes the reverse direction's
    survival onto the same draw (the probe and push-pull round trips)."""
    q = _survival(sched, src, dst)
    if round_trip:
        q = q * _survival(sched, dst, src)
    p = 1.0 - (1.0 - base_loss) * q
    return (src.color == dst.color) & (u >= p)


# ----------------------------------------------------------------------
# Transport helpers.
# ----------------------------------------------------------------------

def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_f32(x: torch.Tensor) -> torch.Tensor:
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32).view(torch.float32)


def pack_terms(terms: NodeTerms):
    """The five per-node scalars as int64 columns holding uint32 values
    (floats by bit pattern), for one roll."""
    return [terms.color.to(torch.int64), terms.a_bits.to(torch.int64),
            terms.b_bits.to(torch.int64), _f32_bits(terms.q_tx),
            _f32_bits(terms.q_rx)]


def unpack_terms(cols) -> NodeTerms:
    c, a, b, qt, qr = cols
    return NodeTerms(color=c.to(torch.int32), a_bits=a.to(torch.int32),
                     b_bits=b.to(torch.int32), q_tx=_bits_f32(qt),
                     q_rx=_bits_f32(qr))


def roll_terms(terms: NodeTerms, shift) -> NodeTerms:
    """Terms of the node ``shift`` seats back along the ring, at every
    row (``collective.roll`` semantics)."""
    return unpack_terms(coll.roll_many(pack_terms(terms), shift))


def shard_once(x):
    """Zero a replicated indicator on every shard but the first: the
    identity on one device."""
    return coll.shard_once(x)


# The [N, slots] node masks; every other leaf is a per-entry scalar.
NODE_MASKS = ("part_side", "ll_a", "ll_b", "cw_mask", "dg_mask")


def place(sched: ChaosSchedule, shard: int, n_shards: int,
          device) -> ChaosSchedule:
    """Shard ``shard``'s copy of a schedule on ``device``: its row block of
    every node mask, every per-entry scalar whole (the reference's
    shard_step.py:68-75)."""
    n = sched.part_side.shape[0]
    if n % n_shards != 0:
        raise ValueError(f"n={n} must divide over {n_shards} shards")
    b = n // n_shards
    return ChaosSchedule(*(
        (x[shard * b:(shard + 1) * b] if f in NODE_MASKS else x).to(
            device, copy=True)
        for f, x in zip(ChaosSchedule._fields, sched)))
