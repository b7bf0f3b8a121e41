"""The serf layer: Lamport time, user events, queries, leaves (PyTorch port
of ``consul_tpu/models/serf.py``).

Serf sits on top of memberlist (reference serf/serf.go): three Lamport
clocks, fire-and-forget **user events** spread epidemically with
recent-event dedup, request/response **queries**, graceful **leave**
intents, and reap bookkeeping of failed and left members. The fused tick
(:func:`step_counted`) rides the event/query packets on the same gossip
legs as the SWIM plane (``swim.step_counted(..., extra_tx=...)``), then
delivers, tallies query responses, decrements budgets and takes in fresh
arrivals (:func:`_fused_event_post_body`).

**Dtypes.** A ``SerfState`` keeps its serf leaves in the reference's
at-rest dtypes (uint32 clocks, keys and signatures; ``origin_dtype(n)``
origins; int8 transmit budgets), so a state carries across bit for bit
and the packed layout stores them as they are. The functions here widen
them to int64 on entry (CPU PyTorch has no arithmetic on uint32), work
with the uint32 values wrapped exactly where the reference's uint32
arithmetic wraps, and narrow them again on return. The SWIM plane is the
port's dense ``SimState`` (int64) or, in the packed layout, a
``PackedSimState`` (models/layout.py).

**Random numbers** enter as a :class:`SerfDraws` bundle: the SWIM tick's
``TickDraws`` plus the query-response draws of the reference's ``k_ev``
key (serf.py:498, :683-700).

The reference's ``step_counted`` gates the post-gossip half on "any
queued event or open query" (``lax.cond``) and runs it unconditionally
inside its kernel; with nothing queued every mask of the body is false
and it passes the state through, so the port runs it unconditionally,
as the kernel does.

The pre-fusion tick (:func:`step_reference_counted`, reference
serf.py:584-642) stays as the oracle the fused tick is held to: the SWIM
tick alone, then the event plane as a second sweep over the view with
its own gossip columns and loss draws (:class:`ReferenceSerfDraws`).

**Faults and the sentinel.** ``step_counted(..., sched=, sentinel=)``
hands a fault schedule (chaos/schedule.py) and the invariant sentinel to
the SWIM tick, gates the query tally's direct response and both legs of
each relayed copy on ``chaos.pair_ok``, and with the sentinel adds the
Lamport-clock regressions of the tick to ``sentinel_monotonic``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig, to_ticks
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import state as sim_state
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import lamport, merge, scaling
from consul_tpu_torch.parallel import collective as coll

# Event key packing: uint32 = (ltime << 9) | (name & 0xff) << 1 | is_query.
_NAME_SHIFT = 1
_LTIME_SHIFT = 9

# Up to here (origin + 1) << 9 stays below bit 31, so the exact-pack
# dedup signature is collision-free; larger clusters use the avalanche
# hash.
_EXACT_SIG_MAX_N = 1 << 21

_U32 = 0xFFFFFFFF
_I32_MAX = 2 ** 31 - 1


def origin_dtype(n: int) -> torch.dtype:
    """Narrowest signed dtype holding every origin row id (plus the -1
    empty marker) for an ``n``-node cluster: the at-rest ``ev_origin``
    dtype."""
    return torch.int16 if n <= 32767 else torch.int32


def _tx_limit(cfg: SimConfig) -> int:
    return int(scaling.retransmit_limit(cfg.gossip.retransmit_mult, cfg.n))


def _tx_dtype(cfg: SimConfig) -> torch.dtype:
    """Narrowest dtype for remaining-transmit counters (28 at 1M nodes)."""
    return torch.int8 if _tx_limit(cfg) <= 127 else torch.int32


def make_event_key(ltime, name, is_query=False):
    lt = torch.as_tensor(ltime).to(torch.int64) & _U32
    nm = torch.as_tensor(name).to(torch.int64) & 0xFF
    q = torch.as_tensor(is_query).to(torch.int64)
    return ((lt << _LTIME_SHIFT) & _U32) | (nm << _NAME_SHIFT) | q


def event_ltime(key):
    return (torch.as_tensor(key).to(torch.int64) & _U32) >> _LTIME_SHIFT


def event_is_query(key):
    return (torch.as_tensor(key).to(torch.int64) & 1) == 1


class SerfState(NamedTuple):
    swim: object             # SimState, or PackedSimState when packed
    # Lamport clocks (serf.go:57-60).
    clock: torch.Tensor        # [N] uint32 — membership intents
    event_clock: torch.Tensor  # [N] uint32
    query_clock: torch.Tensor  # [N] uint32
    # User-event/query broadcast queue.
    ev_key: torch.Tensor       # [N, E] uint32, 0 = empty
    ev_origin: torch.Tensor    # [N, E] origin_dtype(n)
    ev_tx: torch.Tensor        # [N, E] int8 transmits remaining
    ev_pending: torch.Tensor   # [N, E] bool staged-but-undelivered
    # Recent-event dedup buffers (ltime-bucketed).
    ev_bkt_lt: torch.Tensor    # [N, R] uint32 ltime owning each bucket
    ev_bkt_sig: torch.Tensor   # [N, R, O] uint32 (key, origin) sigs
    q_bkt_lt: torch.Tensor     # [N, R] uint32
    q_bkt_sig: torch.Tensor    # [N, R, O] uint32
    ev_delivered: torch.Tensor  # [N] int32 distinct events delivered
    ev_floor: torch.Tensor     # [N] uint32 minimum accepted event ltime
    q_floor: torch.Tensor      # [N] uint32
    # Outstanding queries, Q slots per origin.
    q_open_key: torch.Tensor   # [N, Q] uint32, 0 = none
    q_deadline: torch.Tensor   # [N, Q] int32 tick
    q_resps: torch.Tensor      # [N, Q] int32 responses received
    q_acks: torch.Tensor       # [N, Q] int32 delivery acks received
    q_responder: torch.Tensor  # [N] bool answers queries
    leave_at: torch.Tensor     # [N] int32 tick the node goes quiet, -1
    down_since: torch.Tensor   # [N, K] int32 tick entry went dead/left, -1


def rest_dtypes(cfg: SimConfig) -> dict:
    """The at-rest dtype of every serf leaf (the reference's)."""
    u32, i32 = torch.uint32, torch.int32
    out = {f: u32 for f in ("clock", "event_clock", "query_clock", "ev_key",
                            "ev_bkt_lt", "ev_bkt_sig", "q_bkt_lt", "q_bkt_sig",
                            "ev_floor", "q_floor", "q_open_key")}
    out.update({f: i32 for f in ("ev_delivered", "q_deadline", "q_resps",
                                 "q_acks", "leave_at", "down_since")})
    out.update(ev_origin=origin_dtype(cfg.n), ev_tx=_tx_dtype(cfg),
               ev_pending=torch.bool, q_responder=torch.bool)
    return out


def _widen(s: SerfState) -> SerfState:
    """Serf leaves to the int64 working set (bools stay bool)."""
    return s._replace(**{
        f: getattr(s, f).to(torch.int64) for f in SerfState._fields[1:]
        if getattr(s, f).dtype != torch.bool})


def _narrow(cfg: SimConfig, s: SerfState) -> SerfState:
    """Serf leaves back to their at-rest dtypes."""
    return s._replace(**{f: getattr(s, f).to(dt)
                         for f, dt in rest_dtypes(cfg).items()})


def init(cfg: SimConfig, gen: torch.Generator, device="cpu") -> SerfState:
    n, e = cfg.n, cfg.serf.event_queue_slots
    r, o, q = cfg.serf.seen_ring, cfg.serf.seen_width, cfg.serf.query_slots
    dt = rest_dtypes(cfg)

    def full(shape, val, field):
        return torch.full(shape, val, dtype=dt[field], device=device)

    return SerfState(
        swim=sim_state.init(cfg, gen, device),
        clock=full((n,), 1, "clock"),
        event_clock=full((n,), 1, "event_clock"),
        query_clock=full((n,), 1, "query_clock"),
        ev_key=full((n, e), 0, "ev_key"),
        ev_origin=full((n, e), -1, "ev_origin"),
        ev_tx=full((n, e), 0, "ev_tx"),
        ev_pending=full((n, e), False, "ev_pending"),
        ev_bkt_lt=full((n, r), 0, "ev_bkt_lt"),
        ev_bkt_sig=full((n, r, o), 0, "ev_bkt_sig"),
        q_bkt_lt=full((n, r), 0, "q_bkt_lt"),
        q_bkt_sig=full((n, r, o), 0, "q_bkt_sig"),
        ev_delivered=full((n,), 0, "ev_delivered"),
        ev_floor=full((n,), 0, "ev_floor"),
        q_floor=full((n,), 0, "q_floor"),
        q_open_key=full((n, q), 0, "q_open_key"),
        q_deadline=full((n, q), 0, "q_deadline"),
        q_resps=full((n, q), 0, "q_resps"),
        q_acks=full((n, q), 0, "q_acks"),
        q_responder=full((n,), True, "q_responder"),
        leave_at=full((n,), -1, "leave_at"),
        down_since=full((n, cfg.degree), -1, "down_since"),
    )


def query_timeout_ticks(cfg: SimConfig) -> int:
    """Default query timeout (reference serf/serf.go DefaultQueryTimeout):
    ``gossip_interval * QueryTimeoutMult * ceil(log10(N+1))``."""
    scale = math.ceil(math.log10(cfg.n + 1))
    return cfg.gossip.gossip_period_ticks * cfg.serf.query_timeout_mult * scale


# ----------------------------------------------------------------------
# Queue and dedup helpers (int64 working tensors).
# ----------------------------------------------------------------------

def _scatter_cols(arr, cols, vals):
    """``arr[i, cols[i, j]] = vals[i, j]``; ``cols`` rows hold distinct
    indices."""
    slots = torch.arange(arr.shape[1], device=arr.device)
    onehot = cols[:, :, None] == slots[None, None, :]          # [N, P, S]
    newv = torch.sum(torch.where(onehot, vals[:, :, None],
                                 torch.zeros_like(vals[:, :, None])), dim=1)
    hit = torch.any(onehot, dim=1)
    return torch.where(hit, newv.to(arr.dtype), arr)


def _equeue_push(cfg: SimConfig, s: SerfState, mask, key_, origin, tx0,
                 pending: bool = False):
    """Insert one event per masked node into its event queue: the same
    subject's slot, else an empty slot, else the most-transmitted entry
    (queue.go:182-242; ties to the lowest slot). Returns (state,
    evicted[N]): a push that displaced a different live entry."""
    same = (s.ev_key == key_[:, None]) & (s.ev_origin == origin[:, None])
    empty = s.ev_key == 0
    zero = torch.zeros_like(s.ev_key)
    score = (torch.where(same, zero + 3_000_000, zero)
             + torch.where(empty, zero + 2_000_000, zero)
             + (1_000_000 - torch.clamp(s.ev_tx, max=999_999)))
    slot = torch.argmax(score, dim=1)
    e = cfg.serf.event_queue_slots
    onehot = ((torch.arange(e, device=slot.device)[None, :] == slot[:, None])
              & mask[:, None])
    evicted = torch.any(onehot & ~same & ~empty, dim=1)
    return s._replace(
        ev_key=torch.where(onehot, key_[:, None], s.ev_key),
        ev_origin=torch.where(onehot, origin[:, None], s.ev_origin),
        ev_tx=torch.where(onehot, torch.full_like(s.ev_tx, tx0), s.ev_tx),
        ev_pending=torch.where(onehot, torch.full_like(s.ev_pending, pending),
                               s.ev_pending),
    ), evicted


def _mul32(a, b: int):
    """``(a * b) mod 2**32`` for int64 ``a`` in [0, 2**32) and a uint32
    constant ``b``, in 16-bit halves so no product leaves int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _U32


def _sig(cfg: SimConfig, key_, origin):
    """32-bit dedup identity of (event key, origin), 0 reserved = empty.
    Below ``_EXACT_SIG_MAX_N`` nodes the exact pack
    ``(1<<31) | (origin+1)<<9 | (name<<1 | is_query)`` (the bucket owns
    the ltime); above it the murmur3-finalizer avalanche of the pair."""
    key_ = torch.as_tensor(key_).to(torch.int64) & _U32
    origin = torch.as_tensor(origin).to(torch.int64)
    if cfg.n <= _EXACT_SIG_MAX_N:
        org = (origin + 1) & _U32
        low = key_ & ((1 << _LTIME_SHIFT) - 1)
        return (1 << 31) | ((org << _LTIME_SHIFT) & _U32) | low
    h = key_ ^ _mul32(origin & _U32, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h | 1


def _buf_lookup(cfg: SimConfig, bkt_lt, bkt_sig, floor, key_, origin):
    """Is (key, origin) a duplicate or stale for its row's buffer?
    ``key_``/``origin`` are [N, E] candidates per row. Rejects when the
    candidate's bucket holds its ltime and its signature (or is full),
    when a newer ltime owns the bucket, or below the floor
    (serf/serf.go:1258-1357)."""
    r, o = cfg.serf.seen_ring, cfg.serf.seen_width
    lt = event_ltime(key_)                                    # [N, E]
    b = lt % r
    blt = swim._take_cols(bkt_lt, b)
    full = swim._take_cols(torch.all(bkt_sig != 0, dim=2), b)
    flat = bkt_sig.reshape(bkt_sig.shape[0], -1)              # [N, R*O]
    slot_bucket = torch.arange(r * o, device=flat.device) // o
    hit = torch.any(
        (flat[:, None, :] == _sig(cfg, key_, origin)[:, :, None])
        & (slot_bucket[None, None, :] == b[:, :, None]), dim=2)
    return ((hit & (blt == lt)) | (full & (blt == lt)) | (blt > lt)
            | (lt < floor[:, None]))


def _buf_apply(cfg: SimConfig, bkt_lt, bkt_sig, floor, mask, key_, origin):
    """Record one (key, origin) per masked node in its ltime buffer. A
    newer ltime landing on an occupied bucket evicts it (clearing its
    other slots) and raises the floor past the evicted ltime."""
    r, o = cfg.serf.seen_ring, cfg.serf.seen_width
    dev = bkt_lt.device
    lt = event_ltime(key_)
    b = lt % r
    b_sel = torch.arange(r, device=dev)[None, :] == b[:, None]   # [N, R]
    blt = swim._take_col(bkt_lt, b)
    takeover = mask & (blt != lt)
    evict = takeover & (blt > 0)
    floor = torch.where(evict, torch.maximum(floor, (blt + 1) & _U32), floor)
    b_oh = b_sel & mask[:, None]
    bkt_lt = torch.where(b_oh, lt[:, None], bkt_lt)
    cur_sig = torch.sum(torch.where(b_sel[:, :, None], bkt_sig,
                                    torch.zeros_like(bkt_sig)), dim=1)  # [N, O]
    free = torch.argmax((cur_sig == 0).to(torch.int64), dim=1)
    slot = torch.where(takeover, torch.zeros_like(free), free)
    s_oh = torch.arange(o, device=dev)[None, :] == slot[:, None]
    new_slot_sig = torch.where(
        s_oh, _sig(cfg, key_, origin)[:, None],
        torch.where(takeover[:, None], torch.zeros_like(cur_sig), cur_sig))
    bkt_sig = torch.where(b_oh[:, :, None], new_slot_sig[:, None, :], bkt_sig)
    return bkt_lt, bkt_sig, floor


def _seen_append(cfg: SimConfig, s: SerfState, mask, key_, origin) -> SerfState:
    """Deliver (key, origin) to the masked nodes: record it in the
    matching (event or query) buffer and count event deliveries."""
    isq = event_is_query(key_) & mask
    isev = ~event_is_query(key_) & mask
    e_lt, e_sig, e_floor = _buf_apply(cfg, s.ev_bkt_lt, s.ev_bkt_sig,
                                      s.ev_floor, isev, key_, origin)
    q_lt, q_sig, q_floor = _buf_apply(cfg, s.q_bkt_lt, s.q_bkt_sig,
                                      s.q_floor, isq, key_, origin)
    return s._replace(
        ev_bkt_lt=e_lt, ev_bkt_sig=e_sig, ev_floor=e_floor,
        q_bkt_lt=q_lt, q_bkt_sig=q_sig, q_floor=q_floor,
        ev_delivered=s.ev_delivered + isev.to(torch.int64))


# ----------------------------------------------------------------------
# Origination verbs: a dense SWIM plane in, mask-driven.
# ----------------------------------------------------------------------

def _mask_on(mask, s: SerfState) -> torch.Tensor:
    return torch.as_tensor(mask).to(device=s.clock.device, dtype=torch.bool)


def user_event(cfg: SimConfig, s: SerfState, mask, name: int) -> SerfState:
    """Fire a user event named ``name`` from every masked node (reference
    serf/serf.go:447-505: stamp with the event clock, increment, deliver
    locally, queue for broadcast)."""
    w = _widen(s)
    mask = _mask_on(mask, s)
    rows = coll.rows(cfg.n, mask.device)
    key_ = make_event_key(w.event_clock, name, False)
    w = w._replace(event_clock=lamport.increment(w.event_clock, mask))
    w, _ = _equeue_push(cfg, w, mask, key_, rows, _tx_limit(cfg))
    return _narrow(cfg, _seen_append(cfg, w, mask, key_, rows))


def query(cfg: SimConfig, s: SerfState, mask, name: int) -> SerfState:
    """Open a query from every masked node (reference serf/serf.go:510-614)
    in a free slot of its [Q] axis, else the earliest-deadline slot."""
    w = _widen(s)
    mask = _mask_on(mask, s)
    rows = coll.rows(cfg.n, mask.device)
    q = cfg.serf.query_slots
    key_ = make_event_key(w.query_clock, name, True)
    free = w.q_open_key == 0
    score = torch.where(free, torch.full_like(w.q_deadline, _I32_MAX),
                        -w.q_deadline)
    slot = torch.argmax(score, dim=1)
    oh = ((torch.arange(q, device=slot.device)[None, :] == slot[:, None])
          & mask[:, None])
    zero = torch.zeros_like(w.q_resps)
    w = w._replace(
        query_clock=lamport.increment(w.query_clock, mask),
        q_open_key=torch.where(oh, key_[:, None], w.q_open_key),
        q_deadline=torch.where(oh, w.swim.t + query_timeout_ticks(cfg),
                               w.q_deadline),
        q_resps=torch.where(oh, zero, w.q_resps),
        q_acks=torch.where(oh, zero, w.q_acks),
    )
    w, _ = _equeue_push(cfg, w, mask, key_, rows, _tx_limit(cfg))
    return _narrow(cfg, _seen_append(cfg, w, mask, key_, rows))


def leave(cfg: SimConfig, s: SerfState, mask) -> SerfState:
    """Graceful departure of the masked nodes (reference serf/serf.go:675):
    the own-fact flips to LEFT and re-arms, and the node goes quiet after
    ``leave_propagate_delay``."""
    mask = _mask_on(mask, s)
    sw = s.swim
    sw = sw._replace(
        leaving=sw.leaving | mask,
        own_tx=torch.where(mask, torch.full_like(sw.own_tx, _tx_limit(cfg)),
                           sw.own_tx))
    delay = to_ticks(cfg.serf.leave_propagate_delay_ms, cfg.gossip.tick_ms)
    w = _widen(s)._replace(swim=sw)
    w = w._replace(
        clock=lamport.increment(w.clock, mask),
        leave_at=torch.where(mask, sw.t + delay, w.leave_at))
    return _narrow(cfg, w)


# ----------------------------------------------------------------------
# The serf tick.
# ----------------------------------------------------------------------

class SerfDraws(NamedTuple):
    """Every random number one serf tick consumes: the SWIM tick's bundle
    (``k_swim``) and the query-response draws of ``k_ev`` (serf.py:498,
    :683-700). The relay draws are empty unless :func:`relay_draws_used`."""

    swim: swim.TickDraws
    u_resp: torch.Tensor      # [N] f32 uniform              k_ev
    relay_u1: torch.Tensor    # [N, rf] f32 uniform          split(fold_in(k_ev, 1), 3)[0]
    relay_u2: torch.Tensor    # [N, rf] f32 uniform          ...[1]
    relay_cols: torch.Tensor  # [rf] int64 in [0, K)         ...[2]


def relay_draws_used(cfg: SimConfig, chaos: bool = False) -> bool:
    """Does a tick draw and run the relayed responses? With relays
    configured, under a fault schedule or with packet loss (serf.py:695)."""
    return cfg.serf.query_relay_factor > 0 and (chaos or cfg.packet_loss > 0.0)


def draw_serf_tick(cfg: SimConfig, gen: torch.Generator, device,
                   chaos: bool = False) -> SerfDraws:
    """Draw one serf tick's bundle from ``gen`` on ``device``; ``chaos``
    for a tick with a fault schedule (``TickDraws.u_pp`` and the relay
    draws)."""
    n = cfg.n
    rf = cfg.serf.query_relay_factor if relay_draws_used(cfg, chaos) else 0
    kw = dict(generator=gen, device=device)
    sw = swim.draw_tick(cfg, gen, device, chaos=chaos)
    return SerfDraws(
        swim=sw,
        u_resp=torch.rand((n,), **kw),
        relay_u1=torch.rand((n, rf), **kw),
        relay_u2=torch.rand((n, rf), **kw),
        relay_cols=torch.randint(0, cfg.degree, (rf,), **kw),
    )


class ReferenceSerfDraws(NamedTuple):
    """Every random number one pre-fusion serf tick
    (:func:`step_reference_counted`) consumes. The first five fields are
    :class:`SerfDraws`' field for field, so the SWIM plane takes the same
    numbers as the fused tick's; the query-response draws come off the
    reference's ``k_resp`` here (``k_cols, k_loss, k_resp = split(k_ev,
    3)``, serf.py:949), and the event sweep's own gossip columns and loss
    draws follow."""

    swim: swim.TickDraws
    u_resp: torch.Tensor      # [N] f32 uniform              k_resp
    relay_u1: torch.Tensor    # [N, rf] f32 uniform          split(fold_in(k_resp, 1), 3)[0]
    relay_u2: torch.Tensor    # [N, rf] f32 uniform          ...[1]
    relay_cols: torch.Tensor  # [rf] int64 in [0, K)         ...[2]
    ev_cols: torch.Tensor     # [fan] int64 in [0, K)        k_cols
    ev_u_drop: torch.Tensor   # [N, fan] f32 uniform         k_loss


def draw_reference_tick(cfg: SimConfig, gen: torch.Generator,
                        ev_gen: torch.Generator, device,
                        chaos: bool = False) -> ReferenceSerfDraws:
    """One pre-fusion tick's bundle: :func:`draw_serf_tick` from ``gen``
    (the same numbers, in the same order, as the fused tick draws), then
    the event sweep's columns and loss draws from ``ev_gen``, so that
    ``gen`` moves exactly as under the fused tick."""
    base = draw_serf_tick(cfg, gen, device, chaos=chaos)
    fan = cfg.gossip.gossip_nodes
    kw = dict(generator=ev_gen, device=device)
    return ReferenceSerfDraws(
        *base,
        ev_cols=torch.randint(0, cfg.degree, (fan,), **kw),
        ev_u_drop=torch.rand((cfg.n, fan), **kw))


def step(cfg: SimConfig, topo, world, s: SerfState, draws: SerfDraws, *,
         sched=None, sentinel: bool = False) -> SerfState:
    """One fused serf tick without its counters (reference serf.py:466)."""
    return step_counted(cfg, topo, world, s, draws, sched=sched,
                        sentinel=sentinel)[0]


def step_counted(cfg: SimConfig, topo, world, s: SerfState, draws: SerfDraws,
                 *, sched=None, sentinel: bool = False):
    """One fused serf tick over a dense SWIM plane; returns (SerfState,
    GossipCounters). The top ``piggyback_events`` queue entries by
    remaining budget are chosen from the pre-tick queue and ride the
    membership gossip; delivery, the query tally, budget decrement and
    intake run after it, then query expiry and reap bookkeeping.
    ``sched`` (None or empty: none) and ``sentinel`` are the SWIM tick's;
    under a schedule the query tally gates its legs on ``chaos.pair_ok``
    (``draws.swim.u_pp`` and the relay draws of
    ``draw_serf_tick(..., chaos=True)``), and the sentinel also counts
    Lamport-clock regressions (serf.py:569-580)."""
    w = _widen(s)
    t = w.swim.t
    sched = chaos_mod.or_none(sched)
    terms = None if sched is None else chaos_mod.node_terms(sched, t)
    clocks0 = (w.clock, w.event_clock, w.query_clock)

    m_tx, order = swim._top_k_peel(w.ev_tx, cfg.serf.piggyback_events)
    m_key = swim._take_cols(w.ev_key, order)
    m_origin = swim._take_cols(w.ev_origin, order)
    m_valid = (m_key > 0) & (m_tx > 0)

    sw, cnt, (ex_legs, ex_n_sends) = swim.step_counted(
        cfg, topo, world, w.swim, draws.swim,
        extra_tx=[m_key, m_origin, m_valid], sched=sched, sentinel=sentinel)
    # Pending graceful leaves whose propagate window closed go quiet.
    quiet = (w.leave_at >= 0) & (sw.t >= w.leave_at)
    sw = sw._replace(left=sw.left | quiet)
    w = w._replace(swim=sw, leave_at=torch.where(
        quiet, torch.full_like(w.leave_at, -1), w.leave_at))
    active = sw.alive_truth & ~sw.left

    w, (n_queued, n_retx, n_dropped) = _fused_event_post(
        cfg, topo, w, active, draws, ex_legs, ex_n_sends, m_tx, order, m_valid,
        sched, terms)
    cnt = cnt._replace(serf_intents_queued=n_queued,
                       serf_intents_retx=n_retx,
                       serf_intents_dropped=n_dropped)

    # Query expiry over the [N, Q] slot axis.
    expired = (w.q_open_key > 0) & (sw.t >= w.q_deadline)
    w = w._replace(q_open_key=torch.where(
        expired, torch.zeros_like(w.q_open_key), w.q_open_key))

    # Reap bookkeeping: the tick each view entry went down.
    st = merge.key_status(sw.view_key)
    is_down = (st == merge.DEAD) | (st == merge.LEFT)
    ds = w.down_since
    down_since = torch.where(is_down & (ds < 0), t.expand_as(ds),
                             torch.where(is_down, ds, torch.full_like(ds, -1)))
    if sentinel:
        # Every clock moves only through lamport.witness (a max), so a
        # regression within the tick is corruption.
        regress = sum(counters_mod.count(after < before) for before, after in
                      zip(clocks0, (w.clock, w.event_clock, w.query_clock)))
        cnt = cnt._replace(sentinel_monotonic=cnt.sentinel_monotonic + regress)
    return _narrow(cfg, w._replace(down_since=down_since)), cnt


def step_reference(cfg: SimConfig, topo, world, s: SerfState,
                   draws: ReferenceSerfDraws, *, sched=None,
                   sentinel: bool = False) -> SerfState:
    """The pre-fusion tick without its counters; see
    :func:`step_reference_counted`."""
    return step_reference_counted(cfg, topo, world, s, draws, sched=sched,
                                  sentinel=sentinel)[0]


def step_reference_counted(cfg: SimConfig, topo, world, s: SerfState,
                           draws: ReferenceSerfDraws, *, sched=None,
                           sentinel: bool = False):
    """The PRE-FUSION serf tick (reference serf.py:593-642): the SWIM tick
    first, with no extra lanes, then the event/query plane as a second
    sweep over the view (:func:`_event_phase_ref`), then query expiry and
    reap bookkeeping as in :func:`step_counted`. The oracle the fused tick
    is held to: from the same seed and SWIM draws, the SWIM plane is the
    same bit for bit, and the delivered-event sets, the Lamport floors and
    the SLO counters agree. Returns (SerfState, GossipCounters)."""
    w = _widen(s)
    t = w.swim.t
    sched = chaos_mod.or_none(sched)
    terms = None if sched is None else chaos_mod.node_terms(sched, t)
    clocks0 = (w.clock, w.event_clock, w.query_clock)
    sw, cnt = swim.step_counted(cfg, topo, world, w.swim, draws.swim,
                                sched=sched, sentinel=sentinel)
    quiet = (w.leave_at >= 0) & (sw.t >= w.leave_at)
    sw = sw._replace(left=sw.left | quiet)
    w = w._replace(swim=sw, leave_at=torch.where(
        quiet, torch.full_like(w.leave_at, -1), w.leave_at))
    active = sw.alive_truth & ~sw.left

    w, (n_queued, n_retx, n_dropped) = _event_phase_ref(
        cfg, topo, w, active, draws, sched, terms)
    cnt = cnt._replace(serf_intents_queued=n_queued,
                       serf_intents_retx=n_retx,
                       serf_intents_dropped=n_dropped)

    expired = (w.q_open_key > 0) & (sw.t >= w.q_deadline)
    w = w._replace(q_open_key=torch.where(
        expired, torch.zeros_like(w.q_open_key), w.q_open_key))

    st = merge.key_status(sw.view_key)
    is_down = (st == merge.DEAD) | (st == merge.LEFT)
    ds = w.down_since
    down_since = torch.where(is_down & (ds < 0), t.expand_as(ds),
                             torch.where(is_down, ds, torch.full_like(ds, -1)))
    if sentinel:
        regress = sum(counters_mod.count(after < before) for before, after in
                      zip(clocks0, (w.clock, w.event_clock, w.query_clock)))
        cnt = cnt._replace(sentinel_monotonic=cnt.sentinel_monotonic + regress)
    return _narrow(cfg, w._replace(down_since=down_since)), cnt


def _event_phase_ref(cfg: SimConfig, topo, s: SerfState, active,
                     draws: ReferenceSerfDraws, sched=None, terms=None):
    """The pre-fusion event phase: deliver, gossip out, take in (reference
    serf.py:898-1075). Each active node delivers the oldest queue entry
    its buffer does not yet hold (witnessing its ltime, answering a
    query); sends the top ``piggyback_events`` entries by budget along
    ``gossip_nodes`` shared displacements to live peers in its view
    (``ev_cols``), each leg surviving loss (or ``chaos.pair_ok``) on
    ``ev_u_drop``; budgets fall by the legs sent and spent delivered
    entries retire; each receiver stages up to 2 fresh arrivals. The
    reference gates this on "any queued event or open query"
    (``lax.cond``); idle, every mask here is false and the state passes
    through, so it runs unconditionally. Returns (state, (queued,
    retransmits, drops))."""
    n, fan = cfg.n, cfg.gossip.gossip_nodes
    dev = s.ev_key.device
    e_slots = cfg.serf.event_queue_slots
    slots_i = torch.arange(e_slots, device=dev)
    grows = coll.rows(n, dev)
    sentinel = _U32
    tx_limit = _tx_limit(cfg)

    # 1. Deliver: the oldest entry the buffer does not yet hold.
    q_fresh = ((s.ev_key > 0) & ~_lookup_any(cfg, s, s.ev_key, s.ev_origin)
               & active[:, None])
    del_key = torch.amin(torch.where(q_fresh, s.ev_key,
                                     torch.full_like(s.ev_key, sentinel)), dim=1)
    has = del_key != sentinel
    slot_match = q_fresh & (s.ev_key == del_key[:, None])
    del_slot = torch.argmax(slot_match.to(torch.int64), dim=1)
    del_origin = swim._take_col(s.ev_origin, del_slot)
    wkey = torch.where(has, del_key, torch.zeros_like(del_key))
    worig = torch.where(has, del_origin, torch.zeros_like(del_origin))
    s = _seen_append(cfg, s, has, wkey, worig)
    lt = event_ltime(wkey)
    isq = event_is_query(wkey) & has
    isev = ~event_is_query(wkey) & has
    s = s._replace(event_clock=lamport.witness(s.event_clock, lt, isev),
                   query_clock=lamport.witness(s.query_clock, lt, isq))
    s = _query_response_tally(cfg, topo, s, active, worig, wkey, isq, grows,
                              draws, sched, terms)

    # 2. Gossip out: the most-retransmittable entries to live view peers.
    m_tx, order = swim._top_k_peel(s.ev_tx, cfg.serf.piggyback_events)
    m_key = swim._take_cols(s.ev_key, order)
    m_origin = swim._take_cols(s.ev_origin, order)
    m_valid = (m_key > 0) & (m_tx > 0) & active[:, None]
    jcols = draws.ev_cols
    peer_status = merge.key_status(s.swim.view_key[:, jcols])     # [N, fan]
    peer_ok = (((peer_status == merge.ALIVE) | (peer_status == merge.SUSPECT))
               & active[:, None])
    sends = torch.sum(peer_ok, dim=1)[:, None] * m_valid.to(torch.int64)
    ev_tx = _scatter_cols(s.ev_tx, order, torch.clamp(m_tx - sends, min=0))
    delivered_now = (slots_i[None, :] == del_slot[:, None]) & has[:, None]
    still_fresh = q_fresh & ~delivered_now
    retire = (ev_tx <= 0) & ~still_fresh
    s = s._replace(ev_tx=ev_tx,
                   ev_key=torch.where(retire, torch.zeros_like(s.ev_key),
                                      s.ev_key))

    # 3. Intake: roll in each displacement's sender, stage up to 2 fresh.
    recv_up = s.swim.alive_truth & ~s.swim.left
    pl = cfg.packet_loss
    cand_key, cand_orig = [], []
    for f in range(fan):
        shift = topo.off[jcols[f]]
        s_key, s_orig, s_valid, s_peer = coll.roll_many(
            [m_key, m_origin, m_valid, peer_ok[:, f]], shift)
        if sched is not None:
            s_terms = chaos_mod.roll_terms(terms, shift)
            ok_leg = chaos_mod.pair_ok(sched, s_terms, terms,
                                       draws.ev_u_drop[:, f], pl)
        else:
            ok_leg = draws.ev_u_drop[:, f] >= pl
        arrived = s_peer & ok_leg & recv_up
        ok = arrived[:, None] & s_valid
        cand_key.append(torch.where(ok, s_key, torch.zeros_like(s_key)))
        cand_orig.append(torch.where(ok, s_orig, torch.full_like(s_orig, -1)))
    ckey = torch.cat(cand_key, dim=1)                         # [N, fan*PE]
    corig = torch.cat(cand_orig, dim=1)
    s, n_queued, n_dropped = _stage_fresh(cfg, s, ckey, corig, tx_limit)
    n_retx = torch.sum(sends).to(torch.int32)
    return s, (n_queued, n_retx, n_dropped)


def _stage_fresh(cfg: SimConfig, s: SerfState, ckey, corig, tx_limit):
    """Stage up to 2 fresh (key, origin) candidates per row into the own
    queue, lowest key first; returns (state, queued, evicted) with the
    counts as int32 scalars."""
    dev = s.ev_key.device
    sentinel = _U32
    fresh = (ckey > 0) & ~_lookup_any(cfg, s, ckey, corig)
    n_queued = torch.zeros((), dtype=torch.int32, device=dev)
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(2):
        win_key = torch.amin(torch.where(fresh, ckey,
                                         torch.full_like(ckey, sentinel)), dim=1)
        got = win_key != sentinel
        slot_i = torch.argmax((fresh & (ckey == win_key[:, None])).to(torch.int64),
                              dim=1)
        win_orig = swim._take_col(corig, slot_i)
        s, evicted = _equeue_push(
            cfg, s, got, torch.where(got, win_key, torch.zeros_like(win_key)),
            torch.where(got, win_orig, torch.full_like(win_orig, -1)),
            tx_limit, pending=True)
        n_queued = n_queued + counters_mod.count(got)
        n_dropped = n_dropped + counters_mod.count(evicted)
        taken = ((ckey == win_key[:, None]) & (corig == win_orig[:, None])
                 & got[:, None])
        fresh = fresh & ~taken
    return s, n_queued, n_dropped


def _lookup_any(cfg: SimConfig, s: SerfState, key_, origin):
    """Duplicate/stale check against the kind-matching buffer; ``key_``
    and ``origin`` are [N, E] candidates per row."""
    seen_ev = _buf_lookup(cfg, s.ev_bkt_lt, s.ev_bkt_sig, s.ev_floor,
                          key_, origin)
    seen_q = _buf_lookup(cfg, s.q_bkt_lt, s.q_bkt_sig, s.q_floor, key_, origin)
    return torch.where(event_is_query(key_), seen_q, seen_ev)


def _query_response_tally(cfg: SimConfig, topo, s: SerfState, active, worig,
                          wkey, isq, grows, draws: SerfDraws, sched=None,
                          terms=None) -> SerfState:
    """Each deliverer of a query acks its origin, and a responder answers
    (serf/query.go): the packet lands if the origin is up, it survives
    loss (directly, or through one of ``query_relay_factor`` relays with
    both legs surviving), and the query's slot is still open. Under a
    schedule each leg is ``chaos.pair_ok`` on its draw, with the origin's
    terms read at its row (serf.py:685-711). The tally is the one
    cross-row write of the serf plane (a scatter-add)."""
    n = cfg.n
    pl = cfg.packet_loss
    if sched is not None:
        og = chaos_mod.NodeTerms(*coll.take_rows_many(list(terms), worig))
        arrived = chaos_mod.pair_ok(sched, terms, og, draws.u_resp, pl)
    else:
        arrived = draws.u_resp >= pl
    rf = cfg.serf.query_relay_factor
    if relay_draws_used(cfg, sched is not None):
        shifts = [-topo.off[draws.relay_cols[i]] for i in range(rf)]
        relay_up = torch.stack(coll.rolls(active, shifts), dim=1)
        if sched is not None:
            legs = []
            for i, x in enumerate(shifts):
                rt = chaos_mod.roll_terms(terms, x)
                legs.append(
                    chaos_mod.pair_ok(sched, terms, rt, draws.relay_u1[:, i], pl)
                    & chaos_mod.pair_ok(sched, rt, og, draws.relay_u2[:, i], pl))
            relayed = torch.stack(legs, dim=1)
        else:
            relayed = (draws.relay_u1 >= pl) & (draws.relay_u2 >= pl)
        arrived = arrived | torch.any(relay_up & relayed, dim=1)
    q_open_g, up_g = coll.all_rows_many(                      # [N, Q], [N]
        [s.q_open_key, s.swim.alive_truth & ~s.swim.left])
    slot_hit = q_open_g[worig] == wkey[:, None]
    landed = isq & arrived & up_g[worig] & (worig != grows) & ~s.swim.external
    landed_slot = landed[:, None] & slot_hit
    resp_slot = landed_slot & s.q_responder[:, None]
    return s._replace(
        q_resps=s.q_resps + coll.sum_scatter_rows(
            worig, resp_slot.to(torch.int64), n),
        q_acks=s.q_acks + coll.sum_scatter_rows(
            worig, landed_slot.to(torch.int64), n))


def _fused_event_post(cfg: SimConfig, topo, s: SerfState, active, draws,
                      ex_legs, ex_n_sends, m_tx, order, m_valid, sched=None,
                      terms=None):
    """Post-gossip half of the fused event plane. The reference runs its
    body under a ``lax.cond`` on "any queued event or open query"; the
    body is the pass-through when idle, so it runs unconditionally here
    (as it does inside the reference's kernel). Returns (state, (queued,
    retransmits, drops))."""
    return _fused_event_post_body(cfg, topo, s, active, draws, ex_legs,
                                  ex_n_sends, m_tx, order, m_valid, sched,
                                  terms)


def _fused_event_post_body(cfg: SimConfig, topo, s: SerfState, active,
                           draws, ex_legs, ex_n_sends, m_tx, order, m_valid,
                           sched=None, terms=None):
    """Deliver, decrement and retire, take in. The oldest staged entry of
    each active node delivers (unless the buffer now rejects it as
    duplicate or stale), witnessing its ltime and answering a query;
    budgets fall by the legs the entry was sent on; spent delivered
    entries retire; up to 2 fresh arrivals off the legs are staged."""
    n = cfg.n
    dev = s.ev_key.device
    slots_i = torch.arange(cfg.serf.event_queue_slots, device=dev)
    grows = coll.rows(n, dev)
    sentinel = _U32
    tx_limit = _tx_limit(cfg)

    # 1. Deliver: the oldest staged-undelivered entry of the own queue.
    pend = s.ev_pending & (s.ev_key > 0) & active[:, None]
    del_key = torch.amin(torch.where(pend, s.ev_key,
                                     torch.full_like(s.ev_key, sentinel)), dim=1)
    has = del_key != sentinel
    slot_match = pend & (s.ev_key == del_key[:, None])
    del_slot = torch.argmax(slot_match.to(torch.int64), dim=1)
    del_origin = swim._take_col(s.ev_origin, del_slot)
    wkey = torch.where(has, del_key, torch.zeros_like(del_key))
    worig = torch.where(has, del_origin, torch.zeros_like(del_origin))
    stale = _lookup_any(cfg, s, wkey[:, None], worig[:, None])[:, 0]
    deliver = has & ~stale
    s = _seen_append(cfg, s, deliver, wkey, worig)
    lt = event_ltime(wkey)
    isq = event_is_query(wkey) & deliver
    isev = ~event_is_query(wkey) & deliver
    s = s._replace(event_clock=lamport.witness(s.event_clock, lt, isev),
                   query_clock=lamport.witness(s.query_clock, lt, isq))
    s = _query_response_tally(cfg, topo, s, active, worig, wkey, isq, grows,
                              draws, sched, terms)
    cleared = (slots_i[None, :] == del_slot[:, None]) & has[:, None]
    ev_pending = s.ev_pending & ~cleared

    # 2. Budget decrement by the legs actually sent; retire spent
    #    delivered entries.
    sends = ex_n_sends[:, None] * m_valid.to(torch.int64)
    ev_tx = _scatter_cols(s.ev_tx, order, torch.clamp(m_tx - sends, min=0))
    retire = (ev_tx <= 0) & ~ev_pending
    s = s._replace(ev_tx=ev_tx,
                   ev_key=torch.where(retire, torch.zeros_like(s.ev_key),
                                      s.ev_key),
                   ev_pending=ev_pending)

    # 3. Intake: stage up to 2 fresh arrivals off the fused legs.
    cand_key, cand_orig = [], []
    for (r_key, r_orig, r_valid), ex_arrived in ex_legs:
        ok = ex_arrived[:, None] & r_valid
        cand_key.append(torch.where(ok, r_key, torch.zeros_like(r_key)))
        cand_orig.append(torch.where(ok, r_orig, torch.full_like(r_orig, -1)))
    ckey = torch.cat(cand_key, dim=1)                         # [N, fan*PE]
    corig = torch.cat(cand_orig, dim=1)
    s, n_queued, n_dropped = _stage_fresh(cfg, s, ckey, corig, tx_limit)
    n_retx = torch.sum(sends).to(torch.int32)
    return s, (n_queued, n_retx, n_dropped)


# ----------------------------------------------------------------------
# Inspection.
# ----------------------------------------------------------------------

def query_slot(s: SerfState, row: int, key: int) -> int:
    """Which [Q] slot of ``row`` holds the open query ``key``; -1 when
    closed or stale."""
    slots = s.q_open_key[row].to(torch.int64).cpu().numpy()
    hits = np.nonzero(slots == int(key))[0]
    return int(hits[0]) if hits.size else -1


def newest_query_slot(s: SerfState, row: int) -> int:
    """The origin's most recently opened slot (highest Lamport time); -1
    when none is open."""
    slots = s.q_open_key[row].to(torch.int64).cpu().numpy()
    if not (slots != 0).any():
        return -1
    lts = np.where(slots != 0, slots >> _LTIME_SHIFT, 0)
    return int(np.argmax(lts))


def event_coverage(cfg: SimConfig, s: SerfState, key_, origin) -> torch.Tensor:
    """Fraction of active nodes whose dedup buffer holds (key, origin).
    Under the exact-pack signature this aliases same-(name, origin)
    events across ltimes: probe with distinct (name, origin) pairs. Needs
    a dense SWIM plane."""
    active = s.swim.alive_truth & ~s.swim.left
    key_ = torch.as_tensor(key_).to(torch.int64)
    bkt_sig = s.q_bkt_sig if bool(event_is_query(key_)) else s.ev_bkt_sig
    sig = _sig(cfg, key_, origin).to(bkt_sig.device)
    got = torch.any((bkt_sig.to(torch.int64) == sig).reshape(cfg.n, -1), dim=1)
    return (torch.sum(got & active).to(torch.float32)
            / torch.clamp(torch.sum(active), min=1).to(torch.float32))


class MemberCounts(NamedTuple):
    alive: torch.Tensor    # [N] int32, per observer over its view
    suspect: torch.Tensor
    dead: torch.Tensor     # failed, not yet reaped
    left: torch.Tensor     # gracefully left, not yet reaped
    reaped: torch.Tensor   # removed from member lists


def member_counts(cfg: SimConfig, s: SerfState) -> MemberCounts:
    """Per-observer membership roll-up with reap applied: failed members
    vanish after ``reconnect_timeout``, left members after
    ``tombstone_timeout`` (reference serf/serf.go:1544-1568). Needs a
    dense SWIM plane."""
    g = cfg.gossip
    st = merge.key_status(s.swim.view_key)
    ds = s.down_since.to(torch.int64)
    down_ticks = torch.where(ds >= 0, s.swim.t - ds, torch.zeros_like(ds))
    reconnect_ticks = to_ticks(cfg.serf.reconnect_timeout_ms, g.tick_ms)
    tombstone_ticks = to_ticks(cfg.serf.tombstone_timeout_ms, g.tick_ms)
    reaped = (((st == merge.DEAD) & (down_ticks > reconnect_ticks))
              | ((st == merge.LEFT) & (down_ticks > tombstone_ticks)))

    def count(mask):
        return torch.sum(mask & ~reaped, dim=1).to(torch.int32)

    return MemberCounts(
        alive=count(st == merge.ALIVE),
        suspect=count(st == merge.SUSPECT),
        dead=count(st == merge.DEAD),
        left=count(st == merge.LEFT),
        reaped=torch.sum(reaped, dim=1).to(torch.int32),
    )
