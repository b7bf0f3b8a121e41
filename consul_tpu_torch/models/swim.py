"""The vectorized SWIM + Lifeguard step function (PyTorch port of
``consul_tpu/models/swim.py``).

One call to :func:`step_counted` advances every simulated node by one
tick and returns the tick's :class:`counters.GossipCounters`. This is the
plain PyTorch formulation of the reference's ``step_counted``: the same
phases, in the same order, over the same struct-of-tensors state, with
the reference's ``extra_tx`` hook that carries the fused serf plane
(models/serf.py) on the gossip legs, its optional fault schedule
(``sched``, chaos/schedule.py) and its invariant sentinel
(``sentinel``).

  1. suspicion expiry (reference suspicion.go:86-97, state.go:1141-1156);
  2. probe windows closing with no ack (state.go:437-456);
  3. probe launch, direct/indirect/TCP legs, Vivaldi feed (state.go:193-435);
  4. gossip fan-out and receiver-side delivery (state.go:517-567);
  5. push-pull anti-entropy (state.go:573-608, :1217-1240);
  6. refutation, suspicion bookkeeping and budget re-arm.

**Random numbers enter as a tensor bundle.** Where the reference splits
the tick key ten ways (swim.py:238) and draws at each site, this step
takes :class:`TickDraws`, one field per draw site. :func:`draw_tick`
fills it from an explicit ``torch.Generator``; a test can fill it from
the reference's own key ladder, which holds the port bit for bit against
the reference with no threefry code in the port.

Per-row reads at a displacement are index gathers here (the TPU's
roll/one-hot formulations were a TPU cost trade; the values are the
same). Every read of another row goes through parallel/collective.py
(rolls, ``take_rows``), so the same step runs on one shard's row block
under a mesh (parallel/shard_step.py). Sparse and dense (complete-graph) views are both supported; the
CUDA tick kernel (ops/cuda_gossip.py) covers the sparse view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import state as state_mod
from consul_tpu_torch.models.state import SimState, own_key as _own_key
from consul_tpu_torch.ops import merge, scaling, topology, vivaldi
from consul_tpu_torch.ops.topology import Topology, World
from consul_tpu_torch.parallel import collective as coll

# Above this degree the reference reads target rows by gather instead of
# K-unrolled rolls; the port keeps the same mode switch.
_ROLL_DEGREE_MAX = 256
_I32_MIN = -(2 ** 31)


class TickDraws(NamedTuple):
    """Every random number one tick consumes, one field per draw site of
    the reference's key ladder (swim.py:238, keys[0..9]). ``u_pp`` is
    drawn only for a tick with a fault schedule (the push-pull session's
    chaos draw, swim.py:1155); otherwise it is empty."""

    jitter: torch.Tensor        # [N] f32 standard normal      keys[0]
    u2: torch.Tensor            # [N, 2] f32 uniform           keys[1]
    relay_jcols: torch.Tensor   # [ic] int64 in [0, K)         keys[2]
    u_a: torch.Tensor           # [N, ic] f32 uniform          keys[3]
    u_b: torch.Tensor           # [N, ic] f32 uniform          keys[4]
    u_c: torch.Tensor           # [N, ic] f32 uniform          keys[5]
    perm_u: torch.Tensor        # [N, K] f32 uniform           keys[6]
    viv_fb: torch.Tensor        # [N, D] f32 uniform(-.5, .5)  split(keys[7])[0]
    grav_fb: torch.Tensor       # [N, D] f32 uniform(-.5, .5)  split(keys[7])[1]
    gossip_jcols: torch.Tensor  # [fan] int64 (dense view only) split(keys[8])[0]
    u_drop: torch.Tensor        # [N, fan] f32 uniform         split(keys[8])[1]
    pp_j: torch.Tensor          # [] int64 in [0, K)           keys[9]
    u_pp: torch.Tensor          # [N] f32 uniform, or [0]      fold_in(keys[9], 1)


def draw_tick(cfg: SimConfig, gen: torch.Generator, device,
              chaos: bool = False) -> TickDraws:
    """Draw one tick's bundle from ``gen`` on ``device``; ``chaos`` adds
    the schedule's push-pull draw, last, so the others do not move."""
    n, k_deg = cfg.n, cfg.degree
    g = cfg.gossip
    ic, fan, d = g.indirect_checks, g.gossip_nodes, cfg.vivaldi.dimensionality
    kw = dict(generator=gen, device=device)

    def uni(*shape):
        return torch.rand(shape, **kw)

    return TickDraws(
        jitter=torch.randn((n,), **kw),
        u2=uni(n, 2),
        relay_jcols=torch.randint(0, k_deg, (ic,), **kw),
        u_a=uni(n, ic),
        u_b=uni(n, ic),
        u_c=uni(n, ic),
        perm_u=uni(n, k_deg),
        viv_fb=uni(n, d) - 0.5,
        grav_fb=uni(n, d) - 0.5,
        gossip_jcols=torch.randint(0, k_deg, (fan,), **kw),
        u_drop=uni(n, fan),
        pp_j=torch.randint(0, k_deg, (), **kw),
        u_pp=uni(n) if chaos else torch.empty((0,), device=device),
    )


class ProtocolScalars(NamedTuple):
    """The static protocol scalars of one cluster size (cluster-size
    scaling laws, evaluated once on the host)."""

    tx_limit: int
    susp_min: float
    susp_max: float
    susp_k: int
    pp_period: int
    own_limit: int


def protocol_scalars(cfg: SimConfig, topo: Topology) -> ProtocolScalars:
    g = cfg.gossip
    n = cfg.n
    tx_limit = int(scaling.retransmit_limit(g.retransmit_mult, n))
    susp_min = float(scaling.suspicion_timeout(
        g.suspicion_mult, n, g.probe_period_ticks))
    # A self-fact must reach the node's K specific trackers: in sparse
    # mode its budget covers one full displacement sweep.
    own_limit = tx_limit if topo.dense else max(tx_limit, cfg.degree)
    return ProtocolScalars(
        tx_limit=tx_limit,
        susp_min=susp_min,
        susp_max=g.suspicion_max_timeout_mult * susp_min,
        susp_k=int(scaling.suspicion_k(g.suspicion_mult, n)),
        pp_period=g.push_pull_period_ticks(n),
        own_limit=own_limit,
    )


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of an int64 tensor (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _accuser_bit(node_id: torch.Tensor) -> torch.Tensor:
    """32-bucket hash bitmask bit for a confirming accuser."""
    return torch.ones_like(node_id) << (node_id % 32)


def _take_cols(table: torch.Tensor, cols: torch.Tensor, fill=0):
    """``out[i, p] = table[i, cols[i, p]]``; out-of-range cols give fill."""
    k = table.shape[1]
    ok = (cols >= 0) & (cols < k)
    vals = torch.gather(table, 1, torch.where(ok, cols, torch.zeros_like(cols)))
    return torch.where(ok, vals, torch.full_like(vals, fill))


def _take_col(table: torch.Tensor, col: torch.Tensor, fill=0):
    """``out[i] = table[i, col[i]]``."""
    return _take_cols(table, col[:, None], fill)[:, 0]


def _top_k_peel(x: torch.Tensor, p: int):
    """Top-p per row as (max value, lowest index on ties) peels — the tie
    order of the reference's ``lax.top_k`` (swim.py:857)."""
    cols = torch.arange(x.shape[-1], device=x.device)
    vals, idxs, work = [], [], x
    for _ in range(p):
        best = torch.argmax(work, dim=-1)
        vals.append(torch.gather(work, -1, best[..., None])[..., 0])
        idxs.append(best)
        work = torch.where(cols == best[..., None],
                           torch.full_like(work, _I32_MIN), work)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def step(cfg: SimConfig, topo: Topology, world: World, state: SimState,
         draws: TickDraws, *, sched=None, sentinel: bool = False) -> SimState:
    """Advance the whole cluster by one tick: :func:`step_counted` with
    its counters discarded (the reference's uncounted wrapper,
    swim.py:184-192)."""
    return step_counted(cfg, topo, world, state, draws, sched=sched,
                        sentinel=sentinel)[0]


def step_counted(cfg: SimConfig, topo: Topology, world: World,
                 state: SimState, draws: TickDraws, extra_tx=None, *,
                 sched=None, sentinel: bool = False):
    """One tick plus its GossipCounters.

    ``extra_tx`` is the serf fusion hook (models/serf.py): a list of
    per-node payload tensors ([N] or [N, P]) that ride the same gossip
    legs as the membership packets. When given, the return grows a third
    element ``(ex_legs, ex_n_sends)``: per leg, the payload as each
    receiver sees it and the leg's arrival mask, and each sender's count
    of legs sent. The extra plane's sender gate is liveness only
    (``alive_truth & ~left``): external seats do send serf traffic.

    ``sched`` is an optional :class:`chaos.ChaosSchedule`; None or an
    empty one is the schedule-free tick. With faults installed, churn
    edges kill and warm-revive rows before anything reads them, every
    delivery leg keeps its draw and gates on ``chaos.pair_ok``, the
    push-pull session draws ``draws.u_pp``, and :func:`_chaos_slo` fills
    the chaos counters. ``sentinel`` adds :func:`_sentinel_check`'s
    invariant tallies over the end-of-tick state."""
    n, k_deg = cfg.n, cfg.degree
    g = cfg.gossip
    dev = state.view_key.device
    t = state.t
    rows = coll.rows(n, dev)
    col_ids = torch.arange(k_deg, dtype=torch.int64, device=dev)
    roll_mode = (not topo.dense) and k_deg <= _ROLL_DEGREE_MAX
    sc = protocol_scalars(cfg, topo)
    sched = chaos_mod.or_none(sched)
    chaos_on = sched is not None
    terms = tgt_terms = None
    if chaos_on:
        if tuple(draws.u_pp.shape) != (coll.local_n(n),):
            raise ValueError("a tick with a fault schedule needs draws.u_pp "
                             "[N]: draw_tick(..., chaos=True)")
        # Churn edges first: a wave starting this tick kills its rows, one
        # ending revives them warm with a bumped incarnation.
        down_now = chaos_mod.down_at(sched, t)
        down_prev = chaos_mod.down_at(sched, t - 1)
        state = state_mod.kill(state, down_now & ~down_prev)
        state = state_mod.revive(cfg, state, down_prev & ~down_now)
        terms = chaos_mod.node_terms(sched, t)

    view0 = state.view_key
    seen0 = state.susp_seen
    own0 = state.own_inc
    active = state.alive_truth & ~state.left & ~state.external
    zero_i = torch.zeros_like(state.own_inc)

    # 1. Suspicion expiry.
    statuses = merge.key_status(state.view_key)
    is_suspect = (statuses == merge.SUSPECT) & (state.susp_start >= 0)
    confirms = torch.clamp(popcount(state.susp_seen) - 1, min=0)
    elapsed = (t - state.susp_start).to(torch.float32)
    remaining = scaling.remaining_suspicion_time(
        confirms, sc.susp_k, elapsed, sc.susp_min, sc.susp_max)
    expired = is_suspect & (remaining <= 0.0) & active[:, None]
    dead_key = merge.make_key(merge.key_incarnation(state.view_key), merge.DEAD)
    state = state._replace(
        view_key=torch.where(expired, dead_key, state.view_key))
    n_deaths = counters_mod.count(expired)

    # 2. Probe windows closing with no ack -> suspect the target.
    failing = ((state.pending_col >= 0) & (t >= state.pending_fail_tick)
               & active)
    n_timeouts = counters_mod.count(failing)
    fcol = torch.where(failing, state.pending_col, zero_i)
    fentry = _take_col(state.view_key, fcol)
    fsus_key = merge.make_key(merge.key_incarnation(fentry), merge.SUSPECT)
    fail_oh = (col_ids[None, :] == fcol[:, None]) & failing[:, None]
    view = torch.where(fail_oh, merge.join(state.view_key, fsus_key[:, None]),
                       state.view_key)
    susp_seen = state.susp_seen | torch.where(
        fail_oh, _accuser_bit(rows)[:, None], torch.zeros_like(state.susp_seen))
    awareness = torch.clamp(
        state.awareness + torch.where(failing, 1 + state.pending_nack_miss,
                                      zero_i),
        0, g.awareness_max - 1)
    state = state._replace(
        view_key=view,
        susp_seen=susp_seen,
        awareness=awareness,
        pending_col=torch.where(failing, -torch.ones_like(zero_i),
                                state.pending_col),
        pending_nack_miss=torch.where(failing, zero_i, state.pending_nack_miss),
    )

    # 3. Probe launch: next contactable target among the next 3 columns.
    probing = active & (t >= state.next_probe_tick)
    cand_pos = (state.probe_ptr[:, None]
                + torch.arange(3, device=dev)[None, :]) % k_deg
    cand_col = _take_cols(state.probe_perm, cand_pos)
    cand_ok = _take_cols(merge.is_contactable(state.view_key), cand_col,
                         fill=False)
    has_target = torch.any(cand_ok, dim=1) & probing
    first_ok = torch.argmax(cand_ok.to(torch.int64), dim=1)
    target_col = _take_col(cand_col, first_ok)
    advance = torch.where(probing,
                          torch.where(has_target, first_ok + 1,
                                      torch.full_like(first_ok, 3)),
                          torch.zeros_like(first_ok))

    viv = state.viv
    tcol = torch.where(has_target, target_col, torch.zeros_like(target_col))
    target = topology.neighbor_of(topo, rows, tcol if roll_mode else target_col)
    # The target's rows, by global id (one gather across shards).
    up_all = state.alive_truth & ~state.left
    tgt = coll.take_rows_many(
        [up_all, world.pos, world.height, viv.vec, viv.height, viv.error,
         viv.adjustment, state.own_inc] + (list(terms) if chaos_on else []),
        target)
    target_up = tgt[0] & has_target
    t_pos, t_h, t_vec, t_vh, t_verr, t_vadj, t_inc = tgt[1:8]
    if chaos_on:
        tgt_terms = chaos_mod.NodeTerms(*tgt[8:])
    true_rtt = vivaldi.norm(world.pos - t_pos) + world.height + t_h
    jitter = draws.jitter * cfg.rtt_jitter_frac
    rtt_obs = true_rtt * torch.exp(jitter) if cfg.rtt_jitter_frac > 0 \
        else true_rtt

    timeout_s = g.probe_timeout_ms / 1000.0
    pl = cfg.packet_loss
    if chaos_on:
        # The direct probe and the TCP fallback each model a round trip
        # on one draw: both directions' terms compose onto it.
        ok_direct_leg = chaos_mod.pair_ok(sched, terms, tgt_terms,
                                          draws.u2[:, 0], pl, round_trip=True)
        ok_tcp_leg = chaos_mod.pair_ok(sched, terms, tgt_terms,
                                       draws.u2[:, 1], pl, round_trip=True)
    else:
        ok_direct_leg = draws.u2[:, 0] >= pl
        ok_tcp_leg = draws.u2[:, 1] >= pl
    direct_ok = has_target & target_up & (rtt_obs <= timeout_s) & ok_direct_leg
    ic = g.indirect_checks
    relay_avail = torch.stack(
        coll.rolls(active, [-topo.off[draws.relay_jcols[i]]
                            for i in range(ic)]), dim=1)
    if chaos_on:
        oka, okb, okc = [], [], []
        for i in range(ic):
            rt = chaos_mod.roll_terms(terms, -topo.off[draws.relay_jcols[i]])
            oka.append(chaos_mod.pair_ok(sched, terms, rt, draws.u_a[:, i], pl))
            okb.append(chaos_mod.pair_ok(sched, rt, tgt_terms, draws.u_b[:, i],
                                         pl, round_trip=True))
            okc.append(chaos_mod.pair_ok(sched, rt, terms, draws.u_c[:, i], pl))
        ok_a, ok_b, ok_c = (torch.stack(x, dim=1) for x in (oka, okb, okc))
    else:
        ok_a = draws.u_a >= pl
        ok_b = draws.u_b >= pl
        ok_c = draws.u_c >= pl
    relay_reached = relay_avail & ok_a
    relay_ok = relay_reached & target_up[:, None] & ok_b
    indirect_ok = has_target & torch.any(relay_ok, dim=1) & ~direct_ok
    tcp_ok = has_target & target_up & ok_tcp_leg
    acked = direct_ok | indirect_ok | tcp_ok
    nack_rcvd = relay_reached & ~(target_up[:, None] & ok_b) & ok_c
    nack_miss = ic - torch.sum(nack_rcvd, dim=1)
    n_probes = counters_mod.count(has_target)
    n_acks = counters_mod.count(acked)
    n_nacks = counters_mod.count(nack_rcvd & (has_target & ~direct_ok)[:, None])

    # Compound ping+suspect poke, delivered receiver-side below.
    target_entry = _take_col(state.view_key, tcol)
    target_status = merge.key_status(
        torch.where(has_target, target_entry, torch.zeros_like(target_entry)))
    target_inc = merge.key_incarnation(target_entry)
    poke_flag = has_target & (target_status == merge.SUSPECT) & ok_direct_leg
    poke_col = torch.where(has_target, target_col, -torch.ones_like(target_col))

    miss = has_target & ~acked
    pending_col = torch.where(miss, target_col, state.pending_col)
    pending_fail_tick = torch.where(miss, t + g.probe_period_ticks,
                                    state.pending_fail_tick)
    pending_nack_miss = torch.where(miss, nack_miss, state.pending_nack_miss)
    interval = g.probe_period_ticks * (state.awareness + 1)
    next_probe = torch.where(probing, t + interval, state.next_probe_tick)
    awareness = torch.clamp(state.awareness - acked.to(torch.int64), 0,
                            g.awareness_max - 1)
    ptr = state.probe_ptr + advance
    # Reshuffle wrapped cursors: a stable ascending argsort of this
    # tick's uniforms (the reference's argsort / argmin peel).
    wrapped = ptr >= k_deg
    perm = torch.argsort(draws.perm_u, dim=1, stable=True)
    probe_perm = torch.where(wrapped[:, None], perm, state.probe_perm)
    # A successful ack joins (target incarnation, ALIVE) at its column.
    ack_oh = col_ids[None, :] == torch.where(
        acked, target_col, -torch.ones_like(target_col))[:, None]
    ack_key = merge.make_key(t_inc, merge.ALIVE)
    view_acked = merge.join(state.view_key, torch.where(
        ack_oh, ack_key[:, None], torch.zeros_like(state.view_key)))

    state = state._replace(
        view_key=view_acked,
        probe_ptr=torch.where(wrapped, torch.zeros_like(ptr), ptr),
        probe_perm=probe_perm,
        next_probe_tick=next_probe,
        pending_col=pending_col,
        pending_fail_tick=pending_fail_tick,
        pending_nack_miss=pending_nack_miss,
        awareness=awareness,
    )
    state = _vivaldi_observe(cfg, state, direct_ok, target_col, rtt_obs,
                             t_vec, t_vh, t_verr, t_vadj, draws)

    # 4. Gossip fan-out and delivery.
    gossip_out = _gossip_phase(cfg, topo, state, active, draws, sc.tx_limit,
                               extra_tx, sched if chaos_on else None, terms)
    (state, refute_gossip, n_gossip_tx, n_gossip_rx, n_gossip_msgs,
     n_chaos_drop) = gossip_out[:6]
    refute_poke = _poke_refutes(cfg, topo, state, poke_flag, poke_col,
                                target_inc)

    # 5. Push-pull anti-entropy.
    state, refute_pp, n_pp_merges = _push_pull_phase(
        cfg, topo, state, active, sc.pp_period, draws,
        sched if chaos_on else None, terms)

    # Refutation: bump own incarnation past any accusation.
    claim = torch.maximum(torch.maximum(refute_gossip, refute_poke), refute_pp)
    refuting = (claim > 0) & active & ~state.leaving
    state = state._replace(
        own_inc=torch.where(refuting, (claim + 1) & 0xFFFFFFFF, state.own_inc),
        own_tx=torch.where(refuting, torch.full_like(state.own_tx, sc.own_limit),
                           state.own_tx),
        awareness=torch.clamp(state.awareness + refuting.to(torch.int64), 0,
                              g.awareness_max - 1),
    )

    # 6. Suspicion bookkeeping, then re-arm every changed entry.
    state, n_susp = _reconcile_suspicion(state, view0, t)
    changed = (state.view_key != view0) | ((state.susp_seen & ~seen0) != 0)
    state = state._replace(tx_left=torch.where(
        changed & active[:, None], torch.full_like(state.tx_left, sc.tx_limit),
        state.tx_left))
    # Canonicalize the probe deadline while no probe is outstanding.
    state = state._replace(pending_fail_tick=torch.where(
        state.pending_col < 0, t.expand_as(state.pending_fail_tick),
        state.pending_fail_tick))

    cnt = counters_mod.zeros(dev)._replace(
        probes_sent=n_probes,
        acks_received=n_acks,
        nacks_received=n_nacks,
        probe_timeouts=n_timeouts,
        suspicions_started=n_susp,
        refutations=counters_mod.count(refuting),
        deaths_declared=n_deaths,
        gossip_tx=n_gossip_tx,
        gossip_rx=n_gossip_rx,
        gossip_msgs_tx=n_gossip_msgs,
        pushpull_merges=n_pp_merges,
    )
    if chaos_on:
        cnt = _chaos_slo(cfg, topo, state, sched, terms, t, expired, active,
                         n_chaos_drop, cnt)
    if sentinel:
        cnt = _sentinel_check(cfg, state, view0, own0, t, cnt)
    if extra_tx is not None:
        return state._replace(t=t + 1), cnt, gossip_out[6]
    return state._replace(t=t + 1), cnt


def _sentinel_check(cfg, state: SimState, view0, own0, t, cnt):
    """The invariant sentinel over the end-of-tick state (before any
    packing): range (incarnation headroom, awareness, probe cursor,
    pending column, no timer started in the future), monotonicity (view
    keys and own incarnations never move down within a tick), suspicion
    (SUSPECT iff timer armed iff accusers), and non-finite Vivaldi
    coordinates and written RTT samples."""
    g = cfg.gossip
    k_deg = cfg.degree
    viv = state.viv
    bad_range = (
        (state.own_inc > merge.MAX_INCARNATION)
        | (state.awareness < 0) | (state.awareness >= g.awareness_max)
        | (state.probe_ptr < 0) | (state.probe_ptr >= k_deg)
        | (state.pending_col < -1) | (state.pending_col >= k_deg)
        | torch.any(state.susp_start > t, dim=1))
    n_mono = (counters_mod.count(state.view_key < view0)
              + counters_mod.count(state.own_inc < own0))
    now_suspect = merge.key_status(state.view_key) == merge.SUSPECT
    timer_armed = state.susp_start >= 0
    seen_nonzero = state.susp_seen != 0
    bad_susp = (now_suspect != timer_armed) | (now_suspect != seen_nonzero)
    bad_coord = (torch.any(~torch.isfinite(viv.vec), dim=1)
                 | ~torch.isfinite(viv.height) | ~torch.isfinite(viv.error)
                 | ~torch.isfinite(viv.adjustment))
    s = cfg.vivaldi.latency_filter_size
    written = (torch.arange(s, device=state.lat_cnt.device)[None, None, :]
               < torch.clamp(state.lat_cnt, max=s)[:, :, None])
    bad_rtt = written & ~torch.isfinite(state.lat_buf)
    return cnt._replace(
        sentinel_range=counters_mod.count(bad_range),
        sentinel_monotonic=n_mono,
        sentinel_suspicion=counters_mod.count(bad_susp),
        sentinel_nonfinite_coord=counters_mod.count(bad_coord),
        sentinel_nonfinite_rtt=counters_mod.count(bad_rtt),
    )


def _chaos_slo(cfg, topo: Topology, state: SimState, sched, terms, t,
               expired, active, n_chaos_drop, cnt):
    """The convergence SLO probes: every tracker's end-of-tick belief
    against the ground truth the schedule defines (partition colors and
    liveness). Four grid-wide indicators per tick (a fault exists; no
    tracker suspects yet; none confirms yet; a lifted fault still leaves
    a reachable live subject suspected), this tick's false deaths, and
    the legs the schedule dropped."""
    n = cfg.n
    rows = coll.rows(n, state.view_key.device)
    # Subject truth packed as (color << 2) | (alive << 1) | left, read at
    # each view column's subject row r + off[c].
    pk = ((terms.color.to(torch.int64) << 2)
          | (state.alive_truth.to(torch.int64) << 1)
          | state.left.to(torch.int64))
    subj = coll.take_rows(pk, (rows[:, None] + topo.off[None, :]) % n)
    subj_color = subj >> 2
    subj_alive = (subj & 2) != 0
    subj_left = (subj & 1) != 0
    st_now = merge.key_status(state.view_key)
    suspected = (st_now == merge.SUSPECT) | (st_now == merge.DEAD)
    confirmed = st_now == merge.DEAD
    cross = subj_color != terms.color.to(torch.int64)[:, None]
    subj_down = ~subj_alive & ~subj_left
    unreach = active[:, None] & (cross | subj_down)
    fault_now = coll.any_rows(torch.any(unreach, dim=1))
    detected = coll.any_rows(torch.any(unreach & suspected, dim=1))
    confirm = coll.any_rows(torch.any(unreach & confirmed, dim=1))
    wrong = active[:, None] & suspected & subj_alive & ~subj_left & ~cross
    healing = (chaos_mod.fault_started(sched, t) & ~fault_now
               & coll.any_rows(torch.any(wrong, dim=1)))
    ind = chaos_mod.shard_once(torch.stack([
        fault_now, fault_now & ~detected, fault_now & ~confirm, healing,
    ]).to(torch.int32))
    false_deaths = counters_mod.count(expired & subj_alive & ~subj_left & ~cross)
    return cnt._replace(
        chaos_fault_ticks=ind[0],
        chaos_first_suspect_wait=ind[1],
        chaos_confirm_wait=ind[2],
        chaos_heal_wait=ind[3],
        chaos_false_deaths=false_deaths,
        chaos_msgs_dropped=n_chaos_drop,
    )


def _vivaldi_observe(cfg, state: SimState, ok, peer_col, rtt,
                     p_vec, p_h, p_err, p_adj, draws: TickDraws):
    """Push one probe RTT per masked node into its per-peer ring buffer,
    take the window median, and run the Vivaldi update against the peer's
    coordinate payload."""
    s = cfg.vivaldi.latency_filter_size
    dev = rtt.device
    n = state.lat_cnt.shape[0]
    col_c = torch.where(ok, peer_col, torch.zeros_like(peer_col))
    cnt = _take_col(state.lat_cnt, col_c)
    slot = cnt % s
    col_oh = torch.arange(state.lat_cnt.shape[1], device=dev)[None, :] \
        == col_c[:, None]
    slot_oh = torch.arange(s, device=dev)[None, :] == slot[:, None]
    write = ok[:, None, None] & col_oh[:, :, None] & slot_oh[:, None, :]
    lat_buf = torch.where(write, rtt[:, None, None], state.lat_buf)
    lat_cnt = torch.where(ok[:, None] & col_oh, state.lat_cnt + 1,
                          state.lat_cnt)
    filled = torch.clamp(torch.where(ok, cnt + 1, torch.ones_like(cnt)), max=s)
    row_buf = lat_buf[torch.arange(n, device=dev), col_c]          # [N, S]
    padded = torch.where(torch.arange(s, device=dev)[None, :] < filled[:, None],
                         row_buf, torch.full_like(row_buf, float("inf")))
    med = _take_col(torch.sort(padded, dim=1).values, filled // 2)
    new_viv = vivaldi.update(
        cfg.vivaldi, state.viv, p_vec, p_h, p_err, p_adj,
        torch.where(ok, med, torch.full_like(med, -1.0)),
        (draws.viv_fb, draws.grav_fb))
    return state._replace(viv=new_viv, lat_buf=lat_buf, lat_cnt=lat_cnt)


def _gossip_jcols(cfg: SimConfig, topo: Topology, t, draws: TickDraws):
    """This tick's shared gossip displacements: i.i.d. draws in dense
    mode, the phase-free deterministic sweep in sparse mode (any
    ceil(K/fan) consecutive ticks serve every column)."""
    fan, k_deg = cfg.gossip.gossip_nodes, cfg.degree
    if topo.dense:
        return draws.gossip_jcols
    sweep_len = -(-k_deg // fan)
    pos = (t % sweep_len) * fan
    return (pos + torch.arange(fan, device=topo.off.device)) % k_deg


def _gossip_phase(cfg, topo: Topology, state: SimState, active,
                  draws: TickDraws, tx_limit, extra_tx=None, sched=None,
                  terms=None):
    """Sender-side top-P selection and budget decrements, then
    receiver-side delivery, lattice merge, Lifeguard confirmations and
    refute-claim collection. Returns (state, refute_inc[N], packets_tx,
    packets_rx, msgs_tx, chaos_drops), plus ``(ex_legs, ex_n_sends)``
    when ``extra_tx`` is given (see :func:`step_counted`). With a
    schedule, each leg is one-way sender -> receiver on its drop draw."""
    g = cfg.gossip
    n, k_deg = cfg.n, cfg.degree
    p, fan = g.piggyback_msgs, g.gossip_nodes
    dev = state.view_key.device
    col_ids = torch.arange(k_deg, dtype=torch.int64, device=dev)
    jcols = _gossip_jcols(cfg, topo, state.t, draws)

    # Sender side: top-P entries by remaining budget (queue.go:288-373).
    budget = torch.where(active[:, None], state.tx_left,
                         torch.zeros_like(state.tx_left))
    top_tx, scol = _top_k_peel(budget, p)
    svalid = top_tx > 0
    skey = _take_cols(state.view_key, scol)
    sbits = _take_cols(state.susp_seen, scol)
    ownk = _own_key(state)
    own_sendable = (state.own_tx > 0) & active
    sendable = merge.is_contactable(state.view_key[:, jcols]) & active[:, None]
    n_sends = torch.sum(sendable, dim=1)
    n_msgs = torch.sum(n_sends * (torch.sum(svalid, dim=1)
                                  + own_sendable.to(torch.int64))).to(torch.int32)
    if extra_tx is not None:
        ex_sendable = (merge.is_contactable(state.view_key[:, jcols])
                       & (state.alive_truth & ~state.left)[:, None])
        ex_n_sends = torch.sum(ex_sendable, dim=1)
        ex_legs = []
    sel_oh = torch.any((scol[:, None, :] == col_ids[None, :, None])
                       & svalid[:, None, :], dim=2)
    tx_left = torch.clamp(state.tx_left - torch.where(
        sel_oh, n_sends[:, None], torch.zeros_like(state.tx_left)), min=0)
    own_tx = torch.where(own_sendable, torch.clamp(state.own_tx - n_sends, min=0),
                         state.own_tx)
    state = state._replace(tx_left=tx_left, own_tx=own_tx)

    # Receiver side: one packet per (receiver, displacement).
    recv_up = state.alive_truth & ~state.left
    pl = cfg.packet_loss
    view = state.view_key
    refute_inc = torch.zeros_like(state.own_inc)
    seen_delta = torch.zeros_like(state.susp_seen)
    n_rx = torch.zeros((), dtype=torch.int32, device=dev)
    n_chaos_drop = torch.zeros((), dtype=torch.int32, device=dev)
    cands = []
    for f in range(fan):
        j = jcols[f]
        payload = [sendable[:, f], scol, skey, sbits, svalid, own_sendable,
                   ownk]
        if extra_tx is not None:
            payload = payload + [ex_sendable[:, f]] + list(extra_tx)
        rolled = coll.roll_many(payload, topo.off[j])
        s_send, s_scol, s_skey, s_sbits, s_svalid, s_own_ok, s_ownk = rolled[:7]
        if sched is not None:
            s_terms = chaos_mod.roll_terms(terms, topo.off[j])
            ok_leg = chaos_mod.pair_ok(sched, s_terms, terms,
                                       draws.u_drop[:, f], pl)
            n_chaos_drop = n_chaos_drop + counters_mod.count(
                s_send & recv_up & (draws.u_drop[:, f] >= pl) & ~ok_leg)
        else:
            ok_leg = draws.u_drop[:, f] >= pl
        arrived = s_send & ok_leg & recv_up
        if extra_tx is not None:
            ex_legs.append((rolled[8:], rolled[7] & ok_leg & recv_up))
        n_rx = n_rx + counters_mod.count(arrived)
        fact_ok = arrived[:, None] & s_svalid
        mycol = topology.remap_row(topo, j)[s_scol]          # [N, P]
        about_me = mycol == topology.SELF
        refut = fact_ok & about_me & merge.is_refutable(
            s_skey, about_me, state.own_inc[:, None])
        refute_inc = torch.maximum(refute_inc, torch.amax(torch.where(
            refut, merge.key_incarnation(s_skey), torch.zeros_like(s_skey)),
            dim=1))
        mergeable = fact_ok & (mycol >= 0)
        mkey = torch.where(mergeable, s_skey, torch.zeros_like(s_skey))
        icol = topology.inv_col(topo, j)
        own_val = torch.where(arrived & s_own_ok, s_ownk,
                              torch.zeros_like(s_ownk))
        delta = torch.zeros_like(view).scatter_reduce(
            1, torch.clamp(mycol, min=0), mkey, "amax")
        delta = torch.where(col_ids[None, :] == icol,
                            torch.maximum(delta, own_val[:, None]), delta)
        view = merge.join(view, delta)
        cands.append((mycol, mkey, s_sbits, mergeable))

    # Lifeguard confirmations against the post-merge view
    # (suspicion.go:103-129).
    for mycol, mkey, bits, ok in cands:
        col_c = torch.clamp(mycol, 0, k_deg - 1)
        post = _take_cols(view, col_c)
        conf = (ok
                & (merge.key_status(mkey) == merge.SUSPECT)
                & (merge.key_status(post) == merge.SUSPECT)
                & (merge.key_incarnation(mkey) >= merge.key_incarnation(post)))
        for pi in range(p):
            oh = (col_c[:, pi:pi + 1] == col_ids[None, :]) & conf[:, pi:pi + 1]
            seen_delta = seen_delta | torch.where(
                oh, bits[:, pi:pi + 1], torch.zeros_like(seen_delta))

    state = state._replace(view_key=view, susp_seen=state.susp_seen | seen_delta)
    out = (state, refute_inc, counters_mod.count(sendable), n_rx, n_msgs,
           n_chaos_drop)
    if extra_tx is not None:
        return out + ((ex_legs, ex_n_sends),)
    return out


def _poke_refutes(cfg, topo: Topology, state: SimState, poke_flag, poke_col,
                  poke_inc):
    """Was I probed this tick by an in-neighbor that believes me suspect?
    Every in-column is checked."""
    n, k_deg = cfg.n, cfg.degree
    up = state.alive_truth & ~state.left
    poked_inc = torch.where(poke_flag, poke_inc, torch.zeros_like(poke_inc))
    if (not topo.dense) and k_deg <= _ROLL_DEGREE_MAX:
        # roll(where(col == j, inc, 0), s) == where(roll(col, s) == j,
        # roll(inc, s), 0): two arrays rolled by every offset.
        claim = torch.zeros_like(state.own_inc)
        cols = coll.rolls(poke_col, topo.off_host)
        incs = coll.rolls(poked_inc, topo.off_host)
        for j in range(len(topo.off_host)):
            contrib = torch.where(cols[j] == j, incs[j],
                                  torch.zeros_like(poked_inc))
            claim = torch.maximum(claim, contrib)
        refut = (claim >= state.own_inc) & up & (claim > 0)
        return torch.where(refut, claim, torch.zeros_like(claim))
    rows = coll.rows(n, poke_col.device)
    s_mat = (rows[:, None] - topo.off[None, :]) % n
    col_ids = torch.arange(k_deg, device=poke_col.device)
    poke_col_s, poke_flag_s, poke_inc_s = coll.take_rows_many(
        [poke_col, poke_flag, poke_inc], s_mat)
    hit = (poke_col_s == col_ids[None, :]) & poke_flag_s & up[:, None]
    inc = torch.where(hit, poke_inc_s, torch.zeros_like(s_mat))
    refut = inc >= state.own_inc[:, None]
    return torch.amax(torch.where(refut & hit, inc, torch.zeros_like(inc)), dim=1)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement, as int64."""
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def pushpull_stagger(rows: torch.Tensor, pp_period: int) -> torch.Tensor:
    """Fixed per-node push-pull phase (Knuth hash, int32 arithmetic)."""
    return _wrap_i32(rows * -1640531527) % pp_period


def _push_pull_phase(cfg, topo: Topology, state: SimState, active, pp_period,
                     draws: TickDraws, sched=None, terms=None):
    """Full-state exchange with one displacement-shared partner per due
    node, both directions, remote dead claims demoted to suspicion.
    Under a schedule the session survives iff its round trip clears
    ``draws.u_pp`` (no base loss: push-pull rides TCP). Returns (state,
    refute_inc[N], merges_applied)."""
    n, k_deg = cfg.n, cfg.degree
    dev = state.view_key.device
    rows = coll.rows(n, dev)
    col_ids = torch.arange(k_deg, dtype=torch.int64, device=dev)
    due = active & ((state.t + pushpull_stagger(rows, pp_period))
                    % pp_period == 0)

    j = draws.pp_j
    shift = topo.off[j]
    icol = topology.inv_col(topo, j)
    rr = topology.remap_row(topo, j)
    rr_c = torch.clamp(rr, 0, k_deg - 1)

    view0 = state.view_key
    ownk = _own_key(state)
    up = state.alive_truth & ~state.left
    zero_k = torch.zeros_like(view0)
    pv, fwd_ownk, partner_up = coll.roll_many([view0, ownk, up], -shift)
    init_ok = due & partner_up & merge.is_contactable(view0[:, j])
    if sched is not None:
        p_terms = chaos_mod.roll_terms(terms, -shift)
        init_ok = init_ok & chaos_mod.pair_ok(sched, terms, p_terms,
                                              draws.u_pp, 0.0, round_trip=True)

    # PULL: the initiator merges its partner's full state.
    ent = torch.where(rr[None, :] >= 0, pv[:, rr_c], zero_k)
    ent = torch.where(col_ids[None, :] == j, fwd_ownk[:, None], ent)
    pull = merge.demote_dead_to_suspect(ent)
    view = merge.join(state.view_key, torch.where(init_ok[:, None], pull, zero_k))
    their_view_of_me = pv[:, icol]
    refut1 = init_ok & merge.is_refutable(their_view_of_me, init_ok,
                                          state.own_inc)
    refute_inc = torch.where(refut1, merge.key_incarnation(their_view_of_me),
                             torch.zeros_like(their_view_of_me))

    # PUSH: node r receives the full state of s = r - off[j] iff s
    # initiated toward r.
    sv, bwd_ownk, bwd_init = coll.roll_many([view0, ownk, init_ok], shift)
    s_ok = bwd_init & up
    rr2 = topology.remap_row(topo, icol)
    rr2_c = torch.clamp(rr2, 0, k_deg - 1)
    ent2 = torch.where(rr2[None, :] >= 0, sv[:, rr2_c], zero_k)
    ent2 = torch.where(col_ids[None, :] == icol, bwd_ownk[:, None], ent2)
    push = merge.demote_dead_to_suspect(ent2)
    view = merge.join(view, torch.where(s_ok[:, None], push, zero_k))
    their_view_of_me2 = sv[:, j]
    refut2 = s_ok & merge.is_refutable(their_view_of_me2, s_ok, state.own_inc)
    refute_inc = torch.maximum(refute_inc, torch.where(
        refut2, merge.key_incarnation(their_view_of_me2),
        torch.zeros_like(their_view_of_me2)))

    n_merges = counters_mod.count(init_ok) + counters_mod.count(s_ok)
    return state._replace(view_key=view), refute_inc, n_merges


def _reconcile_suspicion(state: SimState, view0, t):
    """Suspicion-timer starts/resets from this tick's view delta
    (state.go:1000-1001, :1124-1158, :1178-1179). Returns (state,
    timers_started)."""
    st0, st1 = merge.key_status(view0), merge.key_status(state.view_key)
    inc0 = merge.key_incarnation(view0)
    inc1 = merge.key_incarnation(state.view_key)
    now_suspect = st1 == merge.SUSPECT
    fresh = now_suspect & (st0 != merge.SUSPECT)
    re_inc = now_suspect & (st0 == merge.SUSPECT) & (inc1 > inc0)
    restarted = fresh | re_inc
    susp_start = torch.where(
        restarted, t.expand_as(state.susp_start),
        torch.where(now_suspect, state.susp_start,
                    -torch.ones_like(state.susp_start)))
    zero = torch.zeros_like(state.susp_seen)
    one = torch.ones_like(state.susp_seen)
    susp_seen = torch.where(now_suspect, state.susp_seen, zero)
    susp_seen = torch.where(re_inc, one, susp_seen)
    susp_seen = torch.where(fresh & (susp_seen == 0), one, susp_seen)
    return (state._replace(susp_start=susp_start, susp_seen=susp_seen),
            counters_mod.count(restarted))
