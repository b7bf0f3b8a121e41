"""Batched multi-group raft as dense tensor ops (PyTorch port of
``consul_tpu/ops/raft_ops.py``).

R independent raft groups of P peers each are ONE set of ``[R, P]``
tensors stepped synchronously after every gossip tick
(models/cluster.py): a tick is a fixed sub-phase pipeline — timers,
election start, one RequestVote round, leader appends, one
AppendEntries round, quorum commit — where every message exchange is a
dense ``[R, P, P]`` one-hot round and every state update a masked
``torch.where`` full-array write. No data-dependent scatter: log writes
are masked-arange selects, vote/append source selection is a first-max
``argmax`` over an integer score, commit advance is a quorum count over
the static window axis. The body reads nothing back to the host.

Randomness contract: a tick's only randomness is ONE election-timeout
draw per (group, peer), an ``[R, P]`` int32 tensor handed in by the
caller (the ``swim.TickDraws`` contract). A peer resets its timer at
most once per tick, so the draw tensor is the complete randomness spec:
tests feed the reference's ``draw_table`` and the host oracle replays
the same; the simulation draws its own from a generator reseeded from
``(seed, t)`` (models/raft.py), apart from the gossip tick's stream.

Synchronous-model narrowings vs hashicorp/raft: no membership changes,
no InstallSnapshot (the log is a bounded ``window``-entry
absolute-index buffer; entry w+1 lives at slot w), and AppendEntries
ships the leader's FULL window with wholesale adoption — safe because
the election up-to-date rule (§5.4.1) preserves Leader Completeness.
Commit advance keeps the §5.4.2 current-term-only rule.

Client traffic is intent-based: the host bumps ``next_seq[r]``
(models/raft.py RaftPlane.propose) and every CURRENT leader of group r
appends client entries until its log holds ``next_seq[r]`` of them, so
the k-th committed client entry of a group is always proposal k.

Dtypes are the reference's: int32 and bool end to end (sums are taken
with ``dtype=torch.int32``, argmax indices cast back to int32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import RaftConfig

ROLE_FOLLOWER = 0
ROLE_CANDIDATE = 1
ROLE_LEADER = 2

I32 = torch.int32


class RaftState(NamedTuple):
    """Per-(group, peer) raft state, all dense. ``match`` is row p's
    leader-side view of every peer's replicated length (meaningful only
    while p leads). ``next_seq`` is the host-bumped client-entry intent
    per group."""

    term: torch.Tensor        # [R, P] i32
    role: torch.Tensor        # [R, P] i32 (ROLE_*)
    voted_for: torch.Tensor   # [R, P] i32, -1 = none this term
    leader: torch.Tensor      # [R, P] i32, -1 = unknown
    timer: torch.Tensor       # [R, P] i32 election countdown
    hb: torch.Tensor          # [R, P] i32 leader heartbeat countdown
    log_term: torch.Tensor    # [R, P, W] i32, slot w = entry w+1 (0 = empty)
    log_client: torch.Tensor  # [R, P, W] bool — client entry vs leader no-op
    last_index: torch.Tensor  # [R, P] i32 entries held
    commit: torch.Tensor      # [R, P] i32 committed prefix length
    match: torch.Tensor       # [R, P, P] i32 leader replication view
    next_seq: torch.Tensor    # [R] i32 client-entry intent


class RaftCounters(NamedTuple):
    """Per-tick raft event tallies, [] int32 each. Field order is the
    order of the stacked [8] vector."""

    elections_started: torch.Tensor     # timers expired -> candidate
    elections_won: torch.Tensor         # quorum reached -> leader
    term_changes: torch.Tensor          # higher term adopted from a message
    commit_advances: torch.Tensor       # leader commit-index advances
    heartbeats_sent: torch.Tensor       # heartbeat-cadence AppendEntries
    heartbeats_suppressed: torch.Tensor  # quiet leader ticks (no send due)
    entries_appended: torch.Tensor      # log entries appended (noop+client)
    votes_granted: torch.Tensor         # RequestVote grants issued


FIELDS = RaftCounters._fields

# Sink names (the reference's telemetry table).
METRIC_NAMES = {
    "elections_started": "consul.raft.state.candidate",
    "elections_won": "consul.raft.state.leader",
    "term_changes": "consul.raft.term.changes",
    "commit_advances": "consul.raft.commit.advances",
    "heartbeats_sent": "consul.raft.replication.heartbeat",
    "heartbeats_suppressed": "consul.raft.heartbeat.suppressed",
    "entries_appended": "consul.raft.log.appends",
    "votes_granted": "consul.raft.vote.granted",
}
assert set(METRIC_NAMES) == set(FIELDS)


def counters_stack(c: RaftCounters) -> torch.Tensor:
    """RaftCounters -> one [8] int32 vector in field order (the driver
    adds these up over a chunk)."""
    return torch.stack(list(c))


def _count(mask) -> torch.Tensor:
    return mask.sum(dtype=I32)


# ----------------------------------------------------------------------
# Randomness: the draw tensors a tick and init consume.
# ----------------------------------------------------------------------

def draw_timeouts(rcfg: RaftConfig, gen: torch.Generator,
                  device) -> torch.Tensor:
    """``[R, P]`` int32 election-timeout draws in
    [election_ticks_min, election_ticks_max] from ``gen`` (on
    ``device``): what :func:`tick` and :func:`init` take."""
    return torch.randint(rcfg.election_ticks_min, rcfg.election_ticks_max + 1,
                         (rcfg.groups, rcfg.peers), generator=gen,
                         device=device, dtype=I32)


def init(rcfg: RaftConfig, timers: torch.Tensor) -> RaftState:
    """Fresh raft state: everyone a follower at term 0 with the given
    ``[R, P]`` int32 initial election timeouts (a draw tensor, on the
    device the state lives on)."""
    r, p, w = rcfg.groups, rcfg.peers, rcfg.window
    if tuple(timers.shape) != (r, p) or timers.dtype != I32:
        raise ValueError(f"raft init timers must be int32 [{r}, {p}], got "
                         f"{timers.dtype} {tuple(timers.shape)}")
    dev = timers.device

    def full(shape, v, dtype=I32):
        return torch.full(shape, v, dtype=dtype, device=dev)
    return RaftState(
        term=full((r, p), 0),
        role=full((r, p), ROLE_FOLLOWER),
        voted_for=full((r, p), -1),
        leader=full((r, p), -1),
        timer=timers.clone(),
        hb=full((r, p), 0),
        log_term=full((r, p, w), 0),
        log_client=full((r, p, w), False, torch.bool),
        last_index=full((r, p), 0),
        commit=full((r, p), 0),
        match=full((r, p, p), 0),
        next_seq=full((r,), 0),
    )


# ----------------------------------------------------------------------
# Chaos masks: raft events -> per-tick liveness/deliverability.
# ----------------------------------------------------------------------

RK_KILL = 1
RK_PARTITION = 2
RK_STORM = 3


@functools.lru_cache(maxsize=16)
def _consts(r_count: int, p: int, w: int, device: torch.device):
    """Index tensors of one shape on one device, built once: peer ids,
    window slots, the [P, P] identity and the group ids."""
    pid = torch.arange(p, dtype=I32, device=device)
    wid = torch.arange(w, dtype=I32, device=device)
    eye = torch.eye(p, dtype=torch.bool, device=device)
    group_ids = torch.arange(r_count, dtype=I32, device=device)
    return pid, wid, eye, group_ids


def chaos_masks(sched, t, role, group_ids):
    """Evaluate the schedule's raft slots at tick ``t`` down to
    ``(alive [R, P] bool, deliver [R, P, P] bool)`` where
    ``deliver[r, i, j]`` means a message j -> i is deliverable this
    tick. ``role`` is the tick-start role tensor (leader-kill with
    ``peer=-1`` targets whoever currently leads); ``group_ids`` maps
    rows to group ids. ``sched`` None or zero raft slots is the
    no-chaos branch (decided on shapes, no device read)."""
    r_count, p = role.shape
    dev = role.device
    if sched is None or sched.rk_kind.shape[0] == 0:
        return (torch.ones((r_count, p), dtype=torch.bool, device=dev),
                torch.ones((r_count, p, p), dtype=torch.bool, device=dev))
    pid = torch.arange(p, dtype=I32, device=dev)
    act = (sched.rk_start <= t) & (sched.rk_stop > t)             # [K]
    gsel = act[:, None] & ((sched.rk_group[:, None] < 0)
                           | (sched.rk_group[:, None]
                              == group_ids[None, :]))           # [K, R]
    kind = sched.rk_kind
    arg = sched.rk_arg
    # Kill: explicit peer id, or -1 = the group's current leader(s).
    kill_target = torch.where(
        arg[:, None, None] < 0,
        (role == ROLE_LEADER)[None, :, :],
        arg[:, None, None] == pid[None, None, :])               # [K, R, P]
    kill = torch.any(
        gsel[:, :, None] & (kind == RK_KILL)[:, None, None] & kill_target,
        dim=0)                                                  # [R, P]
    # Partition: peers talk iff both sit on the same side of the cut;
    # Storm: total in-group blackout (the split-vote generator).
    side = pid[None, :] < arg[:, None]                          # [K, P]
    cross = side[:, :, None] != side[:, None, :]                # [K, P, P]
    blocked = torch.any(
        gsel[:, :, None, None]
        & (((kind == RK_PARTITION)[:, None, None, None]
            & cross[:, None, :, :])
           | (kind == RK_STORM)[:, None, None, None]),
        dim=0)                                                  # [R, P, P]
    alive = ~kill
    deliver = ~blocked & alive[:, :, None] & alive[:, None, :]
    return alive, deliver


def chaos_masks_reference(events, t: int, role: np.ndarray,
                          group_ids) -> tuple:
    """Numpy twin of :func:`chaos_masks` over HOST event entries
    (chaos/schedule.py RaftKill/RaftPartition/RaftStorm)."""
    r_count, p = role.shape
    group_ids = np.asarray(group_ids)
    kill = np.zeros((r_count, p), bool)
    blocked = np.zeros((r_count, p, p), bool)
    for e in events:
        if not isinstance(e, (chaos_mod.RaftKill, chaos_mod.RaftPartition,
                              chaos_mod.RaftStorm)):
            continue
        if not (e.start <= t < e.stop):
            continue
        rows = np.nonzero((group_ids == e.group) if e.group >= 0
                          else np.ones(r_count, bool))[0]
        for r in rows:
            if isinstance(e, chaos_mod.RaftKill):
                if e.peer >= 0:
                    kill[r, e.peer] = True
                else:
                    kill[r, role[r] == ROLE_LEADER] = True
            elif isinstance(e, chaos_mod.RaftPartition):
                for i in range(p):
                    for j in range(p):
                        if (i < e.cut) != (j < e.cut):
                            blocked[r, i, j] = True
            else:
                blocked[r, :, :] = True
    alive = ~kill
    deliver = (~blocked & alive[:, :, None] & alive[:, None, :])
    return alive, deliver


# ----------------------------------------------------------------------
# The tick.
# ----------------------------------------------------------------------

def _first_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` as int32 (booleans are
    cast first: ``argmax`` returns the first maximal index)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argmax(x, dim=dim).to(I32)


def tick(rcfg: RaftConfig, rst: RaftState, t: int, draws: torch.Tensor,
         sched=None, group0: int = 0) -> tuple:
    """One synchronous raft tick over every group of ``rst``: returns
    ``(RaftState, RaftCounters)``. ``t`` is the global tick (the gossip
    plane's pre-step ``t``, a host int), ``draws`` the tick's
    ``[R_local, P]`` int32 election-timeout draws of these groups. The
    state's rows are the global groups ``group0 + arange(R_local)`` (a
    shard's block under a mesh, parallel/shard_step.RaftArm), so a raft
    entry of a schedule aimed at group g hits the block that holds g.
    Killed peers are fully frozen — they neither act nor send nor
    receive — and every update below is a masked full-array write."""
    p, w = rcfg.peers, rcfg.window
    r_count = rst.term.shape[0]
    quorum = rcfg.quorum
    pid, wid, eye, group_ids = _consts(r_count, p, w, rst.term.device)
    if group0:
        group_ids = group_ids + int(group0)
    pid_row = pid[None, :]
    pid_col = pid[None, None, :]
    wid3 = wid[None, None, :]
    not_eye = ~eye[None]

    alive, deliver = chaos_masks(sched, t, rst.role, group_ids)
    deliver_t = deliver.transpose(1, 2)

    term, role, voted = rst.term, rst.role, rst.voted_for
    leader, timer, hb = rst.leader, rst.timer, rst.hb
    log_term, log_client = rst.log_term, rst.log_client
    last, commit, match = rst.last_index, rst.commit, rst.match

    # -- A: election timers tick down for live non-leaders ------------
    timer = torch.where(alive & (role != ROLE_LEADER), timer - 1, timer)

    # -- B: timeout -> candidate (term++, vote self, fresh timeout) ---
    start = alive & (role != ROLE_LEADER) & (timer <= 0)
    term = torch.where(start, term + 1, term)
    role = torch.where(start, ROLE_CANDIDATE, role)
    voted = torch.where(start, pid_row, voted)
    leader = torch.where(start, -1, leader)
    timer = torch.where(start, draws, timer)
    c_started = _count(start)

    # -- C: one RequestVote round -------------------------------------
    # Last-log term via a one-hot select over the static window axis.
    llt = torch.where(wid3 == (last - 1)[..., None], log_term,
                      0).sum(dim=-1, dtype=I32)                 # [R, P]
    cand = (role == ROLE_CANDIDATE) & alive                     # senders j
    req = cand[:, None, :] & deliver & not_eye                  # [R, i, j]
    # Receivers adopt the max delivered candidate term (> own ->
    # follower, vote cleared) before judging eligibility.
    max_rt = torch.where(req, term[:, None, :], 0).amax(dim=2)
    adopt = alive & (max_rt > term)
    term_rx = torch.where(adopt, max_rt, term)
    role = torch.where(adopt, ROLE_FOLLOWER, role)
    voted = torch.where(adopt, -1, voted)
    leader = torch.where(adopt, -1, leader)
    c_terms = _count(adopt)
    # Grant rule: same term, candidate's log up-to-date (§5.4.1), vote
    # free or already his. voted_for makes at most one j eligible when
    # set, so the first-True argmax is both "re-grant" and "lowest id".
    up_to_date = (llt[:, None, :] > llt[:, :, None]) | (
        (llt[:, None, :] == llt[:, :, None])
        & (last[:, None, :] >= last[:, :, None]))
    eligible = (req & alive[:, :, None]
                & (term[:, None, :] == term_rx[:, :, None]) & up_to_date
                & ((voted[:, :, None] == -1)
                   | (voted[:, :, None] == pid_col)))
    any_el = eligible.any(dim=2)
    grant_to = torch.where(any_el, _first_max(eligible, 2), -1)  # [R, i]
    granted = grant_to >= 0
    voted = torch.where(granted, grant_to, voted)
    timer = torch.where(granted, draws, timer)
    c_votes = _count(granted)
    term = term_rx
    # Tally: self-vote plus grants whose reply leg (i -> j) delivers.
    gr = granted[:, :, None] & (grant_to[:, :, None] == pid_col)
    votes = (gr & deliver_t).sum(dim=1, dtype=I32) + 1          # [R, j]
    win = (role == ROLE_CANDIDATE) & alive & (votes >= quorum)
    role = torch.where(win, ROLE_LEADER, role)
    leader = torch.where(win, pid_row, leader)
    hb = torch.where(win, 0, hb)              # first heartbeat this tick
    c_won = _count(win)
    # Winner appends a no-op barrier entry when the window has room.
    can_noop = win & (last < w)
    noop_at = can_noop[..., None] & (wid3 == last[..., None])
    log_term = torch.where(noop_at, term[..., None], log_term)
    log_client = log_client & ~noop_at
    last = torch.where(can_noop, last + 1, last)
    match = torch.where(win[..., None],
                        torch.where(eye[None], last[..., None], 0), match)

    # -- D: leaders append pending client intents ---------------------
    is_lead = (role == ROLE_LEADER) & alive
    n_client = (log_client & (wid3 < last[..., None])).sum(
        dim=-1, dtype=I32)                                      # [R, P]
    pending = torch.clamp_min(rst.next_seq[:, None] - n_client, 0)
    k_app = torch.where(is_lead, torch.minimum(pending, w - last), 0)
    app_at = (wid3 >= last[..., None]) & (wid3 < (last + k_app)[..., None])
    log_term = torch.where(app_at, term[..., None], log_term)
    log_client = log_client | app_at
    last = last + k_app
    c_appends = _count(noop_at) + _count(app_at)
    match = torch.where(is_lead[..., None] & eye[None],
                        last[..., None], match)

    # -- E: one AppendEntries round (full-window adoption) ------------
    hb = torch.where(is_lead, hb - 1, hb)
    lag = ((match < last[..., None]) & not_eye).any(dim=-1)
    send = is_lead & ((hb <= 0) | lag)
    hb_fire = send & (hb <= 0)
    hb = torch.where(hb_fire, rcfg.heartbeat_ticks, hb)
    c_hb = _count(hb_fire)
    c_hb_sup = _count(is_lead & ~send)
    # Receiver accepts the highest-term delivering leader (lowest id on
    # the impossible tie: the first maximum of term * (P+1) + (P - id)).
    app = (send[:, None, :] & deliver & not_eye & alive[:, :, None]
           & (term[:, None, :] >= term[:, :, None]))            # [R, i, j]
    score = torch.where(app, term[:, None, :] * (p + 1) + (p - pid_col), -1)
    has_src = score.amax(dim=2) >= 0
    src = torch.where(has_src, _first_max(score, 2), -1)
    src_c = torch.clamp_min(src, 0).long()
    src_term = torch.gather(term, 1, src_c)
    term_up = has_src & (src_term > term)
    term = torch.where(has_src, torch.maximum(term, src_term), term)
    voted = torch.where(term_up, -1, voted)
    role = torch.where(has_src, ROLE_FOLLOWER, role)
    leader = torch.where(has_src, src, leader)
    timer = torch.where(has_src, draws, timer)
    c_terms = c_terms + _count(term_up)
    # Wholesale log adoption from the chosen leader (gathers only).
    src_w = src_c[..., None].expand(-1, -1, w)
    src_lt = torch.gather(log_term, 1, src_w)
    src_lc = torch.gather(log_client, 1, src_w)
    src_last = torch.gather(last, 1, src_c)
    src_commit = torch.gather(commit, 1, src_c)
    log_term = torch.where(has_src[..., None], src_lt, log_term)
    log_client = torch.where(has_src[..., None], src_lc, log_client)
    last = torch.where(has_src, src_last, last)
    commit = torch.where(
        has_src, torch.maximum(commit, torch.minimum(src_commit, src_last)),
        commit)
    # Ack return leg: leader j learns follower i now matches its log.
    ack = (has_src[:, :, None] & (src[:, :, None] == pid_col)
           & deliver_t)                                         # [R, i, j]
    match = torch.where(ack.transpose(1, 2), last[:, :, None], match)

    # -- F: quorum commit (current-term entries only, §5.4.2) ---------
    still_lead = (role == ROLE_LEADER) & alive
    repl = (match[:, :, None, :] >= (wid[None, None, :, None] + 1)).sum(
        dim=3, dtype=I32)                                       # [R, P, W]
    ok_w = ((repl >= quorum) & (log_term == term[..., None])
            & (wid3 < last[..., None]))
    reach = torch.where(ok_w, wid3 + 1, 0).amax(dim=-1)
    new_commit = torch.where(still_lead, torch.maximum(commit, reach), commit)
    c_commit = _count(still_lead & (new_commit > commit))
    commit = new_commit

    out = RaftState(term=term, role=role, voted_for=voted, leader=leader,
                    timer=timer, hb=hb, log_term=log_term,
                    log_client=log_client, last_index=last, commit=commit,
                    match=match, next_seq=rst.next_seq)
    cnt = RaftCounters(
        elections_started=c_started, elections_won=c_won,
        term_changes=c_terms, commit_advances=c_commit,
        heartbeats_sent=c_hb, heartbeats_suppressed=c_hb_sup,
        entries_appended=c_appends, votes_granted=c_votes)
    return out, cnt


# ----------------------------------------------------------------------
# Host-facing summaries (one small fetch per pump).
# ----------------------------------------------------------------------

def summary(rst: RaftState) -> tuple:
    """Per-group ``(term [R], leader [R], commit [R],
    committed_clients [R])``, int32 on the state's device — max term,
    highest-term live leader id (-1 when none), max committed prefix,
    and the number of CLIENT entries inside any peer's committed prefix
    (the commit frontier RaftPlane.pump maps back to proposal tickets:
    committed prefixes are stable, so client entry k is proposal k)."""
    r_count, p, w = rst.log_term.shape
    pid, wid, _, _ = _consts(r_count, p, w, rst.term.device)
    term_g = rst.term.amax(dim=1)
    score = torch.where(rst.role == ROLE_LEADER,
                        rst.term * (p + 1) + (p - pid[None, :]), -1)
    leader_g = torch.where(score.amax(dim=1) >= 0, _first_max(score, 1), -1)
    commit_g = rst.commit.amax(dim=1)
    cc = (rst.log_client & (wid[None, None, :] < rst.commit[..., None])).sum(
        dim=-1, dtype=I32)
    return term_g, leader_g, commit_g, cc.amax(dim=1)
