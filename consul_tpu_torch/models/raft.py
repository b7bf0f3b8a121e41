"""RaftPlane: the host tier of the device raft subsystem (PyTorch port of
``consul_tpu/models/raft.py``).

The device half lives in ``ops/raft_ops.py`` — R groups × P peers of
term/role/log tensors stepped after every gossip tick
(``models/cluster.Simulation._exec_chunk``). This module owns what must
not run per tick: proposal intake, the per-tick timeout draws, the
commit-point pump that turns quorum-committed entries into real write
applies, and the counter fold into the telemetry sink.

Commit contract: with a write-attached serving plane,
``WriteBatcher._run_batch`` routes batches here (:meth:`stage`) instead
of applying them. Each batch becomes one proposal ticket on a raft
group; a group's commit index advances only when a quorum of its peers
holds the entries; and :meth:`pump` (run at the chunk boundary, right
before the serving republish) applies exactly the tickets whose entries
sit inside the committed prefix, through the batcher's own apply — so
the apply index (``X-Consul-Index``) moves ONLY at commit, and an
acknowledged index survives leader loss.

Proposals are intent-based (see the raft_ops module docstring): the
k-th committed client entry of a group is always proposal k, so ticket
completion is a comparison of the committed-client count against the
ticket's end sequence.

Draws: the tick's ``[R, P]`` timeouts come from a generator of the
plane's own, reseeded every tick from the simulation's seed and the
tick number through a salt (:func:`tick_seed`), so arming raft never
moves the gossip trajectory; tests hand in the reference's draw tables
instead (``draws=``, ``timers=``).

Under a mesh the live RaftState is placed by a
``parallel/shard_step.RaftArm`` (group-sharded or replicated), through
which ``Simulation`` steps it after each chunk's gossip ticks; the
summary, the pump and the counters read the same values as on one
device.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from consul_tpu_torch.config import RaftConfig
from consul_tpu_torch.models.cluster import metric_seed
from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import raft_ops

# Salts mixed into the simulation's seed for the raft streams (the
# reference folds 7919 into each tick's key and 40961 into its base key):
# apart from each other and from the metric pairs' stream.
_TICK_SALT = 7919 << 32
_INIT_SALT = 40961 << 32

# A group's max term rising by this much between two pumps marks a
# ``raft.election_storm`` instant on the tracer: a term storm, not an
# ordinary election (the reference's threshold).
STORM_TERM_JUMP = 3


def tick_seed(seed: int, t: int) -> int:
    """The seed of tick ``t``'s raft timeout draws."""
    return metric_seed(seed ^ _TICK_SALT, t)


def init_seed(seed: int) -> int:
    """The seed of the initial election timeouts."""
    return metric_seed(seed ^ _INIT_SALT, 0)


class RaftTicket:
    """One staged proposal batch: ``ops`` are (op, target, arg) write
    triples, ``end_seq`` the group's client-entry sequence after this
    batch. ``done`` fires at commit with ``results`` holding the real
    per-op WriteResults (quorum-committed indexes)."""

    __slots__ = ("ops", "group", "end_seq", "done", "results", "error")

    def __init__(self, ops, group: int, end_seq: int):
        self.ops = list(ops)
        self.group = group
        self.end_seq = end_seq
        self.done = threading.Event()
        self.results = None
        self.error: Optional[Exception] = None

    def wait(self, timeout_s: float = 30.0):
        if not self.done.wait(timeout_s):
            raise TimeoutError(
                f"raft group {self.group} did not commit seq "
                f"{self.end_seq} in {timeout_s}s")
        if self.error is not None:
            raise self.error
        return self.results


class RaftPlane:
    """Host companion of the raft tier (built by ``Simulation.set_raft``).
    Holds the live RaftState between chunks, the proposal ticket queues
    and the cumulative counter dict. ``draws`` maps a tick number to its
    ``[R, P]`` int32 timeout draws on the simulation's device (default:
    the plane's own generator); ``timers`` are the initial timeouts
    (default: drawn from the plane's generator)."""

    def __init__(self, sim, rcfg: RaftConfig,
                 draws: Optional[Callable[[int], torch.Tensor]] = None,
                 timers: Optional[torch.Tensor] = None):
        self.sim = sim
        self.rcfg = rcfg
        self.device = sim.device
        self._gen = torch.Generator(device=self.device)
        if timers is None:
            self._gen.manual_seed(init_seed(sim.seed))
            timers = raft_ops.draw_timeouts(rcfg, self._gen, self.device)
        self.state = raft_ops.init(rcfg, timers.to(self.device))
        # The placement under a mesh (shard_step.RaftArm), None on one device.
        self.arm = None
        if sim.mesh is not None:
            self.place(sim.mesh, sim.groups)
        self.draws = draws if draws is not None else self._own_draws
        self.counters = {f: 0 for f in raft_ops.FIELDS}
        self._pending_vecs: list = []
        self._lock = threading.Lock()
        self._tickets = [deque() for _ in range(rcfg.groups)]
        self._next_seq = [0] * rcfg.groups
        self._rr = 0
        self._writes = None  # the WriteBatcher applying committed tickets
        # Host-side intent bumps, folded into the device ``next_seq`` at
        # the next chunk (take_state), never from a proposer thread.
        self._bumps = np.zeros(rcfg.groups, np.int32)
        # Each group's max term at the last pump (the storm marker's base).
        self._last_term = np.zeros(rcfg.groups, np.int64)

    def whole_state(self) -> raft_ops.RaftState:
        """The live RaftState whole on the first device (gathered from the
        shards when group-sharded)."""
        return self.state if self.arm is None else self.arm.whole(self.state)

    def place(self, mesh, groups=None) -> None:
        """Move the live state onto ``mesh`` (None: one device), as
        ``Simulation.set_mesh`` moves the gossip state."""
        from consul_tpu_torch.parallel import shard_step

        whole = self.whole_state()
        self.arm = (None if mesh is None
                    else shard_step.RaftArm(self.rcfg, mesh, groups))
        self.state = whole if self.arm is None else self.arm.place(whole)

    def _own_draws(self, t: int) -> torch.Tensor:
        self._gen.manual_seed(tick_seed(self.sim.seed, t))
        return raft_ops.draw_timeouts(self.rcfg, self._gen, self.device)

    # -- proposal intake --------------------------------------------------
    def propose(self, ops: Sequence[tuple], group: Optional[int] = None
                ) -> RaftTicket:
        """Stage one batch of write triples on a raft group (round-robin
        by default). Returns the ticket; the entries land in the next
        leader tick and the ticket completes at quorum commit."""
        with self._lock:
            if group is None:
                group = self._rr
                self._rr = (self._rr + 1) % self.rcfg.groups
            group = int(group)
            self._next_seq[group] += len(ops)
            tk = RaftTicket(ops, group, self._next_seq[group])
            self._tickets[group].append(tk)
            self._bumps[group] += len(ops)
        return tk

    def take_state(self) -> raft_ops.RaftState:
        """The RaftState to feed the next chunk (placed, under a mesh),
        with any pending proposal intents folded into ``next_seq`` (one
        [R] add). Called only from the thread that runs the chunks."""
        with self._lock:
            bumps = self._bumps.copy() if self._bumps.any() else None
            if bumps is not None:
                self._bumps[:] = 0
        # The host -> device copy stays outside the lock: proposers must
        # not wait behind it.
        if bumps is not None:
            bumps = torch.from_numpy(bumps).to(self.device)
            self.state = (self.state._replace(
                next_seq=self.state.next_seq + bumps) if self.arm is None
                else self.arm.bump(self.state, bumps))
        return self.state

    def stage(self, batcher, ops: Sequence[tuple]) -> list:
        """WriteBatcher gate: turn an apply-now batch into a proposal.
        Returns provisional ``proposed`` results at once; the REAL
        results — with quorum-committed apply indexes — land on the
        ticket at commit, applied through ``batcher._apply_batch``."""
        from consul_tpu_torch.serving.writes import WriteResult

        self._writes = batcher
        self.propose(ops)
        return [WriteResult(applied=False, index=-1, status="proposed")
                for _ in ops]

    @property
    def inflight(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._tickets)

    # -- commit pump (chunk boundary, before the serving republish) -----
    def _fetch(self) -> np.ndarray:
        """One device -> host copy of ``raft_ops.summary`` (returned as a
        [4, R] int64 array) and of the queued chunks' counters, which
        are folded into ``counters`` and the sink."""
        with self._lock:
            vecs, self._pending_vecs = self._pending_vecs, []
        summ = (raft_ops.summary(self.state) if self.arm is None
                else self.arm.summary(self.state))
        parts = [torch.stack(summ).flatten().long()]
        if vecs:
            parts.append(torch.stack(vecs).sum(dim=0, dtype=torch.int64))
        host = torch.cat(parts).cpu().numpy()
        r = self.rcfg.groups
        sink = getattr(self.sim, "sink", None)
        for f, v in zip(raft_ops.FIELDS, host[4 * r:].tolist()):
            self.counters[f] += v
            if v and sink is not None:
                sink.incr_counter(raft_ops.METRIC_NAMES[f], v)
        return host[:4 * r].reshape(4, r)

    def pump(self) -> int:
        """Fold pending counters and read the per-group commit frontier
        (one small copy, the ``raft.step`` span), mark a term storm (any
        group's term up by STORM_TERM_JUMP since the last pump) as a
        ``raft.election_storm`` instant, then apply every ticket whose
        entries are quorum-committed, each in a ``raft.commit`` span.
        Returns the number of tickets applied."""
        with obs_trace.span("raft.step", cat="raft",
                            args={"groups": self.rcfg.groups}):
            term_g, leader_g, commit_g, cc = self._fetch()
        jump = term_g.astype(np.int64) - self._last_term
        if np.any(jump >= STORM_TERM_JUMP) and np.any(self._last_term > 0):
            obs_trace.get_tracer().instant(
                "raft.election_storm", cat="raft",
                args={"max_jump": int(jump.max()),
                      "terms": [int(x) for x in term_g]})
        self._last_term = term_g.astype(np.int64)
        sink = getattr(self.sim, "sink", None)
        if sink is not None:
            sink.set_gauge("consul.raft.commitIndex", int(commit_g.max()))
        applied = 0
        for r in range(self.rcfg.groups):
            while True:
                with self._lock:
                    q = self._tickets[r]
                    if not q or q[0].end_seq > int(cc[r]):
                        break
                    tk = q.popleft()
                applied += 1
                with obs_trace.span("raft.commit", cat="raft",
                                    args={"group": r, "n": len(tk.ops),
                                          "commit": int(commit_g[r])}):
                    try:
                        if self._writes is not None:
                            tk.results = self._writes._apply_batch(tk.ops)
                        else:
                            from consul_tpu_torch.serving.writes import (
                                WriteResult)

                            tk.results = [
                                WriteResult(applied=True,
                                            index=int(commit_g[r]),
                                            status="committed")
                                for _ in tk.ops]
                    except Exception as e:  # noqa: BLE001 - surfaced on the waiter
                        tk.error = e
                tk.done.set()
        return applied

    # -- counters (the Simulation._flush_counters discipline) -----------
    def absorb(self, vec: torch.Tensor) -> None:
        """Queue one chunk's [8] int32 counter vector for the next fetch
        (no device read on the hot path)."""
        with self._lock:
            self._pending_vecs.append(vec)

    def counters_snapshot(self) -> dict:
        """Cumulative counters by field, after folding the queued chunks."""
        self._fetch()
        return dict(self.counters)

    # -- introspection ----------------------------------------------------
    def summary(self) -> dict:
        """Per-group host view: terms, leader ids (-1 = none), commit
        indexes, committed client-entry counts."""
        term_g, leader_g, commit_g, cc = self._fetch()
        return {
            "terms": [int(x) for x in term_g],
            "leaders": [int(x) for x in leader_g],
            "commit": [int(x) for x in commit_g],
            "committed_clients": [int(x) for x in cc],
        }
