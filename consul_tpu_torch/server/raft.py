"""Raft-lite: deterministic in-process consensus for the server tier.

The port's copy of ``consul_tpu/server/raft.py``, host-only apart from the
lockstep oracle of the device raft tier, which takes the port's draw tables
(``ops/raft_ops.draw_timeouts``, ``models/raft.RaftPlane``) instead of
the reference's keys.

The reference vendors hashicorp/raft (~8.7k LoC; reference
vendor/github.com/hashicorp/raft) for leader election, log replication,
and FSM snapshots, driven by wall-clock timers over TCP. This
implementation keeps the protocol core — terms, randomized election
timeouts, RequestVote/AppendEntries with the log-matching property,
quorum commit, log compaction with InstallSnapshot — but is
**tick-driven and deterministic**: timers are tick counters, randomness
is a per-node seeded RNG, and messages flow through an in-memory
transport with explicit partition control (the moral equivalent of the
reference's inmem_transport.go used by dev mode and every raft test).

Determinism is the point: the TPU framework's control plane must be
replayable the same way the data plane is (same seed ⇒ same trajectory),
so consensus tests never flake and fault injection (partitions, node
stops) is scriptable — SURVEY.md §5 "race detection" TPU equivalent.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import zlib
from typing import Any, Callable, Optional

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# Membership/suffrage changes ride the log as configuration entries
# (reference raft configuration LogConfiguration entries): command
# ``{"type": RAFT_CONFIG, "op": promote|demote|add_nonvoter|remove,
# "id": node_id}``. They apply when APPENDED, not when committed
# (hashicorp raft's configurations.latest semantics), so the voter set
# a node computes quorum from always reflects the latest change it has
# seen — and a node crashed mid-change recovers it from its own
# persisted log (or from catch-up replication) instead of restarting
# with a stale out-of-band voter set, which could yield two disjoint
# majorities. Divergence, documented: a truncated uncommitted config
# entry is not rolled back (at most one change is in flight through
# the cluster-level APIs, so the conflict window does not arise).
RAFT_CONFIG = "raft_config"


def _config_cmd(command: Any) -> Optional[dict]:
    if isinstance(command, dict) and command.get("type") == RAFT_CONFIG:
        return command
    return None

HEARTBEAT_TICKS = 2
ELECTION_TICKS_MIN = 10
ELECTION_TICKS_MAX = 20


@dataclasses.dataclass
class LogEntry:
    term: int
    index: int
    command: Any


@dataclasses.dataclass
class Message:
    mtype: str        # request_vote | vote_reply | append | append_reply | install_snapshot
    src: str
    dst: str
    term: int
    payload: dict


class Transport:
    """In-memory message bus with partition faults (reference raft
    inmem_transport.go + test partitioning idioms)."""

    def __init__(self):
        self.nodes: dict[str, "RaftNode"] = {}
        self.queues: dict[str, list[Message]] = {}
        self.cut: set[tuple[str, str]] = set()
        # One lock for the whole cluster's mutation surface: tick/pump
        # from a driver thread and propose from HTTP handler threads
        # interleave in live deployments (agent/boot.py) — entry points
        # take this lock so raft-lite is thread-safe without changing
        # its deterministic single-threaded behavior (RLock: in-process
        # forwarding re-enters propose). Blocking *reads* never touch
        # it; they park on the state store's own condition instead.
        self.lock = threading.RLock()

    def register(self, node: "RaftNode"):
        self.nodes[node.id] = node
        self.queues[node.id] = []

    def send(self, msg: Message):
        if (msg.src, msg.dst) in self.cut or msg.dst not in self.queues:
            return
        self.queues[msg.dst].append(msg)

    def partition(self, a: str, b: str):
        # chaos controls race the pump/propose threads; RLock is cheap
        with self.lock:
            self.cut.add((a, b))
            self.cut.add((b, a))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None):
        with self.lock:
            if a is None:
                self.cut.clear()
            else:
                self.cut.discard((a, b))
                self.cut.discard((b, a))

    def pump(self):
        """Deliver every queued message (messages sent during delivery
        land next pump, keeping rounds deterministic)."""
        with self.lock:
            for node_id in sorted(self.queues):
                batch, self.queues[node_id] = self.queues[node_id], []
                node = self.nodes[node_id]
                for msg in batch:
                    if not node.stopped:
                        node.handle(msg)


class NotLeader(Exception):
    def __init__(self, leader_hint: Optional[str]):
        super().__init__(f"not leader (hint: {leader_hint})")
        self.leader_hint = leader_hint


class RaftNode:
    """One consensus participant. ``apply_fn(index, command)`` receives
    committed entries in order (the FSM boundary, fsm.go:107)."""

    def __init__(self, node_id: str, peer_ids: list[str], transport: Transport,
                 apply_fn: Callable[[int, Any], Any], seed: int = 0,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 restore_fn: Optional[Callable[[dict], None]] = None,
                 snapshot_threshold: int = 1024,
                 store=None, voter: bool = True,
                 voters: Optional[set] = None, sink=None):
        self.id = node_id
        self.peers = [p for p in peer_ids if p != node_id]
        # Voter configuration (reference raft Voter vs Nonvoter
        # suffrage): non-voters replicate the log but neither start
        # elections nor count toward any quorum. Like remove_server,
        # membership/suffrage changes are raft-lite's out-of-band
        # reconfiguration — managed by autopilot, not log entries.
        self.voter = voter
        self.voters: set = set(voters) if voters is not None else set(peer_ids)
        if voter:
            self.voters.add(node_id)
        self.transport = transport
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snapshot_threshold = snapshot_threshold
        # crc32, not hash(): str hashing is salted per process, which
        # would break same-seed-same-trajectory across runs.
        self.rng = random.Random((seed << 32) ^ zlib.crc32(node_id.encode()))

        self.state = FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader_id: Optional[str] = None
        # Log with compaction: entries[0] corresponds to index base+1.
        self.log: list[LogEntry] = []
        self.log_base_index = 0   # index of the last compacted entry
        self.log_base_term = 0
        self.pending_snapshot: Optional[dict] = None
        self.commit_index = 0
        self.last_applied = 0
        self.votes: set[str] = set()
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.apply_errors: list[tuple[int, str]] = []
        # FSM responses by log index — the raftApply future's resolved
        # value (reference rpc.go:377-447: the caller gets the FSM's
        # return, e.g. a CAS verdict). Bounded ring; every replica holds
        # the results of its own recent applies.
        self.apply_results: dict[int, Any] = {}
        self.apply_results_cap = 4096
        # Telemetry (optional): the reference raft library's
        # consul.raft.apply / consul.raft.commitTime /
        # consul.raft.leader.lastContact instrumentation
        # (hashicorp/raft raft.go + api.go metrics). _commit_t0 stamps
        # propose time per index; _follower_contact stamps the last
        # successful AppendEntries reply per follower.
        self.sink = sink
        self._commit_t0: dict[int, float] = {}
        self._follower_contact: dict[str, float] = {}
        self.stopped = False
        # Stats surface for autopilot's StatsFetcher (stats_fetcher.go).
        self.ticks = 0
        self.last_contact_tick = 0
        # Durable storage (server/raft_store.py — the raft-boltdb role,
        # reference bolt_store.go:1-305 at server.go:558-600). When a
        # populated store is handed in, this IS a crash-restart: term,
        # vote, log, and snapshot come back from disk and the FSM is
        # rebuilt from snapshot + committed-log replay once a leader
        # re-establishes the commit index.
        self.store = store
        rec = store.load() if store is not None else None
        if rec is not None:
            self.term = rec["term"]
            self.voted_for = rec["voted_for"]
            if rec.get("suffrage") is not None:
                self.voter = rec["suffrage"]["voter"]
                self.voters = set(rec["suffrage"]["voters"])
            self.log = [LogEntry(**e) for e in rec["entries"]]
            self.log_base_index = rec["base_index"]
            self.log_base_term = rec["base_term"]
            # Re-apply configuration entries from the recovered log:
            # suffrage persisted in the stable store already reflects
            # them (persist happens at apply), but replay covers a
            # crash between log append and the stable write.
            for e in self.log:
                cfg = _config_cmd(e.command)
                if cfg is not None:
                    self._apply_config(cfg)
            self.pending_snapshot = rec["snapshot"]
            if rec["snapshot"] is not None and self.restore_fn is not None:
                self.restore_fn(rec["snapshot"])
            # Commit index is NOT persisted (hashicorp/raft doesn't
            # either): entries beyond the snapshot re-commit via the
            # next leader's AppendEntries commit_index.
            self.commit_index = self.log_base_index
            self.last_applied = self.log_base_index
        elif store is not None:
            store.set_stable(
                self.term, self.voted_for,
                {"voter": self.voter, "voters": sorted(self.voters)},
            )
        self._reset_election_timer()
        transport.register(self)

    def _apply_config(self, cmd: dict):
        """Apply one configuration entry to this node's view of the
        membership (reference raft appendConfigurationEntry →
        configurations.latest). Idempotent; persisted immediately so a
        crash cannot roll suffrage back."""
        op, sid = cmd["op"], cmd["id"]
        if op == "promote":
            self.voters.add(sid)
            if sid == self.id:
                self.voter = True
        elif op == "demote":
            self.voters.discard(sid)
            if sid == self.id:
                self.voter = False
        elif op == "add_nonvoter":
            if sid != self.id and sid not in self.peers:
                self.peers.append(sid)
        elif op == "remove":
            self.voters.discard(sid)
            if sid == self.id:
                if self.state == LEADER:
                    # A leader removing itself stays on just long
                    # enough to commit and answer the entry (hashicorp
                    # raft removes the leader only after the config
                    # entry commits); the halt happens at commit in
                    # _apply_committed.
                    pass
                else:
                    # A removed server halts (Consul shuts it down via
                    # serf leave after RemoveServer).
                    self.stopped = True
            elif sid in self.peers:
                self.peers.remove(sid)
            self.next_index.pop(sid, None)
            self.match_index.pop(sid, None)
        else:
            raise ValueError(f"unknown raft_config op {op!r}")
        self._persist_stable()

    def _persist_stable(self):
        if self.store is not None:
            self.store.set_stable(
                self.term, self.voted_for,
                {"voter": self.voter, "voters": sorted(self.voters)},
            )

    def _persist_append(self, entries: list[LogEntry]):
        if self.store is not None:
            self.store.append([dataclasses.asdict(e) for e in entries])

    def _persist_log_rewrite(self):
        if self.store is not None:
            self.store.rewrite_log(
                [dataclasses.asdict(e) for e in self.log]
            )

    # ------------------------------------------------------------------
    # Log helpers (with compaction offsets)
    # ------------------------------------------------------------------
    def last_log_index(self) -> int:
        return self.log_base_index + len(self.log)

    def last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.log_base_term

    def entry_at(self, index: int) -> Optional[LogEntry]:
        i = index - self.log_base_index - 1
        return self.log[i] if 0 <= i < len(self.log) else None

    def term_at(self, index: int) -> Optional[int]:
        if index == self.log_base_index:
            return self.log_base_term
        e = self.entry_at(index)
        return e.term if e else None

    # ------------------------------------------------------------------
    # Timers
    # ------------------------------------------------------------------
    def _reset_election_timer(self):
        self.election_ticks = self.rng.randint(
            ELECTION_TICKS_MIN, ELECTION_TICKS_MAX
        )

    def tick(self):
        if self.stopped:
            return
        with self.transport.lock:
            self._tick_locked()

    def _tick_locked(self):
        self.ticks += 1
        if self.state == LEADER:
            self.heartbeat_ticks = getattr(self, "heartbeat_ticks", 0) - 1
            if self.heartbeat_ticks <= 0:
                self.heartbeat_ticks = HEARTBEAT_TICKS
                self._broadcast_appends()
                if self.sink is not None and self._follower_contact:
                    # Staleness of the slowest follower, in ms
                    # (consul.raft.leader.lastContact).
                    now = time.perf_counter()
                    self.sink.add_sample(
                        "consul.raft.leader.lastContact",
                        max(now - t
                            for t in self._follower_contact.values())
                        * 1000.0)
            return
        if not self.voter:
            return  # non-voters never campaign
        self.election_ticks -= 1
        if self.election_ticks <= 0:
            self._start_election()

    # ------------------------------------------------------------------
    # Election (raft §5.2)
    # ------------------------------------------------------------------
    def _start_election(self):
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._persist_stable()
        self.votes = {self.id}
        self.leader_id = None
        self._reset_election_timer()
        for p in self.peers:
            self.transport.send(Message(
                "request_vote", self.id, p, self.term,
                {"last_log_index": self.last_log_index(),
                 "last_log_term": self.last_log_term()},
            ))
        self._maybe_win()

    def _maybe_win(self):
        votes = len(self.votes & self.voters)
        if self.state == CANDIDATE and votes * 2 > len(self.voters):
            self.state = LEADER
            self.leader_id = self.id
            self.heartbeat_ticks = 0
            nxt = self.last_log_index() + 1
            self.next_index = {p: nxt for p in self.peers}
            self.match_index = {p: 0 for p in self.peers}
            # Commit a current-term no-op immediately so quorum-
            # replicated entries from prior terms become committable
            # (raft §5.4.2; hashicorp/raft's LogNoop on election).
            self.log.append(LogEntry(self.term, nxt, {"type": "noop"}))
            self._persist_append(self.log[-1:])
            self._broadcast_appends()
            # A single-node cluster is its own quorum (dev mode,
            # reference raftInmem server.go:177) — commit immediately.
            self._advance_commit()

    # ------------------------------------------------------------------
    # Replication (raft §5.3)
    # ------------------------------------------------------------------
    def propose(self, command: Any) -> int:
        """Leader-only append; returns the entry's log index. Commit is
        observed via apply_fn once a quorum replicates (raftApply
        semantics, reference agent/consul/rpc.go:377)."""
        with self.transport.lock:
            if self.state != LEADER:
                raise NotLeader(self.leader_id)
            entry = LogEntry(self.term, self.last_log_index() + 1, command)
            self.log.append(entry)
            if self.sink is not None:
                self.sink.incr_counter("consul.raft.apply")
                self._commit_t0[entry.index] = time.perf_counter()
                if len(self._commit_t0) > 4096:  # uncommittable leftovers
                    self._commit_t0.pop(next(iter(self._commit_t0)))
            self._persist_append([entry])
            self._broadcast_appends()
            # Configuration entries take effect at append (after the
            # broadcast, so a leader proposing its own removal still
            # ships the entry before halting).
            cfg = _config_cmd(command)
            if cfg is not None:
                self._apply_config(cfg)
            self._advance_commit()  # no-op unless we alone are a quorum
            return entry.index

    def _broadcast_appends(self):
        for p in self.peers:
            self._send_append(p)

    def _send_append(self, peer: str):
        nxt = self.next_index.get(peer, self.last_log_index() + 1)
        if nxt <= self.log_base_index:
            # Peer is behind the compaction horizon: ship the snapshot
            # (InstallSnapshot, raft §7 / reference raft/snapshot.go).
            if self.pending_snapshot is not None:
                self.transport.send(Message(
                    "install_snapshot", self.id, peer, self.term,
                    {"snapshot": self.pending_snapshot,
                     "last_index": self.log_base_index,
                     "last_term": self.log_base_term,
                     # Config entries behind the compaction horizon are
                     # gone from the log; the current membership rides
                     # the snapshot (reference raft snapshots embed the
                     # configuration).
                     "voters": sorted(self.voters),
                     "members": sorted({self.id, *self.peers})},
                ))
            return
        prev_index = nxt - 1
        prev_term = self.term_at(prev_index)
        entries = [dataclasses.asdict(e) for e in
                   self.log[prev_index - self.log_base_index:]]
        self.transport.send(Message(
            "append", self.id, peer, self.term,
            {"prev_index": prev_index, "prev_term": prev_term,
             "entries": entries, "commit_index": self.commit_index},
        ))

    # ------------------------------------------------------------------
    # Message handling
    # ------------------------------------------------------------------
    def handle(self, msg: Message):
        if msg.mtype == "request_vote" and msg.src not in self.voters:
            # A server outside the voter configuration cannot start an
            # election we honor (hashicorp raft ignores RequestVote
            # from non-members) — a removed-but-alive server must not
            # inflate terms or win votes. Reply without a term bump.
            self.transport.send(Message(
                "vote_reply", self.id, msg.src, self.term,
                {"granted": False},
            ))
            return
        if msg.term > self.term:
            self.term = msg.term
            self.state = FOLLOWER
            self.voted_for = None
            self._persist_stable()
            # A deposed leader must not keep claiming itself; the new
            # leader's identity arrives with its first AppendEntries.
            self.leader_id = None
        if msg.mtype == "request_vote":
            self._on_request_vote(msg)
        elif msg.mtype == "vote_reply":
            self._on_vote_reply(msg)
        elif msg.mtype == "append":
            self._on_append(msg)
        elif msg.mtype == "append_reply":
            self._on_append_reply(msg)
        elif msg.mtype == "install_snapshot":
            self._on_install_snapshot(msg)

    def _on_request_vote(self, msg: Message):
        p = msg.payload
        up_to_date = (p["last_log_term"], p["last_log_index"]) >= (
            self.last_log_term(), self.last_log_index()
        )
        grant = (
            msg.term >= self.term
            and self.voted_for in (None, msg.src)
            and up_to_date
        )
        if grant:
            self.voted_for = msg.src
            # The vote must be durable before the grant leaves this
            # node (a re-vote in the same term after restart would let
            # two leaders win); transport defers delivery to the next
            # pump, so persisting here precedes the send.
            self._persist_stable()
            self._reset_election_timer()
        self.transport.send(Message(
            "vote_reply", self.id, msg.src, self.term, {"granted": grant}
        ))

    def _on_vote_reply(self, msg: Message):
        if self.state == CANDIDATE and msg.term == self.term and \
                msg.payload["granted"]:
            self.votes.add(msg.src)
            self._maybe_win()

    def _on_append(self, msg: Message):
        if msg.term < self.term:
            self.transport.send(Message(
                "append_reply", self.id, msg.src, self.term,
                {"success": False, "match_index": 0},
            ))
            return
        self.state = FOLLOWER
        self.leader_id = msg.src
        self.last_contact_tick = self.ticks
        self._reset_election_timer()
        p = msg.payload
        if self.term_at(p["prev_index"]) != p["prev_term"]:
            self.transport.send(Message(
                "append_reply", self.id, msg.src, self.term,
                {"success": False,
                 "match_index": min(p["prev_index"] - 1, self.last_log_index())},
            ))
            return
        # Append, truncating conflicts (log matching property).
        added, truncated = [], False
        for e in p["entries"]:
            entry = LogEntry(**e)
            existing = self.entry_at(entry.index)
            if existing is not None and existing.term != entry.term:
                del self.log[entry.index - self.log_base_index - 1:]
                existing = None
                truncated = True
            if existing is None and entry.index == self.last_log_index() + 1:
                self.log.append(entry)
                added.append(entry)
        if truncated:
            self._persist_log_rewrite()  # conflict suffix must not revive
        elif added:
            self._persist_append(added)
        for e in added:
            cfg = _config_cmd(e.command)
            if cfg is not None:
                self._apply_config(cfg)  # config applies at append
        match = p["prev_index"] + len(p["entries"])
        if p["commit_index"] > self.commit_index:
            self.commit_index = min(p["commit_index"], self.last_log_index())
            self._apply_committed()
        self.transport.send(Message(
            "append_reply", self.id, msg.src, self.term,
            {"success": True, "match_index": match},
        ))

    def _on_append_reply(self, msg: Message):
        if self.state != LEADER or msg.term != self.term:
            return
        p = msg.payload
        if p["success"]:
            self.match_index[msg.src] = max(
                self.match_index.get(msg.src, 0), p["match_index"]
            )
            self.next_index[msg.src] = self.match_index[msg.src] + 1
            if self.sink is not None:
                self._follower_contact[msg.src] = time.perf_counter()
            self._advance_commit()
        else:
            self.next_index[msg.src] = max(1, p["match_index"] + 1)
            self._send_append(msg.src)

    def _advance_commit(self):
        """Commit = the highest index replicated on a quorum, current
        term only (raft §5.4.2 safety rule)."""
        for idx in range(self.last_log_index(), self.commit_index, -1):
            if self.term_at(idx) != self.term:
                break
            replicas = (1 if self.id in self.voters else 0) + sum(
                1 for p in self.peers
                if p in self.voters and self.match_index.get(p, 0) >= idx
            )
            if replicas * 2 > len(self.voters):
                self.commit_index = idx
                self._apply_committed()
                break

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            if self.sink is not None:
                # Propose→commit latency on the proposing leader
                # (consul.raft.commitTime, hashicorp/raft
                # dispatchLogs/processLogs timing).
                t0 = self._commit_t0.pop(self.last_applied, None)
                if t0 is not None:
                    self.sink.measure_since("consul.raft.commitTime", t0)
            entry = self.entry_at(self.last_applied)
            if entry is None or entry.command == {"type": "noop"}:
                continue
            cfg = _config_cmd(entry.command)
            if cfg is not None:
                # Configuration entries applied at append; at commit
                # they only resolve the raftApply future — and complete
                # a leader's deferred self-removal.
                result = {"ok": True, "op": cfg.get("op")}
                if cfg["op"] == "remove" and cfg["id"] == self.id:
                    self.stopped = True
            else:
                try:
                    result = self.apply_fn(entry.index, entry.command)
                except Exception as e:  # noqa: BLE001
                    # A bad committed entry must not kill the raft loop
                    # (every replica would crash identically); record it
                    # and keep applying — endpoint-side validation is
                    # the real gate, this is the backstop.
                    self.apply_errors.append((entry.index, repr(e)))
                    result = {"error": repr(e)}
            self.apply_results[entry.index] = result
            while len(self.apply_results) > self.apply_results_cap:
                self.apply_results.pop(next(iter(self.apply_results)))
        self._maybe_compact()

    # ------------------------------------------------------------------
    # Snapshots / compaction (raft §7)
    # ------------------------------------------------------------------
    def _maybe_compact(self):
        if self.snapshot_fn is None or \
                self.last_applied - self.log_base_index < self.snapshot_threshold:
            return
        self.pending_snapshot = self.snapshot_fn()
        base_term = self.term_at(self.last_applied)
        self.log = self.log[self.last_applied - self.log_base_index:]
        self.log_base_index = self.last_applied
        self.log_base_term = base_term
        if self.store is not None:
            self.store.save_snapshot(
                self.pending_snapshot, self.log_base_index,
                self.log_base_term,
            )
            self._persist_log_rewrite()

    def _on_install_snapshot(self, msg: Message):
        p = msg.payload
        if msg.term < self.term or p["last_index"] <= self.last_applied:
            return
        self.state = FOLLOWER
        self.leader_id = msg.src
        self.last_contact_tick = self.ticks
        self._reset_election_timer()
        if self.restore_fn is not None:
            self.restore_fn(p["snapshot"])
        self.log = []
        self.log_base_index = p["last_index"]
        self.log_base_term = p["last_term"]
        self.commit_index = p["last_index"]
        self.last_applied = p["last_index"]
        self.pending_snapshot = p["snapshot"]
        if "voters" in p:
            self.voters = set(p["voters"])
            self.voter = self.id in self.voters
            self.peers = [m for m in p.get("members", [self.id, *self.peers])
                          if m != self.id]
            self._persist_stable()
        if self.store is not None:
            self.store.save_snapshot(
                p["snapshot"], p["last_index"], p["last_term"]
            )
            self._persist_log_rewrite()
        self.transport.send(Message(
            "append_reply", self.id, msg.src, self.term,
            {"success": True, "match_index": p["last_index"]},
        ))

    # ------------------------------------------------------------------
    def stop(self):
        """Fault injection: crash-stop (the Shutdown() idiom of the
        reference's leader tests)."""
        self.stopped = True

    def restart(self):
        self.stopped = False
        self.state = FOLLOWER
        self._reset_election_timer()


class RaftCluster:
    """Test/driver harness: n nodes, one transport, lock-step rounds
    (the in-process multi-server cluster pattern of reference
    agent/consul/helper_test.go wantRaft/wantPeers)."""

    def __init__(self, n: int, apply_factory: Callable[[str], Callable],
                 seed: int = 0, snapshot_threshold: int = 1024,
                 snapshot_factory=None, restore_factory=None,
                 store_factory=None, sink=None):
        self.transport = Transport()
        ids = [f"srv{i}" for i in range(n)]
        self.nodes = {}
        self._factories = (apply_factory, snapshot_factory, restore_factory,
                           store_factory)
        self._seed = seed
        self._snapshot_threshold = snapshot_threshold
        self._sink = sink
        for node_id in ids:
            self.nodes[node_id] = self._make_node(node_id, ids)

    def _make_node(self, node_id: str, ids: list[str]) -> RaftNode:
        apply_f, snap_f, restore_f, store_f = self._factories
        return RaftNode(
            node_id, ids, self.transport, apply_f(node_id),
            seed=self._seed, snapshot_threshold=self._snapshot_threshold,
            snapshot_fn=snap_f(node_id) if snap_f else None,
            restore_fn=restore_f(node_id) if restore_f else None,
            store=store_f(node_id) if store_f else None,
            sink=self._sink,
        )

    def add_nonvoter(self, node_id: str) -> RaftNode:
        """Join a fresh server as a non-voter (reference raft
        AddNonvoter; Consul servers join staging before autopilot
        promotes them). It replicates from the leader but counts
        toward no quorum until promoted."""
        if node_id in self.nodes:
            raise ValueError(f"{node_id} already a member")
        voters = next(iter(self.nodes.values())).voters
        ids = sorted({node_id, *self.nodes})
        apply_f, snap_f, restore_f, store_f = self._factories
        node = RaftNode(
            node_id, ids, self.transport, apply_f(node_id),
            seed=self._seed, snapshot_threshold=self._snapshot_threshold,
            snapshot_fn=snap_f(node_id) if snap_f else None,
            restore_fn=restore_f(node_id) if restore_f else None,
            store=store_f(node_id) if store_f else None,
            voter=False, voters=set(voters), sink=self._sink,
        )
        self.nodes[node_id] = node
        node._persist_stable()  # records voter=False before any crash
        for other in self.nodes.values():
            if other.id != node_id and node_id not in other.peers:
                other.peers.append(node_id)
        # Record the membership in the log too, so a member crashed
        # right now still learns of the new peer on restart/replay.
        led = self.leader()
        if led is not None:
            led.propose({"type": RAFT_CONFIG, "op": "add_nonvoter",
                         "id": node_id})
        return node

    def promote(self, node_id: str) -> None:
        """Grant suffrage (reference raft AddVoter on promotion,
        autopilot.go:256-320) — a replicated configuration entry: the
        change reaches every member, including ones crashed mid-change,
        through the log rather than out-of-band mutation (the
        split-brain a stale restarted voter set could otherwise
        cause). Synchronous: steps until every running member has
        adopted the new configuration."""
        if node_id not in self.nodes:
            raise ValueError(f"unknown server {node_id!r}")
        led = self.wait_leader()
        idx = led.propose({"type": RAFT_CONFIG, "op": "promote",
                           "id": node_id})
        target = self.nodes[node_id]
        for _ in range(400):
            # Wait for commit + the target's own adoption; a
            # partitioned *other* member catches up later via normal
            # replication — best-effort after the cap, like
            # remove_server, never an exception that would kill an
            # autopilot loop.
            if led.commit_index >= idx and node_id in target.voters:
                return
            self.step()

    def crash(self, node_id: str):
        """Hard-kill: the in-memory RaftNode object is discarded (its
        volatile state is gone for good), pending inbox dropped. Only
        what its DurableRaftStore wrote can come back."""
        node = self.nodes.pop(node_id)
        node.stopped = True
        if node.store is not None:
            node.store.close()
        del self.transport.nodes[node_id]
        del self.transport.queues[node_id]

    def restart_from_disk(self, node_id: str) -> RaftNode:
        """Recover a crashed node purely from its store directory —
        requires a ``store_factory`` (crash-restart of a store-less
        node would be an amnesiac rejoining under an old identity)."""
        if self._factories[3] is None:
            raise ValueError("restart_from_disk requires store_factory")
        ids = sorted({node_id, *self.nodes})
        node = self._make_node(node_id, ids)
        self.nodes[node_id] = node
        return node

    def step(self, rounds: int = 1):
        for _ in range(rounds):
            for node in self.nodes.values():
                node.tick()
            self.transport.pump()

    def leader(self) -> Optional[RaftNode]:
        leaders = [n for n in self.nodes.values()
                   if n.state == LEADER and not n.stopped]
        if not leaders:
            return None
        return max(leaders, key=lambda n: n.term)

    def wait_leader(self, max_rounds: int = 400) -> RaftNode:
        for _ in range(max_rounds):
            led = self.leader()
            if led is not None:
                return led
            self.step()
        raise TimeoutError("no leader elected")

    def wait_converged(self, max_rounds: int = 400) -> RaftNode:
        """Step until every running node knows the same leader."""
        for _ in range(max_rounds):
            led = self.leader()
            if led is not None and all(
                n.leader_id == led.id
                for n in self.nodes.values() if not n.stopped
            ):
                return led
            self.step()
        raise TimeoutError("leadership did not converge")

    def propose_and_commit(self, command: Any, max_rounds: int = 200) -> int:
        led = self.wait_leader()
        idx = led.propose(command)
        for _ in range(max_rounds):
            self.step()
            if led.commit_index >= idx:
                return idx
        raise TimeoutError(f"entry {idx} not committed")


# ----------------------------------------------------------------------
# Lockstep oracle for the device raft tier (models/raft.py).
# ----------------------------------------------------------------------

def _table(x, shape):
    """A draw table (numpy array, list or tensor on any device) as an
    int64 numpy array of ``shape``."""
    import numpy as _np

    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    arr = _np.asarray(x).astype(_np.int64)
    if arr.shape != tuple(shape):
        raise ValueError(f"raft draw table of shape {arr.shape}, "
                         f"expected {tuple(shape)}")
    return arr


class LockstepRaftOracle:
    """Golden replay of ``ops/raft_ops.tick`` as plain-Python scalar
    loops over concrete ints — deliberately NOT the dense tensor
    expressions, so a vectorization bug in the device kernel cannot
    hide in a shared implementation. Shares only the chaos semantics
    (``raft_ops.chaos_masks_reference``); the randomness comes in as the
    very tables the tick consumed: ``timers``, the ``[R, P]`` initial
    election timeouts, and ``draws``, the per-tick ``[R, P]`` timeout
    draws, as a ``[T, R, P]`` array indexed by tick or a callable
    ``draws(t) -> [R, P]`` (numpy arrays, or tensors on any device, as
    ``models/raft.RaftPlane`` takes them). Everything else is the six
    tick sub-phases written the way hashicorp/raft's
    runFollower/runCandidate/runLeader read, one peer at a time.

    The parity contract is exact equality of the FULL state arrays after
    every tick — terms, roles, votes, leader views, timers, logs, commit
    indexes, even the leader-side ``match`` matrix — against the device
    tier's ``RaftState``.
    """

    FIELDS = ("elections_started", "elections_won", "term_changes",
              "commit_advances", "heartbeats_sent",
              "heartbeats_suppressed", "entries_appended",
              "votes_granted")

    FOLLOWER_ROLE = 0
    CANDIDATE_ROLE = 1
    LEADER_ROLE = 2

    def __init__(self, rcfg, timers, draws, events=(), group0: int = 0):
        import numpy as _np

        from consul_tpu_torch.ops import raft_ops as _rops

        self.rcfg = rcfg
        self.draws = draws
        self.events = tuple(events)
        self.group0 = int(group0)
        self._rops = _rops
        r, p, w = rcfg.groups, rcfg.peers, rcfg.window
        self.group_ids = _np.arange(r, dtype=_np.int64) + self.group0
        self.term = _np.zeros((r, p), _np.int64)
        self.role = _np.zeros((r, p), _np.int64)
        self.voted = _np.full((r, p), -1, _np.int64)
        self.leader = _np.full((r, p), -1, _np.int64)
        self.timer = _table(timers, (r, p))
        self.hb = _np.zeros((r, p), _np.int64)
        self.log_term = _np.zeros((r, p, w), _np.int64)
        self.log_client = _np.zeros((r, p, w), bool)
        self.last = _np.zeros((r, p), _np.int64)
        self.commit = _np.zeros((r, p), _np.int64)
        self.match = _np.zeros((r, p, p), _np.int64)
        self.next_seq = [0] * r
        self.cnt = {f: 0 for f in self.FIELDS}

    def bump(self, group: int, k: int = 1) -> int:
        """Mirror RaftPlane.propose's intent bump; returns the 1-based
        client sequence the k-th new proposal will commit as."""
        self.next_seq[group] += int(k)
        return self.next_seq[group]

    def step(self, t: int) -> None:
        table = self.draws(int(t)) if callable(self.draws) \
            else self.draws[int(t)]
        draws = _table(table, (self.rcfg.groups, self.rcfg.peers))
        alive, deliver = self._rops.chaos_masks_reference(
            self.events, int(t), self.role.copy(), self.group_ids)
        for r in range(self.rcfg.groups):
            self._step_group(r, draws[r], alive[r], deliver[r])

    def run(self, ticks) -> None:
        for t in ticks:
            self.step(int(t))

    # -- one group, one tick, scalar style -----------------------------
    def _step_group(self, r, draws, alive, deliver):
        cfg = self.rcfg
        peers, w_cap, quorum = cfg.peers, cfg.window, cfg.quorum
        fol, cand_r, led_r = (self.FOLLOWER_ROLE, self.CANDIDATE_ROLE,
                              self.LEADER_ROLE)
        term, role = self.term[r], self.role[r]
        voted, lead = self.voted[r], self.leader[r]
        timer, hb = self.timer[r], self.hb[r]
        lt, lc = self.log_term[r], self.log_client[r]
        last, com, match = self.last[r], self.commit[r], self.match[r]
        cnt = self.cnt

        # A: timers run for live non-leaders.
        for p in range(peers):
            if alive[p] and role[p] != led_r:
                timer[p] -= 1

        # B: expiry -> candidate.
        for p in range(peers):
            if alive[p] and role[p] != led_r and timer[p] <= 0:
                term[p] += 1
                role[p] = cand_r
                voted[p] = p
                lead[p] = -1
                timer[p] = draws[p]
                cnt["elections_started"] += 1

        # C: one RequestVote round.
        llt = [int(lt[p][last[p] - 1]) if last[p] > 0 else 0
               for p in range(peers)]
        s_term = term.copy()  # senders' post-B terms
        s_last = last.copy()
        req = [[bool(role[j] == cand_r and alive[j] and deliver[i][j]
                     and i != j) for j in range(peers)]
               for i in range(peers)]
        term_rx = term.copy()
        for i in range(peers):
            mx = max((int(s_term[j]) for j in range(peers) if req[i][j]),
                     default=0)
            if alive[i] and mx > term[i]:
                term_rx[i] = mx
                role[i] = fol
                voted[i] = -1
                lead[i] = -1
                cnt["term_changes"] += 1
        grant_to = [-1] * peers
        for i in range(peers):
            for j in range(peers):
                up_to_date = (llt[j] > llt[i]
                              or (llt[j] == llt[i]
                                  and s_last[j] >= s_last[i]))
                if (req[i][j] and alive[i] and s_term[j] == term_rx[i]
                        and up_to_date and voted[i] in (-1, j)):
                    grant_to[i] = j
                    break
            if grant_to[i] >= 0:
                voted[i] = grant_to[i]
                timer[i] = draws[i]
                cnt["votes_granted"] += 1
        term[:] = term_rx
        votes = [1] * peers
        for j in range(peers):
            for i in range(peers):
                if grant_to[i] == j and deliver[j][i]:
                    votes[j] += 1
        for j in range(peers):
            if role[j] == cand_r and alive[j] and votes[j] >= quorum:
                role[j] = led_r
                lead[j] = j
                hb[j] = 0
                cnt["elections_won"] += 1
                if last[j] < w_cap:
                    lt[j][last[j]] = term[j]
                    lc[j][last[j]] = False
                    last[j] += 1
                    cnt["entries_appended"] += 1
                match[j][:] = 0
                match[j][j] = last[j]

        # D: leaders append pending client intents.
        for p in range(peers):
            if role[p] == led_r and alive[p]:
                n_client = sum(1 for w in range(last[p]) if lc[p][w])
                k = min(max(self.next_seq[r] - n_client, 0),
                        w_cap - int(last[p]))
                for _ in range(k):
                    lt[p][last[p]] = term[p]
                    lc[p][last[p]] = True
                    last[p] += 1
                    cnt["entries_appended"] += 1
                match[p][p] = last[p]

        # E: one AppendEntries round, full-window adoption.
        send = [False] * peers
        for p in range(peers):
            if role[p] == led_r and alive[p]:
                hb[p] -= 1
                lag = any(match[p][i] < last[p]
                          for i in range(peers) if i != p)
                send[p] = bool(hb[p] <= 0 or lag)
                if send[p] and hb[p] <= 0:
                    hb[p] = cfg.heartbeat_ticks
                    cnt["heartbeats_sent"] += 1
                if not send[p]:
                    cnt["heartbeats_suppressed"] += 1
        e_term, e_lt = term.copy(), lt.copy()
        e_lc, e_last, e_com = lc.copy(), last.copy(), com.copy()
        src = [-1] * peers
        for i in range(peers):
            best, best_score = -1, -1
            for j in range(peers):
                if (j != i and send[j] and deliver[i][j] and alive[i]
                        and e_term[j] >= e_term[i]):
                    score = int(e_term[j]) * (peers + 1) + (peers - j)
                    if score > best_score:
                        best, best_score = j, score
            src[i] = best
        for i in range(peers):
            j = src[i]
            if j < 0:
                continue
            if e_term[j] > term[i]:
                voted[i] = -1
                cnt["term_changes"] += 1
            term[i] = max(int(term[i]), int(e_term[j]))
            role[i] = fol
            lead[i] = j
            timer[i] = draws[i]
            lt[i][:] = e_lt[j]
            lc[i][:] = e_lc[j]
            last[i] = e_last[j]
            com[i] = max(int(com[i]), min(int(e_com[j]), int(e_last[j])))
        # Ack return leg: the device writes the leader's POST-adoption
        # length (a same-tick deposed leader's row goes stale — harmless,
        # rows are re-zeroed on election — but parity is exact equality).
        for i in range(peers):
            j = src[i]
            if j >= 0 and deliver[j][i]:
                match[j][i] = last[j]

        # F: quorum commit, current-term entries only.
        for p in range(peers):
            if role[p] == led_r and alive[p]:
                best = 0
                for w in range(w_cap):
                    repl = sum(1 for i in range(peers)
                               if match[p][i] >= w + 1)
                    if (repl >= quorum and lt[p][w] == term[p]
                            and w < last[p]):
                        best = w + 1
                if best > com[p]:
                    com[p] = best
                    cnt["commit_advances"] += 1

    # -- comparison views ----------------------------------------------
    def snapshot(self) -> dict:
        import numpy as _np

        return {
            "term": self.term.copy(), "role": self.role.copy(),
            "voted_for": self.voted.copy(), "leader": self.leader.copy(),
            "timer": self.timer.copy(), "hb": self.hb.copy(),
            "log_term": self.log_term.copy(),
            "log_client": self.log_client.copy(),
            "last_index": self.last.copy(), "commit": self.commit.copy(),
            "match": self.match.copy(),
            "next_seq": _np.asarray(self.next_seq, _np.int64),
        }

    def summary(self):
        """(term, leader, commit, committed_clients) per group — the
        device ``raft_ops.summary`` quadruple."""
        r_n, peers = self.term.shape
        terms, leaders, commits, clients = [], [], [], []
        for r in range(r_n):
            terms.append(int(self.term[r].max()))
            best, best_score = -1, -1
            for p in range(peers):
                if self.role[r][p] == self.LEADER_ROLE:
                    score = (int(self.term[r][p]) * (peers + 1)
                             + (peers - p))
                    if score > best_score:
                        best, best_score = p, score
            leaders.append(best)
            commits.append(int(self.commit[r].max()))
            clients.append(max(
                sum(1 for w in range(int(self.commit[r][p]))
                    if self.log_client[r][p][w])
                for p in range(peers)))
        return terms, leaders, commits, clients
