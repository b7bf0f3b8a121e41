"""Autopilot: server health scoring and dead-server cleanup.

The port's copy of ``consul_tpu/server/autopilot.py``; it imports nothing of the reference package.

Mirrors the reference autopilot subsystem (reference
agent/consul/autopilot/autopilot.go, structs.go): each server gets a
health verdict from its raft progress (leader contact recency, log
lag, term agreement); unhealthy *failed* servers are removed from the
raft configuration automatically, but only when removal cannot break
quorum (``canRemoveServers`` autopilot.go) — the guard that makes the
cleanup safe.

Membership change here is the simplified single-op reconfiguration of
raft-lite: the cluster driver removes the peer from every node's peer
list and the transport (the reference pipes this through raft
RemoveServer; the safety rule is the same).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from consul_tpu_torch.server.raft import RaftCluster, RaftNode

# Reference defaults (agent/consul/config.go AutopilotConfig /
# autopilot/structs.go): contact threshold 200ms, max trailing logs 250,
# server stabilization time 10s before a non-voter earns suffrage.
LAST_CONTACT_THRESHOLD_TICKS = 10
MAX_TRAILING_LOGS = 250
SERVER_STABILIZATION_TICKS = 30

# The operator-settable subset (reference autopilot/structs.go Config;
# operator_autopilot_endpoint.go get/set). Stored raft-replicated in
# the state store's autopilot table; the Autopilot loop re-reads it
# each pass when wired with config_fn.
DEFAULT_AUTOPILOT_CONFIG = {
    "cleanup_dead_servers": True,
    "last_contact_threshold_ticks": LAST_CONTACT_THRESHOLD_TICKS,
    "max_trailing_logs": MAX_TRAILING_LOGS,
    "server_stabilization_ticks": SERVER_STABILIZATION_TICKS,
}


def fetch_stats(cluster: RaftCluster) -> dict[str, Optional[dict]]:
    """StatsFetcher (reference agent/consul/stats_fetcher.go:1-90): poll
    every server's raft stats ahead of the health evaluation. A stopped
    server doesn't answer (None) — the reference's fetch timeout."""
    out: dict[str, Optional[dict]] = {}
    for nid, node in cluster.nodes.items():
        if node.stopped:
            out[nid] = None
        else:
            out[nid] = {
                "last_index": node.last_log_index(),
                "term": node.term,
                "contact_age": node.ticks - node.last_contact_tick,
                "voter": node.voter,
                "is_leader": node.state == "leader",
            }
    return out


@dataclasses.dataclass
class ServerHealth:
    id: str
    healthy: bool
    voter: bool
    last_contact_ticks: Optional[int]
    trailing_logs: int
    reason: str = ""


def server_health(cluster: RaftCluster, node: RaftNode,
                  leader: RaftNode,
                  stats: Optional[dict] = None,
                  max_trailing: int = MAX_TRAILING_LOGS,
                  contact_threshold: int = LAST_CONTACT_THRESHOLD_TICKS,
                  ) -> ServerHealth:
    """Health verdict for one server from the leader's vantage point,
    scored from *fetched stats* (reference autopilot.go
    updateServerHealth consuming the StatsFetcher's ServerStats:
    last-index lag, term agreement, last leader contact). The
    thresholds are the operator-settable autopilot knobs."""
    st = (stats or fetch_stats(cluster)).get(node.id)
    if st is None:
        return ServerHealth(node.id, False, node.voter, None, 0,
                            "not responding")
    if node.id == leader.id:
        return ServerHealth(node.id, True, True, 0, 0)
    trailing = leader.last_log_index() - st["last_index"]
    if st["term"] != leader.term:
        return ServerHealth(node.id, False, node.voter, None, trailing,
                            f"term {st['term']} != leader term {leader.term}")
    if trailing > max_trailing:
        return ServerHealth(node.id, False, node.voter, None, trailing,
                            f"trailing {trailing} logs")
    if st["contact_age"] > contact_threshold:
        return ServerHealth(node.id, False, node.voter,
                            st["contact_age"], trailing,
                            f"no leader contact for {st['contact_age']} ticks")
    return ServerHealth(node.id, True, node.voter,
                        st["contact_age"], trailing)


def cluster_health(cluster: RaftCluster) -> list[ServerHealth]:
    leader = cluster.leader()
    if leader is None:
        return []
    stats = fetch_stats(cluster)
    return [server_health(cluster, n, leader, stats)
            for n in cluster.nodes.values()]


def can_remove_servers(n_peers: int, n_remove: int) -> bool:
    """Quorum-preservation guard (reference autopilot.go
    canRemoveServers): removal is allowed only while the remaining
    voters still form a majority of the *original* configuration."""
    remaining = n_peers - n_remove
    return remaining >= (n_peers // 2) + 1


def remove_server(cluster: RaftCluster, server_id: str) -> None:
    """Apply the membership change as a replicated configuration entry
    (reference raft RemoveServer appends a LogConfiguration entry):
    every member — including one crashed mid-change, which recovers
    the entry from its persisted log — drops the server from its peer
    list and voter set at append time. The transport-level cleanup
    (queues, node object) stays a cluster-harness concern."""
    from consul_tpu_torch.server.raft import RAFT_CONFIG

    if server_id not in cluster.nodes:
        return
    led = cluster.wait_leader()
    led.propose({"type": RAFT_CONFIG, "op": "remove", "id": server_id})
    for _ in range(400):
        live = [n for n in cluster.nodes.values()
                if not n.stopped and n.id != server_id]
        if all(server_id not in n.voters and server_id not in n.peers
               for n in live):
            break
        cluster.step()
    node = cluster.nodes.pop(server_id, None)
    if node is not None:
        node.stop()
    cluster.transport.nodes.pop(server_id, None)
    cluster.transport.queues.pop(server_id, None)


def clean_dead_servers(cluster: RaftCluster, healths=None) -> list[str]:
    """Remove failed servers, quorum permitting (reference
    autopilot.go pruneDeadServers). Returns removed ids. Pass
    ``healths`` to reuse an evaluation already done this tick."""
    if healths is None:
        healths = cluster_health(cluster)
    elif cluster.leader() is None:
        return []
    dead = [h.id for h in healths
            if not h.healthy and h.reason == "not responding"]
    if not dead or not can_remove_servers(len(cluster.nodes), len(dead)):
        return []
    for sid in dead:
        remove_server(cluster, sid)
    return dead


class Autopilot:
    """The periodic autopilot loop with state: dead-server cleanup plus
    **non-voter promotion after a stabilization window** (reference
    agent/consul/autopilot/autopilot.go:256-320 promoteStableServers:
    a non-voter must be continuously healthy for ServerStabilizationTime
    before it earns suffrage; any unhealthy observation resets its
    clock)."""

    def __init__(self, cluster: RaftCluster,
                 stabilization_ticks: int = SERVER_STABILIZATION_TICKS,
                 cleanup_dead_servers: bool = True,
                 config_fn=None):
        self.cluster = cluster
        self.stabilization_ticks = stabilization_ticks
        self.cleanup_dead_servers = cleanup_dead_servers
        # Live operator configuration (reference autopilot reads the
        # raft-replicated config each pass): a callable returning the
        # current config dict, e.g. a Server's
        # Operator.AutopilotGetConfiguration.
        self.config_fn = config_fn
        self.max_trailing_logs = MAX_TRAILING_LOGS
        self.last_contact_threshold_ticks = LAST_CONTACT_THRESHOLD_TICKS
        self._ticks = 0
        self._healthy_since: dict[str, int] = {}
        self.promoted: list[str] = []
        self.removed: list[str] = []

    def run(self) -> None:
        """One autopilot pass (the leader's periodic serverHealthLoop,
        reference autopilot.go:73-120). Call at the cluster-step cadence."""
        self._ticks += 1
        if self.config_fn is not None:
            cfg = self.config_fn()
            self.stabilization_ticks = int(
                cfg.get("server_stabilization_ticks",
                        self.stabilization_ticks))
            self.cleanup_dead_servers = bool(
                cfg.get("cleanup_dead_servers", self.cleanup_dead_servers))
            self.max_trailing_logs = int(
                cfg.get("max_trailing_logs", self.max_trailing_logs))
            self.last_contact_threshold_ticks = int(
                cfg.get("last_contact_threshold_ticks",
                        self.last_contact_threshold_ticks))
        leader = self.cluster.leader()
        if leader is None:
            return
        stats = fetch_stats(self.cluster)
        healths = {
            h.id: h for h in (
                server_health(
                    self.cluster, n, leader, stats,
                    max_trailing=self.max_trailing_logs,
                    contact_threshold=self.last_contact_threshold_ticks)
                for n in self.cluster.nodes.values()
            )
        }
        # Stabilization bookkeeping for non-voters.
        for nid, h in healths.items():
            if h.voter:
                self._healthy_since.pop(nid, None)
                continue
            if not h.healthy:
                self._healthy_since.pop(nid, None)  # clock resets
                continue
            self._healthy_since.setdefault(nid, self._ticks)
        # Promote every non-voter that has been stable long enough.
        for nid, since in list(self._healthy_since.items()):
            if self._ticks - since >= self.stabilization_ticks:
                self.cluster.promote(nid)
                self.promoted.append(nid)
                del self._healthy_since[nid]
        if self.cleanup_dead_servers:
            self.removed.extend(
                clean_dead_servers(self.cluster, list(healths.values()))
            )
