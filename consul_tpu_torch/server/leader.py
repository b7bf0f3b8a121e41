"""Leader duties: serf↔catalog reconciliation and session TTL expiry.

The port's copy of ``consul_tpu/server/leader.py``; it imports nothing of the reference package.

The reference leader runs a loop (reference agent/consul/leader.go:49,
:143) that, among ACL/CA duties out of scope here, keeps the raft-backed
catalog consistent with gossip-observed membership
(``reconcileMember`` leader.go:1065-1093) and expires session TTLs.

In the TPU framework the "serf members" come from the simulation's
membership views (consul_tpu_torch.models.serf member state), so reconcile is
the bridge from the data plane's eventually-consistent world into the
strongly-consistent catalog — the same boundary the reference draws.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

from consul_tpu_torch.server.endpoints import Server

SERF_HEALTH = "serfHealth"  # reference structs.SerfCheckID


def reconcile_member(server: Server, name: str, address: str, status: str):
    """Reconcile one member observation into the catalog (reference
    leader.go reconcileMember: handleAliveMember / handleFailedMember /
    handleLeftMember-handleReapMember).

    status: "alive" | "failed" | "left" | "reap"
    Returns the raft index of the write, or None when already in sync.
    """
    node = server.store.get_node(name)
    checks = {c["check_id"]: c for c in server.store.checks(node=name)}
    serf_check = checks.get(SERF_HEALTH)

    if status == "alive":
        if node is not None and serf_check is not None and \
                serf_check["status"] == "passing" and \
                node["address"] == address:
            return None
        return server.rpc(
            "Catalog.Register", node=name, address=address,
            check={"check_id": SERF_HEALTH, "status": "passing",
                   "output": "Agent alive and reachable"},
        )
    if status == "failed":
        if node is None:
            return None
        if serf_check is not None and serf_check["status"] == "critical":
            return None
        return server.rpc(
            "Catalog.Register", node=name, address=address or node["address"],
            check={"check_id": SERF_HEALTH, "status": "critical",
                   "output": "Agent not live or unreachable"},
        )
    if status in ("left", "reap"):
        if node is None:
            return None
        return server.rpc("Catalog.Deregister", node=name)
    raise ValueError(f"unknown member status {status!r}")


def reconcile(server: Server, members: Iterable[dict]) -> list[int]:
    """Reconcile a full member list; returns raft indexes of the writes
    issued (the lanEventHandler → reconcileCh → reconcile path,
    reference agent/consul/server_serf.go:131, leader.go:918-…)."""
    if not server.is_leader():
        return []
    t0 = time.perf_counter()
    indexes = []
    seen = set()
    for m in members:
        seen.add(m["name"])
        idx = reconcile_member(server, m["name"], m.get("address", ""),
                               m["status"])
        if idx is not None:
            indexes.append(idx)
    # Catalog nodes that serf has reaped entirely (absent from the
    # member list) but that still linger in the catalog: deregister.
    # Identified by their serfHealth check, so externally-registered
    # nodes (no agent, no serf check) are never touched (reference
    # reconcileReaped leader.go:992-1060).
    for check in server.store.checks():
        if check["check_id"] != SERF_HEALTH:
            continue
        if check["node"] in seen:
            continue
        idx = reconcile_member(server, check["node"], "", "reap")
        if idx is not None:
            indexes.append(idx)
    sink = getattr(server, "sink", None)
    if sink is not None:
        # Reference metrics.MeasureSince([]string{"leader", "reconcile"},
        # ...) around the member sweep (leader.go:918).
        sink.measure_since("consul.leader.reconcile", t0)
    return indexes


class SessionTimers:
    """Leader-side session TTL tracking (reference leader.go
    initializeSessionTimers / resetSessionTimer): sessions with a TTL
    are destroyed ``2 * ttl`` after their last renew (the reference's
    lenient multiplier)."""

    TTL_MULTIPLIER = 2.0  # reference session_ttl.go

    def __init__(self, server: Server, now: Optional[float] = None):
        self.server = server
        self.deadlines: dict[str, float] = {}
        # Renews arrive on HTTP handler threads while the agent pump
        # runs tick() — the deadline map is shared mutable state.
        self._lock = threading.Lock()
        now = time.monotonic() if now is None else now
        for s in server.store.session_list():
            if s.get("ttl_s", 0) > 0:
                self.deadlines[s["id"]] = now + s["ttl_s"] * self.TTL_MULTIPLIER

    def renew(self, session_id: str, now: Optional[float] = None):
        s = self.server.store.session_get(session_id)
        if s is None or s.get("ttl_s", 0) <= 0:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            self.deadlines[session_id] = now + s["ttl_s"] * self.TTL_MULTIPLIER

    def expire(self, now: Optional[float] = None) -> list[str]:
        """Destroy sessions past their deadline; returns their ids."""
        now = time.monotonic() if now is None else now
        expired = []
        with self._lock:
            for sid in [s for s, dl in self.deadlines.items() if dl <= now]:
                # Re-check under the lock: a renew that raced in since
                # the scan keeps the session (its client got a 200).
                if self.deadlines.get(sid, now + 1) <= now:
                    del self.deadlines[sid]
                    expired.append(sid)
        for sid in expired:
            if self.server.store.session_get(sid) is not None:
                self.server.rpc("Session.Apply", op="destroy", session_id=sid)
        return expired

    def tick(self, now: Optional[float] = None) -> list[str]:
        """One leader-loop pass: start tracking TTL sessions created
        since the last pass (the reference arms a timer at session
        apply, session_ttl.go resetSessionTimer — here a scan picks
        them up), then expire. Returns expired ids."""
        now = time.monotonic() if now is None else now
        sessions = self.server.store.session_list()
        live = {s["id"] for s in sessions}
        with self._lock:
            for s in sessions:
                if s.get("ttl_s", 0) > 0 and s["id"] not in self.deadlines:
                    self.deadlines[s["id"]] = \
                        now + s["ttl_s"] * self.TTL_MULTIPLIER
            # Deadlines for sessions destroyed through other paths
            # (explicit destroy, node dereg cascade) retire silently.
            for sid in [x for x in self.deadlines if x not in live]:
                del self.deadlines[sid]
        return self.expire(now)
