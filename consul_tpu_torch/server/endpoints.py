"""RPC endpoint layer: the msgpack-RPC surface of the reference server.

The port's copy of ``consul_tpu/server/endpoints.py``; it imports nothing of the reference package.

One ``Server`` owns a raft node + FSM + store and exposes the endpoint
objects the reference registers (reference agent/consul/server_oss.go:
4-18, *_endpoint.go): Catalog, Health, KVS, Session, Coordinate, Status,
Txn. Calls go through :meth:`Server.rpc`, which forwards writes to the
leader exactly like the reference's ``forward`` retry loop (reference
agent/consul/rpc.go:231-292) — here an in-process hop through the
server registry (the moral equivalent of the yamux conn pool).

Reads support the blocking contract (``index``/``wait``) via the state
store's watch machinery and the ``near=`` RTT sort (reference
agent/consul/rpc.go:457-539, rtt.go:187-221).

Coordinate.Update follows the reference's write-batching design
(reference agent/consul/coordinate_endpoint.go:42-153): updates stage
in a map keyed node:segment, validated and ACL-free here; a periodic
flush applies at most ``update_max_batches × update_batch_size`` staged
entries per period through raft, discarding the excess with a counter —
the natural TPU shape is the same batch (SURVEY.md §2.5).
"""

from __future__ import annotations

import math
import random
import uuid
from time import monotonic as _monotonic, sleep as _sleep
from typing import Any, Optional

from consul_tpu_torch.server import acl as acl_mod
from consul_tpu_torch.server import fsm as fsm_mod
from consul_tpu_torch.server import rtt
from consul_tpu_torch.server.fsm import FSM
from consul_tpu_torch.server.raft import NotLeader, RaftCluster, RaftNode
from consul_tpu_torch.server.state_store import StateStore
from consul_tpu_torch.utils.telemetry import Sink

# Reference defaults (agent/consul/config.go:519-521).
COORDINATE_UPDATE_PERIOD_S = 5.0
COORDINATE_UPDATE_BATCH_SIZE = 128
COORDINATE_UPDATE_MAX_BATCHES = 5


class NoPathToDatacenter(Exception):
    """No live route to the target DC (reference rpc.go:315
    'No path to datacenter')."""

    def __init__(self, dc: str, why: str = "no live server"):
        super().__init__(f"no path to datacenter {dc!r}: {why}")
        self.dc = dc


class Server:
    """One server: raft participant + FSM + endpoint dispatch."""

    def __init__(self, node_id: str, raft_node: RaftNode, fsm: FSM,
                 registry: dict[str, "Server"],
                 vivaldi_dimensionality: int = 8, dc: str = "dc1",
                 sink: Optional[Sink] = None):
        self.id = node_id
        self.raft = raft_node
        # Telemetry sink shared with the raft node (reference
        # lib/telemetry.go: one go-metrics sink per process); the raft
        # timers (consul.raft.*) and the leader loop's reconcile timer
        # (consul.leader.reconcile) land here.
        self.sink = sink if sink is not None else Sink()
        if getattr(raft_node, "sink", None) is None:
            raft_node.sink = self.sink
        self.fsm = fsm
        self.registry = registry
        self.vivaldi_dimensionality = vivaldi_dimensionality
        self.dc = dc
        # Cross-DC plumbing, populated by federate()/join_wan (reference
        # WAN serf membership feeding agent/router/serf_adapter.go).
        self.router = None                  # server/router.Router
        self.wan_registry = None            # "<id>.<dc>" -> Server
        registry[node_id] = self
        # Coordinate staging (coordinate_endpoint.go:42-53).
        self._coord_updates: dict[str, dict] = {}
        # Optional device serving plane (consul_tpu_torch/serving): when
        # attached, ?near= sorting and prepared-query NearestN go
        # through one batched device kernel instead of per-row host
        # math. rtt.py stays the reference path (and the fallback).
        self.serving = None
        # Leader-side session TTL timers (leader.SessionTimers),
        # attached by the runtime pump while this server leads.
        self.session_timers = None
        self.metrics = {"coordinate_updates_discarded": 0,
                        "rpc_forwarded": 0, "rpc_cross_dc": 0}

    @property
    def wan_id(self) -> str:
        """WAN member name, ``<node>.<dc>`` (reference serf WAN naming,
        agent/consul/server_serf.go:33-113)."""
        return f"{self.id}.{self.dc}"

    def join_wan(self, router, wan_registry: dict[str, "Server"]) -> None:
        self.router = router
        self.wan_registry = wan_registry

    @property
    def store(self) -> StateStore:
        return self.fsm.store

    def attach_serving(self, plane) -> None:
        """Route this server's nearness sorting through a device
        serving plane (consul_tpu_torch/serving.ServingPlane)."""
        self.serving = plane

    def _near_sorted(self, near: str, rows: list,
                     node_key: str = "node") -> list:
        """``?near=`` nearness sort: batched device kernel when a
        serving plane is attached (which itself falls back on shapes it
        can't represent), host ``rtt.py`` — the documented reference
        implementation — otherwise. Same contract either way: stable
        order, unknown coordinates last, rows unchanged for an unknown
        source."""
        sets = rtt.coord_sets_from_store(self.store.coordinates())
        if self.serving is not None:
            return self.serving.sort_rows(sets, near, rows,
                                          node_key=node_key)
        return rtt.sort_nodes_by_distance(sets, near, rows,
                                          node_key=node_key)

    def is_leader(self) -> bool:
        return self.raft.state == "leader" and not self.raft.stopped

    # ------------------------------------------------------------------
    # Dispatch + forwarding
    # ------------------------------------------------------------------
    def rpc(self, method: str, dc: Optional[str] = None, **args) -> Any:
        """Invoke ``Endpoint.Method`` (e.g. ``"Catalog.Register"``),
        forwarding writes to the leader when needed. A non-local ``dc``
        routes the call to that datacenter through the WAN router
        (reference rpc.go:315-337 forwardDC) — the reference's everyday
        ``?dc=`` path."""
        if dc and dc != self.dc:
            return self._forward_dc(method, dc, args)
        endpoint, name = method.split(".", 1)
        handler = getattr(self, f"_{endpoint.lower()}_{_snake(name)}", None)
        if handler is None:
            raise AttributeError(f"unknown RPC {method}")
        return handler(**args)

    def _forward_dc(self, method: str, dc: str, args: dict) -> Any:
        """Route to a server of ``dc`` via Router.find_route, rotating
        past down servers (reference rpc.go:315-337: FindRoute +
        NotifyFailedServer on connect failure, retrying the next
        server in the manager's rotation)."""
        if self.router is None or self.wan_registry is None:
            raise NoPathToDatacenter(dc, "not WAN-joined")
        managers = self.router.get_datacenter_maps()
        for _ in range(max(1, len(managers.get(dc, ())))):
            sid = self.router.find_route(dc)
            if sid is None:
                break
            target = self.wan_registry.get(sid)
            if target is None or target.raft.stopped:
                # Connection failure: rotate this server to the end and
                # try the next one (manager.go NotifyFailedServer).
                self.router.fail_server(sid)
                continue
            self.metrics["rpc_cross_dc"] += 1
            return target.rpc(method, **args)
        raise NoPathToDatacenter(dc)

    def global_rpc(self, method: str, **args) -> dict[str, Any]:
        """Fan the call out to every known datacenter, local included
        (reference rpc.go:340-365 globalRPC). Returns dc -> result;
        a DC with no live route reports its error string."""
        out = {self.dc: self.rpc(method, **args)}
        if self.router is None:
            return out
        for dc in self.router.datacenters():
            if dc == self.dc:
                continue
            try:
                out[dc] = self.rpc(method, dc=dc, **args)
            except NoPathToDatacenter as e:
                out[dc] = {"error": str(e)}
        return out

    def _raft_apply(self, command: dict) -> Any:
        """Propose through the leader (forwarding like rpc.go:231-292);
        the caller is responsible for stepping the cluster to commit —
        RaftCluster.propose_and_commit does both in drivers/tests."""
        if self.is_leader():
            return self.raft.propose(command)
        leader = self.raft.leader_id
        # leader == self.id can only mean stale knowledge (we are not
        # the leader per the check above) — never self-forward.
        if leader is None or leader == self.id or leader not in self.registry:
            raise NotLeader(None)
        self.metrics["rpc_forwarded"] += 1
        return self.registry[leader]._raft_apply(command)

    def _blocking(self, tables, min_index, wait_s, fn):
        if min_index:
            idx, val = self.store.blocking_query(
                tables, min_index, fn, timeout_s=wait_s
            )
        else:
            idx, val = max(
                self.store.tables[t].max_index for t in tables
            ) or 1, fn()
        return {"index": idx, "value": val}

    # ------------------------------------------------------------------
    # Status endpoint (reference agent/consul/status_endpoint.go)
    # ------------------------------------------------------------------
    def _serving_apply_index(self) -> int:
        """``Serving.ApplyIndex``: the attached device plane's monotone
        raft-style apply index — the ``X-Consul-Index`` a write-attached
        plane serves blocking queries against (consul_tpu_torch/serving/
        watch.py). 0 when no plane (or no write path) is attached."""
        srv = self.serving
        if srv is None or not getattr(srv, "has_writes",
                                      lambda: False)():
            return 0
        return int(srv.apply_index)

    def _serving_stats(self) -> Optional[dict]:
        """``Serving.Stats``: the attached plane's flat stats dict
        (query/write batch counters, watch fan-out tallies) — None when
        no plane is attached."""
        return None if self.serving is None else self.serving.stats()

    def _status_leader(self) -> Optional[str]:
        return self.raft.leader_id

    def _status_apply_result(self, index: int) -> dict:
        """FSM response for a committed log index (the resolved value of
        the reference's raftApply future, rpc.go:377-447). Returns
        ``{"found": bool, "result": ...}`` — found distinguishes a
        genuine FSM verdict (which may itself be falsy, e.g. a lost
        CAS) from an unavailable one. Checked locally first; a miss
        (e.g. this replica caught up via InstallSnapshot, or the ring
        evicted it) falls through to the leader, which applied the
        entry from its own log."""
        if index in self.raft.apply_results:
            return {"found": True, "result": self.raft.apply_results[index]}
        leader = self.raft.leader_id
        if leader is not None and leader != self.id and leader in self.registry:
            lr = self.registry[leader].raft.apply_results
            if index in lr:
                return {"found": True, "result": lr[index]}
        return {"found": False, "result": None}

    def _status_peers(self) -> list[str]:
        return sorted([self.raft.id, *self.raft.peers])

    def _status_datacenter(self) -> str:
        """This server's datacenter — the WAN-join handshake reads it
        over the wire to learn which DC an address belongs to (the
        reference learns it from serf WAN member tags)."""
        return self.dc

    # ------------------------------------------------------------------
    # Catalog endpoint (reference agent/consul/catalog_endpoint.go)
    # ------------------------------------------------------------------
    def _catalog_register(self, node: str, address: str = "",
                          service: Optional[dict] = None,
                          check: Optional[dict] = None,
                          node_meta: Optional[dict] = None) -> int:
        # Validate before proposing (the reference validates in the
        # endpoint, catalog_endpoint.go Register) — a committed entry
        # that fails to apply would diverge-or-skip on every replica.
        if not node:
            raise ValueError("node name required")
        if check and check.get("status", "critical") not in (
            "passing", "warning", "critical"
        ):
            raise ValueError(f"bad check status {check.get('status')!r}")
        cmd = {"type": fsm_mod.REGISTER, "node": node, "address": address}
        if service:
            cmd["service"] = service
        if check:
            cmd["check"] = check
        if node_meta:
            cmd["node_meta"] = node_meta
        return self._raft_apply(cmd)

    def _catalog_deregister(self, node: str, service_id: Optional[str] = None,
                            check_id: Optional[str] = None) -> int:
        cmd = {"type": fsm_mod.DEREGISTER, "node": node}
        if service_id:
            cmd["service_id"] = service_id
        if check_id:
            cmd["check_id"] = check_id
        return self._raft_apply(cmd)

    def _catalog_list_nodes(self, min_index: int = 0, wait_s: float = 10.0,
                            near: str = "") -> dict:
        out = self._blocking(["nodes"], min_index, wait_s, self.store.nodes)
        if near:
            out["value"] = self._near_sorted(near, out["value"])
        return out

    def _catalog_list_services(self, min_index: int = 0,
                               wait_s: float = 10.0) -> dict:
        return self._blocking(["services"], min_index, wait_s,
                              self.store.services)

    def _catalog_service_nodes(self, service: str, tag: Optional[str] = None,
                               min_index: int = 0, wait_s: float = 10.0,
                               near: str = "") -> dict:
        out = self._blocking(
            ["services", "nodes"], min_index, wait_s,
            lambda: self.store.service_nodes(service, tag),
        )
        if near:
            out["value"] = self._near_sorted(near, out["value"])
        return out

    def _catalog_node_services(self, node: str) -> dict:
        return {"index": self.store.index,
                "value": self.store.node_services(node)}

    def _catalog_list_datacenters(self) -> list[str]:
        """Known datacenters sorted by WAN coordinate distance from
        this one (reference catalog_endpoint.go ListDatacenters via
        router.GetDatacentersByDistance, router.go:395). A non-
        federated server knows only itself."""
        if self.router is None:
            return [self.dc]
        return self.router.get_datacenters_by_distance()

    # ------------------------------------------------------------------
    # Health endpoint (reference agent/consul/health_endpoint.go)
    # ------------------------------------------------------------------
    def _health_service_nodes(self, service: str, passing_only: bool = False,
                              min_index: int = 0, wait_s: float = 10.0,
                              near: str = "") -> dict:
        def fn():
            rows = []
            for svc in self.store.service_nodes(service):
                checks = self.store.checks(node=svc["node"])
                health = self.store.node_health(svc["node"])
                # ?passing drops anything not fully passing, warnings
                # included (reference health_endpoint.go filterNonPassing:
                # check.Status != api.HealthPassing).
                if passing_only and health != "passing":
                    continue
                rows.append({"node": svc["node"], "service": svc,
                             "checks": checks, "aggregate_status": health})
            return rows

        out = self._blocking(["services", "checks", "nodes"],
                             min_index, wait_s, fn)
        if near:
            out["value"] = self._near_sorted(near, out["value"])
        return out

    def _health_node_checks(self, node: str, min_index: int = 0,
                            wait_s: float = 10.0) -> dict:
        return self._blocking(["checks"], min_index, wait_s,
                              lambda: self.store.checks(node=node))

    def _health_checks_in_state(self, state: str, min_index: int = 0,
                                wait_s: float = 10.0) -> dict:
        return self._blocking(["checks"], min_index, wait_s,
                              lambda: self.store.checks(state=state))

    def _health_service_checks(self, service: str, min_index: int = 0,
                               wait_s: float = 10.0) -> dict:
        """Checks for one service (reference /v1/health/checks/:service,
        health_endpoint.go ServiceChecks)."""
        return self._blocking(["checks"], min_index, wait_s,
                              lambda: self.store.checks(service=service))

    # ------------------------------------------------------------------
    # KVS endpoint (reference agent/consul/kvs_endpoint.go)
    # ------------------------------------------------------------------
    def _kvs_apply(self, op: str, key: str, value: bytes = b"",
                   flags: int = 0, cas_index: Optional[int] = None,
                   session: Optional[str] = None) -> Any:
        if op == "lock":
            # Lock-delay rejection (reference kvs_endpoint.go:73-78
            # preApply): an acquire inside the post-invalidation window
            # fails WITHOUT a raft entry — same false verdict a lost
            # lock race produces. The check must run on the LEADER —
            # the delay map is soft state recorded where the destroy
            # applied first; an arbitrary RPC-receiving follower may
            # lag it (the reference also pre-applies after forward()).
            if not self.is_leader():
                leader = self.raft.leader_id
                if leader and leader != self.id and \
                        leader in self.registry:
                    self.metrics["rpc_forwarded"] += 1
                    return self.registry[leader]._kvs_apply(
                        op, key, value, flags, cas_index, session)
            if self.store.kv_lock_delayed(key):
                return False
        return self._raft_apply({
            "type": fsm_mod.KV, "op": op, "key": key, "value": value,
            "flags": flags, "cas_index": cas_index, "session": session,
        })

    def _kvs_get(self, key: str, min_index: int = 0,
                 wait_s: float = 10.0) -> dict:
        return self._blocking(["kv"], min_index, wait_s,
                              lambda: self.store.kv_get(key))

    def _kvs_list(self, prefix: str = "", min_index: int = 0,
                  wait_s: float = 10.0) -> dict:
        return self._blocking(["kv"], min_index, wait_s,
                              lambda: self.store.kv_list(prefix))

    # ------------------------------------------------------------------
    # Session endpoint (reference agent/consul/session_endpoint.go)
    # ------------------------------------------------------------------
    def _session_apply(self, op: str, node: str = "", session_id: str = "",
                       ttl_s: float = 0.0, behavior: str = "release",
                       checks: Optional[list] = None,
                       lock_delay_s: float = 15.0) -> Any:
        if op == "create":
            # Validate before proposing (like the catalog endpoint): a
            # committed entry must not fail on apply. The local store
            # may be marginally stale on a follower; the FSM/raft
            # apply-error backstop covers that residual race.
            if self.store.get_node(node) is None:
                raise KeyError(f"node {node!r} not registered")
            session_id = session_id or str(uuid.uuid4())
            idx = self._raft_apply({
                "type": fsm_mod.SESSION, "op": "create", "id": session_id,
                "node": node, "ttl_s": ttl_s, "behavior": behavior,
                "checks": checks,
                # Reference structs.Session.LockDelay (default 15s,
                # capped at MaxLockDelay=60s at invalidation time).
                "lock_delay_s": float(lock_delay_s),
            })
            # Both the pre-assigned id AND the raft index: callers that
            # answer synchronously (the HTTP tier) must wait for the
            # apply, or an immediate follow-up (renew, acquire) races
            # the commit and reads no-such-session.
            return {"id": session_id, "index": idx}
        return self._raft_apply({"type": fsm_mod.SESSION, "op": "destroy",
                                 "id": session_id})

    def _session_list(self) -> dict:
        return {"index": self.store.index, "value": self.store.session_list()}

    def _session_get(self, session_id: str, min_index: int = 0,
                     wait_s: float = 10.0) -> dict:
        """Blocking read of one session (reference session_endpoint.go
        Get → /v1/session/info/:id). value is a LIST — empty for an
        unknown id, like the reference's Sessions slice."""
        def fn():
            s = self.store.session_get(session_id)
            return [] if s is None else [s]
        return self._blocking(("sessions",), min_index, wait_s, fn)

    def _session_node_sessions(self, node: str, min_index: int = 0,
                               wait_s: float = 10.0) -> dict:
        """Sessions held by one node (reference session_endpoint.go
        NodeSessions → /v1/session/node/:node)."""
        def fn():
            return [s for s in self.store.session_list()
                    if s.get("node") == node]
        return self._blocking(("sessions",), min_index, wait_s, fn)

    def _session_renew(self, session_id: str) -> dict:
        """Reset a TTL session's destroy deadline and return the
        session (reference session_endpoint.go Renew →
        resetSessionTimer). The timer itself is leader-side state
        (leader.SessionTimers, attached by the runtime's pump); a
        renew of an unknown session is an error like the reference."""
        s = self.store.session_get(session_id)
        if s is None:
            raise KeyError(f"unknown session {session_id!r}")
        if self.session_timers is not None:
            self.session_timers.renew(session_id)
        elif not self.is_leader():
            # Timers live with the leader; forward so the renew lands
            # where the deadline is tracked (rpc.go:231 forward).
            leader = self.raft.leader_id
            if leader and leader != self.id and leader in self.registry:
                self.metrics["rpc_forwarded"] += 1
                return self.registry[leader]._session_renew(session_id)
        return s

    # ------------------------------------------------------------------
    # Txn endpoint (reference agent/consul/txn_endpoint.go)
    # ------------------------------------------------------------------
    def _txn_apply(self, ops: list[dict]) -> int:
        return self._raft_apply({"type": fsm_mod.TXN, "ops": ops})

    # ------------------------------------------------------------------
    # ConfigEntry endpoint (reference agent/consul/config_endpoint.go:
    # Apply w/ optional CAS, Get, List, Delete — blocking reads over the
    # config_entries table)
    # ------------------------------------------------------------------
    def _configentry_apply(self, kind: str, name: str, entry: dict,
                           cas_index: Optional[int] = None) -> int:
        cmd = {"type": fsm_mod.CONFIG_ENTRY, "kind": kind, "name": name,
               "entry": entry,
               "op": "set" if cas_index is None else "cas"}
        if cas_index is not None:
            cmd["cas_index"] = cas_index
        return self._raft_apply(cmd)

    def _configentry_delete(self, kind: str, name: str,
                            cas_index: Optional[int] = None) -> int:
        cmd = {"type": fsm_mod.CONFIG_ENTRY, "kind": kind, "name": name,
               "op": "delete" if cas_index is None else "delete-cas"}
        if cas_index is not None:
            cmd["cas_index"] = cas_index
        return self._raft_apply(cmd)

    def _configentry_get(self, kind: str, name: str, min_index: int = 0,
                         wait_s: float = 10.0) -> dict:
        return self._blocking(
            ["config_entries"], min_index, wait_s,
            lambda: self.store.config_get_meta(kind, name),
        )

    def _configentry_list(self, kind: str = "*", min_index: int = 0,
                          wait_s: float = 10.0) -> dict:
        return self._blocking(
            ["config_entries"], min_index, wait_s,
            lambda: self.store.config_list_meta(kind),
        )

    # ------------------------------------------------------------------
    # Operator endpoint (reference agent/consul/operator_raft_endpoint.go
    # :1-89 RaftGetConfiguration/RaftRemovePeerByAddress,
    # operator_autopilot_endpoint.go:1-76 get/set autopilot config)
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # ACL endpoint (reference agent/consul/acl_endpoint.go:
    # Bootstrap + Token/Policy CRUD; resolution for enforcement)
    # ------------------------------------------------------------------
    def _acl_bootstrap(self) -> dict:
        """Mint the initial management token exactly once
        (acl_endpoint.go Bootstrap). The one-shot guard is an
        apply-time verdict so a bootstrap race across servers resolves
        to a single winner."""
        if self.store.acl_bootstrapped():
            raise ValueError("ACL system already bootstrapped")
        token = {
            "accessor_id": str(uuid.uuid4()),
            "secret_id": str(uuid.uuid4()),
            "description": "Bootstrap Token (Global Management)",
            "policies": [acl_mod.MANAGEMENT_POLICY],
        }
        idx = self._raft_apply({"type": fsm_mod.ACL, "op": "bootstrap",
                                "token": token})
        return {"token": token, "index": idx}

    def _acl_token_set(self, token: dict) -> dict:
        t = dict(token)
        t.setdefault("accessor_id", str(uuid.uuid4()))
        existing = self.store.acl_token_get(t["accessor_id"])
        if existing is not None:
            # SecretID is immutable on update (reference acl_endpoint.go
            # TokenSet: "cannot change the secret") — a rewrite could
            # collide with another token's secret and make resolution
            # ambiguous.
            t["secret_id"] = existing["secret_id"]
        else:
            t.setdefault("secret_id", str(uuid.uuid4()))
            clash = self.store.acl_token_by_secret(t["secret_id"])
            if clash is not None and \
                    clash["accessor_id"] != t["accessor_id"]:
                raise ValueError("secret id already in use")
        t.setdefault("description", "")
        t.setdefault("policies", [])
        for p in t["policies"]:
            if p != acl_mod.MANAGEMENT_POLICY and \
                    self.store.acl_policy_get(p) is None:
                raise KeyError(f"unknown ACL policy {p!r}")
        idx = self._raft_apply({"type": fsm_mod.ACL, "op": "token-set",
                                "token": t})
        return {"token": t, "index": idx}

    def _acl_token_delete(self, accessor_id: str) -> int:
        if self.store.acl_token_get(accessor_id) is None:
            raise KeyError(f"unknown ACL token {accessor_id!r}")
        return self._raft_apply({"type": fsm_mod.ACL, "op": "token-delete",
                                 "accessor_id": accessor_id})

    def _acl_token_get(self, accessor_id: str, min_index: int = 0,
                       wait_s: float = 10.0) -> dict:
        def fn():
            t = self.store.acl_token_get(accessor_id)
            return [] if t is None else [t]
        return self._blocking(("acl_tokens",), min_index, wait_s, fn)

    def _acl_token_list(self, min_index: int = 0,
                        wait_s: float = 10.0) -> dict:
        # Listings never expose secrets (acl_endpoint.go TokenList
        # redacts unless the caller proves management; the HTTP tier
        # has already gated this on acl:read).
        def fn():
            return [{k: v for k, v in t.items() if k != "secret_id"}
                    for t in self.store.acl_token_list()]
        return self._blocking(("acl_tokens",), min_index, wait_s, fn)

    def _acl_policy_set(self, policy: dict) -> dict:
        p = dict(policy)
        if not p.get("name"):
            raise ValueError("ACL policy needs a name")
        if p["name"] == acl_mod.MANAGEMENT_POLICY:
            raise ValueError(f"{acl_mod.MANAGEMENT_POLICY!r} is builtin")
        acl_mod.parse_rules(p.get("rules"))  # validate before commit
        p.setdefault("id", str(uuid.uuid4()))
        p.setdefault("description", "")
        idx = self._raft_apply({"type": fsm_mod.ACL, "op": "policy-set",
                                "policy": p})
        return {"policy": p, "index": idx}

    def _acl_policy_delete(self, name: str) -> int:
        if self.store.acl_policy_get(name) is None:
            raise KeyError(f"unknown ACL policy {name!r}")
        return self._raft_apply({"type": fsm_mod.ACL, "op": "policy-delete",
                                 "name": name})

    def _acl_policy_get(self, name: str, min_index: int = 0,
                        wait_s: float = 10.0) -> dict:
        def fn():
            p = self.store.acl_policy_get(name)
            return [] if p is None else [p]
        return self._blocking(("acl_policies",), min_index, wait_s, fn)

    def _acl_policy_list(self, min_index: int = 0,
                         wait_s: float = 10.0) -> dict:
        return self._blocking(("acl_policies",), min_index, wait_s,
                              self.store.acl_policy_list)

    def _acl_resolve(self, secret_id: str,
                     default_allow: bool = True) -> dict:
        """Secret → the token's compiled rule inputs (reference
        acl.go ResolveToken): the HTTP tier builds the Authorizer.
        Unknown secrets are anonymous, NOT an error (the reference
        treats them as anonymous when down-policy permits; a hard
        error would turn every stale token into an outage)."""
        t = self.store.acl_token_by_secret(secret_id) if secret_id else None
        if t is None:
            return {"known": False, "management": False, "rules": []}
        management = acl_mod.MANAGEMENT_POLICY in t.get("policies", [])
        docs = []
        for name in t.get("policies", []):
            p = self.store.acl_policy_get(name)
            if p is not None:
                docs.append(acl_mod.parse_rules(p.get("rules")))
        return {"known": True, "management": management, "rules": docs,
                "accessor_id": t["accessor_id"]}

    # ------------------------------------------------------------------
    # ConnectCA endpoint (reference agent/consul/connect_ca_endpoint.go:
    # Roots / ConfigurationGet / ConfigurationSet / Sign)
    # ------------------------------------------------------------------
    def _ca_ensure_initialized(self) -> dict:
        """Active root, lazily minted on first use (the reference
        initializes the CA when a leader establishes; lazy-on-demand
        gives the same replicated outcome). Generation happens HERE,
        the log carries the PEMs; a racing double-init resolves to one
        winner via the FSM's only_if_uninitialized verdict."""
        from consul_tpu_torch.server import connect_ca as ca_mod
        root = self.store.ca_active_root()
        if root is not None:
            return root
        cfg = self.store.ca_config_get() or {}
        cluster_id = cfg.get("cluster_id") or ca_mod.new_cluster_id()
        new_root = ca_mod.generate_root(cluster_id)
        init_idx = self._raft_apply(
            {"type": fsm_mod.CONNECT_CA, "op": "set-root",
             "root": new_root, "only_if_uninitialized": True})
        if self.store.ca_config_get() is None:
            self._raft_apply({"type": fsm_mod.CONNECT_CA,
                              "op": "set-config",
                              "config": {"provider": "consul",
                                         "cluster_id": cluster_id}})
        # The proposal applies when the raft pump commits it; poll for
        # the replicated copy (a racing init may have won with a
        # DIFFERENT root — the store is the truth, and a leaf minted
        # under a losing root would verify against nothing in the
        # bundle). Only when the entry provably never even resolved —
        # no pump stepped at all, i.e. the step-driven test harness,
        # where no concurrent proposer can exist either — fall back to
        # the material we just proposed.
        deadline = _monotonic() + 2.0
        while _monotonic() < deadline:
            root = self.store.ca_active_root()
            if root is not None:
                return root
            res = self._status_apply_result(init_idx)
            if res["found"] and res["result"] is False:
                # Our init lost the race; the winner's root is about
                # to land in the store — keep polling for it.
                pass
            _sleep(0.005)
        res = self._status_apply_result(init_idx)
        if res["found"] and res["result"] is False:
            raise RuntimeError(
                "connect CA init lost a race and the winning root "
                "never became visible")
        return new_root

    @staticmethod
    def _ca_public_root(root: dict) -> dict:
        """A root WITHOUT its private key — what Roots() serves
        (connect_ca_endpoint.go redacts signing material)."""
        return {k: v for k, v in root.items() if k != "private_key"}

    def _connectca_roots(self, min_index: int = 0,
                         wait_s: float = 10.0) -> dict:
        self._ca_ensure_initialized()

        def fn():
            roots = [self._ca_public_root(r)
                     for r in self.store.ca_roots()]
            active = next((r for r in roots if r.get("active")), None)
            return {
                "active_root_id": active["id"] if active else None,
                "trust_domain": active.get("trust_domain")
                if active else None,
                "roots": roots,
            }
        return self._blocking(("connect_ca",), min_index, wait_s, fn)

    def _connectca_configuration_get(self) -> dict:
        self._ca_ensure_initialized()
        return dict(self.store.ca_config_get() or {})

    def _connectca_configuration_set(self, config: dict) -> dict:
        """Apply CA config; supplying root material (or requesting
        rotation) mints/installs a new ACTIVE root, keeping old roots
        in the trust bundle (the reference's rotation, minus the
        cross-signing intermediate window — documented)."""
        from consul_tpu_torch.server import connect_ca as ca_mod
        cfg = dict(config)
        rotate = bool(cfg.pop("rotate", False))
        provided = cfg.pop("root_cert", None)
        provided_key = cfg.pop("private_key", None)
        cfg.setdefault("provider", "consul")
        old = self.store.ca_config_get() or {}
        cfg.setdefault("cluster_id",
                       old.get("cluster_id") or ca_mod.new_cluster_id())
        idx = self._raft_apply({"type": fsm_mod.CONNECT_CA,
                                "op": "set-config", "config": cfg})
        if provided and provided_key:
            td = ca_mod.trust_domain(cfg["cluster_id"])
            root = {"id": ca_mod.root_id(provided),
                    "name": "Provided CA Root Cert",
                    "root_cert": provided, "private_key": provided_key,
                    "trust_domain": td}
            idx = self._raft_apply({"type": fsm_mod.CONNECT_CA,
                                    "op": "set-root", "root": root})
        elif rotate:
            idx = self._raft_apply({"type": fsm_mod.CONNECT_CA,
                                    "op": "set-root",
                                    "root": ca_mod.generate_root(
                                        cfg["cluster_id"])})
        # A bare int return rides _rpc_write's synchronous-raftApply
        # contract: the HTTP 200 waits for the LAST applied entry
        # (the rotation, when one happened), so a rotate-then-read
        # sequence observes the new bundle.
        return idx

    def _connectca_sign(self, service: str,
                        ttl_s: Optional[float] = None) -> dict:
        """Mint a leaf for ``service`` under the active root
        (connect_ca_endpoint.go Sign; the /v1/agent/connect/ca/leaf
        read rides this)."""
        from consul_tpu_torch.server import connect_ca as ca_mod
        root = self._ca_ensure_initialized()
        return ca_mod.sign_leaf(
            root, service, self.dc,
            ttl_s=ttl_s or ca_mod.DEFAULT_LEAF_TTL_S)

    # ------------------------------------------------------------------
    # DiscoveryChain endpoint (reference agent/consul/
    # discoverychain_endpoint.go Get + discoverychain/compile.go)
    # ------------------------------------------------------------------
    def _discoverychain_get(self, service: str, min_index: int = 0,
                            wait_s: float = 10.0) -> dict:
        """Compile the service's router/splitter/resolver config
        entries into the walkable chain — a blocking read over the
        config_entries table, so watchers recompile on entry changes."""
        from consul_tpu_torch.server import discovery_chain as dch

        def fn():
            return dch.compile_chain(self.store.config_get, service,
                                     datacenter=self.dc)
        return self._blocking(("config_entries",), min_index, wait_s, fn)

    # ------------------------------------------------------------------
    # Intention endpoint (reference agent/consul/intention_endpoint.go:
    # Apply/Get/List/Match/Check; structs/intention.go precedence)
    # ------------------------------------------------------------------
    @staticmethod
    def _intention_precedence(source: str, destination: str) -> int:
        """More-specific-first ordering (structs/intention.go
        UpdatePrecedence, names-only form): exact destination beats
        wildcard, then exact source beats wildcard."""
        base = 9 if destination != "*" else 3
        return base if source != "*" else base - 1

    def _intention_apply(self, op: str, intention: Optional[dict] = None,
                         intention_id: Optional[str] = None) -> Any:
        if op == "delete":
            if self.store.intention_get(intention_id) is None:
                raise KeyError(f"unknown intention {intention_id!r}")
            return self._raft_apply({"type": fsm_mod.INTENTION,
                                     "op": "delete", "id": intention_id})
        x = dict(intention or {})
        for field in ("source", "destination"):
            v = x.get(field, "")
            if not v:
                raise ValueError(f"intention {field} must be set")
            if "*" in v and v != "*":
                # Partial wildcards are invalid (Validate:177-196).
                raise ValueError(
                    f"intention {field}: '*' cannot be used with "
                    "partial values")
        if x.get("action") not in ("allow", "deny"):
            raise ValueError("intention action must be allow or deny")
        if op == "create":
            x["id"] = str(uuid.uuid4())
        elif not x.get("id") or self.store.intention_get(x["id"]) is None:
            raise KeyError(f"unknown intention {x.get('id')!r}")
        x.setdefault("description", "")
        x.setdefault("meta", {})
        # Precedence is read-only, recomputed on every write
        # (UpdatePrecedence runs on Apply).
        x["precedence"] = self._intention_precedence(
            x["source"], x["destination"])
        idx = self._raft_apply({"type": fsm_mod.INTENTION, "op": op,
                                "intention": x})
        return {"id": x["id"], "index": idx}

    def _intention_get(self, intention_id: str, min_index: int = 0,
                       wait_s: float = 10.0) -> dict:
        def fn():
            x = self.store.intention_get(intention_id)
            return [] if x is None else [x]
        return self._blocking(("intentions",), min_index, wait_s, fn)

    def _intention_list(self, min_index: int = 0,
                        wait_s: float = 10.0) -> dict:
        return self._blocking(("intentions",), min_index, wait_s,
                              self.store.intention_list)

    def _intention_match(self, by: str, name: str, min_index: int = 0,
                         wait_s: float = 10.0) -> dict:
        """Intentions whose ``by`` side (source|destination) covers
        ``name`` — exact or wildcard — highest precedence first
        (intention_endpoint.go Match / state IntentionMatch)."""
        if by not in ("source", "destination"):
            raise ValueError(f"match by must be source|destination, "
                             f"got {by!r}")

        def fn():
            return [x for x in self.store.intention_list()
                    if x[by] in (name, "*")]
        return self._blocking(("intentions",), min_index, wait_s, fn)

    def _intention_check(self, source: str, destination: str,
                         default_allow: bool = True) -> dict:
        """Would a connection source → destination be authorized?
        (intention_endpoint.go Check): the highest-precedence
        destination match whose source also covers the caller decides;
        no match falls through to ``default_allow`` (the reference
        derives it from the ACL default policy — the HTTP tier passes
        its configured default in)."""
        matches = [x for x in self.store.intention_list()
                   if x["destination"] in (destination, "*")]
        for x in matches:  # already precedence-sorted
            if x["source"] in (source, "*"):
                return {"allowed": x["action"] == "allow",
                        "matched": x["id"]}
        return {"allowed": bool(default_allow), "matched": None}

    # ------------------------------------------------------------------
    # PreparedQuery endpoint (reference agent/consul/
    # prepared_query_endpoint.go: Apply/Get/List/Explain/Execute/
    # ExecuteRemote over the raft-replicated prepared_queries table)
    # ------------------------------------------------------------------
    def _preparedquery_apply(self, op: str, query: Optional[dict] = None,
                             query_id: Optional[str] = None) -> Any:
        from consul_tpu_torch.server import prepared_query as pq_mod

        if op == "delete":
            if self.store.pq_get(query_id) is None:
                raise KeyError(f"unknown prepared query {query_id!r}")
            return self._raft_apply({"type": fsm_mod.PREPARED_QUERY,
                                     "op": "delete", "id": query_id})
        q = pq_mod.normalize(query or {})
        if op == "create":
            q["id"] = str(uuid.uuid4())
        else:
            if not q["id"] or self.store.pq_get(q["id"]) is None:
                raise KeyError(f"unknown prepared query {q['id']!r}")
        if q["session"] and self.store.session_get(q["session"]) is None:
            # Validated before proposing, like the reference endpoint
            # (prepared_query_endpoint.go:67-75 session verification);
            # the query dies with the session afterwards.
            raise KeyError(f"unknown session {q['session']!r}")
        idx = self._raft_apply({"type": fsm_mod.PREPARED_QUERY,
                                "op": op, "query": q})
        return {"id": q["id"], "index": idx}

    def _preparedquery_get(self, query_id: str, min_index: int = 0,
                           wait_s: float = 10.0) -> dict:
        def fn():
            q = self.store.pq_get(query_id)
            return [] if q is None else [q]
        return self._blocking(("prepared_queries",), min_index, wait_s, fn)

    def _preparedquery_list(self, min_index: int = 0,
                            wait_s: float = 10.0) -> dict:
        return self._blocking(("prepared_queries",), min_index, wait_s,
                              self.store.pq_list)

    def _preparedquery_explain(self, query_id_or_name: str) -> dict:
        """The fully-rendered query an execute would run (reference
        Explain — the template-debugging verb)."""
        from consul_tpu_torch.server import prepared_query as pq_mod
        q = pq_mod.resolve(self.store.pq_list(), query_id_or_name)
        if q is None:
            raise KeyError(f"prepared query {query_id_or_name!r} not found")
        return {"query": q, "index": self.store.index}

    def _pq_run_local(self, q: dict) -> dict:
        """Local-DC execution without sort/failover (reference
        prepared_query_endpoint.go:511-558 execute): health rows for
        the service, then the query's health/tag/meta filters."""
        from consul_tpu_torch.server import prepared_query as pq_mod
        svc = q["service"]["service"]
        rows = []
        for s in self.store.service_nodes(svc):
            nd = self.store.get_node(s["node"]) or {}
            rows.append({"node": s["node"], "service": s,
                         "checks": self.store.checks(node=s["node"]),
                         "node_meta": nd.get("meta", {})})
        return {"service": svc, "nodes": pq_mod.filter_nodes(q, rows),
                "datacenter": self.dc, "failovers": 0,
                "dns": q.get("dns", {}), "index": self.store.index}

    def _preparedquery_execute(self, query_id_or_name: str, limit: int = 0,
                               near: str = "") -> dict:
        """Resolve → run → shuffle → RTT sort → limit → DC failover
        (reference Execute, prepared_query_endpoint.go:331-458).
        ``near`` here is already a node name — the ``_agent`` magic
        value is the HTTP tier's to resolve, since only it knows the
        requesting agent."""
        from consul_tpu_torch.server import prepared_query as pq_mod
        q = pq_mod.resolve(self.store.pq_list(), query_id_or_name)
        if q is None:
            raise KeyError(f"prepared query {query_id_or_name!r} not found")
        reply = self._pq_run_local(q)
        nodes = reply["nodes"]
        # Shuffle for load spread (Execute's Nodes.Shuffle) —
        # deterministically seeded so replicas and tests agree.
        random.Random(f"{q['id']}|{self.store.index}").shuffle(nodes)
        near_node = near or q["service"].get("near", "")
        if near_node:
            nodes = pq_mod.nearest_sorted(nodes, near_node,
                                          self._near_sorted)
        if limit and len(nodes) > limit:
            nodes = nodes[:limit]
        reply["nodes"] = nodes
        if not nodes:
            self._pq_failover(q, limit, reply)
        return reply

    def _preparedquery_execute_remote(self, query: dict,
                                      limit: int = 0) -> dict:
        """Run an already-resolved query shipped from another DC
        (reference ExecuteRemote:466-509 — the full definition rides
        the request since this DC's store doesn't hold it; no onward
        failover, fan-out stays one level)."""
        reply = self._pq_run_local(query)
        random.Random(
            f"{query.get('id', '')}|{self.store.index}"
        ).shuffle(reply["nodes"])
        if limit and len(reply["nodes"]) > limit:
            reply["nodes"] = reply["nodes"][:limit]
        return reply

    def _pq_failover(self, q: dict, limit: int, reply: dict) -> None:
        """Try other DCs when the local result is empty (reference
        queryFailover:677-770): the nearest N by WAN RTT, then any
        explicitly listed DCs we know about, in order, stopping at the
        first DC that answers with nodes."""
        fo = q["service"]["failover"]
        nearest_n = fo.get("nearest_n", 0)
        explicit = fo.get("datacenters", [])
        if nearest_n <= 0 and not explicit:
            return
        known = [d for d in self._catalog_list_datacenters()
                 if d != self.dc]
        dcs = list(known[:nearest_n])
        for d in explicit:
            # Unknown DCs are skipped, not errors (queryFailover:713).
            if d in known and d not in dcs:
                dcs.append(d)
        failovers = 0
        for dc in dcs:
            failovers += 1
            try:
                remote = self._forward_dc(
                    "PreparedQuery.ExecuteRemote", dc,
                    {"query": q, "limit": limit})
            except Exception:  # noqa: BLE001 — dead DC: try the next
                continue
            if remote["nodes"]:
                reply["nodes"] = remote["nodes"]
                reply["datacenter"] = remote["datacenter"]
                break
        reply["failovers"] = failovers

    def _operator_raft_get_configuration(self) -> dict:
        """The raft membership as this server's raft layer sees it:
        id/address/leader/voter per server (reference
        operator_raft_endpoint.go:1-50 resolving serf members against
        raft.GetConfiguration)."""
        n = self.raft
        servers = []
        for sid in sorted({n.id, *n.peers}):
            servers.append({
                "id": sid, "node": sid, "address": sid,
                "leader": sid == n.leader_id,
                "voter": sid in n.voters,
            })
        return {"index": n.commit_index, "servers": servers}

    def _operator_raft_remove_peer(self, id: str) -> int:
        """Kick a peer out of the raft configuration (reference
        operator_raft_endpoint.go:52-89 RaftRemovePeerByAddress — the
        stuck-server escape hatch). Rides the replicated configuration
        entry; quorum-guarded like autopilot's cleanup."""
        from consul_tpu_torch.server.autopilot import can_remove_servers
        from consul_tpu_torch.server.raft import RAFT_CONFIG

        n = self.raft
        if id not in {n.id, *n.peers}:
            raise ValueError(f"id {id!r} is not a raft peer")
        if id in n.voters and not can_remove_servers(len(n.voters), 1):
            raise ValueError(
                f"removing {id!r} would leave fewer than a quorum of "
                f"the {len(n.voters)}-voter configuration")
        return self._raft_apply({"type": RAFT_CONFIG, "op": "remove",
                                 "id": id})

    def _operator_autopilot_get_configuration(self) -> dict:
        from consul_tpu_torch.server.autopilot import DEFAULT_AUTOPILOT_CONFIG
        stored = self.store.autopilot_get()
        return dict(DEFAULT_AUTOPILOT_CONFIG, **(stored or {}))

    def _operator_autopilot_set_configuration(
            self, config: dict, cas_index: Optional[int] = None) -> int:
        from consul_tpu_torch.server.autopilot import DEFAULT_AUTOPILOT_CONFIG
        # modify_index is part of what GET returns (the struct's raft
        # index, like the reference Config.ModifyIndex) — accept the
        # round-trip, it is not a settable field.
        config = {k: v for k, v in config.items() if k != "modify_index"}
        unknown = sorted(set(config) - set(DEFAULT_AUTOPILOT_CONFIG))
        if unknown:
            raise ValueError(f"unknown autopilot config keys: {unknown}")
        cmd = {"type": fsm_mod.AUTOPILOT,
               "config": dict(DEFAULT_AUTOPILOT_CONFIG, **config)}
        if cas_index is not None:
            cmd["cas_index"] = cas_index
        return self._raft_apply(cmd)

    def _operator_server_health(self) -> dict:
        """Autopilot's per-server health verdicts plus the cluster
        rollup (reference operator_autopilot_endpoint.go:56-76
        ServerHealth → OperatorHealthReply: healthy/voter/leader per
        server, FailureTolerance = healthy voters beyond quorum).
        Scored from the same stats the autopilot loop fetches
        (autopilot.server_health), taken over this server's raft view
        of the configuration."""
        from consul_tpu_torch.server import autopilot as ap

        leader_id = self.raft.leader_id
        ids = sorted({self.raft.id, *self.raft.peers})
        if leader_id is None or leader_id not in self.registry:
            # No scorable leader (mid-transition, or leader_id points
            # at a peer gone from the registry after remove-peer).
            # This endpoint is the diagnostic an operator reaches for
            # EXACTLY then — report every server unscored rather than
            # erroring the whole request (the reference still answers
            # with per-server rows from its last stats).
            return {
                "healthy": False, "failure_tolerance": 0,
                "servers": [{
                    "id": sid, "name": sid, "healthy": False,
                    "voter": sid in self.raft.voters, "leader": False,
                    "last_contact_ticks": None, "trailing_logs": 0,
                    "reason": "no leader to score health from",
                } for sid in ids],
            }
        leader = self.registry[leader_id].raft
        stats: dict[str, Optional[dict]] = {}
        for sid in ids:
            srv = self.registry.get(sid)
            n = srv.raft if srv is not None else None
            if n is None or n.stopped:
                stats[sid] = None
            else:
                stats[sid] = {
                    "last_index": n.last_log_index(), "term": n.term,
                    "contact_age": n.ticks - n.last_contact_tick,
                    "voter": n.voter, "is_leader": n.state == "leader",
                }
        servers = []
        for sid in ids:
            srv = self.registry.get(sid)
            if srv is None:
                h = ap.ServerHealth(sid, False, False, None, 0,
                                    "unknown server")
            else:
                # stats is pre-fetched, so server_health never touches
                # its cluster argument (the StatsFetcher contract).
                h = ap.server_health(None, srv.raft, leader, stats)
            servers.append({
                "id": h.id, "name": h.id, "healthy": h.healthy,
                "voter": h.voter, "leader": h.id == leader_id,
                "last_contact_ticks": h.last_contact_ticks,
                "trailing_logs": h.trailing_logs, "reason": h.reason,
            })
        n_voters = len(self.raft.voters)
        healthy_voters = sum(1 for s in servers
                             if s["healthy"] and s["voter"])
        quorum = n_voters // 2 + 1
        return {
            "healthy": all(s["healthy"] for s in servers),
            "failure_tolerance": max(0, healthy_voters - quorum),
            "servers": servers,
        }

    # ------------------------------------------------------------------
    # Internal endpoint (reference agent/consul/internal_endpoint.go:
    # 1-100 NodeInfo/NodeDump — the combined node+services+checks view
    # the UI and `consul debug` read)
    # ------------------------------------------------------------------
    def _node_dump_row(self, nd: dict) -> dict:
        name = nd["node"]
        return {"node": name, "address": nd.get("address", ""),
                "meta": nd.get("meta", {}),
                "services": self.store.node_services(name),
                "checks": self.store.checks(node=name)}

    def _internal_node_info(self, node: str, min_index: int = 0,
                            wait_s: float = 10.0) -> dict:
        def fn():
            nd = self.store.get_node(node)
            return [] if nd is None else [self._node_dump_row(nd)]
        return self._blocking(["nodes", "services", "checks"],
                              min_index, wait_s, fn)

    def _internal_node_dump(self, min_index: int = 0,
                            wait_s: float = 10.0) -> dict:
        return self._blocking(
            ["nodes", "services", "checks"], min_index, wait_s,
            lambda: [self._node_dump_row(nd) for nd in
                     sorted(self.store.nodes(), key=lambda d: d["node"])])

    # ------------------------------------------------------------------
    # Coordinate endpoint (reference agent/consul/coordinate_endpoint.go)
    # ------------------------------------------------------------------
    def _coordinate_update(self, node: str, coord: dict,
                           segment: str = "") -> None:
        """Stage one update; validation mirrors coordinate_endpoint.go:
        122-146 (dimensionality + finite components)."""
        vec = coord.get("vec", [])
        if len(vec) != self.vivaldi_dimensionality:
            raise ValueError(
                f"coordinate dimensionality {len(vec)} != "
                f"{self.vivaldi_dimensionality}"
            )
        comps = [*vec, coord.get("error", 0.0), coord.get("height", 0.0),
                 coord.get("adjustment", 0.0)]
        if not all(math.isfinite(c) for c in comps):
            raise ValueError("coordinate has non-finite components")
        if not self.is_leader():
            leader = self.raft.leader_id
            if leader and leader != self.id and leader in self.registry:
                self.metrics["rpc_forwarded"] += 1
                return self.registry[leader]._coordinate_update(
                    node, coord, segment
                )
            raise NotLeader(None)
        key = f"{node}:{segment}"
        if key not in self._coord_updates and len(self._coord_updates) >= \
                COORDINATE_UPDATE_BATCH_SIZE * COORDINATE_UPDATE_MAX_BATCHES:
            # Rate limit: discard, like coordinate_endpoint.go:66-71.
            self.metrics["coordinate_updates_discarded"] += 1
            return None
        self._coord_updates[key] = {"node": node, "segment": segment,
                                    "coord": coord}
        return None

    def flush_coordinates(self) -> list[int]:
        """Apply staged updates in raft batches of ``update_batch_size``
        (the 5s background batchUpdate, coordinate_endpoint.go:42-111).
        Called by the driver on its update period."""
        if not self._coord_updates:
            return []
        staged = list(self._coord_updates.values())
        self._coord_updates.clear()
        indexes = []
        for i in range(0, len(staged), COORDINATE_UPDATE_BATCH_SIZE):
            batch = staged[i:i + COORDINATE_UPDATE_BATCH_SIZE]
            indexes.append(self._raft_apply({
                "type": fsm_mod.COORDINATE_BATCH_UPDATE, "updates": batch,
            }))
        return indexes

    def _coordinate_list_nodes(self, min_index: int = 0,
                               wait_s: float = 10.0) -> dict:
        return self._blocking(["coordinates"], min_index, wait_s,
                              self.store.coordinates)

    def _coordinate_node(self, node: str, min_index: int = 0,
                         wait_s: float = 10.0) -> dict:
        def fn():
            return [c for c in self.store.coordinates() if c["node"] == node]
        return self._blocking(["coordinates"], min_index, wait_s, fn)

    def _coordinate_list_datacenters(self) -> list[dict]:
        """WAN coordinates of every datacenter's servers (reference
        coordinate_endpoint.go:159-176 ListDatacenters reading the
        router's area maps). Like Catalog.ListDatacenters, a
        non-federated server still reports its own DC (the WAN serf
        always contains self)."""
        if self.router is None:
            return [{"datacenter": self.dc, "area_id": "wan",
                     "coordinates": []}]
        out = []
        for dc, sids in sorted(self.router.get_datacenter_maps().items()):
            coords = [{"node": sid, "coord": self.router.coords[sid]}
                      for sid in sids if sid in self.router.coords]
            out.append({"datacenter": dc,
                        "area_id": type(self.router).LOCAL_AREA,
                        "coordinates": coords})
        return out


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class ServerCluster:
    """In-process multi-server harness: n Servers over one deterministic
    raft transport (the reference's in-process cluster test idiom,
    agent/consul/helper_test.go + TestAgent)."""

    def __init__(self, n: int = 3, seed: int = 0,
                 snapshot_threshold: int = 4096,
                 vivaldi_dimensionality: int = 8,
                 bootstrap_expect: int = 0,
                 data_dir: str = "", dc: str = "dc1"):
        self.registry: dict[str, Server] = {}
        fsms: dict[str, FSM] = {}

        def apply_factory(node_id):
            fsms[node_id] = FSM(StateStore())
            return fsms[node_id].apply

        # data_dir makes consensus state durable (reference -data-dir,
        # raft-boltdb at server.go:558): each node persists under
        # <data_dir>/raft/<node_id> and a process restart with the same
        # dir resumes term/vote/log/snapshot from disk.
        store_factory = None
        if data_dir:
            import os

            from consul_tpu_torch.server.raft_store import DurableRaftStore
            store_factory = lambda nid: DurableRaftStore(  # noqa: E731
                os.path.join(data_dir, "raft", nid))

        # One shared sink for the whole in-process cluster, so a test
        # or bench can read consul.raft.* / consul.leader.* timers from
        # a single place regardless of which node leads.
        self.sink = Sink()
        self.raft = RaftCluster(
            n, apply_factory, seed=seed,
            snapshot_threshold=snapshot_threshold,
            snapshot_factory=lambda nid: fsms[nid].snapshot,
            restore_factory=lambda nid: fsms[nid].restore,
            store_factory=store_factory,
            sink=self.sink,
        )
        self.dc = dc
        self.servers = [
            Server(nid, self.raft.nodes[nid], fsms[nid], self.registry,
                   vivaldi_dimensionality, dc=dc, sink=self.sink)
            for nid in sorted(self.raft.nodes)
        ]
        # bootstrap-expect (reference server_serf.go:236 maybeBootstrap):
        # with a non-zero expectation, raft stays dormant — no elections,
        # no log — until maybe_bootstrap() has seen that many server
        # members (via serf tags) all agreeing on the expectation.
        self.bootstrap_expect = bootstrap_expect
        self.bootstrapped = bootstrap_expect == 0
        if not self.bootstrapped:
            for node in self.raft.nodes.values():
                node.stopped = True

    def maybe_bootstrap(self, members: list[dict]) -> bool:
        """Feed serf member observations (dicts with ``name`` and a
        ``tags`` map: role/expect, reference server_serf.go:33-113).
        Bootstraps raft once ``bootstrap_expect`` servers are known and
        every one of them advertises the same expectation
        (server_serf.go:236-330 maybeBootstrap; mismatched expect values
        log and wait, they never bootstrap a wrong-size quorum)."""
        if self.bootstrapped:
            return True
        servers = [m for m in members
                   if m.get("tags", {}).get("role") == "consul"]
        expects = set()
        for m in servers:
            try:
                expects.add(int(m["tags"].get("expect", 0)))
            except (TypeError, ValueError):
                # Malformed gossip tag: skip the member, never crash
                # the serf-event loop (maybeBootstrap logs-and-skips).
                return False
        if len(servers) < self.bootstrap_expect:
            return False
        if expects != {self.bootstrap_expect}:
            return False  # conflicting -bootstrap-expect: refuse
        for node in self.raft.nodes.values():
            node.stopped = False
        self.bootstrapped = True
        return True

    def step(self, rounds: int = 1):
        self.raft.step(rounds)

    def wait_converged(self, max_rounds: int = 400) -> Server:
        """Step until every running node agrees on the same leader (the
        testrpc.WaitForLeader idiom, reference testrpc/wait.go:14-38)."""
        return self.registry[self.raft.wait_converged(max_rounds).id]

    def leader_server(self) -> Server:
        return self.wait_converged()

    def any_follower(self) -> Server:
        led = self.wait_converged()
        return next(s for s in self.servers if s.id != led.id)

    def write(self, server: Server, method: str, **args) -> Any:
        """Issue a write RPC and step raft until it commits AND every
        running replica has applied it (the synchronous raftApply
        contract of rpc.go:377, plus full replication so follower
        reads — which are stale-by-design, like the reference's
        default consistency mode — observe the write in tests)."""
        out = server.rpc(method, **args)
        if isinstance(out, int):
            for _ in range(300):
                self.step()
                if all(n.last_applied >= out
                       for n in self.raft.nodes.values() if not n.stopped):
                    return out
            raise TimeoutError(f"index {out} not fully applied")
        self.step(5)
        return out


def federate(*clusters: "ServerCluster", seed: int = 0):
    """Wire single-DC ServerClusters into one WAN: every server gets a
    Router seeded with every cluster's server list and a shared
    ``wan_id -> Server`` registry — the in-process equivalent of WAN
    serf membership + flood join feeding each server's router
    (reference agent/consul/flood.go:27-66, agent/router/serf_adapter.go;
    the registry plays the yamux connection pool's role).

    Returns the shared WAN registry."""
    from consul_tpu_torch.server.router import Router, flood_join

    dcs = [c.dc for c in clusters]
    if len(set(dcs)) != len(dcs):
        raise ValueError(f"duplicate datacenter names: {dcs}")
    wan_registry: dict[str, Server] = {
        s.wan_id: s for c in clusters for s in c.servers
    }
    for c in clusters:
        for s in c.servers:
            router = Router(local_dc=c.dc, seed=seed)
            for other in clusters:
                flood_join(router, other.dc,
                           [o.wan_id for o in other.servers])
            s.join_wan(router, wan_registry)
    return wan_registry
