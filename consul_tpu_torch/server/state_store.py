"""Indexed state store with watch-based change notification.

The port's copy of ``consul_tpu/server/state_store.py``: host-only, with no torch.

The reference's state store is go-memdb — immutable radix trees with
per-table modify indexes and watch channels that fire on commit,
feeding the blocking-query engine (reference agent/consul/state/,
``blockingQuery`` agent/consul/rpc.go:457-539). The Python equivalent
keeps the same *contract* — every entry carries ``(create_index,
modify_index)``, every read returns the table's max index, and blocked
readers wake exactly when a write commits to a table they watched —
implemented with one lock + per-table ``threading.Condition``.

Tables (reference agent/consul/state/catalog.go, kvs.go, session.go,
coordinate.go:13-48, config_entry.go): nodes, services, checks, kv,
sessions, coordinates, config_entries.

Writes normally arrive through the FSM (raft-applied, see fsm.py);
direct calls are for single-server/dev mode, mirroring how dev agents
run an in-memory raft (reference agent/consul/server.go:177).
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading
import time
from typing import Any, Callable, Iterable, Optional


@dataclasses.dataclass
class Entry:
    value: Any
    create_index: int
    modify_index: int


class Table:
    """One indexed table: key -> Entry + the table's max modify index."""

    def __init__(self, name: str):
        self.name = name
        self.rows: dict[str, Entry] = {}
        self.max_index = 0

    # All mutation goes through the store (which holds the lock,
    # assigns the global index, and notifies the store-wide condition —
    # coarser than memdb's per-radix-node watch channels but the same
    # contract: a watcher re-checks its tables' indexes on wake).


class StateStore:
    """All replicated tables behind one global modify index.

    The reference uses a single raft index across all tables; reads
    return it so ``?index=`` blocking works uniformly
    (reference agent/consul/state/state_store.go).
    """

    TABLES = (
        "nodes",          # node name -> {id, address, meta, ...}
        "services",       # node/service_id -> {service, port, tags, meta}
        "checks",         # node/check_id -> {status, output, service_id}
        "kv",             # key -> {value, flags, session}
        "sessions",       # session id -> {node, ttl, behavior, checks}
        "coordinates",    # node[:segment] -> coordinate dict
        "config_entries",  # kind/name -> entry
        "autopilot",      # "config" -> operator autopilot configuration
        "prepared_queries",  # query id -> definition
        "acl_tokens",     # accessor id -> token (carries secret id)
        "acl_policies",   # policy name -> {id, rules, description}
        "acl_meta",       # "bootstrap" -> one-shot marker
        "intentions",     # intention id -> {source, destination, action}
        "connect_ca",     # "config" + "root:<id>" -> CA material
    )

    def __init__(self):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.index = 0
        self.tables = {name: Table(name) for name in self.TABLES}
        # Lock-delay windows (reference state.lockDelay): key -> wall
        # expiry. Server-local soft state, consulted leader-side at
        # acquire time; never replicated or snapshotted.
        self._lock_delays: dict[str, float] = {}

    @contextlib.contextmanager
    def transaction(self):
        """Hold the store lock across a multi-op batch.

        Every read path acquires the same lock, so a concurrent reader
        (including a blocking query re-run) can never observe a
        half-applied — possibly later rolled-back — batch, and never a
        non-monotonic index: the visibility contract of the reference's
        single-commit memdb transaction (reference
        agent/consul/state/state_store.go Txn.Commit; blocked readers in
        ``blocking_query`` sit in ``Condition.wait``, which releases the
        underlying lock, so holding it here cannot deadlock them).
        """
        with self._lock:
            yield

    # ------------------------------------------------------------------
    # Core commit path
    # ------------------------------------------------------------------
    def _commit(self, table: str, key: str, value: Any, *, delete: bool = False,
                index: Optional[int] = None) -> int:
        """Apply one write under the lock; bump indexes; wake watchers.

        ``index`` lets the FSM impose the raft log index so replicas
        converge on identical indexes (reference fsm.go applies with the
        raft index; state.go maxIndex bookkeeping).
        """
        with self._lock:
            if index is None:
                self.index += 1
                index = self.index
            else:
                self.index = max(self.index, index)
            t = self.tables[table]
            if delete:
                if key in t.rows:
                    del t.rows[key]
                    t.max_index = index
                    self._cond.notify_all()
            else:
                old = t.rows.get(key)
                create = old.create_index if old else index
                t.rows[key] = Entry(value, create, index)
                t.max_index = index
                self._cond.notify_all()
            return index

    def _bump(self, table: str, index: Optional[int] = None) -> int:
        """Record a table-level change with no row mutation (e.g. a
        batch already applied row-by-row under one raft index)."""
        with self._lock:
            if index is None:
                self.index += 1
                index = self.index
            else:
                self.index = max(self.index, index)
            t = self.tables[table]
            t.max_index = max(t.max_index, index)
            self._cond.notify_all()
            return index

    # ------------------------------------------------------------------
    # Blocking reads (the blockingQuery engine, rpc.go:457-539)
    # ------------------------------------------------------------------
    def blocking_query(
        self,
        tables: Iterable[str],
        min_index: int,
        fn: Callable[[], Any],
        timeout_s: float = 10.0,
    ) -> tuple[int, Any]:
        """Run ``fn`` under the lock; if the watched tables' max index is
        still <= min_index, block until a commit touches one of them (or
        the timeout elapses), then re-run — the long-poll contract of
        ``?index=&wait=`` (reference agent/consul/rpc.go:457-539).
        """
        deadline = time.monotonic() + timeout_s
        names = list(tables)
        with self._lock:
            while True:
                idx = max(self.tables[nm].max_index for nm in names)
                if min_index <= 0 or idx > min_index:
                    return max(idx, 1), fn()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return max(idx, 1), fn()
                self._cond.wait(remaining)

    # ------------------------------------------------------------------
    # Catalog (reference agent/consul/state/catalog.go)
    # ------------------------------------------------------------------
    def ensure_node(self, node: str, address: str, meta: Optional[dict] = None,
                    index: Optional[int] = None) -> int:
        return self._commit(
            "nodes", node, {"node": node, "address": address, "meta": meta or {}},
            index=index,
        )

    def delete_node(self, node: str, index: Optional[int] = None) -> int:
        # Cascading deletes mirror state/catalog.go deleteNodeTxn:
        # services, checks, coordinates, and session invalidation.
        with self._lock:
            idx = self._commit("nodes", node, None, delete=True, index=index)
            for svc_key in [k for k in self.tables["services"].rows
                            if k.split("/", 1)[0] == node]:
                self._commit("services", svc_key, None, delete=True, index=idx)
            for chk_key in [k for k in self.tables["checks"].rows
                            if k.split("/", 1)[0] == node]:
                self._commit("checks", chk_key, None, delete=True, index=idx)
            for coord_key in [k for k in self.tables["coordinates"].rows
                              if k.split(":", 1)[0] == node]:
                self._commit("coordinates", coord_key, None, delete=True, index=idx)
            self._invalidate_sessions_for_node(node, idx)
            return idx

    def nodes(self) -> list[dict]:
        with self._lock:
            return [e.value | {"modify_index": e.modify_index}
                    for e in self.tables["nodes"].rows.values()]

    def get_node(self, node: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["nodes"].rows.get(node)
            return None if e is None else e.value | {"modify_index": e.modify_index}

    def ensure_service(self, node: str, service_id: str, service: str,
                       port: int = 0, tags: Optional[list] = None,
                       meta: Optional[dict] = None,
                       index: Optional[int] = None) -> int:
        if self.get_node(node) is None:
            raise KeyError(f"node {node!r} not registered")
        return self._commit(
            "services", f"{node}/{service_id}",
            {"node": node, "id": service_id, "service": service, "port": port,
             "tags": tags or [], "meta": meta or {}},
            index=index,
        )

    def delete_service(self, node: str, service_id: str,
                       index: Optional[int] = None) -> int:
        with self._lock:
            idx = self._commit("services", f"{node}/{service_id}", None,
                               delete=True, index=index)
            for chk_key, e in list(self.tables["checks"].rows.items()):
                if e.value.get("service_id") == service_id and \
                        chk_key.split("/", 1)[0] == node:
                    self._commit("checks", chk_key, None, delete=True, index=idx)
            return idx

    def services(self) -> dict[str, list[str]]:
        """service name -> union of tags (reference catalog /v1/catalog/services)."""
        with self._lock:
            out: dict[str, set] = {}
            for e in self.tables["services"].rows.values():
                out.setdefault(e.value["service"], set()).update(e.value["tags"])
            return {k: sorted(v) for k, v in out.items()}

    def service_nodes(self, service: str, tag: Optional[str] = None) -> list[dict]:
        with self._lock:
            rows = []
            for e in self.tables["services"].rows.values():
                if e.value["service"] != service:
                    continue
                if tag is not None and tag not in e.value["tags"]:
                    continue
                node = self.get_node(e.value["node"]) or {}
                rows.append(e.value | {"address": node.get("address"),
                                       "modify_index": e.modify_index})
            return rows

    def node_services(self, node: str) -> list[dict]:
        with self._lock:
            return [e.value for e in self.tables["services"].rows.values()
                    if e.value["node"] == node]

    # ------------------------------------------------------------------
    # Health checks (reference agent/consul/state/catalog.go checks)
    # ------------------------------------------------------------------
    def ensure_check(self, node: str, check_id: str, status: str,
                     service_id: str = "", output: str = "",
                     index: Optional[int] = None) -> int:
        if status not in ("passing", "warning", "critical"):
            raise ValueError(f"bad check status {status!r}")
        # Resolve the service NAME too: /v1/health/checks/:service
        # filters by name (reference health_endpoint.go ServiceChecks),
        # while registrations carry only the id.
        with self._lock:
            svc = self.tables["services"].rows.get(f"{node}/{service_id}")
            service_name = svc.value["service"] if svc else ""
            return self._commit(
                "checks", f"{node}/{check_id}",
                {"node": node, "check_id": check_id, "status": status,
                 "service_id": service_id, "service_name": service_name,
                 "output": output},
                index=index,
            )

    def delete_check(self, node: str, check_id: str,
                     index: Optional[int] = None) -> int:
        with self._lock:
            idx = self._commit("checks", f"{node}/{check_id}", None,
                               delete=True, index=index)
            self._invalidate_sessions_on_check(node, check_id, idx)
            return idx

    def checks(self, node: Optional[str] = None, service: Optional[str] = None,
               state: Optional[str] = None) -> list[dict]:
        with self._lock:
            out = []
            for e in self.tables["checks"].rows.values():
                v = e.value
                if node is not None and v["node"] != node:
                    continue
                if service is not None and v["service_id"] != service \
                        and v.get("service_name") != service:
                    continue
                if state is not None and state != "any" and v["status"] != state:
                    continue
                out.append(v | {"modify_index": e.modify_index})
            return out

    def node_health(self, node: str) -> str:
        """Worst check status for the node ('passing' if no checks)."""
        order = {"passing": 0, "warning": 1, "critical": 2}
        worst = "passing"
        for c in self.checks(node=node):
            if order[c["status"]] > order[worst]:
                worst = c["status"]
        return worst

    # ------------------------------------------------------------------
    # KV (reference agent/consul/state/kvs.go)
    # ------------------------------------------------------------------
    def kv_set(self, key: str, value: bytes, flags: int = 0,
               cas_index: Optional[int] = None,
               session: Optional[str] = None,
               index: Optional[int] = None) -> tuple[int, bool]:
        """Set (optionally check-and-set / lock-acquire). Returns
        (index, success) — CAS failure does not bump the index, like the
        reference's SetCAS (state/kvs.go)."""
        with self._lock:
            e = self.tables["kv"].rows.get(key)
            if cas_index is not None:
                cur = e.modify_index if e else 0
                if cur != cas_index:
                    return self.index, False
            if session is not None:
                if session not in self.tables["sessions"].rows:
                    return self.index, False
                if e and e.value.get("session") not in (None, session):
                    return self.index, False  # lock held by someone else
            val = {"value": value, "flags": flags,
                   "session": session if session else
                   (e.value.get("session") if e else None)}
            return self._commit("kv", key, val, index=index), True

    def kv_unlock(self, key: str, session: str,
                  index: Optional[int] = None) -> tuple[int, bool]:
        """Release a lock held by ``session`` (reference KVUnlock verb,
        state/kvs.go kvsUnlockTxn: fails unless that session holds it)."""
        with self._lock:
            e = self.tables["kv"].rows.get(key)
            if session is None or e is None or \
                    e.value.get("session") != session:
                return self.index, False
            return (
                self._commit("kv", key, e.value | {"session": None},
                             index=index),
                True,
            )

    def kv_lock_delayed(self, key: str) -> bool:
        """Is ``key`` inside a post-invalidation lock-delay window?
        (reference state/kvs.go KVSLockDelay). Expired windows are
        dropped on the way through."""
        with self._lock:
            exp = self._lock_delays.get(key)
            if exp is None:
                return False
            if time.time() >= exp:
                del self._lock_delays[key]
                return False
            return True

    def kv_get(self, key: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["kv"].rows.get(key)
            if e is None:
                return None
            return e.value | {"key": key, "create_index": e.create_index,
                              "modify_index": e.modify_index}

    def kv_list(self, prefix: str = "") -> list[dict]:
        with self._lock:
            return [e.value | {"key": k, "modify_index": e.modify_index}
                    for k, e in sorted(self.tables["kv"].rows.items())
                    if k.startswith(prefix)]

    def kv_delete(self, key: str, recurse: bool = False,
                  cas_index: Optional[int] = None,
                  index: Optional[int] = None) -> tuple[int, bool]:
        with self._lock:
            if cas_index is not None:
                e = self.tables["kv"].rows.get(key)
                cur = e.modify_index if e else 0
                if cur != cas_index:
                    return self.index, False
            keys = ([k for k in self.tables["kv"].rows if k.startswith(key)]
                    if recurse else [key])
            idx = self.index
            for k in keys:
                idx = self._commit("kv", k, None, delete=True, index=index)
            return idx, True

    # ------------------------------------------------------------------
    # Sessions (reference agent/consul/state/session.go)
    # ------------------------------------------------------------------
    def session_create(self, session_id: str, node: str, ttl_s: float = 0.0,
                       behavior: str = "release",
                       checks: Optional[list[str]] = None,
                       lock_delay_s: float = 15.0,
                       index: Optional[int] = None) -> int:
        if self.get_node(node) is None:
            raise KeyError(f"node {node!r} not registered")
        return self._commit(
            "sessions", session_id,
            {"id": session_id, "node": node, "ttl_s": ttl_s,
             "behavior": behavior, "checks": checks or [],
             "lock_delay_s": lock_delay_s},
            index=index,
        )

    def session_get(self, session_id: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["sessions"].rows.get(session_id)
            return None if e is None else e.value

    def session_list(self) -> list[dict]:
        with self._lock:
            return [e.value for e in self.tables["sessions"].rows.values()]

    def session_destroy(self, session_id: str,
                        index: Optional[int] = None) -> int:
        """Destroy a session, applying its behavior to held locks
        (release or delete, reference state/session.go invalidation).

        Each released key enters a LOCK-DELAY window (session.go:322-370
        + kvs_endpoint.go:73-78): re-acquisition is refused until
        ``lock_delay_s`` after the invalidation — the reference's
        split-brain guard, so a deposed holder that still thinks it owns
        the lock has time to notice before a new holder acts. Like the
        reference's ``lockDelay`` map this is SERVER-LOCAL soft state
        (wall clock, not raft-replicated, not snapshotted): only the
        leader consults it, at acquire time."""
        with self._lock:
            e = self.tables["sessions"].rows.get(session_id)
            behavior = e.value.get("behavior", "release") if e else "release"
            delay = min(float((e.value.get("lock_delay_s", 15.0)
                               if e else 0.0) or 0.0), 60.0)
            idx = self._commit("sessions", session_id, None, delete=True,
                               index=index)
            now = time.time()
            for k, kv in list(self.tables["kv"].rows.items()):
                if kv.value.get("session") == session_id:
                    if delay > 0:
                        self._lock_delays[k] = now + delay
                    if behavior == "delete":
                        self._commit("kv", k, None, delete=True, index=idx)
                    else:
                        self._commit("kv", k, kv.value | {"session": None},
                                     index=idx)
            self._invalidate_queries_for_session(session_id, idx)
            return idx

    # ------------------------------------------------------------------
    # Prepared queries (reference state/prepared_query.go)
    # ------------------------------------------------------------------
    def pq_set(self, query: dict, index: Optional[int] = None) -> int:
        """Upsert one prepared query by id. Name uniqueness is enforced
        here (reference state/prepared_query.go PreparedQuerySet: the
        wrapped name index) so a replicated create can never land two
        queries on one name."""
        with self._lock:
            name = query.get("name", "")
            if name:
                for qid, e in self.tables["prepared_queries"].rows.items():
                    if qid != query["id"] and e.value.get("name") == name:
                        raise ValueError(
                            f"prepared query name {name!r} already in use")
            return self._commit("prepared_queries", query["id"], query,
                                index=index)

    def pq_delete(self, query_id: str, index: Optional[int] = None) -> int:
        return self._commit("prepared_queries", query_id, None, delete=True,
                            index=index)

    def pq_get(self, query_id: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["prepared_queries"].rows.get(query_id)
            return None if e is None else e.value

    def pq_list(self) -> list[dict]:
        with self._lock:
            return [e.value for _, e in
                    sorted(self.tables["prepared_queries"].rows.items())]

    # ------------------------------------------------------------------
    # ACL tokens + policies (reference state/acl.go)
    # ------------------------------------------------------------------
    def acl_token_set(self, token: dict, index: Optional[int] = None) -> int:
        return self._commit("acl_tokens", token["accessor_id"], token,
                            index=index)

    def acl_token_delete(self, accessor_id: str,
                         index: Optional[int] = None) -> int:
        return self._commit("acl_tokens", accessor_id, None, delete=True,
                            index=index)

    def acl_token_get(self, accessor_id: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["acl_tokens"].rows.get(accessor_id)
            return None if e is None else e.value

    def acl_token_by_secret(self, secret_id: str) -> Optional[dict]:
        """Resolve a presented secret (reference state/acl.go
        ACLTokenGetBySecret — an indexed lookup there; a scan here,
        fine at control-plane token counts)."""
        with self._lock:
            for e in self.tables["acl_tokens"].rows.values():
                if e.value.get("secret_id") == secret_id:
                    return e.value
            return None

    def acl_token_list(self) -> list[dict]:
        with self._lock:
            return [e.value for _, e in
                    sorted(self.tables["acl_tokens"].rows.items())]

    def acl_policy_set(self, policy: dict,
                       index: Optional[int] = None) -> int:
        return self._commit("acl_policies", policy["name"], policy,
                            index=index)

    def acl_policy_delete(self, name: str,
                          index: Optional[int] = None) -> int:
        return self._commit("acl_policies", name, None, delete=True,
                            index=index)

    def acl_policy_get(self, name: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["acl_policies"].rows.get(name)
            return None if e is None else e.value

    def acl_policy_list(self) -> list[dict]:
        with self._lock:
            return [e.value for _, e in
                    sorted(self.tables["acl_policies"].rows.items())]

    def acl_bootstrapped(self) -> bool:
        with self._lock:
            return "bootstrap" in self.tables["acl_meta"].rows

    def acl_mark_bootstrapped(self, index: Optional[int] = None) -> int:
        return self._commit("acl_meta", "bootstrap", {"done": True},
                            index=index)

    # ------------------------------------------------------------------
    # Connect CA (reference state/connect_ca.go)
    # ------------------------------------------------------------------
    def ca_set_root(self, root: dict, activate: bool = True,
                    index: Optional[int] = None) -> int:
        """Store a root; activating it deactivates every other root
        (reference CARootSetCAS keeps old roots inactive for trust-
        bundle continuity)."""
        with self._lock:
            idx = index
            if activate:
                for k, e in list(self.tables["connect_ca"].rows.items()):
                    if k.startswith("root:") and e.value.get("active"):
                        idx = self._commit(
                            "connect_ca", k,
                            e.value | {"active": False}, index=idx)
            return self._commit("connect_ca", f"root:{root['id']}",
                                dict(root, active=activate), index=idx)

    def ca_roots(self) -> list[dict]:
        with self._lock:
            return [e.value for k, e in
                    sorted(self.tables["connect_ca"].rows.items())
                    if k.startswith("root:")]

    def ca_active_root(self) -> Optional[dict]:
        with self._lock:
            for k, e in self.tables["connect_ca"].rows.items():
                if k.startswith("root:") and e.value.get("active"):
                    return e.value
            return None

    def ca_config_set(self, config: dict,
                      index: Optional[int] = None) -> int:
        return self._commit("connect_ca", "config", config, index=index)

    def ca_config_get(self) -> Optional[dict]:
        with self._lock:
            e = self.tables["connect_ca"].rows.get("config")
            return None if e is None else e.value

    # ------------------------------------------------------------------
    # Intentions (reference state/intention.go)
    # ------------------------------------------------------------------
    def intention_set(self, ixn: dict, index: Optional[int] = None) -> int:
        """Upsert by id; the (source, destination) pair is unique
        (reference state/intention.go IntentionSet: the source/
        destination index) — enforced here so replicated creates
        cannot double up."""
        with self._lock:
            for iid, e in self.tables["intentions"].rows.items():
                if iid != ixn["id"] and \
                        e.value["source"] == ixn["source"] and \
                        e.value["destination"] == ixn["destination"]:
                    raise ValueError(
                        f"duplicate intention "
                        f"{ixn['source']!r} -> {ixn['destination']!r}")
            return self._commit("intentions", ixn["id"], ixn, index=index)

    def intention_delete(self, intention_id: str,
                         index: Optional[int] = None) -> int:
        return self._commit("intentions", intention_id, None, delete=True,
                            index=index)

    def intention_get(self, intention_id: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["intentions"].rows.get(intention_id)
            return None if e is None else e.value

    def intention_list(self) -> list[dict]:
        """All intentions, highest precedence first (reference
        structs.Intentions sort order)."""
        with self._lock:
            rows = [e.value for e in self.tables["intentions"].rows.values()]
            return sorted(rows, key=lambda x: (-x["precedence"],
                                               x["destination"], x["source"]))

    def _invalidate_queries_for_session(self, session_id: str, index: int):
        """A query tied to a session dies with it (reference
        state/prepared_query.go: the session invalidation path deletes
        bound queries, mirroring KV lock release)."""
        for qid, e in list(self.tables["prepared_queries"].rows.items()):
            if e.value.get("session") == session_id:
                self._commit("prepared_queries", qid, None, delete=True,
                             index=index)

    def _invalidate_sessions_for_node(self, node: str, index: int):
        for sid, e in list(self.tables["sessions"].rows.items()):
            if e.value["node"] == node:
                self.session_destroy(sid, index=index)

    def _invalidate_sessions_on_check(self, node: str, check_id: str, index: int):
        for sid, e in list(self.tables["sessions"].rows.items()):
            if e.value["node"] == node and check_id in e.value.get("checks", []):
                self.session_destroy(sid, index=index)

    # ------------------------------------------------------------------
    # Coordinates (reference agent/consul/state/coordinate.go:13-172)
    # ------------------------------------------------------------------
    def coordinate_batch_update(self, updates: list[dict],
                                index: Optional[int] = None) -> int:
        """Apply a batch of coordinate updates in one index. Unknown
        nodes are silently skipped, exactly like the reference
        (state/coordinate.go:152-158 — inconsistency with the catalog is
        expected during anti-entropy convergence)."""
        with self._lock:
            applied = False
            idx = index
            for u in updates:
                if u["node"] not in self.tables["nodes"].rows:
                    continue
                key = u["node"] + (":" + u["segment"] if u.get("segment") else "")
                idx = self._commit("coordinates", key,
                                   {"node": u["node"],
                                    "segment": u.get("segment", ""),
                                    "coord": u["coord"]},
                                   index=idx if index is not None else None)
                applied = True
            if not applied:
                # Still consume/record the raft index.
                idx = self._bump("coordinates", index)
            return idx if idx is not None else self.index

    def coordinates(self) -> list[dict]:
        with self._lock:
            return [e.value for _, e in
                    sorted(self.tables["coordinates"].rows.items())]

    def coordinate_for(self, node: str, segment: str = "") -> Optional[dict]:
        with self._lock:
            key = node + (":" + segment if segment else "")
            e = self.tables["coordinates"].rows.get(key)
            return None if e is None else e.value

    # ------------------------------------------------------------------
    # Config entries (reference state/config_entry.go)
    # ------------------------------------------------------------------
    def config_set(self, kind: str, name: str, entry: dict,
                   cas_index: Optional[int] = None,
                   index: Optional[int] = None) -> tuple[int, bool]:
        """Upsert, optionally check-and-set on the entry's modify index
        (reference EnsureConfigEntryCAS, state/config_entry.go; 0 =
        only-if-absent). CAS failure does not bump the index."""
        with self._lock:
            if cas_index is not None:
                e = self.tables["config_entries"].rows.get(f"{kind}/{name}")
                if (e.modify_index if e else 0) != cas_index:
                    return self.index, False
            return self._commit("config_entries", f"{kind}/{name}", entry,
                                index=index), True

    def config_delete(self, kind: str, name: str,
                      cas_index: Optional[int] = None,
                      index: Optional[int] = None) -> tuple[int, bool]:
        with self._lock:
            if cas_index is not None:
                e = self.tables["config_entries"].rows.get(f"{kind}/{name}")
                if (e.modify_index if e else 0) != cas_index:
                    return self.index, False
            return self._commit("config_entries", f"{kind}/{name}", None,
                                delete=True, index=index), True

    def autopilot_set(self, config: dict, cas_index: Optional[int] = None,
                      index: Optional[int] = None) -> tuple[int, bool]:
        """Operator autopilot configuration (reference
        state/autopilot.go AutopilotCASConfig: CAS on the modify
        index, 0 = only-if-absent)."""
        with self._lock:
            if cas_index is not None:
                e = self.tables["autopilot"].rows.get("config")
                if (e.modify_index if e else 0) != cas_index:
                    return self.index, False
            return self._commit("autopilot", "config", config,
                                index=index), True

    def autopilot_get(self) -> Optional[dict]:
        with self._lock:
            e = self.tables["autopilot"].rows.get("config")
            if e is None:
                return None
            return dict(e.value, modify_index=e.modify_index)

    def config_get(self, kind: str, name: str) -> Optional[dict]:
        with self._lock:
            e = self.tables["config_entries"].rows.get(f"{kind}/{name}")
            return None if e is None else e.value

    def config_get_meta(self, kind: str, name: str) -> Optional[dict]:
        """Entry plus its raft indexes — what the ConfigEntry endpoints
        return so clients can CAS (reference structs RaftIndex)."""
        with self._lock:
            e = self.tables["config_entries"].rows.get(f"{kind}/{name}")
            if e is None:
                return None
            return {"kind": kind, "name": name, "entry": e.value,
                    "create_index": e.create_index,
                    "modify_index": e.modify_index}

    def config_list(self, kind: str = "*") -> list[tuple[str, dict]]:
        with self._lock:
            return [(k, e.value) for k, e in
                    sorted(self.tables["config_entries"].rows.items())
                    if fnmatch.fnmatch(k.split("/", 1)[0], kind)]

    def config_list_meta(self, kind: str = "*") -> list[dict]:
        with self._lock:
            return [
                {"kind": k.split("/", 1)[0], "name": k.split("/", 1)[1],
                 "entry": e.value, "create_index": e.create_index,
                 "modify_index": e.modify_index}
                for k, e in
                sorted(self.tables["config_entries"].rows.items())
                if fnmatch.fnmatch(k.split("/", 1)[0], kind)
            ]

    # ------------------------------------------------------------------
    # Snapshot / restore (reference fsm/snapshot*.go persists every
    # table including coordinates)
    # ------------------------------------------------------------------
    def snapshot(self, tables: Optional[Iterable[str]] = None) -> dict:
        """Deep-copy the named tables (all by default). A subset makes a
        cheap undo log for transactions that touch few tables.

        ``table_indexes`` records each table's max_index at snapshot
        time: a deletion leaves no surviving row carrying the index, so
        recomputing from rows on restore would regress the visibility
        index (long-pollers would see X-Consul-Index go backwards)."""
        names = list(tables) if tables is not None else list(self.TABLES)
        with self._lock:
            snap = {
                "index": self.index,
                "table_indexes": {
                    name: self.tables[name].max_index for name in names
                },
                "tables": {
                    name: {k: dataclasses.asdict(e)
                           for k, e in self.tables[name].rows.items()}
                    for name in names
                },
            }
            if "sessions" in names:
                # Session mutations write lock-delay soft state; a TXN
                # undo snapshot must roll those side effects back too
                # (an aborted batch must not leave phantom windows).
                snap["lock_delays"] = dict(self._lock_delays)
            return snap

    def restore(self, snap: dict) -> None:
        """Restore the tables present in the snapshot (others are left
        untouched, supporting partial undo)."""
        with self._lock:
            self.index = snap["index"]
            if "lock_delays" in snap:
                self._lock_delays = dict(snap["lock_delays"])
            recorded = snap.get("table_indexes", {})
            for name, rows in snap["tables"].items():
                t = self.tables[name]
                t.rows = {k: Entry(**e) for k, e in rows.items()}
                t.max_index = recorded.get(name) if name in recorded else max(
                    [e.modify_index for e in t.rows.values()], default=0
                )
            self._cond.notify_all()
