"""The replicated state machine: raft log entries -> state store writes.

The port's copy of ``consul_tpu/server/fsm.py``: host-only, with no torch.

Mirrors the reference FSM (reference agent/consul/fsm/fsm.go:107-152):
entries are typed commands dispatched to a handler per message type,
applied with the raft log index so every replica lands on identical
modify indexes; snapshot/restore round-trips every table including
coordinates (reference fsm/snapshot*.go, commands_oss.go:218-230
``applyCoordinateBatchUpdate``).
"""

from __future__ import annotations

from typing import Any

from consul_tpu_torch.server.state_store import StateStore

# Message types (reference agent/structs/structs.go MessageType values).
REGISTER = "register"
DEREGISTER = "deregister"
KV = "kv"
SESSION = "session"
COORDINATE_BATCH_UPDATE = "coordinate-batch-update"
CONFIG_ENTRY = "config-entry"
AUTOPILOT = "autopilot"
PREPARED_QUERY = "prepared-query"
ACL = "acl"
INTENTION = "intention"
CONNECT_CA = "connect-ca"
TXN = "txn"

# Tables each op type can write (for scoped TXN undo logs). KV ops can
# cascade into sessions? No — but session destroys cascade into kv, and
# node deletes cascade widely; keep cascading types conservative.
_TXN_TABLES: dict[str, set] = {
    KV: {"kv"},
    SESSION: {"sessions", "kv", "prepared_queries"},
    COORDINATE_BATCH_UPDATE: {"coordinates"},
    CONFIG_ENTRY: {"config_entries"},
    PREPARED_QUERY: {"prepared_queries"},
    ACL: {"acl_tokens", "acl_policies", "acl_meta"},
    INTENTION: {"intentions"},
    CONNECT_CA: {"connect_ca"},
    REGISTER: {"nodes", "services", "checks"},
    DEREGISTER: {"nodes", "services", "checks", "coordinates",
                 "sessions", "kv", "prepared_queries"},
}


class FSM:
    def __init__(self, store: StateStore | None = None):
        self.store = store if store is not None else StateStore()

    def apply(self, index: int, command: dict) -> Any:
        """Apply one committed log entry at raft ``index``. Must be
        deterministic: replicas apply the same sequence and converge."""
        mtype = command["type"]
        if mtype == REGISTER:
            # One registration can carry node + service + check, like
            # structs.RegisterRequest (fsm.go applyRegister). A
            # service/check-only registration (no "address" — the txn
            # Service/Check verbs) must not touch the node row: the
            # reference's TxnServiceOp requires the node to exist and
            # leaves it alone; a missing node aborts the (txn) apply.
            r = command
            if "address" in r:
                self.store.ensure_node(r["node"], r["address"],
                                       r.get("node_meta"), index=index)
            elif self.store.get_node(r["node"]) is None:
                raise KeyError(f"node {r['node']!r} not registered")
            if "service" in r:
                s = r["service"]
                self.store.ensure_service(
                    r["node"], s.get("id", s["service"]), s["service"],
                    s.get("port", 0), s.get("tags"), s.get("meta"), index=index,
                )
            if "check" in r:
                c = r["check"]
                self.store.ensure_check(
                    r["node"], c["check_id"], c.get("status", "critical"),
                    c.get("service_id", ""), c.get("output", ""), index=index,
                )
            return index
        if mtype == DEREGISTER:
            r = command
            if "service_id" in r:
                return self.store.delete_service(r["node"], r["service_id"],
                                                 index=index)
            if "check_id" in r:
                return self.store.delete_check(r["node"], r["check_id"],
                                               index=index)
            return self.store.delete_node(r["node"], index=index)
        if mtype == KV:
            op = command["op"]
            if op == "get":
                # Read-inside-txn (reference txn KVGet): the row rides
                # the results list; a missing key fails the batch
                # ("key does not exist", agent/consul/txn_endpoint.go).
                e = self.store.kv_get(command["key"])
                if e is None:
                    raise KeyError(
                        f"key {command['key']!r} does not exist")
                return e
            if op == "unlock":
                _, ok = self.store.kv_unlock(command["key"],
                                             command.get("session"),
                                             index=index)
                return ok
            if op in ("set", "cas", "lock"):
                _, ok = self.store.kv_set(
                    command["key"], command.get("value", b""),
                    command.get("flags", 0),
                    command.get("cas_index") if op == "cas" else None,
                    command.get("session"), index=index,
                )
                return ok
            if op in ("delete", "delete-tree", "delete-cas"):
                _, ok = self.store.kv_delete(
                    command["key"], op == "delete-tree",
                    command.get("cas_index") if op == "delete-cas" else None,
                    index=index,
                )
                return ok
            raise ValueError(f"unknown KV op {op!r}")
        if mtype == SESSION:
            if command["op"] == "create":
                self.store.session_create(
                    command["id"], command["node"], command.get("ttl_s", 0.0),
                    command.get("behavior", "release"), command.get("checks"),
                    lock_delay_s=command.get("lock_delay_s", 15.0),
                    index=index,
                )
                return command["id"]
            self.store.session_destroy(command["id"], index=index)
            return True
        if mtype == COORDINATE_BATCH_UPDATE:
            return self.store.coordinate_batch_update(command["updates"],
                                                      index=index)
        if mtype == CONFIG_ENTRY:
            # Ops mirror reference ConfigEntryRequest (structs/config_
            # entry.go: Upsert/UpsertCAS/Delete[CAS]); CAS evaluates
            # deterministically at apply time and returns the verdict.
            cas = command.get("cas_index")
            if command.get("op") in ("delete", "delete-cas"):
                _, ok = self.store.config_delete(
                    command["kind"], command["name"],
                    cas_index=cas, index=index)
                return ok
            _, ok = self.store.config_set(
                command["kind"], command["name"], command["entry"],
                cas_index=cas, index=index)
            return ok
        if mtype == PREPARED_QUERY:
            # Reference fsm applyPreparedQueryOperation (fsm/commands_
            # oss.go): create/update upsert by id, delete removes.
            # Name-collision on a replicated create is an apply-time
            # verdict (False), like CAS — never a replica divergence.
            if command["op"] == "delete":
                self.store.pq_delete(command["id"], index=index)
                return True
            try:
                self.store.pq_set(command["query"], index=index)
            except ValueError:
                return False
            return command["query"]["id"]
        if mtype == ACL:
            # Reference fsm applyACL* (fsm/commands_oss.go): token and
            # policy upserts/deletes plus the one-shot bootstrap
            # marker. Bootstrap races resolve deterministically at
            # apply time: the second committed bootstrap is a False
            # verdict (acl_endpoint.go Bootstrap "already bootstrapped").
            op = command["op"]
            if op == "token-set":
                self.store.acl_token_set(command["token"], index=index)
                return command["token"]["accessor_id"]
            if op == "token-delete":
                self.store.acl_token_delete(command["accessor_id"],
                                            index=index)
                return True
            if op == "policy-set":
                self.store.acl_policy_set(command["policy"], index=index)
                return command["policy"]["name"]
            if op == "policy-delete":
                self.store.acl_policy_delete(command["name"], index=index)
                return True
            if op == "bootstrap":
                if self.store.acl_bootstrapped():
                    return False
                self.store.acl_mark_bootstrapped(index=index)
                self.store.acl_token_set(command["token"], index=index)
                return True
            raise ValueError(f"unknown ACL op {op!r}")
        if mtype == CONNECT_CA:
            # Reference fsm applyConnectCAOperation: the PEM material
            # is generated ONCE at the endpoint and carried in the log
            # (an FSM must never generate randomness); init is
            # idempotent — a racing second init is a False verdict.
            op = command["op"]
            if op == "set-root":
                if command.get("only_if_uninitialized") and \
                        self.store.ca_active_root() is not None:
                    return False
                self.store.ca_set_root(command["root"],
                                       activate=True, index=index)
                return command["root"]["id"]
            if op == "set-config":
                self.store.ca_config_set(command["config"], index=index)
                return True
            raise ValueError(f"unknown connect-ca op {op!r}")
        if mtype == INTENTION:
            # Reference fsm applyIntentionOperation: upsert/delete by
            # id; a duplicate (source, destination) pair on a
            # replicated create is an apply-time False verdict.
            if command["op"] == "delete":
                self.store.intention_delete(command["id"], index=index)
                return True
            try:
                self.store.intention_set(command["intention"], index=index)
            except ValueError:
                return False
            return command["intention"]["id"]
        if mtype == AUTOPILOT:
            # Operator autopilot configuration (reference
            # fsm applyAutopilotUpdate, operator_autopilot_endpoint.go):
            # CAS evaluated deterministically at apply time.
            _, ok = self.store.autopilot_set(
                command["config"], cas_index=command.get("cas_index"),
                index=index)
            return ok
        if mtype == TXN:
            # All-or-nothing batch (reference agent/consul/txn_endpoint.go)
            # applied inside one store transaction: the store lock is
            # held across verify + apply + (possible) rollback, so a
            # concurrent reader can never observe a partial or
            # later-rolled-back batch — the reference's single-commit
            # memdb Txn visibility.
            with self.store.transaction():
                for op in command["ops"]:
                    if op["type"] == KV and op["op"] in ("cas", "delete-cas"):
                        e = self.store.kv_get(op["key"])
                        cur = e["modify_index"] if e else 0
                        if cur != op.get("cas_index", 0):
                            return {"ok": False, "failed": op["key"]}
                # Undo log covers only the tables this batch can touch —
                # O(touched tables), not O(store) (the reference's memdb
                # txn abort is similarly scoped to written radix nodes).
                touched: set = set()
                for op in command["ops"]:
                    touched |= _TXN_TABLES.get(op["type"], set(StateStore.TABLES))
                undo = self.store.snapshot(tables=touched)
                results = []
                try:
                    for op in command["ops"]:
                        result = self.apply(index, op)
                        # Ops that *return* failure (lock/unlock/CAS
                        # inside the batch) abort the TXN just like ops
                        # that raise.
                        if result is False:
                            self.store.restore(undo)
                            return {"ok": False,
                                    "failed": op.get("key", op["type"])}
                        results.append(result)
                except Exception as e:  # noqa: BLE001
                    self.store.restore(undo)
                    return {"ok": False, "error": repr(e)}
                return {"ok": True, "results": results}
        raise ValueError(f"unknown message type {mtype!r}")

    # Snapshot/restore delegate to the store (fsm.go:134,152).
    def snapshot(self) -> dict:
        return self.store.snapshot()

    def restore(self, snap: dict) -> None:
        self.store.restore(snap)
