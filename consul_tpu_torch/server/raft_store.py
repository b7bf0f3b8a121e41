"""Durable raft storage: term/vote, log, and compaction snapshot on disk.

The port's copy of ``consul_tpu/server/raft_store.py``: host-only, with no torch.

The reference wires a BoltDB-backed LogStore/StableStore into raft
(reference vendor/github.com/hashicorp/raft-boltdb/bolt_store.go:1-305,
mounted at agent/consul/server.go:558-600) so consensus state survives
``kill -9``: on restart a server rejoins the cluster with its term,
vote, snapshot, and log intact. This module is that role for raft-lite
(server/raft.py) — the FSM *content* rides the compaction snapshot,
exactly as the reference splits raft-boltdb (log/stable) from the FSM
snapshot store.

Layout under one directory per node::

    stable.json     {"term": T, "voted_for": ...}      atomic rewrite
    snapshot.json   {"base_index", "base_term", "snapshot", "sha256"}
    log.jsonl       one {"term","index","command"} per line, append-only
                    between truncations/compactions (those rewrite)

Write ordering follows raft's durability rules: the vote/term hit disk
before the reply that promises them leaves the node, and appended
entries hit disk before the follower acks them — both guaranteed here
because persistence happens synchronously inside the handler while the
in-memory transport defers delivery to the next pump.

``fsync=False`` by default: the tests model crash-stop of the process
(state survives in the OS page cache), not power loss. Flip it on for
real deployments where the host itself may die.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Any, Optional


def _to_jsonable(x: Any) -> Any:
    """Commands and FSM snapshots carry ``bytes`` (KV values, serialized
    payloads — the reference's msgpack log encodes them natively,
    rpc.go:377-447); JSON needs a tagged escape. Round-trips exactly
    through :func:`_from_jsonable`."""
    if isinstance(x, bytes):
        return {"__b64__": base64.b64encode(x).decode()}
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    return x


def _from_jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        if set(x) == {"__b64__"}:
            return base64.b64decode(x["__b64__"])
        return {k: _from_jsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_from_jsonable(v) for v in x]
    return x


def _atomic_write(path: str, data: str, fsync: bool) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


class DurableRaftStore:
    """One node's persistent raft state. All mutators keep the on-disk
    files consistent with the in-memory arguments at return time."""

    def __init__(self, directory: str, fsync: bool = False):
        self.dir = directory
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._stable_path = os.path.join(directory, "stable.json")
        self._snap_path = os.path.join(directory, "snapshot.json")
        self._log_path = os.path.join(directory, "log.jsonl")
        self._log_f = None

    # -- recovery ------------------------------------------------------
    def load(self) -> Optional[dict]:
        """Everything persisted, or None for a fresh directory. A torn
        final log line (crash mid-append) is dropped; a digest mismatch
        on the snapshot raises — a corrupt snapshot must not silently
        become an empty FSM (reference bolt_store would likewise fail
        hard on a corrupt db)."""
        if not os.path.exists(self._stable_path):
            return None
        with open(self._stable_path) as f:
            stable = json.load(f)
        suffrage = stable.get("suffrage")  # absent in pre-suffrage files
        base_index, base_term, snapshot = 0, 0, None
        if os.path.exists(self._snap_path):
            with open(self._snap_path) as f:
                snap = json.load(f)
            payload = json.dumps(snap["snapshot"], sort_keys=True)
            digest = hashlib.sha256(payload.encode()).hexdigest()
            if digest != snap["sha256"]:
                raise ValueError(
                    f"raft snapshot digest mismatch in {self._snap_path}"
                )
            base_index = snap["base_index"]
            base_term = snap["base_term"]
            snapshot = _from_jsonable(snap["snapshot"])
        entries = []
        if os.path.exists(self._log_path):
            with open(self._log_path) as f:
                for ln in f:
                    try:
                        entries.append(_from_jsonable(json.loads(ln)))
                    except ValueError:
                        break  # torn tail from a crash mid-append
        # Entries at or below the snapshot horizon are already compacted.
        entries = [e for e in entries if e["index"] > base_index]
        return {
            "term": stable["term"],
            "voted_for": stable.get("voted_for"),
            "suffrage": suffrage,
            "base_index": base_index,
            "base_term": base_term,
            "snapshot": snapshot,
            "entries": entries,
        }

    # -- stable store (term / vote / suffrage) -------------------------
    def set_stable(self, term: int, voted_for: Optional[str],
                   suffrage: Optional[dict] = None) -> None:
        """Suffrage = {"voter": bool, "voters": [...]} — the voter
        configuration must survive a crash (the reference persists it
        as log configuration entries) or a restarted non-voter would
        resurrect with full suffrage, bypassing autopilot's
        stabilization gate."""
        doc = {"term": term, "voted_for": voted_for}
        if suffrage is not None:
            doc["suffrage"] = suffrage
        _atomic_write(self._stable_path, json.dumps(doc), self.fsync)

    # -- log store -----------------------------------------------------
    def _log_handle(self):
        if self._log_f is None or self._log_f.closed:
            self._log_f = open(self._log_path, "a")
        return self._log_f

    def append(self, entries: list[dict]) -> None:
        f = self._log_handle()
        for e in entries:
            f.write(json.dumps(_to_jsonable(e)) + "\n")
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())

    def rewrite_log(self, entries: list[dict]) -> None:
        """Truncation (conflict suffix delete) or compaction rewrite."""
        if self._log_f is not None and not self._log_f.closed:
            self._log_f.close()
        _atomic_write(
            self._log_path,
            "".join(json.dumps(_to_jsonable(e)) + "\n" for e in entries),
            self.fsync,
        )

    # -- snapshot store ------------------------------------------------
    def save_snapshot(self, snapshot: Any, base_index: int,
                      base_term: int) -> None:
        snap_j = _to_jsonable(snapshot)
        payload = json.dumps(snap_j, sort_keys=True)
        _atomic_write(
            self._snap_path,
            json.dumps({
                "base_index": base_index,
                "base_term": base_term,
                "snapshot": snap_j,
                "sha256": hashlib.sha256(payload.encode()).hexdigest(),
            }),
            self.fsync,
        )

    def close(self) -> None:
        if self._log_f is not None and not self._log_f.closed:
            self._log_f.close()
