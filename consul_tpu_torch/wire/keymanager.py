"""Cluster-wide gossip-key rotation via internal queries (the port's copy
of ``consul_tpu/wire/keymanager.py``).

Mirrors the reference KeyManager (reference serf/keymanager.go:
InstallKey/UseKey/RemoveKey/ListKeys issue the internal serf queries
``_serf_install-key`` / ``use-key`` / ``remove-key`` / ``list-keys``,
serf/internal_query.go; every member applies the operation to its local
keyring and acks, and the manager aggregates per-node acks/errors into a
KeyResponse). The install→use→remove sequence is the flag-day-free
rotation the multi-key ring exists for (wire/keyring.py).

Here the "cluster" is the set of keyring holders at the host boundary —
the simulation's own ring plus every bridge-attached agent's — and
query distribution is pluggable: ``reachable()`` names the members the
query round actually reached (wire it to the simulated query plane's
response tally, or leave as everyone for direct use). Members the query
misses simply don't apply the operation — exactly the partial-failure
surface the reference reports via NumErr/NumResp.
"""

from __future__ import annotations

import base64
from typing import Callable, Optional

from consul_tpu_torch.wire.keyring import Keyring, validate_key


class KeyResponse:
    """reference serf/keymanager.go KeyResponse."""

    def __init__(self):
        self.messages: dict[str, str] = {}   # node -> error message
        self.num_nodes = 0
        self.num_resp = 0
        self.num_err = 0
        self.keys: dict[str, int] = {}       # b64 key -> holders

    @property
    def ok(self) -> bool:
        return self.num_err == 0 and self.num_resp == self.num_nodes


def _b64(key: bytes) -> str:
    return base64.b64encode(key).decode()


class KeyManager:
    def __init__(self, members: dict[str, Keyring],
                 reachable: Optional[Callable[[], set]] = None):
        self.members = members
        self._reachable = reachable or (lambda: set(members))

    def _query(self, apply) -> KeyResponse:
        """One internal query round: every reachable member applies and
        acks; errors are collected per node (keymanager.go
        streamKeyResp)."""
        resp = KeyResponse()
        resp.num_nodes = len(self.members)
        reached = self._reachable()
        for name, ring in self.members.items():
            if name not in reached:
                continue
            resp.num_resp += 1
            try:
                apply(ring)
            except (ValueError, KeyError) as e:
                resp.num_err += 1
                resp.messages[name] = str(e)
        return resp

    def install_key(self, key: bytes) -> KeyResponse:
        """Phase 1: every member learns the key (can decrypt) without
        using it to encrypt (keymanager.go InstallKey)."""
        validate_key(key)
        return self._query(lambda ring: ring.install(key))

    def use_key(self, key: bytes) -> KeyResponse:
        """Phase 2: switch the primary. Members that never got the key
        error out, which the caller must treat as a failed rotation
        (keymanager.go UseKey -> keyring.UseKey)."""
        return self._query(lambda ring: ring.use(key))

    def remove_key(self, key: bytes) -> KeyResponse:
        """Phase 3: retire the old key; removing a primary errors
        (keyring.go RemoveKey)."""
        return self._query(lambda ring: ring.remove(key))

    def list_keys(self) -> KeyResponse:
        """Aggregate per-key holder counts (keymanager.go ListKeys) —
        the operator's view of rotation progress."""
        resp = KeyResponse()
        resp.num_nodes = len(self.members)
        reached = self._reachable()
        for name, ring in self.members.items():
            if name not in reached:
                continue
            resp.num_resp += 1
            for k in ring.keys:
                resp.keys[_b64(k)] = resp.keys.get(_b64(k), 0) + 1
        return resp
