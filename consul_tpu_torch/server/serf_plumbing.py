"""Serf→server plumbing: tags, member translation, the LAN event loop.

The port's copy of ``consul_tpu/server/serf_plumbing.py``; it imports
nothing of the reference package. ``build_tags``, ``parse_tags`` and
``LanEventHandler`` are copies. The two readers of the simulation take
the state as the port stores it (packed or dense, on the card) and copy
only the rows they read to the host: ``members_from_sim`` one observer's
row, ``sync_coordinates`` the seats' Vivaldi rows, each in one
device-to-host transfer. Neither unpacks the [N] state whole.

The reference wires gossip into the control plane in three pieces this
module reproduces (reference agent/consul/server_serf.go):

  - ``setupSerf`` stamps every server's serf member with tags — role,
    dc, id, port, expect, protocol versions (:33-113) — which is how
    servers find each other inside a mixed client/server member list
    (:func:`build_tags` / :func:`parse_tags`, the metadata.IsConsulServer
    contract);
  - ``lanEventHandler`` (:131) consumes serf member events and funnels
    them to ``maybeBootstrap`` (:236, bootstrap-expect) and — via
    ``reconcileCh`` — the leader's serf↔catalog reconciliation
    (:class:`LanEventHandler`);
  - the member list itself; here it comes from the *simulated* gossip
    plane: :func:`members_from_sim` reads one observer seat's view row
    and translates each subject into the reconcile shape with serf's
    reap semantics applied — the bridge from the eventually-consistent
    data plane into the raft-backed catalog, closing the loop the
    reference closes through serf.Members().
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from consul_tpu_torch.config import SimConfig, to_ticks
from consul_tpu_torch.models import coalesce
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.ops import merge
from consul_tpu_torch.server.leader import reconcile

VSN_TAGS = {"vsn": "2", "vsn_min": "1", "vsn_max": "3",
            "raft_vsn": "3", "wan_join_port": "8302"}

# Device-to-host bytes of the simulation reads (members_from_sim rows and
# sync_coordinates rows), for the card's measurements.
STATS = {"d2h_bytes": 0}


def build_tags(node_id: str, dc: str = "dc1", server: bool = True,
               expect: int = 0, port: int = 8300,
               segment: str = "") -> dict[str, str]:
    """The setupSerf tag map (server_serf.go:33-113)."""
    tags = {"id": node_id, "dc": dc, "segment": segment, **VSN_TAGS}
    if server:
        tags["role"] = "consul"
        tags["port"] = str(port)
        if expect:
            tags["expect"] = str(expect)
    else:
        tags["role"] = "node"
    return tags


def parse_tags(member: dict) -> Optional[dict]:
    """metadata.IsConsulServer: a member's tags parsed into server
    attributes, or None for non-server members (clients)."""
    tags = member.get("tags", {})
    if tags.get("role") != "consul":
        return None
    try:
        return {
            "id": tags.get("id", member.get("name", "")),
            "dc": tags.get("dc", ""),
            "port": int(tags.get("port", 8300)),
            "expect": int(tags.get("expect", 0)),
        }
    except (TypeError, ValueError):
        return None  # malformed gossip tags never crash the handler


def _rows_to_host(x: torch.Tensor) -> np.ndarray:
    out = x.cpu().numpy()
    STATS["d2h_bytes"] += out.nbytes
    return out


def _observer_row(serf_state, observer: int):
    """``(view_key[K], down_since[K], t)`` of one observer, gathered on
    the state's device from the SWIM plane as it is stored (packed rows
    unpacked by ``layout``) and copied to the host in one transfer."""
    sw = serf_state.swim
    idx = torch.tensor([int(observer)], dtype=torch.int64, device=sw.t.device)
    row = layout_mod.take_rows(sw, idx)
    if isinstance(row, layout_mod.PackedSimState):
        row = layout_mod.unpack(row)
    i64 = torch.int64
    down = serf_state.down_since.index_select(0, idx)
    k = row.view_key.shape[1]
    host = _rows_to_host(torch.cat([
        row.view_key[0].to(i64), down[0].to(i64), row.t.to(i64).reshape(1)]))
    return host[:k], host[k:2 * k], int(host[2 * k])


def members_from_sim(cfg: SimConfig, topo, serf_state, observer: int,
                     name_fn=None) -> list[dict]:
    """Translate one observer seat's membership view into reconcile's
    member-dict shape, with reap semantics (serf.go:1544-1568): dead
    past reconnect-timeout and left past tombstone-timeout report as
    "reap" so the catalog sweep deregisters them. ``serf_state`` is a
    ``models/serf.SerfState`` whose SWIM plane is packed or dense; only
    the observer's row leaves the device."""
    name_fn = name_fn or (lambda i: f"sim-{i}")
    g = cfg.gossip
    row, down, t = _observer_row(serf_state, observer)
    off = topo.off_host or tuple(int(x) for x in topo.off.tolist())
    reconnect = to_ticks(cfg.serf.reconnect_timeout_ms, g.tick_ms)
    tombstone = to_ticks(cfg.serf.tombstone_timeout_ms, g.tick_ms)
    n = cfg.n
    # The local node is always in its own member list (serf.Members()
    # includes self) — without it the reconcile reap sweep would
    # deregister the live observer.
    out = [{"name": name_fn(observer), "address": name_fn(observer),
            "status": "alive"}]
    for c in range(row.shape[0]):
        key = int(row[c])
        st = merge.key_status_int(key)
        if key == merge.UNKNOWN:
            continue  # never-heard subjects are not members yet
        down_ticks = (t - int(down[c])) if down[c] >= 0 else 0
        if st == merge.ALIVE or st == merge.SUSPECT:
            status = "alive"   # suspicion is not yet failure (leader
            #                    reconcile acts on serf's final states)
        elif st == merge.DEAD:
            status = "reap" if down_ticks > reconnect else "failed"
        else:  # LEFT
            status = "reap" if down_ticks > tombstone else "left"
        subject = (observer + int(off[c])) % n
        out.append({"name": name_fn(subject),
                    "address": name_fn(subject), "status": status})
    return out


def _vivaldi_rows(sim, seats: list[int]) -> np.ndarray:
    """``[S, D + 3]`` float32 host rows ``vec | height | error |
    adjustment`` of the seats, gathered from the SWIM plane as it is
    stored (packed rows unpacked by ``layout``), in one transfer. A
    simulation on a mesh is refused: its state is only whole once
    gathered from every shard."""
    if getattr(sim, "mesh", None) is not None:
        raise ValueError("sync_coordinates reads one device's state: "
                         "set_mesh(None) before syncing coordinates")
    sw = sim._swim_at_rest()
    idx = torch.as_tensor(seats, dtype=torch.int64, device=sw.t.device)
    rows = layout_mod.take_rows(sw, idx)
    if isinstance(rows, layout_mod.PackedSimState):
        rows = layout_mod.unpack(rows)
    v = rows.viv
    f32 = torch.float32
    return _rows_to_host(torch.cat([
        v.vec.to(f32), v.height.to(f32)[:, None], v.error.to(f32)[:, None],
        v.adjustment.to(f32)[:, None]], dim=1))


def sync_coordinates(sim, server, seats: Iterable[int],
                     name_fn=None, flush_every: int = 512) -> int:
    """The agent coordinate loop for simulated seats (reference
    agent/agent.go:1891-1940 sendCoordinate -> Coordinate.Update):
    read the named seats' Vivaldi rows in one gather and one
    device->host copy and stage them on the server's coordinate
    endpoint — the write-batching design of coordinate_endpoint.go:42-153
    maps directly onto the tensor batch (SURVEY §2.5). Large seat sets
    are flushed every ``flush_every`` updates so the endpoint's rate
    limiter (batch_size x max_batches pending) never silently discards
    any; the returned count is therefore exactly what landed. A final
    ``server.flush_coordinates()`` commits the tail."""
    name_fn = name_fn or (lambda i: f"sim-{i}")
    seats = list(seats)
    if not seats:
        return 0
    rows = _vivaldi_rows(sim, seats)
    d = rows.shape[1] - 3
    staged = 0
    for i, seat in enumerate(seats):
        server.rpc(
            "Coordinate.Update", node=name_fn(seat),
            coord={"vec": [float(x) for x in rows[i, :d]],
                   "height": float(rows[i, d]),
                   "error": float(rows[i, d + 1]),
                   "adjustment": float(rows[i, d + 2])},
        )
        staged += 1
        if staged % flush_every == 0:
            server.flush_coordinates()
    return staged


class LanEventHandler:
    """lanEventHandler (server_serf.go:131): consume member events,
    maintain the member map, feed bootstrap-expect and the leader's
    reconcile. Accepts the coalescer's Event stream, so bursts arrive
    already collapsed (serf wires the coalescer in front of the
    handler)."""

    def __init__(self, server, cluster=None):
        self.server = server
        self.cluster = cluster   # ServerCluster for maybe_bootstrap
        self.members: dict[str, dict] = {}

    def handle_events(self, events: Iterable[coalesce.Event]) -> list[int]:
        """Apply a batch of member events; returns reconcile indexes."""
        for e in events:
            if e.type == coalesce.MEMBER_JOIN:
                m = self.members.setdefault(
                    e.name, {"name": e.name, "tags": {}})
                m["status"] = "alive"
                if isinstance(e.payload, dict):
                    m["tags"] = e.payload
            elif e.type == coalesce.MEMBER_FAILED:
                self.members.setdefault(e.name, {"name": e.name})[
                    "status"] = "failed"
            elif e.type == coalesce.MEMBER_LEAVE:
                self.members.setdefault(e.name, {"name": e.name})[
                    "status"] = "left"
            elif e.type == coalesce.MEMBER_REAP:
                self.members.pop(e.name, None)
        member_list = list(self.members.values())
        if self.cluster is not None and not self.cluster.bootstrapped:
            self.cluster.maybe_bootstrap(member_list)
        if self.server.is_leader():
            return reconcile(self.server, [
                {"name": m["name"],
                 # Never clobber a known catalog address with "": the
                 # alive path re-registers when addresses differ.
                 "address": m.get("address")
                 or (self.server.store.get_node(m["name"]) or {}).get(
                     "address", ""),
                 "status": m.get("status", "alive")}
                for m in member_list
            ])
        return []
