"""WAN router: multi-datacenter server tracking and RTT-aware routing
(the port's copy of ``consul_tpu/server/router.py``, over the port's
``server/rtt.py``; the port imports nothing of the reference package).

Mirrors the reference router (reference agent/router/router.go:
areas → managers → servers; ``GetDatacentersByDistance`` :395,
``GetDatacenterMaps`` :469; ``Manager.RebalanceServers`` manager.go:297)
plus the LAN→WAN flood join (reference agent/consul/flood.go:12-66):
every server floods its LAN server list into the WAN pool so remote DCs
can route to it.

Coordinates come from the WAN coordinate space (in this framework, a
federation's WAN simulation or the store's coordinate table); distance
sorting reuses the same Vivaldi math as catalog ``?near=``.
"""

from __future__ import annotations

import math
import random
from typing import Optional

from consul_tpu_torch.server import rtt


class Manager:
    """Per-(area, dc) server list with rebalancing (reference
    agent/router/manager.go: shuffled server order spreads RPC load;
    ``NotifyFailedServer`` cycles a failed server to the end)."""

    def __init__(self, dc: str, seed: int = 0):
        self.dc = dc
        self.servers: list[str] = []
        self.rng = random.Random(seed)

    def add_server(self, server_id: str):
        if server_id not in self.servers:
            self.servers.append(server_id)

    def remove_server(self, server_id: str):
        if server_id in self.servers:
            self.servers.remove(server_id)

    def find_server(self) -> Optional[str]:
        return self.servers[0] if self.servers else None

    def rebalance(self):
        self.rng.shuffle(self.servers)

    def notify_failed(self, server_id: str):
        """Move a failed server to the end of the rotation."""
        if server_id in self.servers:
            self.servers.remove(server_id)
            self.servers.append(server_id)


class Router:
    """Areas of datacenters with coordinate-based distance sorting."""

    LOCAL_AREA = "wan"  # reference types.AreaWAN

    def __init__(self, local_dc: str, seed: int = 0):
        self.local_dc = local_dc
        self.seed = seed
        # area -> dc -> Manager
        self.areas: dict[str, dict[str, Manager]] = {}
        # server id -> WAN coordinate (dict form)
        self.coords: dict[str, dict] = {}
        # server id -> dc
        self.server_dc: dict[str, str] = {}

    # ------------------------------------------------------------------
    def add_server(self, server_id: str, dc: str,
                   area: str = LOCAL_AREA,
                   coord: Optional[dict] = None):
        """Track a server (the serf WAN member-join path, reference
        agent/router/serf_adapter.go handleMemberEvent)."""
        managers = self.areas.setdefault(area, {})
        managers.setdefault(dc, Manager(dc, seed=self.seed)).add_server(server_id)
        self.server_dc[server_id] = dc
        if coord is not None:
            self.coords[server_id] = coord

    def remove_server(self, server_id: str, area: str = LOCAL_AREA):
        dc = self.server_dc.pop(server_id, None)
        self.coords.pop(server_id, None)
        if dc and area in self.areas and dc in self.areas[area]:
            self.areas[area][dc].remove_server(server_id)
            if not self.areas[area][dc].servers:
                del self.areas[area][dc]

    def fail_server(self, server_id: str, area: str = LOCAL_AREA):
        dc = self.server_dc.get(server_id)
        if dc and area in self.areas and dc in self.areas[area]:
            self.areas[area][dc].notify_failed(server_id)

    def update_coordinate(self, server_id: str, coord: dict):
        self.coords[server_id] = coord

    # ------------------------------------------------------------------
    def datacenters(self, area: str = LOCAL_AREA) -> list[str]:
        return sorted(self.areas.get(area, {}))

    def find_route(self, dc: str, area: str = LOCAL_AREA) -> Optional[str]:
        """A server to forward a cross-DC RPC to (reference
        router.go:312 FindRoute → forwardDC rpc.go:315)."""
        m = self.areas.get(area, {}).get(dc)
        return m.find_server() if m else None

    def get_datacenters_by_distance(self, area: str = LOCAL_AREA) -> list[str]:
        """DCs sorted by median coordinate distance from the local DC's
        servers (reference router.go:395 GetDatacentersByDistance,
        sorting by min-median RTT; ties/unknowns sort by name last)."""
        out = []
        for dc in self.datacenters(area):
            d = self._dc_distance(dc, area)
            out.append((d, dc))
        out.sort(key=lambda t: (t[0], t[1]))
        return [dc for _, dc in out]

    def _dc_distance(self, dc: str, area: str) -> float:
        if dc == self.local_dc:
            return 0.0
        local = self.areas.get(area, {}).get(self.local_dc)
        remote = self.areas.get(area, {}).get(dc)
        if not local or not remote:
            return math.inf
        dists = []
        for a in local.servers:
            ca = self.coords.get(a)
            for b in remote.servers:
                cb = self.coords.get(b)
                d = rtt.compute_distance(ca, cb)
                if math.isfinite(d):
                    dists.append(d)
        if not dists:
            return math.inf
        dists.sort()
        return dists[len(dists) // 2]

    def get_datacenter_maps(self, area: str = LOCAL_AREA) -> dict[str, list[str]]:
        """dc -> server ids (reference router.go:469 GetDatacenterMaps)."""
        return {dc: list(m.servers)
                for dc, m in self.areas.get(area, {}).items()}


def flood_join(router: Router, dc: str, lan_server_ids: list[str],
               coords: Optional[dict[str, dict]] = None,
               area: str = Router.LOCAL_AREA) -> int:
    """Flood the LAN server list into the WAN pool (reference
    agent/consul/flood.go:27-66 Flood: every local server joins the WAN
    member list on a ticker + membership notifications). Returns the
    number of servers newly added."""
    existing = set(router.get_datacenter_maps(area).get(dc, []))
    added = 0
    for sid in lan_server_ids:
        if sid not in existing:
            router.add_server(sid, dc, area,
                              (coords or {}).get(sid))
            added += 1
        elif coords and sid in coords:
            router.update_coordinate(sid, coords[sid])
    return added
