"""Multi-datacenter federation: LAN pools + the WAN gossip pool (PyTorch
port of ``consul_tpu/models/federation.py``).

The reference federates datacenters with two gossip tiers (reference
agent/consul/server.go:223-230: every server is in its DC's LAN serf
pool *and* the global WAN pool, with slower WAN timing
memberlist/config.go:272-281): LAN pools detect node failures inside a
DC, the WAN pool detects server/DC failures globally and carries the WAN
coordinate space that drives cross-DC routing (``server/router.py``).

Shape on the card:

  - Every DC's LAN pool is a packed state of its own, stepped by one
    launch set of the CUDA tick per DC per LAN tick, all through one
    :class:`~consul_tpu_torch.ops.cuda_gossip.TickKernel` built for the
    LAN config and the shared LAN topology (the reference vmaps one step
    over a stacked ``dc`` axis).
  - The WAN pool is a second, smaller packed state over the union of
    every DC's server subset (nodes ``0..servers_per_dc-1`` of each DC)
    at the WAN timing profile, stepped by the same kernel built for its
    own config (at 4 DCs x 3 servers, the dense view with K = 11).
  - LAN ticks are the global clock; the WAN tick fires on a Bresenham
    schedule (a 500 ms WAN tick interleaves 200 ms LAN ticks as
    3,2,3,2,...). The schedule follows from the configs' ``tick_ms``
    alone, so the host keeps the accumulator and knows which ticks fire
    without reading the device: a chunk reads nothing back.
  - After the LAN pools step, each owned DC's server liveness (flag bits
    0 and 1: ``alive_truth``, ``left``) is written into the WAN rows this
    instance owns, and nothing else of the WAN state.

Ground truth: DC sites are planted far apart (inter-DC RTTs dominate),
servers near their site, so learned WAN Vivaldi coordinates recover the
inter-DC distance ordering used by ``Router.get_datacenters_by_distance``.
LAN worlds and initial states are drawn per **global** DC index from
generators seeded by ``(seed, global dc)``, so an island of a DCN
federation (``parallel/dcn.py``) plants exactly the DCs the single
federation has in those slots.

``mesh=`` places the federation over a 2-D (dc, nodes) mesh
(``parallel.mesh.make_mesh(devices, n_dc=D)``, the reference's
``federation_sharding``): mesh row ``r`` holds the DCs ``[r * n_dc / D,
(r + 1) * n_dc / D)``, each node-sharded over the row's R devices
(``parallel.mesh.federation_rows`` / ``row_mesh``). Everything is planted
on the mesh's first device exactly as on one device, then each DC's LAN
state and world are placed on its row (``shard_step.place`` under
``groups``, a grouping of one row's shards applied to every row), and
each DC steps through a sharded CUDA tick of its own
(``cuda_gossip.ShardedTickKernel``, B7: one world per kernel) or, with
``kernel="torch"``, through the plain sharded step
(``shard_step.run_ticks``). The WAN pool stays whole on the mesh's first
device (the port's narrowing: the reference shards WAN rows by node
where ``n_wan`` divides R). A meshed federation is bit-equal to the
one-device federation of the same seed.

Pass ``device="cpu", kernel="torch"`` for the plain PyTorch path on the
CPU. Nothing falls back: ``kernel="cuda"`` without a CUDA device raises,
on every device of a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from consul_tpu_torch.config import GossipConfig, SimConfig
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import state as sim_state
from consul_tpu_torch.models import swim
from consul_tpu_torch.ops import cuda_gossip, topology
from consul_tpu_torch.ops.topology import World
from consul_tpu_torch.parallel import mesh as mesh_mod
from consul_tpu_torch.parallel import shard_step
from consul_tpu_torch.utils import metrics

# Flag bits the LAN pool writes into the WAN rows: alive_truth | left << 1.
_LIVENESS = 0x3


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    n_dc: int = 2
    nodes_per_dc: int = 256
    servers_per_dc: int = 3
    # Intra-DC latency world (LAN profile defaults).
    lan: SimConfig = dataclasses.field(default_factory=SimConfig)
    # Inter-DC spread for the WAN ground truth (ms).
    wan_diameter_ms: float = 120.0
    # Inter-island (DCN) partitioning: this instance owns the ``n_dc``
    # datacenters starting at global index ``dc_offset`` out of
    # ``n_dc_total``; its WAN pool replica spans ALL DCs' servers, but
    # LAN ground truth flows into only the owned rows (parallel/dcn.py).
    # None tracks ``n_dc`` (read via :attr:`dc_total`).
    n_dc_total: Optional[int] = None
    dc_offset: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "lan", dataclasses.replace(self.lan, n=self.nodes_per_dc)
        )

    @property
    def dc_total(self) -> int:
        return self.n_dc_total if self.n_dc_total is not None else self.n_dc

    @property
    def wan(self) -> SimConfig:
        """The WAN pool's SimConfig: server subset, WAN gossip profile
        (reference memberlist/config.go:272-281)."""
        return dataclasses.replace(
            self.lan,
            n=self.dc_total * self.servers_per_dc,
            gossip=GossipConfig.wan(),
            world_diameter_ms=self.wan_diameter_ms,
        )

    @property
    def n_wan(self) -> int:
        return self.dc_total * self.servers_per_dc


class FederationState(NamedTuple):
    # n_dc PackedSimStates, one per owned DC (under a mesh, each a list of
    # its row's shard blocks, placed by shard_step.place)
    lan: tuple
    wan: object            # PackedSimState [n_wan]
    wan_accum_ms: int      # Bresenham accumulator (host int)


# Seed streams of the planting generators (one generator per use, so the
# topology, the worlds, the initial states and the draws never share one).
_LAN_TOPO, _LAN_WORLD, _LAN_INIT = 1, 2, 3
_WAN_TOPO, _WAN_WORLD, _WAN_INIT, _CENTERS, _DRAWS = 4, 5, 6, 7, 8


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for generator ``(seed, stream, index)``: a splitmix64
    mix, so nearby triples seed unrelated streams."""
    x = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB + 1) % (1 << 64)
    for mul, shift in ((0xBF58476D1CE4E5B9, 30), (0x94D049BB133111EB, 27)):
        x = ((x ^ (x >> shift)) * mul) % (1 << 64)
    return (x ^ (x >> 31)) >> 1


def _gen(device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, index))
    return g


def _on(tree, device):
    """A draw bundle (a NamedTuple of tensors) on ``device``."""
    return type(tree)(*(x.to(device) for x in tree))


class Federation:
    """Driver for one federated simulation (LAN pools + WAN pool).

    Tests can hand in the shared topologies, the per-DC LAN worlds, the
    WAN world and a whole :class:`FederationState` (``convert.py`` carries
    the reference's across), and a draw source: ``draws(t)`` returns the
    LAN tick ``t``'s n_dc :class:`swim.TickDraws` and the WAN pool's
    bundle, which is read only when :meth:`next_wan_fires` (it may be None
    otherwise). By default the federation draws from its own generator,
    the WAN bundle only on ticks where the WAN tick fires.

    ``mesh`` is a 2-D (dc, nodes) ``parallel.mesh.Mesh`` (module
    docstring) whose first device ``device`` must name; ``groups`` groups
    one row's shards as on ``Simulation`` (default ``mesh.device_groups``
    of the row; ``mesh.shard_groups`` runs one group per shard), the same
    grouping on every row."""

    def __init__(self, cfg: FederationConfig, seed: int = 0, mesh=None, *,
                 groups=None, device="cuda", kernel: str = cuda_gossip.CUDA,
                 lan_topo: Optional[topology.Topology] = None,
                 wan_topo: Optional[topology.Topology] = None,
                 lan_world: Optional[list] = None,
                 wan_world: Optional[World] = None,
                 state: Optional[FederationState] = None,
                 draws: Optional[Callable] = None):
        if cfg.dc_offset < 0 or cfg.dc_offset + cfg.n_dc > cfg.dc_total:
            raise ValueError(f"DCs [{cfg.dc_offset}, {cfg.dc_offset + cfg.n_dc})"
                             f" lie outside the federation's {cfg.dc_total}")
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.kernel = kernel
        lan, wan = cfg.lan, cfg.wan
        for c in (lan, wan):
            layout_mod.validate(c, layout_mod.PACKED)
        self.mesh, self.groups = self._check_mesh(mesh, groups)
        for dev in ([self.device] if self.mesh is None
                    else self.mesh.unique_devices()):
            cuda_gossip.validate_kernel(kernel, layout_mod.PACKED, dev)
        dev = self.device
        if lan_topo is None:
            lan_topo = topology.make_topology(lan, _gen(dev, seed, _LAN_TOPO), dev)
        if wan_topo is None:
            wan_topo = topology.make_topology(wan, _gen(dev, seed, _WAN_TOPO), dev)
        self.lan_topo, self.wan_topo = lan_topo, wan_topo
        # Worlds and initial states over the GLOBAL DC index, so an island
        # plants what the single federation has in its slots.
        dcs = range(cfg.dc_offset, cfg.dc_offset + cfg.n_dc)
        if lan_world is None:
            lan_world = [topology.make_world(lan, _gen(dev, seed, _LAN_WORLD, g), dev)
                         for g in dcs]
        self.lan_world = list(lan_world)
        if wan_world is None:
            # Servers planted near their DC site (all DCs: the WAN replica
            # is global even when this instance owns a slice).
            centers = torch.rand((cfg.dc_total, lan.world_dims),
                                 generator=_gen(dev, seed, _CENTERS),
                                 device=dev) * (cfg.wan_diameter_ms / 1000.0)
            local = topology.make_world(wan, _gen(dev, seed, _WAN_WORLD), dev)
            site = torch.repeat_interleave(centers, cfg.servers_per_dc, dim=0)
            wan_world = World(pos=site + 0.02 * local.pos, height=local.height)
        self.wan_world = wan_world
        if state is None:
            state = FederationState(
                lan=tuple(layout_mod.pack(sim_state.init(
                    lan, _gen(dev, seed, _LAN_INIT, g), dev)) for g in dcs),
                wan=layout_mod.pack(sim_state.init(
                    wan, _gen(dev, seed, _WAN_INIT), dev)),
                wan_accum_ms=0)
        if len(state.lan) != cfg.n_dc or len(self.lan_world) != cfg.n_dc:
            raise ValueError(f"{len(state.lan)} LAN states and "
                             f"{len(self.lan_world)} LAN worlds for "
                             f"{cfg.n_dc} DCs")
        self.state = state._replace(lan=tuple(state.lan),
                                    wan_accum_ms=int(state.wan_accum_ms))
        # The host copy of the LAN tick (every LAN pool steps together).
        self._t = int(layout_mod.tick_of(self.state.lan[0]))
        self._wan_off = cfg.dc_offset * cfg.servers_per_dc
        self.gen = _gen(dev, seed, _DRAWS)
        self.draws = draws if draws is not None else self._own_draws
        if kernel == cuda_gossip.CUDA:
            self._lan_tick = cuda_gossip.make_tick_kernel(lan, lan_topo)
            self._wan_tick = cuda_gossip.make_tick_kernel(wan, wan_topo)
        else:
            self._lan_tick = self._plain(lan, lan_topo)
            self._wan_tick = self._plain(wan, wan_topo)
        # Cumulative GossipCounters on the device: [n_dc, 26] (under a mesh
        # [n_dc, groups, 26], summed over the groups when read) and [26].
        nf = len(counters_mod.FIELDS)
        per_dc = (nf,) if self.mesh is None else (len(self.groups), nf)
        self._lan_cnt = torch.zeros((cfg.n_dc,) + per_dc, dtype=torch.int64,
                                    device=dev)
        self._wan_cnt = torch.zeros((nf,), dtype=torch.int64, device=dev)
        if self.mesh is not None:
            self._place_lan()

    def _check_mesh(self, mesh, groups):
        """``(mesh, groups)`` held to the federation: a 2-D (dc, nodes) mesh
        whose rows divide the DCs and whose row width divides each DC's
        nodes (``mesh.federation_rows``), ``device`` its first device, and
        ``groups`` a grouping of one row's shards that fits every row.
        ``(None, None)`` without a mesh."""
        if mesh is None:
            return None, None
        if not isinstance(mesh, mesh_mod.Mesh):
            mesh = mesh_mod.make_mesh(list(mesh))
        cfg = self.cfg
        self._rows = mesh_mod.federation_rows(mesh, cfg.n_dc, cfg.nodes_per_dc)
        first = mesh.devices[0]
        if mesh_mod.as_device(self.device) != first:
            raise ValueError(f"device={self.device!r} disagrees with the "
                             f"mesh, whose first device is {first}")
        self.device = first
        rows = [mesh_mod.row_mesh(mesh, r) for r in range(mesh.shape[0])]
        groups = mesh_mod.check_groups(rows[0], groups)
        for m in rows[1:]:
            mesh_mod.check_groups(m, groups)
        # Each owned DC's row, as a 1-D node mesh.
        self._lan_meshes = [rows[r] for r in self._rows]
        return mesh, groups

    def _place_lan(self):
        """Each DC's LAN state placed on its row and its stepping bound:
        one sharded CUDA tick per DC (B7 keeps one world), or the DC's
        world placed for the plain sharded step."""
        cfg, n = self.cfg, self.cfg.nodes_per_dc
        self.state = self.state._replace(lan=tuple(
            shard_step.place(m, st, n, groups=self.groups)
            for m, st in zip(self._lan_meshes, self.state.lan)))
        if self.kernel == cuda_gossip.CUDA:
            self._lan_ticks = []
            for m, w in zip(self._lan_meshes, self.lan_world):
                k = cuda_gossip.ShardedTickKernel(cfg.lan, self.lan_topo, m,
                                                  groups=self.groups)
                k.set_world(w)
                self._lan_ticks.append(k)
        else:
            self._world_blocks = [shard_step.place(m, w, n, groups=self.groups)
                                  for m, w in zip(self._lan_meshes,
                                                  self.lan_world)]
            self._topos = {dev: shard_step.topo_on(self.lan_topo, dev)
                           for dev in self.mesh.unique_devices()}

    @staticmethod
    def _plain(cfg, topo):
        return lambda w, s, d, sched=None: cuda_gossip.plain_tick(
            cfg, topo, w, s, d, sched)

    # ------------------------------------------------------------------
    def next_wan_fires(self) -> bool:
        """Whether the WAN tick fires on the next LAN tick (Bresenham over
        the configs' ``tick_ms``; host state only)."""
        lan_ms = self.cfg.lan.gossip.tick_ms
        return self.state.wan_accum_ms + lan_ms >= self.cfg.wan.gossip.tick_ms

    def _own_draws(self, t):
        lan = [swim.draw_tick(self.cfg.lan, self.gen, self.device)
               for _ in range(self.cfg.n_dc)]
        wan = (swim.draw_tick(self.cfg.wan, self.gen, self.device)
               if self.next_wan_fires() else None)
        return lan, wan

    def _server_flags(self, st):
        """A DC's server rows ``[0, servers_per_dc)`` of ``flags``, on the
        federation's device: under a mesh read from the blocks that hold
        them, with no gather of the DC."""
        s = self.cfg.servers_per_dc
        if self.mesh is None:
            return st.flags[:s]
        b = self.cfg.nodes_per_dc // self.mesh.shape[1]
        parts = [blk.flags[:min(b, s - d * b)].to(self.device)
                 for d, blk in enumerate(st) if d * b < s]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _wan_liveness(self, lan, wan):
        """The WAN state with the owned rows' flag bits 0 and 1 taken from
        each owned DC's servers (their LAN ``alive_truth`` / ``left``)."""
        s = self.cfg.servers_per_dc
        lo = self._wan_off
        hi = lo + self.cfg.n_dc * s
        srv = torch.cat([self._server_flags(st) for st in lan])
        f = wan.flags
        owned = (f[lo:hi] & (0xFF ^ _LIVENESS)) | (srv & _LIVENESS)
        return wan._replace(flags=torch.cat([f[:lo], owned, f[hi:]]))

    def _tick(self):
        fire = self.next_wan_fires()
        lan_d, wan_d = self.draws(self._t)
        st = self.state
        lan = [self._lan_step(i, st.lan[i], lan_d[i])
               for i in range(self.cfg.n_dc)]
        wan = self._wan_liveness(lan, st.wan)
        accum = st.wan_accum_ms + self.cfg.lan.gossip.tick_ms
        if fire:
            if wan_d is None:
                raise ValueError(f"LAN tick {self._t} fires the WAN tick; the "
                                 "draw source returned no WAN bundle")
            wan, c = self._wan_tick(self.wan_world, wan, wan_d, None)
            self._wan_cnt += c
            accum -= self.cfg.wan.gossip.tick_ms
        self.state = FederationState(lan=tuple(lan), wan=wan, wan_accum_ms=accum)
        self._t += 1

    def _lan_step(self, i: int, st, d):
        """One LAN tick of DC ``i`` (its state, its bundle), its counters
        added: through the CUDA tick (B1, or under a mesh the DC's sharded
        tick, B7, handed the bundle on its row's first device) or the plain
        tick (under a mesh the plain sharded step)."""
        if self.mesh is None:
            s, c = self._lan_tick(self.lan_world[i], st, d, None)
            self._lan_cnt[i] += c
            return s
        m = self._lan_meshes[i]
        if self.kernel == cuda_gossip.CUDA:
            blocks, cv = self._lan_ticks[i](st, _on(d, m.devices[0]))
            for g, c in enumerate(cv):
                self._lan_cnt[i, g] += c.to(self.device)
            return blocks
        lan = self.cfg.lan

        def tick(topo, w, s, dd, sched):
            return cuda_gossip.plain_tick(lan, topo, w, s, dd, sched)
        blocks, c = shard_step.run_ticks(m, lan.n, tick, self._topos,
                                         self._world_blocks[i], st, None,
                                         lambda _t: d, self._t, 1)
        self._lan_cnt[i, 0] += c.to(self.device)
        return blocks

    def run(self, lan_ticks: int, chunk: int = 32):
        """Advance ``lan_ticks`` LAN ticks. Nothing is read back from the
        device: the WAN fire pattern is the host's, the counters add up on
        the device. ``chunk`` is accepted only to match the reference's
        signature (its scan length); ticks are launched one by one."""
        for _ in range(lan_ticks):
            self._tick()
        return self.state

    # ------------------------------------------------------------------
    # Fault injection
    # ------------------------------------------------------------------
    def kill(self, dc: int, mask):
        """Kill nodes in one locally-owned DC (LAN + WAN if servers);
        ``dc`` is the local index within this instance's slice."""
        mask = torch.as_tensor(mask, dtype=torch.bool).to(self.device)
        st = self.state
        lan = list(st.lan)
        if self.mesh is None:
            f = lan[dc].flags
            lan[dc] = lan[dc]._replace(flags=torch.where(mask, f & 0xFE, f))
        else:
            # The mask placed by block; the edited blocks placed anew.
            m, n = self._lan_meshes[dc], self.cfg.nodes_per_dc
            masks = mesh_mod.split(m, mask, n, groups=self.groups)
            lan[dc] = shard_step.adjoin(m, [
                blk._replace(flags=torch.where(mk, blk.flags & 0xFE, blk.flags))
                for blk, mk in zip(lan[dc], masks)], n, groups=self.groups)
        s = self.cfg.servers_per_dc
        g = (self.cfg.dc_offset + dc) * s
        wf = st.wan.flags
        rows = torch.zeros_like(wf, dtype=torch.bool)
        rows[g:g + s] = mask[:s]
        wan = st.wan._replace(flags=torch.where(rows, wf & 0xFE, wf))
        self.state = st._replace(lan=tuple(lan), wan=wan)

    def kill_dc(self, dc: int):
        self.kill(dc, torch.ones((self.cfg.nodes_per_dc,), dtype=torch.bool))

    # ------------------------------------------------------------------
    # Inspection
    # ------------------------------------------------------------------
    def counters(self) -> dict:
        """Cumulative GossipCounters (one host read): ``{"lan": [n_dc dicts],
        "wan": dict}``, Python ints by field name."""
        fields = counters_mod.FIELDS
        lan = self._lan_cnt if self.mesh is None else self._lan_cnt.sum(1)
        rows = torch.cat([lan, self._wan_cnt[None]]).tolist()
        return {"lan": [dict(zip(fields, r)) for r in rows[:-1]],
                "wan": dict(zip(fields, rows[-1]))}

    def _lan_whole(self, dc: int):
        """DC ``dc``'s LAN state whole: under a mesh the view of its one
        group's storage where the kernel steps one group on the
        federation's device, a gathered copy otherwise."""
        st = self.state.lan[dc]
        if self.mesh is None:
            return st
        m, n = self._lan_meshes[dc], self.cfg.nodes_per_dc
        if (self.kernel == cuda_gossip.CUDA and len(self.groups) == 1
                and m.devices[0] == self.device):
            return mesh_mod.group_tree(st, self.groups[0], n // m.size, n)
        return shard_step.gather(st, n, self.device)

    def whole_state(self) -> FederationState:
        """The whole FederationState on the federation's device: each DC's
        LAN state gathered from its blocks under a mesh (a copy), the
        state itself on one device."""
        if self.mesh is None:
            return self.state
        n = self.cfg.nodes_per_dc
        return self.state._replace(lan=tuple(
            shard_step.gather(st, n, self.device) for st in self.state.lan))

    def lan_health(self, dc: int) -> metrics.HealthMetrics:
        return metrics.health_packed(self.cfg.lan, self.lan_topo,
                                     self._lan_whole(dc))

    def wan_health(self) -> metrics.HealthMetrics:
        return metrics.health_packed(self.cfg.wan, self.wan_topo, self.state.wan)

    def wan_server_coord(self, dc: int, server: int) -> dict:
        """A WAN server's learned Vivaldi coordinate in store/router form
        (the WAN coordinate of reference agent/router sorting)."""
        i = dc * self.cfg.servers_per_dc + server
        viv = self.state.wan.viv
        return {
            "vec": [float(x) for x in viv.vec[i].float().cpu()],
            "error": float(viv.error[i]),
            "height": float(viv.height[i]),
            "adjustment": float(viv.adjustment[i]),
        }

    def wan_members_seen_by(self, observer_dc: int,
                            observer_server: int = 0) -> list[dict]:
        """The WAN member list as one server sees it, which feeds the router
        as serf WAN membership events do (reference
        agent/router/serf_adapter.go)."""
        i = observer_dc * self.cfg.servers_per_dc + observer_server
        # uint16 has no bitwise ops on CUDA: read the status on the host.
        st = (self.state.wan.meta[i].cpu().to(torch.int32) & 0x3).tolist()
        nbrs = topology.nbrs_table(self.wan_topo)[i].cpu().tolist()
        out = []
        for col in range(self.cfg.wan.degree):
            dc, srv = divmod(int(nbrs[col]), self.cfg.servers_per_dc)
            out.append({
                "id": f"srv{srv}.dc{dc}", "dc": f"dc{dc}",
                "status": ["alive", "suspect", "dead", "left"][st[col]],
            })
        return out

    def true_dc_distance_order(self, from_dc: int) -> list[int]:
        """Ground-truth DC ordering by site distance (for tests)."""
        s = self.cfg.servers_per_dc
        sites = self.wan_world.pos[::s]
        d = torch.linalg.norm(sites - sites[from_dc], dim=1)
        return [int(i) for i in torch.argsort(d, stable=True).cpu()]
