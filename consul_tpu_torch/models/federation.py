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

Pass ``device="cpu", kernel="torch"`` for the plain PyTorch path on the
CPU. Nothing falls back: ``kernel="cuda"`` without a CUDA device raises,
and so does ``mesh=`` (multi-GPU placement is ROADMAP A13).
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
    lan: tuple             # n_dc PackedSimStates, one per owned DC
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


class Federation:
    """Driver for one federated simulation (LAN pools + WAN pool).

    Tests can hand in the shared topologies, the per-DC LAN worlds, the
    WAN world and a whole :class:`FederationState` (``convert.py`` carries
    the reference's across), and a draw source: ``draws(t)`` returns the
    LAN tick ``t``'s n_dc :class:`swim.TickDraws` and the WAN pool's
    bundle, which is read only when :meth:`next_wan_fires` (it may be None
    otherwise). By default the federation draws from its own generator,
    the WAN bundle only on ticks where the WAN tick fires."""

    def __init__(self, cfg: FederationConfig, seed: int = 0, mesh=None, *,
                 device="cuda", kernel: str = cuda_gossip.CUDA,
                 lan_topo: Optional[topology.Topology] = None,
                 wan_topo: Optional[topology.Topology] = None,
                 lan_world: Optional[list] = None,
                 wan_world: Optional[World] = None,
                 state: Optional[FederationState] = None,
                 draws: Optional[Callable] = None):
        if mesh is not None:
            raise NotImplementedError(
                "Federation(mesh=...) places the federation over a device "
                "mesh, which is multi-GPU work (ROADMAP A13); the port runs "
                "it on one device")
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
        cuda_gossip.validate_kernel(kernel, layout_mod.PACKED, self.device)
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
        self._wan_off = cfg.dc_offset * cfg.servers_per_dc
        self.gen = _gen(dev, seed, _DRAWS)
        self.draws = draws if draws is not None else self._own_draws
        if kernel == cuda_gossip.CUDA:
            self._lan_tick = cuda_gossip.make_tick_kernel(lan, lan_topo)
            self._wan_tick = cuda_gossip.make_tick_kernel(wan, wan_topo)
        else:
            self._lan_tick = self._plain(lan, lan_topo)
            self._wan_tick = self._plain(wan, wan_topo)
        # The host copy of the LAN tick (every LAN pool steps together).
        self._t = int(layout_mod.tick_of(self.state.lan[0]))
        # Cumulative GossipCounters on the device: [n_dc, 26] and [26].
        nf = len(counters_mod.FIELDS)
        self._lan_cnt = torch.zeros((cfg.n_dc, nf), dtype=torch.int64, device=dev)
        self._wan_cnt = torch.zeros((nf,), dtype=torch.int64, device=dev)

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

    def _wan_liveness(self, lan, wan):
        """The WAN state with the owned rows' flag bits 0 and 1 taken from
        each owned DC's servers (their LAN ``alive_truth`` / ``left``)."""
        s = self.cfg.servers_per_dc
        lo = self._wan_off
        hi = lo + self.cfg.n_dc * s
        srv = torch.cat([st.flags[:s] for st in lan])
        f = wan.flags
        owned = (f[lo:hi] & (0xFF ^ _LIVENESS)) | (srv & _LIVENESS)
        return wan._replace(flags=torch.cat([f[:lo], owned, f[hi:]]))

    def _tick(self):
        fire = self.next_wan_fires()
        lan_d, wan_d = self.draws(self._t)
        st = self.state
        lan = []
        for i in range(self.cfg.n_dc):
            s, c = self._lan_tick(self.lan_world[i], st.lan[i], lan_d[i], None)
            self._lan_cnt[i] += c
            lan.append(s)
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
        f = lan[dc].flags
        lan[dc] = lan[dc]._replace(flags=torch.where(mask, f & 0xFE, f))
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
        rows = torch.cat([self._lan_cnt, self._wan_cnt[None]]).tolist()
        return {"lan": [dict(zip(fields, r)) for r in rows[:-1]],
                "wan": dict(zip(fields, rows[-1]))}

    def lan_health(self, dc: int) -> metrics.HealthMetrics:
        return metrics.health_packed(self.cfg.lan, self.lan_topo,
                                     self.state.lan[dc])

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
