"""Inter-island (DCN) federation: the WAN tier across islands (PyTorch
port of ``consul_tpu/parallel/dcn.py``).

The reference federates datacenters over real WAN links: every server
joins the global WAN serf pool, and cross-DC traffic rides UDP/TCP
between hosts (reference agent/consul/server.go:223-230, flood.go). This
module is the host-mediated exchange between islands: each island runs
its own LAN pools plus a full **replica of the WAN pool**
(``models/federation.Federation``), reconciled at superstep boundaries
through the host.

The WAN pool's state is gossip state, per-observer views in a
join-semilattice; at a sync, every island receives every other island's
**owned rows wholesale** (the whole packed per-node protocol state:
views, incarnations, budgets, coordinates), a push-pull anti-entropy
exchange (reference memberlist/state.go:573-608) at the DCN tier. The
received facts then spread into the island's own rows in-protocol, by
the replica's later WAN ticks; the sync period is the modeled DCN
latency.

Ownership: island k owns the WAN rows of the servers in its DCs
(``FederationConfig.dc_offset`` / ``n_dc``); LAN ground truth flows into
owned rows only, so a server's liveness is always authored by the island
that simulates its datacenter.

Fault envelope: each directed link (src island -> dst island) runs a
small state machine (:class:`LinkPolicy` / ``_LinkState``): a failed send
(injected via :meth:`DcnFederation.inject_link_faults`: ``timeout`` a
send that burns its ``send_timeout_s`` budget, ``drop`` a fast failure)
puts the link into bounded exponential backoff measured in SYNC ROUNDS
with deterministic jitter (no wall clock, no host randomness), while the
undelivered payloads buffer in a bounded drop-oldest retransmit queue
(the newest always survives, which is all anti-entropy needs). On heal
the queue re-merges oldest-to-newest and the replicas reconverge. Every
event is counted into the telemetry sink (``utils/telemetry.Sink``):
``sim.dcn.retries``, ``sim.dcn.link_down_ticks``,
``sim.dcn.send_timeouts``, ``sim.dcn.retx_dropped``, ``sim.dcn.heals``,
``sim.dcn.link_degraded``.

Every island runs on the one device given, or with ``meshes=`` each on
its own 2-D (dc, nodes) mesh (``Federation(mesh=)``: its DCs node-sharded
over the mesh's rows, its WAN replica whole on the mesh's first device,
which is the island's device). A sync takes one device -> host pull and
one host -> device push per island, each one flat byte buffer of the
island's WAN state, pushed onto the island's device; a meshed run is
bit-equal to the meshless run of the same seed and faults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from consul_tpu_torch.models.federation import (_DRAWS, Federation,
                                                FederationConfig, stream_seed)
from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import cuda_gossip
from consul_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class LinkPolicy:
    """Per-link fault envelope for the DCN tier. Backoff is measured in
    sync rounds (one round = ``sync_every`` LAN ticks of modeled time),
    bounded exponentially: after the k-th consecutive failure the link
    stays down ``min(backoff_cap, backoff_base * 2**(k-1)) + jitter``
    rounds, with deterministic hash jitter. ``retry_max`` bounds the
    consecutive retries before the link is marked degraded (it keeps
    retrying at the capped cadence, but the degradation is counted)."""

    send_timeout_s: float = 2.0     # modeled per-send budget (timeout kind)
    retry_max: int = 5
    backoff_base: int = 1           # sync rounds
    backoff_cap: int = 8            # sync rounds
    queue_bound: int = 4            # buffered anti-entropy payloads


DEFAULT_LINK_POLICY = LinkPolicy()


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """An injected DCN link fault: sends src->dst fail during sync rounds
    [start, stop). ``kind`` is ``"drop"`` (fast failure) or ``"timeout"``
    (the send burns its ``send_timeout_s`` budget first: same outcome,
    distinct diagnosis and counter)."""

    src: int
    dst: int
    start: int
    stop: int
    kind: str = "drop"


@dataclasses.dataclass
class _LinkState:
    """One directed link's retry machine (host-side bookkeeping)."""

    queue: list = dataclasses.field(default_factory=list)
    attempt: int = 0          # consecutive failures
    down_until: int = 0       # backoff expiry, in sync rounds
    degraded: bool = False
    queue_peak: int = 0


def _jitter(src: int, dst: int, attempt: int) -> int:
    """Deterministic backoff jitter in {0, 1} rounds: a Knuth-style hash
    of (link, attempt)."""
    h = (src * 73856093) ^ (dst * 19349663) ^ (attempt * 83492791)
    return (h >> 4) & 1


# The packed WAN state's one leaf that is not per row: the tick counter.
_SCALAR_LEAVES = {"t"}


def _named_leaves(tree, prefix=""):
    """(dotted name, tensor) of every leaf of a packed state, in order."""
    out = []
    for name, x in zip(tree._fields, tree):
        if isinstance(x, torch.Tensor):
            out.append((prefix + name, x))
        else:
            out += _named_leaves(x, prefix + name + ".")
    return out


def _rebuild(tree, leaves: dict, prefix=""):
    """``tree`` with every leaf replaced by ``leaves[dotted name]``."""
    return type(tree)(*[
        leaves[prefix + name] if isinstance(x, torch.Tensor)
        else _rebuild(x, leaves, prefix + name + ".")
        for name, x in zip(tree._fields, tree)])


def _flat(named):
    """The leaves' bytes in one uint8 buffer, each leaf at an 8-byte
    aligned offset, and where each lies."""
    parts, spec, off = [], [], 0
    for name, x in named:
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        parts += [raw, raw.new_zeros(pad)]
        spec.append((name, off, x.dtype, tuple(x.shape), raw.numel()))
        off += raw.numel() + pad
    return torch.cat(parts), spec


def _cut(buf, spec) -> dict:
    return {name: buf[o:o + nb].view(dt).reshape(shape)
            for name, o, dt, shape, nb in spec}


def _pull(tree) -> dict:
    """Every leaf of a device state as host tensors, in one transfer."""
    buf, spec = _flat(_named_leaves(tree))
    return _cut(buf.cpu(), spec)


def _push(leaves: dict, like, device):
    """A state shaped as ``like`` from host leaves, in one transfer."""
    buf, spec = _flat([(name, leaves[name]) for name, _ in _named_leaves(like)])
    return _rebuild(like, _cut(buf.to(device), spec))


class DcnFederation:
    """Driver for a federation partitioned over ``n_islands`` islands.

    ``cfg`` describes the WHOLE federation (its ``n_dc`` is the global DC
    count); DCs are partitioned contiguously across islands. Every island
    runs on the one device given (``device``, ``kernel`` as
    :class:`Federation`), or with ``meshes`` (one 2-D (dc, nodes) mesh per
    island) island ``k`` is ``Federation(mesh=meshes[k], groups=groups)``
    on its mesh's first device."""

    def __init__(self, cfg: FederationConfig, n_islands: int = 2,
                 seed: int = 0, meshes: Optional[Sequence] = None,
                 link_policy: Optional[LinkPolicy] = None, sink=None, *,
                 groups=None, device="cuda", kernel: str = cuda_gossip.CUDA):
        if meshes is not None:
            meshes = [m if isinstance(m, mesh_mod.Mesh)
                      else mesh_mod.make_mesh(list(m)) for m in meshes]
            if len(meshes) != n_islands:
                raise ValueError(f"{len(meshes)} meshes for {n_islands} islands")
        self.meshes = meshes
        if cfg.n_dc % n_islands != 0:
            raise ValueError(
                f"n_dc={cfg.n_dc} must divide into {n_islands} islands"
            )
        per = cfg.n_dc // n_islands
        self.cfg = cfg
        self.n_islands = n_islands
        self.device = torch.device(device)
        self.islands: list[Federation] = []
        for k in range(n_islands):
            icfg = dataclasses.replace(
                cfg, n_dc=per, n_dc_total=cfg.n_dc, dc_offset=k * per
            )
            # Same seed everywhere: the WAN plant (sites, topology) must be
            # identical across replicas; LAN worlds differ because they are
            # planted per global DC (federation.py).
            mesh = None if meshes is None else meshes[k]
            isl = Federation(icfg, seed=seed, mesh=mesh, groups=groups,
                             device=device if mesh is None else mesh.devices[0],
                             kernel=kernel)
            # De-correlate per-tick protocol randomness between islands
            # (each replica is its own gossip universe between syncs).
            isl.gen.manual_seed(stream_seed(seed, _DRAWS, 1 + k))
            self.islands.append(isl)
        s = cfg.servers_per_dc
        # [n_wan] owning island of each WAN row (host).
        self._owner = torch.repeat_interleave(
            torch.arange(n_islands, dtype=torch.int64), per * s)
        self.link_policy = link_policy if link_policy is not None \
            else DEFAULT_LINK_POLICY
        self.sink = sink
        self._links = {
            (a, b): _LinkState()
            for a in range(n_islands) for b in range(n_islands) if a != b
        }
        self._faults: list[LinkFault] = []
        self._round = 0  # sync rounds elapsed: the link-layer clock

    # ------------------------------------------------------------------
    # Link fault envelope
    # ------------------------------------------------------------------
    def inject_link_faults(self, faults: Sequence[LinkFault]):
        """Arm a DCN fault schedule: each entry fails sends on one directed
        link for a sync-round window."""
        self._faults = list(faults)

    def _fault_kind(self, src: int, dst: int, rnd: int) -> Optional[str]:
        for f in self._faults:
            if f.src == src and f.dst == dst and f.start <= rnd < f.stop:
                return f.kind
        return None

    def _count(self, name: str, n: int = 1):
        if self.sink is not None and n:
            self.sink.incr_counter(name, n)

    def link_state(self, src: int, dst: int) -> _LinkState:
        """The directed link's retry machine (tests + bench probes)."""
        return self._links[(src, dst)]

    def _offer(self, src: int, dst: int, payload, ticks: int) -> list:
        """Run one sync round of the (src -> dst) link: enqueue the fresh
        payload, then either deliver the whole buffered queue (link up) or
        count the failure and back off. Returns the payloads to merge at
        dst, oldest first (empty while the link is down)."""
        pol, link, rnd = self.link_policy, self._links[(src, dst)], self._round
        link.queue.append(payload)
        if len(link.queue) > pol.queue_bound:
            # Drop-oldest: payloads supersede each other, so the newest
            # must survive, bounding memory across a long partition.
            dropped = len(link.queue) - pol.queue_bound
            del link.queue[:dropped]
            self._count("sim.dcn.retx_dropped", dropped)
        link.queue_peak = max(link.queue_peak, len(link.queue))

        if rnd < link.down_until:
            # Still backing off: down, not even attempting.
            self._count("sim.dcn.link_down_ticks", ticks)
            return []
        retrying = link.attempt > 0
        if retrying:
            self._count("sim.dcn.retries", 1)
        kind = self._fault_kind(src, dst, rnd)
        if kind is None:
            # Delivered: the link is (back) up; flush the buffer.
            if retrying:
                self._count("sim.dcn.heals", 1)
            link.attempt = 0
            link.degraded = False
            out, link.queue = link.queue, []
            return out
        # Failed send: classify, then bounded exponential backoff.
        if kind == "timeout":
            self._count("sim.dcn.send_timeouts", 1)
        link.attempt += 1
        if link.attempt >= pol.retry_max and not link.degraded:
            link.degraded = True
            self._count("sim.dcn.link_degraded", 1)
        backoff = min(pol.backoff_cap,
                      pol.backoff_base * (1 << min(link.attempt - 1, 16)))
        link.down_until = rnd + 1 + backoff + _jitter(src, dst, link.attempt)
        self._count("sim.dcn.link_down_ticks", ticks)
        return []

    # ------------------------------------------------------------------
    def _take_rows(self, dst: dict, src: dict, src_island: int) -> dict:
        """``dst`` with ``src_island``'s owned rows taken from ``src``, leaf
        by NAME: the tick counter stays dst's, every other leaf must be
        per row (a leaf that is not raises, never mis-broadcasts)."""
        owner = self._owner
        out = {}
        for name, a in dst.items():
            if name in _SCALAR_LEAVES:
                out[name] = a
                continue
            if a.dim() == 0 or a.shape[0] != owner.shape[0]:
                raise ValueError(
                    f"per-row WAN leaf {name} with shape {tuple(a.shape)}, "
                    f"expected a leading dim of {owner.shape[0]}")
            m = (owner == src_island).reshape((-1,) + (1,) * (a.dim() - 1))
            # Select on the raw bits: the copy is exact for every dtype.
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
            out[name] = torch.where(m, src[name].view(bits), a.view(bits)).view(a.dtype)
        return out

    def sync(self, ticks: int = 1):
        """One DCN reconciliation round: every island receives, over its
        per-source links, the other islands' owned WAN rows wholesale;
        links that are faulted or backing off deliver nothing this round
        and their payloads buffer in the retransmit queue instead. One
        device -> host pull and one host -> device push per island.
        ``ticks`` is how many LAN ticks this round represents (the run
        loop passes its sync cadence, so ``sim.dcn.link_down_ticks``
        counts modeled time)."""
        tr = obs_trace.get_tracer()
        t0_us = tr.now_us()
        wans = [_pull(isl.state.wan) for isl in self.islands]
        for d, isl in enumerate(self.islands):
            merged = wans[d]
            for s in range(self.n_islands):
                if s == d:
                    continue
                for payload in self._offer(s, d, wans[s], ticks):
                    # Oldest first: a newer payload supersedes an older one
                    # row for row.
                    merged = self._take_rows(merged, payload, s)
            wan = _push(merged, isl.state.wan, isl.device)
            isl.state = isl.state._replace(wan=wan)
        self._round += 1
        # Explicit timing, so the round rides along as an arg (retry and
        # backoff rounds show as consecutive dcn.sync spans).
        tr.complete("dcn.sync", t0_us, tr.now_us() - t0_us, cat="dcn",
                    args={"round": self._round, "ticks": int(ticks)})

    def run(self, lan_ticks: int, sync_every: int = 16, chunk: int = 16):
        """Advance all islands ``lan_ticks`` LAN ticks, reconciling the WAN
        tier every ``sync_every`` ticks (the DCN cadence; 16 ticks = 3.2 s
        of protocol time at the 200 ms LAN tick). ``chunk`` is accepted
        only to match the reference's signature (see ``Federation.run``)."""
        remaining = lan_ticks
        while remaining > 0:
            c = min(sync_every, remaining)
            for isl in self.islands:
                isl.run(c)
            self.sync(ticks=c)
            remaining -= c

    # ------------------------------------------------------------------
    def replicas_agree(self) -> bool:
        """True when every island's WAN replica is identical, bit for bit:
        what a clean (all links delivered) sync round guarantees, and the
        convergence probe a healed partition must pass."""
        wans = [_pull(isl.state.wan) for isl in self.islands]
        return all(torch.equal(a.reshape(-1).view(torch.uint8),
                               w[name].reshape(-1).view(torch.uint8))
                   for w in wans[1:] for name, a in wans[0].items())

    def queue_peak(self) -> int:
        """High-water retransmit-queue depth across all links (never above
        ``LinkPolicy.queue_bound``)."""
        return max((l.queue_peak for l in self._links.values()), default=0)

    # ------------------------------------------------------------------
    def island_of_dc(self, dc: int) -> tuple[Federation, int]:
        """(owning island, local dc index) for a global DC index."""
        per = self.cfg.n_dc // self.n_islands
        return self.islands[dc // per], dc % per

    def kill(self, dc: int, mask):
        isl, local = self.island_of_dc(dc)
        isl.kill(local, mask)

    def wan_status_seen_by(self, observer_dc: int, subject_dc: int,
                           observer_server: int = 0) -> list[str]:
        """How ``observer_dc``'s server sees ``subject_dc``'s servers, read
        from the OBSERVER's island replica. Columns the observer's partial
        view does not track report "untracked"."""
        isl, _ = self.island_of_dc(observer_dc)
        s = self.cfg.servers_per_dc
        out = {}
        for m in isl.wan_members_seen_by(observer_dc, observer_server):
            if m["dc"] == f"dc{subject_dc}":
                srv = int(m["id"].split(".")[0][3:])
                out[srv] = m["status"]
        return [out.get(k, "untracked") for k in range(s)]
