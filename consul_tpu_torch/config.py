"""Protocol configuration for the simulated gossip fabric (PyTorch port).

A copy of the JAX package's ``consul_tpu/config.py`` dataclasses, with
the same fields and defaults, so a test can build both configs from the
same keyword arguments. The port keeps its own copy instead of importing
the reference. ``RaftConfig`` belongs to a later slice and is left out.

The knob names and default values mirror the reference so published
Serf/Consul timing defaults transfer 1:1:
  - memberlist LAN/WAN/Local profiles:
      reference vendor/github.com/hashicorp/memberlist/config.go:231-300
  - Vivaldi tuning factors:
      reference vendor/github.com/hashicorp/serf/coordinate/config.go:59-70

Wall-clock intervals are mapped onto a single global tick cadence
(``tick_ms``, default 200 ms = the LAN gossip interval): gossip fires every
tick, probes every ``probe_interval_ms / tick_ms`` ticks, push-pull every
``push_pull_interval_ms / tick_ms`` ticks scaled by ``push_pull_scale(n)``.
"""

from __future__ import annotations

import dataclasses
import math


def to_ticks(ms: float, tick_ms: float) -> int:
    """Convert a wall-clock interval to whole ticks (minimum 1).

    Rounds up so a quantized interval is never shorter than specified —
    a probe timeout of 500 ms on a 200 ms tick must wait 3 ticks, not 2.
    """
    return max(1, math.ceil(ms / tick_ms))


_ticks = to_ticks  # internal alias used by the config properties below


def clamp_view_degree(n: int, view_degree: int) -> int:
    """Clamp a requested partial-view degree to a valid value for ``n``.

    The sparse view is a symmetric circulant: every offset ``d`` pairs
    with ``n - d``, so a sparse degree must be even (ops/topology.py
    rejects odd degrees at build time). An explicit odd request is an
    error — silently rounding a user's choice would hide a config typo —
    but the *cap* at ``n - 2`` rounds down to the nearest even value so
    small clusters under a wide default (e.g. n=17 with view_degree=16)
    still build. 0 always means the complete graph.
    """
    if view_degree < 0:
        raise ValueError(f"view_degree must be >= 0, got {view_degree}")
    if view_degree == 0:
        return 0
    if view_degree % 2 != 0:
        raise ValueError(
            f"view_degree must be even: the sparse view pairs every "
            f"offset d with n-d (symmetric circulant, ops/topology.py), "
            f"got {view_degree} — use {view_degree - 1} or "
            f"{view_degree + 1}")
    if view_degree >= n - 1:
        return view_degree  # SimConfig.degree falls back to dense
    capped = min(view_degree, n - 2)
    if capped % 2 != 0:
        capped -= 1
    return max(capped, 0)


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """SWIM / gossip protocol knobs (reference memberlist/config.go).

    All ``*_ms`` values are wall-clock milliseconds in the simulated
    cluster's frame; the tick mapping derives integer tick counts.
    """

    # -- time base ---------------------------------------------------------
    tick_ms: int = 200

    # -- failure detector (reference config.go:241-249) --------------------
    probe_interval_ms: int = 1000
    probe_timeout_ms: int = 500
    indirect_checks: int = 3
    awareness_max: int = 8

    # -- suspicion (Lifeguard; reference config.go:243-244) ----------------
    suspicion_mult: int = 4
    suspicion_max_timeout_mult: int = 6

    # -- dissemination (reference config.go:242,251-253) -------------------
    retransmit_mult: int = 4
    gossip_interval_ms: int = 200
    gossip_nodes: int = 3
    gossip_to_the_dead_ms: int = 30_000

    # -- anti-entropy (reference config.go:245) ----------------------------
    push_pull_interval_ms: int = 30_000

    # -- vectorization capacity knobs (no reference analogue; these bound
    #    the fixed-shape replacements for Go's unbounded structures) -------
    # Per-node broadcast queue slots (replaces the btree
    # TransmitLimitedQueue, reference memberlist/queue.go:14-28).
    queue_slots: int = 8
    # Messages piggybacked per gossip send (models the 1400-byte UDP
    # budget, reference memberlist/state.go:541 / config.go:265).
    piggyback_msgs: int = 3

    # ---------------------------------------------------------------------
    @classmethod
    def lan(cls, **overrides) -> "GossipConfig":
        """Reference DefaultLANConfig (memberlist/config.go:231-267)."""
        return cls(**overrides)

    @classmethod
    def wan(cls, **overrides) -> "GossipConfig":
        """Reference DefaultWANConfig (memberlist/config.go:272-283)."""
        kw = dict(
            tick_ms=500,
            suspicion_mult=6,
            push_pull_interval_ms=60_000,
            probe_timeout_ms=3_000,
            probe_interval_ms=5_000,
            gossip_nodes=4,
            gossip_interval_ms=500,
            gossip_to_the_dead_ms=60_000,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def local(cls, **overrides) -> "GossipConfig":
        """Reference DefaultLocalConfig (memberlist/config.go:288-300)."""
        kw = dict(
            tick_ms=100,
            indirect_checks=1,
            retransmit_mult=2,
            suspicion_mult=3,
            push_pull_interval_ms=15_000,
            probe_timeout_ms=200,
            probe_interval_ms=1000,
            gossip_interval_ms=100,
            gossip_to_the_dead_ms=15_000,
        )
        kw.update(overrides)
        return cls(**kw)

    # -- derived tick counts ----------------------------------------------
    @property
    def probe_period_ticks(self) -> int:
        return _ticks(self.probe_interval_ms, self.tick_ms)

    @property
    def probe_timeout_ticks(self) -> int:
        return _ticks(self.probe_timeout_ms, self.tick_ms)

    @property
    def gossip_period_ticks(self) -> int:
        return _ticks(self.gossip_interval_ms, self.tick_ms)

    @property
    def gossip_to_the_dead_ticks(self) -> int:
        return _ticks(self.gossip_to_the_dead_ms, self.tick_ms)

    def push_pull_period_ticks(self, n: int) -> int:
        """Push-pull cadence scaled by cluster size.

        Mirrors pushPullScale (reference memberlist/util.go:89-97): the
        interval multiplies by ceil(log2(n) - log2(32)) + 1 above 32 nodes.
        """
        from consul_tpu_torch.ops import scaling

        base = _ticks(self.push_pull_interval_ms, self.tick_ms)
        return base * int(scaling.push_pull_scale(n))


@dataclasses.dataclass(frozen=True)
class SerfConfig:
    """Serf-layer knobs (reference serf/config.go:246-289, lib/serf.go).

    The fixed-capacity ``*_slots``/``*_ring`` sizes replace Go's unbounded
    per-node queues and buffers (eventBroadcasts / recent-event buffers,
    reference serf/serf.go + delegate.go:19-282) with static shapes.
    """

    # Per-node user-event/query broadcast queue slots (replaces the
    # serf event TransmitLimitedQueue, serf/serf.go eventBroadcasts).
    event_queue_slots: int = 8
    # Events piggybacked per gossip send (models the UDP byte budget
    # split across the serf queues, serf/delegate.go GetBroadcasts).
    piggyback_events: int = 2
    # Recent-event dedup buffer per node, in **Lamport-time buckets**
    # (reference buffers the last EventBuffer=512 ltimes keyed by
    # ``ltime % size``, serf/serf.go:1258-1357 + config.go:158). Events
    # older than the window are rejected as stale, never redelivered.
    seen_ring: int = 16
    # Distinct origins remembered per Lamport-time bucket (the reference
    # keeps an unbounded per-ltime name list; this is the fixed-shape
    # bound — >width concurrent same-ltime events per bucket drop).
    seen_width: int = 4
    # Dynamic queue-depth limit knobs (reference serf/serf.go:1612-1648
    # getQueueMax/checkQueueDepth; Consul raises MinQueueDepth to 4096,
    # reference lib/serf.go:26-28). The scaled limit max(2N, min) bounds
    # *host-side* queues (the seam buffers of
    # consul_tpu_torch/wire/bridge.py); the warning threshold feeds the
    # serf.queue.* telemetry samples.
    min_queue_depth: int = 4096
    max_queue_depth: int = 0
    # The reference warns when one node's queue holds 128 messages; the
    # sim's per-node capacity is event_queue_slots, so the effective
    # warning level is min(this, event_queue_slots) — a full queue warns.
    queue_depth_warning: int = 128
    # Query response timeout multiplier (reference serf/config.go
    # QueryTimeoutMult=16; timeout = mult * log10(N+1) * gossip_interval,
    # serf/serf.go DefaultQueryTimeout).
    query_timeout_mult: int = 16
    # Concurrent outstanding queries per origin (the reference keeps
    # per-query QueryResponse state, serf/query.go — unbounded; this is
    # the fixed-shape bound. A query opened past the cap evicts the
    # origin's oldest-deadline slot).
    query_slots: int = 4
    # Duplicate query responses relayed through this many other members
    # for redundancy under packet loss (reference QueryParam.RelayFactor,
    # serf/query.go:31-33, relayResponse serf.go:244-...; default 0).
    query_relay_factor: int = 0
    # Failed members are remembered (and eligible for reconnect) this
    # long before being reaped from member lists (reference
    # serf/config.go:277 ReconnectTimeout=24h).
    reconnect_timeout_ms: int = 24 * 3600 * 1000
    # Left members linger this long before reaping (reference
    # serf/config.go TombstoneTimeout=24h).
    tombstone_timeout_ms: int = 24 * 3600 * 1000
    # A leaving node keeps gossiping this long so its leave intent
    # propagates before it goes quiet (reference lib/serf.go:21-25
    # LeavePropagateDelay=3s, sized for >99.99% of 100k nodes).
    leave_propagate_delay_ms: int = 3000


@dataclasses.dataclass(frozen=True)
class VivaldiConfig:
    """Vivaldi coordinate tuning (reference serf/coordinate/config.go:59-70)."""

    dimensionality: int = 8
    vivaldi_error_max: float = 1.5
    vivaldi_ce: float = 0.25
    vivaldi_cc: float = 0.25
    adjustment_window_size: int = 20
    height_min: float = 10.0e-6
    latency_filter_size: int = 3
    gravity_rho: float = 150.0


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Device raft tier shape (models/raft.py + ops/raft_ops.py): R
    independent ``groups`` of ``peers`` voters each, stepped as [R, P]
    tensors after every gossip tick. Frozen and hashable; ``None`` on a
    simulation is raft off.

    Timing constants default to the reference host tier's
    (server/raft.py HEARTBEAT_TICKS / ELECTION_TICKS_MIN /
    ELECTION_TICKS_MAX). ``window`` is the bounded on-device log: at most
    ``window`` entries per group per run (no InstallSnapshot)."""

    groups: int = 4
    peers: int = 5
    window: int = 32
    heartbeat_ticks: int = 2
    election_ticks_min: int = 10
    election_ticks_max: int = 20

    def __post_init__(self):
        if self.groups < 1:
            raise ValueError(f"raft groups must be >= 1, got {self.groups}")
        if self.peers < 1:
            raise ValueError(f"raft peers must be >= 1, got {self.peers}")
        if self.window < 2:
            raise ValueError(f"raft window must be >= 2, got {self.window}")
        if self.heartbeat_ticks < 1:
            raise ValueError("raft heartbeat_ticks must be >= 1")
        if not (self.heartbeat_ticks < self.election_ticks_min
                <= self.election_ticks_max):
            raise ValueError(
                "need heartbeat_ticks < election_ticks_min <= "
                "election_ticks_max, got "
                f"{self.heartbeat_ticks}/{self.election_ticks_min}/"
                f"{self.election_ticks_max}")

    @property
    def quorum(self) -> int:
        return self.peers // 2 + 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level simulation parameters for one simulated datacenter."""

    n: int = 1024                      # number of simulated nodes
    gossip: GossipConfig = dataclasses.field(default_factory=GossipConfig)
    vivaldi: VivaldiConfig = dataclasses.field(default_factory=VivaldiConfig)
    serf: SerfConfig = dataclasses.field(default_factory=SerfConfig)

    # Partial-view degree: each node maintains membership views of at most
    # ``view_degree`` neighbors. 0 means the complete graph (each node
    # views every other node, like a real memberlist member map — only
    # feasible for small n; the >=100k configs must bound this).
    view_degree: int = 0

    # Sparse-view graph family (consul_tpu/topo/families.py registry).
    # Every family emits a symmetric circulant offset set, so the
    # roll-based delivery machinery is family-independent; "circulant"
    # reproduces the original sampling bit-for-bit. Ignored when the
    # view is dense (view_degree == 0).
    topo_family: str = "circulant"
    # One per-family shape parameter; 0.0 selects the family default
    # (smallworld: rewire probability 0.2, hier: 8 datacenters,
    # expander: 32 candidate draws). circulant ignores it.
    topo_param: float = 0.0

    # Ground-truth latency model: nodes are planted in a Vivaldi-style
    # space; RTT(i,j) = euclidean distance + per-node access-link height,
    # plus lognormal jitter. Units: milliseconds.
    world_diameter_ms: float = 50.0    # spread of planted coordinates
    world_dims: int = 3                # intrinsic dimensionality of truth
    height_ms_min: float = 0.1
    height_ms_max: float = 2.0
    rtt_jitter_frac: float = 0.05      # lognormal sigma on each sample
    packet_loss: float = 0.0           # iid drop probability per message

    @property
    def degree(self) -> int:
        """Effective neighbor-table width K (N-1 for complete graph).
        A configured partial view at least as wide as the cluster falls
        back to the complete graph — a 20-server WAN pool under the
        LAN's view_degree=32 tracks everyone, like the reference's
        member map would."""
        if self.view_degree == 0 or self.view_degree >= self.n - 1:
            return self.n - 1
        return self.view_degree
