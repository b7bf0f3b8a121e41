"""Gossip counters: the per-tick protocol event tallies (PyTorch port of
``consul_tpu/models/counters.py``).

The same 26 fields in the same wire order as the reference, each a []
int32 tensor per tick (and per chunk once summed). The SWIM, serf, chaos
and sentinel fields are filled; ``writes_applied`` (the serving plane)
stays zero. The host folds chunk totals into Python ints, so
cumulative totals never wrap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GossipCounters(NamedTuple):
    """Per-tick (or per-chunk) protocol event tallies, all [] int32.
    Field order is the wire order of the stacked [26] vector."""

    probes_sent: torch.Tensor
    acks_received: torch.Tensor
    nacks_received: torch.Tensor
    probe_timeouts: torch.Tensor
    suspicions_started: torch.Tensor
    refutations: torch.Tensor
    deaths_declared: torch.Tensor
    gossip_tx: torch.Tensor
    gossip_rx: torch.Tensor
    gossip_msgs_tx: torch.Tensor
    pushpull_merges: torch.Tensor
    serf_intents_queued: torch.Tensor
    serf_intents_retx: torch.Tensor
    serf_intents_dropped: torch.Tensor
    chaos_fault_ticks: torch.Tensor
    chaos_first_suspect_wait: torch.Tensor
    chaos_confirm_wait: torch.Tensor
    chaos_heal_wait: torch.Tensor
    chaos_false_deaths: torch.Tensor
    chaos_msgs_dropped: torch.Tensor
    sentinel_range: torch.Tensor
    sentinel_monotonic: torch.Tensor
    sentinel_suspicion: torch.Tensor
    sentinel_nonfinite_coord: torch.Tensor
    sentinel_nonfinite_rtt: torch.Tensor
    writes_applied: torch.Tensor


FIELDS = GossipCounters._fields

# Sink names each counter folds into at the chunk boundary
# (telemetry.emit_counter_deltas): the reference's names, field for field.
METRIC_NAMES = {
    "probes_sent": "memberlist.probeNode",
    "acks_received": "sim.probe.acks",
    "nacks_received": "sim.probe.nacks",
    "probe_timeouts": "sim.probe.timeouts",
    "suspicions_started": "memberlist.msg.suspect",
    "refutations": "memberlist.msg.alive",
    "deaths_declared": "memberlist.msg.dead",
    "gossip_tx": "memberlist.udp.sent",
    "gossip_rx": "memberlist.udp.received",
    "gossip_msgs_tx": "sim.gossip.msgs_sent",
    "pushpull_merges": "memberlist.pushPullNode",
    "serf_intents_queued": "serf.events",
    "serf_intents_retx": "sim.serf.event_retransmits",
    "serf_intents_dropped": "sim.serf.event_drops",
    "chaos_fault_ticks": "sim.chaos.fault_ticks",
    "chaos_first_suspect_wait": "sim.chaos.time_to_first_suspect",
    "chaos_confirm_wait": "sim.chaos.time_to_confirm",
    "chaos_heal_wait": "sim.chaos.time_to_heal",
    "chaos_false_deaths": "sim.chaos.false_positive_deaths",
    "chaos_msgs_dropped": "sim.chaos.messages_dropped",
    "sentinel_range": "sim.sentinel.range_violations",
    "sentinel_monotonic": "sim.sentinel.monotonicity_violations",
    "sentinel_suspicion": "sim.sentinel.suspicion_violations",
    "sentinel_nonfinite_coord": "sim.sentinel.nonfinite_coordinates",
    "sentinel_nonfinite_rtt": "sim.sentinel.nonfinite_rtt",
    "writes_applied": "sim.serving.writes_applied",
}
assert set(METRIC_NAMES) == set(FIELDS)

# The invariant-sentinel fields, in bitmask order: bit i of the violation
# mask (violation_mask) is SENTINEL_FIELDS[i].
SENTINEL_FIELDS = tuple(f for f in FIELDS if f.startswith("sentinel_"))


def violation_mask(deltas: dict) -> int:
    """Fold a counter-delta dict into the sentinel violation bitmask: bit
    i set iff SENTINEL_FIELDS[i] saw a nonzero tally."""
    mask = 0
    for i, f in enumerate(SENTINEL_FIELDS):
        if deltas.get(f, 0):
            mask |= 1 << i
    return mask


def zeros(device="cpu") -> GossipCounters:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return GossipCounters(*([z] * len(FIELDS)))


def count(mask) -> torch.Tensor:
    """Sum a bool mask of any shape down to one [] int32."""
    return torch.sum(mask).to(torch.int32)


def add(a: GossipCounters, b: GossipCounters) -> GossipCounters:
    return GossipCounters(*(x + y for x, y in zip(a, b)))


def stack(c: GossipCounters) -> torch.Tensor:
    """[len(FIELDS)] int32, the single batched transfer shape."""
    return torch.stack(list(c))


def unstack(vec) -> GossipCounters:
    return GossipCounters(*(vec[i] for i in range(len(FIELDS))))
