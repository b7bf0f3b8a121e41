"""SimState: the whole simulated cluster as one struct of tensors (PyTorch
port of ``consul_tpu/models/state.py``).

The same fields as the reference. Integer fields are int64 tensors in the
working set: keys and accuser bitmasks use all 32 bits, and CPU PyTorch
has no max, shift or select on uint32, so int64 holds the uint32 values
exactly. ``t`` is a [] int64 tensor on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.ops import merge, scaling, vivaldi


class SimState(NamedTuple):
    t: torch.Tensor              # [] int64, global tick counter
    alive_truth: torch.Tensor    # [N] bool — process actually up
    left: torch.Tensor           # [N] bool — gracefully departed
    leaving: torch.Tensor        # [N] bool — leave intent, no refutation
    external: torch.Tensor       # [N] bool — transport-bridge seats
    own_inc: torch.Tensor        # [N] int64 (uint32 values)
    own_tx: torch.Tensor         # [N] int64 — own-fact transmits remaining
    awareness: torch.Tensor      # [N] int64, 0..awareness_max-1
    probe_perm: torch.Tensor     # [N, K] int64, shuffled probe order
    probe_ptr: torch.Tensor      # [N] int64, cursor into probe_perm
    next_probe_tick: torch.Tensor    # [N] int64
    pending_col: torch.Tensor        # [N] int64, -1 = no outstanding probe
    pending_fail_tick: torch.Tensor  # [N] int64
    pending_nack_miss: torch.Tensor  # [N] int64
    view_key: torch.Tensor       # [N, K] int64 (uint32 keys)
    susp_start: torch.Tensor     # [N, K] int64, -1 = none
    susp_seen: torch.Tensor      # [N, K] int64 (uint32 accuser bitmask)
    tx_left: torch.Tensor        # [N, K] int64 — gossip transmits remaining
    viv: vivaldi.VivaldiState    # batched [N]
    lat_buf: torch.Tensor        # [N, K, S] float32 per-peer RTT samples
    lat_cnt: torch.Tensor        # [N, K] int64 samples pushed


def own_key(state: SimState) -> torch.Tensor:
    """Each node's own-fact payload: alive at its incarnation, or a leave
    intent once leaving/left."""
    status = torch.where(state.leaving | state.left,
                         torch.full_like(state.own_inc, merge.LEFT),
                         torch.full_like(state.own_inc, merge.ALIVE))
    return merge.make_key(state.own_inc, status)


def init(cfg: SimConfig, gen: torch.Generator, device="cpu") -> SimState:
    """A formed cluster at steady state: every node knows every neighbor
    alive at incarnation 1, coordinates at the origin, nothing queued.
    The probe order is a stable argsort of uniforms, as the reference's."""
    n, k_deg = cfg.n, cfg.degree
    i64 = dict(dtype=torch.int64, device=device)
    u = torch.rand((n, k_deg), generator=gen, device=device)
    perm = torch.argsort(u, dim=1, stable=True)
    probe_period = cfg.gossip.probe_period_ticks
    return SimState(
        t=torch.zeros((), **i64),
        alive_truth=torch.ones((n,), dtype=torch.bool, device=device),
        left=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        external=torch.zeros((n,), dtype=torch.bool, device=device),
        own_inc=torch.ones((n,), **i64),
        own_tx=torch.zeros((n,), **i64),
        awareness=torch.zeros((n,), **i64),
        probe_perm=perm,
        probe_ptr=torch.zeros((n,), **i64),
        next_probe_tick=torch.randint(0, probe_period, (n,), generator=gen,
                                      **i64),
        pending_col=torch.full((n,), -1, **i64),
        pending_fail_tick=torch.zeros((n,), **i64),
        pending_nack_miss=torch.zeros((n,), **i64),
        view_key=torch.full((n, k_deg), merge.make_key_int(1, merge.ALIVE),
                            **i64),
        susp_start=torch.full((n, k_deg), -1, **i64),
        susp_seen=torch.zeros((n, k_deg), **i64),
        tx_left=torch.zeros((n, k_deg), **i64),
        viv=vivaldi.new(cfg.vivaldi, batch_shape=(n,), device=device),
        lat_buf=torch.zeros((n, k_deg, cfg.vivaldi.latency_filter_size),
                            dtype=torch.float32, device=device),
        lat_cnt=torch.zeros((n, k_deg), **i64),
    )


def kill(state: SimState, mask: torch.Tensor) -> SimState:
    """Hard-kill the masked nodes."""
    return state._replace(alive_truth=state.alive_truth & ~mask)


def revive(cfg: SimConfig, state: SimState, mask: torch.Tensor,
           cold: bool = False, join_seeds: int = 3) -> SimState:
    """Restart the masked nodes with a bumped incarnation and an armed
    own-fact announcement. ``cold=True`` also forgets their views: every
    entry drops to UNKNOWN except ``join_seeds`` seed columns believed
    (0, ALIVE) (reference serf/snapshot.go, memberlist.go:206-228)."""
    own_inc = torch.where(mask, (state.own_inc + 1) & 0xFFFFFFFF, state.own_inc)
    tx0 = int(scaling.retransmit_limit(cfg.gossip.retransmit_mult, cfg.n))
    if cfg.view_degree:
        tx0 = max(tx0, cfg.degree)
    state = state._replace(
        alive_truth=state.alive_truth | mask,
        left=state.left & ~mask,
        leaving=state.leaving & ~mask,
        own_inc=own_inc,
        own_tx=torch.where(mask, torch.full_like(state.own_tx, tx0),
                           state.own_tx),
    )
    if cold:
        k_deg = state.view_key.shape[1]
        cols = torch.arange(k_deg, dtype=torch.int64, device=mask.device)
        unknown = merge.make_key_int(0, merge.DEAD)
        if join_seeds <= 0:
            seeded = torch.full_like(cols, unknown)
        else:
            stride = max(1, k_deg // min(join_seeds, k_deg))
            seeded = torch.where((cols % stride) == 0,
                                 torch.full_like(cols, merge.make_key_int(0, merge.ALIVE)),
                                 torch.full_like(cols, unknown))
        m = mask[:, None]
        zero = torch.zeros_like(state.susp_seen)
        state = state._replace(
            view_key=torch.where(m, seeded[None, :], state.view_key),
            susp_start=torch.where(m, -torch.ones_like(state.susp_start),
                                   state.susp_start),
            susp_seen=torch.where(m, zero, state.susp_seen),
            tx_left=torch.where(m, zero, state.tx_left),
            lat_cnt=torch.where(m, zero, state.lat_cnt),
        )
    return state
