"""Convergence and accuracy metrics (PyTorch port of
``consul_tpu/utils/metrics.py``): membership agreement over every (live
observer, neighbor) edge, and Vivaldi RMSE against the planted ground
truth.

:func:`health_packed` and :func:`vivaldi_rmse_packed` compute the same
values from a ``PackedSimState`` without unpacking it: a cell's status is
``meta & 3``, a node's liveness its flag bits, and the coordinates are
read as bfloat16 at the sampled rows only and widened to float32 (exact,
as ``layout.unpack`` widens them). They equal :func:`health` and
:func:`vivaldi_rmse` of the unpacked state bit for bit, and are the plain
version of the CUDA metrics launch (``cuda_gossip.MetricsKernel``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models.layout import PackedSimState
from consul_tpu_torch.models.state import SimState
from consul_tpu_torch.ops import merge, topology, vivaldi
from consul_tpu_torch.ops.topology import World


class HealthMetrics(NamedTuple):
    agreement: torch.Tensor       # [] f32
    false_positive: torch.Tensor  # [] f32
    undetected: torch.Tensor      # [] f32
    live_nodes: torch.Tensor      # [] int64


def health(cfg: SimConfig, topo, state: SimState) -> HealthMetrics:
    """Membership-agreement metrics over every (live observer, neighbor)
    edge. Suspect counts as disagreement for convergence, not as a false
    positive."""
    return _health(topo, state.alive_truth & ~state.left,
                   merge.key_status(state.view_key))


def health_packed(cfg: SimConfig, topo, packed: PackedSimState) -> HealthMetrics:
    """:func:`health` of ``layout.unpack(packed)``, from the packed leaves:
    statuses from ``meta & 3``, liveness from the flag bits."""
    flags = packed.flags
    active = ((flags & 1) != 0) & ((flags & 2) == 0)
    return _health(topo, active, packed.meta.to(torch.int32) & (merge.N_STATUS - 1))


def _health(topo, active, st) -> HealthMetrics:
    subj_up = topology.gather_cols(topo, active)
    believed_up = st == merge.ALIVE
    believed_down = (st == merge.DEAD) | (st == merge.LEFT)
    obs = active[:, None].expand_as(st)
    edges = torch.clamp(torch.sum(obs), min=1)
    agree = obs & ((subj_up & believed_up) | (~subj_up & believed_down))
    fp = obs & subj_up & believed_down
    und = obs & ~subj_up & believed_up
    return HealthMetrics(
        agreement=torch.sum(agree) / edges,
        false_positive=torch.sum(fp) / edges,
        undetected=torch.sum(und) / edges,
        live_nodes=torch.sum(active),
    )


def vivaldi_rmse(cfg: SimConfig, world: World, state: SimState,
                 i: torch.Tensor, j: torch.Tensor):
    """RMSE of estimated vs true RTT over the sampled pairs (i[s], j[s]),
    live pairs only, in seconds. The sample indices are arguments so a
    caller can pass any sampler's draws."""
    v = state.viv
    return _rmse(world, state.alive_truth, i, j,
                 (v.vec[i], v.height[i], v.adjustment[i]),
                 (v.vec[j], v.height[j], v.adjustment[j]))


def vivaldi_rmse_packed(cfg: SimConfig, world: World, packed: PackedSimState,
                        i: torch.Tensor, j: torch.Tensor):
    """:func:`vivaldi_rmse` of ``layout.unpack(packed)``: the bfloat16
    coordinates of the sampled rows only, widened to float32."""
    v = packed.viv

    def coords(x):
        return tuple(leaf[x].to(torch.float32)
                     for leaf in (v.vec, v.height, v.adjustment))
    return _rmse(world, (packed.flags & 1) != 0, i, j, coords(i), coords(j))


def _rmse(world, alive, i, j, coords_i, coords_j):
    ok = (i != j) & alive[i] & alive[j]
    est = vivaldi.distance(*coords_i, *coords_j)
    err = torch.where(ok, est - topology.true_rtt(world, i, j),
                      torch.zeros_like(est))
    denom = torch.clamp(torch.sum(ok), min=1)
    return torch.sqrt(torch.sum(err * err) / denom)


def rmse_samples(cfg: SimConfig, gen: torch.Generator, samples: int, device):
    """Uniform random pair indices for :func:`vivaldi_rmse`."""
    i = torch.randint(0, cfg.n, (samples,), generator=gen, device=device)
    j = torch.randint(0, cfg.n, (samples,), generator=gen, device=device)
    return i, j
