"""Convergence and accuracy metrics (PyTorch port of
``consul_tpu/utils/metrics.py``): membership agreement over every (live
observer, neighbor) edge, and Vivaldi RMSE against the planted ground
truth.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.config import SimConfig
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
    active = state.alive_truth & ~state.left
    st = merge.key_status(state.view_key)
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
    ok = (i != j) & state.alive_truth[i] & state.alive_truth[j]
    v = state.viv
    est = vivaldi.distance(v.vec[i], v.height[i], v.adjustment[i],
                           v.vec[j], v.height[j], v.adjustment[j])
    err = torch.where(ok, est - topology.true_rtt(world, i, j),
                      torch.zeros_like(est))
    denom = torch.clamp(torch.sum(ok), min=1)
    return torch.sqrt(torch.sum(err * err) / denom)


def rmse_samples(cfg: SimConfig, gen: torch.Generator, samples: int, device):
    """Uniform random pair indices for :func:`vivaldi_rmse`."""
    i = torch.randint(0, cfg.n, (samples,), generator=gen, device=device)
    j = torch.randint(0, cfg.n, (samples,), generator=gen, device=device)
    return i, j
