"""Vectorized Vivaldi network coordinates (PyTorch port of
``consul_tpu/ops/vivaldi.py``).

The reference's per-observation serial update (reference
serf/coordinate/client.go:145-234, coordinate.go:104-203) as batched
float32 tensor functions, in the reference's operation order. Distances
and RTTs are in seconds. The coincident-point fallback directions always
enter as explicit tensors (``fallback_rnd``): the port draws every random
number outside the update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.config import VivaldiConfig

ZERO_THRESHOLD = 1.0e-6
# RTT observations above this are rejected (reference client.go:216-219).
MAX_RTT_SECONDS = 10.0


class VivaldiState(NamedTuple):
    """Struct-of-arrays Vivaldi client state; leading dims are batch dims."""

    vec: torch.Tensor          # [..., D] float32
    height: torch.Tensor       # [...]    float32
    error: torch.Tensor        # [...]    float32
    adjustment: torch.Tensor   # [...]    float32
    adj_samples: torch.Tensor  # [..., W] float32
    adj_idx: torch.Tensor      # [...]    int64
    resets: torch.Tensor       # [...]    int64


def new(cfg: VivaldiConfig, batch_shape=(), device="cpu") -> VivaldiState:
    """Fresh origin coordinates (reference coordinate.go:54-61)."""
    shape = tuple(batch_shape)
    f32 = dict(dtype=torch.float32, device=device)
    return VivaldiState(
        vec=torch.zeros(shape + (cfg.dimensionality,), **f32),
        height=torch.full(shape, cfg.height_min, **f32),
        error=torch.full(shape, cfg.vivaldi_error_max, **f32),
        adjustment=torch.zeros(shape, **f32),
        adj_samples=torch.zeros(shape + (cfg.adjustment_window_size,), **f32),
        adj_idx=torch.zeros(shape, dtype=torch.int64, device=device),
        resets=torch.zeros(shape, dtype=torch.int64, device=device),
    )


def fold_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the last axis as a left fold from 0, ``((0 + x0) + x1) +
    ...``: the order the CUDA tick kernel adds in. A library reduction
    picks its own order, and a last-bit difference can flip a packed
    rounding."""
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc[..., None] if keepdim else acc


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as ``sqrt(sum(x * x))``, the
    reference's formulation of ``jnp.linalg.norm``."""
    return torch.sqrt(fold_sum(x * x, keepdim=keepdim))


def raw_distance(vec_a, height_a, vec_b, height_b):
    """Vivaldi distance without adjustments (reference coordinate.go:137-139)."""
    return norm(vec_a - vec_b) + height_a + height_b


def distance(vec_a, height_a, adj_a, vec_b, height_b, adj_b):
    """Distance with the adjustment offsets, used only while positive
    (reference coordinate.go:121-132)."""
    dist = raw_distance(vec_a, height_a, vec_b, height_b)
    adjusted = dist + adj_a + adj_b
    return torch.where(adjusted > 0.0, adjusted, dist)


def _unit_vector_at(vec_a, vec_b, rnd):
    """Unit vector at ``vec_a`` from ``vec_b`` plus the distance; coincident
    points take the fallback direction ``rnd`` (then e0) and report 0."""
    d = vec_a - vec_b
    mag = norm(d, keepdim=True)
    rnd_mag = norm(rnd, keepdim=True)
    e0 = torch.zeros_like(d)
    e0[..., 0] = 1.0
    use_real = mag > ZERO_THRESHOLD
    use_rnd = rnd_mag > ZERO_THRESHOLD
    one = torch.ones_like(mag)
    unit = torch.where(
        use_real,
        d / torch.where(use_real, mag, one),
        torch.where(use_rnd, rnd / torch.where(use_rnd, rnd_mag, one), e0),
    )
    return unit, torch.where(use_real[..., 0], mag[..., 0],
                             torch.zeros_like(mag[..., 0]))


def apply_force(cfg: VivaldiConfig, vec, height, force, other_vec,
                other_height, rnd):
    """Move along the unit direction from ``other`` (reference
    coordinate.go:104-117)."""
    unit, mag = _unit_vector_at(vec, other_vec, rnd)
    new_vec = vec + unit * force[..., None]
    moved = mag > ZERO_THRESHOLD
    new_height = (height + other_height) * force / torch.where(
        moved, mag, torch.ones_like(mag)) + height
    new_height = torch.clamp(new_height, min=cfg.height_min)
    return new_vec, torch.where(moved, new_height, height)


def update(cfg: VivaldiConfig, state: VivaldiState, other_vec, other_height,
           other_error, other_adjustment, rtt_seconds,
           fallback_rnd) -> VivaldiState:
    """One full observation update per batch element (reference
    client.go:202-234 minus the median filter). Invalid observations (a
    non-finite peer coordinate, an RTT outside [0, 10 s]) leave the
    element untouched. ``fallback_rnd`` is the pair of [..., D]
    uniform(-0.5, 0.5) fallback directions of the two apply_force calls."""
    rnd_viv, rnd_grav = fallback_rnd
    rtt_in = rtt_seconds.to(torch.float32)
    obs_ok = (
        torch.all(torch.isfinite(other_vec), dim=-1)
        & torch.isfinite(other_height) & torch.isfinite(other_error)
        & torch.isfinite(other_adjustment)
        & torch.isfinite(rtt_in) & (rtt_in >= 0.0)
        & (rtt_in <= MAX_RTT_SECONDS)
    )

    # -- updateVivaldi (client.go:145-168)
    dist = distance(state.vec, state.height, state.adjustment,
                    other_vec, other_height, other_adjustment)
    rtt = torch.clamp(rtt_in, min=ZERO_THRESHOLD)
    wrongness = torch.abs(dist - rtt) / rtt
    total_error = torch.clamp(state.error + other_error, min=ZERO_THRESHOLD)
    weight = state.error / total_error
    error = (cfg.vivaldi_ce * weight * wrongness
             + state.error * (1.0 - cfg.vivaldi_ce * weight))
    error = torch.clamp(error, max=cfg.vivaldi_error_max)
    force = cfg.vivaldi_cc * weight * (rtt - dist)
    vec, height = apply_force(cfg, state.vec, state.height, force,
                              other_vec, other_height, rnd_viv)

    # -- updateAdjustment (client.go:172-188)
    w = cfg.adjustment_window_size
    if w:
        raw = raw_distance(vec, height, other_vec, other_height)
        sample = rtt - raw
        onehot = (torch.arange(w, device=vec.device)
                  == state.adj_idx[..., None])
        adj_samples = torch.where(onehot, sample[..., None], state.adj_samples)
        adj_idx = (state.adj_idx + 1) % w
        adjustment = fold_sum(adj_samples) / (2.0 * w)
    else:
        adj_samples, adj_idx, adjustment = (
            state.adj_samples, state.adj_idx, state.adjustment)

    # -- updateGravity (client.go:193-197)
    origin_vec = torch.zeros_like(vec)
    origin_h = torch.full_like(height, cfg.height_min)
    dist_origin = distance(vec, height, adjustment, origin_vec, origin_h,
                           torch.zeros_like(adjustment))
    g_force = -1.0 * (dist_origin / cfg.gravity_rho) ** 2.0
    vec, height = apply_force(cfg, vec, height, g_force, origin_vec,
                              origin_h, rnd_grav)

    # -- validity reset (client.go:228-231)
    finite = (
        torch.all(torch.isfinite(vec), dim=-1)
        & torch.isfinite(height) & torch.isfinite(error)
        & torch.isfinite(adjustment)
    )
    fresh = new(cfg, batch_shape=state.height.shape, device=vec.device)
    updated = VivaldiState(
        vec=torch.where(finite[..., None], vec, fresh.vec),
        height=torch.where(finite, height, fresh.height),
        error=torch.where(finite, error, fresh.error),
        adjustment=torch.where(finite, adjustment, fresh.adjustment),
        adj_samples=torch.where(finite[..., None], adj_samples,
                                fresh.adj_samples),
        adj_idx=torch.where(finite, adj_idx, fresh.adj_idx),
        resets=state.resets + (~finite).to(torch.int64),
    )
    return VivaldiState(*(
        torch.where(obs_ok.reshape(obs_ok.shape + (1,) * (a.dim() - obs_ok.dim())),
                    a, b)
        for a, b in zip(updated, state)
    ))
