"""Cluster-size scaling laws of the SWIM/Lifeguard protocol (PyTorch port
of ``consul_tpu/ops/scaling.py``).

The same float32 formulas as the reference (reference memberlist/util.go
:62-97, memberlist/suspicion.go:86-97). Every function takes scalars or
tensors and returns a tensor; the step evaluates the static ones once on
the host.
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def suspicion_timeout(suspicion_mult, n, probe_interval_ticks):
    """``mult * max(1, log10(max(1, n))) * probe_interval`` in float32."""
    node_scale = torch.clamp(torch.log10(torch.clamp(_f32(n), min=1.0)), min=1.0)
    return suspicion_mult * node_scale * probe_interval_ticks


def retransmit_limit(retransmit_mult, n):
    """``mult * ceil(log10(n + 1))``, with the reference's epsilon guard
    against float32 log10 landing a hair above an integer."""
    scale = torch.ceil(torch.log10(_f32(n) + 1.0) - 1e-3)
    return (retransmit_mult * scale).to(torch.int32)


def push_pull_scale(n):
    """1 up to 32 nodes, then ``ceil(log2(n) - log2(32)) + 1``."""
    n = _f32(n)
    mult = torch.ceil(torch.log2(torch.clamp(n, min=1.0))
                      - torch.log2(_f32(32.0)) - 1e-3) + 1.0
    return torch.where(n <= 32.0, torch.ones_like(mult, dtype=torch.int32),
                       mult.to(torch.int32))


def remaining_suspicion_time(n_confirms, k, elapsed, min_timeout, max_timeout):
    """Lifeguard's decaying suspicion timeout less the time elapsed; <= 0
    means expired (reference memberlist/suspicion.go:86-97)."""
    n_confirms = _f32(n_confirms)
    k = _f32(k)
    frac = torch.where(
        k > 0.0,
        torch.log(n_confirms + 1.0) / torch.log(k + 1.0),
        torch.ones_like(n_confirms),
    )
    raw = max_timeout - frac * (max_timeout - min_timeout)
    return torch.clamp(raw, min=min_timeout) - elapsed


def suspicion_k(suspicion_mult, n):
    """``suspicion_mult - 2``, zeroed when ``n - 2 < k``."""
    n = torch.as_tensor(n).to(torch.int32)
    k = torch.as_tensor(suspicion_mult - 2).to(torch.int32)
    return torch.where(n - 2 < k, torch.zeros_like(k), k)


def queue_max_depth(max_queue_depth, min_queue_depth, n_members):
    """Dynamic serf broadcast-queue depth limit.

    Mirrors getQueueMax (reference serf/serf.go:1612-1624): the static
    ``MaxQueueDepth`` unless ``MinQueueDepth`` is set, in which case the
    limit scales with the cluster — ``max(2 * n_members,
    min_queue_depth)`` (Consul sets MinQueueDepth=4096, reference
    lib/serf.go:26-28). Host-side helper (plain ints): the limit guards
    host-side queues (wire/bridge.py seam buffers).
    """
    m = int(max_queue_depth)
    if min_queue_depth > 0:
        m = max(2 * int(n_members), int(min_queue_depth))
    return m
