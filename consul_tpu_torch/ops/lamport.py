"""Lamport clock operations, vectorized over the node axis (PyTorch port of
``consul_tpu/ops/lamport.py``).

Serf keeps three Lamport clocks per node (membership, user-event and
query time, reference serf/serf.go:57-60) with two operations (reference
serf/lamport.go:10-45): ``increment`` when originating, ``witness`` when
observing a remote time. The clocks are uint32 at rest; here they are
int64 tensors holding the uint32 values, and both operations wrap modulo
2**32 exactly where the reference's uint32 arithmetic does.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def witness(clock: torch.Tensor, observed, mask=None) -> torch.Tensor:
    """Raise ``clock`` to ``observed + 1`` where behind (and ``mask``).

    Mirrors LamportClock.Witness (reference serf/lamport.go:29-45).
    """
    clock = clock.to(torch.int64)
    obs = torch.as_tensor(observed, device=clock.device).to(torch.int64)
    bumped = torch.maximum(clock, ((obs & _U32) + 1) & _U32)
    if mask is None:
        return bumped
    return torch.where(mask, bumped, clock)


def increment(clock: torch.Tensor, mask=None) -> torch.Tensor:
    """Advance the clock by one where ``mask`` (everywhere when None).

    Mirrors LamportClock.Increment (reference serf/lamport.go:23-26); the
    originated message carries the previous value.
    """
    clock = clock.to(torch.int64)
    if mask is None:
        return (clock + 1) & _U32
    return torch.where(mask, (clock + 1) & _U32, clock)
