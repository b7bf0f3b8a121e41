"""The SWIM membership-state merge semilattice (PyTorch port of
``consul_tpu/ops/merge.py``).

Keys pack (incarnation, status) into 32 bits, incarnation high, status in
the low two bits, so the join is a pointwise max. The keys use all 32
bits, and CPU PyTorch has no max, shift or select on uint32, so the plain
path holds them in int64 tensors: the order and the bit patterns are the
uint32 ones.
"""

from __future__ import annotations

import torch

ALIVE = 0
SUSPECT = 1
DEAD = 2
LEFT = 3

N_STATUS = 4
_STATUS_BITS = 2

MAX_INCARNATION = (1 << 30) - 1

# "Never heard of this node": (0, DEAD), the cold-join sentinel.
UNKNOWN = (0 << _STATUS_BITS) | DEAD


def make_key(incarnation, status):
    """Pack (incarnation, status) into a lexicographically ordered key."""
    inc = torch.as_tensor(incarnation).to(torch.int64) & 0xFFFFFFFF
    return ((inc << _STATUS_BITS) & 0xFFFFFFFF) | status


def make_key_int(incarnation: int, status: int) -> int:
    return (int(incarnation) << _STATUS_BITS) | int(status)


def key_incarnation_int(key: int) -> int:
    return int(key) >> _STATUS_BITS


def key_status_int(key: int) -> int:
    return int(key) & (N_STATUS - 1)


def key_incarnation(key):
    return key >> _STATUS_BITS


def key_status(key):
    return key & (N_STATUS - 1)


def join(key_a, key_b):
    """The semilattice join: pointwise max of packed keys."""
    return torch.maximum(key_a, key_b)


def demote_dead_to_suspect(key):
    """Dead claims become suspicions at the same incarnation (push-pull
    never kills directly, reference memberlist/state.go:1231-1237); LEFT
    and UNKNOWN are exempt."""
    demote = (key & (N_STATUS - 1) == DEAD) & (key != UNKNOWN)
    return torch.where(demote, (key & ~(N_STATUS - 1)) | SUSPECT, key)


def is_contactable(key):
    """Alive, suspect, or never heard of (a join address)."""
    st = key_status(key)
    return (st == ALIVE) | (st == SUSPECT) | (key == UNKNOWN)


def is_refutable(key, subject_is_self, own_incarnation):
    """A suspect/dead claim about self at a current-or-newer incarnation."""
    st = key_status(key)
    return (
        subject_is_self
        & ((st == SUSPECT) | (st == DEAD))
        & (key_incarnation(key) >= own_incarnation)
    )
