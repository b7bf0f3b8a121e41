"""Simulated cluster topology and ground-truth latency model (PyTorch port
of ``consul_tpu/ops/topology.py``).

Every node sits at a ground-truth position in a small Euclidean world
with a per-node access-link height; observed RTTs are the true distance
with lognormal jitter. Membership views follow one symmetric circulant
neighbor relation::

    nbrs(i, c) = (i + off[c]) mod N,   off[K] sorted, distinct,
                                       d in off  <=>  N-d in off

Dense mode (``view_degree == 0``) is the complete graph, ``off = [1..N-1]``
with closed-form column maps. Sparse mode draws ``off`` from the family
registry (numpy, ``topo/families.py``) and precomputes the ``rcol[K, K]``
remap and ``inv[K]`` tables: the column a gossiped subject lands in at
the receiver depends only on (sender column, receiver in-column).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.topo import families

# rcol sentinel: the subject of this (in-column, sender-column) pair is
# the receiver itself (refutation fodder, never a view merge).
SELF = -2
# rcol sentinel: subject not in the receiver's partial view.
ABSENT = -1


class World(NamedTuple):
    """Ground-truth node placement; all units in seconds (RTT space)."""

    pos: torch.Tensor     # [N, world_dims] float32
    height: torch.Tensor  # [N] float32


class Topology(NamedTuple):
    """The shared circulant neighbor relation. ``rcol``/``inv`` are None
    in dense mode. ``off_host`` holds the offsets as Python ints, so roll
    shifts known on the host never read the device."""

    n: int
    dense: bool
    off: torch.Tensor              # [K] int64, sorted
    rcol: Optional[torch.Tensor]   # [K, K] int64
    inv: Optional[torch.Tensor]    # [K] int64
    off_host: tuple = ()

    @property
    def degree(self) -> int:
        return self.off.shape[0]


def make_topology(cfg: SimConfig, gen: torch.Generator,
                  device="cpu") -> Topology:
    """Build the offset table and remap tables. The family generator runs
    on a numpy rng seeded by one draw from ``gen``."""
    n, k_deg = cfg.n, cfg.degree
    if k_deg == n - 1:
        off = torch.arange(1, n, dtype=torch.int64, device=device)
        return Topology(n=n, dense=True, off=off, rcol=None, inv=None,
                        off_host=tuple(range(1, n)))
    if k_deg % 2 != 0:
        raise ValueError("sparse view_degree must be even (symmetric offsets)")
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen,
                             device=gen.device))
    rng = np.random.default_rng(seed)
    off_np = families.offsets_for(cfg.topo_family, n, k_deg, rng,
                                  param=cfg.topo_param)
    return topology_from_offsets(n, off_np, device)


def topology_from_offsets(n: int, off_np: np.ndarray, device="cpu") -> Topology:
    """Build the remap/inverse tables for a validated offset set."""
    off_np = np.asarray(off_np, dtype=np.int64)
    k_deg = off_np.shape[0]
    # rcol[j, c] = column of (off[c] - off[j]) mod n.
    d = (off_np[None, :] - off_np[:, None]) % n
    col = np.clip(np.searchsorted(off_np, d), 0, k_deg - 1)
    rcol = np.where(off_np[col] == d, col, ABSENT)
    rcol[np.arange(k_deg), np.arange(k_deg)] = SELF
    inv = np.searchsorted(off_np, (n - off_np))
    return Topology(
        n=n,
        dense=False,
        off=torch.as_tensor(off_np, dtype=torch.int64, device=device),
        rcol=torch.as_tensor(rcol, dtype=torch.int64, device=device),
        inv=torch.as_tensor(inv, dtype=torch.int64, device=device),
        off_host=tuple(int(x) for x in off_np),
    )


def neighbor_of(topo: Topology, row, col):
    """Global id of ``row``'s neighbor at ``col``: (row + off[col]) mod N."""
    return (row + topo.off[col]) % topo.n


def nbrs_table(topo: Topology) -> torch.Tensor:
    """Materialized [N, K] neighbor-id table (host-side read-outs only)."""
    rows = torch.arange(topo.n, dtype=torch.int64, device=topo.off.device)
    return (rows[:, None] + topo.off[None, :]) % topo.n


def remap_row(topo: Topology, j):
    """``rcol[j]`` as a [K] vector; entry c is the receiver's column for
    the sender's column-c subject (SELF when c == j)."""
    if topo.dense:
        k_deg = topo.degree
        c = torch.arange(k_deg, dtype=torch.int64, device=topo.off.device)
        d = (c - j) % (k_deg + 1)
        return torch.where(c == j, torch.full_like(c, SELF), d - 1)
    return topo.rcol[j]


def inv_col(topo: Topology, j):
    """Column where the sender itself sits in the receiver's view, given
    the sender occupies the receiver's in-column j."""
    if topo.dense:
        return topo.n - 2 - j
    return topo.inv[j]


def gather_cols(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    """[N, K] view of a per-node array along the neighbor relation:
    ``out[i, c] = x[(i + off[c]) mod N]``."""
    if not topo.dense:
        return torch.stack([torch.roll(x, -s, 0) for s in topo.off_host], dim=1)
    rows = torch.arange(topo.n, dtype=torch.int64, device=x.device)
    return x[(rows[:, None] + topo.off[None, :]) % topo.n]


def make_world(cfg: SimConfig, gen: torch.Generator, device="cpu") -> World:
    """Plant every node uniformly in the world cube, with a uniform
    access-link height."""
    diameter_s = cfg.world_diameter_ms / 1000.0
    pos = torch.rand((cfg.n, cfg.world_dims), generator=gen,
                     device=device) * diameter_s
    lo, hi = cfg.height_ms_min / 1000.0, cfg.height_ms_max / 1000.0
    height = torch.rand((cfg.n,), generator=gen, device=device) * (hi - lo) + lo
    return World(pos=pos, height=height)


def true_rtt(world: World, i, j):
    """Noise-free round-trip time between node indices, in seconds."""
    d = world.pos[i] - world.pos[j]
    return torch.sqrt(torch.sum(d * d, dim=-1)) + world.height[i] + world.height[j]
