"""View-graph family registry: symmetric circulant offset generators.

The PyTorch port's own copy of the numpy-only ``consul_tpu/topo/families.py``:
the offsets it draws from a seeded ``numpy`` generator are the same as the
reference's, so both topologies agree table for table.

Every family here emits a *symmetric circulant* offset set — sorted
distinct offsets in ``[1, n-1]`` closed under negation (``d`` present
iff ``n - d`` present). That invariant is what lets the SWIM/serf step
deliver every neighbor column with a dense roll instead of a scatter
(ops/topology.py), so families differ **only** in how the offsets are
chosen; the remap/inverse/roll machinery is family-independent and the
offset tensors can travel as program arguments (chaos/sweep.py) so
same-shape families share one XLA executable.

Families:

``circulant``
    The original uniform draw of ``K/2`` half-offsets — preserved
    bit-identically (same rng consumption order) as the default.
``expander``
    Best-of-m random circulant unions scored by spectral gap. Random
    circulants are near-Ramanujan with high probability; taking the
    best of ``m`` draws (default 32) pushes the gap toward the
    ``1 - 2*sqrt(K-1)/K`` bound.
``smallworld``
    Watts–Strogatz on the offset set: the ring lattice
    ``{±1..±K/2}`` with each half-offset beyond ±1 rewired to a
    uniform long-range offset with probability beta (default 0.2).
    ±1 is always kept so the ring stays connected.
``hier``
    Hierarchical DC-aware: dense intra-DC circulant (small offsets)
    plus sparse inter-DC bridges that are exact multiples of the
    per-DC block size — under the dc-major node numbering used by the
    ``(dc, nodes)`` mesh (parallel/mesh.py), a multiple-of-``n/n_dc``
    offset hops whole datacenters while keeping the same in-DC seat.

All generators are host-side numpy (they run once per Simulation
build); the spectral-gap probe uses the circulant closed form
``lambda_d = sum_c cos(2 pi off_c d / n)`` — O(nK), no eigensolver.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Callable, Dict

import numpy as np

# family name -> generator(n, k_deg, rng, param) -> sorted symmetric
# int64 offsets of length k_deg. Registered below via @register.
FAMILIES: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FAMILIES[name] = fn
        return fn
    return deco


def offsets_for(family: str, n: int, k_deg: int, rng: np.random.Generator,
                param: float = 0.0) -> np.ndarray:
    """Generate and validate the offset set for one family."""
    try:
        gen = FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown topology family {family!r}; registered families: "
            f"{', '.join(sorted(FAMILIES))}") from None
    off = gen(n, k_deg, rng, param)
    validate_offsets(off, n, k_deg, family=family)
    return off


# ---------------------------------------------------------------------------
# validators + spectral probe

def validate_offsets(off: np.ndarray, n: int, k_deg: int,
                     family: str = "?") -> None:
    """Structural invariants every family must satisfy.

    Checks degree bound, range, strict sortedness (distinctness),
    symmetry closure, and connectivity. Connectivity of a circulant
    graph has an exact arithmetic form: the offsets generate Z_n iff
    gcd(off_1, ..., off_K, n) == 1 — no BFS needed at any n.
    """
    off = np.asarray(off)
    if off.shape != (k_deg,):
        raise ValueError(
            f"family {family!r}: expected {k_deg} offsets, got shape "
            f"{off.shape} (degree bound violated)")
    if off.size and (off.min() < 1 or off.max() > n - 1):
        raise ValueError(
            f"family {family!r}: offsets must lie in [1, {n - 1}], got "
            f"range [{off.min()}, {off.max()}]")
    if np.any(np.diff(off) <= 0):
        raise ValueError(
            f"family {family!r}: offsets must be sorted and distinct")
    if set(int(d) for d in off) != set(int(n - d) for d in off):
        raise ValueError(
            f"family {family!r}: offset set not closed under negation "
            f"(symmetric circulant needs d and n-d together)")
    if reduce(math.gcd, (int(d) for d in off), n) != 1:
        raise ValueError(
            f"family {family!r}: offsets do not generate Z_{n} "
            f"(gcd(offsets, n) != 1) — the view graph is disconnected")


def spectral_gap(off: np.ndarray, n: int) -> float:
    """Normalized spectral gap of the circulant view graph.

    Circulant adjacency eigenvalues in closed form:
    ``lambda_d = sum_c cos(2 pi off_c d / n)`` for d = 0..n-1 (the
    sine parts cancel by symmetry closure). Returns
    ``1 - max_{d != 0} |lambda_d| / K`` in [0, 1]; larger means faster
    gossip mixing. Ramanujan quality would be
    ``>= 1 - 2 sqrt(K-1) / K``. Host-side O(nK).
    """
    off = np.asarray(off, dtype=np.float64)
    k_deg = off.shape[0]
    if k_deg == 0 or n <= 1:
        return 0.0
    d = np.arange(1, n, dtype=np.float64)
    lam = np.zeros(n - 1, dtype=np.float64)
    for s in off:  # K accumulations over an [n-1] vector, not [n-1, K]
        lam += np.cos((2.0 * np.pi * s / n) * d)
    return float(1.0 - np.max(np.abs(lam)) / k_deg)


# ---------------------------------------------------------------------------
# generators

def _close(half: np.ndarray, n: int) -> np.ndarray:
    """Sorted symmetric closure {d, n-d} of a half-offset set."""
    half = np.asarray(half, dtype=np.int64)
    return np.sort(np.concatenate([half, n - half]))


def _draw_half(n: int, k_half: int, rng: np.random.Generator) -> np.ndarray:
    """The original uniform half-offset draw (bit-identity anchor).

    Must consume the rng exactly like the pre-family make_topology did:
    one rng.choice over [1, (n+1)//2) without replacement.
    """
    return rng.choice(np.arange(1, (n + 1) // 2), size=k_half, replace=False)


@register("circulant")
def circulant(n: int, k_deg: int, rng: np.random.Generator,
              param: float = 0.0) -> np.ndarray:
    """The default family: one uniform random symmetric circulant,
    conditioned on connectivity.

    The first draw consumes the rng exactly like the pre-registry
    topology code and is returned unchanged whenever it generates Z_n
    — which keeps every connected pre-registry topology bit-identical
    (golden-pinned in tests/test_topology.py). A disconnected draw
    (all offsets sharing a factor with n — ~5% at n=128, K=8) is
    redrawn; the pre-registry code silently accepted those broken
    graphs, the registry's connectivity validator does not.
    """
    for _ in range(256):
        off = _close(_draw_half(n, k_deg // 2, rng).astype(np.int64), n)
        if reduce(math.gcd, (int(d) for d in off), n) == 1:
            return off
    return off  # let validate_offsets report the disconnection


@register("expander")
def expander(n: int, k_deg: int, rng: np.random.Generator,
             param: float = 0.0) -> np.ndarray:
    """Best-of-m random circulant unions by spectral gap (m = param or
    32). Disconnected candidates score gap 0 exactly (lambda at
    d = n/gcd hits K), so maximizing the gap also selects for
    connectivity whenever any candidate connects."""
    candidates = int(param) if param else 32
    best, best_gap = None, -np.inf
    for _ in range(max(1, candidates)):
        off = _close(_draw_half(n, k_deg // 2, rng).astype(np.int64), n)
        gap = spectral_gap(off, n)
        if gap > best_gap:
            best, best_gap = off, gap
    return best


@register("smallworld")
def smallworld(n: int, k_deg: int, rng: np.random.Generator,
               param: float = 0.0) -> np.ndarray:
    """Watts–Strogatz on the half-offset set (beta = param or 0.2).

    Start from the ring lattice {1..K/2}; each half-offset above 1 is
    rewired to a uniform long-range half-offset with probability beta.
    ±1 is never rewired, so the base ring (which alone generates Z_n)
    keeps the graph connected at any beta.
    """
    beta = float(param) if param else 0.2
    k_half = k_deg // 2
    hi = (n + 1) // 2  # half-offsets live in [1, hi)
    used: set = set()
    half = []
    for d in range(1, k_half + 1):
        cand = d
        if d > 1 and rng.random() < beta:
            cand = int(rng.integers(2, hi))
        while cand in used or cand >= hi:
            cand = int(rng.integers(2, hi))
        used.add(cand)
        half.append(cand)
    return _close(np.asarray(half, dtype=np.int64), n)


@register("hier")
def hier(n: int, k_deg: int, rng: np.random.Generator,
         param: float = 0.0) -> np.ndarray:
    """Hierarchical DC-aware view (n_dc = param or 8).

    Node ids are dc-major (node i lives in DC ``i // (n/n_dc)``, the
    same layout the (dc, nodes) mesh shards). Offsets split into:
      - bridges: multiples of ``per_dc = n / n_dc`` — pure inter-DC
        hops (same seat, +j DCs), about 1/4 of the half-degree;
      - intra: small offsets < per_dc — mostly-local neighbors.
    """
    n_dc = int(param) if param else 8
    if n_dc < 2 or n % n_dc != 0:
        raise ValueError(
            f"hier family needs n divisible by n_dc >= 2, got n={n} "
            f"n_dc={n_dc} (pass n_dc via topo_param / --family-param)")
    per_dc = n // n_dc
    k_half = k_deg // 2
    hi = (n + 1) // 2

    # Inter-DC bridge half-offsets: distinct multiples of per_dc below
    # n/2 (a multiple equal to n/2 would be its own negation).
    mult = per_dc * np.arange(1, n_dc, dtype=np.int64)
    mult = mult[mult < hi]
    n_bridge = min(max(1, k_half // 4), len(mult), k_half - 1)
    bridges = np.sort(rng.choice(mult, size=n_bridge, replace=False))

    # Intra-DC half-offsets: the smallest offsets, skipping anything
    # that collides with a bridge (possible only when per_dc is tiny).
    used = set(int(b) for b in bridges)
    half = [int(b) for b in bridges]
    d = 1
    while len(half) < k_half:
        if d >= hi:
            raise ValueError(
                f"hier family: cannot place {k_half} half-offsets in "
                f"[1, {hi}) for n={n} n_dc={n_dc}")
        if d not in used:
            used.add(d)
            half.append(d)
        d += 1
    return _close(np.asarray(half, dtype=np.int64), n)
