"""Host-side coordinate math for RTT estimation and nearness sorting
(the port's copy of ``consul_tpu/server/rtt.py``; the port imports
nothing of the reference package).

The serializable coordinate format (``{"vec": [...], "error": e,
"height": h, "adjustment": a}``) matches the reference's
``coordinate.Coordinate`` struct (reference serf/coordinate/
coordinate.go:14-37); distances follow ``Coordinate.DistanceTo`` +
``lib.ComputeDistance`` (reference coordinate.go:121-132, lib/rtt.go:
13-19): Euclidean + both heights, plus both adjustments when the
adjusted value stays positive, infinity for nil/mismatched coordinates.

This is the read-side math behind ``consul rtt`` and catalog ``?near=``
sorting (reference command/rtt/rtt.go, agent/consul/rtt.go:21-221). It
is the serving plane's fallback for coordinate sets with named segments
(``serving/plane.py``) and the host math the device path is held
against: the batched NearestN/distance path (``ops/serving.py``) agrees
with ``compute_distance`` and ``sort_nodes_by_distance`` in ordering,
including the +inf unknown-coordinate rule and the adjustment clamp
(tests/test_torch_serving.py).
"""

from __future__ import annotations

import math
from typing import Optional


def compute_distance(a: Optional[dict], b: Optional[dict]) -> float:
    """Estimated RTT in seconds; +inf when either side is unknown
    (reference lib/rtt.go:13-19)."""
    if a is None or b is None:
        return math.inf
    va, vb = a["vec"], b["vec"]
    if len(va) != len(vb):
        return math.inf
    dist = math.sqrt(sum((x - y) ** 2 for x, y in zip(va, vb)))
    dist += a.get("height", 0.0) + b.get("height", 0.0)
    adjusted = dist + a.get("adjustment", 0.0) + b.get("adjustment", 0.0)
    return adjusted if adjusted > 0.0 else dist


def intersect(set_a: dict[str, dict], set_b: dict[str, dict]) -> tuple:
    """Pick comparable coordinates from two per-segment coordinate sets
    (reference lib/rtt.go:31-52 CoordinateSet.Intersect): use the
    default segment unless both sides share a named segment."""
    segment = ""
    if len(set_a) == 1 and "" not in set_a:
        segment = next(iter(set_a))
    if len(set_b) == 1 and "" not in set_b:
        segment = next(iter(set_b))
    return set_a.get(segment), set_b.get(segment)


def sort_nodes_by_distance(coord_sets: dict[str, dict[str, dict]],
                           source: str, rows: list[dict],
                           node_key: str = "node") -> list[dict]:
    """Stable-sort catalog/health rows by estimated RTT from ``source``
    (reference agent/consul/rtt.go:187-221 sortNodesByDistanceFrom).
    Unknown coordinates sort last (infinite distance)."""
    src_set = coord_sets.get(source)
    if not src_set:
        return rows

    def dist(row):
        other = coord_sets.get(row[node_key])
        if not other:
            return math.inf
        a, b = intersect(src_set, other)
        return compute_distance(a, b)

    return sorted(rows, key=dist)


def coord_sets_from_store(coords: list[dict]) -> dict[str, dict[str, dict]]:
    """Group store coordinate rows into per-node segment sets."""
    out: dict[str, dict[str, dict]] = {}
    for row in coords:
        out.setdefault(row["node"], {})[row.get("segment", "")] = row["coord"]
    return out
