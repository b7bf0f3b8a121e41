"""Prepared queries: stored service lookups with templates + failover.

The port's copy of ``consul_tpu/server/prepared_query.py``; it imports nothing of the reference package.

Mirrors the reference's prepared-query subsystem (reference
agent/consul/prepared_query_endpoint.go, agent/structs/prepared_query.go,
agent/consul/prepared_query/template.go): a raft-replicated definition
of a health-filtered service lookup — tag/metadata filters, RTT ``near``
sorting, cross-DC failover — resolvable by id or by name, with
``name_prefix_match`` templates rendered against the looked-up name.

This module is the pure logic (normalization, template rendering,
result filtering); the raft/RPC plumbing lives in
``server/endpoints.py`` and storage in ``server/state_store.py``.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from consul_tpu_torch.utils import health

TEMPLATE_NAME_PREFIX_MATCH = "name_prefix_match"

_DEFAULTS: dict[str, Any] = {
    "id": "", "name": "", "session": "", "token": "",
    "template": {"type": "", "regexp": "", "remove_empty_tags": False},
    "service": {
        "service": "",
        "failover": {"nearest_n": 0, "datacenters": []},
        "only_passing": False,
        "ignore_check_ids": [],
        "near": "",
        "tags": [],
        "node_meta": {},
        "service_meta": {},
    },
    "dns": {"ttl": ""},
}


def _merge_defaults(defaults: dict, given: dict) -> dict:
    out = {}
    for k, d in defaults.items():
        v = given.get(k, d)
        if isinstance(d, dict) and isinstance(v, dict) and d:
            # Fixed-schema subdict: recurse so missing knobs default.
            out[k] = _merge_defaults(d, v)
        else:
            # Scalar, list, or an OPEN map (empty-dict default like
            # node_meta/service_meta): the given value rides verbatim.
            out[k] = v if v is not None else d
    return out


def normalize(q: dict) -> dict:
    """Fill defaults and validate (reference parseQuery + parseService,
    prepared_query_endpoint.go:120-214). Raises ValueError on a bad
    definition."""
    unknown = sorted(set(q) - set(_DEFAULTS))
    if unknown:
        raise ValueError(f"unknown prepared query fields: {unknown}")
    out = _merge_defaults(_DEFAULTS, q)
    if not out["service"]["service"]:
        raise ValueError("prepared query must specify a Service to query")
    t = out["template"]["type"]
    if t and t != TEMPLATE_NAME_PREFIX_MATCH:
        raise ValueError(f"bad template type {t!r} "
                         f"(only {TEMPLATE_NAME_PREFIX_MATCH!r})")
    if out["template"]["regexp"]:
        try:
            re.compile(out["template"]["regexp"])
        except re.error as e:
            raise ValueError(f"bad template regexp: {e}") from e
    nn = out["service"]["failover"]["nearest_n"]
    if not isinstance(nn, int) or nn < 0:
        raise ValueError(f"bad NearestN {nn!r}")
    return out


def is_template(q: dict) -> bool:
    return bool(q.get("template", {}).get("type"))


_INTERP = re.compile(r"\$\{\s*([a-z.]+(?:\(\d+\))?)\s*\}")


def render(q: dict, name: str) -> dict:
    """Render a template query against the looked-up ``name``
    (reference prepared_query/template.go Render: the go-hcl
    interpolation over every string field, with ``name.full``/
    ``name.prefix``/``name.suffix`` and ``match(N)`` regexp captures).

    The interpolation here covers the fields a service query reads —
    service name, tags, node/service metadata values — which is where
    the reference's walk visits strings that matter."""
    prefix = q.get("name", "")
    variables = {
        "name.full": name,
        "name.prefix": prefix,
        "name.suffix": name[len(prefix):] if name.startswith(prefix) else "",
    }
    rx = q.get("template", {}).get("regexp", "")
    if rx:
        m = re.match(rx, name)
        if m:
            for i, g in enumerate(m.groups(), start=1):
                variables[f"match({i})"] = g or ""

    def interp(s: str) -> str:
        return _INTERP.sub(lambda mo: variables.get(mo.group(1), ""), s)

    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in q.items()}
    svc = dict(out["service"])
    svc["service"] = interp(svc["service"])
    tags = [interp(t) for t in svc.get("tags", [])]
    if out.get("template", {}).get("remove_empty_tags"):
        tags = [t for t in tags if t]
    svc["tags"] = tags
    svc["node_meta"] = {k: interp(v)
                        for k, v in (svc.get("node_meta") or {}).items()}
    svc["service_meta"] = {k: interp(v)
                           for k, v in (svc.get("service_meta") or {}).items()}
    out["service"] = svc
    return out


def filter_nodes(q: dict, rows: list[dict]) -> list[dict]:
    """Apply the query's health + tag + metadata filters to health
    rows ({node, service, checks, ...}) — reference
    CheckServiceNodes.FilterIgnore + tagFilter + nodeMetaFilter +
    serviceMetaFilter (prepared_query_endpoint.go:560-640)."""
    svc = q["service"]
    ignore = set(svc.get("ignore_check_ids") or [])
    required = [t.lower() for t in svc.get("tags", [])
                if t and not t.startswith("!")]
    forbidden = [t[1:].lower() for t in svc.get("tags", [])
                 if t.startswith("!")]
    node_meta = svc.get("node_meta") or {}
    service_meta = svc.get("service_meta") or {}
    out = []
    for row in rows:
        worst = 0
        for c in row.get("checks", []):
            if c.get("check_id") in ignore:
                continue
            worst = max(worst, health.severity(c.get("status")))
        # only_passing drops warnings too; default drops critical only
        # (reference FilterIgnore).
        if worst >= (1 if svc.get("only_passing") else 2):
            continue
        tags = {t.lower() for t in (row["service"].get("tags") or [])}
        if any(t not in tags for t in required):
            continue
        if any(t in tags for t in forbidden):
            continue
        smeta = row["service"].get("meta") or {}
        if any(smeta.get(k) != v for k, v in service_meta.items()):
            continue
        nmeta = row.get("node_meta") or {}
        if node_meta and any(nmeta.get(k) != v
                             for k, v in node_meta.items()):
            continue
        out.append(row)
    return out


def resolve(queries: list[dict], id_or_name: str) -> Optional[dict]:
    """Resolve by exact id, exact name, then longest matching
    ``name_prefix_match`` template — rendered (reference
    state/prepared_query.go PreparedQueryResolve)."""
    if not id_or_name:
        raise ValueError("missing query id or name")
    by_id = next((q for q in queries if q["id"] == id_or_name), None)
    if by_id is not None:
        if is_template(by_id):
            raise ValueError(
                "prepared query templates can only be resolved by name, "
                "not by id")
        return by_id
    exact = next((q for q in queries
                  if q["name"] == id_or_name and not is_template(q)), None)
    if exact is not None:
        return exact
    best = None
    for q in queries:
        if not is_template(q):
            continue
        if id_or_name.startswith(q["name"]):
            if best is None or len(q["name"]) > len(best["name"]):
                best = q
    if best is not None:
        return render(best, id_or_name)
    return None


def nearest_sorted(nodes: list[dict], near_node: str, sort_fn) -> list[dict]:
    """RTT-order an executed query's nodes from ``near_node``, then
    float the queried-from node itself to position 0 when it lands near
    the front (reference Execute:430-441, depth-capped at 10 — a node
    asking for its own service should be offered itself first).

    ``sort_fn(near, rows)`` is the nearness sorter — host
    ``rtt.sort_nodes_by_distance`` over store coordinate sets or the
    device serving plane's batched path; this helper stays pure either
    way.
    """
    nodes = list(sort_fn(near_node, nodes))
    for i, row in enumerate(nodes[:10]):
        if row["node"] == near_node:
            nodes[0], nodes[i] = nodes[i], nodes[0]
            break
    return nodes
