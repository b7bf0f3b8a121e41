"""Discovery-chain compiler: config entries → a routing graph.

The port's copy of ``consul_tpu/server/discovery_chain.py``; it imports nothing of the reference package.

Mirrors the reference's discovery chain (reference
agent/consul/discoverychain/compile.go + structs/discovery_chain.go):
the L7 config entries for one service — ``service-router``,
``service-splitter``, ``service-resolver`` — compile into a walkable
graph of router → splitter → resolver nodes ending in concrete
targets (service, subset, datacenter), with redirects followed,
failover recorded per resolver, and reference-style defaults (a
service with no entries compiles to a single default resolver).

Entry shapes (the subset of each kind this compiler evaluates,
snake_case like the rest of the config-entry surface):

  service-router:   {"routes": [{"match": {"http": {"path_prefix"|
                     "path_exact"|"header": [{"name","exact"}]}},
                     "destination": {"service", "service_subset"}}]}
  service-splitter: {"splits": [{"weight", "service",
                     "service_subset"}]}
  service-resolver: {"default_subset", "subsets": {name: {"filter"}},
                     "redirect": {"service","service_subset",
                     "datacenter"}, "failover": {subset|"*":
                     {"service", "datacenters": [...]}},
                     "connect_timeout"}

Circular redirects and router/splitter references are a compile error
(compile.go's circular-reference detection via its string stack).
"""

from __future__ import annotations

from typing import Any, Optional

ROUTER = "router"
SPLITTER = "splitter"
RESOLVER = "resolver"

DEFAULT_CONNECT_TIMEOUT = "5s"


class ChainCompileError(ValueError):
    pass


class _Compiler:
    def __init__(self, get_entry, service: str, datacenter: str):
        self.get_entry = get_entry
        self.service = service
        self.datacenter = datacenter
        self.nodes: dict[str, dict] = {}
        self.targets: dict[str, dict] = {}
        self._stack: list[str] = []  # circular-reference guard

    # -- helpers -------------------------------------------------------
    def _entry(self, kind: str, name: str) -> Optional[dict]:
        return self.get_entry(kind, name)

    def _target_id(self, service: str, subset: str, dc: str) -> str:
        # The reference's target naming: <subset>.<service>.<ns>.<dc>;
        # single-namespace here.
        return f"{subset or 'default'}.{service}.{dc}"

    def _ensure_target(self, service: str, subset: str, dc: str,
                       subset_def: Optional[dict]) -> str:
        tid = self._target_id(service, subset, dc)
        if tid not in self.targets:
            self.targets[tid] = {
                "id": tid, "service": service,
                "service_subset": subset or "",
                "datacenter": dc,
                "subset": dict(subset_def or {}),
            }
        return tid

    def _guard(self, node_name: str):
        if node_name in self._stack:
            cycle = " -> ".join([*self._stack, node_name])
            raise ChainCompileError(
                f"circular reference in discovery chain: {cycle}")
        self._stack.append(node_name)

    def _unguard(self):
        self._stack.pop()

    # -- node builders (compile.go assembleChain) ----------------------
    def entry_node(self, service: str) -> str:
        """The first node for ``service``: router, else splitter, else
        resolver (assembleChain's ordering)."""
        if self._entry("service-router", service) is not None:
            return self.router_node(service)
        if self._entry("service-splitter", service) is not None:
            return self.splitter_node(service)
        return self.resolver_node(service, "")

    def router_node(self, service: str) -> str:
        name = f"{ROUTER}:{service}"
        if name in self.nodes:
            return name
        self._guard(name)
        try:
            entry = self._entry("service-router", service) or {}
            self.nodes[name] = node = {"type": ROUTER, "name": service,
                                       "routes": []}
            for route in entry.get("routes", []):
                dest = route.get("destination") or {}
                svc = dest.get("service") or service
                subset = dest.get("service_subset", "")
                nxt = (self.resolver_node(svc, subset) if subset
                       else self.next_after_router(svc))
                node["routes"].append({
                    "match": route.get("match") or {},
                    "next_node": nxt,
                })
            # The implicit catch-all default route to the service
            # itself (compile.go appends a default route).
            node["routes"].append({
                "match": None,
                "next_node": self.next_after_router(service),
            })
        finally:
            self._unguard()
        return name

    def next_after_router(self, service: str) -> str:
        if self._entry("service-splitter", service) is not None:
            return self.splitter_node(service)
        return self.resolver_node(service, "")

    def splitter_node(self, service: str) -> str:
        name = f"{SPLITTER}:{service}"
        if name in self.nodes:
            return name
        self._guard(name)
        try:
            entry = self._entry("service-splitter", service) or {}
            splits_in = entry.get("splits", [])
            total = sum(float(s.get("weight", 0)) for s in splits_in)
            if splits_in and abs(total - 100.0) > 0.01:
                raise ChainCompileError(
                    f"service-splitter {service!r} weights sum to "
                    f"{total}, must be 100")
            self.nodes[name] = node = {"type": SPLITTER, "name": service,
                                       "splits": []}
            for s in splits_in or [{"weight": 100}]:
                svc = s.get("service") or service
                node["splits"].append({
                    "weight": float(s.get("weight", 0)),
                    "next_node": self.resolver_node(
                        svc, s.get("service_subset", "")),
                })
        finally:
            self._unguard()
        return name

    def resolver_node(self, service: str, subset: str,
                      dc_override: str = "") -> str:
        entry = self._entry("service-resolver", service) or {}
        redirect = entry.get("redirect") or {}
        r_svc = redirect.get("service", "")
        if redirect and r_svc and r_svc != service:
            # A redirect to a DIFFERENT service re-enters the chain at
            # the destination's resolver (compile.go), carrying subset
            # and datacenter overrides along; cycle-guarded.
            self._guard(f"redirect:{service}")
            try:
                return self.resolver_node(
                    r_svc,
                    redirect.get("service_subset", subset),
                    dc_override=redirect.get("datacenter", dc_override))
            finally:
                self._unguard()
        if redirect:
            # Same-service redirect (subset-only and/or dc-only — both
            # valid reference shapes): adopt the overrides WITHOUT
            # recursion, so the cycle guard can never trip on them.
            subset = redirect.get("service_subset", subset)
            dc_override = redirect.get("datacenter", dc_override)
        subset = subset or entry.get("default_subset", "")
        dc = dc_override or self.datacenter
        name = f"{RESOLVER}:{subset or 'default'}.{service}" + (
            f".{dc}" if dc_override else "")
        if name in self.nodes:
            return name
        subsets = entry.get("subsets") or {}
        if subset and subset not in subsets:
            raise ChainCompileError(
                f"service-resolver {service!r} has no subset {subset!r}")
        tid = self._ensure_target(service, subset, dc,
                                  subsets.get(subset))
        failover = None
        fo_map = entry.get("failover") or {}
        fo = fo_map.get(subset or "*") or fo_map.get("*")
        if fo:
            fo_svc = fo.get("service") or service
            fo_targets = [
                self._ensure_target(fo_svc, fo.get("service_subset", ""),
                                    fdc, None)
                for fdc in (fo.get("datacenters") or [self.datacenter])
            ]
            failover = {"targets": fo_targets}
        self.nodes[name] = {
            "type": RESOLVER, "name": f"{subset or 'default'}.{service}",
            "resolver": {
                "target": tid,
                "connect_timeout": entry.get(
                    "connect_timeout", DEFAULT_CONNECT_TIMEOUT),
                "default": not entry,
                "failover": failover,
            },
        }
        return name


def compile_chain(get_entry, service: str,
                  datacenter: str = "dc1") -> dict:
    """``get_entry(kind, name) -> entry|None`` over the config-entry
    store; returns the reference's CompiledDiscoveryChain shape."""
    c = _Compiler(get_entry, service, datacenter)
    start = c.entry_node(service)
    return {
        "service_name": service,
        "datacenter": datacenter,
        "start_node": start,
        "nodes": c.nodes,
        "targets": c.targets,
    }
