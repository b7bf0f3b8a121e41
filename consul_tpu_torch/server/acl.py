"""ACL system: tokens, policies, and the authorizer.

The port's copy of ``consul_tpu/server/acl.py``; it imports nothing of the reference package.

Mirrors the reference ACL core (reference acl/policy.go rule model,
acl/acl.go enforcement semantics, agent/consul/acl_endpoint.go CRUD):
policies are rule documents over resource families — ``key``/
``key_prefix``, ``node``/``node_prefix``, ``service``/
``service_prefix``, ``session``/``session_prefix``, ``event``/
``event_prefix``, ``query``/``query_prefix``, ``agent``/
``agent_prefix``, plus the scalar ``operator``, ``keyring`` and
``acl`` switches — each granting ``read``/``write``/``deny``.
Rules may be written as the reference's HCL DSL (``key_prefix "foo/"
{ policy = "write" }``, parsed by utils/hcl) or as the equivalent
JSON object.

Enforcement semantics (acl/acl.go): an exact rule for the name wins;
otherwise the LONGEST matching prefix rule; otherwise the default
policy. When several policies on one token speak to the same rule,
``deny`` takes precedence over ``write`` over ``read``
(acl/policy_merger.go).

Tokens pair a public accessor id with a secret id and carry a policy
list; the builtin ``global-management`` policy grants everything
(agent/structs/acl.go ACLPolicyGlobalManagement), and the bootstrap
endpoint mints the first management token exactly once
(acl_endpoint.go Bootstrap / the reset-index escape hatch is out of
scope).
"""

from __future__ import annotations

from typing import Any, Optional, Union

RESOURCES = ("key", "node", "service", "session", "event", "query",
             "agent")
SCALARS = ("operator", "keyring", "acl")
ACCESS = ("deny", "read", "write")

MANAGEMENT_POLICY = "global-management"

# deny beats write beats read when policies collide on one rule
# (acl/policy_merger.go).
_PRECEDENCE = {"deny": 2, "write": 1, "read": 0}


def parse_rules(rules: Union[str, dict, None]) -> dict:
    """Rules document → validated {family: {name: access}} form.
    Accepts the HCL DSL or the equivalent dict; raises ValueError on
    unknown families/accesses (acl/policy.go parse validation)."""
    if rules is None or rules == "":
        return {}
    if isinstance(rules, str):
        from consul_tpu_torch.utils import hcl
        doc = hcl.parse(rules)
    else:
        doc = rules
    out: dict = {}
    for fam, body in doc.items():
        base = fam[:-7] if fam.endswith("_prefix") else fam
        if fam in SCALARS:
            if body not in ACCESS:
                raise ValueError(f"bad {fam} policy {body!r}")
            out[fam] = body
            continue
        if base not in RESOURCES:
            raise ValueError(f"unknown ACL resource {fam!r}")
        if not isinstance(body, dict):
            raise ValueError(f"{fam} rules must be a block, got {body!r}")
        slot = out.setdefault(fam, {})
        for name, spec in body.items():
            pol = spec.get("policy") if isinstance(spec, dict) else spec
            if pol not in ACCESS:
                raise ValueError(f"bad policy {pol!r} for {fam} {name!r}")
            slot[name] = pol
    return out


class Authorizer:
    """Compiled rule set for one token (the merged view over its
    policies). ``allowed(resource, name, "read"|"write")``."""

    def __init__(self, policy_docs: list[dict],
                 default_allow: bool = True,
                 management: bool = False):
        self.default_allow = default_allow
        self.management = management
        self.exact: dict[str, dict[str, str]] = {r: {} for r in RESOURCES}
        self.prefix: dict[str, dict[str, str]] = {r: {} for r in RESOURCES}
        self.scalar: dict[str, str] = {}
        for doc in policy_docs:
            for fam, body in doc.items():
                if fam in SCALARS:
                    self._put(self.scalar, fam, body)
                    continue
                is_prefix = fam.endswith("_prefix")
                base = fam[:-7] if is_prefix else fam
                tgt = self.prefix[base] if is_prefix else self.exact[base]
                for name, pol in body.items():
                    self._put(tgt, name, pol)

    @staticmethod
    def _put(d: dict, k: str, pol: str):
        cur = d.get(k)
        if cur is None or _PRECEDENCE[pol] > _PRECEDENCE[cur]:
            d[k] = pol

    def _grants(self, access: Optional[str], want: str) -> Optional[bool]:
        if access is None:
            return None
        if access == "deny":
            return False
        return access == "write" or want == "read"

    def allowed_prefix(self, resource: str, prefix: str,
                       want: str = "read") -> bool:
        """Authorize an operation covering the WHOLE subtree under
        ``prefix`` (recursive KV reads/deletes, key listings) —
        reference acl.go KeyWritePrefix: the deepest prefix rule
        covering the subtree must grant it, and no rule *within* the
        subtree may refuse it. An exact-key grant never extends to
        the subtree."""
        if self.management:
            return True
        if resource in SCALARS:
            return self.allowed(resource, "", want)
        best = None
        for p in self.prefix[resource]:
            if prefix.startswith(p):
                if best is None or len(p) > len(best):
                    best = p
        base = (self._grants(self.prefix[resource][best], want)
                if best is not None else self.default_allow)
        if not base:
            return False
        for rules in (self.exact[resource], self.prefix[resource]):
            for name, pol in rules.items():
                if name.startswith(prefix) and \
                        not self._grants(pol, want):
                    return False
        return True

    def allowed(self, resource: str, name: str, want: str = "read") -> bool:
        if self.management:
            return True
        if resource in SCALARS:
            got = self._grants(self.scalar.get(resource), want)
            return self.default_allow if got is None else got
        got = self._grants(self.exact[resource].get(name), want)
        if got is not None:
            return got
        best = None
        for p in self.prefix[resource]:
            if name.startswith(p):
                if best is None or len(p) > len(best):
                    best = p
        if best is not None:
            return bool(self._grants(self.prefix[resource][best], want))
        return self.default_allow


def management_authorizer() -> Authorizer:
    return Authorizer([], default_allow=True, management=True)


def anonymous_authorizer(default_allow: bool) -> Authorizer:
    return Authorizer([], default_allow=default_allow)
