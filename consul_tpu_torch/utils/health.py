"""Check-status severity ordering, shared by every rollup.

The port's copy of ``consul_tpu/utils/health.py``; it imports nothing of the reference package.

The reference encodes this precedence wherever check statuses are
aggregated (structs' check status precedence; agent/checks/alias.go
worst-of; ui_endpoint.go summaries): passing < warning < critical,
and any unrecognized status ranks as critical.
"""

from __future__ import annotations

_ORDER = {"passing": 0, "warning": 1}


def severity(status: str) -> int:
    return _ORDER.get(status, 2)


def worst_status(statuses) -> str:
    """The most severe of ``statuses`` (an empty set is passing —
    reference alias.go:150-158: no checks at all means passing)."""
    worst = "passing"
    for s in statuses:
        if severity(s) > severity(worst):
            worst = s
    return worst
