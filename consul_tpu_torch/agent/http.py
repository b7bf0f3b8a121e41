"""The HTTP surface's shared parameter parsing (the port's copy of
``parse_blocking`` and ``_dur_to_s`` from ``consul_tpu/agent/http.py``:
the reference agent/http.go parseWait contract). The async serving front
end (``serving/frontend.py``) answers ``?index=`` + ``?wait=`` blocking
queries with it; the agent's REST surface comes with the host tier
(ROADMAP A21)."""

from __future__ import annotations


def _dur_to_s(s: str) -> float:
    """Parse Go-style durations ('10s', '1m', '150ms')."""
    s = s.strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    if s.endswith("m"):
        return float(s[:-1]) * 60.0
    return float(s)


def parse_blocking(q: dict, default_wait_s: float = 10.0
                   ) -> tuple[int, float]:
    """``?index=`` + ``?wait=`` -> (min_index, wait_s)."""
    min_index = int(q.get("index", 0))
    wait_s = _dur_to_s(q["wait"]) if "wait" in q else default_wait_s
    return min_index, wait_s
