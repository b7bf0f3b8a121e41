"""Game-day plane: the federated soak harness with an SLO gate (PyTorch
port of ``consul_tpu/gameday``).

``harness.py`` runs the full stack at once: composed chaos riding the
compiled schedule with the raft tier armed, sustained mixed traffic
through either host front end, a DCN-federated leg, watchers through the
watch plane, phased warmup -> steady -> fault -> heal -> drain, with a
resume at drained phase boundaries. ``slo.py`` turns the measurements into
the one pass/fail verdict and holds the golden regression points as data;
``swarm.py`` is the multi-process HTTP client swarm for the async front
end's socket surface. Its workers import this package, so nothing here
imports ``torch`` up front: the harness loads on first use.
"""

from consul_tpu_torch.gameday.slo import SloThresholds, evaluate, load_goldens

PHASES = ("warmup", "steady", "fault", "heal", "drain")

__all__ = [
    "GamedayConfig", "PHASES", "SloThresholds", "evaluate",
    "load_goldens", "run_gameday",
]


def __getattr__(name):
    if name in ("GamedayConfig", "run_gameday"):
        from consul_tpu_torch.gameday import harness

        return getattr(harness, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
