"""Golden SLO measurement points: the worst-case regression alarm (PyTorch
port of ``consul_tpu/gameday/goldens.py``).

Two fixed, fast, deterministic probes whose results are stored as data
(``slo_goldens.json``, the port's own, in ticks) and re-measured by
``tests/test_torch_gameday.py``:

- **topology**: the ``worst_case`` heal-time argmax over the standard
  partition scenario grid at a fixed (n, degree, S) point;
- **raft**: commit-visibility latency in ticks (chunk-quantized) for
  proposed writes on a small armed simulation, the quorum-commit path the
  game day's lost-writes gate depends on.

Both reuse the paths the game day runs (``chaos/sweep.run_sweep`` and
``worst_case``; ``RaftPlane.propose`` and the chunk pump) at regression
scale. Like every entry point of the port, both probes run on the card
unless the caller asks for the CPU. The stored points were measured with
``device="cpu", kernel="torch"``: the card's generator draws other
numbers, so it walks another trajectory. Running this module re-measures
them on the CPU.
"""

from __future__ import annotations


def measure_topology(n: int = 256, degree: int = 8, scenarios: int = 4,
                     settle: int = 96, chunk: int = 32,
                     form_ticks: int = 64, seed: int = 0,
                     device: str = "cuda", kernel: str = "cuda") -> dict:
    """Worst-case heal time over the standard partition grid at one fixed
    sweep point. Deterministic for a fixed config and device."""
    from consul_tpu_torch.chaos import sweep as sweep_mod
    from consul_tpu_torch.config import SimConfig
    from consul_tpu_torch.models.cluster import Simulation

    sim = Simulation(SimConfig(n=n, view_degree=degree), seed=seed,
                     device=device, kernel=kernel)
    sim.run(form_ticks, chunk=chunk, with_metrics=False)
    results = sweep_mod.run_sweep(
        sim, sweep_mod.scenario_grid(n, scenarios), chunk=chunk, settle=settle)
    wi = sweep_mod.worst_case(results)
    worst = results[wi]["slo"]
    return {
        "n": n, "degree": degree, "scenarios": scenarios,
        "settle": settle, "chunk": chunk, "seed": seed,
        "worst_index": wi,
        "time_to_heal": int(worst["time_to_heal"]),
        "false_positive_deaths": int(worst["false_positive_deaths"]),
        "time_to_first_suspect": int(worst["time_to_first_suspect"]),
    }


def measure_raft_commit(n: int = 256, groups: int = 4, peers: int = 3,
                        window: int = 64, probes: int = 6,
                        rchunk: int = 8, seed: int = 0,
                        device: str = "cuda", kernel: str = "cuda") -> dict:
    """Commit-visibility latency in ticks for proposed writes: propose one
    entry, step the simulation in ``rchunk``-tick chunks until the quorum
    commit releases the ticket. Quantized to ``rchunk``."""
    from consul_tpu_torch.config import RaftConfig, SimConfig
    from consul_tpu_torch.models.cluster import Simulation
    from consul_tpu_torch.ops import deltas

    sim = Simulation(SimConfig(n=n, view_degree=8), seed=seed, device=device,
                     kernel=kernel)
    plane = sim.set_raft(RaftConfig(groups=groups, peers=peers, window=window))
    # Form, and the first elections.
    sim.run(4 * rchunk, chunk=rchunk, with_metrics=False)
    lat = []
    for i in range(probes):
        tk = plane.propose([(deltas.OP_KV_PUT, i, 1)])
        ticks = 0
        while not tk.done.is_set() and ticks < 32 * rchunk:
            sim.run(rchunk, chunk=rchunk, with_metrics=False)
            ticks += rchunk
        lat.append(ticks)
    lat.sort()
    return {
        "n": n, "groups": groups, "peers": peers, "window": window,
        "probes": probes, "rchunk": rchunk, "seed": seed,
        "commit_ticks_p50": int(lat[len(lat) // 2]),
        "commit_ticks_p99": int(lat[-1]),
        "all_committed": all(x < 32 * rchunk for x in lat),
    }


if __name__ == "__main__":
    # Re-measure both probes at their golden configs; write the values
    # into slo_goldens.json when a deliberate protocol change moves them.
    # The stored points are CPU trajectories, so this asks for the CPU.
    import json

    cpu = {"device": "cpu", "kernel": "torch"}
    print(json.dumps({"topology": measure_topology(**cpu),
                      "raft": measure_raft_commit(**cpu)}, indent=2))
