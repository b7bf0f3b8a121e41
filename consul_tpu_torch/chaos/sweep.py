"""Adversarial scenario sweeps and the view-graph Pareto table (PyTorch
port of ``consul_tpu/chaos/sweep.py``).

A sweep runs S fault scenarios against one formed simulation, each in a
lane of its own: a copy of the live state, its own compiled schedule
shifted onto the live tick, the tick with the sentinel off
(``Simulation._run_lanes``). The simulation itself does not advance.

Parity contract: every lane takes the same draw bundle at a tick, the one
the simulation's draw source gives a schedule-armed tick (with ``u_pp``),
and the draw generator is put back afterwards. So lane ``s`` consumes
exactly the random numbers a solo :meth:`Simulation.run_scenario` replay
of scenario ``s`` from the same state and generator state consumes, and
its counters equal that replay's. With the reference's key ladder as the
draw source, they equal the reference's ``run_sweep``.

The reference stacks the lanes on a leading axis and vmaps one compiled
chunk body over them; here the lanes are a list stepped tick by tick
through the CUDA tick kernel (or its plain version), since there is no
executable to share: the view-graph family enters the kernel as its
offset tables, so every family runs the same code. ``chunk`` is the
reference's executable length: the sweeps take it for the reference's
signature and do not use it; ``bench_pareto`` forms in chunks of it.

The reference refuses a packed simulation because its vmapped body is
written on the dense pytree; the port's card path is the packed layout,
and both layouts give the same counters, so both are taken here. On a
sharded simulation every lane is a placed copy of the state
(``parallel/shard_step.place_lanes``, the reference's ``place_sweep``)
stepped by the sharded runner (``ShardedChunkRunner.run_lanes``, the
reference's ``make_sharded_sweep_runner``): on the card the chaos
variant of B7 with the sentinel off, lane by lane each tick. A
raft-armed sweep on a mesh raises, as the reference's does. A sweep lane
is warmed by ``utils/prewarm.prewarm(..., sweep=S)`` (A20); the kernel's
one build, cached on disk, stands for the reference's executable cache.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig, clamp_view_degree
from consul_tpu_torch.models import cluster
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.ops import raft_ops
from consul_tpu_torch.parallel import mesh as mesh_mod
from consul_tpu_torch.topo import spectral_gap

# Estimated wire bytes for the Pareto bandwidth axis, mirroring the
# reference msgpack encodings the 1400-byte UDP budget is divided by
# (memberlist state.go/util.go): a compound-message frame per packet
# plus ~33 encoded bytes per piggybacked alive/suspect/dead message.
PACKET_OVERHEAD_BYTES = 12
MSG_BYTES = 33


def _check_sim(sim):
    if sim.topo.dense:
        raise ValueError(
            "chaos sweeps need the sparse view (view_degree > 0): "
            "topology families only differ there — pass --view-degree "
            "(an even K, e.g. 16)")


def _upload(sched, device):
    """A host schedule onto ``device``; onto a card through pinned memory
    without waiting, so a sweep's set-up makes no host sync."""
    if device.type != "cuda":
        return chaos_mod.to_device(sched, device)
    return chaos_mod.ChaosSchedule(*(
        x.pin_memory().to(device, non_blocking=True) for x in sched))


def compile_scenarios(sim, scenarios, ticks=None, settle: int = 64):
    """Compile, shape-check and rebase the scenarios' schedules onto the
    sim's live tick (values only, as run_scenario does); returns the
    schedules on the sim's device and the tick count (default: the last
    stop plus ``settle``)."""
    if not scenarios:
        raise ValueError("empty scenario sweep")
    scheds = [chaos_mod.compile_schedule(sim.cfg.n, ev) for ev in scenarios]
    keys = {chaos_mod.static_key_of(s) for s in scheds}
    if len(keys) != 1 or None in keys:
        raise ValueError(
            "sweep scenarios must share one schedule shape so they can "
            f"stack into one executable; got shapes {sorted(map(str, keys))}"
            " — pad the short ones with no-op entries (empty node slices"
            " / zero loss rates)")
    if ticks is None:
        stops = [int(e.stop) for ev in scenarios for e in ev]
        ticks = (max(stops) if stops else 0) + settle
    return [_upload(chaos_mod.shift_schedule(s, sim._t), sim.device)
            for s in scheds], ticks


def run_sweep(sim, scenarios, *, ticks=None, chunk: int = 32,
              settle: int = 64):
    """Run S fault scenarios against ``sim``'s current state; returns a
    list of S dicts ``{"slo": ..., "counters": ..., "ticks": ...}`` in
    input order.

    ``scenarios`` is a sequence of event lists (Partition/LinkLoss/
    ChurnWave/Degrade, plus RaftKill/RaftPartition/RaftStorm when the
    sim's raft tier is armed), all compiling to the same slot shape
    (chaos/schedule.static_key_of). Each runs on its own copy of the
    state — ``sim`` itself is not advanced — with start/stop rebased
    onto the live tick, for ``ticks`` ticks (default: global max stop
    + ``settle``). Counter semantics match
    :meth:`Simulation.run_scenario` exactly.

    With ``sim.set_raft(...)`` armed, every lane also steps a copy of the
    live RaftState and each row gains a ``raft`` entry: per-group
    terms/leaders/commit/committed_clients after the scenario plus the
    scenario's raft counters. The counters come back in one device ->
    host copy, the raft rows in one more. ``chunk`` is not used: the
    lanes step tick by tick, with no executable length to choose. On a
    sharded simulation the lanes run over its mesh; raft-armed sweeps
    are single-device only (a mesh sweep with raft armed raises)."""
    _check_sim(sim)
    scheds, ticks = compile_scenarios(sim, scenarios, ticks, settle)
    _, cnt, raft = sim._run_lanes(scheds, ticks)
    n_scen = len(scheds)

    raft_rows = None
    if raft is not None:
        rsts, rcnt = raft
        r = sim.raft.rcfg.groups
        summ = torch.stack([torch.stack(raft_ops.summary(x)) for x in rsts])
        raft_rows = [{
            "terms": row[:r], "leaders": row[r:2 * r],
            "commit": row[2 * r:3 * r], "committed_clients": row[3 * r:4 * r],
            "counters": dict(zip(raft_ops.FIELDS, row[4 * r:])),
        } for row in torch.cat([summ.flatten(1), rcnt], dim=1).tolist()]

    vals = cnt.tolist()
    sim.sink.incr_counter("sim.sweep.runs", 1)
    sim.sink.incr_counter("sim.sweep.scenarios", n_scen)
    results = []
    for s in range(n_scen):
        deltas = dict(zip(counters_mod.FIELDS, vals[s]))
        slo = {cluster.SLO_KEYS[f]: deltas[f] for f in cluster.SLO_KEYS}
        row = {"slo": slo, "counters": deltas, "ticks": ticks}
        if raft_rows is not None:
            row["raft"] = raft_rows[s]
        results.append(row)
    return results


# ---------------------------------------------------------------------------
# Scenario generators: the search space of the worst-case plane.

def scenario_grid(n: int, count: int, *, start: int = 4):
    """``count`` partition scenarios over a (fraction x duration) grid —
    all one Partition slot, so the whole grid stacks into one sweep."""
    fracs = [0.1, 0.2, 0.3, 0.45]
    durs = [8, 12, 16, 24]
    out = []
    for i in range(count):
        fr = fracs[i % len(fracs)]
        du = durs[(i // len(fracs)) % len(durs)]
        out.append([chaos_mod.Partition(
            start=start, stop=start + du,
            side_a=slice(0, max(1, int(n * fr))))])
    return out


def scenario_random(n: int, count: int, seed: int = 0, *, start: int = 4,
                    max_dur: int = 24):
    """``count`` seeded random compound scenarios, each one Partition +
    one ChurnWave + one Degrade slot (no-op entries keep the shape
    uniform when a draw lands at zero intensity)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        fr = float(rng.uniform(0.05, 0.45))
        du = int(rng.integers(6, max_dur + 1))
        churn = int(n * float(rng.uniform(0.0, 0.2)))
        tx_loss = float(rng.uniform(0.0, 0.5))
        out.append([
            chaos_mod.Partition(start=start, stop=start + du,
                                side_a=slice(0, max(1, int(n * fr)))),
            chaos_mod.ChurnWave(start=start, stop=start + du,
                                nodes=slice(0, churn)),
            chaos_mod.Degrade(start=start, stop=start + du,
                              nodes=slice(0, max(1, n // 10)),
                              tx_loss=tx_loss),
        ])
    return out


def worst_case(results):
    """Index of the worst scenario: slowest heal, then most false
    deaths, then slowest detection — the argmax the sweep plane
    searches for."""
    def severity(r):
        s = r["slo"]
        return (s["time_to_heal"], s["false_positive_deaths"],
                s["time_to_first_suspect"])

    return max(range(len(results)), key=lambda i: severity(results[i]))


# ---------------------------------------------------------------------------
# Pareto table: bandwidth vs convergence per family.

def wire_bytes_per_tick_node(counters: dict, ticks: int, n: int) -> float:
    """Estimated gossip-plane wire bytes per tick per node over a
    scenario window (the Pareto bandwidth axis): packets pay the
    compound-frame overhead, each piggybacked message its encoded
    size."""
    total = (counters["gossip_tx"] * PACKET_OVERHEAD_BYTES
             + counters["gossip_msgs_tx"] * MSG_BYTES)
    return float(total) / float(max(1, ticks) * n)


def pareto_table(per_family: dict) -> list:
    """Rank family summaries on (bytes/tick/node, worst time-to-heal).
    Adds ``dominated_by`` to each row (standard Pareto dominance:
    <= on both axes, < on at least one). Rows sort by bytes."""
    rows = [dict(family=fam, **d) for fam, d in per_family.items()]
    for r in rows:
        r["dominated_by"] = sorted(
            o["family"] for o in rows
            if o["family"] != r["family"]
            and o["bytes_per_tick_node"] <= r["bytes_per_tick_node"]
            and o["time_to_heal_worst"] <= r["time_to_heal_worst"]
            and (o["bytes_per_tick_node"] < r["bytes_per_tick_node"]
                 or o["time_to_heal_worst"] < r["time_to_heal_worst"]))
    return sorted(rows, key=lambda r: r["bytes_per_tick_node"])


def strict_dominators(per_family: dict, baseline: str = "circulant"):
    """Families strictly better than ``baseline`` on BOTH axes (the
    acceptance bar: lower bytes AND faster worst-case heal)."""
    base = per_family.get(baseline)
    if base is None:
        return []
    return sorted(
        fam for fam, d in per_family.items()
        if fam != baseline
        and d["bytes_per_tick_node"] < base["bytes_per_tick_node"]
        and d["time_to_heal_worst"] < base["time_to_heal_worst"])


def family_sweep(sim, scenarios, *, ticks=None, chunk: int = 32,
                 settle: int = 64) -> dict:
    """Sweep one formed sim and fold the results into a JSON-ready
    per-family summary row (the Pareto table input)."""
    results = run_sweep(sim, scenarios, ticks=ticks, chunk=chunk,
                        settle=settle)
    ticks_run = results[0]["ticks"]
    n = sim.cfg.n
    byt = [wire_bytes_per_tick_node(r["counters"], ticks_run, n)
           for r in results]
    heal = [r["slo"]["time_to_heal"] for r in results]
    wi = worst_case(results)
    return {
        "degree": sim.topo.degree,
        "spectral_gap": round(
            spectral_gap(np.asarray(sim.topo.off_host), n), 6),
        "bytes_per_tick_node": round(float(np.mean(byt)), 3),
        "time_to_heal_worst": int(max(heal)),
        "time_to_heal_mean": round(float(np.mean(heal)), 2),
        "worst_scenario": int(wi),
        "worst_slo": dict(results[wi]["slo"]),
        "scenarios": [
            {"bytes_per_tick_node": round(float(b), 3), **r["slo"]}
            for b, r in zip(byt, results)
        ],
    }


def bench_pareto(*, n: int, degree: int, scenarios: int,
                 families=("circulant", "expander", "smallworld", "hier"),
                 seed: int = 0, form_ticks: int = 64, chunk: int = 32,
                 settle: int = 64, mode: str = "grid",
                 sweep_seed: int = 0, serf: bool = False,
                 device: str = "cuda", kernel: str = "cuda",
                 mesh=None) -> dict:
    """The reference bench's ``topology`` phase body: form one sim per
    family at equal degree, run the same S-scenario sweep against each,
    and emit the bandwidth-vs-convergence Pareto table. ``mesh`` shards
    every family's simulation, whose device is then the mesh's first."""
    cls = cluster.SerfSimulation if serf else cluster.Simulation
    if mesh is not None and not isinstance(mesh, mesh_mod.Mesh):
        mesh = mesh_mod.make_mesh(list(mesh))
    scens = (scenario_grid(n, scenarios) if mode == "grid"
             else scenario_random(n, scenarios, seed=sweep_seed))
    per_family = {}
    for fam in families:
        cfg = SimConfig(n=n, view_degree=clamp_view_degree(n, degree),
                        topo_family=fam)
        sim = cls(cfg, seed=seed, kernel=kernel, mesh=mesh,
                  device=device if mesh is None else mesh.devices[0])
        sim.run(form_ticks, chunk=chunk, with_metrics=False)
        per_family[fam] = family_sweep(sim, scens, chunk=chunk,
                                       settle=settle)
    return {
        "n": int(n),
        "degree": int(degree),
        "scenario_count": int(scenarios),
        "mode": mode,
        "families": list(families),
        "pareto": pareto_table(per_family),
        "dominates_default": strict_dominators(per_family),
    }
