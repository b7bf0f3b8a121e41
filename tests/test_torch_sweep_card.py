"""Scenario sweeps through the CUDA tick kernel against the plain tick,
on a card (marked ``cuda``; skips without a CUDA device). The module
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_sweep_card.py

A ``smallworld`` simulation (n = 4,096, K = 16) formed through the kernel
is copied into a ``kernel="torch"`` twin (world, topology, state and
draw generator); three ``scenario_random`` lanes (a Partition, a
ChurnWave and a Degrade each) run on both: every lane's counters and
final packed state are bit-equal, ``run_sweep``'s rows equal, and
neither simulation moves.
"""

import pytest
import torch

from consul_tpu_torch.chaos import sweep
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import cluster


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.reshape(-1).view(torch.uint8)]
    return [x for sub in tree for x in _leaves(sub)]


@pytest.mark.cuda
def test_card_sweep_kernel_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tick kernel runs only there")
    cfg = SimConfig(n=4096, view_degree=16, topo_family="smallworld")
    sim = cluster.Simulation(cfg, seed=0)
    sim.run(32, chunk=32, with_metrics=False)
    plain = cluster.Simulation(cfg, seed=0, kernel="torch", world=sim.world,
                               topo=sim.topo, state=sim.state)
    plain.load_state(sim.state, sim.generator_state())
    scens = sweep.scenario_random(cfg.n, 3, seed=7)
    scheds, ticks = sweep.compile_scenarios(sim, scens, settle=16)
    ks, kc, _ = sim._run_lanes(scheds, ticks)
    ps, pc, _ = plain._run_lanes(scheds, ticks)
    assert torch.equal(kc, pc)
    for lane, (a, b) in enumerate(zip(ks, ps)):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y), lane
    before = [x.clone() for x in _leaves(sim.state)]
    rows = sim.sweep(scens, settle=16)
    assert rows == plain.sweep(scens, settle=16)
    assert rows[0]["counters"] == dict(zip(
        rows[0]["counters"], kc[0].tolist()))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(sim.state), before))
