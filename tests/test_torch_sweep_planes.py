"""PyTorch port vs the JAX reference: scenario sweeps of the serf plane
and of the raft tier (``consul_tpu_torch/chaos/sweep.py``,
``SerfSimulation.sweep``, ``run_sweep`` with ``set_raft`` armed), with the
helpers and sizes of tests/test_torch_sweep.py (a file of its own so that
each file's reference compiles stay short).

- ``SerfSimulation``: the port's rows equal the reference's lane for lane
  for ``scenario_grid(N, 3)``.
- Raft (the reference's tests/test_raft_device.py sweep case, n = 64):
  the rows carry ``raft``, equal to the reference's (terms, leaders,
  commit, committed clients, every raft counter), and the live plane's
  summary and counters do not move.
"""

import jax

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.chaos import sweep as jsweep
from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.models import cluster as jcluster
from consul_tpu.models import raft as jraft_mod
from consul_tpu.ops import raft_ops as jraft
from consul_tpu_torch import convert
from consul_tpu_torch.chaos import schedule as tchaos
from consul_tpu_torch.chaos import sweep as tsweep
from consul_tpu_torch.config import RaftConfig as TRaftConfig
from consul_tpu_torch.models import cluster as tcluster

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401
from test_torch_sweep import (CHUNK, N, TICKS, _assert_rows_equal, _draws_fn,
                              _formed_pair, _to_ref)


def test_serf_sweep_matches_reference():
    jsim, tsim = _formed_pair(jcluster.SerfSimulation, "circulant")
    want = jsweep.run_sweep(jsim, jsweep.scenario_grid(N, 3), ticks=TICKS,
                            chunk=CHUNK)
    got = tsim.sweep(tsweep.scenario_grid(N, 3), ticks=TICKS, chunk=CHUNK)
    _assert_rows_equal(got, want)


def _raft_pair():
    """tests/test_raft_device.py's sweep case (n = 64, seed 3, 2x3 groups,
    24 ticks formed with raft armed), formed by the port on the
    reference's gossip and raft ladders and handed to both sides."""
    jcfg, tcfg = tp.configs(n=64, view_degree=12)
    kw = dict(groups=2, peers=3, window=16, election_ticks_min=6,
              election_ticks_max=12)
    jr, tr = JRaftConfig(**kw), TRaftConfig(**kw)
    jsim = jcluster.Simulation(jcfg, seed=3)
    jplane = jsim.set_raft(jr)
    init_key = jraft_mod.init_key_of(jsim)
    base = jsim.base_key
    draws = _draws_fn(jcfg, False)
    tsim = tcluster.Simulation(
        tcfg, seed=3, kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(jsim.world)),
        topo=convert.topology_from(tp.np_tree(jsim.topo)),
        state=convert.sim_state_from(tp.np_tree(jsim.state)),
        draws=lambda t: tp.to_tick_draws(draws(jax.random.fold_in(base, t))))
    tplane = tsim.set_raft(
        tr, draws=lambda t: convert.raft_draws_from(jraft.draw_table(jr, base, t)),
        timers=convert.raft_draws_from(jraft.timeout_draws(jr, init_key, 0,
                                                           jr.groups)))
    tsim.run(24, chunk=12, with_metrics=False)
    jsim.state = _to_ref(jsim.state, tsim.swim_state)
    jplane.state = _to_ref(jplane.state, tplane.state)
    return jsim, tsim


def test_raft_rows_match_reference_and_leave_the_plane():
    jsim, tsim = _raft_pair()
    scen = lambda C: [[C.RaftStorm(start=2, stop=18)],  # noqa: E731
                      [C.RaftKill(start=2, stop=14, group=0, peer=-1)]]
    base = tsim.raft.summary()
    base_counters = tsim.raft.counters_snapshot()
    want = jsweep.run_sweep(jsim, scen(jchaos), ticks=32, chunk=16)
    got = tsweep.run_sweep(tsim, scen(tchaos), ticks=32, chunk=16)
    _assert_rows_equal(got, want)
    for g, w in zip(got, want):
        assert g["raft"] == w["raft"]
        assert set(g["raft"]) >= {"terms", "leaders", "commit",
                                  "committed_clients", "counters"}
    assert max(got[0]["raft"]["terms"]) > max(base["terms"])
    assert got[1]["raft"]["counters"]["elections_won"] > 0
    assert tsim.raft.summary() == base
    assert tsim.raft.counters_snapshot() == base_counters
