"""PyTorch port vs the JAX reference: ``swim.step_counted`` tick by tick.

Both sides start from the reference's state and take the same random
numbers (the port's TickDraws rebuilt from the reference's key ladder).
Over 32 ticks, with 5 % of the nodes killed at tick 8 and 2 % packet
loss: every int/bool SimState field and all 26 counters equal on every
tick; the Vivaldi and RTT-window floats within rtol 1e-5 (atol 1e-7) —
the same f32 operations in the same order, with reductions that XLA and
PyTorch may sum in another order.
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models import state as jstate
from consul_tpu.models import swim as jswim
from consul_tpu_torch import convert
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

TICKS = 32
KILL_AT = 8


@pytest.mark.parametrize("n,view_degree", [(256, 0), (1024, 16)],
                         ids=["dense-256", "sparse-1024-k16"])
def test_step_counted_matches_reference(n, view_degree):
    jcfg, tcfg, world, topo, st = tp.setup(n, view_degree, packet_loss=0.02)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    ts = convert.sim_state_from(tp.np_tree(st))
    assert tt.dense == (view_degree == 0)
    step = jax.jit(lambda s, k: jswim.step_counted(jcfg, topo, world, s, k))
    draws = tp.make_draws_fn(jcfg)
    base = jax.random.PRNGKey(17)
    kill = np.zeros(n, bool)
    kill[: n // 20] = True
    totals = np.zeros(26, np.int64)
    for t in range(TICKS):
        if t == KILL_AT:
            st = jstate.kill(st, kill)
            ts = tstate.kill(ts, torch.from_numpy(kill))
        key = jax.random.fold_in(base, t)
        st, jc = step(st, key)
        ts, tc = tswim.step_counted(tcfg, tt, tw, ts, tp.to_tick_draws(draws(key)))
        tp.assert_state_matches(tp.np_tree(st), ts, f"tick {t}")
        want = [int(x) for x in jc]
        assert [int(x) for x in tc] == want, f"tick {t} counters"
        totals += want
    # The run exercised the probe, suspicion and gossip paths.
    fields = tswim.counters_mod.FIELDS
    for f in ("probes_sent", "probe_timeouts", "suspicions_started",
              "gossip_rx", "pushpull_merges"):
        assert totals[fields.index(f)] > 0, f


def test_draw_tick_shapes():
    _, tcfg = tp.configs(n=128, view_degree=16)
    d = tswim.draw_tick(tcfg, torch.Generator().manual_seed(0), "cpu")
    g = tcfg.gossip
    assert d.perm_u.shape == (128, 16) and d.u_drop.shape == (128, g.gossip_nodes)
    assert d.relay_jcols.shape == (g.indirect_checks,) and d.pp_j.dim() == 0
    assert float(d.viv_fb.min()) >= -0.5 and float(d.viv_fb.max()) < 0.5
    assert int(d.relay_jcols.max()) < 16


def test_popcount_and_peel():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x12345678])
    assert tswim.popcount(x).tolist() == [bin(int(v)).count("1") for v in x]
    vals, idx = tswim._top_k_peel(torch.tensor([[1, 3, 3, 0, 3]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3, 3, 3]]
