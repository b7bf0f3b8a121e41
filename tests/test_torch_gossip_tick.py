"""The port's gossip tick module (consul_tpu_torch/ops/cuda_gossip.py).

- The plain version (unpack -> step -> pack) against the reference's
  Pallas tick in interpret mode, 4 ticks at n = 256, K = 16: discrete
  packed leaves and counters bit-equal; each bfloat16/float8 leaf within
  MAX_STEPS storage steps (ulps) of the reference's, or within FLOOR_S
  seconds (height_min) where values cross zero, since a last-bit f32
  difference in a reduction can flip a rounding.
- The dense view (K = N - 1): at n = 64 the plain versions, bare and
  serf, each with and without a fault schedule (and the sentinel), against
  the reference's interpret-mode tick on the dense topology over 10 ticks
  after a kill, bit-equal as above; the kernel's dense topology tables equal the closed forms and
  ``topology_from_offsets`` over offsets 1..n-1.
- The CUDA wrapper raises on CPU tensors and on what it does not take
  (K > 255); the module imports and selects engines without nvcc. The
  kernel itself runs only on a card and is held against the plain version
  there by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.models import layout as jlayout
from consul_tpu.models import serf as jserf
from consul_tpu.models import swim as jswim
from consul_tpu.ops import pallas_gossip
from consul_tpu_torch import convert
from consul_tpu_torch.models import counters as tcounters
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.ops import cuda_gossip, topology as ttopo

import torch_parity as tp


def test_plain_tick_matches_interpret_tick():
    jcfg, tcfg, world, topo, st = tp.setup(256, 16, packet_loss=0.02)
    kill = np.zeros(256, bool)
    kill[:13] = True
    st = st._replace(alive_truth=st.alive_truth & ~kill)
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo))
    draws = tp.make_draws_fn(jcfg)
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    pp = convert.packed_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(17)
    for t in range(4):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, None, kp, key)
        pp, pc = cuda_gossip.plain_tick(tcfg, tt, tw, pp,
                                        tp.to_tick_draws(draws(key)))
        tp.assert_packed_close(tp.np_tree(kp), pp, f"tick {t}")
        assert pc.tolist() == [int(x) for x in kc], f"tick {t} counters"


def _small(n=128, k=16):
    cfg = TSimConfig(n=n, view_degree=k)
    gen = torch.Generator().manual_seed(0)
    world = ttopo.make_world(cfg, gen)
    topo = ttopo.make_topology(cfg, gen)
    st = tlayout.pack(tstate.init(cfg, gen))
    return cfg, world, topo, st, tswim.draw_tick(cfg, gen, "cpu")


def test_cuda_wrapper_raises_on_cpu_tensors():
    cfg, world, topo, st, d = _small()
    kernel = cuda_gossip.make_tick_kernel(cfg, topo)
    before = dict(cuda_gossip.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(world, st, d)
    assert cuda_gossip.LAUNCHES == before


def _dense_events(C, n):
    """A partition, a churn wave whose kill and revive edges fall in the
    window, a lossy link and a degraded block."""
    return [C.Partition(1, 10, slice(0, n // 4)),
            C.ChurnWave(1, 20, slice(n // 2, n // 2 + 4), period=4,
                        down_ticks=2),
            C.LinkLoss(0, 14, slice(0, n // 8), slice(n // 8, n // 4), fwd=0.8,
                       rev=0.2),
            C.Degrade(0, 14, slice(n - n // 8, n), tx_loss=0.4)]


@pytest.mark.parametrize("serf_plane,chaos", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["bare", "bare-chaos-sentinel", "serf", "serf-chaos-sentinel"])
def test_dense_plain_ticks_match_interpret_tick(serf_plane, chaos):
    n = 64
    jcfg, tcfg, world, topo, st = tp.setup(n, 0, packet_loss=0.01)
    assert topo.dense and jcfg.degree == n - 1
    if serf_plane:
        st = jserf.init(jcfg, jax.random.PRNGKey(4))._replace(swim=st)
        ev = np.zeros(n, bool)
        ev[[20, 50]] = True
        st = jserf.user_event(jcfg, st, ev, 7)
        st = jserf.query(jcfg, st, np.arange(n) == 5, 3)
    sw = st.swim if serf_plane else st
    kill = np.zeros(n, bool)
    kill[:8] = True
    sw = sw._replace(alive_truth=sw.alive_truth & ~kill)
    st = st._replace(swim=sw) if serf_plane else sw
    js = jchaos.compile_schedule(n, _dense_events(jchaos, n)) if chaos else None
    ts = convert.schedule_from(tp.np_tree(js)) if chaos else None
    step_fn = jserf.step_counted if serf_plane else jswim.step_counted
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo, step_fn=step_fn,
                                                sentinel=chaos))
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    assert tt.dense
    if serf_plane:
        draws = tp.make_serf_draws_fn(jcfg, chaos=chaos)
        pp = convert.serf_state_from(tp.np_tree(kp))
    else:
        draws = tp.make_draws_fn(jcfg, chaos=chaos)
        pp = convert.packed_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(31)
    totals = np.zeros(len(tcounters.FIELDS), np.int64)
    for t in range(10):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, js, kp, key)
        if serf_plane:
            pp, pc = cuda_gossip.plain_serf_tick(
                tcfg, tt, tw, pp, tp.to_serf_draws(draws(key)), ts, chaos)
            tp.assert_serf_equal(tp.np_tree(kp), pp, f"tick {t}")
            tp.assert_packed_close(tp.np_tree(kp).swim, pp.swim, f"tick {t}")
        else:
            pp, pc = cuda_gossip.plain_tick(tcfg, tt, tw, pp,
                                            tp.to_tick_draws(draws(key)), ts,
                                            chaos)
            tp.assert_packed_close(tp.np_tree(kp), pp, f"tick {t}")
        want = [int(x) for x in kc]
        assert pc.tolist() == want, f"tick {t} counters"
        totals += want
    fields = tcounters.FIELDS
    assert totals[fields.index("suspicions_started")] > 0
    if chaos:
        assert totals[fields.index("chaos_msgs_dropped")] > 0
    if serf_plane:
        assert totals[fields.index("serf_intents_queued")] > 0


def test_dense_topology_tables_match_closed_forms():
    """The kernel's dense rcol/inv come from topology.remap_row/inv_col;
    they equal the reference's closed forms and the sparse construction
    over the offsets 1..n-1."""
    from consul_tpu.ops import topology as jtopo
    for n in (64, 256):
        cfg = TSimConfig(n=n, view_degree=0)
        topo = ttopo.make_topology(cfg, torch.Generator().manual_seed(0))
        assert topo.dense and topo.degree == n - 1 <= 255
        off, rcol, inv = cuda_gossip.make_tick_kernel(cfg, topo)._topo_tables(
            torch.device("cpu"))
        k = n - 1
        assert rcol.dtype == inv.dtype == off.dtype == torch.int32
        assert rcol.shape == (k * k,) and inv.shape == (k,)
        sparse = ttopo.topology_from_offsets(n, np.arange(1, n))
        assert torch.equal(rcol.reshape(k, k), sparse.rcol.to(torch.int32))
        assert torch.equal(inv, sparse.inv.to(torch.int32))
        jt = jtopo.Topology(n=n, dense=True, off=np.arange(1, n, dtype=np.int32),
                            rcol=None, inv=None)
        want = np.stack([np.asarray(jtopo.remap_row(jt, j)) for j in range(k)])
        np.testing.assert_array_equal(rcol.reshape(k, k).numpy(), want)
        np.testing.assert_array_equal(
            inv.numpy(), [int(jtopo.inv_col(jt, j)) for j in range(k)])


def test_cuda_wrapper_rejects_dense_views_and_bad_limits():
    # The dense view is taken up to K = 255 and refused past it.
    cfg = TSimConfig(n=64, view_degree=0)
    topo = ttopo.make_topology(cfg, torch.Generator().manual_seed(0))
    cuda_gossip.make_tick_kernel(cfg, topo)
    wide = TSimConfig(n=300, view_degree=0)
    topo = ttopo.make_topology(wide, torch.Generator().manual_seed(0))
    for serf_plane in (False, True):
        with pytest.raises(ValueError, match="K <= 255"):
            cuda_gossip.make_tick_kernel(wide, topo, serf_plane=serf_plane,
                                         sentinel=True)
    cfg = TSimConfig(n=128, view_degree=16)
    cfg = cfg.__class__(n=128, view_degree=16,
                        gossip=cfg.gossip.__class__(gossip_nodes=9))
    topo = ttopo.make_topology(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="gossip_nodes"):
        cuda_gossip.make_tick_kernel(cfg, topo)


def test_validate_kernel():
    cuda_gossip.validate_kernel("torch", "dense", "cpu")
    cuda_gossip.validate_kernel("cuda", "packed", "cuda")
    with pytest.raises(ValueError):
        cuda_gossip.validate_kernel("cuda", "packed", "cpu")
    with pytest.raises(ValueError):
        cuda_gossip.validate_kernel("cuda", "dense", "cuda")
    with pytest.raises(ValueError):
        cuda_gossip.validate_kernel("pallas", "packed", "cuda")


def test_module_imports_and_builds_nothing_without_nvcc(monkeypatch, tmp_path):
    assert cuda_gossip._LIB is None and cuda_gossip._LIB_INFO is None
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_gossip.build()
    assert cuda_gossip._LIB is None and cuda_gossip._LIB_INFO is None


def test_hbm_contract_matches_reference():
    jcfg, tcfg = tp.configs(n=1024, view_degree=32)
    from consul_tpu.models import state as jstate
    from consul_tpu.ops import topology as jtopo
    jst = jlayout.pack(jstate.init(jcfg, jax.random.PRNGKey(0)))
    jw = jtopo.make_world(jcfg, jax.random.PRNGKey(1))
    want = pallas_gossip.tick_hbm_bytes_per_node(jst, jw)
    gen = torch.Generator().manual_seed(0)
    got = cuda_gossip.tick_hbm_bytes_per_node(
        tlayout.pack(tstate.init(tcfg, gen)), ttopo.make_world(tcfg, gen))
    assert got == want
    assert round(got) == 1088
    # The kernel's own buffers (draws, topology tables, scratch) on top.
    st = tlayout.pack(tstate.init(tcfg, gen))
    kernel = cuda_gossip.make_tick_kernel(tcfg, ttopo.make_topology(tcfg, gen))
    moved = kernel.buffer_bytes_per_node(ttopo.make_world(tcfg, gen), st,
                                         tswim.draw_tick(tcfg, gen, "cpu"))
    assert moved > got

