"""The port's gossip tick module (consul_tpu_torch/ops/cuda_gossip.py).

- The plain version (unpack -> step -> pack) against the reference's
  Pallas tick in interpret mode, 4 ticks at n = 256, K = 16: discrete
  packed leaves and counters bit-equal; each bfloat16/float8 leaf within
  MAX_STEPS storage steps (ulps) of the reference's, or within FLOOR_S
  seconds (height_min) where values cross zero, since a last-bit f32
  difference in a reduction can flip a rounding.
- The CUDA wrapper raises on CPU tensors and on what it does not take;
  the module imports and selects engines without nvcc. The kernel itself
  runs only on a card and is held against the plain version there by
  chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models import layout as jlayout
from consul_tpu.ops import pallas_gossip
from consul_tpu_torch import convert
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


def test_cuda_wrapper_rejects_dense_views_and_bad_limits():
    cfg = TSimConfig(n=64, view_degree=0)
    topo = ttopo.make_topology(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sparse"):
        cuda_gossip.make_tick_kernel(cfg, topo)
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

