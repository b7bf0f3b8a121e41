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
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.ops import cuda_gossip, topology as ttopo

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401


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


@pytest.mark.parametrize("n,view_degree", [(128, 8), (16, 0)],
                         ids=["k8", "dense16"])
def test_plain_tick_matches_interpret_tick_when_rows_wrap_and_budgets_tie(
        n, view_degree):
    """Every row's probe due with its cursor at the last column, so every
    live row wraps and reshuffles on the first tick, and the view's
    budgets on three values drawn with numpy, so the top-P peel by budget
    ties: the plain tick against the reference's interpret-mode tick, 3
    ticks, as test_plain_tick_matches_interpret_tick compares them."""
    jcfg, tcfg, world, topo, st = tp.setup(n, view_degree, packet_loss=0.02)
    k = jcfg.degree
    rng = np.random.default_rng(23)
    kill = np.zeros(n, bool)
    kill[: max(1, n // 16)] = True
    st = st._replace(
        alive_truth=st.alive_truth & ~kill,
        probe_ptr=np.full(n, k - 1, np.int32),
        next_probe_tick=np.zeros(n, np.int32),
        tx_left=rng.choice(np.array([0, 2, 5], np.int32), size=(n, k)))
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo))
    draws = tp.make_draws_fn(jcfg)
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    pp = convert.packed_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(29)
    wrapped = 0
    for t in range(3):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, None, kp, key)
        before = pp.probe_ptr
        pp, pc = cuda_gossip.plain_tick(tcfg, tt, tw, pp,
                                        tp.to_tick_draws(draws(key)))
        tp.assert_packed_close(tp.np_tree(kp), pp, f"tick {t}")
        assert pc.tolist() == [int(x) for x in kc], f"tick {t} counters"
        wrapped += int(((pp.probe_ptr == 0) & (before > 0)).sum())
    assert wrapped >= n - int(kill.sum())


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



def _launch_bytes(cfg, serf_plane=False, sched=None, due_at_last_col=False):
    gen = torch.Generator().manual_seed(0)
    world = ttopo.make_world(cfg, gen)
    if serf_plane:
        st = tlayout.pack_state(tserf.init(cfg, gen, "cpu"))
        d = tserf.draw_serf_tick(cfg, gen, "cpu", chaos=sched is not None)
    else:
        st = tlayout.pack(tstate.init(cfg, gen))
        d = tswim.draw_tick(cfg, gen, "cpu", chaos=sched is not None)
    if due_at_last_col:
        sw = st.swim if serf_plane else st
        sw = sw._replace(next_probe_delta=torch.zeros_like(sw.next_probe_delta),
                         probe_ptr=torch.full_like(sw.probe_ptr, cfg.degree - 1))
        st = st._replace(swim=sw) if serf_plane else sw
    plain = cuda_gossip.plain_serf_tick if serf_plane else cuda_gossip.plain_tick
    out, _ = plain(cfg, ttopo.make_topology(cfg, gen), world, st, d, sched)
    return {stage: cuda_gossip.launch_hbm_bytes_per_node(
        stage, st, world, d, sched, cfg=cfg, out=out)
        for stage in cuda_gossip.STAGES}


@pytest.mark.parametrize("n,view_degree", [(1024, 32), (256, 0)],
                         ids=["k32", "dense255"])
def test_launch_bytes_match_hand_counts(n, view_degree):
    """The per-launch floors of the bare tick at K = 32 and on the dense
    view (K = 255), every probe due at the last column (so in the plain
    tick that gives the output state every row probes and wraps, and the
    probe draws and perm_u count for every row), against counts made by
    hand from the
    leaf widths: S = 3 RTT slots, D = 8, W = 20, 3 world dims, 3 relays,
    3 gossip legs, 3 piggybacked facts."""
    cfg = TSimConfig(n=n, view_degree=view_degree)
    k = cfg.degree
    assert k == (32 if view_degree else 255)
    got = _launch_bytes(cfg, due_at_last_col=True)
    own, scalars = 1 + 2, 9                   # flags + own_inc; own_tx .. nack
    view_in = (2 + 2 + 2 + 4) * k             # view_inc, meta, susp_delta, seen
    viv = 2 * 8 + 2 + 2 + 2 + 20 + 1 + 1      # vec .. resets
    probe = 4 + 8 + 3 * 3 * 4 + 2 * 8 * 4     # jitter, u2, u_a/b/c, viv/grav
    a_read = (own + scalars + view_in + 2 * k + 3 * k + viv + 3 * 4 + 4
              + probe + 4 * k + (3 * 8 + 3 * 8 + 4 * k) / n)
    a_write = (4 * k + 4 * k + 2 * k + 2 * k + 3 * k + viv + 1 + scalars
               + 2 + 3 + 12 + 12 + 4 + 4)
    want = {
        "chaos_pre": 0.0,
        "probe_send": a_read + a_write,
        "receive": own + 2 + 3 + 12 + 12 + 4 + 4 + 3 * 4
                   + (3 * 4 * k + 3 * 8) / n + 4,
        "pushpull": own + 4 + 4 * k + view_in + 4 * k + 2 * k
                    + (8 * k + 8) / n + 3 * 2 * k + 4 * k + 2,
        "serf_post": 0.0,
        "ref_send": 0.0,
        "ref_intake": 0.0,
    }
    assert got == pytest.approx(want, rel=1e-12)
    if k == 32:
        assert round(want["probe_send"]) == 1363 and round(want["pushpull"]) == 969
    else:
        assert round(want["probe_send"]) == 8949 and round(want["pushpull"]) == 7667


def test_launch_bytes_serf_and_schedule_hand_counts():
    """The serf plane's launch D and a schedule's launch P at K = 32 (E = 8
    queue slots with int16 origins and int8 budgets, R = 16 buckets of O =
    4 signatures, Q = 4 query slots, 2 piggybacked events), against hand
    counts; a schedule adds the post-churn row scalars and terms to every
    launch's own read."""
    from consul_tpu_torch.chaos import schedule as tchaos
    cfg = TSimConfig(n=1024, view_degree=32)
    sched = tchaos.compile_schedule(1024, [
        tchaos.Partition(0, 8, slice(0, 256)),
        tchaos.Degrade(0, 8, slice(512, 768), tx_loss=0.5)], "cpu")
    got = _launch_bytes(cfg, serf_plane=True, sched=sched)
    serf_rw = (4 + 8 * 4 + 8 * 2 + 8 + 8 + 16 * 4 + 16 * 4 * 4 + 16 * 4
               + 16 * 4 * 4 + 4 + 4 + 3 * 4 + 4 + 1 + 4 * 4 + 4 * 4 + 32 * 4)
    assert serf_rw == 893
    # The row's flags and terms under a schedule: chaos_pre's 4-byte word
    # and 16-byte record.
    d_read = serf_rw + 4 + 16 + 2 + 2 * 4 + 2 * 4 + 3 * 4 + 4 + 2 * 32
    assert got["serf_post"] == pytest.approx(d_read + serf_rw + 1, rel=1e-12)
    # One partition slot and one degrade slot: their node masks packed into
    # one u32 word a node, plus the per-slot ticks and rates; the word and
    # the record written.
    scalars = sum(tlayout.np_size_bytes(getattr(sched, f))
                  for f in cuda_gossip._SCHED_SCALARS) / 1024
    assert cuda_gossip.mask_words(sched) == 1
    assert got["chaos_pre"] == pytest.approx(1 + 2 + 4 + scalars + 4 + 16)
    bare = _launch_bytes(cfg)
    # The word and the record in place of the input's flags and
    # incarnation (3 B), and the push-pull draw.
    assert got["pushpull"] - bare["pushpull"] == pytest.approx(17 + 4)
    assert got["receive"] - bare["receive"] == pytest.approx(17)
