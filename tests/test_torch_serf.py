"""PyTorch port vs the JAX reference: the fused serf plane.

Inputs come from the reference and cross through ``convert.py``; random
numbers are the reference's own key ladder (``torch_parity``). At n = 256,
K = 16, 1 % packet loss:

- the serf ops (``lamport``, ``_sig`` in both branches, ``_buf_lookup``,
  ``_buf_apply``, ``_equeue_push``) and the verbs (``user_event``,
  ``query``, ``leave``) equal the reference's, leaf for leaf;
- 10 ticks of ``serf.step_counted`` (dense SWIM plane, rounded through
  the packed codec each tick as the reference's packed driver does) and
  of ``cuda_gossip.plain_serf_tick`` (packed) against the reference's
  jitted ``serf.step_counted`` with that rounding, with an event storm, a
  query and a leave in flight, for ``query_relay_factor`` 0 and 2: every
  serf leaf, every discrete SWIM leaf and all 26 counters equal on every
  tick; Vivaldi floats of the dense plane within ``torch_parity``'s
  rtol 1e-5 / atol 1e-7, packed float leaves within 3 storage steps (or
  1e-5 s where values cross zero);
- under the serf stress of ``chip_smoke.py`` (equal keys from 8 origins
  at one Lamport time, 24 Lamport times from 2 more origins, a relayed
  query under loss), 24 ticks of ``serf.step_counted`` and
  ``plain_serf_tick`` against the reference's, leaf for leaf, with bucket
  takeovers and floor bumps, full buckets, one key from two origins in a
  queue, queue evictions and many acks on one query slot in the window;
- 4 ticks of ``plain_serf_tick`` against the reference's interpret-mode
  Pallas tick with ``step_fn=serf.step_counted``;
- ``SerfSimulation(device="cpu", kernel="torch")`` follows the reference's
  trajectory to ``event_coverage == 1.0``;
- the CUDA serf wrapper raises on CPU tensors, a view wider than 255
  columns, a relay factor beyond its limit, dedup buckets too wide for
  its shared-memory stage and ev_tx wider than int8, and takes the dense
  view.
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.config import SerfConfig as JSerfConfig
from consul_tpu.models import layout as jlayout
from consul_tpu.models import serf as jserf
from consul_tpu.ops import lamport as jlamport
from consul_tpu.ops import pallas_gossip
from consul_tpu.ops import topology as jtopo
from consul_tpu_torch import convert
from consul_tpu_torch.config import SerfConfig as TSerfConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import serf as tserf
from consul_tpu_torch.ops import cuda_gossip, lamport as tlamport
from consul_tpu_torch.ops import topology as ttopo

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N, K, LOSS = 256, 16, 0.01
TICKS = 10
STRESS_TICKS = 24
_JIT = {}


def _configs(rf=0, n=N, **kw):
    jcfg, tcfg = tp.configs(n=n, view_degree=K, packet_loss=LOSS, **kw)
    return (jcfg.__class__(**{**jcfg.__dict__,
                              "serf": JSerfConfig(query_relay_factor=rf)}),
            tcfg.__class__(**{**tcfg.__dict__,
                              "serf": TSerfConfig(query_relay_factor=rf)}))


def _setup(rf=0):
    jcfg, tcfg = _configs(rf)
    kw, kt, ks = jax.random.split(jax.random.PRNGKey(3), 3)
    return (jcfg, tcfg, jtopo.make_world(jcfg, kw),
            jtopo.make_topology(jcfg, kt), jserf.init(jcfg, ks))


def _mask(rows, n=N):
    m = np.zeros(n, bool)
    m[list(rows)] = True
    return m


def _in_flight(jcfg, topo, world, st):
    """A leave, 6 reference ticks (so it goes quiet inside the next 10),
    then an event storm (16 events over 8 ltimes, so queues overflow) and
    a query."""
    st = jserf.leave(jcfg, st, _mask([77]))
    ref_tick, _ = _ref_tick(jcfg, topo, world)
    for t in range(6):
        st, _ = ref_tick(st, jax.random.PRNGKey(1000 + t))
    for lt in range(8):
        st = jserf.user_event(jcfg, st, _mask([3 + lt, 100 + lt]), 5 + lt)
    return jserf.query(jcfg, st, _mask([9]), 3)


def _ref_tick(jcfg, topo, world):
    """The reference's jitted serf tick with the packed driver's rounding
    (tests/test_pallas_gossip.py:103-107), memoized per config."""
    key = (jcfg.serf.query_relay_factor,)
    if key not in _JIT:
        @jax.jit
        def tick(s, k):
            s, c = jserf.step_counted(jcfg, topo, world, s, k)
            return jlayout.unpack_state(jlayout.pack_state(s)), c
        _JIT[key] = (tick, tp.make_serf_draws_fn(jcfg))
    return _JIT[key]


def _u32(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


# ----------------------------------------------------------------------
# Ops
# ----------------------------------------------------------------------

def test_lamport_matches_reference():
    rng = np.random.default_rng(0)
    clock = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    clock[:4] = [0, 1, 0xFFFFFFFE, 0xFFFFFFFF]
    obs = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    obs[4:8] = [0xFFFFFFFF, 0xFFFFFFFE, 0, 7]
    mask = rng.random(64) < 0.5
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        np.testing.assert_array_equal(
            tlamport.witness(_u32(clock), _u32(obs), tm).numpy(),
            np.asarray(jlamport.witness(clock, obs, m)).astype(np.int64))
        np.testing.assert_array_equal(
            tlamport.increment(_u32(clock), tm).numpy(),
            np.asarray(jlamport.increment(clock, m)).astype(np.int64))


@pytest.mark.parametrize("n", [N, (1 << 21) + 1], ids=["exact", "murmur"])
def test_sig_matches_reference(n):
    # The murmur branch is chosen by the config's n alone; only _sig reads it.
    jcfg, tcfg = _configs(n=n)
    rng = np.random.default_rng(1)
    key = rng.integers(0, 2 ** 32, 512, dtype=np.uint64).astype(np.uint32)
    origin = rng.integers(-1, n, 512).astype(np.int32)
    origin[:3] = [-1, 0, n - 1]
    np.testing.assert_array_equal(
        tserf._sig(tcfg, _u32(key), torch.from_numpy(origin)).numpy(),
        np.asarray(jserf._sig(jcfg, key, origin)).astype(np.int64))


def _random_buffers(rng, cfg, rows):
    r, o = cfg.serf.seen_ring, cfg.serf.seen_width
    lt = rng.integers(0, 6, (rows, r)).astype(np.uint32)
    sig = np.where(rng.random((rows, r, o)) < 0.6,
                   np.asarray(jserf._sig(cfg, rng.integers(0, 1 << 13, (rows, r, o)),
                                         rng.integers(-1, 8, (rows, r, o)))), 0)
    floor = rng.integers(0, 3, rows).astype(np.uint32)
    return lt, sig.astype(np.uint32), floor


def test_buf_lookup_and_apply_match_reference():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(2)
    rows, e = 128, 6
    lt, sig, floor = _random_buffers(rng, jcfg, rows)
    # Candidates built from the buffers' own signatures and fresh ones.
    key = jserf.make_event_key(rng.integers(0, 6, (rows, e)),
                               rng.integers(0, 16, (rows, e)),
                               rng.random((rows, e)) < 0.3)
    origin = rng.integers(-1, 8, (rows, e)).astype(np.int32)
    key, origin = np.asarray(key), origin
    want = np.asarray(jserf._buf_lookup(jcfg, lt, sig, floor, key, origin))
    got = tserf._buf_lookup(tcfg, _u32(lt), _u32(sig), _u32(floor), _u32(key),
                            torch.from_numpy(origin).to(torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    mask = rng.random(rows) < 0.7
    want = jserf._buf_apply(jcfg, lt, sig, floor, mask, key[:, 0], origin[:, 0])
    got = tserf._buf_apply(tcfg, _u32(lt), _u32(sig), _u32(floor),
                           torch.from_numpy(mask), _u32(key[:, 0]),
                           torch.from_numpy(origin[:, 0]).to(torch.int64))
    for w, g, name in zip(want, got, ("bkt_lt", "bkt_sig", "floor")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64),
                                      err_msg=name)


def test_equeue_push_matches_reference():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    e = jcfg.serf.event_queue_slots
    st = jserf.init(jcfg, jax.random.PRNGKey(0))
    ev_key = np.where(rng.random((N, e)) < 0.8,
                      rng.integers(1, 1 << 12, (N, e)), 0).astype(np.uint32)
    st = st._replace(
        ev_key=ev_key,
        ev_origin=rng.integers(-1, 16, (N, e)).astype(np.int16),
        ev_tx=rng.integers(0, 12, (N, e)).astype(np.int8),
        ev_pending=rng.random((N, e)) < 0.5)
    pick = rng.integers(0, e, N)
    same = rng.random(N) < 0.3
    key = np.where(same, ev_key[np.arange(N), pick], rng.integers(1, 1 << 12, N))
    origin = np.where(same, np.asarray(st.ev_origin)[np.arange(N), pick],
                      rng.integers(0, 16, N)).astype(np.int32)
    mask = rng.random(N) < 0.8
    want, w_ev = jserf._equeue_push(jcfg, st, mask, key.astype(np.uint32),
                                    origin, 9, pending=True)
    ts = tserf._widen(convert.serf_state_from(tp.np_tree(st)))
    got, g_ev = tserf._equeue_push(tcfg, ts, torch.from_numpy(mask),
                                   _u32(key), torch.from_numpy(origin).to(torch.int64),
                                   9, pending=True)
    tp.assert_serf_equal(tp.np_tree(want), tserf._narrow(tcfg, got), "push")
    np.testing.assert_array_equal(g_ev.numpy(), np.asarray(w_ev))
    assert np.asarray(w_ev).any()


def test_verbs_match_reference():
    jcfg, tcfg, _, _, st = _setup()
    ts = convert.serf_state_from(tp.np_tree(st))
    for verb, args in ((jserf.user_event, (_mask([1, 2]), 7)),
                       (jserf.query, (_mask([2, 40]), 3)),
                       (jserf.query, (_mask([2]), 4)),
                       (jserf.leave, (_mask([5, 6]),)),
                       (jserf.user_event, (_mask([2]), 8))):
        st = verb(jcfg, st, *args)
        ts = getattr(tserf, verb.__name__)(tcfg, ts, torch.from_numpy(args[0]),
                                           *args[1:])
        ref = tp.np_tree(st)
        tp.assert_serf_equal(ref, ts, verb.__name__)
        tp.assert_state_matches(ref.swim, ts.swim, verb.__name__)


# ----------------------------------------------------------------------
# The tick
# ----------------------------------------------------------------------


@pytest.mark.parametrize("rf", [0, 2], ids=["relay0", "relay2"])
def test_step_counted_matches_reference(rf):
    jcfg, tcfg, world, topo, st = _setup(rf)
    st = _in_flight(jcfg, topo, world, st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    dense = convert.serf_state_from(tp.np_tree(st))
    packed = convert.serf_state_from(tp.np_tree(jlayout.pack_state(st)))
    ref_tick, draws = _ref_tick(jcfg, topo, world)
    base = jax.random.PRNGKey(17)
    totals = np.zeros(26, np.int64)
    for t in range(TICKS):
        key = jax.random.fold_in(base, t)
        st, jc = ref_tick(st, key)
        d = tp.to_serf_draws(draws(key))
        dense, dc = tserf.step_counted(tcfg, tt, tw, dense, d)
        dense = tlayout.unpack_state(tlayout.pack_state(dense))
        packed, pc = cuda_gossip.plain_serf_tick(tcfg, tt, tw, packed, d)
        want = [int(x) for x in jc]
        assert [int(x) for x in dc] == want, f"tick {t} counters"
        assert pc.tolist() == want, f"tick {t} plain_serf_tick counters"
        ref = tp.np_tree(st)
        tp.assert_serf_equal(ref, dense, f"tick {t}")
        tp.assert_state_matches(ref.swim, dense.swim, f"tick {t}")
        ref_p = tp.np_tree(jlayout.pack_state(st))
        tp.assert_serf_equal(ref_p, packed, f"tick {t} packed")
        tp.assert_packed_close(ref_p.swim, packed.swim, f"tick {t} packed")
        totals += want
    fields = tserf.counters_mod.FIELDS
    for f in ("serf_intents_queued", "serf_intents_retx", "serf_intents_dropped"):
        assert totals[fields.index(f)] > 0, f
    final = tp.np_tree(st)
    assert final.q_acks[9].max() > 0 and final.swim.left[77]
    assert final.ev_delivered.sum() > N
    # The read-outs on the final state.
    for w, g in zip(jserf.member_counts(jcfg, st), tserf.member_counts(tcfg, dense)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slot = jserf.newest_query_slot(st, 9)
    assert tserf.newest_query_slot(dense, 9) == slot >= 0
    qkey = int(final.q_open_key[9, slot])
    assert tserf.query_slot(dense, 9, qkey) == jserf.query_slot(st, 9, qkey) == slot
    key = jserf.make_event_key(1, 5)
    assert float(tserf.event_coverage(tcfg, dense, int(key), 3)) == float(
        jserf.event_coverage(jcfg, st, key, 3))


def _stress(jcfg, st):
    """chip_smoke.stress_events on the reference's state: one event of one
    name from 8 origins at Lamport time 1, 24 from 2 more origins, a query."""
    st = jserf.user_event(jcfg, st, _mask([(N // 8) * j + 5 for j in range(8)]), 1)
    for k in range(24):
        st = jserf.user_event(jcfg, st, _mask([N // 3 + 1, 2 * N // 3 + 1]), 2 + k)
    return jserf.query(jcfg, st, _mask([N // 2 + 9]), 3)


def _stress_hits(before, after):
    same = ((after.ev_key[:, :, None] == after.ev_key[:, None, :])
            & (after.ev_key[:, :, None] > 0)
            & (after.ev_origin[:, :, None] != after.ev_origin[:, None, :]))
    return np.array([
        ((after.ev_bkt_lt != before.ev_bkt_lt) & (before.ev_bkt_lt > 0)).sum(),
        (after.ev_floor > before.ev_floor).sum(),
        (after.ev_bkt_sig != 0).all(-1).any(-1).sum(),
        same.reshape(N, -1).any(1).sum()])


def test_step_counted_matches_reference_under_stress():
    jcfg, tcfg, world, topo, st = _setup(rf=2)
    ref_tick, draws = _ref_tick(jcfg, topo, world)
    for t in range(4):
        st, _ = ref_tick(st, jax.random.PRNGKey(2000 + t))
    assert (np.asarray(st.event_clock) == 1).all()
    st = _stress(jcfg, st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    dense = convert.serf_state_from(tp.np_tree(st))
    packed = convert.serf_state_from(tp.np_tree(jlayout.pack_state(st)))
    base = jax.random.PRNGKey(31)
    totals, hits = np.zeros(26, np.int64), np.zeros(4, np.int64)
    for t in range(STRESS_TICKS):
        key = jax.random.fold_in(base, t)
        before = tp.np_tree(st)
        st, jc = ref_tick(st, key)
        d = tp.to_serf_draws(draws(key))
        dense, dc = tserf.step_counted(tcfg, tt, tw, dense, d)
        dense = tlayout.unpack_state(tlayout.pack_state(dense))
        packed, pc = cuda_gossip.plain_serf_tick(tcfg, tt, tw, packed, d)
        want = [int(x) for x in jc]
        assert [int(x) for x in dc] == want, f"tick {t} counters"
        assert pc.tolist() == want, f"tick {t} plain_serf_tick counters"
        ref = tp.np_tree(st)
        tp.assert_serf_equal(ref, dense, f"tick {t}")
        tp.assert_state_matches(ref.swim, dense.swim, f"tick {t}")
        ref_p = tp.np_tree(jlayout.pack_state(st))
        tp.assert_serf_equal(ref_p, packed, f"tick {t} packed")
        tp.assert_packed_close(ref_p.swim, packed.swim, f"tick {t} packed")
        totals += want
        hits += _stress_hits(before, ref)
    # takeovers, floor bumps, full buckets, one key from two origins.
    assert (hits > 0).all(), hits
    assert totals[tserf.counters_mod.FIELDS.index("serf_intents_dropped")] > 0
    slot = jserf.newest_query_slot(st, N // 2 + 9)
    assert tp.np_tree(st).q_acks[N // 2 + 9, slot] > 1


def test_plain_serf_tick_matches_interpret_tick():
    jcfg, tcfg, world, topo, st = _setup()
    st = _in_flight(jcfg, topo, world, st)
    tick = jax.jit(pallas_gossip.interpret_tick(jcfg, topo,
                                                step_fn=jserf.step_counted))
    _, draws = _ref_tick(jcfg, topo, world)
    kp = jlayout.pack_state(st)
    tw = convert.world_from(tp.np_tree(world))
    tt = convert.topology_from(tp.np_tree(topo))
    pp = convert.serf_state_from(tp.np_tree(kp))
    base = jax.random.PRNGKey(23)
    for t in range(4):
        key = jax.random.fold_in(base, t)
        kp, kc = tick(world, None, kp, key)
        pp, pc = cuda_gossip.plain_serf_tick(tcfg, tt, tw, pp,
                                             tp.to_serf_draws(draws(key)))
        ref = tp.np_tree(kp)
        tp.assert_serf_equal(ref, pp, f"tick {t}")
        tp.assert_packed_close(ref.swim, pp.swim, f"tick {t}")
        assert pc.tolist() == [int(x) for x in kc], f"tick {t} counters"


def test_serf_simulation_reaches_full_coverage():
    jcfg, tcfg, world, topo, st = _setup()
    ref_tick, draws = _ref_tick(jcfg, topo, world)
    base = jax.random.PRNGKey(29)
    sim = tcluster.SerfSimulation(
        tcfg, seed=0, layout="packed", kernel="torch", device="cpu",
        world=convert.world_from(tp.np_tree(world)),
        topo=convert.topology_from(tp.np_tree(topo)),
        state=convert.serf_state_from(tp.np_tree(st)),
        draws=lambda t: tp.to_serf_draws(draws(jax.random.fold_in(base, t))))
    fired = [(int(st.event_clock[r]), name, r) for r, name in ((4, 21), (130, 22))]
    for _, name, r in fired:
        st = jserf.user_event(jcfg, st, _mask([r]), name)
        sim.user_event(_mask([r]), name)
    tp.assert_serf_equal(tp.np_tree(jlayout.pack_state(st)), sim.state, "fired")
    chunk, cover = 8, 0.0
    while cover < 1.0 and sim._t < 96:
        for _ in range(chunk):
            st, _ = ref_tick(st, jax.random.fold_in(base, sim._t))
            sim.run(1, chunk=1, with_metrics=False)
        tp.assert_serf_equal(tp.np_tree(jlayout.pack_state(st)), sim.state,
                             f"tick {sim._t}")
        cover = min(float(tserf.event_coverage(
            tcfg, sim.serf_state, tserf.make_event_key(lt, name), r))
            for lt, name, r in fired)
        want = min(float(jserf.event_coverage(jcfg, st, jserf.make_event_key(lt, name), r))
                   for lt, name, r in fired)
        assert cover == want
    assert cover == 1.0


# ----------------------------------------------------------------------
# The CUDA serf wrapper off the card
# ----------------------------------------------------------------------

def test_cuda_serf_wrapper_raises():
    cfg = TSimConfig(n=128, view_degree=16)
    gen = torch.Generator().manual_seed(0)
    world, topo = ttopo.make_world(cfg, gen), ttopo.make_topology(cfg, gen)
    st = tlayout.pack_state(tserf.init(cfg, gen))
    kernel = cuda_gossip.make_tick_kernel(cfg, topo, serf_plane=True)
    before = dict(cuda_gossip.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(world, st, tserf.draw_serf_tick(cfg, gen, "cpu"))
    assert cuda_gossip.LAUNCHES == before
    dense = TSimConfig(n=64, view_degree=0)
    dk = cuda_gossip.make_tick_kernel(dense, ttopo.make_topology(dense, gen),
                                      serf_plane=True)
    dk._check_inputs(ttopo.make_world(dense, gen),
                     tlayout.pack_state(tserf.init(dense, gen)),
                     tserf.draw_serf_tick(dense, gen, "cpu"), torch.device("cpu"))
    wide = TSimConfig(n=300, view_degree=0)
    with pytest.raises(ValueError, match="K <= 255"):
        cuda_gossip.make_tick_kernel(wide, ttopo.make_topology(wide, gen),
                                     serf_plane=True)
    far = TSimConfig(n=128, view_degree=16, packet_loss=0.01, serf=TSerfConfig(
        query_relay_factor=cuda_gossip.MAX_RELAY_FACTOR + 1))
    with pytest.raises(ValueError, match="query_relay_factor"):
        cuda_gossip.make_tick_kernel(far, topo, serf_plane=True)
    # serf_post stages a row's queue and dedup buckets in shared memory.
    wide_ring = TSimConfig(n=128, view_degree=16,
                           serf=TSerfConfig(seen_ring=128, seen_width=64))
    with pytest.raises(ValueError, match="stages a row's queue"):
        cuda_gossip.make_tick_kernel(wide_ring, topo, serf_plane=True)
    d = tserf.draw_serf_tick(cfg, gen, "cpu")
    with pytest.raises(TypeError, match="ev_tx"):
        kernel._check_inputs(world, st._replace(ev_tx=st.ev_tx.to(torch.int32)),
                             d, torch.device("cpu"))
    kernel._check_inputs(world, st, d, torch.device("cpu"))


def test_serf_hbm_contract_matches_reference():
    """Bytes per node of the packed SerfState and of the tick's contract at
    the serf north star's n = 1,048,576, K = 32, from shapes alone (the
    reference's eval_shape, meta tensors here)."""
    n = 1 << 20
    jcfg, tcfg = tp.configs(n=n, view_degree=32)
    jst = jax.eval_shape(lambda: jlayout.pack_state(
        jserf.init(jcfg, jax.random.PRNGKey(0))))
    jw = jax.eval_shape(lambda: jtopo.make_world(jcfg, jax.random.PRNGKey(1)))
    small = tlayout.pack_state(tserf.init(
        TSimConfig(n=64, view_degree=32), torch.Generator().manual_seed(0)))

    def meta(tree):
        if isinstance(tree, torch.Tensor):
            shape = (n,) + tuple(tree.shape[1:]) if tree.dim() else ()
            return torch.empty(shape, dtype=tree.dtype, device="meta")
        return type(tree)(*[meta(x) for x in tree])

    st = meta(small)
    st = st._replace(ev_origin=torch.empty((n, 8), dtype=tserf.origin_dtype(n),
                                           device="meta"))
    world = ttopo.World(pos=torch.empty((n, 3), device="meta"),
                        height=torch.empty((n,), device="meta"))
    assert tlayout.is_packed(st) and not tlayout.is_packed(tlayout.unpack_state(small))
    assert round(tlayout.bytes_per_node(st, n)) == 1477
    assert tlayout.bytes_per_node(st, n) == jlayout.bytes_per_node(jst, n)
    got = cuda_gossip.tick_hbm_bytes_per_node(st, world)
    assert got == pallas_gossip.tick_hbm_bytes_per_node(jst, jw)
    assert round(got) == 2970


def test_serf_simulation_defaults_to_the_card_and_never_falls_back():
    fields = tcluster.SerfSimulation.__dataclass_fields__
    assert (fields["device"].default, fields["kernel"].default,
            fields["layout"].default) == ("cuda", "cuda", "packed")
    cfg = TSimConfig(n=64, view_degree=16)
    with pytest.raises(ValueError, match="CUDA device"):
        tcluster.SerfSimulation(cfg, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        tcluster.SerfSimulation(cfg, device="cpu", kernel="cuda", layout="dense")
    sim = tcluster.SerfSimulation(cfg, device="cpu", kernel="torch", layout="dense")
    sim.leave(_mask([3], 64))
    sim.run(16, chunk=8)
    st = sim.serf_state
    assert bool(st.swim.left[3]) and int(st.leave_at[3]) == -1
    counts = tserf.member_counts(cfg, st)
    assert int(counts.left.sum()) > 0
