"""Launch P of the CUDA tick (``k_chaos_pre``) and the row word and record
it hands to the later launches, on the CPU:

- ``cuda_gossip.plain_chaos_pre`` against the reference's
  ``chaos.node_terms``, ``chaos.down_at`` and its kill / warm-revive rule
  (``consul_tpu/models/swim.py:240-251``), exactly, at n = 256 under a
  composed schedule on every tick from before its first entry opens to
  after its last one closes (every window edge, every churn edge);
- the node masks' bit packing round-trips and puts entry e of a row at
  bit e % 32 of word e // 32, families concatenated;
- the word and record widths refuse what the schedule cannot produce;
- the packed masks are made once per installed schedule;
- the sharded tick exchanges two chaos mirrors before A, and its byte
  count says so;
- on a card (marked ``cuda``), launch P equals ``plain_chaos_pre`` bit for
  bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.models import state as jstate
from consul_tpu_torch.chaos import schedule as tchaos
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate
from consul_tpu_torch.models import swim as tswim
from consul_tpu_torch.ops import cuda_gossip as cg
from consul_tpu_torch.ops import topology as ttopo
from consul_tpu_torch.parallel import mesh as tmesh

import torch_parity as tp

N = 256


def _events(C, n):
    """Every family, overlapping: two Partitions, two LinkLosses, two
    ChurnWaves (one with a period and downtime, one held down), three
    Degrades on the same rows (their products in slot order)."""
    return [
        C.Partition(2, 11, slice(0, n // 4)),
        C.Partition(4, 13, slice(n // 8, 3 * n // 8)),
        C.LinkLoss(1, 15, slice(0, n // 8), slice(n // 8, n // 4), fwd=0.8,
                   rev=0.2),
        C.LinkLoss(3, 15, slice(0, n // 4), slice(n // 8, n // 2), fwd=0.3,
                   rev=0.6),
        C.ChurnWave(2, 21, slice(n // 2, n // 2 + n // 16), period=5,
                    down_ticks=2),
        C.ChurnWave(6, 9, slice(n // 2 + n // 32, 5 * n // 8)),
        C.Degrade(1, 15, slice(n - n // 8, n), tx_loss=0.4),
        C.Degrade(1, 15, slice(n - n // 4, n), tx_loss=0.3, rx_loss=0.2),
        C.Degrade(3, 15, slice(n - n // 4, n), tx_loss=0.7, rx_loss=0.1),
    ]


def _row_flags(seed):
    """Random alive / left / leaving / external bits and incarnations, with
    the churned rows' incarnations at the u16 ceiling (a revive takes them
    to 65,536, the record's 17th bit)."""
    rng = np.random.default_rng(seed)
    bits = rng.random((4, N)) < np.array([[0.8], [0.1], [0.1], [0.05]])
    inc = rng.integers(0, 65536, N).astype(np.int64)
    inc[N // 2: N // 2 + N // 64] = 65535
    return bits, inc


def _decode(word, rec):
    w = word.numpy().view(np.uint32).astype(np.int64)
    r = rec.numpy().view(np.uint32).astype(np.int64)
    lo = r[:, 0] | (r[:, 1] << 32)
    return dict(flags=w & 0xFF, color=w >> 8, inc=lo & 0x1FFFF,
                a_bits=(lo >> 17) & 0xFFFFF, b_bits=(lo >> 37) & 0xFFFFF,
                high=lo >> 57, q_tx=r[:, 2], q_rx=r[:, 3])


def test_plain_chaos_pre_matches_reference():
    jcfg, tcfg = tp.configs(n=N, view_degree=32)
    (alive, left, leaving, external), inc = _row_flags(5)
    js = jchaos.compile_schedule(N, _events(jchaos, N))
    ts = tchaos.compile_schedule(N, _events(tchaos, N))
    j0 = jstate.init(jcfg, jax.random.PRNGKey(0))._replace(
        alive_truth=jnp.asarray(alive), left=jnp.asarray(left),
        leaving=jnp.asarray(leaving), external=jnp.asarray(external),
        own_inc=jnp.asarray(inc, jnp.uint32))
    flags = alive | (left << 1) | (leaving << 2) | (external << 3)
    packed = types.SimpleNamespace(
        flags=torch.from_numpy(flags.astype(np.uint8)),
        own_inc=torch.from_numpy(inc.astype(np.uint16)))
    edges = {"kill": 0, "revive": 0}
    for t in range(0, 24):
        down, prev = jchaos.down_at(js, t), jchaos.down_at(js, t - 1)
        kill, revive = down & ~prev, prev & ~down
        ref = jstate.revive(jcfg, jstate.kill(j0, kill), revive)
        terms = jchaos.node_terms(js, t)
        want = dict(
            flags=(np.asarray(ref.alive_truth).astype(np.int64)
                   | np.asarray(ref.left) << 1 | np.asarray(ref.leaving) << 2
                   | np.asarray(ref.external) << 3
                   | np.where(np.asarray(revive), 0x80, 0)),
            color=np.asarray(terms.color), inc=np.asarray(ref.own_inc),
            a_bits=np.asarray(terms.a_bits), b_bits=np.asarray(terms.b_bits),
            high=np.zeros(N),
            q_tx=np.asarray(terms.q_tx).view(np.uint32),
            q_rx=np.asarray(terms.q_rx).view(np.uint32))
        word, rec = cg.plain_chaos_pre(packed, ts, t)
        assert word.dtype == rec.dtype == torch.int32
        assert word.shape == (N,) and rec.shape == (N, 4)
        got = _decode(word, rec)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.astype(np.int64),
                                          err_msg=f"t={t}: {k}")
        edges["kill"] += int(np.asarray(kill).sum())
        edges["revive"] += int(np.asarray(revive).sum())
    # Every churn edge ran both ways, the revives of rows at the u16
    # ceiling included.
    assert edges["kill"] > 0 and edges["revive"] > 0
    assert int(np.asarray(jchaos.down_at(js, 7))[N // 2: N // 2 + N // 64].sum())


def _sched_with(family, m, n=64, seed=0):
    """A schedule with ``m`` entries of ``family`` (a MASK_FIELDS name) on
    random rows and one entry of each other family."""
    rng = np.random.default_rng(seed)

    def rows():
        return rng.random(n) < 0.4

    count = {f: (m if f == family else 1) for f in cg.MASK_FIELDS}
    count["ll_a"] = count["ll_b"] = max(count["ll_a"], count["ll_b"])
    ev = [tchaos.Partition(0, 4, rows()) for _ in range(count["part_side"])]
    ev += [tchaos.LinkLoss(0, 4, rows(), rows(), fwd=0.5)
           for _ in range(count["ll_a"])]
    ev += [tchaos.ChurnWave(0, 4, rows(), period=2, down_ticks=1)
           for _ in range(count["cw_mask"])]
    ev += [tchaos.Degrade(0, 4, rows(), tx_loss=0.5)
           for _ in range(count["dg_mask"])]
    return tchaos.compile_schedule(n, ev)


@pytest.mark.parametrize("family,m", [
    ("part_side", 1), ("part_side", 20), ("ll_a", 1), ("ll_a", 20),
    ("cw_mask", 1), ("cw_mask", 20), ("cw_mask", 33), ("dg_mask", 1),
    ("dg_mask", 20), ("dg_mask", 33)])
def test_pack_masks_round_trips(family, m):
    sched = _sched_with(family, m)
    words = cg.pack_masks(sched)
    cols = np.concatenate([getattr(sched, f).numpy() for f in cg.MASK_FIELDS],
                          axis=1)
    w = cg.mask_words(sched)
    assert w == -(-cols.shape[1] // 32)
    assert words.dtype == torch.int32 and words.shape == (64, w)
    # Entry e of a row at bit e % 32 of word e // 32.
    padded = np.zeros((64, 32 * w), np.uint64)
    padded[:, :cols.shape[1]] = cols
    want = (padded.reshape(64, w, 32) << np.arange(32, dtype=np.uint64)).sum(2)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  want.astype(np.uint32))
    # And back: each family's columns from its bits.
    bits = (words.numpy().view(np.uint32)[:, :, None].astype(np.uint64)
            >> np.arange(32, dtype=np.uint64)) & 1
    bits = bits.reshape(64, 32 * w).astype(bool)
    e = 0
    for f in cg.MASK_FIELDS:
        m = getattr(sched, f).shape[1]
        np.testing.assert_array_equal(bits[:, e:e + m],
                                      getattr(sched, f).numpy(), err_msg=f)
        e += m
    assert not bits[:, e:].any()


def _kernel(n=64):
    cfg = SimConfig(n=n, view_degree=16)
    gen = torch.Generator().manual_seed(3)
    topo = ttopo.make_topology(cfg, gen, "cpu")
    world = ttopo.make_world(cfg, gen, "cpu")
    st = tlayout.pack(tstate.init(cfg, gen, "cpu"))
    d = tswim.draw_tick(cfg, gen, "cpu", chaos=True)
    return cfg, cg.make_tick_kernel(cfg, topo), world, st, d


def test_widths_refuse_what_the_schedule_cannot_produce():
    for make, what in ((lambda i: tchaos.Partition(0, 2, [i]), "Partition"),
                       (lambda i: tchaos.LinkLoss(0, 2, [i], [i + 1], fwd=0.5),
                        "LinkLoss")):
        tchaos.compile_schedule(64, [make(i) for i in range(20)])
        with pytest.raises(ValueError, match=f"at most 20 {what}"):
            tchaos.compile_schedule(64, [make(i) for i in range(21)])
    cfg, k, world, st, d = _kernel()
    ok = tchaos.compile_schedule(64, [tchaos.Partition(0, 2, [1]),
                                      tchaos.LinkLoss(0, 2, [1], [2], 0.5)])
    k._check_schedule(ok, d, torch.device("cpu"), 64)
    # Schedules built by hand past the 20-bit fields of the word and record.
    wide = {"part": ok._replace(
        part_start=torch.zeros(21, dtype=torch.int32),
        part_stop=torch.ones(21, dtype=torch.int32),
        part_side=torch.zeros((64, 21), dtype=torch.bool)),
        "ll": ok._replace(
        ll_start=torch.zeros(21, dtype=torch.int32),
        ll_stop=torch.ones(21, dtype=torch.int32),
        ll_fwd=torch.zeros(21), ll_rev=torch.zeros(21),
        ll_a=torch.zeros((64, 21), dtype=torch.bool),
        ll_b=torch.zeros((64, 21), dtype=torch.bool))}
    for fam, sched in wide.items():
        with pytest.raises(ValueError, match=f"at most 20 {fam} slots"):
            k._check_schedule(sched, d, torch.device("cpu"), 64)
    m = 32 * cg.MAX_MASK_WORDS
    many = ok._replace(cw_start=torch.zeros(m, dtype=torch.int32),
                       cw_stop=torch.ones(m, dtype=torch.int32),
                       cw_period=torch.zeros(m, dtype=torch.int32),
                       cw_down=torch.zeros(m, dtype=torch.int32),
                       cw_mask=torch.zeros((64, m), dtype=torch.bool))
    with pytest.raises(ValueError, match="schedule entries in all"):
        k._check_schedule(many, d, torch.device("cpu"), 64)


def test_masks_packed_once_per_installed_schedule():
    cfg, k, world, st, d = _kernel()
    cpu = torch.device("cpu")
    a = tchaos.compile_schedule(64, _events(tchaos, 64))
    b = tchaos.compile_schedule(64, _events(tchaos, 64)[:4])
    packs = cg.MASK_CACHE.packs
    for t in range(6):
        # A shifted schedule keeps its masks: no new pack; two lanes
        # alternate tick by tick, each packed once.
        for lane in (tchaos.shift_schedule(a, t), b):
            _, scratch, tens = k._buffers(world, st, d, cpu, lane)
            words = tens[cg._PTRS.index("masks")]
            assert torch.equal(words, cg.pack_masks(lane))
            args = k._args(tens, lane)
            assert args.i[cg._INTS.index("mw")] == cg.mask_words(lane)
            assert scratch["c_word"].shape == (64,)
            assert scratch["c_rec"].shape == (64, 4)
    assert cg.MASK_CACHE.packs == packs + 2
    # An edited mask is packed again.
    a.cw_mask[0, 0] = ~a.cw_mask[0, 0]
    _, _, tens = k._buffers(world, st, d, cpu, a)
    assert cg.MASK_CACHE.packs == packs + 3
    assert torch.equal(tens[cg._PTRS.index("masks")], cg.pack_masks(a))
    # No schedule: no masks, no P operands.
    _, scratch, tens = k._buffers(world, st, d, cpu, None)
    assert tens[cg._PTRS.index("masks")] is None and "c_word" not in scratch
    assert k._args(tens, None).i[cg._INTS.index("mw")] == 0


@pytest.mark.parametrize("g", [1, 2, 4])
def test_exchange_before_a_moves_two_chaos_mirrors(g):
    """Under a schedule the exchange before A copies the word and the
    record (4 + 16 B a node) beside the four Vivaldi mirrors (22 B), each
    read once and written once into every other group; the seven arrays
    P wrote before took 25 B."""
    chaos_mirrors = [m for m in cg.EXCHANGES["probe_send_chaos"]
                     if m not in cg.EXCHANGES["probe_send"]]
    assert chaos_mirrors == ["m_cword", "m_crec"]
    assert len(cg.EXCHANGES["probe_send_chaos"]) == 6
    cfg = SimConfig(n=256, view_degree=32)
    st = tlayout.pack(tstate.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    sched = tchaos.compile_schedule(256, _events(tchaos, 256))
    groups = tuple((d,) for d in range(g))
    per = cg.exchange_bytes_per_node("probe_send", st, sched, cfg=cfg,
                                     groups=groups)
    assert per == 2 * (22 + 4 + 16) * (g - 1)
    plan = cg.exchange_plan("probe_send_chaos",
                            tmesh.shard_groups(tmesh.make_mesh(["cpu"] * g)),
                            256 // g)
    assert len(plan) == 6 * g * (g - 1)


def test_chaos_pre_raises_without_a_card():
    cfg, k, world, st, d = _kernel()
    sched = tchaos.compile_schedule(64, _events(tchaos, 64))
    with pytest.raises(ValueError, match="plain_chaos_pre"):
        k.chaos_pre(world, st, d, sched)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["composed", "wide"])
def test_card_chaos_pre_equals_plain(wide):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launch P runs only there")
    dev = torch.device("cuda")
    n = 4096
    cfg = SimConfig(n=n, view_degree=16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    world = ttopo.make_world(cfg, gen, dev)
    topo = ttopo.make_topology(cfg, gen, dev)
    st = tlayout.pack(tstate.init(cfg, gen, dev))
    k = cg.make_tick_kernel(cfg, topo)
    ev = _events(tchaos, n)
    if wide:  # past one mask word: 20 + 2 * 20 + 34 + 3 bits
        ev = ([tchaos.Partition(1 + i % 5, 9 + i % 7, slice(i * 7, n // 2))
               for i in range(20)]
              + [tchaos.LinkLoss(i % 4, 10 + i % 3, slice(0, n // 4 + i),
                                 slice(n // 4, n // 2 - i), fwd=0.1 * (i % 9))
                 for i in range(20)]
              + [tchaos.ChurnWave(i % 6, 12 + i % 5, slice(n // 2 + 8 * i,
                                                           n // 2 + 8 * i + 64),
                                  period=3 + i % 4, down_ticks=1 + i % 2)
                 for i in range(34)]
              + ev[-3:])
    sched = tchaos.compile_schedule(n, ev, dev)
    for _ in range(24):
        d = tswim.draw_tick(cfg, gen, dev, chaos=True)
        word, rec = k.chaos_pre(world, st, d, sched)
        pw, pr = cg.plain_chaos_pre(st, sched, int(st.t))
        assert torch.equal(word, pw) and torch.equal(rec, pr)
        st, _ = k(world, st, d, sched)
