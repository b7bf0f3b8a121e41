"""PyTorch port vs the JAX reference: the pure ops (merge lattice,
scaling laws, Vivaldi update, topology tables, world model).

Tolerances: discrete results equal; floats ``allclose(rtol=1e-6)``
(Vivaldi's update at ``rtol=1e-5``: XLA and PyTorch may sum its 8- and
20-element reductions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.config import VivaldiConfig as JViv
from consul_tpu.ops import merge as jmerge
from consul_tpu.ops import scaling as jscaling
from consul_tpu.ops import topology as jtopo
from consul_tpu.ops import vivaldi as jvivaldi
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.config import VivaldiConfig as TViv
from consul_tpu_torch.ops import merge as tmerge
from consul_tpu_torch.ops import scaling as tscaling
from consul_tpu_torch.ops import topology as ttopo
from consul_tpu_torch.ops import vivaldi as tvivaldi

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401


def _keys(rng, size):
    inc = rng.integers(0, 1 << 30, size=size, dtype=np.uint64)
    inc[: size // 3] = rng.integers(0, 4, size=size // 3)  # small incs tie often
    st = rng.integers(0, 4, size=size, dtype=np.uint64)
    return ((inc << 2) | st).astype(np.uint32)


class TestMerge:
    def test_lattice_ops_match(self):
        rng = np.random.default_rng(0)
        a, b = _keys(rng, 4096), _keys(rng, 4096)
        own = rng.integers(0, 8, size=4096).astype(np.uint32)
        me = rng.random(4096) < 0.5
        ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
        pairs = [
            (jmerge.join(a, b), tmerge.join(ta, tb)),
            (jmerge.demote_dead_to_suspect(a), tmerge.demote_dead_to_suspect(ta)),
            (jmerge.is_contactable(a), tmerge.is_contactable(ta)),
            (jmerge.is_refutable(a, me, own),
             tmerge.is_refutable(ta, torch.from_numpy(me),
                                 torch.from_numpy(own.astype(np.int64)))),
            (jmerge.key_incarnation(a), tmerge.key_incarnation(ta)),
            (jmerge.key_status(a), tmerge.key_status(ta)),
            (jmerge.make_key(a >> 2, b & 3),
             tmerge.make_key(ta >> 2, tb & 3)),
        ]
        for want, got in pairs:
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          np.asarray(want).astype(np.int64))


class TestScaling:
    @pytest.mark.parametrize("n", [2, 32, 33, 100, 1024, 65536, 1_048_576])
    def test_laws_match(self, n):
        assert int(tscaling.retransmit_limit(4, n)) == int(jscaling.retransmit_limit(4, n))
        assert int(tscaling.push_pull_scale(n)) == int(jscaling.push_pull_scale(n))
        assert int(tscaling.suspicion_k(4, n)) == int(jscaling.suspicion_k(4, n))
        np.testing.assert_allclose(float(tscaling.suspicion_timeout(4, n, 5)),
                                   float(jscaling.suspicion_timeout(4, n, 5)),
                                   rtol=1e-6)

    def test_remaining_suspicion_time_matches(self):
        conf = np.arange(0, 8, dtype=np.int32)
        el = np.linspace(0, 400, 8).astype(np.float32)
        want = jscaling.remaining_suspicion_time(conf, 2, el, 60.2, 361.2)
        got = tscaling.remaining_suspicion_time(torch.from_numpy(conf), 2,
                                                torch.from_numpy(el), 60.2, 361.2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


class TestVivaldi:
    def test_update_matches(self):
        rng = np.random.default_rng(1)
        b, d, w = 512, 8, 20
        cfg_j, cfg_t = JViv(), TViv()

        def f32(*shape, lo=0.0, hi=1.0):
            return rng.uniform(lo, hi, size=shape).astype(np.float32)

        st = jvivaldi.VivaldiState(
            vec=f32(b, d, lo=-0.05, hi=0.05), height=f32(b, lo=1e-5, hi=0.003),
            error=f32(b, lo=0.1, hi=1.5), adjustment=f32(b, lo=-1e-3, hi=1e-3),
            adj_samples=f32(b, w, lo=-2e-3, hi=2e-3),
            adj_idx=rng.integers(0, w, size=b).astype(np.int32),
            resets=np.zeros(b, np.int32))
        st = st._replace(vec=st.vec.copy())
        st.vec[:8] = 0.0  # coincident points take the fallback directions
        other = (f32(b, d, lo=-0.05, hi=0.05), f32(b, lo=1e-5, hi=0.003),
                 f32(b, lo=0.1, hi=1.5), f32(b, lo=-1e-3, hi=1e-3))
        other[0][:8] = 0.0
        rtt = f32(b, lo=0.001, hi=0.1)
        rtt[-16:] = -1.0  # rejected observations pass through
        fb = (f32(b, d, lo=-0.5, hi=0.5), f32(b, d, lo=-0.5, hi=0.5))
        want = jvivaldi.update(cfg_j, st, *other, rtt, jax.random.PRNGKey(0),
                               fallback_rnd=fb)
        tst = tvivaldi.VivaldiState(*(torch.from_numpy(np.asarray(x)).to(
            torch.int64 if np.asarray(x).dtype == np.int32 else torch.float32)
            for x in st))
        got = tvivaldi.update(cfg_t, tst, *(torch.from_numpy(x) for x in other),
                              torch.from_numpy(rtt),
                              tuple(torch.from_numpy(x) for x in fb))
        for f in tvivaldi.VivaldiState._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-9, err_msg=f)


class TestTopology:
    @pytest.mark.parametrize("n", [64, 1024])
    @pytest.mark.parametrize("k", [8, 16])
    def test_tables_match(self, n, k):
        jcfg, _ = tp.configs(n=n, view_degree=k)
        jt = jtopo.make_topology(jcfg, jax.random.PRNGKey(n + k))
        tt = ttopo.topology_from_offsets(n, np.asarray(jt.off))
        np.testing.assert_array_equal(tt.off.numpy(), np.asarray(jt.off))
        np.testing.assert_array_equal(tt.rcol.numpy(), np.asarray(jt.rcol))
        np.testing.assert_array_equal(tt.inv.numpy(), np.asarray(jt.inv))
        for j in (0, k // 2, k - 1):
            np.testing.assert_array_equal(
                ttopo.remap_row(tt, torch.tensor(j)).numpy(),
                np.asarray(jtopo.remap_row(jt, j)))
            assert int(ttopo.inv_col(tt, torch.tensor(j))) == int(jtopo.inv_col(jt, j))
        rows = np.arange(n, dtype=np.int32)
        cols = rows % k
        np.testing.assert_array_equal(
            ttopo.neighbor_of(tt, torch.from_numpy(rows.astype(np.int64)),
                              torch.from_numpy(cols.astype(np.int64))).numpy(),
            np.asarray(jtopo.neighbor_of(jt, rows, cols)))
        x = np.random.default_rng(n).random(n).astype(np.float32)
        np.testing.assert_array_equal(
            ttopo.gather_cols(tt, torch.from_numpy(x)).numpy(),
            np.asarray(jtopo.gather_cols(jt, jnp.asarray(x))))

    def test_dense_tables_match(self):
        jcfg, _ = tp.configs(n=64, view_degree=0)
        jt = jtopo.make_topology(jcfg, jax.random.PRNGKey(0))
        tt = convert.topology_from(tp.np_tree(jt))
        assert tt.dense and tt.degree == 63
        for j in (0, 31, 62):
            np.testing.assert_array_equal(
                ttopo.remap_row(tt, torch.tensor(j)).numpy(),
                np.asarray(jtopo.remap_row(jt, j)))
            assert int(ttopo.inv_col(tt, torch.tensor(j))) == int(jtopo.inv_col(jt, j))

    def test_families_draw_the_reference_offsets(self):
        from consul_tpu.topo import families as jfam
        from consul_tpu_torch.topo import families as tfam
        for fam in ("circulant", "expander", "smallworld", "hier"):
            a = jfam.offsets_for(fam, 1024, 16, np.random.default_rng(5))
            b = tfam.offsets_for(fam, 1024, 16, np.random.default_rng(5))
            np.testing.assert_array_equal(a, b, err_msg=fam)


class TestWorld:
    def test_world_and_rtt_match(self):
        jcfg, tcfg = tp.configs(n=1024, view_degree=16)
        jw = jtopo.make_world(jcfg, jax.random.PRNGKey(4))
        tw = convert.world_from(tp.np_tree(jw))
        np.testing.assert_array_equal(tw.pos.numpy(), np.asarray(jw.pos))
        i = np.arange(1024) % 97
        j = (np.arange(1024) * 7) % 1024
        np.testing.assert_allclose(
            ttopo.true_rtt(tw, torch.from_numpy(i), torch.from_numpy(j)).numpy(),
            np.asarray(jtopo.true_rtt(jw, i, j)), rtol=1e-6)

    def test_make_world_draws_the_reference_distribution(self):
        cfg = TSimConfig(n=4096)
        gen = torch.Generator().manual_seed(0)
        w = ttopo.make_world(cfg, gen)
        assert w.pos.shape == (4096, cfg.world_dims) and w.pos.dtype == torch.float32
        assert float(w.pos.min()) >= 0.0
        assert float(w.pos.max()) <= cfg.world_diameter_ms / 1000.0
        assert float(w.height.min()) >= cfg.height_ms_min / 1000.0 - 1e-9
        assert float(w.height.max()) <= cfg.height_ms_max / 1000.0 + 1e-9
