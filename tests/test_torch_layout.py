"""PyTorch port vs the JAX reference: the packed StateLayout codec.

Tolerance: none. ``pack`` and ``unpack`` are bit-equal to the
reference's on random valid states, float leaves included (bfloat16 and
float8 casts round to nearest even on both sides).
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models import layout as jlayout
from consul_tpu.models import state as jstate
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import state as tstate

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401


def _random_state(n, k, seed):
    """A dense reference SimState with every field random within the
    packed layout's documented bounds."""
    jcfg, _ = tp.configs(n=n, view_degree=k)
    base = jstate.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    t = 1000

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, size=shape or (n,)).astype(np.int32)

    def f32(lo, hi, *shape):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    s, d, w = 3, jcfg.vivaldi.dimensionality, jcfg.vivaldi.adjustment_window_size
    key = (rng.integers(0, 65536, size=(n, k)).astype(np.uint32) << 2) \
        | rng.integers(0, 4, size=(n, k)).astype(np.uint32)
    susp_start = np.where(rng.random((n, k)) < 0.5, -1,
                          t - ints(0, 65535, n, k)).astype(np.int32)
    return base._replace(
        t=np.int32(t),
        alive_truth=rng.random(n) < 0.9, left=rng.random(n) < 0.1,
        leaving=rng.random(n) < 0.1, external=rng.random(n) < 0.1,
        own_inc=ints(0, 65536).astype(np.uint32), own_tx=ints(0, 256),
        awareness=ints(0, 8), probe_perm=ints(0, k, n, k),
        probe_ptr=ints(0, k), next_probe_tick=t + ints(-32768, 32768),
        pending_col=ints(-1, k), pending_fail_tick=t + ints(-32768, 32768),
        pending_nack_miss=ints(0, 4), view_key=key, susp_start=susp_start,
        susp_seen=rng.integers(0, 1 << 32, size=(n, k), dtype=np.uint64).astype(np.uint32),
        tx_left=ints(0, 64, n, k), lat_buf=f32(-2.0, 2.0, n, k, s),
        lat_cnt=ints(0, 65536, n, k),
        viv=base.viv._replace(
            vec=f32(-0.05, 0.05, n, d), height=f32(1e-5, 3e-3, n),
            error=f32(0.0, 1.5, n), adjustment=f32(-1e-3, 1e-3, n),
            adj_samples=f32(-2.0, 2.0, n, w), adj_idx=ints(0, w),
            resets=ints(0, 256)),
    )


@pytest.mark.parametrize("k", [16, 32])
def test_pack_is_bit_equal(k):
    ref = _random_state(512, k, seed=k)
    want = tp.np_tree(jlayout.pack(ref))
    got = tlayout.pack(convert.sim_state_from(ref))
    tp.assert_packed_equal(want, got, "pack")


@pytest.mark.parametrize("k", [16, 32])
def test_unpack_is_bit_equal(k):
    packed = tp.np_tree(jlayout.pack(_random_state(512, k, seed=100 + k)))
    want = tp.np_tree(jlayout.unpack(packed))
    got = tlayout.unpack(convert.packed_state_from(packed))
    for f in tp.DISCRETE + ("lat_buf",):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.float64),
            np.asarray(getattr(want, f)).astype(np.float64), err_msg=f)
    for f in want.viv._fields:
        np.testing.assert_array_equal(
            getattr(got.viv, f).numpy().astype(np.float64),
            np.asarray(getattr(want.viv, f)).astype(np.float64), err_msg=f)


def test_pack_unpack_round_trip_is_a_fixed_point():
    packed = convert.packed_state_from(
        tp.np_tree(jlayout.pack(_random_state(256, 16, seed=7))))
    again = tlayout.pack(tlayout.unpack(packed))
    for a, b in zip(tlayout.leaves(packed), tlayout.leaves(again)):
        np.testing.assert_array_equal(convert.bits(a), convert.bits(b))
    assert tlayout.pack_state(packed) is packed
    dense = tlayout.unpack_state(packed)
    assert tlayout.unpack_state(dense) is dense


def test_bytes_per_node_matches_reference():
    n = 1024
    jcfg, tcfg = tp.configs(n=n, view_degree=32)
    want = jlayout.bytes_per_node(jlayout.pack(jstate.init(jcfg, jax.random.PRNGKey(0))), n)
    got = tlayout.bytes_per_node(
        tlayout.pack(tstate.init(tcfg, torch.Generator().manual_seed(0))), n)
    assert got == want
    assert round(got) == 536


def test_validate_rejects_overflowing_configs():
    with pytest.raises(ValueError):
        tlayout.validate(TSimConfig(n=1024, view_degree=256), tlayout.PACKED)
    with pytest.raises(ValueError):
        tlayout.validate(TSimConfig(n=1024), "sparse")
    tlayout.validate(TSimConfig(n=1024, view_degree=256), tlayout.DENSE)
