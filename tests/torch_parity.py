"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

The reference (``consul_tpu``) makes the inputs and its own key ladder;
these helpers carry them across as numpy arrays into the port
(``consul_tpu_torch``), so both sides step the same state with the same
random numbers.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from consul_tpu.config import GossipConfig as JGossipConfig
from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models import state as j_state
from consul_tpu.ops import topology as j_topology
from consul_tpu_torch import convert
from consul_tpu_torch.config import GossipConfig as TGossipConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import layout as t_layout
from consul_tpu_torch.models import serf as t_serf
from consul_tpu_torch.models import swim as t_swim

# The port's tests run at small sizes beside other test workers: one
# intra-op thread each avoids oversubscribing the cores (PyTorch starts
# one thread per core in every process by default).
torch.set_num_threads(1)

# Vivaldi floats of the plain step against the reference, both in f32 on
# the CPU: the same operations in the same order; XLA and PyTorch may sum
# the 3-, 8- and 20-element reductions in another order (a few ulp per
# tick), so relative 1e-5 with an absolute floor far below one bf16 step.
VIV_RTOL = 1e-5
VIV_ATOL = 1e-7

# Packed float leaves (bfloat16, or float8 under the x256 codec) of the
# plain version against the reference: each element within MAX_STEPS
# storage steps (ulps), or within FLOOR_S seconds (height_min) where values
# cross zero, since a last-bit f32 difference in a reduction can flip a
# rounding; NaN only where both hold it.
PACKED_FLOATS = {"vec", "height", "error", "adjustment", "adj_samples", "lat_buf"}
MAX_STEPS, FLOOR_S = 3, 1e-5

DISCRETE = (
    "t", "alive_truth", "left", "leaving", "external", "own_inc",
    "own_tx", "awareness", "probe_perm", "probe_ptr", "next_probe_tick",
    "pending_col", "pending_fail_tick", "pending_nack_miss", "view_key",
    "susp_start", "susp_seen", "tx_left", "lat_cnt",
)


def configs(gossip=None, **kw):
    """The reference's and the port's SimConfig from the same kwargs;
    ``gossip`` is a dict of GossipConfig kwargs for both."""
    g = gossip or {}
    return (JSimConfig(gossip=JGossipConfig(**g), **kw),
            TSimConfig(gossip=TGossipConfig(**g), **kw))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def setup(n, view_degree, seed=3, **kw):
    """Reference config/world/topology/state, as the reference's tests
    build them, plus the port's config."""
    jcfg, tcfg = configs(n=n, view_degree=view_degree, **kw)
    kw_, kt, ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    world = j_topology.make_world(jcfg, kw_)
    topo = j_topology.make_topology(jcfg, kt)
    return jcfg, tcfg, world, topo, j_state.init(jcfg, ks)


def make_draws_fn(jcfg, chaos=False):
    """A jitted function: tick key -> the tick's draws as numpy arrays,
    split exactly as swim.step_counted and its helpers split the key.
    ``chaos`` adds ``u_pp``, the push-pull draw the reference takes only
    when a fault schedule is installed (swim.py:1155)."""
    n, k_deg = jcfg.n, jcfg.degree
    g = jcfg.gossip
    ic, fan, d = g.indirect_checks, g.gossip_nodes, jcfg.vivaldi.dimensionality

    @jax.jit
    def draws(tick_key):
        keys = jax.random.split(tick_key, 10)
        k_viv, k_grav = jax.random.split(keys[7])
        k_cols, k_drop = jax.random.split(keys[8])
        uni = jax.random.uniform
        out = dict(
            jitter=jax.random.normal(keys[0], (n,)),
            u2=uni(keys[1], (n, 2)),
            relay_jcols=jax.random.randint(keys[2], (ic,), 0, k_deg),
            u_a=uni(keys[3], (n, ic)),
            u_b=uni(keys[4], (n, ic)),
            u_c=uni(keys[5], (n, ic)),
            perm_u=uni(keys[6], (n, k_deg)),
            viv_fb=uni(k_viv, (n, d), minval=-0.5, maxval=0.5),
            grav_fb=uni(k_grav, (n, d), minval=-0.5, maxval=0.5),
            gossip_jcols=jax.random.randint(k_cols, (fan,), 0, k_deg),
            u_drop=uni(k_drop, (n, fan)),
            pp_j=jax.random.randint(keys[9], (), 0, k_deg),
        )
        if chaos:
            out["u_pp"] = uni(jax.random.fold_in(keys[9], 1), (n,))
        return out

    return draws


def make_serf_draws_fn(jcfg, chaos=False):
    """A jitted function: tick key -> the serf tick's draws as numpy
    arrays: ``k_swim, k_ev = split(key)``, the SWIM ladder on ``k_swim``,
    then ``u_resp`` on ``k_ev`` and the relay draws on
    ``split(fold_in(k_ev, 1), 3)`` (serf.py:498, :683-700). The relay
    draws are empty unless the reference draws them: with relays
    configured, under a schedule (``chaos``, which also adds ``u_pp``) or
    with packet loss."""
    n, k_deg = jcfg.n, jcfg.degree
    rf = jcfg.serf.query_relay_factor
    relay = rf > 0 and (chaos or jcfg.packet_loss > 0.0)
    swim_draws = make_draws_fn(jcfg, chaos=chaos)

    @jax.jit
    def draws(tick_key):
        k_swim, k_ev = jax.random.split(tick_key)
        out = dict(swim=swim_draws(k_swim),
                   u_resp=jax.random.uniform(k_ev, (n,)))
        if relay:
            k_rl1, k_rl2, k_rcol = jax.random.split(jax.random.fold_in(k_ev, 1), 3)
            out.update(relay_u1=jax.random.uniform(k_rl1, (n, rf)),
                       relay_u2=jax.random.uniform(k_rl2, (n, rf)),
                       relay_cols=jax.random.randint(k_rcol, (rf,), 0, k_deg))
        else:
            out.update(relay_u1=np.zeros((n, 0), np.float32),
                       relay_u2=np.zeros((n, 0), np.float32),
                       relay_cols=np.zeros((0,), np.int64))
        return out

    return draws


def to_serf_draws(d, device="cpu") -> t_serf.SerfDraws:
    f32 = torch.float32
    return t_serf.SerfDraws(
        swim=to_tick_draws(d["swim"], device),
        u_resp=convert.tensor(np.asarray(d["u_resp"]), device, f32),
        relay_u1=convert.tensor(np.asarray(d["relay_u1"]), device, f32),
        relay_u2=convert.tensor(np.asarray(d["relay_u2"]), device, f32),
        relay_cols=convert.tensor(np.asarray(d["relay_cols"]), device,
                                  torch.int64))


def to_tick_draws(d, device="cpu", chaos=True) -> t_swim.TickDraws:
    """Reference draws -> TickDraws; ``u_pp`` stays empty unless the
    draws hold it and ``chaos`` is set (a tick with a schedule)."""
    ints = ("relay_jcols", "gossip_jcols", "pp_j")
    d = dict(d)
    if not chaos or "u_pp" not in d:
        d["u_pp"] = np.zeros((0,), np.float32)
    return t_swim.TickDraws(**{
        k: convert.tensor(np.asarray(v), device,
                          torch.int64 if k in ints else torch.float32)
        for k, v in d.items()})


def assert_state_matches(ref, got, context):
    """Dense reference SimState (numpy) vs port SimState: discrete plane
    equal, Vivaldi and RTT floats within VIV_RTOL/VIV_ATOL."""
    for f in DISCRETE:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f).cpu()).astype(np.int64),
            np.asarray(getattr(ref, f)).astype(np.int64),
            err_msg=f"{context}: {f}")
    for f in ("vec", "height", "error", "adjustment", "adj_samples"):
        np.testing.assert_allclose(
            getattr(got.viv, f).cpu().numpy(), np.asarray(getattr(ref.viv, f)),
            rtol=VIV_RTOL, atol=VIV_ATOL, err_msg=f"{context}: viv.{f}")
    for f in ("adj_idx", "resets"):
        np.testing.assert_array_equal(
            getattr(got.viv, f).cpu().numpy(), np.asarray(getattr(ref.viv, f)),
            err_msg=f"{context}: viv.{f}")
    np.testing.assert_allclose(got.lat_buf.cpu().numpy(), np.asarray(ref.lat_buf),
                               rtol=VIV_RTOL, atol=VIV_ATOL,
                               err_msg=f"{context}: lat_buf")


SERF_LEAVES = t_serf.SerfState._fields[1:]


def assert_serf_equal(ref, got, context):
    """Reference SerfState serf leaves (numpy) vs the port's, exactly and
    dtype for dtype."""
    for f in SERF_LEAVES:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        assert g.dtype == r.dtype, f"{context}: {f} dtype {g.dtype} != {r.dtype}"
        np.testing.assert_array_equal(g, r, err_msg=f"{context}: {f}")


def assert_packed_equal(ref, got, context):
    """Reference PackedSimState (numpy) vs port PackedSimState, bit for
    bit, leaf for leaf."""
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if f == "viv":
            assert_packed_equal(r, g, context + ".viv")
            continue
        np.testing.assert_array_equal(convert.bits(g), convert.ref_bits(r),
                                      err_msg=f"{context}: {f}")


def assert_packed_close(ref, got, context):
    """Reference PackedSimState (numpy) vs port PackedSimState: discrete
    leaves bit for bit, float leaves within MAX_STEPS / FLOOR_S."""
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if f == "viv":
            assert_packed_close(r, g, context + ".viv")
        elif f in PACKED_FLOATS:
            steps, diff = t_layout.float_gap(g, convert.tensor(r))
            bad = (steps > MAX_STEPS) & (diff > FLOOR_S)
            assert not bool(bad.any()), (
                f"{context}.{f}: {int(bad.sum())} elements beyond {MAX_STEPS} "
                f"steps and {FLOOR_S} s (max {int(steps.max())} steps, "
                f"{float(diff.max())} s)")
        else:
            np.testing.assert_array_equal(convert.bits(g), convert.ref_bits(r),
                                          err_msg=f"{context}.{f}")
