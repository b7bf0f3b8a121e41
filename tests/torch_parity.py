"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

The reference (``consul_tpu``) makes the inputs and its own key ladder;
these helpers carry them across as numpy arrays into the port
(``consul_tpu_torch``), so both sides step the same state with the same
random numbers.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from consul_tpu.config import GossipConfig as JGossipConfig
from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models import federation as j_federation
from consul_tpu.models import state as j_state
from consul_tpu.ops import topology as j_topology
from consul_tpu_torch import convert
from consul_tpu_torch.config import GossipConfig as TGossipConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import federation as t_federation
from consul_tpu_torch.models import layout as t_layout
from consul_tpu_torch.models import serf as t_serf
from consul_tpu_torch.models import swim as t_swim

# The port's tests run at small sizes beside other test workers: one
# intra-op thread each avoids oversubscribing the cores (PyTorch starts
# one thread per core in every process by default).
torch.set_num_threads(1)

@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    """Compile the reference's programs with most of XLA's optimization
    work off (``jax_disable_most_optimizations``) while a parity module
    runs, and put the flag back after it. The oracles then compile about
    40 % faster on the CPU, and the same fields are checked at the same
    ticks with the same tolerances. The flag can move the reference's f32
    Vivaldi and RTT floats in their last bits (another fusion, another
    rounding), which the float tolerances are there for:
    ``tests/reference_flag_check.py`` runs the interpret-mode tick,
    ``run_scenario`` and the federation's runners with the flag off and
    on and reports every array that moved. In the cases it runs, no
    discrete leaf and no counter did. A test module
    takes it with ``from torch_parity import quick_reference_compiles``."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


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


# tests/test_layout_parity.py's tolerance for the packed floats against the
# dense f32 reference (bfloat16 coordinates, float8 RTT windows).
PACKED_RTOL = 3e-2
PACKED_ATOL = 2e-3
PACKED_LAT_ATOL = 2e-2


def assert_fed_state(ref, got, context):
    """A port FederationState against the reference's (numpy): every
    pool's packed state unpacks to the reference's dense one, the discrete
    plane bit for bit and the floats within tests/test_layout_parity.py's
    tolerance."""
    assert got.wan_accum_ms == int(ref.wan_accum_ms), context
    pools = [(f"{context} lan{i}", convert._take(ref.lan, i), p)
             for i, p in enumerate(got.lan)]
    pools.append((f"{context} wan", ref.wan, got.wan))
    for where, r, p in pools:
        d = t_layout.unpack(p)
        for f in DISCRETE:
            np.testing.assert_array_equal(
                getattr(d, f).numpy().astype(np.int64),
                np.asarray(getattr(r, f)).astype(np.int64),
                err_msg=f"{where}: {f}")
        for f in ("adj_idx", "resets"):
            np.testing.assert_array_equal(
                getattr(d.viv, f).numpy(), np.asarray(getattr(r.viv, f)),
                err_msg=f"{where}: viv.{f}")
        for f in ("vec", "height", "error", "adjustment", "adj_samples"):
            np.testing.assert_allclose(
                getattr(d.viv, f).numpy(), np.asarray(getattr(r.viv, f)),
                rtol=PACKED_RTOL,
                atol=PACKED_ATOL if f != "adj_samples" else PACKED_LAT_ATOL,
                err_msg=f"{where}: viv.{f}")
        np.testing.assert_allclose(d.lat_buf.numpy(), np.asarray(r.lat_buf),
                                   rtol=PACKED_RTOL, atol=PACKED_LAT_ATOL,
                                   err_msg=f"{where}: lat_buf")


def ladder_draws(jcfg, base_key, holder):
    """``draws(t)`` from the reference's ladder (federation.py:111-113,
    :173): ``fold_in(base_key, t)`` split into LAN and WAN keys, the LAN key
    split n_dc ways; the WAN bundle only when the port's WAN tick fires.
    One jitted call derives the tick's keys and every bundle."""
    lan_fn = make_draws_fn(jcfg.lan)
    wan_fn = make_draws_fn(jcfg.wan)

    @jax.jit
    def ladder(t):
        k_lan, k_wan = jax.random.split(jax.random.fold_in(base_key, t))
        return (jax.vmap(lan_fn)(jax.random.split(k_lan, jcfg.n_dc)),
                wan_fn(k_wan))

    def draws(t):
        lan, wan = jax.device_get(ladder(t))
        lan = [to_tick_draws({k: v[i] for k, v in lan.items()})
               for i in range(jcfg.n_dc)]
        wan = to_tick_draws(wan) if holder["fed"].next_wan_fires() else None
        return lan, wan

    return draws


def port_federation(jcfg, tcfg, jfed, **kw):
    """The port's plain-path Federation started from a reference one."""
    holder = {}
    fed = t_federation.Federation(
        tcfg, seed=0, device="cpu", kernel="torch",
        draws=ladder_draws(jcfg, jfed.base_key, holder),
        **convert.federation_kw(jfed), **kw)
    holder["fed"] = fed
    return fed


def fed_configs(**kw):
    lan = kw.pop("lan", {})
    return (j_federation.FederationConfig(lan=JSimConfig(**lan), **kw),
            t_federation.FederationConfig(lan=TSimConfig(**lan), **kw))


def fed_oracle(jcfg, lan_topo, wan_topo):
    """The reference's federation tick (federation.py:101-143) with its
    counters, rounded through the reference's packed codec after every
    step, as the reference's packed simulation is: a jitted
    ``tick(lan_world, wan_world, state, key, off=0) -> (state, lan counters
    [n_dc, 26], WAN counters [26])`` over a dense FederationState (``off``
    the first owned WAN row, ``dc_offset * servers_per_dc``), built
    from the reference's ``swim.step_counted`` and ``layout.pack`` /
    ``unpack``. The WAN step runs every tick and is kept where the
    Bresenham accumulator fires (its counters are zero elsewhere)."""
    import jax.numpy as jnp

    from consul_tpu.models import counters as j_counters
    from consul_tpu.models import layout as j_layout
    from consul_tpu.models import swim as j_swim

    lan_cfg, wan_cfg = jcfg.lan, jcfg.wan
    s = jcfg.servers_per_dc
    lan_ms, wan_ms = lan_cfg.gossip.tick_ms, wan_cfg.gossip.tick_ms

    def rounded(st):
        return j_layout.unpack(j_layout.pack(st))

    def lan_step(world, st, key):
        st, c = j_swim.step_counted(lan_cfg, lan_topo, world, st, key)
        return rounded(st), j_counters.stack(c)

    @jax.jit
    def tick(lan_world, wan_world, state, key, off=0):
        k_lan, k_wan = jax.random.split(key)
        lan, lc = jax.vmap(lan_step)(lan_world, state.lan,
                                     jax.random.split(k_lan, jcfg.n_dc))
        wan = state.wan._replace(
            alive_truth=jax.lax.dynamic_update_slice(
                state.wan.alive_truth, lan.alive_truth[:, :s].reshape(-1), (off,)),
            left=jax.lax.dynamic_update_slice(
                state.wan.left, lan.left[:, :s].reshape(-1), (off,)))
        accum = state.wan_accum_ms + lan_ms
        fire = accum >= wan_ms
        stepped, wc = j_swim.step_counted(wan_cfg, wan_topo, wan_world, wan, k_wan)
        wan = jax.tree.map(functools.partial(jnp.where, fire), rounded(stepped), wan)
        wc = jnp.where(fire, j_counters.stack(wc), 0)
        accum = jnp.where(fire, accum - wan_ms, accum)
        return state._replace(lan=lan, wan=wan, wan_accum_ms=accum), lc, wc

    @jax.jit
    def start(state):
        """The reference's initial state, rounded as the port packs it."""
        return state._replace(lan=jax.vmap(rounded)(state.lan),
                              wan=rounded(state.wan))

    tick.start = start
    return tick


@functools.lru_cache(maxsize=None)
def _j_pack():
    from consul_tpu.models import layout as j_layout

    return jax.jit(j_layout.pack)


def assert_fed_close(ref, got, context):
    """A port FederationState against the rounded reference
    (:func:`fed_oracle`, numpy): every pool's packed state equal to the
    reference's packing of it, discrete leaves bit for bit and float
    leaves within MAX_STEPS / FLOOR_S (:func:`assert_packed_close`)."""
    pack = _j_pack()
    assert got.wan_accum_ms == int(ref.wan_accum_ms), context
    for i, p in enumerate(got.lan):
        assert_packed_close(np_tree(pack(convert._take(ref.lan, i))),
                            p, f"{context} lan{i}")
    assert_packed_close(np_tree(pack(ref.wan)), got.wan, f"{context} wan")
