"""StateLayout: the packed per-node state (PyTorch port of
``consul_tpu/models/layout.py``).

The same encoding as the reference, leaf for leaf and dtype for dtype,
so a packed state carries across bit for bit:

* the discrete plane is narrowed to the width its protocol bound needs
  (statuses 2 bits, gossip budgets 6, probe columns 8, incarnations 16,
  saturating) and round-trips exactly;
* tick-anchored deadlines are saturating i16/u16 deltas from ``t``;
* Vivaldi floats rest in bfloat16; RTT windows in float8_e4m3fn scaled
  by 256, clipped before the cast (the cast alone must not be trusted to
  saturate).

536 B/node at K = 32 (``bytes_per_node``); a packed ``SerfState`` adds
its serf plane as it is, 1,477 B/node at K = 32 with the default serf
config.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import state as sim_state
from consul_tpu_torch.ops import merge, scaling, vivaldi

DENSE = "dense"
PACKED = "packed"
LAYOUTS = (DENSE, PACKED)

_F8 = torch.float8_e4m3fn
_F8_SCALE = 256.0
_F8_CLIP = 448.0 / _F8_SCALE

_NO_COL = 255        # pending_col == -1
_NO_SUSP = 65535     # susp_start == -1
_SUSP_MAX = 65534    # saturation for live suspicion ages

_META_STATUS_BITS = 2
_META_TX_BITS = 6
_META_TX_MAX = (1 << _META_TX_BITS) - 1


def _to_f8(x):
    """f32 seconds -> scaled float8 (clip, then cast)."""
    return (torch.clamp(x, -_F8_CLIP, _F8_CLIP) * _F8_SCALE).to(_F8)


def _from_f8(x):
    """Scaled float8 -> f32 seconds (exact: power-of-two scale)."""
    return x.to(torch.float32) / _F8_SCALE


class PackedVivaldi(NamedTuple):
    vec: torch.Tensor          # [N, D] bfloat16
    height: torch.Tensor       # [N] bfloat16
    error: torch.Tensor        # [N] bfloat16
    adjustment: torch.Tensor   # [N] bfloat16
    adj_samples: torch.Tensor  # [N, W] float8_e4m3fn (x256 codec)
    adj_idx: torch.Tensor      # [N] uint8
    resets: torch.Tensor       # [N] uint8 (wraps mod 256)


class PackedSimState(NamedTuple):
    t: torch.Tensor                   # [] int32
    flags: torch.Tensor               # [N] uint8 alive|left<<1|leaving<<2|external<<3
    own_inc: torch.Tensor             # [N] uint16 (saturating)
    own_tx: torch.Tensor              # [N] uint8
    awareness: torch.Tensor           # [N] uint8
    probe_ptr: torch.Tensor           # [N] uint8
    next_probe_delta: torch.Tensor    # [N] int16 = next_probe_tick - t
    pending_col: torch.Tensor         # [N] uint8, 255 = none
    pending_fail_delta: torch.Tensor  # [N] int16 = pending_fail_tick - t
    pending_nack_miss: torch.Tensor   # [N] uint8
    view_inc: torch.Tensor            # [N, K] uint16
    meta: torch.Tensor                # [N, K] uint16 status|tx_left<<2|perm<<8
    susp_delta: torch.Tensor          # [N, K] uint16 = t - susp_start
    susp_seen: torch.Tensor           # [N, K] uint32 accuser bitmask
    lat_cnt: torch.Tensor             # [N, K] uint16
    lat_buf: torch.Tensor             # [N, K, S] float8_e4m3fn
    viv: PackedVivaldi


def validate(cfg: SimConfig, layout: str) -> None:
    """Reject configs whose protocol bounds overflow the packed widths."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown state layout {layout!r}; "
                         f"expected one of {LAYOUTS}")
    if layout == DENSE:
        return
    k_deg = cfg.degree
    if k_deg > 255:
        raise ValueError(
            f"packed layout needs view degree <= 255 (8-bit probe "
            f"columns + pending_col sentinel); got K={k_deg}")
    tx_limit = int(scaling.retransmit_limit(cfg.gossip.retransmit_mult, cfg.n))
    if tx_limit > _META_TX_MAX:
        raise ValueError(
            f"packed layout stores tx_left in {_META_TX_BITS} bits "
            f"(<= {_META_TX_MAX}); retransmit limit for n={cfg.n} is "
            f"{tx_limit}")
    if cfg.gossip.awareness_max > 256:
        raise ValueError(
            f"packed layout stores awareness in 8 bits; awareness_max="
            f"{cfg.gossip.awareness_max} > 256")
    interval_max = cfg.gossip.probe_period_ticks * cfg.gossip.awareness_max
    if interval_max > 32767:
        raise ValueError(
            f"packed layout stores probe deadlines as i16 tick deltas; "
            f"max probe interval {interval_max} overflows")
    if cfg.vivaldi.adjustment_window_size > 255:
        raise ValueError(
            f"packed layout stores the adjustment-window cursor in 8 "
            f"bits; window size {cfg.vivaldi.adjustment_window_size}")


def pack(state: sim_state.SimState) -> PackedSimState:
    """Dense SimState -> PackedSimState (elementwise)."""
    t = state.t
    flags = (state.alive_truth.to(torch.int64)
             | (state.left.to(torch.int64) << 1)
             | (state.leaving.to(torch.int64) << 2)
             | (state.external.to(torch.int64) << 3))
    status = state.view_key & (merge.N_STATUS - 1)
    tx = torch.clamp(state.tx_left, 0, _META_TX_MAX)
    meta = (status | (tx << _META_STATUS_BITS)
            | (state.probe_perm << (_META_STATUS_BITS + _META_TX_BITS)))
    susp_age = torch.clamp(t - state.susp_start, 0, _SUSP_MAX)
    susp_delta = torch.where(state.susp_start < 0,
                             torch.full_like(susp_age, _NO_SUSP), susp_age)
    v = state.viv
    bf = torch.bfloat16
    u8, u16, i16 = torch.uint8, torch.uint16, torch.int16
    return PackedSimState(
        t=t.to(torch.int32),
        flags=flags.to(u8),
        own_inc=torch.clamp(state.own_inc, max=65535).to(u16),
        own_tx=torch.clamp(state.own_tx, 0, 255).to(u8),
        awareness=(state.awareness & 0xFF).to(u8),
        probe_ptr=(state.probe_ptr & 0xFF).to(u8),
        next_probe_delta=torch.clamp(state.next_probe_tick - t,
                                     -32768, 32767).to(i16),
        pending_col=torch.where(state.pending_col < 0,
                                torch.full_like(state.pending_col, _NO_COL),
                                state.pending_col).to(u8),
        pending_fail_delta=torch.clamp(state.pending_fail_tick - t,
                                       -32768, 32767).to(i16),
        pending_nack_miss=torch.clamp(state.pending_nack_miss, 0, 255).to(u8),
        view_inc=torch.clamp(merge.key_incarnation(state.view_key),
                             max=65535).to(u16),
        meta=(meta & 0xFFFF).to(u16),
        susp_delta=susp_delta.to(u16),
        susp_seen=state.susp_seen.to(torch.uint32),
        lat_cnt=torch.clamp(state.lat_cnt, max=65535).to(u16),
        lat_buf=_to_f8(state.lat_buf),
        viv=PackedVivaldi(
            vec=v.vec.to(bf),
            height=v.height.to(bf),
            error=v.error.to(bf),
            adjustment=v.adjustment.to(bf),
            adj_samples=_to_f8(v.adj_samples),
            adj_idx=(v.adj_idx & 0xFF).to(u8),
            resets=(v.resets & 0xFF).to(u8),
        ),
    )


def unpack(packed: PackedSimState) -> sim_state.SimState:
    """PackedSimState -> the dense SimState the step consumes."""
    i64 = torch.int64
    t = packed.t.to(i64)
    meta = packed.meta.to(i64)
    status = meta & (merge.N_STATUS - 1)
    tx_left = (meta >> _META_STATUS_BITS) & _META_TX_MAX
    perm = meta >> (_META_STATUS_BITS + _META_TX_BITS)
    susp_delta = packed.susp_delta.to(i64)
    susp_start = torch.where(susp_delta == _NO_SUSP,
                             -torch.ones_like(susp_delta), t - susp_delta)
    flags = packed.flags.to(i64)
    pcol = packed.pending_col.to(i64)
    pv = packed.viv
    return sim_state.SimState(
        t=t,
        alive_truth=(flags & 1) != 0,
        left=(flags & 2) != 0,
        leaving=(flags & 4) != 0,
        external=(flags & 8) != 0,
        own_inc=packed.own_inc.to(i64),
        own_tx=packed.own_tx.to(i64),
        awareness=packed.awareness.to(i64),
        probe_perm=perm,
        probe_ptr=packed.probe_ptr.to(i64),
        next_probe_tick=t + packed.next_probe_delta.to(i64),
        pending_col=torch.where(pcol == _NO_COL, -torch.ones_like(pcol), pcol),
        pending_fail_tick=t + packed.pending_fail_delta.to(i64),
        pending_nack_miss=packed.pending_nack_miss.to(i64),
        view_key=merge.make_key(packed.view_inc.to(i64), status),
        susp_start=susp_start,
        susp_seen=packed.susp_seen.to(i64),
        tx_left=tx_left,
        viv=vivaldi.VivaldiState(
            vec=pv.vec.to(torch.float32),
            height=pv.height.to(torch.float32),
            error=pv.error.to(torch.float32),
            adjustment=pv.adjustment.to(torch.float32),
            adj_samples=_from_f8(pv.adj_samples),
            adj_idx=pv.adj_idx.to(i64),
            resets=pv.resets.to(i64),
        ),
        lat_buf=_from_f8(packed.lat_buf),
        lat_cnt=packed.lat_cnt.to(i64),
    )


# Whole-driver-state dispatch: a SerfState keeps its event/query plane in
# the reference's at-rest dtypes and swaps only the SWIM plane.

def pack_state(state):
    """Pack a driver state (SimState or SerfState). Idempotent: an
    already-packed SWIM plane passes through."""
    if hasattr(state, "swim"):
        if isinstance(state.swim, PackedSimState):
            return state
        return state._replace(swim=pack(state.swim))
    return state if isinstance(state, PackedSimState) else pack(state)


def unpack_state(state):
    """Inverse of :func:`pack_state` (idempotent on dense input)."""
    if hasattr(state, "swim"):
        if isinstance(state.swim, PackedSimState):
            return state._replace(swim=unpack(state.swim))
        return state
    return unpack(state) if isinstance(state, PackedSimState) else state


def is_packed(state) -> bool:
    sw = state.swim if hasattr(state, "swim") else state
    return isinstance(sw, PackedSimState)


def swim_plane(state):
    """The SWIM plane of any driver state, dense, without touching the
    rest."""
    sw = state.swim if hasattr(state, "swim") else state
    return unpack(sw) if isinstance(sw, PackedSimState) else sw


def tick_of(state):
    """Current tick of any (possibly packed) driver state, read off the
    ``t`` leaf without unpacking."""
    sw = state.swim if hasattr(state, "swim") else state
    return sw.t


# Row gathers and scatters run on a same-width view of the leaves whose
# dtypes have no index kernels (unsigned ints, float8).
ROW_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.float8_e4m3fn: torch.uint8}


def take_rows(tree, idx):
    """The rows ``idx`` of every per-node leaf of a (packed or dense)
    SWIM plane; the scalar ``t`` as it is."""
    out = []
    for x in tree:
        if not isinstance(x, torch.Tensor):
            out.append(take_rows(x, idx))
        elif x.dim() == 0:
            out.append(x)
        else:
            v = ROW_VIEWS.get(x.dtype)
            out.append(x.index_select(0, idx) if v is None
                       else x.view(v).index_select(0, idx).view(x.dtype))
    return type(tree)(*out)


def float_gap(a: torch.Tensor, b: torch.Tensor):
    """Element-wise gap between two packed float leaves of one dtype
    (bfloat16, or float8 under the x256 codec): (steps apart in the
    storage format, |difference| of the decoded f32 values). A NaN on both
    sides is no gap; a NaN on one side only is an infinite one."""
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, _F8):
        raise TypeError(f"float_gap takes two bfloat16 or two float8 leaves, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dtype == torch.bfloat16:
        ints, mag, decode = torch.int16, 0x7FFF, lambda x: x.to(torch.float32)
    else:
        ints, mag, decode = torch.int8, 0x7F, _from_f8

    def order(x):  # sign-magnitude bits -> an integer order of the values
        bits = x.view(ints).to(torch.int32)
        return torch.where(bits < 0, -(bits & mag), bits)

    fa, fb = decode(a), decode(b)
    na, nb = torch.isnan(fa), torch.isnan(fb)
    steps = (order(a) - order(b)).abs()
    diff = (fa - fb).abs()
    steps = torch.where(na | nb, torch.where(na == nb, 0, 1 << 16), steps)
    diff = torch.where(na | nb, torch.where(na == nb, 0.0, float("inf")), diff)
    return steps, diff


def leaves(tree):
    """The tensor leaves of a (nested) NamedTuple state."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            out.extend(leaves(x))
    return out


def np_size_bytes(leaf: torch.Tensor) -> int:
    return int(leaf.numel()) * int(leaf.element_size())


def bytes_per_node(tree, n: int) -> float:
    """At-rest bytes per node of a state with node axis size n."""
    return sum(np_size_bytes(x) for x in leaves(tree)) / float(n)
