"""The packed gossip tick as a hand-written CUDA kernel for Hopper.

Counterpart of ``consul_tpu/ops/pallas_gossip.py``: its one ``pallas_call``
(``make_tick_kernel``, pallas_call at :145) fuses unpack -> tick -> pack
over the packed state, for ``step_fn=swim.step_counted`` (the bare SWIM
tick), ``step_fn=serf.step_counted`` (the fused serf plane) or
``step_fn=serf.step_reference_counted`` (the pre-fusion serf oracle,
B8), each with or without a fault schedule and the invariant sentinel,
on the sparse circulant view or the dense one (K = N - 1 <= 255). The
port's kernel is ``consul_tpu_torch/csrc/gossip_tick.cu``: three
launches split at the tick's grid-wide read-after-write barriers
(probe/sender, receive, push-pull/pack), in the serf variant a fourth
(serf_post), in the pre-fusion serf variant two more instead (ref_send
and ref_intake, the event sweep split at its one barrier), and with a
schedule a first one (chaos_pre) that applies the churn edges and
evaluates the schedule per row. The tick is bound by bytes, most of them
[N, K] view rows and [N, E] / [N, R, O] serf rows, so every launch but
chaos_pre runs on a persistent grid of warp tiles: a warp owns up to 32
consecutive rows, takes their cells with consecutive lanes (every warp
load of a row-major leaf a full line; serf_post stages its queue and
dedup buckets in shared memory) and their per-row scalar work one row
per lane; chaos_pre takes four rows a thread, reads the schedule's node
masks bit-packed once per installed schedule (:func:`pack_masks`) and
hands the later launches one word and one 16-byte record a row. See the
note at the top of that file. :func:`launch_hbm_bytes_per_node` counts each
launch's least traffic, the yardstick of its time on the card.

One more launch of that file, M (:class:`MetricsKernel`), is not a TPU
kernel: it computes a tick's TickTrace row (agreement, false positives,
undetected deaths, Vivaldi RMSE) from the packed leaves, where the
reference's chunk body unpacks a transient view. Its plain version is
:func:`plain_metrics`. Launch L (:class:`LensKernel`), not a TPU kernel
either, writes a tick's node-lens row of S sampled nodes (the reference
gathers it with XLA in its chunk scan, ``consul_tpu/obs/lens.py:88``);
its plain version is ``obs/lens.snapshot_packed``.

Beside the kernel sit its plain PyTorch versions, :func:`plain_tick`
(``unpack -> swim.step_counted -> pack``), :func:`plain_serf_tick`
(``unpack_state -> serf.step_counted -> pack_state``) and
:func:`plain_reference_serf_tick` (the same through
``serf.step_reference_counted``), which the CPU tests
hold against the reference and which ``chip_smoke.py`` holds the kernel
against on the card. A plain version is chosen only by an explicit
``kernel="torch"``; the kernel wrapper raises on anything it does not
take (a CPU tensor, K > 255, a wrong dtype or shape) and never falls
back.

Build: ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes``, compiled at first use into ``utils/compile_cache``'s
directory (by default ``build/consul_tpu_torch/`` beside the package;
the file name carries a hash of the source, so an edited source
rebuilds). Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Optional

import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.ops import topology
from consul_tpu_torch.ops.topology import Topology
from consul_tpu_torch.utils import compile_cache, metrics

TORCH = "torch"
CUDA = "cuda"
KERNELS = (TORCH, CUDA)
# The reference's engine names, taken as aliases (Simulation.set_kernel,
# the CLI's --kernel).
KERNEL_ALIASES = {"pallas": CUDA, "xla": TORCH}

# The tick kernel's variants: the bare SWIM tick (B1-B3, B5), the fused
# serf tick (B4, B6) and the pre-fusion serf tick (B8).
SWIM, SERF, SERF_REFERENCE = "swim", "serf", "serf_reference"
VARIANTS = (SWIM, SERF, SERF_REFERENCE)

# Kernel launches on the card since the last reset, by launch stage
# (serf_post runs in the serf variant only, ref_send and ref_intake (E1,
# E2) in the pre-fusion serf variant only, chaos_pre in ticks with a
# fault schedule; metrics is launch M, once per tick with metrics on;
# lens is launch L, once per tick with the node lens armed).
# Incremented only where a stage is launched; chip_smoke.py zeroes it
# before it drives a main path and reads it after.
LAUNCHES = {"chaos_pre": 0, "probe_send": 0, "receive": 0, "pushpull": 0,
            "serf_post": 0, "ref_send": 0, "ref_intake": 0, "metrics": 0,
            "lens": 0}
# The sharded call's launches (B7, ShardedTickKernel), by stage, beside
# LAUNCHES (which counts them too), and its cross-group SLO folds.
SHARDED_LAUNCHES = {"chaos_pre": 0, "probe_send": 0, "receive": 0,
                    "pushpull": 0, "serf_post": 0, "slo_fold": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gossip_tick.cu")

# Limits of the kernel's per-thread arrays (gossip_tick.cu).
_MAXD, _MAXW, _MAXS, _MAXFAN, _MAXP = 16, 64, 8, 8, 7
_MAXE, _MAXPE, _MAXC = 16, 8, 32
# serf_post's shared-memory stage per warp, in 32-bit words
# (SERF_WARP_WORDS), and the words one tile row takes (serf_row_words).
_SERF_WARP_WORDS = 4096


def _serf_row_words(e: int, r: int, o: int) -> int:
    return (r | 1) + ((r * o) | 1) + 3 * (e | 1)
# The largest query_relay_factor the serf variant takes.
MAX_RELAY_FACTOR = 8

# TickArgs tables, in the order of the enums in gossip_tick.cu.
_LEAVES = 23
_SERF_LEAVES = len(serf.SerfState._fields) - 1
# The schedule leaves the kernel reads: every family but the raft lane,
# which the SWIM tick does not read. The node masks go in packed into bit
# words (:func:`pack_masks`, in MASK_FIELDS order), the rest as they are.
_SCHED_LEAVES = chaos_mod.ChaosSchedule._fields[:19]
assert _SCHED_LEAVES[-1] == "dg_mask"
MASK_FIELDS = ("part_side", "ll_a", "ll_b", "cw_mask", "dg_mask")
_SCHED_SCALARS = tuple(f for f in _SCHED_LEAVES if f not in MASK_FIELDS)
# The most u32 mask words a row that launch P stages (4 per word of
# shared memory a block).
MAX_MASK_WORDS = 1024
_PTRS = (
    ["in_" + str(k) for k in range(_LEAVES)]
    + ["out_" + str(k) for k in range(_LEAVES)]
    + ["pos", "height", "jitter", "u2", "relay_jcols", "u_a", "u_b", "u_c",
       "perm_u", "viv_fb", "grav_fb", "u_drop", "pp_j", "gossip_jcols", "off",
       "rcol", "inv",
       "view_mid", "pay_flags", "pay_scol", "pay_skey", "pay_sbits",
       "pay_ownk", "poke", "refute", "counters"]
    + ["sin_" + str(k) for k in range(_SERF_LEAVES)]
    + ["sout_" + str(k) for k in range(_SERF_LEAVES)]
    + ["u_resp", "relay_u1", "relay_u2", "relay_cols", "x_flags", "x_key",
       "x_orig", "ev_cols", "ev_u_drop"]
    + list(_SCHED_SCALARS)
    + ["masks", "u_pp", "c_word", "c_rec", "slo"]
)
# The mirrors (full-height copies of what a launch reads at other rows) and
# where each comes from in a tick: a SWIM-plane leaf of the input, a
# scratch buffer, a draw or a serf leaf of the input.
MIRRORS = {
    "m_flags": "flags", "m_inc": "own_inc", "m_vec": "viv.vec",
    "m_vh": "viv.height", "m_verr": "viv.error", "m_vadj": "viv.adjustment",
    "m_cword": "c_word", "m_crec": "c_rec", "m_vmid": "view_mid",
    "m_pflags": "pay_flags",
    "m_pscol": "pay_scol", "m_pskey": "pay_skey", "m_psbits": "pay_sbits",
    "m_pownk": "pay_ownk", "m_poke": "poke", "m_upp": "u_pp",
    "m_xflags": "x_flags", "m_xkey": "x_key", "m_xorig": "x_orig",
    "m_qopen": "q_open_key", "m_leave": "leave_at"}


# The sources of MIRRORS that are leaves of the state (the rest are scratch
# buffers of a tick and the push-pull draw), as paths into a packed SWIM
# plane ("viv.vec") or a SerfState ("swim.viv.vec", "q_open_key"). Under a
# mesh of several device groups each is stored full height per group, so
# that the group's rows and the other groups' (filled in by the exchange)
# form one buffer: the group's mirror.
_SWIM_FULL = frozenset(v for v in MIRRORS.values() if v.startswith("viv.")
                       or v in layout_mod.PackedSimState._fields)
_SERF_FULL = frozenset(v for v in MIRRORS.values()
                       if v in serf.SerfState._fields)
# The rest are the tick's scratch buffers (TickKernel._buffers makes each
# of them full height under several groups) and the push-pull draw.
assert frozenset(MIRRORS.values()) - _SWIM_FULL - _SERF_FULL == {
    "c_word", "c_rec", "view_mid", "pay_flags", "pay_scol", "pay_skey",
    "pay_sbits", "pay_ownk", "poke", "x_flags", "x_key", "x_orig", "u_pp"}


def full_height_leaves(tree) -> frozenset:
    """Paths (``parallel.mesh.split``'s) of the leaves of a packed state
    that the sharded tick reads at other rows: stored full height per
    device group, the group's own rows in place."""
    if isinstance(tree, serf.SerfState):
        return frozenset("swim." + p for p in _SWIM_FULL) | _SERF_FULL
    if isinstance(tree, layout_mod.PackedSimState):
        return _SWIM_FULL
    return frozenset()


def _leaf_ptr(leaf: str, side: str = "in") -> str:
    """The pointer that carries ``leaf`` (a MIRRORS source) in one tick."""
    sw, ss = layout_mod.PackedSimState._fields, serf.SerfState._fields
    if leaf.startswith("viv."):
        k = len(sw) - 1 + layout_mod.PackedVivaldi._fields.index(leaf[4:])
        return f"{side}_{k}"
    if leaf in sw:
        return f"{side}_{sw.index(leaf)}"
    if leaf in ss:
        return f"s{side}_{ss.index(leaf) - 1}"
    return leaf


_PTRS += list(MIRRORS) + ["t_acks", "t_resps"]
# On one device each mirror is its source and D's tally lands in the
# output's q_acks / q_resps: the column each of those pointers repeats.
_ALIASES = tuple(_PTRS.index(_leaf_ptr(leaf)) for leaf in MIRRORS.values()) + (
    _PTRS.index(_leaf_ptr("q_acks", "out")), _PTRS.index(_leaf_ptr("q_resps", "out")))
_SOURCE = dict(zip(range(len(_PTRS) - len(_ALIASES), len(_PTRS)), _ALIASES))
_INTS = ("n", "k", "s", "d", "w", "wd", "ic", "fan", "p", "tx_limit",
         "susp_k", "pp_period", "own_limit", "probe_period", "awareness_max",
         "serf", "e", "r", "o", "q", "pe", "rf", "orig16", "exact_sig",
         "chaos", "sentinel", "np", "nl", "nc", "nd", "dense", "row0", "rows",
         "slo_defer", "sref", "mw")
# Pointers to a shard's own [rows, ...] tensors, passed as row origins
# (gossip_tick.cu, the sharded call): every leaf of the state but t, the
# per-row draws, the per-row scratch and the schedule's node masks.
_ROW_PTRS = frozenset(
    [f"in_{k}" for k in range(1, _LEAVES)] + [f"out_{k}" for k in range(1, _LEAVES)]
    + ["jitter", "u2", "u_a", "u_b", "u_c", "perm_u", "viv_fb", "grav_fb",
       "u_drop", "view_mid", "pay_flags", "pay_scol", "pay_skey", "pay_sbits",
       "pay_ownk", "poke", "refute"]
    + [f"sin_{k}" for k in range(_SERF_LEAVES)]
    + [f"sout_{k}" for k in range(_SERF_LEAVES)]
    + ["u_resp", "relay_u1", "relay_u2", "x_flags", "x_key", "x_orig",
       "ev_u_drop", "masks", "u_pp", "c_word", "c_rec"])
assert _ROW_PTRS <= set(_PTRS)
_ROW_COLS = tuple(sorted(_PTRS.index(p) for p in _ROW_PTRS))
# The mirrors each launch needs filled before it runs under a mesh (with a
# schedule, chaos_pre's word and record take the place of the input's
# flags and incarnation; u_pp is the tick's draw, whole on every device).
EXCHANGES = {
    "probe_send": ("m_flags", "m_inc", "m_vec", "m_vh", "m_verr", "m_vadj"),
    "probe_send_chaos": ("m_cword", "m_crec", "m_vec", "m_vh", "m_verr",
                         "m_vadj"),
    "receive": ("m_pflags", "m_pscol", "m_pskey", "m_psbits", "m_pownk",
                "m_poke"),
    "pushpull": ("m_vmid",),
    "serf_post": ("m_xflags", "m_xkey", "m_xorig", "m_qopen", "m_leave"),
}
_FLTS = ("susp_min", "susp_max", "susp_diff", "packet_loss", "timeout_s",
         "jitter_frac", "ce", "cc", "err_max", "height_min", "gravity_rho",
         "keep")


class _TickArgs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * len(_PTRS)),
                ("i", ctypes.c_int32 * len(_INTS)),
                ("f", ctypes.c_float * len(_FLTS))]


# MetricsArgs tables of launch M, in the order of MPtr / MInt; its grid
# scratch holds _MACC words (MAcc) and two per block of 256 sampled pairs.
_MPTRS = ("meta", "flags", "off", "vec", "height", "adjustment", "pos",
          "world_height", "i", "j", "acc", "out")
_MINTS = ("n", "k", "d", "wd", "samples", "vec")
_MACC = 5


class _MetricsArgs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * len(_MPTRS)),
                ("i", ctypes.c_int32 * len(_MINTS))]


# LensArgs of launch L, in the order of LPtr / LInt; LWARPS sampled rows
# a block.
_LPTRS = ("flags", "own_inc", "own_tx", "pending_col", "pending_fail_delta",
          "viv.error", "meta", "susp_delta", "clock", "ids", "out")
_LINTS = ("n", "k", "s", "stride")
_LWARPS = 4


class _LensArgs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * len(_LPTRS)),
                ("i", ctypes.c_int32 * len(_LINTS))]


def canonical_kernel(kernel: str) -> str:
    """``kernel`` with the reference's names mapped to the port's
    (``"pallas"`` -> ``"cuda"``, ``"xla"`` -> ``"torch"``)."""
    return KERNEL_ALIASES.get(kernel, kernel)


def validate_kernel(kernel: str, layout: str, device=None) -> None:
    """Reject invalid engine selections up front: the CUDA kernel is
    packed-native and runs only on a CUDA device."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")
    if kernel == CUDA and layout != layout_mod.PACKED:
        raise ValueError("kernel='cuda' is packed-native; run it with "
                         "layout='packed'")
    if kernel == CUDA and device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"kernel='cuda' needs a CUDA device, got {device!r}; "
                         "pass kernel='torch' to run the plain version")


def tick_hbm_bytes_per_node(state, world=None, sched=None) -> float:
    """The tick's memory-traffic contract in bytes/tick/node: one read of
    the packed state, the world and the fault schedule (every leaf, the
    raft lane too), one write of the state (the counterpart of
    pallas_gossip.tick_hbm_bytes_per_node). The draw bundle is not in it:
    the reference kernel draws its random numbers in-kernel from one key,
    so reading them from memory is a cost of this port's design."""
    trees = [state, state] + [x for x in (world, sched) if x is not None]
    leaves = [x for tr in trees for x in layout_mod.leaves(tr)]
    n = max(int(x.shape[0]) for x in leaves if x.dim() >= 1)
    return sum(layout_mod.np_size_bytes(x) for x in leaves) / float(n)


def sweep_payload_bytes_per_node(cfg: SimConfig) -> float:
    """The pre-fusion tick's (B8's) bytes per node beyond the state
    contract: the event sweep's payload (flags, peel keys and origins)
    that E1 writes and E2 reads back across the grid-wide barrier
    between them."""
    return 2.0 * (2 + 8 * cfg.serf.piggyback_events)


# The tick's launch stages (every launch but M and L).
STAGES = tuple(k for k in LAUNCHES if k not in ("metrics", "lens"))
# Bytes a row of chaos_pre's output: the word (flags, colour) and the
# record (incarnation and side bits, qtx, qrx); gossip_tick.cu, above
# k_chaos_pre, has the layout.
_CHAOS_ROW = 4 + 16


def mask_words(sched) -> int:
    """u32 words a row of a schedule's packed node masks: one bit an
    entry of every family in MASK_FIELDS, at least one word."""
    bits = sum(getattr(sched, f).shape[1] for f in MASK_FIELDS)
    return max(1, -(-bits // 32))


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as int32 tensors of the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_masks(sched) -> torch.Tensor:
    """A schedule's node masks as launch P reads them: [N, W] int32 (u32
    bit patterns, W = :func:`mask_words`), row i's bit e the e-th column
    of the MASK_FIELDS masks of row i concatenated (partition sides, link
    A sides, link B sides, churn, degrade), bit e in word e // 32 at bit
    e % 32. On the masks' device."""
    cols = torch.cat([getattr(sched, f) for f in MASK_FIELDS], dim=1)
    words = torch.zeros((cols.shape[0], mask_words(sched)), dtype=torch.int64,
                        device=cols.device)
    for e in range(cols.shape[1]):
        words[:, e // 32] |= cols[:, e].to(torch.int64) << (e % 32)
    return _as_i32(words)


class _MaskCache:
    """The packed node masks (:func:`pack_masks`) of the schedules the
    kernel runs under, packed once per installed schedule: keyed by each
    mask's address, shape, strides and version counter, so a shifted
    schedule (``chaos.shift_schedule`` keeps the masks) or a sweep's lane
    reuses its words and an edited mask is packed again. An entry holds
    its masks, so no other tensor takes their addresses while it lives;
    the SIZE most recently used stay (a sweep's lanes, each group's rows
    of a placed schedule)."""

    SIZE = 64

    def __init__(self):
        self.packs = 0
        self._entries = {}
        self._lock = threading.Lock()

    def get(self, sched) -> torch.Tensor:
        masks = tuple(getattr(sched, f) for f in MASK_FIELDS)
        key = tuple((x.device, x.data_ptr(), tuple(x.shape), x.stride(),
                     x._version) for x in masks)
        with self._lock:
            hit = self._entries.pop(key, None)
            if hit is None:
                hit = (masks, pack_masks(sched))
                self.packs += 1
            self._entries[key] = hit
            while len(self._entries) > self.SIZE:
                self._entries.pop(next(iter(self._entries)))
            return hit[1]


MASK_CACHE = _MaskCache()


def launch_hbm_bytes_per_node(stage: str, state, world, draws, sched=None, *,
                              cfg: SimConfig, out) -> float:
    """The least memory traffic of one launch in bytes/tick/node: each
    leaf, scratch buffer and draw the launch must read counted once, each
    it must write counted once, from the shapes of one tick's tensors.

    A row read again at a displacement (a probe target, a partner's view
    row) is counted once, as a part of its leaf. Where what a launch reads
    depends on the data, only what this tick's data needs is counted: the
    probe draws (jitter, round trips, relay legs, Vivaldi's random
    directions) by the rows whose probe is due, and ``perm_u`` by the rows
    whose cursor wraps (read from ``out``, the tick's output state).
    Writes and cells that only the run decides (B's merges into view_mid,
    a refuting row's own budget, D's tally) are left out, so the count is
    a floor. ``stage`` is a key of :data:`LAUNCHES`; ``cfg`` gives the
    piggyback widths, which no tensor of the tick carries. The sharded
    call's exchanges are counted apart (:func:`exchange_bytes_per_node`)."""
    if stage not in STAGES:
        raise ValueError(f"unknown launch {stage!r}; expected one of {STAGES}")
    serf_plane = isinstance(state, serf.SerfState)
    # The pre-fusion serf tick (B8) takes the oracle's draws.
    reference = isinstance(draws, serf.ReferenceSerfDraws)
    sw, sd = (state.swim, draws.swim) if serf_plane else (state, draws)
    sched = chaos_mod.or_none(sched)
    chaos = sched is not None
    n, k = sw.meta.shape
    s, d, wd = sw.lat_buf.shape[2], sw.viv.vec.shape[1], world.pos.shape[1]
    ic, fan = sd.u_a.shape[1], sd.u_drop.shape[1]
    p = cfg.gossip.piggyback_msgs
    b = layout_mod.np_size_bytes

    def row_bytes(x):
        return b(x) / float(n)

    # A row's own scalars as every launch reads them: the input's flags and
    # incarnation, or under a schedule chaos_pre's word (post-churn flags,
    # colour) and record (incarnation, side bits, two survival products).
    own = _CHAOS_ROW if chaos else 1 + 2
    view_in = sum(row_bytes(x) for x in (sw.view_inc, sw.meta, sw.susp_delta,
                                         sw.susp_seen))
    u16, u32 = 2 * k, 4 * k     # one [K] row of uint16 / uint32
    if stage == "chaos_pre":
        if not chaos:
            return 0.0
        # The input's flags and incarnation, the packed node masks and the
        # per-entry leaves read; the word and the record written.
        scalars = sum(row_bytes(getattr(sched, f)) for f in _SCHED_SCALARS)
        return 1 + 2 + 4 * mask_words(sched) + scalars + _CHAOS_ROW

    if stage == "probe_send":
        flags = sw.flags
        active = (flags & 1).bool() & ~(flags & 2).bool() & ~(flags & 8).bool()
        due = active & (sw.next_probe_delta <= 0)
        osw = out.swim if serf_plane else out
        wraps = (osw.probe_ptr == 0) & (sw.probe_ptr > 0)
        f_due, f_wrap = float(due.float().mean()), float(wraps.float().mean())
        scalars = 1 + 1 + 1 + 2 + 1 + 2 + 1       # own_tx .. nack
        viv = sum(row_bytes(x) for x in sw.viv)
        rd = (own + scalars + view_in + row_bytes(sw.lat_cnt)
              + row_bytes(sw.lat_buf) + viv + 4 * wd + 4
              + f_due * (4 + 8 + 3 * 4 * ic + 2 * 4 * d) + f_wrap * 4 * k
              + (8 * ic + 8 * fan + 4 * k) / n)   # relay/gossip cols, offsets
        wr = (u32 + u32 + u16 + u16 + k * s + viv + 1 + scalars
              + 2 + p + 4 * p + 4 * p + 4 + 4)    # payload, own key, poke
        if serf_plane:
            q = state.q_acks.shape[1]
            pe = cfg.serf.piggyback_events
            # The query tallies copied to the output; in the fused tick
            # also the pre-tick peel of the queue and its payload.
            rd += 8 * q
            wr += 8 * q
            if not reference:
                rd += (row_bytes(state.ev_key) + row_bytes(state.ev_origin)
                       + row_bytes(state.ev_tx))
                wr += 2 + 4 * pe + 4 * pe
        return rd + wr

    if stage == "receive":
        rd = (own + 2 + p + 4 * p + 4 * p + 4 + 4 + 4 * fan
              + (4 * fan * k + 8 * fan) / n)       # rcol rows, inv, off
        return rd + 4                              # + refute

    if stage == "pushpull":
        # Own flags and refute claim; view_mid, whose partner and initiator
        # rows are rows of the same array; the input view; A's and B's
        # o_sseen and o_meta; the two rcol rows of this tick's column.
        rd = (own + 4 + u32 + view_in + u32 + u16 + (4 if chaos else 0)
              + (8 * k + 8) / n)
        return rd + 3 * u16 + u32 + 2             # view out, own_inc

    pe = cfg.serf.piggyback_events
    queue = ("ev_key", "ev_origin", "ev_tx", "ev_pending")
    buckets = ("ev_bkt_lt", "ev_bkt_sig", "q_bkt_lt", "q_bkt_sig", "ev_floor",
               "q_floor")
    if stage in ("ref_send", "ref_intake"):
        if not reference:
            return 0.0
        rf = draws.relay_u1.shape[1]
        if stage == "ref_send":
            # E1: the queue, the dedup buckets and floors, the clocks, the
            # delivered count, the responder bit and the leave tick read
            # and written; the row's flags (and terms), the post-SWIM
            # status of the sweep's fan columns and the tally draws read;
            # the flags and the payload (flags, peel keys and origins)
            # written.
            rw = sum(row_bytes(getattr(state, f)) for f in queue + buckets + (
                "clock", "event_clock", "query_clock", "ev_delivered",
                "q_responder", "leave_at"))
            rd = (rw + (_CHAOS_ROW if chaos else 1) + 2 * fan + 4 + 8 * rf
                  + (8 * fan + 8 * rf) / n)
            return rd + rw + 1 + 2 + 4 * pe + 4 * pe
        # E2: the queue read and written; E1's buckets and floors, the
        # senders' payloads, the row's flags (and terms), leave tick and
        # loss draws read; the open queries and deadlines and down_since
        # (with C's final meta row) read and written.
        rw = sum(row_bytes(getattr(state, f)) for f in queue + (
            "q_open_key", "q_deadline", "down_since"))
        rd = (rw + sum(row_bytes(getattr(state, f)) for f in buckets)
              + (_CHAOS_ROW if chaos else 1) + 4 + 2 + 4 * pe + 4 * pe + 4 * fan
              + u16 + 8 * fan / n)
        return rd + rw

    # serf_post: the serf leaves it reads and rewrites, the row's flags
    # (and terms), the senders' payloads, the intake and tally draws, and
    # C's final meta row.
    if not serf_plane or reference:
        return 0.0
    keep = ("leave_at", "ev_key", "ev_origin", "ev_tx", "ev_pending",
            "ev_bkt_lt", "ev_bkt_sig", "q_bkt_lt", "q_bkt_sig", "ev_floor",
            "q_floor", "clock", "event_clock", "query_clock", "ev_delivered",
            "q_responder", "q_open_key", "q_deadline", "down_since")
    rw = sum(row_bytes(getattr(state, f)) for f in keep)
    rf = draws.relay_u1.shape[1]
    rd = (rw + (_CHAOS_ROW if chaos else 1) + 2 + 4 * pe + 4 * pe + 4 * fan + 4
          + 8 * rf + u16 + 8 * rf / n)
    return rd + rw + 1


class BuildInfo(NamedTuple):
    path: str
    seconds: float
    log: str
    compiled: bool  # False when the library of this source was already built


_LIB = None
_LIB_INFO: Optional[BuildInfo] = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA tick kernel is built on "
                           "a machine with the CUDA toolkit")
    return found


def build() -> BuildInfo:
    """Compile gossip_tick.cu for sm_90a (once per source version) and load
    it. Returns where it went, how long the compile took, what ``ptxas -v``
    said and whether this call compiled. A real compile is recorded as a
    ``cat="cuda"`` ``cuda.build`` span on the process tracer; a load of an
    earlier build records nothing."""
    global _LIB, _LIB_INFO
    with _LIB_LOCK:
        if _LIB_INFO is not None:
            return _LIB_INFO
        src = open(SOURCE, "rb").read()
        tag = hashlib.sha256(src).hexdigest()[:12]
        build_dir = compile_cache.build_dir()
        out = os.path.join(build_dir, f"libgossip_tick_{tag}.so")
        t0 = time.perf_counter()
        log = ""
        compiled = not os.path.exists(out)
        if compiled:
            tracer = obs_trace.get_tracer()
            start_us = tracer.now_us()
            nvcc = _nvcc()
            os.makedirs(build_dir, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                   "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, out)
            tracer.complete("cuda.build", start_us, tracer.now_us() - start_us,
                            cat="cuda", args={"library": os.path.basename(out)})
        compile_cache.record(hit=not compiled)
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        for name in ("gossip_chaos_pre", "gossip_probe_send", "gossip_receive",
                     "gossip_pushpull", "gossip_serf_post", "gossip_ref_send",
                     "gossip_ref_intake"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_TickArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gossip_slo_fold.argtypes = [ctypes.POINTER(_TickArgs),
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.gossip_slo_fold.restype = ctypes.c_int
        lib.gossip_metrics.argtypes = [ctypes.POINTER(_MetricsArgs),
                                       ctypes.c_void_p]
        lib.gossip_metrics.restype = ctypes.c_int
        lib.gossip_lens.argtypes = [ctypes.POINTER(_LensArgs), ctypes.c_void_p]
        lib.gossip_lens.restype = ctypes.c_int
        for fn, want in (
                (lib.gossip_layout, (len(_PTRS), len(_INTS), len(_FLTS),
                                     ctypes.sizeof(_TickArgs))),
                (lib.gossip_metrics_layout, (len(_MPTRS), len(_MINTS), _MACC,
                                             ctypes.sizeof(_MetricsArgs))),
                (lib.gossip_lens_layout, (len(_LPTRS), len(_LINTS), _LWARPS,
                                          ctypes.sizeof(_LensArgs)))):
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            lay = (ctypes.c_int * 4)()
            fn(lay)
            if tuple(lay) != want:
                raise RuntimeError(f"{fn.__name__} mismatch: library "
                                   f"{tuple(lay)}, wrapper {want}")
        _LIB = lib
        _LIB_INFO = BuildInfo(out, seconds, log, compiled)
        return _LIB_INFO


def plain_tick(cfg: SimConfig, topo: Topology, world, packed, draws,
               sched=None, sentinel: bool = False):
    """The plain PyTorch version of the kernel's function:
    ``unpack -> swim.step_counted(sched, sentinel) -> pack`` and the
    stacked [26] int32 counters."""
    state, cnt = swim.step_counted(cfg, topo, world,
                                   layout_mod.unpack(packed), draws,
                                   sched=sched, sentinel=sentinel)
    return layout_mod.pack(state), counters_mod.stack(cnt)


def plain_serf_tick(cfg: SimConfig, topo: Topology, world, packed, draws,
                    sched=None, sentinel: bool = False):
    """The plain PyTorch version of the serf variant:
    ``unpack_state -> serf.step_counted(sched, sentinel) -> pack_state``
    and the stacked [26] int32 counters."""
    state, cnt = serf.step_counted(cfg, topo, world,
                                   layout_mod.unpack_state(packed), draws,
                                   sched=sched, sentinel=sentinel)
    return layout_mod.pack_state(state), counters_mod.stack(cnt)


def plain_reference_serf_tick(cfg: SimConfig, topo: Topology, world, packed,
                              draws, sched=None, sentinel: bool = False):
    """The plain PyTorch version of the pre-fusion serf variant (B8):
    ``unpack_state -> serf.step_reference_counted(sched, sentinel) ->
    pack_state`` and the stacked [26] int32 counters."""
    state, cnt = serf.step_reference_counted(
        cfg, topo, world, layout_mod.unpack_state(packed), draws,
        sched=sched, sentinel=sentinel)
    return layout_mod.pack_state(state), counters_mod.stack(cnt)


def plain_chaos_pre(state, sched, t):
    """The plain PyTorch version of launch P alone: ``(word, record)``,
    [N] and [N, 4] int32 holding the kernel's u32 bits (the layout is in
    gossip_tick.cu, above k_chaos_pre), for a packed state (or a SerfState
    with a packed SWIM plane) at tick ``t`` under ``sched``: the churn
    edges of ``chaos.down_at`` at t - 1 and t (a kill on a falling edge; a
    warm revive on a rising one: alive, not left or leaving, the REVIVED
    mark, incarnation + 1) and ``chaos.node_terms`` at t. For the tests
    and the card's check of P; the tick's plain versions take the
    schedule whole."""
    sw = state.swim if isinstance(state, serf.SerfState) else state
    i64 = torch.int64
    terms = chaos_mod.node_terms(sched, t)
    down_now, down_prev = chaos_mod.down_at(sched, t), chaos_mod.down_at(sched, t - 1)
    fl, inc = sw.flags.to(i64), sw.own_inc.to(i64)
    kill, revive = down_now & ~down_prev, down_prev & ~down_now
    fl = torch.where(kill, fl & ~1, fl)
    fl = torch.where(revive, ((fl | 1) & ~6) | 0x80, fl)
    inc = torch.where(revive, inc + 1, inc)
    word = fl | (terms.color.to(i64) << 8)
    lo = inc | (terms.a_bits.to(i64) << 17) | (terms.b_bits.to(i64) << 37)
    rec = torch.stack([lo & 0xFFFFFFFF, lo >> 32,
                       chaos_mod._f32_bits(terms.q_tx),
                       chaos_mod._f32_bits(terms.q_rx)], dim=1)
    return _as_i32(word), _as_i32(rec)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


class TickKernel:
    """The CUDA tick for one (config, topology): ``tick(world, packed,
    draws, sched=None) -> (packed, counters[26] int32)``, all on one CUDA
    device. ``sched`` is a fault schedule (None or empty: none), whose
    ticks need ``draws.u_pp``; ``sentinel=True`` adds the invariant
    tallies. With ``serf_plane=True`` (``variant="serf"``) it is the serf
    variant: ``packed`` is a ``SerfState`` whose SWIM plane is packed and
    ``draws`` a ``serf.SerfDraws`` (``draw_serf_tick(..., chaos=True)``
    under a schedule). ``variant="serf_reference"`` is the pre-fusion serf
    tick (B8, ``serf.step_reference_counted``) over the same state, whose
    draws are a ``serf.ReferenceSerfDraws``. The view is sparse or dense,
    K <= 255 either way."""

    def __init__(self, cfg: SimConfig, topo: Topology, serf_plane: bool = False,
                 sentinel: bool = False, variant: Optional[str] = None):
        if variant is None:
            variant = SERF if serf_plane else SWIM
        if variant not in VARIANTS:
            raise ValueError(f"unknown tick variant {variant!r}; expected one "
                             f"of {VARIANTS}")
        serf_plane = variant != SWIM
        g = cfg.gossip
        if cfg.degree > 255:
            raise ValueError("the CUDA tick kernel covers views of K <= 255 "
                             f"columns, got K = {cfg.degree}; larger views "
                             "run with kernel='torch' and the dense layout")
        layout_mod.validate(cfg, layout_mod.PACKED)
        v = cfg.vivaldi
        limits = [(v.dimensionality, _MAXD, "vivaldi dimensionality"),
                  (v.adjustment_window_size, _MAXW, "adjustment window"),
                  (v.latency_filter_size, _MAXS, "latency filter"),
                  (g.gossip_nodes, _MAXFAN, "gossip_nodes"),
                  (g.piggyback_msgs, _MAXP, "piggyback_msgs"),
                  (g.indirect_checks, 8, "indirect_checks"),
                  (cfg.world_dims, 8, "world_dims")]
        sf = cfg.serf
        if serf_plane:
            limits += [(sf.event_queue_slots, _MAXE, "event_queue_slots"),
                       (sf.piggyback_events, min(_MAXPE, sf.event_queue_slots),
                        "piggyback_events"),
                       (g.gossip_nodes * sf.piggyback_events, _MAXC,
                        "gossip_nodes * piggyback_events")]
            nc = g.gossip_nodes * sf.piggyback_events
            if _SERF_WARP_WORDS - 64 * nc < _serf_row_words(
                    sf.event_queue_slots, sf.seen_ring, sf.seen_width):
                raise ValueError(
                    "the serf variant stages a row's queue and dedup buckets "
                    f"in {_SERF_WARP_WORDS * 4} B per warp; event_queue_slots "
                    f"{sf.event_queue_slots}, seen_ring {sf.seen_ring} and "
                    f"seen_width {sf.seen_width} do not fit")
            if not 0 <= sf.query_relay_factor <= MAX_RELAY_FACTOR:
                raise ValueError("the serf variant takes query_relay_factor "
                                 f"in [0, {MAX_RELAY_FACTOR}], got "
                                 f"{sf.query_relay_factor}")
        for val, hi, what in limits:
            if not 1 <= val <= hi:
                raise ValueError(f"the CUDA tick kernel takes {what} in "
                                 f"[1, {hi}], got {val}")
        self.cfg, self.topo, self.serf = cfg, topo, serf_plane
        self.variant = variant
        self.reference = variant == SERF_REFERENCE
        self.sentinel = sentinel
        # This instance's launches (every stage), beside LAUNCHES: the
        # federation reads its LAN and WAN pools' apart.
        self.launches = 0
        sc = swim.protocol_scalars(cfg, topo)
        self._ints = (cfg.n, cfg.degree, v.latency_filter_size,
                      v.dimensionality, v.adjustment_window_size,
                      cfg.world_dims, g.indirect_checks, g.gossip_nodes,
                      g.piggyback_msgs, sc.tx_limit, sc.susp_k, sc.pp_period,
                      sc.own_limit, g.probe_period_ticks, g.awareness_max,
                      int(serf_plane), sf.event_queue_slots, sf.seen_ring,
                      sf.seen_width, sf.query_slots, sf.piggyback_events,
                      sf.query_relay_factor,
                      int(serf.origin_dtype(cfg.n) == torch.int16),
                      int(cfg.n <= serf._EXACT_SIG_MAX_N))
        # 1 - packet_loss rounded once from double, as the reference's
        # (1.0 - base_loss) * q takes it (chaos.pair_ok).
        self._flts = (sc.susp_min, sc.susp_max, sc.susp_max - sc.susp_min,
                      cfg.packet_loss, g.probe_timeout_ms / 1000.0,
                      cfg.rtt_jitter_frac, v.vivaldi_ce, v.vivaldi_cc,
                      v.vivaldi_error_max, v.height_min, v.gravity_rho,
                      1.0 - cfg.packet_loss)
        self._tables = {}

    def _topo_tables(self, device):
        """``off``, ``rcol`` (flat [K*K]) and ``inv`` as int32 on
        ``device``; the dense view's from the closed forms
        (topology.remap_row / inv_col)."""
        if device not in self._tables:
            topo = self.topo
            if topo.dense:
                cols = range(topo.degree)
                rcol = torch.stack([topology.remap_row(topo, j) for j in cols])
                inv = torch.tensor([topology.inv_col(topo, j) for j in cols])
            else:
                rcol, inv = topo.rcol, topo.inv
            self._tables[device] = tuple(
                x.to(device=device, dtype=torch.int32).contiguous()
                for x in (topo.off, rcol.reshape(-1), inv))
        return self._tables[device]

    def _relay_factor(self, sched) -> int:
        """The relayed responses the serf variant runs this tick: the
        configured factor under a schedule or with loss, else none."""
        if not serf.relay_draws_used(self.cfg, sched is not None):
            return 0
        return self.cfg.serf.query_relay_factor

    def _check_schedule(self, sched, draws, device, n):
        """Every leaf the kernel reads, by its name's suffix: slot ticks
        int32 [m], loss rates float32 [m], node masks bool [n, m] (``n``
        the launch's rows)."""
        for fam, most in (("part", chaos_mod.MAX_PARTITIONS),
                          ("ll", chaos_mod.MAX_LINKS)):
            m = getattr(sched, fam + "_start").shape[0]
            # Partition colours and link sides are 20-bit fields of chaos_pre's
            # word and record.
            if m > most:
                raise ValueError(f"the CUDA tick kernel takes at most "
                                 f"{most} {fam} slots, got {m}")
        if mask_words(sched) > MAX_MASK_WORDS:
            raise ValueError(f"the CUDA tick kernel takes at most "
                             f"{32 * MAX_MASK_WORDS} schedule entries in all, "
                             f"got {32 * mask_words(sched)}")
        for name in _SCHED_LEAVES:
            fam, leaf = name.split("_", 1)
            m = getattr(sched, fam + "_start").shape[0]
            if leaf in ("side", "a", "b", "mask"):
                dt, shape = torch.bool, (n, m)
            elif leaf in ("fwd", "rev", "tx", "rx"):
                dt, shape = torch.float32, (m,)
            else:
                dt, shape = torch.int32, (m,)
            _check(getattr(sched, name), "sched." + name, dt, shape, device)
        # A tick with a schedule needs swim.draw_tick(..., chaos=True).
        _check(draws.u_pp, "draws.u_pp", torch.float32, (n,), device)

    def _check_inputs(self, world, packed, draws, device, sched=None,
                      rows=None):
        """Every input's dtype, shape, device and layout; ``rows`` is the
        launch's row count (the shard's block; default every row). The
        world is whole."""
        cfg = self.cfg
        n, k = (cfg.n if rows is None else rows), cfg.degree
        g, v = cfg.gossip, cfg.vivaldi
        s, d, w = v.latency_filter_size, v.dimensionality, v.adjustment_window_size
        u8, u16, i16 = torch.uint8, torch.uint16, torch.int16
        f8, bf = torch.float8_e4m3fn, torch.bfloat16
        f32, i64 = torch.float32, torch.int64
        if self.serf:
            if not isinstance(packed, serf.SerfState):
                raise TypeError("the serf variant takes a SerfState")
            want = serf.ReferenceSerfDraws if self.reference else serf.SerfDraws
            if not isinstance(draws, want):
                raise TypeError(f"the {self.variant} variant takes "
                                f"serf.{want.__name__}, got "
                                f"{type(draws).__name__}")
            sf = cfg.serf
            dts = serf.rest_dtypes(cfg)
            e, r, o, q = (sf.event_queue_slots, sf.seen_ring, sf.seen_width,
                          sf.query_slots)
            shapes = dict(clock=(n,), event_clock=(n,), query_clock=(n,),
                          ev_key=(n, e), ev_origin=(n, e), ev_tx=(n, e),
                          ev_pending=(n, e), ev_bkt_lt=(n, r),
                          ev_bkt_sig=(n, r, o), q_bkt_lt=(n, r),
                          q_bkt_sig=(n, r, o), ev_delivered=(n,),
                          ev_floor=(n,), q_floor=(n,), q_open_key=(n, q),
                          q_deadline=(n, q), q_resps=(n, q), q_acks=(n, q),
                          q_responder=(n,), leave_at=(n,), down_since=(n, k))
            for name in serf.SerfState._fields[1:]:
                _check(getattr(packed, name), name, dts[name], shapes[name], device)
            rf = self._relay_factor(sched)
            for name, dt, shape in (("u_resp", f32, (n,)),
                                    ("relay_u1", f32, (n, rf)),
                                    ("relay_u2", f32, (n, rf)),
                                    ("relay_cols", i64, (rf,))):
                _check(getattr(draws, name), "draws." + name, dt, shape, device)
            if self.reference:
                fan = g.gossip_nodes
                _check(draws.ev_cols, "draws.ev_cols", i64, (fan,), device)
                _check(draws.ev_u_drop, "draws.ev_u_drop", f32, (n, fan), device)
            packed, draws = packed.swim, draws.swim
        spec = (
            ("t", torch.int32, ()), ("flags", u8, (n,)), ("own_inc", u16, (n,)),
            ("own_tx", u8, (n,)), ("awareness", u8, (n,)),
            ("probe_ptr", u8, (n,)), ("next_probe_delta", i16, (n,)),
            ("pending_col", u8, (n,)), ("pending_fail_delta", i16, (n,)),
            ("pending_nack_miss", u8, (n,)), ("view_inc", u16, (n, k)),
            ("meta", u16, (n, k)), ("susp_delta", u16, (n, k)),
            ("susp_seen", torch.uint32, (n, k)), ("lat_cnt", u16, (n, k)),
            ("lat_buf", f8, (n, k, s)))
        for name, dt, shape in spec:
            _check(getattr(packed, name), name, dt, shape, device)
        vspec = (("vec", bf, (n, d)), ("height", bf, (n,)), ("error", bf, (n,)),
                 ("adjustment", bf, (n,)), ("adj_samples", f8, (n, w)),
                 ("adj_idx", u8, (n,)), ("resets", u8, (n,)))
        for name, dt, shape in vspec:
            _check(getattr(packed.viv, name), "viv." + name, dt, shape, device)
        _check(world.pos, "world.pos", f32, (cfg.n, cfg.world_dims), device)
        _check(world.height, "world.height", f32, (cfg.n,), device)
        ic, fan = g.indirect_checks, g.gossip_nodes
        dspec = (("jitter", f32, (n,)), ("u2", f32, (n, 2)),
                 ("relay_jcols", i64, (ic,)), ("u_a", f32, (n, ic)),
                 ("u_b", f32, (n, ic)), ("u_c", f32, (n, ic)),
                 ("perm_u", f32, (n, k)), ("viv_fb", f32, (n, d)),
                 ("grav_fb", f32, (n, d)), ("u_drop", f32, (n, fan)),
                 ("pp_j", i64, ()), ("gossip_jcols", i64, (fan,)))
        for name, dt, shape in dspec:
            _check(getattr(draws, name), "draws." + name, dt, shape, device)
        if sched is not None:
            self._check_schedule(sched, draws, device, n)

    def _buffers(self, world, packed, draws, device, sched=None, rows=None,
                 row0=None):
        """The output state, the scratch buffers and the flat operand list
        (in TickArgs order, None for a null pointer) of one tick over
        ``rows`` rows (default every row); the mirrors and tally targets
        are the tick's own leaves (one device), which a sharded call
        replaces. With ``row0`` (a device group of a mesh of several) the
        mirrored output leaves and scratch buffers are the rows [row0,
        row0 + rows) of new full-height buffers."""
        cfg = self.cfg
        n, k, p = (cfg.n if rows is None else rows), cfg.degree, cfg.gossip.piggyback_msgs

        def tall(shape, dtype):
            """A mirrored buffer: rows [row0, row0 + rows) of a full-height
            one under ``row0``."""
            if row0 is None:
                return torch.empty(shape, dtype=dtype, device=device)
            return torch.empty((cfg.n,) + tuple(shape[1:]), dtype=dtype,
                               device=device)[row0:row0 + shape[0]]

        def out_of(xs, fields, mirrored):
            """New leaves like ``xs``; the ``mirrored`` ones tall."""
            if row0 is None:
                return [torch.empty_like(x) for x in xs]
            return [tall(x.shape, x.dtype) if f in mirrored
                    else torch.empty_like(x) for f, x in zip(fields, xs)]

        sw_in, sw_draws = ((packed.swim, draws.swim) if self.serf
                           else (packed, draws))
        sw_out = layout_mod.PackedSimState(
            *out_of(sw_in[:-1], layout_mod.PackedSimState._fields, _SWIM_FULL),
            layout_mod.PackedVivaldi(*out_of(
                sw_in.viv, ["viv." + f for f in layout_mod.PackedVivaldi._fields],
                _SWIM_FULL)))
        u32 = torch.uint32
        scratch = dict(
            view_mid=tall((n, k), u32),
            pay_flags=tall((n,), torch.uint16),
            pay_scol=tall((n, p), torch.uint8),
            pay_skey=tall((n, p), u32),
            pay_sbits=tall((n, p), u32),
            pay_ownk=tall((n,), u32),
            poke=tall((n,), u32),
            refute=torch.empty((n,), dtype=u32, device=device),
            counters=torch.zeros((len(counters_mod.FIELDS),), dtype=torch.int32,
                                 device=device),
        )
        off, rcol, inv = self._topo_tables(device)
        tensors = (layout_mod.leaves(sw_in) + layout_mod.leaves(sw_out)
                   + [world.pos, world.height, sw_draws.jitter, sw_draws.u2,
                      sw_draws.relay_jcols, sw_draws.u_a, sw_draws.u_b,
                      sw_draws.u_c, sw_draws.perm_u, sw_draws.viv_fb,
                      sw_draws.grav_fb, sw_draws.u_drop, sw_draws.pp_j,
                      sw_draws.gossip_jcols, off, rcol, inv]
                   + list(scratch.values()))
        if not self.serf:
            out = sw_out
            tensors += [None] * (2 * _SERF_LEAVES + 9)
        else:
            pe = cfg.serf.piggyback_events
            s_in = list(packed[1:])
            out = serf.SerfState(sw_out, *out_of(
                packed[1:], serf.SerfState._fields[1:], _SERF_FULL))
            xs = dict(
                x_flags=tall((n,), torch.uint16),
                x_key=tall((n, pe), u32),
                x_orig=tall((n, pe), torch.int32))
            scratch.update(xs)
            tensors += (s_in + list(out[1:])
                        + [draws.u_resp, draws.relay_u1, draws.relay_u2,
                           draws.relay_cols] + list(xs.values())
                        + ([draws.ev_cols, draws.ev_u_drop] if self.reference
                           else [None, None]))
        if sched is None:
            tensors += [None] * (len(_SCHED_SCALARS) + 5)
        else:
            i32 = torch.int32
            # chaos_pre's word and 16-byte record a row, u32 bit patterns.
            cs = dict(
                c_word=tall((n,), i32),
                c_rec=tall((n, 4), i32),
                slo=torch.zeros((2,), dtype=i32, device=device))
            scratch.update(cs)
            tensors += ([getattr(sched, f) for f in _SCHED_SCALARS]
                        + [MASK_CACHE.get(sched), sw_draws.u_pp]
                        + list(cs.values()))
        tensors += [tensors[c] for c in _ALIASES]
        assert len(tensors) == len(_PTRS)
        return out, scratch, tensors

    def _args(self, tensors, sched, row0: int = 0, rows=None,
              slo_defer: bool = False) -> _TickArgs:
        """The TickArgs of one launch set: pointers (the row leaves as row
        origins, ``row0`` rows back), ints and floats."""
        args = _TickArgs()
        ptrs = [None if x is None else x.data_ptr() for x in tensors]
        if row0:
            for c in _ROW_COLS:
                x = tensors[c]
                if x is not None and x.numel():
                    ptrs[c] -= row0 * (x.numel() // x.shape[0]) * x.element_size()
        args.p[:] = ptrs
        ints = list(self._ints) + [
            int(sched is not None), int(self.sentinel),
            *((0, 0, 0, 0) if sched is None else (
                sched.part_start.shape[0], sched.ll_start.shape[0],
                sched.cw_start.shape[0], sched.dg_start.shape[0])),
            int(self.topo.dense), row0, self.cfg.n if rows is None else rows,
            int(slo_defer), int(self.reference),
            0 if sched is None else mask_words(sched)]
        ints[_INTS.index("rf")] = self._relay_factor(sched)
        args.i[:] = [int(x) for x in ints]
        args.f[:] = [float(x) for x in self._flts]
        return args

    def _stages(self, sched):
        stages = [("chaos_pre", _LIB.gossip_chaos_pre)] if sched is not None else []
        stages += [("probe_send", _LIB.gossip_probe_send),
                   ("receive", _LIB.gossip_receive),
                   ("pushpull", _LIB.gossip_pushpull)]
        if self.reference:
            stages += [("ref_send", _LIB.gossip_ref_send),
                       ("ref_intake", _LIB.gossip_ref_intake)]
        elif self.serf:
            stages.append(("serf_post", _LIB.gossip_serf_post))
        return stages

    def _launch(self, stage, fn, args, stream):
        """One launch on ``stream`` (of the current device)."""
        rc = fn(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"gossip_tick {stage} launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES[stage] += 1
        self.launches += 1

    def buffer_bytes_per_node(self, world, packed, draws, sched=None) -> float:
        """Bytes per node of every buffer the launches touch, from the
        tensors of one tick: each input (state, world, draws, topology
        tables) read once, the output state written once, each scratch
        buffer written once and read once. A row read again at a
        displacement is counted once, so this is the least traffic of the
        launch design, not a measurement."""
        device = layout_mod.tick_of(packed).device
        sched = chaos_mod.or_none(sched)
        self._check_inputs(world, packed, draws, device, sched)
        _, scratch, tensors = self._buffers(world, packed, draws, device, sched)
        # The mirrors and tally targets alias the tick's own leaves here.
        own = tensors[:len(_PTRS) - len(_ALIASES)]
        total = sum(layout_mod.np_size_bytes(x) for x in own if x is not None)
        total += sum(layout_mod.np_size_bytes(x) for x in scratch.values())
        return total / float(self.cfg.n)

    def __call__(self, world, packed, draws, sched=None):
        device = layout_mod.tick_of(packed).device
        sched = chaos_mod.or_none(sched)
        if device.type != "cuda":
            raise ValueError(f"the CUDA tick kernel takes CUDA tensors, got "
                             f"{device}; use plain_tick, plain_serf_tick or "
                             "plain_reference_serf_tick for the plain version")
        self._check_inputs(world, packed, draws, device, sched)
        build()
        out, scratch, tensors = self._buffers(world, packed, draws, device,
                                              sched)
        args = self._args(tensors, sched)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for stage, fn in self._stages(sched):
                self._launch(stage, fn, args, stream)
        return out, scratch["counters"]

    def chaos_pre(self, world, packed, draws, sched):
        """Launch P alone on the tick's inputs: its ``(word, record)``
        ([N] and [N, 4] int32 of u32 bits), which the tick's later launches
        would read; the inputs are untouched. CUDA tensors only: the plain
        version is :func:`plain_chaos_pre`."""
        device = layout_mod.tick_of(packed).device
        sched = chaos_mod.or_none(sched)
        if device.type != "cuda":
            raise ValueError(f"launch P takes CUDA tensors, got {device}; use "
                             "plain_chaos_pre for the plain version")
        if sched is None:
            raise ValueError("launch P runs under a non-empty schedule")
        self._check_inputs(world, packed, draws, device, sched)
        build()
        _, scratch, tensors = self._buffers(world, packed, draws, device, sched)
        with torch.cuda.device(device):
            self._launch("chaos_pre", _LIB.gossip_chaos_pre,
                         self._args(tensors, sched),
                         torch.cuda.current_stream(device).cuda_stream)
        return scratch["c_word"], scratch["c_rec"]


def make_tick_kernel(cfg: SimConfig, topo: Topology, *,
                     serf_plane: bool = False,
                     sentinel: bool = False,
                     variant: Optional[str] = None) -> TickKernel:
    """The counterpart of pallas_gossip.make_tick_kernel: the SWIM tick,
    or with ``serf_plane=True`` its ``step_fn=serf.step_counted`` variant,
    or with ``variant="serf_reference"`` its
    ``step_fn=serf.step_reference_counted`` one (B8); a fault schedule per
    call, the sentinel with ``sentinel=True``."""
    return TickKernel(cfg, topo, serf_plane, sentinel, variant)


def _row_views(tree, n: int, row0: int, rows: int, device):
    """Rows [row0, row0 + rows) of every node-axis leaf of a draw bundle
    (views where the bundle is on ``device``, copies elsewhere), every
    other leaf whole."""
    if tree is None or isinstance(tree, torch.Tensor):
        if tree is None:
            return None
        x = tree[row0:row0 + rows] if tree.dim() >= 1 and tree.shape[0] == n \
            else tree
        return x.to(device)
    return type(tree)(*(_row_views(x, n, row0, rows, device) for x in tree))


def exchange_plan(key: str, groups, b: int) -> list:
    """The copies of the sharded call's exchange before launch ``key`` (a
    key of :data:`EXCHANGES`) under ``groups`` (``parallel.mesh``'s
    grouping, ``b`` rows a shard): one ``(mirror, to, from, row0, rows)``
    per mirror the launch reads and pair of distinct groups, the source
    group's rows [row0, row0 + rows) copied into the receiving group's
    full-height buffer. A group's own rows are never copied; one group
    copies nothing."""
    spans = [(g[0] * b, len(g) * b) for g in groups]
    return [(name, to, frm, *spans[frm]) for name in EXCHANGES.get(key, ())
            for to in range(len(groups)) for frm in range(len(groups))
            if to != frm]


class _Group(NamedTuple):
    """One device group's operands of a sharded tick."""
    device: torch.device
    row0: int
    rows: int
    out: object
    scratch: dict
    tensors: list


class ShardedTickKernel:
    """B7, the tick once per node-axis shard (the reference's kernel under
    ``shard_map``, parallel/shard_step.py:253-267, :295-299):
    ``tick(blocks, draws, sched_blocks=None) -> (blocks, counters)``.

    ``blocks`` holds each shard's packed state (a ``SerfState`` with a
    packed SWIM plane for ``serf_plane=True``) of ``n / R`` rows on its
    mesh device, placed by ``parallel.shard_step.place`` under this
    call's ``groups``; ``draws`` is the tick's one bundle for the whole
    cluster (``swim.draw_tick`` / ``serf.draw_serf_tick``) on the mesh's
    first device; ``sched_blocks`` the schedule placed by
    ``shard_step.place_schedule`` under the same ``groups``.

    The shards of one device group (``groups``, by default
    ``parallel.mesh.device_groups``: a run of shards on one device) are
    adjacent row views of one storage per leaf, so each stage (chaos_pre,
    probe_send, receive, pushpull, serf_post) launches once per group,
    over the group's rows, on the group's device and its current stream.
    On one card the default grouping is one group, and a tick is the
    one-device launch set (row0 = 0, rows = n): no exchange, no mirror, D's
    tally straight into the output, C's SLO counters formed by C. With
    several groups the leaves a launch reads at other rows
    (:func:`full_height_leaves`, and the scratch behind :data:`MIRRORS`)
    are full height per group; before each launch that reads them
    (:data:`EXCHANGES`) every group receives the other groups' rows, one
    copy per (leaf, source group) (:func:`exchange_plan`); D's tally lands
    in a zeroed full-height scratch per group, summed in group order and
    added to each group's rows, and the groups' SLO words are OR-ed into
    the counters by one more launch (``gossip_slo_fold``). A group whose
    blocks are not adjacent raises; they are never copied into place.
    ``groups=parallel.mesh.shard_groups(mesh)`` runs the schedule of a
    mesh of one card per shard on any mesh, one card included. Returns
    the new blocks (adjacent views again) and each group's [26] int32
    counters (the SLO counters on group 0's), which sum to the tick's.
    A call takes CUDA tensors only and raises on others; the plain version
    is the threaded runner of parallel/shard_step.py."""

    def __init__(self, cfg: SimConfig, topo: Topology, mesh,
                 serf_plane: bool = False, sentinel: bool = False,
                 groups=None):
        from consul_tpu_torch.parallel import mesh as mesh_mod

        self.mesh = mesh
        self.rows = mesh_mod.check_rows(cfg.n, mesh.size)
        self.groups = mesh_mod.check_groups(mesh, groups)
        self.kernel = TickKernel(cfg, topo, serf_plane, sentinel)
        self.cfg, self.serf = cfg, serf_plane
        # Launches and exchange copies since construction.
        self.launches = 0
        self.copies = 0
        self._worlds = {}
        # Set to a list to trace a tick: (label, CUDA event) marks on the
        # first device's stream before each exchange and each stage's
        # launch set, and an "end" mark (chip_smoke.py times them apart).
        self.events = None

    def _mark(self, label: str):
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.mesh.devices[0]))
            self.events.append((label, ev))

    def set_world(self, world):
        """The world, whole on every device of the mesh (it never changes:
        one copy at placement)."""
        self._worlds = {dev: topology.World(*(x.to(dev, copy=True) for x in world))
                        for dev in self.mesh.unique_devices()}

    def __call__(self, blocks, draws, sched_blocks=None):
        from consul_tpu_torch.parallel import mesh as mesh_mod

        mesh, b = self.mesh, self.rows
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} shards")
        sched_blocks = (None if sched_blocks is None
                        or chaos_mod.or_none(sched_blocks[0]) is None
                        else sched_blocks)
        if not self._worlds:
            raise ValueError("set_world first: the kernel reads the world "
                             "whole on every device")
        for d, (blk, dev) in enumerate(zip(blocks, mesh.devices)):
            if dev.type != "cuda":
                raise ValueError(f"the sharded CUDA tick takes CUDA tensors; "
                                 f"shard {d} is on {dev}: run the plain "
                                 "version (parallel/shard_step.run_ticks)")
            if layout_mod.tick_of(blk).device != dev:
                raise ValueError(f"shard {d}'s block is on "
                                 f"{layout_mod.tick_of(blk).device}, its mesh "
                                 f"device is {dev}")
        build()
        k = self.kernel
        multi, chaos = len(self.groups) > 1, sched_blocks is not None
        parts, args = self._operands(blocks, draws, sched_blocks)
        stages = k._stages(sched_blocks)
        for stage, fn in stages:
            key = "probe_send_chaos" if stage == "probe_send" and chaos else stage
            if multi and key in EXCHANGES:
                self._mark("exchange:" + stage)
                self._exchange(key, parts)
            self._mark("launch:" + stage)
            for part, a in zip(parts, args):
                with torch.cuda.device(part.device):
                    k._launch(stage, fn, a,
                              torch.cuda.current_stream(part.device).cuda_stream)
                SHARDED_LAUNCHES[stage] += 1
                self.launches += 1
            if stage == "pushpull" and multi and chaos:
                self._slo_fold(args[0], parts)
        if multi and self.serf:
            self._mark("exchange:tally")
            self._tally(parts)
        self._mark("end")
        out = []
        for g, part in zip(self.groups, parts):
            out += mesh_mod.shard_views(part.out, g, b)
        return out, [part.scratch["counters"] for part in parts]

    def chaos_pre(self, blocks, draws, sched_blocks):
        """Launch P alone, once per group, on one tick's inputs: each
        group's ``(word, record)`` over its rows (as
        :meth:`TickKernel.chaos_pre`), in group order."""
        if sched_blocks is None or chaos_mod.or_none(sched_blocks[0]) is None:
            raise ValueError("launch P runs under a non-empty schedule")
        for dev in self.mesh.devices:
            if dev.type != "cuda":
                raise ValueError(f"launch P takes CUDA tensors, got {dev}")
        build()
        parts, args = self._operands(blocks, draws, sched_blocks)
        for part, a in zip(parts, args):
            with torch.cuda.device(part.device):
                self.kernel._launch(
                    "chaos_pre", _LIB.gossip_chaos_pre, a,
                    torch.cuda.current_stream(part.device).cuda_stream)
            SHARDED_LAUNCHES["chaos_pre"] += 1
            self.launches += 1
        return [(p.scratch["c_word"], p.scratch["c_rec"]) for p in parts]

    def _operands(self, blocks, draws, sched_blocks):
        """Each group's operands (:class:`_Group`) and TickArgs for one
        tick: the group's blocks as one tree of its rows (views, checked
        adjacent), its rows of the draws, its new buffers and, under
        several groups, its mirrors."""
        from consul_tpu_torch.parallel import mesh as mesh_mod

        cfg, b, k = self.cfg, self.rows, self.kernel
        multi, chaos = len(self.groups) > 1, sched_blocks is not None
        # The push-pull draw is the tick's, whole on every device.
        u_pp = (draws.swim if self.serf else draws).u_pp if chaos else None
        parts, args = [], []
        for g in self.groups:
            dev = self.mesh.devices[g[0]]
            row0, rows = g[0] * b, len(g) * b
            st = mesh_mod.group_tree(blocks, g, b, cfg.n)
            dd = _row_views(draws, cfg.n, row0, rows, dev)
            sd = (None if not chaos else mesh_mod.group_tree(
                sched_blocks, g, b, cfg.n, rows=chaos_mod.NODE_MASKS))
            world = self._worlds[dev]
            k._check_inputs(world, st, dd, dev, sd, rows=rows)
            out, scratch, tens = k._buffers(world, st, dd, dev, sd, rows=rows,
                                            row0=row0 if multi else None)
            if multi:
                self._mirrors(tens, row0, dev, u_pp)
            parts.append(_Group(dev, row0, rows, out, scratch, tens))
            args.append(k._args(tens, sd, row0, rows, slo_defer=multi and chaos))
        return parts, args

    def _mirrors(self, tens, row0, dev, u_pp):
        """A group's mirror operands under several groups: each source's
        full-height buffer (the group's input leaves as placed, its new
        scratch), the whole push-pull draw, zeroed tally scratch."""
        from consul_tpu_torch.parallel import mesh as mesh_mod

        q = self.cfg.serf.query_slots
        for col, src in _SOURCE.items():
            name, x = _PTRS[col], tens[src]
            if x is None:
                tens[col] = None
            elif name == "m_upp":
                tens[col] = u_pp.to(dev)
            elif name in ("t_acks", "t_resps"):
                tens[col] = torch.zeros((self.cfg.n, q), dtype=torch.int32,
                                        device=dev)
            else:
                tens[col] = mesh_mod.full_view(
                    x, row0, self.cfg.n,
                    what=f"{name} (place blocks with parallel.shard_step.place)")

    def _exchange(self, key, parts):
        """Each group's full-height buffers receive the other groups' rows
        of the mirrors launch ``key`` reads (:func:`exchange_plan`)."""
        for name, to, frm, row0, rows in exchange_plan(key, self.groups, self.rows):
            col = _PTRS.index(name)
            parts[to].tensors[col][row0:row0 + rows].copy_(
                parts[frm].tensors[_SOURCE[col]])
            self.copies += 1

    def _slo_fold(self, args0, parts):
        """The groups' SLO words, OR-ed into group 0's counters."""
        dev0 = parts[0].device
        words = torch.cat([p.scratch["slo"][:1].to(dev0) for p in parts])
        with torch.cuda.device(dev0):
            stream = torch.cuda.current_stream(dev0).cuda_stream
            rc = _LIB.gossip_slo_fold(ctypes.byref(args0),
                                      ctypes.c_void_p(words.data_ptr()),
                                      len(parts), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"gossip_slo_fold launch failed: CUDA error {rc}")
        SHARDED_LAUNCHES["slo_fold"] += 1

    def _tally(self, parts):
        """D's tallies summed over the groups in order, each group's rows
        added to its q_acks / q_resps (sum_scatter_rows; integer adds)."""
        for name, leaf in (("t_acks", "q_acks"), ("t_resps", "q_resps")):
            col = _PTRS.index(name)
            total = parts[0].tensors[col]
            for part in parts[1:]:
                total = total + part.tensors[col].to(total.device)
            for part in parts:
                dst = getattr(part.out, leaf)
                dst += total[part.row0:part.row0 + part.rows].to(dst.device)


def exchange_bytes_per_node(stage: str, state, sched=None, *, cfg: SimConfig,
                            groups) -> float:
    """Bytes per node that the sharded call's exchange before launch
    ``stage`` moves under ``groups`` (``parallel.mesh``'s grouping): each
    mirrored leaf (:data:`EXCHANGES`) read once from its source group and
    written once into each other group's buffer, only rows copied across
    groups (:func:`exchange_plan`): with G groups, G - 1 copies of the
    leaf in all; none with one group. From the shapes of one tick's state
    (a block or the whole: per node it is the same)."""
    if stage not in STAGES:
        raise ValueError(f"unknown launch {stage!r}; expected one of {STAGES}")
    serf_plane = isinstance(state, serf.SerfState)
    sw = state.swim if serf_plane else state
    sched = chaos_mod.or_none(sched)
    n, k = sw.meta.shape
    p = cfg.gossip.piggyback_msgs
    if stage == "probe_send":
        viv = sum(layout_mod.np_size_bytes(x) for x in (
            sw.viv.vec, sw.viv.height, sw.viv.error, sw.viv.adjustment)) / n
        # flags and incarnation, or chaos_pre's word and record.
        per = viv + (_CHAOS_ROW if sched is not None else 1 + 2)
    elif stage == "receive":
        per = 2 + p + 4 * p + 4 * p + 4 + 4
    elif stage == "pushpull":
        per = 4 * k
    elif stage == "serf_post" and serf_plane:
        pe, q = cfg.serf.piggyback_events, state.q_open_key.shape[1]
        per = 2 + 4 * pe + 4 * pe + 4 * q + 4
    else:
        per = 0.0
    return 2 * per * (len(groups) - 1)


def plain_metrics(cfg: SimConfig, topo: Topology, world, packed, i, j):
    """The plain PyTorch version of launch M: [4] float32 agreement,
    false_positive, undetected and Vivaldi RMSE of a PackedSimState over
    the pairs (i, j) (metrics.health_packed, metrics.vivaldi_rmse_packed)."""
    h = metrics.health_packed(cfg, topo, packed)
    rmse = metrics.vivaldi_rmse_packed(cfg, world, packed, i, j)
    return torch.stack([h.agreement, h.false_positive, h.undetected,
                        rmse]).to(torch.float32)


def metrics_hbm_bytes(packed, world, samples: int) -> float:
    """The least memory traffic of one launch M in bytes: meta and flags
    read once, and for each sampled pair its two indices and the two rows'
    flags, coordinates and world positions; the [4] row written."""
    n, k = packed.meta.shape
    d, wd = packed.viv.vec.shape[1], world.pos.shape[1]
    per_row = 1 + 2 * d + 2 + 2 + 4 * wd + 4
    return (2 * n * k + n + 4 * k + samples * (2 * 8 + 2 * per_row) + 16)


class MetricsKernel:
    """Launch M for one (config, topology): ``m(world, packed, i, j, out)``
    writes the tick's TickTrace row of a PackedSimState (agreement,
    false_positive, undetected, Vivaldi RMSE over the pairs (i, j)) into
    ``out``, a [4] float32 CUDA tensor (a row of the chunk's [C, 4]
    trace), with no read back to the host. CUDA tensors only: the plain
    version is :func:`plain_metrics`."""

    def __init__(self, cfg: SimConfig, topo: Topology):
        self.cfg, self.topo = cfg, topo
        self._tables = {}

    def _scratch(self, device, samples: int):
        """The offsets as int32 and the grid scratch for ``samples`` pairs,
        which each launch leaves zeroed for the next."""
        words = _MACC + 2 * -(-samples // 256)
        if device not in self._tables or self._tables[device][1].numel() < words:
            off = self.topo.off.to(device=device, dtype=torch.int32).contiguous()
            acc = torch.zeros((words,), dtype=torch.int64, device=device)
            self._tables[device] = (off, acc)
        return self._tables[device]

    def __call__(self, world, packed, i, j, out):
        cfg = self.cfg
        device = packed.meta.device
        if device.type != "cuda":
            raise ValueError(f"launch M takes CUDA tensors, got {device}; use "
                             "plain_metrics for the plain version")
        n, k = cfg.n, cfg.degree
        d, wd = cfg.vivaldi.dimensionality, cfg.world_dims
        s = i.shape[0] if i.dim() == 1 else -1
        bf = torch.bfloat16
        for name, t, dt, shape in (
                ("meta", packed.meta, torch.uint16, (n, k)),
                ("flags", packed.flags, torch.uint8, (n,)),
                ("viv.vec", packed.viv.vec, bf, (n, d)),
                ("viv.height", packed.viv.height, bf, (n,)),
                ("viv.adjustment", packed.viv.adjustment, bf, (n,)),
                ("world.pos", world.pos, torch.float32, (n, wd)),
                ("world.height", world.height, torch.float32, (n,)),
                ("i", i, torch.int64, (s,)), ("j", j, torch.int64, (s,)),
                ("out", out, torch.float32, (4,))):
            _check(t, name, dt, shape, device)
        if s < 1:
            raise ValueError("launch M needs at least one sampled pair")
        build()
        off, acc = self._scratch(device, s)
        args = _MetricsArgs()
        ptrs = (packed.meta, packed.flags, off, packed.viv.vec,
                packed.viv.height, packed.viv.adjustment, world.pos,
                world.height, i, j, acc, out)
        for idx, x in enumerate(ptrs):
            args.p[idx] = x.data_ptr()
        # The bit-sliced pass where rows are whole 16-byte chunks of meta and
        # flags can be read 16 bytes at a time; one cell a thread otherwise.
        vec = (k % 8 == 0 and packed.meta.data_ptr() % 16 == 0
               and packed.flags.data_ptr() % 16 == 0)
        for idx, x in enumerate((n, k, d, wd, s, vec)):
            args.i[idx] = int(x)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _LIB.gossip_metrics(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"gossip_metrics launch failed: CUDA error {rc}")
        LAUNCHES["metrics"] += 1
        return out


def make_metrics_kernel(cfg: SimConfig, topo: Topology) -> MetricsKernel:
    """Launch M for ``cfg`` and ``topo`` (sparse or dense view)."""
    return MetricsKernel(cfg, topo)


def lens_hbm_bytes(packed, ids, clock=None) -> float:
    """The least memory traffic of one launch L in bytes: for each sampled
    row its flags, own_inc, own_tx, pending_col, pending_fail_delta and
    viv.error, its K cells of meta and susp_delta, the serf clock (when
    there is one) and its int32 id read once, and its 7 f32 written."""
    k = packed.meta.shape[1]
    per_row = 1 + 2 + 1 + 1 + 2 + 2 + 2 * k + 2 * k + 4 + 4 * 7
    if clock is not None:
        per_row += 4
    return float(len(ids) * per_row)


class LensKernel:
    """Launch L for one config: ``lens(packed, clock, ids, out)`` writes the
    tick's node-lens row of a PackedSimState at the sampled ``ids`` (the
    obs/lens.FIELDS, with the serf Lamport ``clock`` or 0 when it is None)
    into ``out``, an [S, 7] float32 CUDA tensor whose rows may be strided
    (the first 7 columns of a row of the chunk's [C, S, F] buffer), with no
    read back to the host. CUDA tensors only: the plain version is
    ``obs/lens.snapshot_packed``."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self._ids = {}

    def _ids_on(self, ids, device) -> torch.Tensor:
        """The ids as an int32 tensor on ``device``, checked and made once
        per id tuple."""
        key = (tuple(ids), device)
        if key not in self._ids:
            n = self.cfg.n
            if not all(0 <= int(i) < n for i in key[0]):
                raise ValueError(f"lens ids must lie in [0, {n})")
            self._ids[key] = torch.tensor(key[0], dtype=torch.int32,
                                          device=device)
        return self._ids[key]

    def __call__(self, packed, clock, ids, out):
        cfg = self.cfg
        device = packed.meta.device
        if device.type != "cuda":
            raise ValueError(f"launch L takes CUDA tensors, got {device}; use "
                             "obs.lens.snapshot_packed for the plain version")
        n, k, s = cfg.n, cfg.degree, len(ids)
        for name, t, dt, shape in (
                ("flags", packed.flags, torch.uint8, (n,)),
                ("own_inc", packed.own_inc, torch.uint16, (n,)),
                ("own_tx", packed.own_tx, torch.uint8, (n,)),
                ("pending_col", packed.pending_col, torch.uint8, (n,)),
                ("pending_fail_delta", packed.pending_fail_delta, torch.int16,
                 (n,)),
                ("viv.error", packed.viv.error, torch.bfloat16, (n,)),
                ("meta", packed.meta, torch.uint16, (n, k)),
                ("susp_delta", packed.susp_delta, torch.uint16, (n, k))):
            _check(t, name, dt, shape, device)
        if clock is not None:
            _check(clock, "clock", torch.uint32, (n,), device)
        if s < 1:
            raise ValueError("launch L needs at least one sampled id")
        if not isinstance(out, torch.Tensor) or out.device != device:
            raise ValueError(f"out: expected a tensor on {device}")
        if out.dtype != torch.float32 or tuple(out.shape) != (s, 7):
            raise ValueError(f"out: {out.dtype} {tuple(out.shape)}, expected "
                             f"float32 ({s}, 7)")
        if out.stride(1) != 1 or out.stride(0) < 7:
            raise ValueError("out: rows must be unit-stride and apart by at "
                             "least 7 elements")
        idx = self._ids_on(ids, device)
        build()
        args = _LensArgs()
        ptrs = (packed.flags, packed.own_inc, packed.own_tx, packed.pending_col,
                packed.pending_fail_delta, packed.viv.error, packed.meta,
                packed.susp_delta, clock, idx, out)
        for i, x in enumerate(ptrs):
            args.p[i] = None if x is None else x.data_ptr()
        for i, x in enumerate((n, k, s, out.stride(0))):
            args.i[i] = int(x)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _LIB.gossip_lens(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"gossip_lens launch failed: CUDA error {rc}")
        LAUNCHES["lens"] += 1
        return out


def make_lens_kernel(cfg: SimConfig) -> LensKernel:
    """Launch L for ``cfg`` (sparse or dense view)."""
    return LensKernel(cfg)
