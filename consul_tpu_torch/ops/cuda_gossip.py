"""The packed gossip tick as a hand-written CUDA kernel for Hopper.

Counterpart of ``consul_tpu/ops/pallas_gossip.py``: its one ``pallas_call``
(``make_tick_kernel``, pallas_call at :145) fuses unpack -> tick -> pack
over the packed state, for ``step_fn=swim.step_counted`` (the bare SWIM
tick) or ``step_fn=serf.step_counted`` (the fused serf plane), each with
or without a fault schedule and the invariant sentinel, on the sparse
circulant view or the dense one (K = N - 1 <= 255). The port's kernel is
``consul_tpu_torch/csrc/gossip_tick.cu``: three launches split at the
tick's grid-wide read-after-write barriers (probe/sender, receive,
push-pull/pack), in the serf variant a fourth (serf_post), and with a
schedule a first one (chaos_pre) that applies the churn edges and
evaluates the schedule per row. The tick is bound by bytes, most of them
[N, K] view rows and [N, E] / [N, R, O] serf rows, so every launch but
chaos_pre runs on a persistent grid of warp tiles: a warp owns up to 32
consecutive rows, takes their cells with consecutive lanes (every warp
load of a row-major leaf a full line; serf_post stages its queue and
dedup buckets in shared memory) and their per-row scalar work one row
per lane; chaos_pre takes one row per thread. See the note at the top of
that file. :func:`launch_hbm_bytes_per_node` counts each
launch's least traffic, the yardstick of its time on the card.

One more launch of that file, M (:class:`MetricsKernel`), is not a TPU
kernel: it computes a tick's TickTrace row (agreement, false positives,
undetected deaths, Vivaldi RMSE) from the packed leaves, where the
reference's chunk body unpacks a transient view. Its plain version is
:func:`plain_metrics`.

Beside the kernel sit its plain PyTorch versions, :func:`plain_tick`
(``unpack -> swim.step_counted -> pack``) and :func:`plain_serf_tick`
(``unpack_state -> serf.step_counted -> pack_state``), which the CPU tests
hold against the reference and which ``chip_smoke.py`` holds the kernel
against on the card. A plain version is chosen only by an explicit
``kernel="torch"``; the kernel wrapper raises on anything it does not
take (a CPU tensor, K > 255, a wrong dtype or shape) and never falls
back.

Build: ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes``, compiled at first use into ``build/consul_tpu_torch/``
beside the package (the file name carries a hash of the source, so an
edited source rebuilds). Nothing is built or loaded at import.
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
from consul_tpu_torch.ops import topology
from consul_tpu_torch.ops.topology import Topology
from consul_tpu_torch.utils import metrics

TORCH = "torch"
CUDA = "cuda"
KERNELS = (TORCH, CUDA)

# Kernel launches on the card since the last reset, by launch stage
# (serf_post runs in the serf variant only, chaos_pre in ticks with a
# fault schedule; metrics is launch M, once per tick with metrics on).
# Incremented only where a stage is launched; chip_smoke.py zeroes it
# before it drives a main path and reads it after.
LAUNCHES = {"chaos_pre": 0, "probe_send": 0, "receive": 0, "pushpull": 0,
            "serf_post": 0, "metrics": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gossip_tick.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "consul_tpu_torch")

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
# which the SWIM tick does not read.
_SCHED_LEAVES = chaos_mod.ChaosSchedule._fields[:19]
assert _SCHED_LEAVES[-1] == "dg_mask"
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
       "x_orig"]
    + list(_SCHED_LEAVES)
    + ["u_pp", "c_flags", "c_inc", "c_color", "c_abits", "c_bbits", "c_qtx",
       "c_qrx", "slo"]
)
_INTS = ("n", "k", "s", "d", "w", "wd", "ic", "fan", "p", "tx_limit",
         "susp_k", "pp_period", "own_limit", "probe_period", "awareness_max",
         "serf", "e", "r", "o", "q", "pe", "rf", "orig16", "exact_sig",
         "chaos", "sentinel", "np", "nl", "nc", "nd", "dense")
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


# The tick's launch stages (every launch but M).
STAGES = tuple(k for k in LAUNCHES if k != "metrics")


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
    piggyback widths, which no tensor of the tick carries."""
    if stage not in STAGES:
        raise ValueError(f"unknown launch {stage!r}; expected one of {STAGES}")
    serf_plane = isinstance(state, serf.SerfState)
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
    # incarnation, or chaos_pre's post-churn flags, incarnation and node
    # terms (color, side bits, two survival products) under a schedule.
    own = 1 + 4 + 20 if chaos else 1 + 2
    view_in = sum(row_bytes(x) for x in (sw.view_inc, sw.meta, sw.susp_delta,
                                         sw.susp_seen))
    u16, u32 = 2 * k, 4 * k     # one [K] row of uint16 / uint32
    if stage == "chaos_pre":
        if not chaos:
            return 0.0
        # The input's flags and incarnation and the schedule the kernel
        # reads; the post-churn flags, incarnation and terms written.
        masks = sum(row_bytes(getattr(sched, f)) for f in _SCHED_LEAVES)
        return 1 + 2 + masks + 1 + 4 + 4 * 5

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
            rd += (row_bytes(state.ev_key) + row_bytes(state.ev_origin)
                   + row_bytes(state.ev_tx) + 8 * q)
            wr += 2 + 4 * pe + 4 * pe + 8 * q
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

    # serf_post: the serf leaves it reads and rewrites, the row's flags
    # (and terms), the senders' payloads, the intake and tally draws, and
    # C's final meta row.
    if not serf_plane:
        return 0.0
    keep = ("leave_at", "ev_key", "ev_origin", "ev_tx", "ev_pending",
            "ev_bkt_lt", "ev_bkt_sig", "q_bkt_lt", "q_bkt_sig", "ev_floor",
            "q_floor", "clock", "event_clock", "query_clock", "ev_delivered",
            "q_responder", "q_open_key", "q_deadline", "down_since")
    rw = sum(row_bytes(getattr(state, f)) for f in keep)
    pe = cfg.serf.piggyback_events
    rf = draws.relay_u1.shape[1]
    rd = (rw + (1 + 20 if chaos else 1) + 2 + 4 * pe + 4 * pe + 4 * fan + 4
          + 8 * rf + u16 + 8 * rf / n)
    return rd + rw + 1


class BuildInfo(NamedTuple):
    path: str
    seconds: float
    log: str


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
    it. Returns where it went, how long the compile took and what
    ``ptxas -v`` said."""
    global _LIB, _LIB_INFO
    with _LIB_LOCK:
        if _LIB_INFO is not None:
            return _LIB_INFO
        src = open(SOURCE, "rb").read()
        tag = hashlib.sha256(src).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"libgossip_tick_{tag}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(out):
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                   "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, out)
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        for name in ("gossip_chaos_pre", "gossip_probe_send", "gossip_receive",
                     "gossip_pushpull", "gossip_serf_post"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_TickArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gossip_metrics.argtypes = [ctypes.POINTER(_MetricsArgs),
                                       ctypes.c_void_p]
        lib.gossip_metrics.restype = ctypes.c_int
        for fn, want in (
                (lib.gossip_layout, (len(_PTRS), len(_INTS), len(_FLTS),
                                     ctypes.sizeof(_TickArgs))),
                (lib.gossip_metrics_layout, (len(_MPTRS), len(_MINTS), _MACC,
                                             ctypes.sizeof(_MetricsArgs)))):
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            lay = (ctypes.c_int * 4)()
            fn(lay)
            if tuple(lay) != want:
                raise RuntimeError(f"{fn.__name__} mismatch: library "
                                   f"{tuple(lay)}, wrapper {want}")
        _LIB = lib
        _LIB_INFO = BuildInfo(out, seconds, log)
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
    tallies. With ``serf_plane=True`` it is the serf variant: ``packed``
    is a ``SerfState`` whose SWIM plane is packed and ``draws`` a
    ``serf.SerfDraws`` (``draw_serf_tick(..., chaos=True)`` under a
    schedule). The view is sparse or dense, K <= 255 either way."""

    def __init__(self, cfg: SimConfig, topo: Topology, serf_plane: bool = False,
                 sentinel: bool = False):
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
        self.sentinel = sentinel
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

    def _check_schedule(self, sched, draws, device):
        """Every leaf the kernel reads, by its name's suffix: slot ticks
        int32 [m], loss rates float32 [m], node masks bool [n, m]."""
        n = self.cfg.n
        for fam in ("part", "ll"):
            m = getattr(sched, fam + "_start").shape[0]
            # Partition colors and link sides are int32 bitfields.
            if m > chaos_mod.MAX_PARTITIONS:
                raise ValueError(f"the CUDA tick kernel takes at most "
                                 f"{chaos_mod.MAX_PARTITIONS} {fam} slots, "
                                 f"got {m}")
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

    def _check_inputs(self, world, packed, draws, device, sched=None):
        cfg = self.cfg
        n, k = cfg.n, cfg.degree
        g, v = cfg.gossip, cfg.vivaldi
        s, d, w = v.latency_filter_size, v.dimensionality, v.adjustment_window_size
        u8, u16, i16 = torch.uint8, torch.uint16, torch.int16
        f8, bf = torch.float8_e4m3fn, torch.bfloat16
        f32, i64 = torch.float32, torch.int64
        if self.serf:
            if not isinstance(packed, serf.SerfState):
                raise TypeError("the serf variant takes a SerfState")
            if not isinstance(draws, serf.SerfDraws):
                raise TypeError("the serf variant takes serf.SerfDraws")
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
        _check(world.pos, "world.pos", f32, (n, cfg.world_dims), device)
        _check(world.height, "world.height", f32, (n,), device)
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
            self._check_schedule(sched, draws, device)

    def _buffers(self, world, packed, draws, device, sched=None):
        """The output state, the scratch buffers and the flat operand list
        (in TickArgs order, None for a null pointer) of one tick."""
        cfg = self.cfg
        n, k, p = cfg.n, cfg.degree, cfg.gossip.piggyback_msgs
        sw_in, sw_draws = ((packed.swim, draws.swim) if self.serf
                           else (packed, draws))
        sw_out = layout_mod.PackedSimState(
            *[torch.empty_like(x) for x in sw_in[:-1]],
            layout_mod.PackedVivaldi(*[torch.empty_like(x) for x in sw_in.viv]))
        u32 = torch.uint32
        scratch = dict(
            view_mid=torch.empty((n, k), dtype=u32, device=device),
            pay_flags=torch.empty((n,), dtype=torch.uint16, device=device),
            pay_scol=torch.empty((n, p), dtype=torch.uint8, device=device),
            pay_skey=torch.empty((n, p), dtype=u32, device=device),
            pay_sbits=torch.empty((n, p), dtype=u32, device=device),
            pay_ownk=torch.empty((n,), dtype=u32, device=device),
            poke=torch.empty((n,), dtype=u32, device=device),
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
            tensors += [None] * (2 * _SERF_LEAVES + 7)
        else:
            pe = cfg.serf.piggyback_events
            s_in = list(packed[1:])
            out = serf.SerfState(sw_out, *[torch.empty_like(x) for x in s_in])
            xs = dict(
                x_flags=torch.empty((n,), dtype=torch.uint16, device=device),
                x_key=torch.empty((n, pe), dtype=u32, device=device),
                x_orig=torch.empty((n, pe), dtype=torch.int32, device=device))
            scratch.update(xs)
            tensors += (s_in + list(out[1:])
                        + [draws.u_resp, draws.relay_u1, draws.relay_u2,
                           draws.relay_cols] + list(xs.values()))
        if sched is None:
            tensors += [None] * (len(_SCHED_LEAVES) + 9)
        else:
            i32, f32 = torch.int32, torch.float32
            cs = dict(
                c_flags=torch.empty((n,), dtype=torch.uint8, device=device),
                c_inc=torch.empty((n,), dtype=u32, device=device),
                c_color=torch.empty((n,), dtype=i32, device=device),
                c_abits=torch.empty((n,), dtype=i32, device=device),
                c_bbits=torch.empty((n,), dtype=i32, device=device),
                c_qtx=torch.empty((n,), dtype=f32, device=device),
                c_qrx=torch.empty((n,), dtype=f32, device=device),
                slo=torch.zeros((2,), dtype=i32, device=device))
            scratch.update(cs)
            tensors += ([getattr(sched, f) for f in _SCHED_LEAVES]
                        + [sw_draws.u_pp] + list(cs.values()))
        assert len(tensors) == len(_PTRS)
        return out, scratch, tensors

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
        total = sum(layout_mod.np_size_bytes(x) for x in tensors if x is not None)
        total += sum(layout_mod.np_size_bytes(x) for x in scratch.values())
        return total / float(self.cfg.n)

    def __call__(self, world, packed, draws, sched=None):
        device = layout_mod.tick_of(packed).device
        sched = chaos_mod.or_none(sched)
        if device.type != "cuda":
            raise ValueError(f"the CUDA tick kernel takes CUDA tensors, got "
                             f"{device}; use plain_tick or plain_serf_tick "
                             "for the plain version")
        self._check_inputs(world, packed, draws, device, sched)
        build()
        out, scratch, tensors = self._buffers(world, packed, draws, device,
                                              sched)
        args = _TickArgs()
        for idx, x in enumerate(tensors):
            args.p[idx] = None if x is None else x.data_ptr()
        ints = list(self._ints) + [
            int(sched is not None), int(self.sentinel),
            *((0, 0, 0, 0) if sched is None else (
                sched.part_start.shape[0], sched.ll_start.shape[0],
                sched.cw_start.shape[0], sched.dg_start.shape[0])),
            int(self.topo.dense)]
        ints[_INTS.index("rf")] = self._relay_factor(sched)
        for idx, x in enumerate(ints):
            args.i[idx] = int(x)
        for idx, x in enumerate(self._flts):
            args.f[idx] = float(x)
        stages = [("chaos_pre", _LIB.gossip_chaos_pre)] if sched is not None else []
        stages += [("probe_send", _LIB.gossip_probe_send),
                  ("receive", _LIB.gossip_receive),
                  ("pushpull", _LIB.gossip_pushpull)]
        if self.serf:
            stages.append(("serf_post", _LIB.gossip_serf_post))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for stage, fn in stages:
                rc = fn(ctypes.byref(args), ctypes.c_void_p(stream))
                if rc != 0:
                    raise RuntimeError(f"gossip_tick {stage} launch failed: "
                                       f"CUDA error {rc}")
                LAUNCHES[stage] += 1
        return out, scratch["counters"]


def make_tick_kernel(cfg: SimConfig, topo: Topology, *,
                     serf_plane: bool = False,
                     sentinel: bool = False) -> TickKernel:
    """The counterpart of pallas_gossip.make_tick_kernel: the SWIM tick,
    or with ``serf_plane=True`` its ``step_fn=serf.step_counted`` variant;
    a fault schedule per call, the sentinel with ``sentinel=True``."""
    return TickKernel(cfg, topo, serf_plane, sentinel)


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
        # Groups of 8 cells in one 16-byte load where rows hold whole groups.
        vec = k % 8 == 0 and packed.meta.data_ptr() % 16 == 0
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
