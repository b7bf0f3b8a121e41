// One packed SWIM gossip tick for Hopper (sm_90a), in three to five launches.
//
// Replaces the TPU kernel consul_tpu/ops/pallas_gossip.py:make_tick_kernel
// (pallas_call at :145): unpack -> swim.step_counted (or serf.step_counted)
// -> pack over the packed state, plus the stacked int32 counters, with or
// without a fault schedule and the invariant sentinel, on a circulant view
// of K <= 255 columns or the dense one (K = N - 1).
//
// What bounds it: bytes. The tick is branchy integer work with a few dozen
// float operations per node; the packed contract is 1088 B/node/tick at
// K = 32 (state read + write + world), far below the card's operations rate.
//
// The Pallas kernel keeps the whole population in one VMEM block. Here the
// tick is split at its grid-wide read-after-write barriers into launches:
//   (A) probe_send: suspicion expiry, probe resolution and launch, the
//       median filter and Vivaldi update, and the gossip sender side. Reads
//       of other rows (probe target, relays) come from the INPUT state.
//       Writes the post-probe view keys to the view_mid scratch, a per-
//       sender payload and a poke word, and every output field that no
//       later phase changes.
//   (B) receive: each receiver reads its senders' payloads, merges facts,
//       applies Lifeguard confirmations against the post-merge view,
//       collects refute claims and scans the K in-columns for pokes. It
//       updates only its own view_mid row.
//   (C) pushpull: pull and push against view_mid rows of the partner and
//       the initiator (recomputing the initiator's init_ok from its row),
//       refutation, suspicion reconciliation, budget re-arm and pack.
// Every per-row read at a displacement is a plain indexed load (i +- off[c])
// mod n. Counters are integer sums, exact in any order. Built without fast
// math and with -fmad=false, so the float operations keep the reference's
// order.
//
// A, B, C and D, warp tiles. Most of A's and C's bytes are the [N, K] view
// leaves (view_inc, meta, susp_delta, susp_seen, view_mid, lat_cnt,
// lat_buf), one row-major row of 64-128 B per node at K = 32. A thread walking its own
// row puts a warp's 32 loads on 32 rows, 32 sectors for 2-4 useful bytes
// each, and the lines are gone from L1 before the next column. So a warp
// owns a tile of up to 32 consecutive rows, whose cells are contiguous in
// every view leaf, and the work is cut in two kinds of phase:
//   cell phases: consecutive lanes take consecutive cells of the tile, 2-4
//     of them in flight per lane, so every warp load or store of a view
//     leaf is one or two full lines (A's expiry, C's merge, reconciliation
//     and pack; C's partner and initiator reads are permutations within one
//     row of view_mid, a line or two per warp load);
//   row phases: one lane takes one row, as the [N] arrays are laid out (the
//     probe and its round trips, the relays, the median, Vivaldi, the send
//     gates and payload; refutation and the push-pull decisions), and a
//     row's results reach the cell phases by __shfl_sync.
// A stages its tile's meta in shared memory (rows padded to an odd number
// of words, so 32 lanes reading 32 rows at one column hit 32 banks): the
// probe candidates, the top-P peel by remaining budget (max value, lowest
// column on ties) and the budget decrement read and write it there, and a
// cell phase writes meta out. A wrapped row's probe-order reshuffle ranks
// each column against the row's uniforms with the lanes over its columns:
// O(K) per lane, where one thread's argmin peel was O(K^2). Vivaldi updates
// of direct acks, a fifth of the rows, wait in a per-warp queue and run 32
// at a time, one per lane, in registers (vectors in unrolled [MAXD] arrays,
// the adjustment window streamed), after the tile copies have put every
// row's input Vivaldi leaves in the output. Blocks are persistent, as many
// as stay resident, each warp striding over tiles; counters are summed per
// lane, per warp (__reduce_add_sync) and per block, one global atomic per
// counter per block. Only integer work moves between lanes; each float
// operation of a row stays on one lane in the reference's order, and no
// float sum is split.
// B and D follow the same plan (their notes below): B's rows, and D's
// queue and dedup buckets, are the tile's contiguous cells, its per-row
// work one row per lane over them.
// What still bounds them: C moves its bytes near the card's rate. A's row
// phases chase dependent scattered reads (probe target, relays, the
// target's coordinates) one row per lane, so A runs a few times over its
// bytes bound. Hopper's tensor cores have no work here (integer compare,
// max and count). TMA and cp.async are not used: a tile's row of a view
// leaf is a line or two that a warp loads itself, with several cells per
// lane in flight.
//
// Host interface: a plain C function per launch taking one TickArgs by
// pointer (pointer, int and float tables indexed by the enums below, which
// consul_tpu_torch/ops/cuda_gossip.py mirrors) and a stream; each returns
// cudaGetLastError() after its launch.
//
// The serf variant (I_SERF = 1) replaces the same pallas_call with
// step_fn=serf.step_counted: unpack -> serf.step_counted -> pack over a
// SerfState whose SWIM plane is packed and whose serf leaves keep the
// reference's dtypes (1477 B/node at K = 32, E = 8, R = 16, O = 4, Q = 4;
// the contract is 2970 B/node/tick). It adds to A and runs a fourth launch:
//   (A) also peels the top piggyback_events queue entries of the PRE-tick
//       queue by remaining budget (serf.py:512-531) and writes them, with
//       the per-leg liveness-only send gate ex_sendable, to the x_* payload
//       scratch beside pay_*; and copies q_resps/q_acks to the output, so
//       the tally's cross-row adds in D land on the input values.
//   (D) serf_post, after C has written the final view, in warp tiles:
//       the row's quiet leave (left |= quiet in its own packed flags),
//       delivery of the oldest staged entry against the dedup buckets, the
//       Lamport witness, the query tally, budget decrement and retirement,
//       intake of up to 2 fresh arrivals, query expiry and down_since from
//       the final view status. D re-reads the senders' x_* payloads at the
//       tick's gossip displacements (no [N, fan*PE] candidate scratch);
//       the arrival of each leg uses the membership leg's drop draw and
//       the receiver's pre-quiet liveness, as in swim._gossip_phase. The
//       tally is its one cross-row write: each responder adds 1 into the
//       origin row's q_acks (and q_resps) slot with an int32 atomicAdd,
//       exact in any order. The slot match reads q_open_key from the INPUT
//       (pre-expiry, serf.py:723 then :558); the origin's and each relay
//       row's liveness is recomputed post-quiet from their flags (after
//       P's churn edges, under a schedule) and leave_at. D stages its
//       tile's queue and event dedup buckets in shared memory, updates them
//       there in the order the reference rejects in and writes them out;
//       the query buckets, which only query keys touch, are copied to the
//       output and updated there.
//
// The chaos + sentinel variant replaces the same pallas_call with a
// non-empty ChaosSchedule (I_CHAOS = 1) and/or sentinel=True
// (I_SENTINEL = 1), for the bare SWIM tick. All schedule evaluation of the
// Pallas body runs here, from the schedule's tensors and the draws:
//   (P) chaos_pre, a launch before A, one thread per row: each row's churn
//       edges at tick t (kill rows whose wave went down this tick,
//       warm-revive rows whose wave came back: incarnation + 1, alive, not
//       left or leaving, own budget re-armed) and its node terms (partition
//       color, LinkLoss side bits, Degrade survival products in slot
//       order), into c_* scratch that no later launch writes. A, B and C
//       read every row's flags, incarnation and terms, their own and other
//       rows', from that scratch, so each read sees the post-churn value
//       and the input state stays untouched.
//   A gates the direct/TCP round trips and the three relay legs on
//       pair_ok, counts false deaths (expiries whose subject is up and on
//       the prober's side) and, with the sentinel, the non-finite Vivaldi
//       coordinates and written RTT slots on the f32 values before packing.
//   B gates each gossip leg on pair_ok(sender, receiver) and counts the
//       legs the schedule dropped.
//   C gates the push-pull session on its round trip against u_pp (both
//       directions: the initiator's own session is recomputed from its
//       row), and over the final view folds the four grid-wide SLO
//       indicators (fault, not yet suspected, not yet confirmed, stale
//       after the fault) into a per-block word, atomicOr'd into slo[0];
//       the last block to finish (a ticket in slo[1]) turns them into the
//       tick's counters on the device. With the sentinel it also counts
//       range, monotonicity and suspicion violations on the final values.
//       Its per-cell subject reads (flags and colour at r + off[c]) are
//       the one read that cell phases scatter: 32 rows per warp load, from
//       [N] arrays that stay in L2.
// Survival products multiply in the reference's order (chaos.pair_ok):
// a one-ulp difference in a threshold would flip a draw.
//
// The serf + chaos + sentinel variant (I_SERF = 1 with I_CHAOS and/or
// I_SENTINEL) replaces the same pallas_call with step_fn=serf.step_counted
// under a schedule and/or the sentinel. P runs first, A, B and C are the
// chaos variant's, and D reads every liveness after the churn edges
// (flags_at): its own flags, which it writes back with the quiet bit, the
// origin's and each relay row's. The tally's direct response and both
// legs of each relayed copy are pair_ok legs on P's terms (the origin's at
// worig, a relay's at r + off[rcols[k]]), and the relays run under a
// schedule even without loss. Each intake leg arrives on the one-way
// pair_ok that gates the membership leg in B. With the sentinel D adds its
// rows' Lamport regressions to sentinel_monotonic; the SWIM-plane checks,
// the SLO indicators and false deaths stay in A and C, where the reference
// takes them (inside swim.step_counted, before serf's quiet leave).
//
// Every variant also takes the dense view (I_DENSE = 1: the complete graph,
// K = N - 1 <= 255): the wrapper builds rcol and inv from the closed forms
// of topology.remap_row / inv_col, and the gossip displacements are the
// draws' i.i.d. gossip_jcols instead of the sweep (gossip_col). A warp then
// takes fewer rows (down to one, so n = 256 spreads over 256 warps).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_fp16.h>

// Packed-state leaves, in PackedSimState flatten order.
enum Leaf {
  L_T, L_FLAGS, L_OWN_INC, L_OWN_TX, L_AWARE, L_PTR, L_NEXT, L_PCOL, L_PFAIL,
  L_NACK, L_VINC, L_META, L_SDELTA, L_SSEEN, L_LCNT, L_LBUF, L_VEC, L_VH,
  L_VERR, L_VADJ, L_VSAMP, L_VIDX, L_VRES, N_LEAVES
};

enum Ptr {
  P_IN = 0,                     // + Leaf: input packed state
  P_OUT = N_LEAVES,             // + Leaf: output packed state
  P_POS = 2 * N_LEAVES, P_HEIGHT,
  P_JITTER, P_U2, P_RELAY, P_UA, P_UB, P_UC, P_PERMU, P_VIVFB, P_GRAVFB,
  P_UDROP, P_PPJ, P_GJCOLS,
  P_OFF, P_RCOL, P_INV,
  P_VMID, P_PFLAGS, P_PSCOL, P_PSKEY, P_PSBITS, P_POWNK, P_POKE, P_REFUTE,
  P_CNT,
  // Serf variant only (null for the bare tick).
  P_SIN,                        // + SLeaf: input serf leaves
  P_SOUT = P_SIN + 21,          // + SLeaf: output serf leaves
  P_URESP = P_SOUT + 21, P_RU1, P_RU2, P_RCOLS,
  P_XFLAGS, P_XKEY, P_XORIG,
  // Chaos variant only: the schedule (ChaosSchedule field order, raft lane
  // excluded), the push-pull draw, the per-row scratch of chaos_pre, and
  // the SLO word and ticket.
  P_PSTART, P_PSTOP, P_PSIDE, P_LSTART, P_LSTOP, P_LFWD, P_LREV, P_LA, P_LB,
  P_CSTART, P_CSTOP, P_CPERIOD, P_CDOWN, P_CMASK, P_DSTART, P_DSTOP, P_DTX,
  P_DRX, P_DMASK, P_UPP, P_CFLAGS, P_CINC, P_CCOLOR, P_CABITS, P_CBBITS,
  P_CQTX, P_CQRX, P_SLO, N_PTR
};

// Serf leaves, in SerfState field order after the SWIM plane.
enum SLeaf {
  S_CLOCK, S_ECLOCK, S_QCLOCK, S_EKEY, S_EORIG, S_ETX, S_EPEND, S_EBLT,
  S_EBSIG, S_QBLT, S_QBSIG, S_EDELIV, S_EFLOOR, S_QFLOOR, S_QOPEN, S_QDEAD,
  S_QRESP, S_QACK, S_QRESPONDER, S_LEAVE, S_DOWN, N_SLEAVES
};
static_assert(N_SLEAVES == 21, "serf leaf table");

enum Int {
  I_N, I_K, I_S, I_D, I_W, I_WD, I_IC, I_FAN, I_P, I_TX_LIMIT, I_SUSP_K,
  I_PP_PERIOD, I_OWN_LIMIT, I_PROBE_PERIOD, I_AWARE_MAX,
  I_SERF, I_E, I_R, I_O, I_Q, I_PE, I_RF, I_ORIG16, I_EXACT_SIG,
  I_CHAOS, I_SENTINEL, I_NP, I_NL, I_NC, I_ND, I_DENSE, N_INT
};

enum Flt {
  F_SUSP_MIN, F_SUSP_MAX, F_SUSP_DIFF, F_PLOSS, F_TIMEOUT, F_JITTER_FRAC,
  F_CE, F_CC, F_ERR_MAX, F_HMIN, F_RHO,
  F_KEEP,  // 1 - packet_loss, rounded once from double (chaos.pair_ok)
  N_FLT
};

struct TickArgs {
  void* p[N_PTR];
  int32_t i[N_INT];
  float f[N_FLT];
};

enum Counter {
  C_PROBES, C_ACKS, C_NACKS, C_TIMEOUTS, C_SUSP, C_REFUT, C_DEATHS, C_GTX,
  C_GRX, C_GMSGS, C_PP, C_SQUEUED, C_SRETX, C_SDROPPED, C_FAULT, C_FIRST,
  C_CONFIRM, C_HEAL, C_FALSE_DEATHS, C_CDROPPED, C_SRANGE, C_SMONO, C_SSUSP,
  C_SCOORD, C_SRTT, C_WRITES, N_CNT
};
static_assert(N_CNT == 26, "counter wire order");

#define MAXD 16
#define MAXW 64
#define MAXS 8
#define MAXE 16    // event queue slots
#define MAXP 7     // piggybacked facts per send
#define MAXPE 8    // piggybacked events per send
#define MAXC 32    // intake candidates, gossip_nodes * piggyback_events

constexpr uint32_t ALIVE = 0, SUSPECT = 1, DEAD = 2, LEFT = 3;
constexpr uint32_t UNKNOWN = 2;  // (0, DEAD)
constexpr int SELF_COL = -2;
constexpr float ZERO_T = 1.0e-6f;
constexpr float F8_SCALE = 256.0f;
constexpr float F8_CLIP = 448.0f / 256.0f;
constexpr uint32_t MAX_INCARNATION = (1u << 30) - 1u;
constexpr uint8_t REVIVED = 0x80;  // chaos_pre's mark in c_flags, never stored

template <typename T>
__device__ __forceinline__ T* ptr(const TickArgs& a, int k) {
  return reinterpret_cast<T*>(a.p[k]);
}

__device__ __forceinline__ uint32_t mk(uint32_t inc, uint32_t st) {
  return (inc << 2) | st;
}
__device__ __forceinline__ uint32_t kst(uint32_t k) { return k & 3u; }
__device__ __forceinline__ uint32_t kinc(uint32_t k) { return k >> 2; }
__device__ __forceinline__ bool contactable(uint32_t k) {
  uint32_t s = kst(k);
  return s == ALIVE || s == SUSPECT || k == UNKNOWN;
}
__device__ __forceinline__ uint32_t demote(uint32_t k) {
  return (kst(k) == DEAD && k != UNKNOWN) ? ((k & ~3u) | SUSPECT) : k;
}
__device__ __forceinline__ bool refutes(uint32_t k, uint32_t own_inc) {
  uint32_t s = kst(k);
  return (s == SUSPECT || s == DEAD) && kinc(k) >= own_inc;
}

__device__ __forceinline__ float bf2f(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float f8tof(uint8_t b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b),
                                         __NV_E4M3);
  return __half2float(__half(h)) / F8_SCALE;
}
__device__ __forceinline__ uint8_t ftof8(float x) {
  x = fminf(fmaxf(x, -F8_CLIP), F8_CLIP) * F8_SCALE;
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE,
                                                    __NV_E4M3));
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

// Folds a block's shared-memory counters into the global ones: one global
// atomic per nonzero counter per block.
__device__ void block_flush(const int* smem, int* global) {
  __syncthreads();
  for (int k = threadIdx.x; k < N_CNT; k += blockDim.x)
    if (smem[k]) atomicAdd(&global[k], smem[k]);
}

// ---------------------------------------------------------------------------
// Chaos schedule (chaos/schedule.py), per row.
// ---------------------------------------------------------------------------

// A row's flags and incarnation as the tick sees them: after chaos_pre's
// churn edges when a schedule is installed, else the input's.
__device__ __forceinline__ uint8_t flags_at(const TickArgs& a, int x) {
  return a.i[I_CHAOS] ? ptr<const uint8_t>(a, P_CFLAGS)[x]
                      : ptr<const uint8_t>(a, P_IN + L_FLAGS)[x];
}
__device__ __forceinline__ uint32_t inc_at(const TickArgs& a, int x) {
  return a.i[I_CHAOS] ? ptr<const uint32_t>(a, P_CINC)[x]
                      : static_cast<uint32_t>(ptr<const uint16_t>(a, P_IN + L_OWN_INC)[x]);
}

struct Terms {
  int color, abits, bbits;
  float qtx, qrx;
};

__device__ __forceinline__ Terms terms_at(const TickArgs& a, int x) {
  return Terms{ptr<const int32_t>(a, P_CCOLOR)[x], ptr<const int32_t>(a, P_CABITS)[x],
               ptr<const int32_t>(a, P_CBBITS)[x], ptr<const float>(a, P_CQTX)[x],
               ptr<const float>(a, P_CQRX)[x]};
}

// chaos._link_survival: slot by slot, forward then reverse.
__device__ float link_survival(const TickArgs& a, const Terms& s, const Terms& d) {
  const float* fwd = ptr<const float>(a, P_LFWD);
  const float* rev = ptr<const float>(a, P_LREV);
  const int fh = s.abits & d.bbits, rh = s.bbits & d.abits;
  float q = 1.0f;
  for (int l = 0; l < a.i[I_NL]; ++l) {
    if ((fh >> l) & 1) q = q * (1.0f - fwd[l]);
    if ((rh >> l) & 1) q = q * (1.0f - rev[l]);
  }
  return q;
}

__device__ __forceinline__ float survival(const TickArgs& a, const Terms& s,
                                          const Terms& d) {
  return s.qtx * d.qrx * link_survival(a, s, d);
}

// chaos.pair_ok: one leg src -> dst on its draw u; keep = 1 - base loss.
__device__ bool pair_ok(const TickArgs& a, const Terms& s, const Terms& d, float u,
                        float keep, bool round_trip) {
  float q = survival(a, s, d);
  if (round_trip) q = q * survival(a, d, s);
  const float p = 1.0f - keep * q;
  return s.color == d.color && u >= p;
}

__device__ __forceinline__ bool in_window(int t, int start, int stop) {
  return t >= start && t < stop;
}

// The tick's f-th gossip displacement column (swim._gossip_jcols): the
// draws' i.i.d. columns on the dense view, the phase-free sweep (any
// ceil(K / fan) consecutive ticks serve every column) on the sparse one.
__device__ __forceinline__ int gossip_col(const TickArgs& a, int t, int f) {
  if (a.i[I_DENSE]) return static_cast<int>(ptr<const int64_t>(a, P_GJCOLS)[f]);
  const int K = a.i[I_K], FAN = a.i[I_FAN];
  return ((t % ((K + FAN - 1) / FAN)) * FAN + f) % K;
}

// ---------------------------------------------------------------------------
// Vivaldi (ops/vivaldi.py update, one element), held in registers: vectors
// are [MAXD] arrays walked by unrolled loops guarded by k < d, and the
// adjustment window streams from the row's stored samples, so nothing
// goes to local memory. Every sum is a left fold in the reference's order.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float vnorm(const float (&x)[MAXD], int d) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (k < d) acc += x[k] * x[k];
  return sqrtf(acc);
}

__device__ __forceinline__ float vdistance(const float (&va)[MAXD], float ha, float aa,
                                           const float (&vb)[MAXD], float hb, float ab,
                                           int d) {
  float diff[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) diff[k] = k < d ? va[k] - vb[k] : 0.0f;
  float dist = vnorm(diff, d) + ha + hb;
  float adjusted = dist + aa + ab;
  return adjusted > 0.0f ? adjusted : dist;
}

// apply_force: moves vec (in place) and returns the new height; rnd is the
// row's random direction in the draws.
__device__ __forceinline__ float apply_force(float (&vec)[MAXD], float h, float force,
                                             const float (&ovec)[MAXD], float oh,
                                             const float* rnd, int d, float hmin) {
  float diff[MAXD], r[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    diff[k] = k < d ? vec[k] - ovec[k] : 0.0f;
    r[k] = k < d ? rnd[k] : 0.0f;
  }
  float mag = vnorm(diff, d);
  float rmag = vnorm(r, d);
  bool use_real = mag > ZERO_T, use_rnd = rmag > ZERO_T;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k >= d) continue;
    float unit;
    if (use_real) unit = diff[k] / mag;
    else if (use_rnd) unit = r[k] / rmag;
    else unit = (k == 0) ? 1.0f : 0.0f;
    vec[k] = vec[k] + unit * force;
  }
  float m = use_real ? mag : 0.0f;
  bool moved = m > ZERO_T;
  float nh = (h + oh) * force / (moved ? m : 1.0f) + h;
  nh = fmaxf(nh, hmin);
  return moved ? nh : h;
}

// Row i's Vivaldi observation of target tgt at the median RTT med (when
// direct_ok): an accepted update, or a reset when it comes out non-finite,
// written over the output leaves (which hold the input row until then).
// Returns whether the row's f32 coordinates after the tick are non-finite
// (the sentinel's check, asked for with check; an accepted update always
// leaves them finite).
__device__ bool viv_observe(const TickArgs& a, int i, int tgt, bool direct_ok, float med,
                            bool check) {
  if (!direct_ok && !check) return false;
  const int d = a.i[I_D], w = a.i[I_W];
  const float ce = a.f[F_CE], cc = a.f[F_CC], emax = a.f[F_ERR_MAX];
  const float hmin = a.f[F_HMIN], rho = a.f[F_RHO];
  const uint16_t* in_vec = ptr<const uint16_t>(a, P_IN + L_VEC);
  const uint16_t* in_vh = ptr<const uint16_t>(a, P_IN + L_VH);
  const uint16_t* in_verr = ptr<const uint16_t>(a, P_IN + L_VERR);
  const uint16_t* in_vadj = ptr<const uint16_t>(a, P_IN + L_VADJ);
  const uint8_t* in_vsamp = ptr<const uint8_t>(a, P_IN + L_VSAMP);
  const uint8_t* in_vidx = ptr<const uint8_t>(a, P_IN + L_VIDX);
  const uint8_t* in_vres = ptr<const uint8_t>(a, P_IN + L_VRES);
  uint16_t* o_vec = ptr<uint16_t>(a, P_OUT + L_VEC);
  uint16_t* o_vh = ptr<uint16_t>(a, P_OUT + L_VH);
  uint16_t* o_verr = ptr<uint16_t>(a, P_OUT + L_VERR);
  uint16_t* o_vadj = ptr<uint16_t>(a, P_OUT + L_VADJ);
  uint8_t* o_vsamp = ptr<uint8_t>(a, P_OUT + L_VSAMP);
  uint8_t* o_vidx = ptr<uint8_t>(a, P_OUT + L_VIDX);
  uint8_t* o_vres = ptr<uint8_t>(a, P_OUT + L_VRES);
  const size_t vb = static_cast<size_t>(i) * d;
  const size_t sb = static_cast<size_t>(i) * w;
  const int idx = in_vidx[i];

  float vec[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) vec[k] = k < d ? bf2f(in_vec[vb + k]) : 0.0f;
  const float h = bf2f(in_vh[i]), err = bf2f(in_verr[i]), adj = bf2f(in_vadj[i]);
  bool accepted = false;
  if (direct_ok) {
    const size_t tb = static_cast<size_t>(tgt) * d;
    float ovec[MAXD];
#pragma unroll
    for (int k = 0; k < MAXD; ++k) ovec[k] = k < d ? bf2f(in_vec[tb + k]) : 0.0f;
    const float oh = bf2f(in_vh[tgt]), oerr = bf2f(in_verr[tgt]);
    const float oadj = bf2f(in_vadj[tgt]);
    bool ok = isfinite(oh) && isfinite(oerr) && isfinite(oadj) && isfinite(med) &&
              med >= 0.0f && med <= 10.0f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) ok = ok && (k >= d || isfinite(ovec[k]));
    if (ok) {
      accepted = true;
      float dist = vdistance(vec, h, adj, ovec, oh, oadj, d);
      float rtt = fmaxf(med, ZERO_T);
      float wrongness = fabsf(dist - rtt) / rtt;
      float total = fmaxf(err + oerr, ZERO_T);
      float weight = err / total;
      float cw = ce * weight;
      float error = cw * wrongness + err * (1.0f - cw);
      error = fminf(error, emax);
      float force = cc * weight * (rtt - dist);
      float nvec[MAXD];
#pragma unroll
      for (int k = 0; k < MAXD; ++k) nvec[k] = vec[k];
      float nh = apply_force(nvec, h, force, ovec, oh,
                             ptr<const float>(a, P_VIVFB) + vb, d, hmin);
      float sample = 0.0f, nadj = adj;
      int nidx = idx;
      if (w) {
        float diff[MAXD];
#pragma unroll
        for (int k = 0; k < MAXD; ++k) diff[k] = k < d ? nvec[k] - ovec[k] : 0.0f;
        float raw = vnorm(diff, d) + nh + oh;
        sample = rtt - raw;
        nidx = (idx + 1) % w;
        float sum = 0.0f;
        for (int k = 0; k < w; ++k) sum += k == idx ? sample : f8tof(in_vsamp[sb + k]);
        nadj = sum / (2.0f * static_cast<float>(w));
      }
      float origin[MAXD];
#pragma unroll
      for (int k = 0; k < MAXD; ++k) origin[k] = 0.0f;
      float dist_o = vdistance(nvec, nh, nadj, origin, hmin, 0.0f, d);
      float x = dist_o / rho;
      float g_force = -1.0f * (x * x);
      nh = apply_force(nvec, nh, g_force, origin, hmin,
                       ptr<const float>(a, P_GRAVFB) + vb, d, hmin);
      bool finite = isfinite(nh) && isfinite(error) && isfinite(nadj);
#pragma unroll
      for (int k = 0; k < MAXD; ++k) finite = finite && (k >= d || isfinite(nvec[k]));
      if (finite) {
        for (int k = 0; k < d; ++k) o_vec[vb + k] = f2bf(nvec[k]);
        o_vh[i] = f2bf(nh);
        o_verr[i] = f2bf(error);
        o_vadj[i] = f2bf(nadj);
        for (int k = 0; k < w; ++k)
          o_vsamp[sb + k] = ftof8(k == idx ? sample : f8tof(in_vsamp[sb + k]));
        o_vidx[i] = static_cast<uint8_t>(nidx & 0xFF);
        o_vres[i] = in_vres[i];
      } else {
        for (int k = 0; k < d; ++k) o_vec[vb + k] = f2bf(0.0f);
        o_vh[i] = f2bf(hmin);
        o_verr[i] = f2bf(emax);
        o_vadj[i] = f2bf(0.0f);
        for (int k = 0; k < w; ++k) o_vsamp[sb + k] = ftof8(0.0f);
        o_vidx[i] = 0;
        o_vres[i] = static_cast<uint8_t>((in_vres[i] + 1) & 0xFF);
      }
    }
  }
  if (accepted) return false;
  bool bad = !isfinite(h) || !isfinite(err) || !isfinite(adj);
#pragma unroll
  for (int k = 0; k < MAXD; ++k) bad = bad || (k < d && !isfinite(vec[k]));
  return bad;
}

// ---------------------------------------------------------------------------
// Serf helpers (models/serf.py), for one row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int load_origin(const TickArgs& a, int k, size_t idx) {
  return a.i[I_ORIG16] ? static_cast<int>(ptr<const int16_t>(a, k)[idx])
                       : static_cast<int>(ptr<const int32_t>(a, k)[idx]);
}
__device__ __forceinline__ void store_origin(const TickArgs& a, int k, size_t idx,
                                             int v) {
  if (a.i[I_ORIG16]) ptr<int16_t>(a, k)[idx] = static_cast<int16_t>(v);
  else ptr<int32_t>(a, k)[idx] = v;
}

// Top-PE queue slots of row block eb by remaining budget (max value, lowest
// index on ties), read from the input queue.
__device__ void serf_peel(const TickArgs& a, size_t eb, int E, int PE,
                          int* order, int* mtx) {
  const int8_t* etx = ptr<const int8_t>(a, P_SIN + S_ETX) + eb;
  uint32_t taken = 0;
  for (int q = 0; q < PE; ++q) {
    int best = -1, bv = 0;
    for (int e = 0; e < E; ++e) {
      if ((taken >> e) & 1u) continue;
      const int v = etx[e];
      if (best < 0 || v > bv) {
        best = e;
        bv = v;
      }
    }
    taken |= 1u << best;
    order[q] = best;
    mtx[q] = bv;
  }
}

// Dedup identity of (key, origin): the exact pack below 2^21 nodes, the
// murmur3 finalizer above (serf._sig).
__device__ __forceinline__ uint32_t serf_sig(bool exact, uint32_t key, int origin) {
  if (exact)
    return 0x80000000u | (static_cast<uint32_t>(origin + 1) << 9) | (key & 0x1FFu);
  uint32_t h = key ^ (static_cast<uint32_t>(origin) * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h | 1u;
}

// One ltime-bucketed dedup buffer of one row (serf._buf_lookup/_buf_apply).
struct Bucket {
  uint32_t* lt;    // [R]
  uint32_t* sig;   // [R * O]
  uint32_t floor;
  int R, O;
  bool exact;

  __device__ bool rejects(uint32_t key, int origin) const {
    const uint32_t l = key >> 9;
    const int b = static_cast<int>(l % static_cast<uint32_t>(R));
    const uint32_t blt = lt[b];
    const uint32_t sg = serf_sig(exact, key, origin);
    bool full = true, hit = false;
    for (int o = 0; o < O; ++o) {
      const uint32_t v = sig[b * O + o];
      full = full && v != 0u;
      hit = hit || v == sg;
    }
    return (hit && blt == l) || (full && blt == l) || blt > l || l < floor;
  }

  __device__ void apply(uint32_t key, int origin) {
    const uint32_t l = key >> 9;
    const int b = static_cast<int>(l % static_cast<uint32_t>(R));
    const uint32_t blt = lt[b];
    const bool takeover = blt != l;
    if (takeover && blt > 0u) floor = max(floor, blt + 1u);
    lt[b] = l;
    int free_slot = 0;
    for (int o = O - 1; o >= 0; --o)
      if (sig[b * O + o] == 0u) free_slot = o;
    const int slot = takeover ? 0 : free_slot;
    const uint32_t sg = serf_sig(exact, key, origin);
    for (int o = 0; o < O; ++o)
      sig[b * O + o] = o == slot ? sg : (takeover ? 0u : sig[b * O + o]);
  }
};

// ---------------------------------------------------------------------------
// (P) chaos_pre: churn edges and node terms at tick t, one row per thread
//     (swim.py:240-251, chaos.node_terms / down_at).
// ---------------------------------------------------------------------------

__device__ bool churn_down(const TickArgs& a, int i, int t) {
  const int NC = a.i[I_NC];
  const int32_t* cs = ptr<const int32_t>(a, P_CSTART);
  const int32_t* ce = ptr<const int32_t>(a, P_CSTOP);
  const int32_t* cp = ptr<const int32_t>(a, P_CPERIOD);
  const int32_t* cd = ptr<const int32_t>(a, P_CDOWN);
  const bool* cm = ptr<const bool>(a, P_CMASK) + static_cast<size_t>(i) * NC;
  bool down = false;
  for (int c = 0; c < NC; ++c)
    down = down || (cm[c] && in_window(t, cs[c], ce[c]) &&
                    floor_mod(t - cs[c], max(cp[c], 1)) < cd[c]);
  return down;
}

__global__ void k_chaos_pre(TickArgs a) {
  const int n = a.i[I_N];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = *ptr<const int32_t>(a, P_IN + L_T);
  const int NP = a.i[I_NP], NL = a.i[I_NL], ND = a.i[I_ND];
  const size_t row = static_cast<size_t>(i);

  uint8_t fl = ptr<const uint8_t>(a, P_IN + L_FLAGS)[i];
  uint32_t inc = ptr<const uint16_t>(a, P_IN + L_OWN_INC)[i];
  const bool down_now = churn_down(a, i, t), down_prev = churn_down(a, i, t - 1);
  if (down_now && !down_prev) fl &= ~1u;           // kill
  if (down_prev && !down_now) {                    // warm revive
    fl = static_cast<uint8_t>(((fl | 1u) & ~6u) | REVIVED);
    inc += 1u;
  }
  ptr<uint8_t>(a, P_CFLAGS)[i] = fl;
  ptr<uint32_t>(a, P_CINC)[i] = inc;

  int color = 0, abits = 0, bbits = 0;
  const bool* side = ptr<const bool>(a, P_PSIDE) + row * NP;
  for (int p = 0; p < NP; ++p)
    if (side[p] && in_window(t, ptr<const int32_t>(a, P_PSTART)[p],
                             ptr<const int32_t>(a, P_PSTOP)[p]))
      color |= 1 << p;
  const bool* la = ptr<const bool>(a, P_LA) + row * NL;
  const bool* lb = ptr<const bool>(a, P_LB) + row * NL;
  for (int l = 0; l < NL; ++l) {
    if (!in_window(t, ptr<const int32_t>(a, P_LSTART)[l],
                   ptr<const int32_t>(a, P_LSTOP)[l]))
      continue;
    if (la[l]) abits |= 1 << l;
    if (lb[l]) bbits |= 1 << l;
  }
  float qtx = 1.0f, qrx = 1.0f;
  const bool* dm = ptr<const bool>(a, P_DMASK) + row * ND;
  for (int d = 0; d < ND; ++d) {
    if (!(dm[d] && in_window(t, ptr<const int32_t>(a, P_DSTART)[d],
                             ptr<const int32_t>(a, P_DSTOP)[d])))
      continue;
    qtx = qtx * (1.0f - ptr<const float>(a, P_DTX)[d]);
    qrx = qrx * (1.0f - ptr<const float>(a, P_DRX)[d]);
  }
  ptr<int32_t>(a, P_CCOLOR)[i] = color;
  ptr<int32_t>(a, P_CABITS)[i] = abits;
  ptr<int32_t>(a, P_CBBITS)[i] = bbits;
  ptr<float>(a, P_CQTX)[i] = qtx;
  ptr<float>(a, P_CQRX)[i] = qrx;
}

// ---------------------------------------------------------------------------
// Warp tiles: A and C
//
// Each warp owns a tile of up to 32 consecutive rows and strides over the
// tiles of a persistent grid. Cell phases run with the lanes over the
// tile's [rows, K] cells (consecutive lanes on consecutive cells, so every
// warp load or store of a view leaf is a full coalesced line); row phases
// run with one row per lane, as the [N] arrays are laid out. A row's
// values pass from its lane to the cell phases by __shfl_sync.
// ---------------------------------------------------------------------------

#define WARPS 8    // warps per block of A and C
#define MAXK 256   // widest view row a warp stages in shared memory
#define UNROLL 2   // cells per lane per step of a cell phase
constexpr uint32_t FULL = 0xFFFFFFFFu;

// Per-lane counter tallies (compile-time indices, so they stay in
// registers), summed over the warp with __reduce_add_sync and over the
// block in shared memory: one global atomic per nonzero counter per block.
struct Tally {
  int v[N_CNT];
  __device__ Tally() {
#pragma unroll
    for (int k = 0; k < N_CNT; ++k) v[k] = 0;
  }
  __device__ __forceinline__ void add(int k, int x) { v[k] += x; }
  __device__ void flush(int* smem, int lane) {
#pragma unroll
    for (int k = 0; k < N_CNT; ++k) {
      const int s = __reduce_add_sync(FULL, v[k]);
      if (lane == 0 && s) atomicAdd(&smem[k], s);
    }
  }
};

// The row of flat cell e of a tile: e / K as a multiply-high (exact for
// e < 2^24; kdiv = floor((2^32 - 1) / K) + 1).
__device__ __forceinline__ int row_of(int e, int K, uint32_t kdiv) {
  return K == 1 ? e : static_cast<int>(__umulhi(static_cast<uint32_t>(e), kdiv));
}

// Copies nbytes from src to dst with the lanes of one warp, 16 bytes a lane
// where both ends allow it, U loads of a lane in flight at once.
template <int U = 1>
__device__ void warp_copy(uint8_t* dst, const uint8_t* src, size_t nbytes, int lane) {
  size_t done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const size_t nv = nbytes / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t x0 = 0; x0 < nv; x0 += 32 * U) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (x0 + 32 * u + lane < nv) v[u] = s4[x0 + 32 * u + lane];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (x0 + 32 * u + lane < nv) d4[x0 + 32 * u + lane] = v[u];
    }
    done = nv * 16;
  }
  for (size_t x = done + lane; x < nbytes; x += 32) dst[x] = src[x];
}

#define MAXFAN 8   // widest gossip fan-out (gossip_nodes)

// The multiplier of row_of for a row width w.
__host__ __device__ __forceinline__ uint32_t div_of(int w) {
  return 0xFFFFFFFFu / static_cast<uint32_t>(w) + 1u;
}

// (x + d) mod n and (x - d) mod n for 0 <= x, d < n.
__device__ __forceinline__ int wrap_add(int x, int d, int n) {
  const int y = x + d;
  return y >= n ? y - n : y;
}
__device__ __forceinline__ int wrap_sub(int x, int d, int n) {
  const int y = x - d;
  return y < 0 ? y + n : y;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tile's [rows, w] 32-bit cells (contiguous at src) into stage rows of
// stride s words, lanes over cells, by cp.async; cp_async_wait_all and a
// __syncwarp() make them visible.
__device__ __forceinline__ void stage_in(uint32_t* dst, int s, const uint32_t* src,
                                         int rows, int w, uint32_t wdiv, int lane) {
  const int tot = rows * w;
  for (int e = lane; e < tot; e += 32)
    cp_async4(dst + e + row_of(e, w, wdiv) * (s - w), src + e);
}
// And back out, coalesced.
__device__ __forceinline__ void stage_out(uint32_t* dst, const uint32_t* src, int s,
                                          int rows, int w, uint32_t wdiv, int lane) {
  const int tot = rows * w;
  for (int e = lane; e < tot; e += 32) dst[e] = src[e + row_of(e, w, wdiv) * (s - w)];
}

// ---------------------------------------------------------------------------
// (A) probe_send
//
// Per tile: (A1) lanes over cells: suspicion expiry into view_mid and
// o_sseen, the tile's meta staged in shared memory, the tile's latency
// window copied to the output; (A2) one row per lane: the probe window,
// probe launch (candidates from the staged meta), round trips and relays,
// the ack merge, the median filter and Vivaldi, the gossip send gates, the
// top-P peel by remaining budget over the staged row and the budget
// decrement there, the payload, the serf sender side and the row's
// scalars; (A3) the probe-order reshuffle of each wrapped row (a rank per
// column, lanes over its columns), then lanes over cells: meta from the
// staged tile, and the sentinel's RTT scan. __syncwarp() separates the
// phases: each reads cells another lane wrote.
// ---------------------------------------------------------------------------

// The staged meta of a tile (order and budget; the status bits are free
// for A2's pick marks): rows of meta_stride(K) uint16, an odd number of
// 32-bit words, so that 32 lanes each reading its own row at one column
// hit 32 banks; at most META_CELLS per warp.
#define META_CELLS 2176
__host__ __device__ __forceinline__ int meta_stride(int K) {
  const int words = (K + 1) / 2;
  return 2 * (words | 1);
}
__host__ __device__ __forceinline__ int probe_tile_rows(int K) {
  const int rows = META_CELLS / meta_stride(K);
  return rows < 32 ? rows : 32;
}

// A warp's queue of direct acks waiting for their Vivaldi update: row,
// target and median RTT sample. Queued rows of a warp are distinct, and
// nothing else in A reads or writes their Vivaldi leaves after A1.
struct VivQueue {
  int row[32], tgt[32];
  float med[32];
};

// Runs the queued updates, one row per lane; returns this lane's count of
// rows whose coordinates are non-finite after it (with the sentinel).
__device__ int viv_drain(const TickArgs& a, const VivQueue* q, int len, int lane,
                         bool sentinel) {
  __syncwarp();
  int bad = 0;
  if (lane < len) bad = viv_observe(a, q->row[lane], q->tgt[lane], true, q->med[lane],
                                    sentinel);
  __syncwarp();
  return sentinel ? bad : 0;
}

__global__ void __launch_bounds__(WARPS * 32, 2) k_probe_send(TickArgs a, int tile_rows) {
  __shared__ int smem[N_CNT];
  __shared__ uint16_t s_meta[WARPS][META_CELLS];
  __shared__ float s_pu[WARPS][MAXK];
  __shared__ VivQueue s_viv[WARPS];
  for (int k = threadIdx.x; k < N_CNT; k += blockDim.x) smem[k] = 0;
  __syncthreads();
  Tally tl;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = a.i[I_N];
  const int K = a.i[I_K], S = a.i[I_S], WD = a.i[I_WD], IC = a.i[I_IC];
  const int D = a.i[I_D], W = a.i[I_W];
  const int FAN = a.i[I_FAN], P = a.i[I_P];
  const int amax = a.i[I_AWARE_MAX], pperiod = a.i[I_PROBE_PERIOD];
  const int susp_k = a.i[I_SUSP_K];
  const int RS = meta_stride(K);
  const uint32_t kdiv = 0xFFFFFFFFu / static_cast<uint32_t>(K) + 1u;
  const float pl = a.f[F_PLOSS];
  const int t = *ptr<const int32_t>(a, P_IN + L_T);
  const int32_t* off = ptr<const int32_t>(a, P_OFF);
  const bool chaos = a.i[I_CHAOS] != 0, sentinel = a.i[I_SENTINEL] != 0;
  const float keep = a.f[F_KEEP];
  const float logk1 = logf(static_cast<float>(susp_k) + 1.0f);

  const uint16_t* in_vinc = ptr<const uint16_t>(a, P_IN + L_VINC);
  const uint16_t* in_meta = ptr<const uint16_t>(a, P_IN + L_META);
  const uint16_t* in_sdelta = ptr<const uint16_t>(a, P_IN + L_SDELTA);
  const uint32_t* in_sseen = ptr<const uint32_t>(a, P_IN + L_SSEEN);
  const uint16_t* in_lcnt = ptr<const uint16_t>(a, P_IN + L_LCNT);
  const uint8_t* in_lbuf = ptr<const uint8_t>(a, P_IN + L_LBUF);
  uint32_t* vmid = ptr<uint32_t>(a, P_VMID);
  uint32_t* o_sseen = ptr<uint32_t>(a, P_OUT + L_SSEEN);
  uint16_t* o_meta = ptr<uint16_t>(a, P_OUT + L_META);
  uint16_t* o_lcnt = ptr<uint16_t>(a, P_OUT + L_LCNT);
  uint8_t* o_lbuf = ptr<uint8_t>(a, P_OUT + L_LBUF);
  uint16_t* tmeta = s_meta[wib];
  VivQueue* wq = &s_viv[wib];
  int q_len = 0;

  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x * WARPS + wib; tile < ntiles; tile += gridDim.x * WARPS) {
    const int base = tile * tile_rows;
    const int rows = min(tile_rows, n - base);
    const bool valid = lane < rows;
    const int i = base + (valid ? lane : 0);
    const size_t rb = static_cast<size_t>(i) * K;
    const size_t eb = static_cast<size_t>(base) * K;
    const int tot = rows * K;

    // The row scalars the cell phases need.
    const uint8_t fl = flags_at(a, i);
    const bool alive = fl & 1, left = fl & 2, leaving = fl & 4, external = fl & 8;
    const bool active = valid && alive && !left && !external;
    const Terms me = chaos ? terms_at(a, i) : Terms{0, 0, 0, 1.0f, 1.0f};

    // A1. Suspicion expiry, lanes over the tile's cells; meta staged.
    for (int e00 = 0; e00 < tot; e00 += 32 * UNROLL) {
      uint32_t vi[UNROLL], seen[UNROLL];
      uint16_t mt[UNROLL], sd[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e00 + 32 * u + lane;
        if (e < tot) {
          vi[u] = in_vinc[eb + e];
          mt[u] = in_meta[eb + e];
          seen[u] = in_sseen[eb + e];
          sd[u] = in_sdelta[eb + e];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e00 + 32 * u + lane;
        const int j = row_of(e, K, kdiv);
        const bool act = __shfl_sync(FULL, active, j & 31);
        const int color = chaos ? __shfl_sync(FULL, me.color, j & 31) : 0;
        if (e >= tot) continue;
        const int c = e - j * K;
        tmeta[j * RS + c] = static_cast<uint16_t>(mt[u] & 0xFFFCu);
        const uint32_t st = mt[u] & 3u;
        uint32_t key = mk(vi[u], st);
        const int sstart = sd[u] == 65535 ? -1 : t - static_cast<int>(sd[u]);
        if (act && st == SUSPECT && sstart >= 0) {
          int conf = __popc(seen[u]) - 1;
          conf = conf < 0 ? 0 : conf;
          float elapsed = static_cast<float>(t - sstart);
          float frac = susp_k > 0
              ? logf(static_cast<float>(conf) + 1.0f) / logk1 : 1.0f;
          float raw = a.f[F_SUSP_MAX] - frac * a.f[F_SUSP_DIFF];
          float rem = fmaxf(raw, a.f[F_SUSP_MIN]) - elapsed;
          if (rem <= 0.0f) {
            key = mk(vi[u], DEAD);
            tl.add(C_DEATHS, 1);
            if (chaos) {  // a false death: the subject is up and reachable
              const int sr = (base + j + off[c]) % n;
              const uint8_t sf = flags_at(a, sr);
              tl.add(C_FALSE_DEATHS, (sf & 1) && !(sf & 2) &&
                                         ptr<const int32_t>(a, P_CCOLOR)[sr] == color);
            }
          }
        }
        vmid[eb + e] = key;
        o_sseen[eb + e] = seen[u];
      }
    }
    // The latency window goes to the output as it is; A2 then writes the
    // one sample and count a direct ack adds.
    warp_copy(reinterpret_cast<uint8_t*>(o_lcnt + eb),
              reinterpret_cast<const uint8_t*>(in_lcnt + eb),
              static_cast<size_t>(tot) * 2, lane);
    warp_copy(o_lbuf + eb * S, in_lbuf + eb * S, static_cast<size_t>(tot) * S, lane);
    // So do the Vivaldi leaves; an accepted observation overwrites its row.
    for (int leaf = L_VEC; leaf <= L_VRES; ++leaf) {
      const size_t width = leaf == L_VEC ? 2 * D : leaf == L_VSAMP ? W
                           : (leaf == L_VIDX || leaf == L_VRES) ? 1 : 2;
      warp_copy(ptr<uint8_t>(a, P_OUT + leaf) + base * width,
                ptr<const uint8_t>(a, P_IN + leaf) + base * width,
                static_cast<size_t>(rows) * width, lane);
    }
    __syncwarp();

    // A2. One row per lane, over its staged meta row. Results A3 reads:
    // wrapped, and for the sentinel direct_ok, col_c, slot, rtt_obs.
    bool wrapped = false, direct_ok = false;
    int col_c = 0, slot = 0, tgt = 0;
    float rtt_obs = 0.0f, med = -1.0f;
    if (valid) {
      uint16_t* mrow = tmeta + lane * RS;
      const uint32_t own_inc = inc_at(a, i);
      int own_tx = (chaos && (fl & REVIVED)) ? a.i[I_OWN_LIMIT]
                                             : ptr<const uint8_t>(a, P_IN + L_OWN_TX)[i];
      int aw = ptr<const uint8_t>(a, P_IN + L_AWARE)[i];
      const int ptr0 = ptr<const uint8_t>(a, P_IN + L_PTR)[i];
      int next_probe = t + ptr<const int16_t>(a, P_IN + L_NEXT)[i];
      const uint8_t pc8 = ptr<const uint8_t>(a, P_IN + L_PCOL)[i];
      int pcol = pc8 == 255 ? -1 : static_cast<int>(pc8);
      int pfail = t + ptr<const int16_t>(a, P_IN + L_PFAIL)[i];
      int nack = ptr<const uint8_t>(a, P_IN + L_NACK)[i];

      // Probe windows closing with no ack.
      const bool failing = pcol >= 0 && t >= pfail && active;
      int add = 0;
      if (failing) {
        tl.add(C_TIMEOUTS, 1);
        if (pcol < K) {  // a column past K (corrupt input) suspects nothing
          uint32_t fkey = vmid[rb + pcol];
          vmid[rb + pcol] = max(fkey, mk(kinc(fkey), SUSPECT));
          o_sseen[rb + pcol] |= 1u << (static_cast<uint32_t>(i) % 32u);
        }
        add = 1 + nack;
        pcol = -1;
        nack = 0;
      }
      aw = clampi(aw + add, 0, amax - 1);

      // Probe launch.
      const bool probing = active && t >= next_probe;
      int cand[3];
      bool cok[3];
      for (int k = 0; k < 3; ++k) {
        cand[k] = mrow[(ptr0 + k) % K] >> 8;
        cok[k] = contactable(vmid[rb + cand[k]]);
      }
      const bool has_target = (cok[0] || cok[1] || cok[2]) && probing;
      const int first_ok = cok[0] ? 0 : (cok[1] ? 1 : (cok[2] ? 2 : 0));
      const int target_col = cand[first_ok];
      const int advance = probing ? (has_target ? first_ok + 1 : 3) : 0;

      const int tcol = has_target ? target_col : 0;
      tgt = (i + off[tcol]) % n;
      bool target_up = false, ok_direct = false, any_relay_ok = false;
      bool ok_tcp = false;
      int nack_rcvd = 0;
      // The round trips, relays and their draws only for a row with a
      // target.
      if (has_target) {
        const uint8_t tfl = flags_at(a, tgt);
        target_up = (tfl & 1) && !(tfl & 2);
        const Terms tt = chaos ? terms_at(a, tgt) : me;
        const float* pos = ptr<const float>(a, P_POS);
        const float* hgt = ptr<const float>(a, P_HEIGHT);
        float acc = 0.0f;
        for (int k = 0; k < WD; ++k) {
          float df = pos[static_cast<size_t>(i) * WD + k] -
                     pos[static_cast<size_t>(tgt) * WD + k];
          acc += df * df;
        }
        const float true_rtt = sqrtf(acc) + hgt[i] + hgt[tgt];
        const float jf = a.f[F_JITTER_FRAC];
        rtt_obs = jf > 0.0f
            ? true_rtt * expf(ptr<const float>(a, P_JITTER)[i] * jf) : true_rtt;
        const float* u2 = ptr<const float>(a, P_U2);
        // Under a schedule each round trip composes both directions' terms
        // onto its one draw.
        ok_direct = chaos ? pair_ok(a, me, tt, u2[2 * i], keep, true)
                          : u2[2 * i] >= pl;
        ok_tcp = chaos ? pair_ok(a, me, tt, u2[2 * i + 1], keep, true)
                       : u2[2 * i + 1] >= pl;
        const int64_t* relay = ptr<const int64_t>(a, P_RELAY);
        const float* ua = ptr<const float>(a, P_UA);
        const float* ub = ptr<const float>(a, P_UB);
        const float* uc = ptr<const float>(a, P_UC);
        for (int r = 0; r < IC; ++r) {
          const int rrow = (i + off[relay[r]]) % n;
          const uint8_t rf = flags_at(a, rrow);
          const bool ravail = (rf & 1) && !(rf & 2) && !(rf & 8);
          const size_t u = static_cast<size_t>(i) * IC + r;
          bool oka = ua[u] >= pl, okb = ub[u] >= pl, okc = uc[u] >= pl;
          if (chaos) {
            const Terms rt = terms_at(a, rrow);
            oka = pair_ok(a, me, rt, ua[u], keep, false);
            okb = pair_ok(a, rt, tt, ub[u], keep, true);
            okc = pair_ok(a, rt, me, uc[u], keep, false);
          }
          const bool reached = ravail && oka;
          if (reached && target_up && okb) any_relay_ok = true;
          if (reached && !(target_up && okb) && okc) ++nack_rcvd;
        }
      }
      direct_ok = has_target && target_up && rtt_obs <= a.f[F_TIMEOUT] && ok_direct;
      const bool indirect_ok = has_target && any_relay_ok && !direct_ok;
      const bool tcp_ok = has_target && target_up && ok_tcp;
      const bool acked = direct_ok || indirect_ok || tcp_ok;
      tl.add(C_PROBES, has_target);
      tl.add(C_ACKS, acked);
      if (has_target && !direct_ok) tl.add(C_NACKS, nack_rcvd);

      // Compound ping+suspect poke (delivered in B).
      const uint32_t tentry = vmid[rb + tcol];
      const uint32_t tstatus = has_target ? kst(tentry) : 0u;
      const bool poke_flag = has_target && tstatus == SUSPECT && ok_direct;
      ptr<uint32_t>(a, P_POKE)[i] = poke_flag
          ? (0x80000000u | (static_cast<uint32_t>(target_col) << 16) |
             (kinc(tentry) & 0xFFFFu))
          : 0u;

      if (has_target && !acked) {
        pcol = target_col;
        pfail = t + pperiod;
        nack = IC - nack_rcvd;
      }
      if (probing) next_probe = t + pperiod * (aw + 1);
      aw = clampi(aw - (acked ? 1 : 0), 0, amax - 1);
      int ptr1 = ptr0 + advance;
      wrapped = ptr1 >= K;
      if (wrapped) ptr1 = 0;
      if (acked) {
        const uint32_t ak = mk(inc_at(a, tgt), ALIVE);
        vmid[rb + target_col] = max(vmid[rb + target_col], ak);
      }

      // Vivaldi observation: median filter, then the update.
      col_c = direct_ok ? target_col : 0;
      const int cnt = in_lcnt[rb + col_c];
      slot = cnt % S;
      const size_t lb = (rb + col_c) * S;
      if (direct_ok) {
        o_lbuf[lb + slot] = ftof8(rtt_obs);
        o_lcnt[rb + col_c] = static_cast<uint16_t>(min(cnt + 1, 65535));
        const int filled = min(cnt + 1, S);
        float v[MAXS];
        for (int s = 0; s < S; ++s)
          v[s] = s >= filled ? __int_as_float(0x7f800000)
                             : (s == slot ? rtt_obs : f8tof(in_lbuf[lb + s]));
        // Insertion sort, ascending, NaN above every number (as
        // torch.sort orders them: a NaN sample is corrupt state).
        for (int x = 1; x < S; ++x) {
          float key = v[x];
          int y = x - 1;
          while (y >= 0 && (v[y] > key || (isnan(v[y]) && !isnan(key)))) {
            v[y + 1] = v[y];
            --y;
          }
          v[y + 1] = key;
        }
        med = v[filled / 2];
      }
      // A direct ack's Vivaldi update waits in the warp's queue (below);
      // the sentinel checks every other row's coordinates here (and the
      // written RTT slots in A3).
      if (sentinel && !direct_ok)
        tl.add(C_SCOORD, viv_observe(a, i, tgt, false, med, true));

      // Gossip sender side, on the view after the ack merge: the send
      // gates, then top-P by remaining budget (max value, lowest column on
      // ties) over the staged row, marking picks in its status bits (A3
      // clears them), the payload and the picked budgets' decrement.
      uint32_t sbits_f = 0;
      int n_sends = 0;
      for (int f = 0; f < FAN; ++f) {
        const int jc = gossip_col(a, t, f);
        if (active && contactable(vmid[rb + jc])) {
          sbits_f |= 1u << f;
          ++n_sends;
        }
      }
      int scol[MAXP];
      uint32_t vbits = 0;
      int nvalid = 0;
#pragma unroll
      for (int q = 0; q < MAXP; ++q) {
        scol[q] = 0;
        if (q >= P) continue;
        int best = -1, bv = 0;
        for (int c = 0; c < K; ++c) {
          const uint16_t m = mrow[c];
          if (m & 1u) continue;
          const int b = active ? ((m >> 2) & 63) : 0;
          if (best < 0 || b > bv) {
            best = c;
            bv = b;
          }
        }
        best = best < 0 ? 0 : best;
        mrow[best] |= 1u;
        scol[q] = best;
        if (bv > 0) {
          vbits |= 1u << q;
          ++nvalid;
        }
      }
      const bool own_sendable = own_tx > 0 && active;
      tl.add(C_GTX, n_sends);
      tl.add(C_GMSGS, n_sends * (nvalid + (own_sendable ? 1 : 0)));
      uint8_t* pscol = ptr<uint8_t>(a, P_PSCOL);
      uint32_t* pskey = ptr<uint32_t>(a, P_PSKEY);
      uint32_t* psbits = ptr<uint32_t>(a, P_PSBITS);
#pragma unroll
      for (int q = 0; q < MAXP; ++q) {
        if (q >= P) continue;
        const size_t pq = static_cast<size_t>(i) * P + q;
        pscol[pq] = static_cast<uint8_t>(scol[q]);
        pskey[pq] = vmid[rb + scol[q]];
        psbits[pq] = o_sseen[rb + scol[q]];
        if ((vbits >> q) & 1u) {
          const uint16_t m = mrow[scol[q]];
          const int tx = max(((m >> 2) & 63) - n_sends, 0);
          mrow[scol[q]] = static_cast<uint16_t>((m & ~(63u << 2)) | (tx << 2));
        }
      }
      ptr<uint16_t>(a, P_PFLAGS)[i] = static_cast<uint16_t>(
          sbits_f | (vbits << 8) | (own_sendable ? 0x8000u : 0u));
      ptr<uint32_t>(a, P_POWNK)[i] = mk(own_inc, (leaving || left) ? LEFT : ALIVE);
      if (own_sendable) own_tx = max(own_tx - n_sends, 0);

      // Serf sender side: the fused event plane's payload for D.
      if (a.i[I_SERF]) {
        uint32_t xbits = 0;
        for (int f = 0; f < FAN; ++f) {
          const int jc = gossip_col(a, t, f);
          if (alive && !left && contactable(vmid[rb + jc])) xbits |= 1u << f;
        }
        const int E = a.i[I_E], PE = a.i[I_PE], Q = a.i[I_Q];
        const size_t eq = static_cast<size_t>(i) * E;
        int order[MAXPE], mtx[MAXPE];
        serf_peel(a, eq, E, PE, order, mtx);
        uint32_t* xkey = ptr<uint32_t>(a, P_XKEY);
        int32_t* xorig = ptr<int32_t>(a, P_XORIG);
        const uint32_t* ekey = ptr<const uint32_t>(a, P_SIN + S_EKEY);
        for (int q = 0; q < PE; ++q) {
          const uint32_t key = ekey[eq + order[q]];
          xkey[static_cast<size_t>(i) * PE + q] = key;
          xorig[static_cast<size_t>(i) * PE + q] =
              load_origin(a, P_SIN + S_EORIG, eq + order[q]);
          if (key > 0u && mtx[q] > 0) xbits |= 1u << (8 + q);
        }
        ptr<uint16_t>(a, P_XFLAGS)[i] = static_cast<uint16_t>(xbits);
        const size_t qb = static_cast<size_t>(i) * Q;
        for (int q = 0; q < Q; ++q) {
          ptr<int32_t>(a, P_SOUT + S_QRESP)[qb + q] =
              ptr<const int32_t>(a, P_SIN + S_QRESP)[qb + q];
          ptr<int32_t>(a, P_SOUT + S_QACK)[qb + q] =
              ptr<const int32_t>(a, P_SIN + S_QACK)[qb + q];
        }
      }

      // Fields no later phase changes, packed against t + 1. The probe
      // deadline is canonicalized to t while no probe is outstanding.
      if (pcol < 0) pfail = t;
      ptr<uint8_t>(a, P_OUT + L_FLAGS)[i] = static_cast<uint8_t>(fl & ~REVIVED);
      ptr<uint8_t>(a, P_OUT + L_OWN_TX)[i] = static_cast<uint8_t>(own_tx);
      ptr<uint8_t>(a, P_OUT + L_AWARE)[i] = static_cast<uint8_t>(aw);
      ptr<uint8_t>(a, P_OUT + L_PTR)[i] = static_cast<uint8_t>(ptr1);
      ptr<int16_t>(a, P_OUT + L_NEXT)[i] =
          static_cast<int16_t>(clampi(next_probe - (t + 1), -32768, 32767));
      ptr<uint8_t>(a, P_OUT + L_PCOL)[i] =
          static_cast<uint8_t>(pcol < 0 ? 255 : pcol);
      ptr<int16_t>(a, P_OUT + L_PFAIL)[i] =
          static_cast<int16_t>(clampi(pfail - (t + 1), -32768, 32767));
      ptr<uint8_t>(a, P_OUT + L_NACK)[i] =
          static_cast<uint8_t>(clampi(nack, 0, 255));
    }
    __syncwarp();

    // Direct acks join the warp's Vivaldi queue, which runs (one queued
    // row per lane) whenever the next tile's acks would overflow it.
    const uint32_t dm = __ballot_sync(FULL, direct_ok);
    if (q_len + __popc(dm) > 32) {
      tl.add(C_SCOORD, viv_drain(a, wq, q_len, lane, sentinel));
      q_len = 0;
    }
    if (direct_ok) {
      const int at = q_len + __popc(dm & ((1u << lane) - 1u));
      wq->row[at] = i;
      wq->tgt[at] = tgt;
      wq->med[at] = med;
    }
    q_len += __popc(dm);
    __syncwarp();

    // A3. Probe order: a wrapped row's is the stable ascending order of this
    // tick's uniforms (column c's rank: the columns below it, and those
    // equal to it at a lower index), one wrapped row at a time with the
    // lanes over its columns; every other row keeps its order.
    const float* perm_u = ptr<const float>(a, P_PERMU);
    for (uint32_t wr = __ballot_sync(FULL, wrapped); wr; wr &= wr - 1u) {
      const int j = __ffs(wr) - 1;
      const float* pu = perm_u + static_cast<size_t>(base + j) * K;
      for (int c = lane; c < K; c += 32) s_pu[wib][c] = pu[c];
      __syncwarp();
      uint16_t* mrow = tmeta + j * RS;
      for (int c = lane; c < K; c += 32) {
        const float x = s_pu[wib][c];
        int rank = 0;
        for (int c2 = 0; c2 < K; ++c2) {
          const float y = s_pu[wib][c2];
          rank += (y < x) || (y == x && c2 < c);
        }
        mrow[rank] = static_cast<uint16_t>((mrow[rank] & 0x00FFu) | (c << 8));
      }
      __syncwarp();
    }
    // meta out (status bits clear: C sets them), lanes over the tile's
    // cells; with the sentinel, the non-finite written RTT slots, this
    // tick's sample in its slot.
    const int sflags = (direct_ok ? 1 : 0) | (col_c << 1);
    for (int e0 = 0; e0 < tot; e0 += 32) {
      const int e = e0 + lane;
      const int j = row_of(e, K, kdiv);
      int fj = 0, slot_j = 0;
      float rtt_j = 0.0f;
      if (sentinel) {
        fj = __shfl_sync(FULL, sflags, j & 31);
        slot_j = __shfl_sync(FULL, slot, j & 31);
        rtt_j = __shfl_sync(FULL, rtt_obs, j & 31);
      }
      if (e >= tot) continue;
      const int c = e - j * K;
      o_meta[eb + e] = static_cast<uint16_t>(tmeta[j * RS + c] & 0xFFFCu);
      if (sentinel) {
        const bool here = (fj & 1) && c == (fj >> 1);
        const int cnt = in_lcnt[eb + e];
        const int written = min(here ? min(cnt + 1, 65535) : cnt, S);
        for (int s = 0; s < written; ++s) {
          const float x = (here && s == slot_j) ? rtt_j
                                                : f8tof(in_lbuf[(eb + e) * S + s]);
          tl.add(C_SRTT, !isfinite(x));
        }
      }
    }
    __syncwarp();
  }
  tl.add(C_SCOORD, viv_drain(a, wq, q_len, lane, sentinel));
  tl.flush(smem, lane);
  block_flush(smem, ptr<int>(a, P_CNT));
}

// ---------------------------------------------------------------------------
// (B) receive, in warp tiles
//
// Per tile of up to 32 rows, one row per lane: each leg's arrival (the
// senders of consecutive rows are consecutive rows, so the reads of their
// flags and payloads are coalesced across lanes), the merges in the
// reference's order into the row's view_mid cells, the Lifeguard
// confirmations against the post-merge row (o_sseen ORs in place), the
// refute claim and the poke scan over the K in-neighbours (consecutive
// rows across lanes for each column). The tick's offsets and gossip
// columns sit in shared memory and every displacement wraps by one
// compare, not an integer division. The merges stay read-modify-writes of
// the touched cells: staging the tile's view_mid rows in shared memory
// and writing them back cost more than the scattered cells it saved, in
// every state measured (PERF.md, section 6).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WARPS * 32) k_receive(TickArgs a, int tile_rows) {
  __shared__ int smem[N_CNT];
  __shared__ int s_off[MAXK];
  __shared__ int s_gcol[MAXFAN];
  const int t = *ptr<const int32_t>(a, P_IN + L_T);
  const int K = a.i[I_K], FAN = a.i[I_FAN];
  for (int k = threadIdx.x; k < N_CNT; k += blockDim.x) smem[k] = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_off[k] = ptr<const int32_t>(a, P_OFF)[k];
  if (threadIdx.x < MAXFAN)
    s_gcol[threadIdx.x] = static_cast<int>(threadIdx.x) < FAN ? gossip_col(a, t, threadIdx.x)
                                                               : 0;
  __syncthreads();
  Tally tl;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = a.i[I_N], P = a.i[I_P];
  const float pl = a.f[F_PLOSS], keep = a.f[F_KEEP];
  const bool chaos = a.i[I_CHAOS] != 0;
  const int32_t* rcol = ptr<const int32_t>(a, P_RCOL);
  const int32_t* inv = ptr<const int32_t>(a, P_INV);
  const uint16_t* pflags = ptr<const uint16_t>(a, P_PFLAGS);
  const uint8_t* pscol = ptr<const uint8_t>(a, P_PSCOL);
  const uint32_t* pskey = ptr<const uint32_t>(a, P_PSKEY);
  const uint32_t* psbits = ptr<const uint32_t>(a, P_PSBITS);
  const uint32_t* pownk = ptr<const uint32_t>(a, P_POWNK);
  const uint32_t* poke = ptr<const uint32_t>(a, P_POKE);
  const float* udrop = ptr<const float>(a, P_UDROP);
  uint32_t* vmid = ptr<uint32_t>(a, P_VMID);
  uint32_t* o_sseen = ptr<uint32_t>(a, P_OUT + L_SSEEN);

  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x * WARPS + wib; tile < ntiles; tile += gridDim.x * WARPS) {
    const int base = tile * tile_rows;
    const int rows = min(tile_rows, n - base);
    const bool valid = lane < rows;
    const int r = base + (valid ? lane : 0);
    if (!valid) continue;
    const size_t rb = static_cast<size_t>(r) * K;

    // Which legs arrived.
    const uint8_t fl = flags_at(a, r);
    const bool recv_up = (fl & 1) && !(fl & 2);
    const Terms me = chaos ? terms_at(a, r) : Terms{0, 0, 0, 1.0f, 1.0f};
    uint32_t arrived_bits = 0;
    int n_rx = 0, n_cdrop = 0;
    for (int f = 0; f < FAN; ++f) {
      const int s = wrap_sub(r, s_off[s_gcol[f]], n);
      const uint16_t pf = pflags[s];
      const float u = udrop[static_cast<size_t>(r) * FAN + f];
      const bool sent = (pf >> f) & 1;
      bool ok_leg = u >= pl;
      if (chaos) {  // one-way sender -> receiver on the leg's drop draw
        ok_leg = pair_ok(a, terms_at(a, s), me, u, keep, false);
        n_cdrop += sent && recv_up && u >= pl && !ok_leg;
      }
      if (!(sent && ok_leg && recv_up)) continue;
      arrived_bits |= 1u << f;
      ++n_rx;
    }
    tl.add(C_GRX, n_rx);
    tl.add(C_CDROPPED, n_cdrop);

    // Merges in the reference's order, then confirmations, refute, pokes.
    const uint32_t own_inc = inc_at(a, r);
    uint32_t refute = 0;
    for (int f = 0; f < FAN; ++f) {
      if (!((arrived_bits >> f) & 1)) continue;
      const int jc = s_gcol[f];
      const int s = wrap_sub(r, s_off[jc], n);
      const uint16_t pf = pflags[s];
      for (int q = 0; q < P; ++q) {
        if (!((pf >> (8 + q)) & 1)) continue;
        const size_t sq = static_cast<size_t>(s) * P + q;
        const uint32_t key = pskey[sq];
        const int mycol = rcol[jc * K + pscol[sq]];
        if (mycol == SELF_COL) {
          if (refutes(key, own_inc)) refute = max(refute, kinc(key));
        } else if (mycol >= 0) {
          vmid[rb + mycol] = max(vmid[rb + mycol], key);
        }
      }
      if (pf & 0x8000u) {
        const int icol = inv[jc];
        vmid[rb + icol] = max(vmid[rb + icol], pownk[s]);
      }
    }
    // Lifeguard confirmations against the post-merge view.
    for (int f = 0; f < FAN; ++f) {
      if (!((arrived_bits >> f) & 1)) continue;
      const int jc = s_gcol[f];
      const int s = wrap_sub(r, s_off[jc], n);
      const uint16_t pf = pflags[s];
      for (int q = 0; q < P; ++q) {
        if (!((pf >> (8 + q)) & 1)) continue;
        const size_t sq = static_cast<size_t>(s) * P + q;
        const int mycol = rcol[jc * K + pscol[sq]];
        if (mycol < 0) continue;
        const uint32_t key = pskey[sq];
        const uint32_t post = vmid[rb + mycol];
        if (kst(key) == SUSPECT && kst(post) == SUSPECT && kinc(key) >= kinc(post))
          o_sseen[rb + mycol] |= psbits[sq];
      }
    }
    // Pokes: was I probed by an in-neighbor that believes me suspect?
    uint32_t claim = 0;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const uint32_t w = poke[wrap_sub(r, s_off[j], n)];
      if ((w >> 31) && static_cast<int>((w >> 16) & 0xFFu) == j)
        claim = max(claim, w & 0xFFFFu);
    }
    const uint32_t refute_poke =
        (claim >= own_inc && recv_up && claim > 0) ? claim : 0u;
    ptr<uint32_t>(a, P_REFUTE)[r] = max(refute, refute_poke);
  }
  tl.flush(smem, lane);
  block_flush(smem, ptr<int>(a, P_CNT));
}

// ---------------------------------------------------------------------------
// (C) pushpull: push-pull, refutation, reconciliation, budget re-arm, pack.
//
// Per tile: (C1) one row per lane: the push-pull decisions (the row's own
// pull, and the initiator s's push recomputed from its row) and the
// refutation; (C2) lanes over the tile's cells: the merge against the
// partner's and the initiator's view rows (permutations within one row:
// one or two lines per warp load), reconciliation, re-arm and pack, the
// SLO indicators and the sentinel's cell checks; (C3) one row per lane:
// the sentinel's row checks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool is_up(uint8_t fl) { return (fl & 1) && !(fl & 2); }
__device__ __forceinline__ bool is_active(uint8_t fl) {
  return (fl & 1) && !(fl & 2) && !(fl & 8);
}
__device__ __forceinline__ bool pp_due(int x, uint8_t fl, int t, int pp) {
  const int stagger = floor_mod(
      static_cast<int32_t>(static_cast<uint32_t>(x) * 0x9E3779B9u), pp);
  return is_active(fl) && floor_mod(t + stagger, pp) == 0;
}

__global__ void __launch_bounds__(WARPS * 32) k_pushpull(TickArgs a, int tile_rows) {
  __shared__ int smem[N_CNT];
  __shared__ int slo_bits;  // the block's OR of the rows' SLO indicators
  __shared__ uint32_t s_bad[WARPS];  // bit j: a cell of tile row j out of range
  if (threadIdx.x == 0) slo_bits = 0;
  for (int k = threadIdx.x; k < N_CNT; k += blockDim.x) smem[k] = 0;
  __syncthreads();
  Tally tl;
  uint32_t row_bits = 0;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const bool chaos = a.i[I_CHAOS] != 0, sentinel = a.i[I_SENTINEL] != 0;
  const int n = a.i[I_N];
  const int K = a.i[I_K], pp = a.i[I_PP_PERIOD];
  const int amax = a.i[I_AWARE_MAX];
  const uint32_t kdiv = 0xFFFFFFFFu / static_cast<uint32_t>(K) + 1u;
  const int t = *ptr<const int32_t>(a, P_IN + L_T);
  const int32_t* off = ptr<const int32_t>(a, P_OFF);
  const int32_t* rcol = ptr<const int32_t>(a, P_RCOL);
  const int32_t* inv = ptr<const int32_t>(a, P_INV);
  const uint16_t* in_vinc = ptr<const uint16_t>(a, P_IN + L_VINC);
  const uint16_t* in_meta = ptr<const uint16_t>(a, P_IN + L_META);
  const uint16_t* in_sdelta = ptr<const uint16_t>(a, P_IN + L_SDELTA);
  const uint32_t* in_sseen = ptr<const uint32_t>(a, P_IN + L_SSEEN);
  const uint32_t* vmid = ptr<const uint32_t>(a, P_VMID);
  uint16_t* o_meta = ptr<uint16_t>(a, P_OUT + L_META);
  uint32_t* o_sseen = ptr<uint32_t>(a, P_OUT + L_SSEEN);
  uint16_t* o_vinc = ptr<uint16_t>(a, P_OUT + L_VINC);
  uint16_t* o_sdelta = ptr<uint16_t>(a, P_OUT + L_SDELTA);
  uint8_t* o_own_tx = ptr<uint8_t>(a, P_OUT + L_OWN_TX);
  uint8_t* o_aw = ptr<uint8_t>(a, P_OUT + L_AWARE);
  const int tx_limit = a.i[I_TX_LIMIT];

  const int j = static_cast<int>(*ptr<const int64_t>(a, P_PPJ));
  const int shift = off[j];
  const int icol = inv[j];
  auto ownk = [&](int x) {
    return mk(inc_at(a, x), (flags_at(a, x) & 6) ? LEFT : ALIVE);
  };

  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x * WARPS + wib; tile < ntiles; tile += gridDim.x * WARPS) {
    const int base = tile * tile_rows;
    const int rows = min(tile_rows, n - base);
    const bool valid = lane < rows;
    const int r = base + (valid ? lane : 0);
    const size_t eb = static_cast<size_t>(base) * K;
    const int tot = rows * K;

    // C1. One row per lane: who pulls and pushes, and the refutation.
    const uint8_t fl = flags_at(a, r);
    const uint32_t own_inc = inc_at(a, r);
    const bool active = valid && is_active(fl);
    const Terms me = chaos ? terms_at(a, r) : Terms{0, 0, 0, 1.0f, 1.0f};
    bool init_ok = false, s_ok = false;
    uint32_t ownk_p = 0, ownk_s = 0, new_inc = own_inc;
    if (valid) {
      const int p = (r + shift) % n;          // pull partner
      const int s = (r - shift + n) % n;      // push initiator
      const size_t rb = static_cast<size_t>(r) * K;
      const size_t pb = static_cast<size_t>(p) * K;
      const size_t sb = static_cast<size_t>(s) * K;
      init_ok = pp_due(r, fl, t, pp) && is_up(flags_at(a, p)) &&
                contactable(vmid[rb + j]);
      s_ok = pp_due(s, flags_at(a, s), t, pp) && is_up(fl) &&
             contactable(vmid[sb + j]);
      if (chaos) {
        // One TCP session per initiator, kept iff its round trip clears the
        // initiator's u_pp (no base loss); the initiator s's own session
        // toward r is recomputed from its row.
        const float* upp = ptr<const float>(a, P_UPP);
        init_ok = init_ok && pair_ok(a, me, terms_at(a, p), upp[r], 1.0f, true);
        s_ok = s_ok && pair_ok(a, terms_at(a, s), me, upp[s], 1.0f, true);
      }
      ownk_p = ownk(p);
      ownk_s = ownk(s);
      uint32_t refute_pp = 0;
      if (init_ok) {
        const uint32_t their = vmid[pb + icol];
        if (refutes(their, own_inc)) refute_pp = kinc(their);
      }
      if (s_ok) {
        const uint32_t their2 = vmid[sb + j];
        if (refutes(their2, own_inc)) refute_pp = max(refute_pp, kinc(their2));
      }
      tl.add(C_PP, (init_ok ? 1 : 0) + (s_ok ? 1 : 0));

      // Refutation.
      const uint32_t claim = max(ptr<const uint32_t>(a, P_REFUTE)[r], refute_pp);
      const bool refuting = claim > 0 && active && !(fl & 4);
      tl.add(C_REFUT, refuting);
      new_inc = refuting ? claim + 1 : own_inc;
      if (refuting) {
        o_own_tx[r] = static_cast<uint8_t>(clampi(a.i[I_OWN_LIMIT], 0, 255));
        o_aw[r] = static_cast<uint8_t>(clampi(o_aw[r] + 1, 0, amax - 1));
      }
      ptr<uint16_t>(a, P_OUT + L_OWN_INC)[r] =
          static_cast<uint16_t>(min(new_inc, 65535u));
    }
    if (lane == 0) s_bad[wib] = 0u;
    __syncwarp();

    // C2. Merge, reconcile, re-arm, pack, lanes over the tile's cells; the
    // SLO indicators and the sentinel read the final cells.
    const int rflags = (init_ok ? 1 : 0) | (s_ok ? 2 : 0) | (active ? 4 : 0);
    for (int e00 = 0; e00 < tot; e00 += 32 * UNROLL) {
      int jr[UNROLL], fr[UNROLL];
      uint32_t kp[UNROLL], ks[UNROLL];
      int color[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e00 + 32 * u + lane;
        jr[u] = row_of(e, K, kdiv);
        fr[u] = __shfl_sync(FULL, rflags, jr[u] & 31);
        kp[u] = __shfl_sync(FULL, ownk_p, jr[u] & 31);
        ks[u] = __shfl_sync(FULL, ownk_s, jr[u] & 31);
        color[u] = chaos ? __shfl_sync(FULL, me.color, jr[u] & 31) : 0;
      }
      uint32_t v[UNROLL], ep[UNROLL], es[UNROLL], seen_in[UNROLL], seen_ab[UNROLL];
      uint16_t vi[UNROLL], mt0[UNROLL], sd0[UNROLL], mt[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e00 + 32 * u + lane;
        if (e < tot) {
          const int c = e - jr[u] * K;
          const int row = base + jr[u];
          v[u] = vmid[eb + e];
          ep[u] = es[u] = 0u;
          if (fr[u] & 1) {
            const int rc = rcol[j * K + c];
            const size_t pb = static_cast<size_t>((row + shift) % n) * K;
            ep[u] = c == j ? kp[u] : (rc >= 0 ? vmid[pb + rc] : 0u);
          }
          if (fr[u] & 2) {
            const int rc2 = rcol[icol * K + c];
            const size_t sb = static_cast<size_t>((row - shift + n) % n) * K;
            es[u] = c == icol ? ks[u] : (rc2 >= 0 ? vmid[sb + rc2] : 0u);
          }
          vi[u] = in_vinc[eb + e];
          mt0[u] = in_meta[eb + e];
          sd0[u] = in_sdelta[eb + e];
          seen_in[u] = in_sseen[eb + e];
          seen_ab[u] = o_sseen[eb + e];
          mt[u] = o_meta[eb + e];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e00 + 32 * u + lane;
        if (e >= tot) continue;
        const int c = e - jr[u] * K;
        const int row = base + jr[u];
        const bool act = fr[u] & 4;
        uint32_t vv = v[u];
        if (fr[u] & 1) vv = max(vv, demote(ep[u]));
        if (fr[u] & 2) vv = max(vv, demote(es[u]));
        const uint32_t k0 = mk(vi[u], mt0[u] & 3u);
        const uint32_t st0 = kst(k0), st1 = kst(vv);
        const bool now_s = st1 == SUSPECT;
        const bool fresh = now_s && st0 != SUSPECT;
        const bool re_inc = now_s && st0 == SUSPECT && kinc(vv) > kinc(k0);
        const bool restarted = fresh || re_inc;
        tl.add(C_SUSP, restarted);
        const int sstart0 = sd0[u] == 65535 ? -1 : t - static_cast<int>(sd0[u]);
        const int sstart = restarted ? t : (now_s ? sstart0 : -1);
        uint32_t seen = now_s ? seen_ab[u] : 0u;
        if (re_inc) seen = 1u;
        if (fresh && seen == 0u) seen = 1u;
        const bool changed = vv != k0 || (seen & ~seen_in[u]) != 0u;
        int tx = (mt[u] >> 2) & 63;
        if (changed && act) tx = tx_limit;
        o_vinc[eb + e] = static_cast<uint16_t>(min(kinc(vv), 65535u));
        o_meta[eb + e] = static_cast<uint16_t>(
            (mt[u] & 0xFF00u) | (clampi(tx, 0, 63) << 2) | st1);
        o_sdelta[eb + e] = static_cast<uint16_t>(
            sstart < 0 ? 65535 : clampi(t + 1 - sstart, 0, 65534));
        o_sseen[eb + e] = seen;
        if (chaos) {
          // Subject truth at row + off[c]: unreachable when cut off by a
          // partition or held down; suspected/confirmed from the final view.
          const int sr = (row + off[c]) % n;
          const uint8_t sf = flags_at(a, sr);
          const bool s_alive = sf & 1, s_left = sf & 2;
          const bool cross = ptr<const int32_t>(a, P_CCOLOR)[sr] != color[u];
          const bool suspected = st1 == SUSPECT || st1 == DEAD;
          const bool unreach = act && (cross || (!s_alive && !s_left));
          if (unreach) row_bits |= 1;
          if (unreach && suspected) row_bits |= 2;
          if (unreach && st1 == DEAD) row_bits |= 4;
          if (act && suspected && s_alive && !s_left && !cross) row_bits |= 8;
        }
        if (sentinel) {
          tl.add(C_SMONO, vv < k0);
          const bool armed = sstart >= 0;
          tl.add(C_SSUSP, (now_s != armed) || (now_s != (seen != 0u)));
          if (sstart > t) atomicOr(&s_bad[wib], 1u << jr[u]);
        }
      }
    }
    __syncwarp();

    // C3. The sentinel's row checks, one row per lane.
    if (valid && sentinel) {
      const int aw = o_aw[r];
      const int ptr1 = ptr<const uint8_t>(a, P_OUT + L_PTR)[r];
      const uint8_t pc = ptr<const uint8_t>(a, P_OUT + L_PCOL)[r];
      const int pcol = pc == 255 ? -1 : static_cast<int>(pc);
      const bool bad_range = ((s_bad[wib] >> lane) & 1u) || new_inc > MAX_INCARNATION ||
                             aw < 0 || aw >= amax || ptr1 < 0 || ptr1 >= K ||
                             pcol < -1 || pcol >= K;
      tl.add(C_SRANGE, bad_range);
      tl.add(C_SMONO, new_inc < own_inc ? 1 : 0);
    }
    if (valid && r == 0) *ptr<int32_t>(a, P_OUT + L_T) = t + 1;
    __syncwarp();
  }
  tl.flush(smem, lane);
  row_bits = __reduce_or_sync(FULL, row_bits);
  if (lane == 0 && row_bits) atomicOr(&slo_bits, static_cast<int>(row_bits));
  block_flush(smem, ptr<int>(a, P_CNT));
  if (chaos && threadIdx.x == 0) {
    // Grid-wide SLO indicators: OR the block's word in, then the last
    // block to take a ticket turns the final word into the counters.
    int* slo = ptr<int>(a, P_SLO);
    if (slo_bits) atomicOr(&slo[0], slo_bits);
    __threadfence();
    if (atomicAdd(&slo[1], 1) == static_cast<int>(gridDim.x) - 1) {
      const int bits = atomicOr(&slo[0], 0);
      const bool fault = bits & 1, detected = bits & 2, confirmed = bits & 4;
      const bool wrong = bits & 8;
      bool started = false;  // chaos.fault_started
      for (int q = 0; q < a.i[I_NP]; ++q)
        started = started || ptr<const int32_t>(a, P_PSTART)[q] <= t;
      for (int q = 0; q < a.i[I_NC]; ++q)
        started = started || ptr<const int32_t>(a, P_CSTART)[q] <= t;
      int* cnt = ptr<int>(a, P_CNT);
      if (fault) atomicAdd(&cnt[C_FAULT], 1);
      if (fault && !detected) atomicAdd(&cnt[C_FIRST], 1);
      if (fault && !confirmed) atomicAdd(&cnt[C_CONFIRM], 1);
      if (started && !fault && wrong) atomicAdd(&cnt[C_HEAL], 1);
    }
  }
}

// ---------------------------------------------------------------------------
// (D) serf_post: the post-gossip half of the fused serf tick
//     (serf.py:539-568 and _fused_event_post_body :802-895), in warp tiles.
//
// Per tile of up to 32 rows: (D1) lanes over cells: the tile's event dedup
// buckets and queue staged in shared memory (cp.async for the 32-bit
// leaves), the query buckets copied to the output, and while the copies
// fly the query expiry over [rows, Q] and the reap walk over [rows, K];
// (D2) one row per lane: the quiet leave, delivery, the Lamport witness,
// the query tally, the peel with its budget decrement, retirement and
// intake, on the staged queue and buckets (the query buckets, which only
// query keys touch, in the output); (D3) lanes over cells: the staged
// queue and buckets written out. Stage rows are padded to an odd number
// of words, so 32 lanes on 32 rows at one column hit 32 banks; the intake
// candidates sit in a [candidate][lane] block of the stage.
// ---------------------------------------------------------------------------

#define SWARPS 4              // warps per block of D
#define SERF_WARP_WORDS 4096  // stage words per warp of D (16 KB)

// Words of a tile row in D's stage: event bucket ltimes and signatures,
// queue keys, origins and tx | pending, each padded to an odd count.
__host__ __device__ __forceinline__ int serf_row_words(int E, int R, int O) {
  return (R | 1) + ((R * O) | 1) + 3 * (E | 1);
}
__host__ __device__ __forceinline__ int serf_warp_words(int rows, int E, int R, int O,
                                                        int nc) {
  return rows * serf_row_words(E, R, O) + 64 * nc;
}

// Post-quiet liveness of row x (alive_truth & ~left after the tick's churn
// edges and quiet leaves), from its post-churn flags and leave_at.
__device__ __forceinline__ bool serf_up(const TickArgs& a, int x, int t1) {
  const uint8_t f = flags_at(a, x);
  const int la = ptr<const int32_t>(a, P_SIN + S_LEAVE)[x];
  return (f & 1) && !(f & 2) && !(la >= 0 && t1 >= la);
}

__global__ void __launch_bounds__(SWARPS * 32) k_serf_post(TickArgs a, int tile_rows) {
  extern __shared__ uint32_t s_dyn[];
  __shared__ int smem[N_CNT];
  __shared__ int s_goff[MAXFAN];  // off[] of the tick's gossip columns
  const int t = *ptr<const int32_t>(a, P_IN + L_T);
  for (int k = threadIdx.x; k < N_CNT; k += blockDim.x) smem[k] = 0;
  if (threadIdx.x < MAXFAN)
    s_goff[threadIdx.x] = static_cast<int>(threadIdx.x) < a.i[I_FAN]
        ? ptr<const int32_t>(a, P_OFF)[gossip_col(a, t, threadIdx.x)] : 0;
  __syncthreads();
  Tally tl;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int n = a.i[I_N];
  const int K = a.i[I_K], FAN = a.i[I_FAN];
  const int E = a.i[I_E], R = a.i[I_R], O = a.i[I_O], Q = a.i[I_Q];
  const int PE = a.i[I_PE], RF = a.i[I_RF];
  const int RO = R * O, nc = FAN * PE;
  const bool exact = a.i[I_EXACT_SIG] != 0;
  const bool chaos = a.i[I_CHAOS] != 0, orig16 = a.i[I_ORIG16] != 0;
  const bool sentinel = a.i[I_SENTINEL] != 0;
  const float pl = a.f[F_PLOSS], keep = a.f[F_KEEP];
  const int t1 = t + 1;
  const int tx_limit = a.i[I_TX_LIMIT];
  const int32_t* off = ptr<const int32_t>(a, P_OFF);
  const int LS = R | 1, SS = RO | 1, QS = E | 1;
  const uint32_t dR = div_of(R), dRO = div_of(RO), dE = div_of(E);

  const uint32_t* in_elt = ptr<const uint32_t>(a, P_SIN + S_EBLT);
  const uint32_t* in_esig = ptr<const uint32_t>(a, P_SIN + S_EBSIG);
  const uint32_t* in_key = ptr<const uint32_t>(a, P_SIN + S_EKEY);
  const int8_t* in_tx = ptr<const int8_t>(a, P_SIN + S_ETX);
  const uint8_t* in_pend = ptr<const uint8_t>(a, P_SIN + S_EPEND);
  const uint32_t* qopen_in = ptr<const uint32_t>(a, P_SIN + S_QOPEN);
  const int32_t* qdead_in = ptr<const int32_t>(a, P_SIN + S_QDEAD);
  const uint16_t* o_meta = ptr<const uint16_t>(a, P_OUT + L_META);
  const int32_t* ds_in = ptr<const int32_t>(a, P_SIN + S_DOWN);
  int32_t* ds_out = ptr<int32_t>(a, P_SOUT + S_DOWN);
  uint32_t* o_qlt = ptr<uint32_t>(a, P_SOUT + S_QBLT);
  uint32_t* o_qsig = ptr<uint32_t>(a, P_SOUT + S_QBSIG);
  const uint16_t* xflags = ptr<const uint16_t>(a, P_XFLAGS);
  const uint32_t* xkey = ptr<const uint32_t>(a, P_XKEY);
  const int32_t* xorig = ptr<const int32_t>(a, P_XORIG);
  const float* udrop = ptr<const float>(a, P_UDROP);

  // The warp's stage.
  uint32_t* s_elt = s_dyn + static_cast<size_t>(wib) *
                                serf_warp_words(tile_rows, E, R, O, nc);
  uint32_t* s_esig = s_elt + tile_rows * LS;
  uint32_t* s_key = s_esig + tile_rows * SS;
  int32_t* s_org = reinterpret_cast<int32_t*>(s_key + tile_rows * QS);
  int32_t* s_txp = s_org + tile_rows * QS;   // tx * 2 + pending
  uint32_t* s_ck = reinterpret_cast<uint32_t*>(s_txp + tile_rows * QS);
  int32_t* s_co = reinterpret_cast<int32_t*>(s_ck + 32 * nc);

  const int ntiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x * SWARPS + wib; tile < ntiles; tile += gridDim.x * SWARPS) {
    const int base = tile * tile_rows;
    const int rows = min(tile_rows, n - base);
    const bool valid = lane < rows;
    const int r = base + (valid ? lane : 0);
    const size_t b = static_cast<size_t>(base);

    // D1. Stage the event buckets and the queue; the query buckets go to
    // the output as they are (a query delivery updates its row there).
    stage_in(s_elt, LS, in_elt + b * R, rows, R, dR, lane);
    stage_in(s_esig, SS, in_esig + b * RO, rows, RO, dRO, lane);
    stage_in(s_key, QS, in_key + b * E, rows, E, dE, lane);
    if (!orig16)
      stage_in(reinterpret_cast<uint32_t*>(s_org), QS,
               ptr<const uint32_t>(a, P_SIN + S_EORIG) + b * E, rows, E, dE, lane);
    for (int e = lane; e < rows * E; e += 32) {
      const int x = e + row_of(e, E, dE) * (QS - E);
      if (orig16) s_org[x] = ptr<const int16_t>(a, P_SIN + S_EORIG)[b * E + e];
      s_txp[x] = static_cast<int>(in_tx[b * E + e]) * 2 + (in_pend[b * E + e] ? 1 : 0);
    }
    warp_copy<4>(reinterpret_cast<uint8_t*>(o_qlt + b * R),
                 ptr<const uint8_t>(a, P_SIN + S_QBLT) + b * R * 4,
                 static_cast<size_t>(rows) * R * 4, lane);
    warp_copy<4>(reinterpret_cast<uint8_t*>(o_qsig + b * RO),
                 ptr<const uint8_t>(a, P_SIN + S_QBSIG) + b * RO * 4,
                 static_cast<size_t>(rows) * RO * 4, lane);
    // Query expiry (the tally matched the pre-expiry keys, from the input).
    for (int e0 = 0; e0 < rows * Q; e0 += 32 * 4) {
      uint32_t qk[4];
      int32_t dl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e < rows * Q) {
          qk[u] = qopen_in[b * Q + e];
          dl[u] = qdead_in[b * Q + e];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e >= rows * Q) continue;
        ptr<uint32_t>(a, P_SOUT + S_QOPEN)[b * Q + e] =
            (qk[u] > 0u && t1 >= dl[u]) ? 0u : qk[u];
        ptr<int32_t>(a, P_SOUT + S_QDEAD)[b * Q + e] = dl[u];
      }
    }
    // Reap bookkeeping from the final view status (C's output).
    const size_t kb = b * K;
    const int ktot = rows * K;
    for (int e0 = 0; e0 < ktot; e0 += 32 * 8) {
      uint16_t m[8];
      int32_t ds[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e < ktot) {
          m[u] = o_meta[kb + e];
          ds[u] = ds_in[kb + e];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + 32 * u + lane;
        if (e >= ktot) continue;
        const uint32_t st = m[u] & 3u;
        const bool down = st == DEAD || st == LEFT;
        ds_out[kb + e] = down ? (ds[u] < 0 ? t : ds[u]) : -1;
      }
    }
    cp_async_wait_all();
    __syncwarp();

    // D2. One row per lane, on the stage.
    if (valid) {
      uint32_t* kq = s_key + lane * QS;
      int32_t* oq = s_org + lane * QS;
      int32_t* tq = s_txp + lane * QS;

      // Quiet leaves: left |= quiet, in the row's own packed flags, on top
      // of the tick's churn edges (what A wrote there).
      const uint8_t fl = static_cast<uint8_t>(flags_at(a, r) & ~REVIVED);
      const Terms me = chaos ? terms_at(a, r) : Terms{0, 0, 0, 1.0f, 1.0f};
      const int leave_in = ptr<const int32_t>(a, P_SIN + S_LEAVE)[r];
      const bool quiet = leave_in >= 0 && t1 >= leave_in;
      const bool alive = fl & 1, left = fl & 2, external = fl & 8;
      const bool active = alive && !left && !quiet;
      ptr<uint8_t>(a, P_OUT + L_FLAGS)[r] = static_cast<uint8_t>(fl | (quiet ? 2 : 0));
      ptr<int32_t>(a, P_SOUT + S_LEAVE)[r] = quiet ? -1 : leave_in;

      Bucket evb{s_elt + lane * LS, s_esig + lane * SS,
                 ptr<const uint32_t>(a, P_SIN + S_EFLOOR)[r], R, O, exact};
      Bucket qub{o_qlt + static_cast<size_t>(r) * R, o_qsig + static_cast<size_t>(r) * RO,
                 ptr<const uint32_t>(a, P_SIN + S_QFLOOR)[r], R, O, exact};
      const uint32_t clock0 = ptr<const uint32_t>(a, P_SIN + S_CLOCK)[r];
      const uint32_t eclock0 = ptr<const uint32_t>(a, P_SIN + S_ECLOCK)[r];
      const uint32_t qclock0 = ptr<const uint32_t>(a, P_SIN + S_QCLOCK)[r];
      uint32_t eclock = eclock0, qclock = qclock0;
      int delivered = ptr<const int32_t>(a, P_SIN + S_EDELIV)[r];

      // 1. Deliver the oldest staged-undelivered entry (the minimum key,
      //    lowest slot on ties).
      uint32_t del_key = 0xFFFFFFFFu;
      int del_slot = 0;
      for (int e = 0; e < E; ++e) {
        const uint32_t k = kq[e];
        if ((tq[e] & 1) && k > 0u && active && k < del_key) {
          del_key = k;
          del_slot = e;
        }
      }
      const bool has = del_key != 0xFFFFFFFFu;
      const uint32_t wkey = has ? del_key : 0u;
      const int worig = has ? oq[del_slot] : 0;
      const bool is_q = wkey & 1u;
      const bool stale = is_q ? qub.rejects(wkey, worig) : evb.rejects(wkey, worig);
      const bool deliver = has && !stale;
      const uint32_t lt = wkey >> 9;
      if (deliver && !is_q) {
        evb.apply(wkey, worig);
        delivered += 1;
        eclock = max(eclock, lt + 1u);
      }
      if (deliver && is_q) {
        qub.apply(wkey, worig);
        qclock = max(qclock, lt + 1u);
        // The query tally: ack (and answer) the origin's open slot. Under a
        // schedule the direct response and both legs of each relayed copy
        // are pair_ok legs, with the origin's terms read at its row.
        const float ur = ptr<const float>(a, P_URESP)[r];
        const Terms og = chaos ? terms_at(a, worig) : me;
        bool arrived = chaos ? pair_ok(a, me, og, ur, keep, false) : ur >= pl;
        if (RF > 0 && (chaos || pl > 0.0f)) {
          const int64_t* rcols = ptr<const int64_t>(a, P_RCOLS);
          const float* u1 = ptr<const float>(a, P_RU1);
          const float* u2 = ptr<const float>(a, P_RU2);
          for (int k = 0; k < RF; ++k) {
            const int rrow = wrap_add(r, off[rcols[k]], n);
            const size_t u = static_cast<size_t>(r) * RF + k;
            bool legs = u1[u] >= pl && u2[u] >= pl;
            if (chaos) {
              const Terms rt = terms_at(a, rrow);
              legs = pair_ok(a, me, rt, u1[u], keep, false) &&
                     pair_ok(a, rt, og, u2[u], keep, false);
            }
            if (serf_up(a, rrow, t1) && legs) arrived = true;
          }
        }
        if (arrived && worig != r && !external && serf_up(a, worig, t1)) {
          const bool responder = ptr<const uint8_t>(a, P_SIN + S_QRESPONDER)[r] != 0;
          int32_t* qacks = ptr<int32_t>(a, P_SOUT + S_QACK);
          int32_t* qresps = ptr<int32_t>(a, P_SOUT + S_QRESP);
          const size_t ob = static_cast<size_t>(worig) * Q;
          for (int q = 0; q < Q; ++q) {
            if (qopen_in[ob + q] != wkey) continue;
            atomicAdd(&qacks[ob + q], 1);
            if (responder) atomicAdd(&qresps[ob + q], 1);
          }
        }
      }
      if (has) tq[del_slot] &= ~1;

      // 2. Budget decrement by the legs sent, from the pre-tick selection:
      //    the top-PE slots by remaining budget (max value, lowest index on
      //    ties; a slot's budget is read before any decrement, since a
      //    taken slot is never compared again). Then retire spent
      //    delivered entries.
      const uint32_t xbits = xflags[r];
      const int ex_sends = __popc(xbits & 0xFFu);
      uint32_t taken = 0;
      int n_retx = 0;
      for (int q = 0; q < PE; ++q) {
        int best = -1, bv = 0;
        for (int e = 0; e < E; ++e) {
          if ((taken >> e) & 1u) continue;
          const int v = tq[e] >> 1;
          if (best < 0 || v > bv) {
            best = e;
            bv = v;
          }
        }
        taken |= 1u << best;
        const int sends = ((xbits >> (8 + q)) & 1u) ? ex_sends : 0;
        n_retx += sends;
        tq[best] = max(bv - sends, 0) * 2 + (tq[best] & 1);
      }
      for (int e = 0; e < E; ++e)
        if ((tq[e] >> 1) <= 0 && !(tq[e] & 1)) kq[e] = 0u;

      // 3. Intake: up to 2 fresh arrivals off the legs, re-read from the
      //    senders' payloads at this tick's displacements. A leg arrives as
      //    the membership leg does in B: its drop draw (a one-way pair_ok
      //    under a schedule) and the receiver's pre-quiet liveness.
      //    The senders' flags and draws of every leg are read at once, then
      //    the candidates' keys and origins eight at a time.
      const bool recv_up = alive && !left;
      uint32_t okmask = 0;  // bit f * PE + q: candidate q of leg f arrived
#pragma unroll
      for (int f = 0; f < MAXFAN; ++f) {
        const int s = wrap_sub(r, s_goff[f], n);
        const uint32_t xs = xflags[s];
        const float u = udrop[static_cast<size_t>(r) * FAN + min(f, FAN - 1)];
        if (f >= FAN) continue;
        const bool ok_leg = chaos ? pair_ok(a, terms_at(a, s), me, u, keep, false)
                                  : u >= pl;
        if (((xs >> f) & 1u) && ok_leg && recv_up)
          okmask |= ((xs >> 8) & ((1u << PE) - 1u)) << (f * PE);
      }
      uint32_t fresh = 0;
      for (int c0 = 0; c0 < nc; c0 += 8) {
        uint32_t ckv[8];
        int cov[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = min(c0 + u, nc - 1);
          const int f = c / PE;
          const size_t sq = static_cast<size_t>(wrap_sub(r, s_goff[f], n)) * PE + (c - f * PE);
          ckv[u] = xkey[sq];
          cov[u] = xorig[sq];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = c0 + u;
          if (c >= nc) continue;
          const bool ok = (okmask >> c) & 1u;
          const uint32_t ck = ok ? ckv[u] : 0u;
          const int co = ok ? cov[u] : -1;
          s_ck[c * 32 + lane] = ck;
          s_co[c * 32 + lane] = co;
          if (ck > 0u && !((ck & 1u) ? qub.rejects(ck, co) : evb.rejects(ck, co)))
            fresh |= 1u << c;
        }
      }
      int queued = 0, dropped = 0;
      for (int round = 0; round < 2; ++round) {
        // The minimum fresh key, lowest candidate on ties.
        uint32_t win = 0xFFFFFFFFu;
        int slot_i = 0;
        for (int c = 0; c < nc; ++c) {
          const uint32_t ck = s_ck[c * 32 + lane];
          if (((fresh >> c) & 1u) && ck < win) {
            win = ck;
            slot_i = c;
          }
        }
        if (win == 0xFFFFFFFFu) break;
        const int worg = s_co[slot_i * 32 + lane];
        // _equeue_push: same subject, else empty, else most transmitted.
        int slot = 0, best = 0;
        bool slot_same = false, slot_empty = false;
        for (int e = 0; e < E; ++e) {
          const bool same = kq[e] == win && oq[e] == worg;
          const bool empty = kq[e] == 0u;
          const int score = (same ? 3000000 : 0) + (empty ? 2000000 : 0) +
                            (1000000 - min(tq[e] >> 1, 999999));
          if (e == 0 || score > best) {
            best = score;
            slot = e;
            slot_same = same;
            slot_empty = empty;
          }
        }
        dropped += (!slot_same && !slot_empty) ? 1 : 0;
        ++queued;
        kq[slot] = win;
        oq[slot] = worg;
        tq[slot] = tx_limit * 2 + 1;
        for (int c = 0; c < nc; ++c)
          if (s_ck[c * 32 + lane] == win && s_co[c * 32 + lane] == worg)
            fresh &= ~(1u << c);
      }
      tl.add(C_SQUEUED, queued);
      tl.add(C_SRETX, n_retx);
      tl.add(C_SDROPPED, dropped);
      // Sentinel: Lamport regressions within the tick (the clocks move only
      // through the witness max, so any is corruption).
      if (sentinel) tl.add(C_SMONO, (eclock < eclock0) + (qclock < qclock0));

      ptr<uint32_t>(a, P_SOUT + S_CLOCK)[r] = clock0;
      ptr<uint32_t>(a, P_SOUT + S_ECLOCK)[r] = eclock;
      ptr<uint32_t>(a, P_SOUT + S_QCLOCK)[r] = qclock;
      ptr<uint32_t>(a, P_SOUT + S_EFLOOR)[r] = evb.floor;
      ptr<uint32_t>(a, P_SOUT + S_QFLOOR)[r] = qub.floor;
      ptr<int32_t>(a, P_SOUT + S_EDELIV)[r] = delivered;
      ptr<uint8_t>(a, P_SOUT + S_QRESPONDER)[r] =
          ptr<const uint8_t>(a, P_SIN + S_QRESPONDER)[r];
    }
    __syncwarp();

    // D3. The staged queue and event buckets out, lanes over cells.
    stage_out(ptr<uint32_t>(a, P_SOUT + S_EBLT) + b * R, s_elt, LS, rows, R, dR, lane);
    stage_out(ptr<uint32_t>(a, P_SOUT + S_EBSIG) + b * RO, s_esig, SS, rows, RO, dRO,
              lane);
    stage_out(ptr<uint32_t>(a, P_SOUT + S_EKEY) + b * E, s_key, QS, rows, E, dE, lane);
    int8_t* o_tx = ptr<int8_t>(a, P_SOUT + S_ETX);
    uint8_t* o_pend = ptr<uint8_t>(a, P_SOUT + S_EPEND);
    for (int e = lane; e < rows * E; e += 32) {
      const int x = e + row_of(e, E, dE) * (QS - E);
      store_origin(a, P_SOUT + S_EORIG, b * E + e, s_org[x]);
      o_tx[b * E + e] = static_cast<int8_t>(s_txp[x] >> 1);
      o_pend[b * E + e] = static_cast<uint8_t>(s_txp[x] & 1);
    }
    __syncwarp();
  }
  tl.flush(smem, lane);
  block_flush(smem, ptr<int>(a, P_CNT));
}

// ---------------------------------------------------------------------------
// (M) gossip_metrics: one tick's TickTrace row from the packed leaves.
//
// Replaces the metrics tail of the reference's chunk body
// (consul_tpu/models/cluster.py:263-276: metrics.health and
// metrics.vivaldi_rmse on a transient unpacked view, fused by XLA into the
// scan). Not a TPU kernel: the port ran it as PyTorch ops on an unpacked
// copy of the whole SWIM plane every tick. Its plain version is
// metrics.health_packed + metrics.vivaldi_rmse_packed.
//
// What bounds it: bytes. One pass over meta ([N, K] uint16, of which it
// needs the 2-bit status) and flags ([N] uint8: a row's own liveness and,
// at (r + off[c]) wrapped by a compare, each cell's subject's), 2K + 1
// B/node; the RMSE reads 2 x 2048 sampled rows, a few hundred KB. Threads
// walk the flat cells in groups of 8 of one row (one 16-byte load of meta,
// consecutive threads on consecutive groups, so a warp load is 512
// contiguous bytes), or one at a time where K % 8 != 0 (the dense view);
// a thread carries (row, column) from one grid stride to the next with no
// division. The subject flags are scattered byte reads of an [N] array
// that stays in L2; each step issues all of its loads before it uses one.
//
// Counts are integers, reduced per warp (__reduce_add_sync), per block in
// shared memory and over the grid with 64-bit atomics, exact in any order.
// The last ceil(S / 256) blocks of the grid (the RMSE blocks) take one
// sampled pair a thread, so no block chases more than one pair's
// dependent reads, and sum err^2 over their pairs in a fixed shuffle tree
// into a partial of their own; the partials add in block order, so the
// sum's order is fixed (a NaN propagates as in torch.sum). The last block
// to finish (a ticket) divides once, as the reference does (count and
// edges each rounded to float32, one IEEE division), writes the four
// floats of the row and zeroes the grid scratch for the next launch.
// ---------------------------------------------------------------------------

enum MPtr {
  M_META, M_FLAGS, M_OFF, M_VEC, M_VH, M_VADJ, M_POS, M_HEIGHT, M_I, M_J,
  M_ACC, M_OUT, N_MPTR
};
enum MInt { MI_N, MI_K, MI_D, MI_WD, MI_S, MI_VEC, N_MINT };

struct MetricsArgs {
  void* p[N_MPTR];
  int32_t i[N_MINT];
};

// M_ACC, unsigned 64-bit words: agree, false positive, undetected, active
// rows, ticket, then for RMSE block b its err^2 partial (float bits) at
// A_PART + 2b and its live pairs at A_PART + 2b + 1.
enum MAcc { A_AGREE, A_FP, A_UND, A_ROWS, A_TICKET, A_PART };

#define MTHREADS 256

__host__ __device__ __forceinline__ int m_rmse_blocks(int samples) {
  return (samples + MTHREADS - 1) / MTHREADS;
}

__device__ __forceinline__ bool m_active(const uint8_t* flags, int x) {
  const uint8_t f = flags[x];
  return (f & 1) && !(f & 2);
}

__device__ __forceinline__ float m_pair_err2(const MetricsArgs& a, int64_t pi,
                                             int64_t pj, bool* ok_out) {
  const uint8_t* flags = static_cast<const uint8_t*>(a.p[M_FLAGS]);
  const bool ok = pi != pj && (flags[pi] & 1) && (flags[pj] & 1);
  *ok_out = ok;
  const int D = a.i[MI_D], WD = a.i[MI_WD];
  const uint16_t* vec = static_cast<const uint16_t*>(a.p[M_VEC]);
  const uint16_t* vh = static_cast<const uint16_t*>(a.p[M_VH]);
  const uint16_t* vadj = static_cast<const uint16_t*>(a.p[M_VADJ]);
  const float* pos = static_cast<const float*>(a.p[M_POS]);
  const float* hgt = static_cast<const float*>(a.p[M_HEIGHT]);
  // vivaldi.distance: the norm as a left fold from 0, then + heights, then
  // + adjustments, used only while positive.
  float sq = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float diff = bf2f(vec[pi * D + d]) - bf2f(vec[pj * D + d]);
    sq = sq + diff * diff;
  }
  const float dist = (sqrtf(sq) + bf2f(vh[pi])) + bf2f(vh[pj]);
  const float adjusted = (dist + bf2f(vadj[pi])) + bf2f(vadj[pj]);
  const float est = adjusted > 0.0f ? adjusted : dist;
  // topology.true_rtt.
  float w = 0.0f;
  for (int d = 0; d < WD; ++d) {
    const float diff = pos[pi * WD + d] - pos[pj * WD + d];
    w = w + diff * diff;
  }
  const float rtt = (sqrtf(w) + hgt[pi]) + hgt[pj];
  const float err = ok ? est - rtt : 0.0f;
  return err * err;
}

// The health counts of the cells this thread visits, G consecutive cells
// of one row at a time (G = 8: one 16-byte load of meta, where K % 8 == 0
// and meta is 16-byte aligned; else one cell). Each step issues the row's
// flags, the G statuses and the G subjects' flags before it uses any.
template <int G>
__device__ void m_health(const MetricsArgs& a, unsigned int v[4]) {
  const int n = a.i[MI_N], K = a.i[MI_K];
  const uint16_t* meta = static_cast<const uint16_t*>(a.p[M_META]);
  const uint8_t* flags = static_cast<const uint8_t*>(a.p[M_FLAGS]);
  const int32_t* off = static_cast<const int32_t*>(a.p[M_OFF]);
  const long long groups = static_cast<long long>(n) * K / G;
  const long long stride =
      static_cast<long long>(gridDim.x - m_rmse_blocks(a.i[MI_S])) * MTHREADS;
  long long g = static_cast<long long>(blockIdx.x) * MTHREADS + threadIdx.x;
  const long long step = stride * G;
  const int dr = static_cast<int>(step / K), dc = static_cast<int>(step % K);
  int r = static_cast<int>(g * G / K), c = static_cast<int>(g * G % K);
  for (; g < groups; g += stride) {
    uint16_t m[G];
    if constexpr (G == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(meta + g * G);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[2 * k] = static_cast<uint16_t>(w[k] & 0xFFFFu);
        m[2 * k + 1] = static_cast<uint16_t>(w[k] >> 16);
      }
    } else {
      m[0] = meta[g];
    }
    const bool obs = m_active(flags, r);
    bool up[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      int nb = r + off[c + k];
      if (nb >= n) nb -= n;
      up[k] = m_active(flags, nb);
    }
    if (obs) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const uint32_t st = m[k] & 3u;
        const bool b_up = st == ALIVE, b_down = st == DEAD || st == LEFT;
        v[0] += (up[k] && b_up) || (!up[k] && b_down);
        v[1] += up[k] && b_down;
        v[2] += !up[k] && b_up;
      }
      v[3] += c == 0;
    }
    c += dc;
    r += dr;
    if (c >= K) { c -= K; ++r; }
  }
}

__global__ void __launch_bounds__(MTHREADS) k_metrics(MetricsArgs a) {
  __shared__ unsigned int s_cnt[4];
  __shared__ float s_sq[MTHREADS / 32];
  __shared__ unsigned int s_ok[MTHREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  unsigned long long* acc = static_cast<unsigned long long*>(a.p[M_ACC]);
  if (threadIdx.x < 4) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const int S = a.i[MI_S], rmse_blocks = m_rmse_blocks(S);
  const int rb = static_cast<int>(blockIdx.x) - (static_cast<int>(gridDim.x) - rmse_blocks);
  if (rb < 0) {
    // Health: the cell pass over the grid's first blocks.
    unsigned int v[4] = {0, 0, 0, 0};
    if (a.i[MI_VEC]) m_health<8>(a, v);
    else m_health<1>(a, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned int s = __reduce_add_sync(FULL, v[k]);
      if (lane == 0 && s) atomicAdd(&s_cnt[k], s);
    }
    __syncthreads();
    if (threadIdx.x < 4 && s_cnt[threadIdx.x])
      atomicAdd(&acc[A_AGREE + threadIdx.x], static_cast<unsigned long long>(s_cnt[threadIdx.x]));
  } else {
    // RMSE: pair rb * MTHREADS + threadIdx.x.
    const int s = rb * MTHREADS + threadIdx.x;
    float sq = 0.0f;
    unsigned int oks = 0;
    if (s < S) {
      bool ok;
      sq = m_pair_err2(a, static_cast<const int64_t*>(a.p[M_I])[s],
                       static_cast<const int64_t*>(a.p[M_J])[s], &ok);
      oks = ok;
    }
    for (int o = 16; o > 0; o >>= 1) sq = sq + __shfl_down_sync(FULL, sq, o);
    oks = __reduce_add_sync(FULL, oks);
    if (lane == 0) { s_sq[wib] = sq; s_ok[wib] = oks; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.0f;
      unsigned int ok_tot = 0;
      for (int w = 0; w < MTHREADS / 32; ++w) { tot = tot + s_sq[w]; ok_tot += s_ok[w]; }
      acc[A_PART + 2 * rb] = __float_as_uint(tot);
      acc[A_PART + 2 * rb + 1] = ok_tot;
    }
  }

  // The last block to finish writes the row and clears the scratch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&acc[A_TICKET], 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  volatile unsigned long long* vacc = acc;
  unsigned long long edges = vacc[A_ROWS] * static_cast<unsigned long long>(a.i[MI_K]);
  if (edges < 1) edges = 1;
  const float fe = __ull2float_rn(edges);
  float* out = static_cast<float*>(a.p[M_OUT]);
  out[0] = __fdiv_rn(__ull2float_rn(vacc[A_AGREE]), fe);
  out[1] = __fdiv_rn(__ull2float_rn(vacc[A_FP]), fe);
  out[2] = __fdiv_rn(__ull2float_rn(vacc[A_UND]), fe);
  float sq = 0.0f;
  unsigned long long oks = 0;
  for (int b = 0; b < rmse_blocks; ++b) {
    sq = sq + __uint_as_float(static_cast<uint32_t>(vacc[A_PART + 2 * b]));
    oks += vacc[A_PART + 2 * b + 1];
  }
  out[3] = __fsqrt_rn(__fdiv_rn(sq, __ull2float_rn(oks < 1 ? 1 : oks)));
  for (int k = 0; k < A_PART + 2 * rmse_blocks; ++k) vacc[k] = 0;
}

// ---------------------------------------------------------------------------
// Host entry points: one per launch, each returns cudaGetLastError().
// ---------------------------------------------------------------------------

static dim3 grid_for(const TickArgs* a, int threads) {
  return dim3((a->i[I_N] + threads - 1) / threads);
}

extern "C" int gossip_chaos_pre(const TickArgs* a, void* stream) {
  k_chaos_pre<<<grid_for(a, 128), 128, 0, (cudaStream_t)stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// A and C run on persistent grids: as many blocks as stay resident on the
// card at once (from the occupancy of the kernel as built), and no more
// than the tiles need. A warp takes 32 rows while the tiles outnumber the
// resident warps, and fewer rows on a small population (down to one, so a
// dense view of 256 rows spreads over 256 warps). The resident count is
// asked of the runtime once per kernel, on the card of its first launch: a
// process drives one card.
static int resident_blocks(const void* fn, int warps = WARPS, size_t smem = 0) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, warps * 32, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(per_sm, 1) * std::max(sms, 1);
}

// Rows per tile: max_rows, halved while the tiles would not fill every
// resident warp.
static int tile_rows_for(int n, int blocks, int warps, int max_rows) {
  int rows = max_rows;
  while (rows > 1 && (n + rows - 1) / rows < blocks * warps) rows = (rows + 1) / 2;
  return rows;
}

static int launch_tiles(void (*kern)(TickArgs, int), int blocks, const TickArgs* a,
                        void* stream, int max_rows) {
  const int n = a->i[I_N];
  const int rows = tile_rows_for(n, blocks, WARPS, max_rows);
  const int tiles = (n + rows - 1) / rows;
  const int grid = std::min(blocks, (tiles + WARPS - 1) / WARPS);
  kern<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(*a, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gossip_probe_send(const TickArgs* a, void* stream) {
  static const int blocks = resident_blocks(reinterpret_cast<const void*>(k_probe_send));
  return launch_tiles(k_probe_send, blocks, a, stream, probe_tile_rows(a->i[I_K]));
}

extern "C" int gossip_receive(const TickArgs* a, void* stream) {
  static const int blocks = resident_blocks(reinterpret_cast<const void*>(k_receive));
  return launch_tiles(k_receive, blocks, a, stream, 32);
}

extern "C" int gossip_pushpull(const TickArgs* a, void* stream) {
  static const int blocks = resident_blocks(reinterpret_cast<const void*>(k_pushpull));
  return launch_tiles(k_pushpull, blocks, a, stream, 32);
}

// D's tiles take as many rows (up to 32) as its stage holds at this
// configuration's queue and bucket widths; its dynamic shared memory is
// SWARPS stages of that many rows. Resident blocks are counted at the
// full stage, which no launch exceeds.
extern "C" int gossip_serf_post(const TickArgs* a, void* stream) {
  const void* fn = reinterpret_cast<const void*>(k_serf_post);
  const int full = SWARPS * SERF_WARP_WORDS * 4;
  static const cudaError_t attr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, full);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int blocks = resident_blocks(fn, SWARPS, full);
  const int E = a->i[I_E], R = a->i[I_R], O = a->i[I_O];
  const int nc = a->i[I_FAN] * a->i[I_PE];
  const int max_rows = std::min(
      32, (SERF_WARP_WORDS - 64 * nc) / serf_row_words(E, R, O));
  if (max_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = a->i[I_N];
  const int rows = tile_rows_for(n, blocks, SWARPS, max_rows);
  const int tiles = (n + rows - 1) / rows;
  const int grid = std::min(blocks, (tiles + SWARPS - 1) / SWARPS);
  const size_t bytes = static_cast<size_t>(SWARPS) * serf_warp_words(rows, E, R, O, nc) * 4;
  k_serf_post<<<grid, SWARPS * 32, bytes, (cudaStream_t)stream>>>(*a, rows);
  return static_cast<int>(cudaGetLastError());
}

// M runs its health pass on as many blocks as stay resident (no more than
// the cells need) and its RMSE on ceil(S / 256) more, the last of the grid.
extern "C" int gossip_metrics(const MetricsArgs* a, void* stream) {
  static const int blocks =
      resident_blocks(reinterpret_cast<const void*>(k_metrics), MTHREADS / 32);
  const long long cells = static_cast<long long>(a->i[MI_N]) * a->i[MI_K];
  const long long need = std::max(1LL, (cells + MTHREADS - 1) / MTHREADS);
  const int health = static_cast<int>(std::min(need, static_cast<long long>(blocks)));
  k_metrics<<<health + m_rmse_blocks(a->i[MI_S]), MTHREADS, 0, (cudaStream_t)stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gossip_metrics_layout(int* out) {
  out[0] = N_MPTR;
  out[1] = N_MINT;
  out[2] = A_PART;
  out[3] = static_cast<int>(sizeof(MetricsArgs));
  return 0;
}

extern "C" int gossip_layout(int* out) {
  out[0] = N_PTR;
  out[1] = N_INT;
  out[2] = N_FLT;
  out[3] = static_cast<int>(sizeof(TickArgs));
  return 0;
}
