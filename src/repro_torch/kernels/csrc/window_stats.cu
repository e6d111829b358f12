// Window stats: the pre-aggregated multi-window query.  For every request
// row q, RANGE window T and lane l, the five stats (sum, count, min, max,
// sumsq) over the window (ts_q - T, ts_q] of the request key's history,
// the request row included:
//
//   raw rows     ring slots in the oldest partial bucket (b_lo, when it is
//                not the request's bucket) and in the request's bucket
//                b_q, inside the window and not in the future;
//   middle       bucket pre-aggregates whose stored id lies strictly
//                between b_lo and b_q, in any of the NB slots;
//   out          (raw + request row) combined with middle, as
//                window_stats_ref (kernels/window_agg/ref.py) composes it.
//
// with b_q = floor(ts_q / B) and b_lo = floor((ts_q - T) / B).
//
// Replaces the Pallas TPU kernel window_stats_pallas
// (src/repro/kernels/window_agg/window_agg.py, body _window_agg_kernel).
// There a scalar-prefetched index map DMAs the key's (C, L) ring tile and
// (NB, L, 5) bucket tile into VMEM, one grid step per query.
//
// Design: a warp per request, one pass over the key's slots for every
// window and lane.  The 32 lanes split the key's C ring timestamps and NB
// bucket ids into 16-byte vectors: lane i takes vectors v = i, i + 32,
// ..., vector v holding slots 4v .. 4v + 3 (int4 loads where the row is
// 16-byte aligned and C or NB a multiple of 4, the same slots one by one
// otherwise), two ring vectors and four id vectors a round, all loaded
// before any is used (one round at C <= 256, NB <= 512).  The request's
// reads are then three dependent round trips: its key; its timestamps
// and ids; the rows they select.  The register instantiation makes the
// third one round trip as well: it first computes every slot's window bits
// (two a slot: raw row of window w, middle bucket of window w), then
// issues the loads of all its raw rows (one float2 at L = 2) before any
// fold, and its middle buckets' (L, 5) stats two hits at a time (five
// float2 at L = 2) before their folds, so a lane never waits on one slot
// before asking for the next (folding each slot as it is loaded costs a
// round trip per slot position that any lane of the warp hits, which
// `general` pays; PERF.md, section 6, times both).  Only slots some window
// takes are loaded; all NB ids are tested (membership b_lo < id < b_q, so
// a bucket outside slot id mod NB still counts).  At the end one warp
// reduction per accumulator, the composition, and lanes 0 .. NW*L*5 - 1
// store the request's outputs in one coalesced write.
//
// Two instantiations, picked by the wrapper (ops.py, plan_window_stats):
// `small` for NW <= 2 and L <= 2 (the fraud view's 2 x 2) keeps the
// 9 * NW * L + NW accumulators of a lane in registers, 8 warps (8
// requests) to a block, two blocks an SM (128 registers a thread; a
// budget for three or four blocks spills and ran slower, so did the
// accumulators in shared memory at four blocks); `general` keeps them in
// shared memory, a column a lane ([entry][32], no bank conflicts), as
// many warps to a block as 227 KB hold, and folds each slot as it loads
// it.  A launch takes at most 8 windows (WindowsArg, passed by value)
// and, in `general`, as many lanes as fit one warp's shared memory; the
// wrapper covers larger NW or L with one launch per (window, lane) chunk.
// No __syncthreads anywhere: warps share nothing.
//
// Order of the float sums (the CPU tests replay it, tests/
// window_stats_replay.py):
//   1. in a lane, raw sum and sumsq in slot order (vector v ascending,
//      then slot 4v + j, j = 0 .. 3), __fadd_rn(acc, g) and
//      __fadd_rn(acc, __fmul_rn(g, g)); middle sum, count and sumsq in
//      bucket-slot order the same way, each from 0.0f;
//   2. across lanes, a butterfly: for off = 16, 8, 4, 2, 1, v_i =
//      __fadd_rn(v_i, v_{i ^ off}) (all lanes end with the same bits; a
//      group that no lane touched is left at its identity, which the
//      butterfly would return unchanged);
//   3. out sum = (raw + q) + middle, sumsq = (raw + q * q) + middle, each
//      a rounded add; count = (raw + 1) + middle.
// Count, min and max are exact in any order: the raw count is an integer
// (__reduce_add_sync), min and max reduce as order-preserving int32 keys
// (__reduce_min_sync / __reduce_max_sync; -0.0 below +0.0), with NaN in
// any lane falling back to a butterfly of fmin_ref / fmax_ref (lower lane
// first), the plain version's select order.  Built with -fmad=false
// (kernels/build.py) so g * g is rounded before it is added.
//
// Traps: b_lo is negative early in the timeline and empty ring slots hold
// TS_EMPTY = -2^31, so bucket ids use floor division, not C's truncating
// one; ts_q - T wraps as int32, as in the reference (computed on uint32,
// never as a signed overflow).  Bucket membership of a ring row compares
// ts with b * B in int64 instead of dividing every slot.
//
// Bound on the H100: bytes, counted on the data (chip_smoke.py,
// _window_stats_bytes).  Per distinct key the C ring timestamps (4C), the
// lanes of the ring rows folded raw (4L each), the ids of the bucket slots
// that can hold a middle bucket of the widest window (4 each; at most
// ceil(T_max / B) + 1 of the NB slots) and the stats of the slots whose id
// is a middle bucket (20L each); per query the request (8 + 4L) and the
// output (NW * L * 20).  The kernel reads all NB ids of the key (2 KB at
// NB = 512) where the bound counts only the slots that can hold a middle
// bucket, so on sparse histories it moves up to ~1.6x the bound's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

// the windows of one launch, by value (at most 8; the wrapper chunks more)
struct WindowsArg {
  int32_t t[8];
};

namespace {

constexpr int MAX_WINDOWS = 8;
constexpr int32_t TS_EMPTY = INT32_MIN;
constexpr int32_t ID_NONE = INT32_MIN;  // past the end of a bucket row
constexpr float POS_INF = 3.0e38f;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int VB_TS = 2;         // ring-ts vectors a lane loads a round
constexpr int VB_ID = 4;         // bucket-id vectors a lane loads a round
constexpr int SMALL_WARPS = 8;   // requests a block of `small`
constexpr int MID_BIT = 8;       // touched bits: raw window w, middle 8 + w
constexpr int MID_CHUNK = 2;     // middle-bucket slots a lane loads at once

struct Args {
  const int32_t* ring_ts;   // (K, C)
  const float* ring_lanes;  // (K, C, L)
  const float* bstats;      // (K, NB, L, 5)
  const int32_t* bbucket;   // (K, NB)
  const int32_t* q_key;     // (Q,)
  const int32_t* q_ts;      // (Q,)
  const float* q_lanes;     // (Q, L)
  float* out;               // (Q, NW_total, L, 5)
  int Q, C, NB, L, NW_total, w0, nw, l0, lc, B;
  bool ts_vec, id_vec, row_vec2, st_vec2;
};

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  // b > 0
  int32_t q = a / b;
  if ((a % b) != 0 && a < 0) q -= 1;
  return q;
}

// the plain version's min / max (jnp.minimum / jnp.maximum semantics:
// NaN wins, -0.0 below +0.0); see fold_levels.cu
__device__ __forceinline__ float fmin_ref(float a, float b) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const bool neg = (ua >> 31) != 0;
  const uint32_t nx = neg ? ub : ua, ny = neg ? ua : ub;
  const uint32_t pick = (__uint_as_float(nx) < __uint_as_float(ny)) ? nx : ny;
  return __uint_as_float(((nx & 0x7FFFFFFFu) > 0x7F800000u) ? nx : pick);
}

__device__ __forceinline__ float fmax_ref(float a, float b) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const bool neg = (ua >> 31) != 0;
  const uint32_t nx = neg ? ua : ub, ny = neg ? ub : ua;
  const uint32_t pick = (__uint_as_float(nx) > __uint_as_float(ny)) ? nx : ny;
  return __uint_as_float(((nx & 0x7FFFFFFFu) > 0x7F800000u) ? nx : pick);
}

__device__ __forceinline__ bool is_nan(float v) {
  return (__float_as_uint(v) & 0x7FFFFFFFu) > 0x7F800000u;
}

// float -> int32 key with the same order (-0.0 below +0.0), and back
__device__ __forceinline__ int32_t order_key(float f) {
  const int32_t i = __float_as_int(f);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int32_t i) {
  return __int_as_float(i >= 0 ? i : (i ^ 0x7FFFFFFF));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  if (__any_sync(FULL, is_nan(v))) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(FULL, v, off);
      const bool hi = (lane & off) != 0;
      v = fmin_ref(hi ? o : v, hi ? v : o);
    }
    return v;
  }
  return from_key(__reduce_min_sync(FULL, order_key(v)));
}

__device__ __forceinline__ float warp_max(float v) {
  if (__any_sync(FULL, is_nan(v))) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(FULL, v, off);
      const bool hi = (lane & off) != 0;
      v = fmax_ref(hi ? o : v, hi ? v : o);
    }
    return v;
  }
  return from_key(__reduce_max_sync(FULL, order_key(v)));
}

// slots 4v .. 4v + 3 of a row of n int32 (nvec = ceil(n / 4) vectors);
// `fill` past the end
__device__ __forceinline__ int4 load_vec(const int32_t* row, int v, int n,
                                         int nvec, bool vec, int32_t fill) {
  int4 r = make_int4(fill, fill, fill, fill);
  if (v >= nvec) return r;
  if (vec) return __ldg(reinterpret_cast<const int4*>(row) + v);
  const int s = 4 * v;
  r.x = __ldg(row + s);
  if (s + 1 < n) r.y = __ldg(row + s + 1);
  if (s + 2 < n) r.z = __ldg(row + s + 2);
  if (s + 3 < n) r.w = __ldg(row + s + 3);
  return r;
}

__device__ __forceinline__ int32_t part(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the OR of the 2-bit groups of x (the windows any slot of a round takes)
__device__ __forceinline__ uint32_t window_bits(uint32_t x) {
  x |= x >> 16;
  x |= x >> 8;
  x |= x >> 4;
  x |= x >> 2;
  return x & 3u;
}

// one request's windows: raw-row tests and middle bounds
struct Windows {
  int32_t lo[MAX_WINDOWS];       // first ts inside the window
  int32_t b_lo[MAX_WINDOWS];     // floor((ts_q - T) / B)
  int64_t head_from[MAX_WINDOWS];  // [head_from, head_to): bucket b_lo
  int64_t head_to[MAX_WINDOWS];    // (empty when b_lo == b_q)
  int32_t min_b_lo;
};

template <int NWMAX>
__device__ __forceinline__ void window_bounds(const WindowsArg& win, int nw,
                                              int32_t ts_q, int32_t B,
                                              int32_t b_q, Windows& s) {
  s.min_b_lo = INT32_MAX;
#pragma unroll
  for (int w = 0; w < NWMAX; ++w) {
    if (w >= nw) break;
    const uint32_t d = (uint32_t)ts_q - (uint32_t)win.t[w];  // wraps
    s.lo[w] = (int32_t)(d + 1u);
    s.b_lo[w] = floordiv((int32_t)d, B);
    const bool head = s.b_lo[w] != b_q;
    s.head_from[w] = head ? (int64_t)s.b_lo[w] * B : 1;
    s.head_to[w] = head ? (int64_t)s.b_lo[w] * B + B : 0;
    s.min_b_lo = min(s.min_b_lo, s.b_lo[w]);
  }
}

// bit w set when ring row ts is a raw row of window w
template <int NWMAX>
__device__ __forceinline__ unsigned raw_mask(const Windows& s, int nw,
                                             int32_t ts, int32_t ts_q,
                                             int64_t tail_from) {
  unsigned m = 0;
  if (ts == TS_EMPTY || ts > ts_q) return 0;
  const int64_t t = ts;
  const bool tail = t >= tail_from;  // ts <= ts_q: in bucket b_q
#pragma unroll
  for (int w = 0; w < NWMAX; ++w) {
    if (w >= nw) break;
    const bool in = ts >= s.lo[w] &&
                    (tail || (t >= s.head_from[w] && t < s.head_to[w]));
    m |= (unsigned)in << w;
  }
  return m;
}

// bit w set when bucket id is a middle bucket of window w
template <int NWMAX>
__device__ __forceinline__ unsigned mid_mask(const Windows& s, int nw,
                                             int32_t id, int32_t b_q) {
  unsigned m = 0;
  if (!(id > s.min_b_lo && id < b_q)) return 0;
#pragma unroll
  for (int w = 0; w < NWMAX; ++w) {
    if (w >= nw) break;
    m |= (unsigned)(id > s.b_lo[w]) << w;
  }
  return m;
}

// Rounds of a lane's pass over a key's rows (one at C <= 256, NB <= 512),
// and round r's VB_TS ring-ts vectors and VB_ID bucket-id vectors.
__device__ __forceinline__ int rounds_of(const Args& a) {
  const int nv_ts = (a.C + 3) >> 2, nv_id = (a.NB + 3) >> 2;
  return max((nv_ts + 32 * VB_TS - 1) / (32 * VB_TS),
             (nv_id + 32 * VB_ID - 1) / (32 * VB_ID));
}

__device__ __forceinline__ void load_round(const Args& a,
                                           const int32_t* ts_row,
                                           const int32_t* id_row, int r,
                                           int lane, int4 (&tv)[VB_TS],
                                           int4 (&iv)[VB_ID]) {
  const int nv_ts = (a.C + 3) >> 2, nv_id = (a.NB + 3) >> 2;
#pragma unroll
  for (int u = 0; u < VB_TS; ++u)
    tv[u] = load_vec(ts_row, (r * VB_TS + u) * 32 + lane, a.C, nv_ts,
                     a.ts_vec, TS_EMPTY);
#pragma unroll
  for (int u = 0; u < VB_ID; ++u)
    iv[u] = load_vec(id_row, (r * VB_ID + u) * 32 + lane, a.NB, nv_id,
                     a.id_vec, ID_NONE);
}

// One lane's pass over a key's ring and bucket rows, as `general` makes
// it: rounds of VB_TS ring vectors and VB_ID id vectors, all loaded before
// any is used; raw(ts, slot) for each ring slot, mid(id, slot) for each
// bucket slot, both in ascending slot order.
template <class Raw, class Mid>
__device__ __forceinline__ void scan_key(const Args& a, const int32_t* ts_row,
                                         const int32_t* id_row, int lane,
                                         Raw raw, Mid mid) {
  const int rounds = rounds_of(a);
  for (int r = 0; r < rounds; ++r) {
    int4 tv[VB_TS], iv[VB_ID];
    load_round(a, ts_row, id_row, r, lane, tv, iv);
#pragma unroll
    for (int u = 0; u < VB_TS; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw(part(tv[u], j), 4 * (int64_t)((r * VB_TS + u) * 32 + lane) + j);
#pragma unroll
    for (int u = 0; u < VB_ID; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mid(part(iv[u], j), 4 * (int64_t)((r * VB_ID + u) * 32 + lane) + j);
  }
}

// ---------------------------------------------------------------------------
// small: accumulators in registers (NW, L compile-time)
// ---------------------------------------------------------------------------

// fields of a (window, lane) group's 9 accumulators
enum Field { RSUM, RMIN, RMAX, RSQ, MSUM, MCNT, MMIN, MMAX, MSQ, NFIELDS };

__device__ __forceinline__ float field_identity(int f) {
  return (f == RMIN || f == MMIN) ? POS_INF
         : (f == RMAX || f == MMAX) ? NEG_INF : 0.f;
}

// a lane's 9 * NW * L accumulators, in registers (every index is known at
// compile time in `small`)
template <int NW, int L>
struct Acc {
  float v[NW * L * NFIELDS];
  __device__ __forceinline__ float& operator()(int f, int w, int l) {
    return v[(w * L + l) * NFIELDS + f];
  }
};

// two blocks an SM: up to 128 registers a thread (see the header)
template <int NW, int L>
__global__ void __launch_bounds__(SMALL_WARPS * 32, 2)
window_stats_small(const Args a, const WindowsArg win) {
  static_assert(NW <= 2, "two window bits a slot");
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * SMALL_WARPS + (threadIdx.x >> 5);
  if (q >= a.Q) return;
  const int64_t key = a.q_key[q];
  const int32_t ts_q = a.q_ts[q];
  const int32_t B = a.B;
  const int32_t b_q = floordiv(ts_q, B);
  const int64_t tail_from = (int64_t)b_q * B;
  Windows s;
  window_bounds<NW>(win, NW, ts_q, B, b_q, s);

  Acc<NW, L> c;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int f = 0; f < NFIELDS; ++f) c(f, w, l) = field_identity(f);
  int rcnt[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) rcnt[w] = 0;
  unsigned touched = 0;

  const int32_t* ts_row = a.ring_ts + key * a.C;
  const float* g_row = a.ring_lanes + key * a.C * L;
  const int32_t* id_row = a.bbucket + key * a.NB;
  const float* st_row = a.bstats + key * a.NB * L * 5;
  const int rounds = rounds_of(a);
  for (int r = 0; r < rounds; ++r) {
    int4 tv[VB_TS], iv[VB_ID];
    load_round(a, ts_row, id_row, r, lane, tv, iv);
    // the window bits of the round's ring and bucket slots, 2 bits a slot
    uint32_t rawm = 0, midm = 0;
#pragma unroll
    for (int p = 0; p < 4 * VB_TS; ++p)
      rawm |= raw_mask<NW>(s, NW, part(tv[p >> 2], p & 3), ts_q, tail_from)
              << (2 * p);
#pragma unroll
    for (int p = 0; p < 4 * VB_ID; ++p)
      midm |= mid_mask<NW>(s, NW, part(iv[p >> 2], p & 3), b_q) << (2 * p);
    touched |= window_bits(rawm) | (window_bits(midm) << MID_BIT);

    // raw rows: every load issued, then the folds in slot order
    if (rawm) {
      float g[4 * VB_TS][L];
#pragma unroll
      for (int p = 0; p < 4 * VB_TS; ++p) {
        if (!((rawm >> (2 * p)) & 3u)) continue;
        const int64_t slot =
            4 * (int64_t)((r * VB_TS + (p >> 2)) * 32 + lane) + (p & 3);
        if constexpr (L == 2) {
          if (a.row_vec2) {
            const float2 v =
                __ldg(reinterpret_cast<const float2*>(g_row) + slot);
            g[p][0] = v.x;
            g[p][1] = v.y;
            continue;
          }
        }
#pragma unroll
        for (int l = 0; l < L; ++l) g[p][l] = __ldg(g_row + slot * L + l);
      }
#pragma unroll
      for (int p = 0; p < 4 * VB_TS; ++p) {
        const unsigned m = (rawm >> (2 * p)) & 3u;
        if (!m) continue;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (!((m >> w) & 1u)) continue;
          rcnt[w] += 1;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const float x = g[p][l];
            c(RSUM, w, l) = __fadd_rn(c(RSUM, w, l), x);
            c(RMIN, w, l) = fmin_ref(c(RMIN, w, l), x);
            c(RMAX, w, l) = fmax_ref(c(RMAX, w, l), x);
            c(RSQ, w, l) = __fadd_rn(c(RSQ, w, l), __fmul_rn(x, x));
          }
        }
      }
    }

    // middle buckets: MID_CHUNK of a lane's hits at a time, in slot order,
    // every load of a chunk issued before its folds
    uint32_t hits = 0;
#pragma unroll
    for (int p = 0; p < 4 * VB_ID; ++p)
      hits |= (uint32_t)(((midm >> (2 * p)) & 3u) != 0) << p;
    while (__any_sync(FULL, hits != 0)) {
      int pos[MID_CHUNK];
      float x[MID_CHUNK][L * 5];
#pragma unroll
      for (int k = 0; k < MID_CHUNK; ++k) {
        pos[k] = hits ? __ffs(hits) - 1 : -1;
        hits &= hits - 1;
      }
#pragma unroll
      for (int k = 0; k < MID_CHUNK; ++k) {
        if (pos[k] < 0) continue;
        const int64_t slot =
            4 * (int64_t)((r * VB_ID + (pos[k] >> 2)) * 32 + lane) +
            (pos[k] & 3);
        const float* st = st_row + slot * L * 5;
        if constexpr ((L * 5) % 2 == 0) {
          if (a.st_vec2) {
#pragma unroll
            for (int i = 0; i < L * 5 / 2; ++i) {
              const float2 v = __ldg(reinterpret_cast<const float2*>(st) + i);
              x[k][2 * i] = v.x;
              x[k][2 * i + 1] = v.y;
            }
            continue;
          }
        }
#pragma unroll
        for (int i = 0; i < L * 5; ++i) x[k][i] = __ldg(st + i);
      }
#pragma unroll
      for (int k = 0; k < MID_CHUNK; ++k) {
        if (pos[k] < 0) continue;
        const unsigned m = (midm >> (2 * pos[k])) & 3u;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (!((m >> w) & 1u)) continue;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const float* y = x[k] + l * 5;
            c(MSUM, w, l) = __fadd_rn(c(MSUM, w, l), y[0]);
            c(MCNT, w, l) = __fadd_rn(c(MCNT, w, l), y[1]);
            c(MMIN, w, l) = fmin_ref(c(MMIN, w, l), y[2]);
            c(MMAX, w, l) = fmax_ref(c(MMAX, w, l), y[3]);
            c(MSQ, w, l) = __fadd_rn(c(MSQ, w, l), y[4]);
          }
        }
      }
    }
  }

  // one reduction per accumulator, skipped where no lane touched the group
  const unsigned any = __reduce_or_sync(FULL, touched);
  float ql[L];
#pragma unroll
  for (int l = 0; l < L; ++l) ql[l] = __ldg(a.q_lanes + (int64_t)q * L + l);
  float mine = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const bool raw_any = (any >> w) & 1u;
    const bool mid_any = (any >> (MID_BIT + w)) & 1u;
    const float rc = raw_any ? (float)__reduce_add_sync(FULL, rcnt[w]) : 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float r0 = c(RSUM, w, l), r2 = c(RMIN, w, l), r3 = c(RMAX, w, l),
            r4 = c(RSQ, w, l);
      if (raw_any) {
        r0 = warp_sum(r0); r2 = warp_min(r2); r3 = warp_max(r3);
        r4 = warp_sum(r4);
      }
      float m0 = c(MSUM, w, l), m1 = c(MCNT, w, l), m2 = c(MMIN, w, l),
            m3 = c(MMAX, w, l), m4 = c(MSQ, w, l);
      if (mid_any) {
        m0 = warp_sum(m0); m1 = warp_sum(m1); m2 = warp_min(m2);
        m3 = warp_max(m3); m4 = warp_sum(m4);
      }
      const float o[5] = {
          __fadd_rn(__fadd_rn(r0, ql[l]), m0),
          __fadd_rn(__fadd_rn(rc, 1.0f), m1),
          fmin_ref(fmin_ref(r2, ql[l]), m2),
          fmax_ref(fmax_ref(r3, ql[l]), m3),
          __fadd_rn(__fadd_rn(r4, __fmul_rn(ql[l], ql[l])), m4),
      };
#pragma unroll
      for (int f = 0; f < 5; ++f)
        if (lane == (w * L + l) * 5 + f) mine = o[f];
    }
  }
  if (lane < NW * L * 5) a.out[(int64_t)q * (NW * L * 5) + lane] = mine;
}

// ---------------------------------------------------------------------------
// general: accumulators in shared memory, [entry][32] a warp
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
window_stats_general(const Args a, const WindowsArg win) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= a.Q) return;
  const int nw = a.nw, lc = a.lc, L = a.L;
  const int E = NFIELDS * nw * lc;
  float* acc = smem + (int64_t)warp * E * 32 + lane;  // entry e at acc[32 e]
  for (int e = 0; e < E; ++e) acc[32 * e] = field_identity(e % NFIELDS);

  const int64_t key = a.q_key[q];
  const int32_t ts_q = a.q_ts[q];
  const int32_t B = a.B;
  const int32_t b_q = floordiv(ts_q, B);
  const int64_t tail_from = (int64_t)b_q * B;
  Windows s;
  window_bounds<MAX_WINDOWS>(win, nw, ts_q, B, b_q, s);
  int rcnt[MAX_WINDOWS];
#pragma unroll
  for (int w = 0; w < MAX_WINDOWS; ++w) rcnt[w] = 0;
  unsigned touched = 0;

  const int32_t* ts_row = a.ring_ts + key * a.C;
  const float* g_row = a.ring_lanes + key * a.C * L + a.l0;
  const int32_t* id_row = a.bbucket + key * a.NB;
  const float* st_row = a.bstats + (key * a.NB * L + a.l0) * 5;
  scan_key(a, ts_row, id_row, lane,
    [&](int32_t ts, int64_t slot) {
      const unsigned m = raw_mask<MAX_WINDOWS>(s, nw, ts, ts_q, tail_from);
      if (m == 0) return;
#pragma unroll
      for (int w = 0; w < MAX_WINDOWS; ++w) rcnt[w] += (m >> w) & 1u;
      for (int l = 0; l < lc; ++l) {
        const float g = __ldg(g_row + slot * L + l);
        const float gg = __fmul_rn(g, g);
        for (int w = 0; w < nw; ++w) {
          if (!((m >> w) & 1u)) continue;
          float* e = acc + 32 * ((w * lc + l) * NFIELDS);
          e[32 * RSUM] = __fadd_rn(e[32 * RSUM], g);
          e[32 * RMIN] = fmin_ref(e[32 * RMIN], g);
          e[32 * RMAX] = fmax_ref(e[32 * RMAX], g);
          e[32 * RSQ] = __fadd_rn(e[32 * RSQ], gg);
        }
      }
      touched |= m;
    },
    [&](int32_t id, int64_t slot) {
      const unsigned m = mid_mask<MAX_WINDOWS>(s, nw, id, b_q);
      if (m == 0) return;
      const float* st = st_row + slot * L * 5;
      for (int l = 0; l < lc; ++l) {
        float x[5];
#pragma unroll
        for (int f = 0; f < 5; ++f) x[f] = __ldg(st + l * 5 + f);
        for (int w = 0; w < nw; ++w) {
          if (!((m >> w) & 1u)) continue;
          float* e = acc + 32 * ((w * lc + l) * NFIELDS);
          e[32 * MSUM] = __fadd_rn(e[32 * MSUM], x[0]);
          e[32 * MCNT] = __fadd_rn(e[32 * MCNT], x[1]);
          e[32 * MMIN] = fmin_ref(e[32 * MMIN], x[2]);
          e[32 * MMAX] = fmax_ref(e[32 * MMAX], x[3]);
          e[32 * MSQ] = __fadd_rn(e[32 * MSQ], x[4]);
        }
      }
      touched |= m << MID_BIT;
    });

  // reduce each entry; lane 0 keeps the result in its own column
  const unsigned any = __reduce_or_sync(FULL, touched);
  float rc[MAX_WINDOWS];
#pragma unroll
  for (int w = 0; w < MAX_WINDOWS; ++w)
    rc[w] = ((any >> w) & 1u) ? (float)__reduce_add_sync(FULL, rcnt[w]) : 0.f;
  for (int e = 0; e < E; ++e) {
    const int f = e % NFIELDS, w = e / (NFIELDS * lc);
    const int bit = f < MSUM ? w : MID_BIT + w;
    if (!((any >> bit) & 1u)) continue;  // every lane holds the identity
    float v = acc[32 * e];
    if (f == RMIN || f == MMIN) v = warp_min(v);
    else if (f == RMAX || f == MMAX) v = warp_max(v);
    else v = warp_sum(v);
    if (lane == 0) acc[32 * e] = v;
  }
  __syncwarp();
  const float* res = acc - lane;  // lane 0's column: the reduced entries
  for (int t = lane; t < nw * lc * 5; t += 32) {
    const int w = t / (lc * 5), l = (t / 5) % lc, f = t % 5;
    const float* r = res + 32 * ((w * lc + l) * NFIELDS);
    const float ql = __ldg(a.q_lanes + (int64_t)q * L + a.l0 + l);
    float rcw = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_WINDOWS; ++i)
      if (i == w) rcw = rc[i];
    float o;
    if (f == 0) o = __fadd_rn(__fadd_rn(r[32 * RSUM], ql), r[32 * MSUM]);
    else if (f == 1) o = __fadd_rn(__fadd_rn(rcw, 1.0f), r[32 * MCNT]);
    else if (f == 2) o = fmin_ref(fmin_ref(r[32 * RMIN], ql), r[32 * MMIN]);
    else if (f == 3) o = fmax_ref(fmax_ref(r[32 * RMAX], ql), r[32 * MMAX]);
    else o = __fadd_rn(__fadd_rn(r[32 * RSQ], __fmul_rn(ql, ql)), r[32 * MSQ]);
    a.out[(((int64_t)q * a.NW_total + a.w0 + w) * L + a.l0 + l) * 5 + f] = o;
  }
}

template <int NW, int L>
cudaError_t launch_small(const Args& a, const WindowsArg& win,
                         cudaStream_t stream) {
  const int blocks = (a.Q + SMALL_WARPS - 1) / SMALL_WARPS;
  window_stats_small<NW, L><<<blocks, SMALL_WARPS * 32, 0, stream>>>(a, win);
  return cudaGetLastError();
}

}  // namespace

// One launch over Q requests for windows [w0, w0 + nw) (their lengths in
// `windows`) and lanes [l0, l0 + lc) of the output.  small != 0: the
// register instantiation (nw == NW_total <= 2, lc == L <= 2); else
// `general` with `warps` requests a block and `smem` bytes of shared
// memory (warps * 9 * nw * lc * 32 floats).  Returns a cudaError_t.
extern "C" int window_stats_launch(
    const int32_t* ring_ts, const float* ring_lanes, const float* bstats,
    const int32_t* bbucket, const int32_t* q_key, const int32_t* q_ts,
    const float* q_lanes, float* out, WindowsArg windows, int Q, int C,
    int NB, int L, int NW_total, int w0, int nw, int l0, int lc,
    int bucket_size, int small, int warps, int smem, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0) return 0;
  if (bucket_size <= 0 || nw < 1 || nw > MAX_WINDOWS || lc < 1 ||
      l0 + lc > L || w0 + nw > NW_total)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ring_ts = ring_ts; a.ring_lanes = ring_lanes; a.bstats = bstats;
  a.bbucket = bbucket; a.q_key = q_key; a.q_ts = q_ts; a.q_lanes = q_lanes;
  a.out = out;
  a.Q = Q; a.C = C; a.NB = NB; a.L = L; a.NW_total = NW_total; a.w0 = w0;
  a.nw = nw; a.l0 = l0; a.lc = lc; a.B = bucket_size;
  a.ts_vec = (C % 4 == 0) && ((uintptr_t)ring_ts % 16 == 0);
  a.id_vec = (NB % 4 == 0) && ((uintptr_t)bbucket % 16 == 0);
  a.row_vec2 = (L == 2) && ((uintptr_t)ring_lanes % 8 == 0);
  a.st_vec2 = (L % 2 == 0) && ((uintptr_t)bstats % 8 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (small) {
    if (nw != NW_total || lc != L || w0 != 0 || l0 != 0)
      return (int)cudaErrorInvalidValue;
    switch (nw * 4 + lc) {
      case 1 * 4 + 1: return (int)launch_small<1, 1>(a, windows, st);
      case 1 * 4 + 2: return (int)launch_small<1, 2>(a, windows, st);
      case 2 * 4 + 1: return (int)launch_small<2, 1>(a, windows, st);
      case 2 * 4 + 2: return (int)launch_small<2, 2>(a, windows, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (warps < 1 || warps > 8 ||
      (int64_t)smem < (int64_t)warps * 9 * nw * lc * 32 * 4)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(window_stats_general,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (Q + warps - 1) / warps;
  window_stats_general<<<blocks, warps * 32, smem, st>>>(a, windows);
  return (int)cudaGetLastError();
}
