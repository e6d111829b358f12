// Window stats: the pre-aggregated multi-window query.  For every request
// row q, RANGE window T and lane l, the five stats (sum, count, min, max,
// sumsq) over the window (ts_q - T, ts_q] of the request key's history,
// the request row included:
//
//   raw rows     ring slots in the oldest partial bucket (b_lo, when it is
//                not the request's bucket) and in the request's bucket
//                b_q, inside the window and not in the future;
//   middle       bucket pre-aggregates whose stored id lies strictly
//                between b_lo and b_q;
//   out          (raw + request row) combined with middle, as
//                window_stats_ref (kernels/window_agg/ref.py) composes it.
//
// with b_q = floor(ts_q / B) and b_lo = floor((ts_q - T) / B).
//
// Replaces the Pallas TPU kernel window_stats_pallas
// (src/repro/kernels/window_agg/window_agg.py, body _window_agg_kernel).
// There a scalar-prefetched index map DMAs the key's (C, L) ring tile and
// (NB, L, 5) bucket tile into VMEM, one grid step per query.  Here one
// block of 256 threads per query gathers the same rows itself: each thread
// folds a strided share of the C ring slots and the NB bucket slots, and
// the block reduces the ten partial stats with warp shuffles, for every
// (window, lane).  The gathered rows stay in L1 / L2 across windows and
// lanes.
//
// Traps: b_lo is negative early in the timeline and empty ring slots hold
// TS_EMPTY = -2^31, so bucket ids use floor division, not C's truncating
// one; ts_q - T wraps as int32, as in the reference.
//
// Exactness: count (a sum of ones), min and max are exact in any order and
// equal the plain version bit for bit.  Sum and sumsq reduce in the
// block's tree order, which no reference fixes (the plain version reduces
// in PyTorch's order); built with -fmad=false so g * g is rounded before
// it is added, as in the plain version.
//
// Bound on the H100: bytes, counted on the data (chip_smoke.py,
// _window_stats_bytes).  Per distinct key the C ring timestamps (4C), the
// lanes of the ring rows folded raw (4L each), the ids of the bucket slots
// that can hold a middle bucket of the widest window (4 each; at most
// ceil(T_max / B) + 1 of the NB slots) and the stats of the slots whose id
// is a middle bucket (20L each); per query the request (8 + 4L) and the
// output (NW * L * 20).  This kernel reads every ring and bucket slot of
// the key, so on sparse histories it is far above that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int32_t TS_EMPTY = INT32_MIN;
constexpr float POS_INF = 3.0e38f;
constexpr float NEG_INF = -3.0e38f;

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  // b > 0
  int32_t q = a / b;
  if ((a % b) != 0 && a < 0) q -= 1;
  return q;
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
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

struct Stats {
  float v[10];  // raw: sum, count, min, max, sumsq; middle: the same
};

__device__ __forceinline__ void stats_init(Stats& s) {
  s.v[0] = 0.f; s.v[1] = 0.f; s.v[2] = POS_INF; s.v[3] = NEG_INF; s.v[4] = 0.f;
  s.v[5] = 0.f; s.v[6] = 0.f; s.v[7] = POS_INF; s.v[8] = NEG_INF; s.v[9] = 0.f;
}

__device__ __forceinline__ void stats_merge(Stats& a, const Stats& b) {
#pragma unroll
  for (int h = 0; h < 10; h += 5) {
    a.v[h + 0] = __fadd_rn(a.v[h + 0], b.v[h + 0]);
    a.v[h + 1] = __fadd_rn(a.v[h + 1], b.v[h + 1]);
    a.v[h + 2] = fmin_ref(a.v[h + 2], b.v[h + 2]);
    a.v[h + 3] = fmax_ref(a.v[h + 3], b.v[h + 3]);
    a.v[h + 4] = __fadd_rn(a.v[h + 4], b.v[h + 4]);
  }
}

__device__ __forceinline__ void warp_reduce(Stats& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
#pragma unroll
    for (int j = 0; j < 10; ++j) o.v[j] = __shfl_down_sync(0xFFFFFFFFu, s.v[j], off);
    stats_merge(s, o);
  }
}

__global__ void window_stats_kernel(
    const int32_t* __restrict__ ring_ts,     // (K, C)
    const float* __restrict__ ring_lanes,    // (K, C, L)
    const float* __restrict__ bstats,        // (K, NB, L, 5)
    const int32_t* __restrict__ bbucket,     // (K, NB)
    const int32_t* __restrict__ q_key,       // (Q,)
    const int32_t* __restrict__ q_ts,        // (Q,)
    const float* __restrict__ q_lanes,       // (Q, L)
    const int32_t* __restrict__ windows,     // (NW,)
    float* __restrict__ out,                 // (Q, NW, L, 5)
    int C, int NB, int L, int NW, int B) {
  __shared__ Stats partial[WARPS];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int64_t key = q_key[q];
  const int32_t ts_q = q_ts[q];
  const int32_t* ts_row = ring_ts + key * C;
  const float* g_row = ring_lanes + key * C * L;
  const int32_t* id_row = bbucket + key * NB;
  const float* st_row = bstats + key * NB * L * 5;
  const int32_t b_q = floordiv(ts_q, B);

  for (int w = 0; w < NW; ++w) {
    const int32_t T = windows[w];
    const int32_t lo = wrap_sub(ts_q, T) + 1;
    const int32_t b_lo = floordiv(wrap_sub(ts_q, T), B);
    for (int l = 0; l < L; ++l) {
      Stats s;
      stats_init(s);
      for (int c = tid; c < C; c += THREADS) {
        const int32_t ts = ts_row[c];
        const int32_t brow = floordiv(ts, B);
        const bool in = ts != TS_EMPTY && ts <= ts_q && ts >= lo;
        const bool raw = in && ((brow == b_lo && b_lo != b_q) || brow == b_q);
        if (raw) {
          const float g = g_row[(int64_t)c * L + l];
          s.v[0] = __fadd_rn(s.v[0], g);
          s.v[1] = __fadd_rn(s.v[1], 1.0f);
          s.v[2] = fmin_ref(s.v[2], g);
          s.v[3] = fmax_ref(s.v[3], g);
          s.v[4] = __fadd_rn(s.v[4], __fmul_rn(g, g));
        }
      }
      for (int nb = tid; nb < NB; nb += THREADS) {
        const int32_t id = id_row[nb];
        if (id > b_lo && id < b_q) {
          const float* st = st_row + ((int64_t)nb * L + l) * 5;
          s.v[5] = __fadd_rn(s.v[5], st[0]);
          s.v[6] = __fadd_rn(s.v[6], st[1]);
          s.v[7] = fmin_ref(s.v[7], st[2]);
          s.v[8] = fmax_ref(s.v[8], st[3]);
          s.v[9] = __fadd_rn(s.v[9], st[4]);
        }
      }
      warp_reduce(s);
      if (lane_id == 0) partial[warp] = s;
      __syncthreads();
      if (tid == 0) {
        Stats t = partial[0];
        for (int j = 1; j < WARPS; ++j) stats_merge(t, partial[j]);
        const float ql = q_lanes[(int64_t)q * L + l];
        float* o = out + (((int64_t)q * NW + w) * L + l) * 5;
        o[0] = __fadd_rn(__fadd_rn(t.v[0], ql), t.v[5]);
        o[1] = __fadd_rn(__fadd_rn(t.v[1], 1.0f), t.v[6]);
        o[2] = fmin_ref(fmin_ref(t.v[2], ql), t.v[7]);
        o[3] = fmax_ref(fmax_ref(t.v[3], ql), t.v[8]);
        o[4] = __fadd_rn(__fadd_rn(t.v[4], __fmul_rn(ql, ql)), t.v[9]);
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int window_stats_launch(
    const int32_t* ring_ts, const float* ring_lanes, const float* bstats,
    const int32_t* bbucket, const int32_t* q_key, const int32_t* q_ts,
    const float* q_lanes, const int32_t* windows, float* out, int Q, int C,
    int NB, int L, int NW, int bucket_size, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0) return 0;
  if (bucket_size <= 0) return (int)cudaErrorInvalidValue;
  window_stats_kernel<<<Q, THREADS, 0, (cudaStream_t)stream>>>(
      ring_ts, ring_lanes, bstats, bbucket, q_key, q_ts, q_lanes, windows,
      out, C, NB, L, NW, bucket_size);
  return (int)cudaGetLastError();
}
