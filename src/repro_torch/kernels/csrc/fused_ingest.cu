// Fused ingest: ring scatter + bucket pre-aggregate merge in one launch.
//
// Replaces the Pallas TPU kernel fused_ingest_pallas
// (src/repro/kernels/ingest/ingest.py, body _fused_ingest_kernel).  That
// kernel walks the (key, ts)-sorted batch row by row over a sequential
// grid, carrying a per-(key, bucket) accumulator in VMEM from one grid step
// to the next.  Blocks on Hopper run in no order, so nothing may carry
// between them; this kernel computes the same function with one thread
// per (row, lane) instead, driven by the plan that ops.py computes on the
// device (see PLAN_ROWS there; the P_* indices below follow it):
//
//   * a row with ring_w set writes its ts (lane 0) and lane value into
//     ring slot slot_r of its key — only a run's last C rows carry
//     ring_w, so slots never collide and the last row wins, as in the
//     plain version's scatter;
//   * the last valid row of a key run (kend) writes the new cursor;
//   * the thread on a segment's first row (walk) folds the segment's
//     valid rows sequentially in row order, ((ident + r0) + r1) ..., then
//     merges the fold into bucket slot slot_b of its key — resetting the
//     slot to identity first when it holds a stale bucket id — and lane 0
//     writes the bucket id.  No atomics and no tree reduction, so every
//     float sum associates exactly as the plain version's row-order fold.
//     Segments own distinct (key, slot) pairs (a batch spans fewer than NB
//     buckets), so no two threads write one state element.
//
// Exactness: built with -fmad=false, and every add / multiply is an
// explicit __fadd_rn / __fmul_rn, so the sumsq increment is the rounded
// v*v the plain version materializes (no fused multiply-add).  The
// distinct-bitmap hash (mix32 chain, salt 77) runs in uint32_t, where
// wrap-around is defined; the reference's arithmetic first shift is
// reproduced on the int32 view.
//
// Bound on the H100: bytes moved.  A batch of N rows and F lanes touches
// one ring slot per written row (4 + 4F bytes) and one bucket slot per
// segment (2 x (20F + 4F) + 4 bytes read and written), plus the batch and
// the plan; there is no arithmetic to speak of.  The design keeps that to
// one pass: each state element is read and written at most once, and each
// thread's walk reads only its own segment's rows.  The writes land in
// scattered 32-byte sectors (one key's slots are contiguous, keys are
// not), which is what keeps it from the streaming rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_STATS = 5;
constexpr float POS_INF = 3.0e38f;
constexpr float NEG_INF = -3.0e38f;

// plan rows (kernels/ingest/ops.py PLAN_ROWS)
enum {
  P_CKEY = 0, P_VALID, P_SSTART, P_WALK, P_SLOT_R, P_RING_W, P_KEND,
  P_CUR_NEW, P_CBID, P_SLOT_B, P_STALE
};

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t salt) {
  h ^= salt & 0x7FFFFFFFu;
  h ^= (uint32_t)(((int32_t)h) >> 16);  // arithmetic shift, unmasked
  h *= 0x85EBCA6Bu;
  h ^= (h >> 13) & 0x0007FFFFu;
  h *= 0xC2B2AE35u;
  h ^= (h >> 16) & 0x0000FFFFu;
  return h;
}

// aggregates.row_bitmap: 1 << (|mix64(bits(v), salt=77)| % 32)
__device__ __forceinline__ int32_t row_bitmap(float v) {
  uint32_t h1 = mix32(__float_as_uint(v), 77u);
  uint32_t h2 = mix32(h1 ^ 0x5BD1E995u, 77u ^ 0x27D4EB2Fu);
  uint32_t h = h1 ^ (h2 * 5u + 0x38495AB5u);
  uint32_t a = ((int32_t)h < 0) ? (0u - h) : h;  // abs, INT_MIN wraps
  return (int32_t)(1u << (a & 31u));
}

__global__ void fused_ingest_kernel(
    int32_t* __restrict__ ring_ts, float* __restrict__ ring_vals,
    int32_t* __restrict__ cursor, float* __restrict__ bstats,
    int32_t* __restrict__ bbitmap, int32_t* __restrict__ bbucket,
    const int32_t* __restrict__ ts, const float* __restrict__ vals,
    const int32_t* __restrict__ plan, int n, int F, int C, int NB) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)n * F) return;
  const int i = (int)(tid / F);
  const int f = (int)(tid % F);
  const int32_t* P = plan;
#define PL(row, j) P[(long long)(row) * n + (j)]
  const long long k = PL(P_CKEY, i);

  if (PL(P_RING_W, i)) {
    const long long r = k * C + PL(P_SLOT_R, i);
    ring_vals[r * F + f] = vals[(long long)i * F + f];
    if (f == 0) ring_ts[r] = ts[i];
  }
  if (f == 0 && PL(P_KEND, i)) cursor[k] = PL(P_CUR_NEW, i);

  if (PL(P_WALK, i)) {
    float s = 0.0f, c = 0.0f, mn = POS_INF, mx = NEG_INF, sq = 0.0f;
    int32_t bm = 0;
    for (int j = i; j < n; ++j) {
      if (j > i && PL(P_SSTART, j)) break;
      if (!PL(P_VALID, j)) continue;
      const float v = vals[(long long)j * F + f];
      s = __fadd_rn(s, v);
      c = __fadd_rn(c, 1.0f);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
      bm |= row_bitmap(v);
    }
    const long long slot = k * NB + PL(P_SLOT_B, i);
    const bool stale = PL(P_STALE, i) != 0;
    float* st = bstats + (slot * F + f) * NUM_STATS;
    const float b0 = stale ? 0.0f : st[0];
    const float b1 = stale ? 0.0f : st[1];
    const float b2 = stale ? POS_INF : st[2];
    const float b3 = stale ? NEG_INF : st[3];
    const float b4 = stale ? 0.0f : st[4];
    st[0] = __fadd_rn(b0, s);
    st[1] = __fadd_rn(b1, c);
    st[2] = fminf(b2, mn);
    st[3] = fmaxf(b3, mx);
    st[4] = __fadd_rn(b4, sq);
    int32_t* bmp = bbitmap + slot * F + f;
    *bmp = (stale ? 0 : *bmp) | bm;
    if (f == 0) bbucket[slot] = PL(P_CBID, i);
  }
#undef PL
}

}  // namespace

extern "C" int fused_ingest_launch(
    int32_t* ring_ts, float* ring_vals, int32_t* cursor, float* bstats,
    int32_t* bbitmap, int32_t* bbucket, const int32_t* ts, const float* vals,
    const int32_t* plan, int n, int F, int C, int NB, int K, int device,
    void* stream) {
  (void)K;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)n * F;
  if (threads == 0) return 0;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  fused_ingest_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket, ts, vals, plan,
      n, F, C, NB);
  return (int)cudaGetLastError();
}
