// Flash attention: causal / sliding-window grouped-query attention with an
// online softmax.  For q (B, H, S, D), k and v (B, Hkv, S, D), query head h
// reads KV head h / (H / Hkv), and per query row q_pos
//
//     o = Σ_k softmax_k(scale · q·k) v,   over k_pos < S, k_pos <= q_pos
//                                          (causal), k_pos > q_pos - window
//
// with float32 scores, running max, denominator and accumulator, the
// output in q's dtype (float32 or bf16).
//
// Replaces the Pallas TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py, body flash_attention_kernel).  On the
// TPU the grid is (B, H, S/bq, S/bk) with the KV axis sequential, the
// running state in VMEM scratch, and every KV block computed, masked or
// not.  Here a block owns one (b, h) query tile -- or, for short
// sequences, one (b, KV head) -- and loops over the KV tiles itself, only
// over those the causal limit and the window can reach (a skipped tile is
// all masked and adds nothing on the TPU either).  Kept of the
// reference's arithmetic: masked scores -1e30 (here -inf inside a tile,
// which gives the same zero weights) and masked weights 0; alpha = 0 while
// the running max is still -1e30; the final divide by max(l, 1e-30), so a
// row with no visible key comes out 0.
//
// Bound on the H100: operations -- 4·D FLOP per visible (q, k) pair and
// head at 989 TFLOP/s of bf16 tensor-core peak -- for long sequences;
// bytes (q, k, v read once, o written once at 3.35 TB/s) for short ones
// and for small D.  Four instantiations, chosen by the wrapper
// (kernels/flash_attention/ops.py, plan_attention):
//
// 1. fa_wgmma_kernel -- bf16, S > 128: Hopper's own design.  A producer
//    warpgroup (one thread issues) loads the query tile once and K / V
//    tiles into a two-stage ring by TMA (128-byte swizzle, 64-column
//    boxes, the ragged edge zero-filled by the hardware), with a full
//    mbarrier per stage and tensor, an empty one per stage.  Consumer
//    warpgroups own 64 query rows each (two at D <= 128: a 128-row tile
//    over 128-row KV tiles; one at D = 256 over 64-row KV tiles) and run
//    S = Q Kᵀ as wgmma with both operands in shared memory (K-major), the
//    online softmax in registers (a row's max and sum over the 4 lanes of
//    a quad), and O += P V as wgmma with P in registers -- the S
//    accumulator converted to bf16 A fragments in place -- and V read
//    MN-major (the transpose bit).  Tiles wholly inside the causal limit
//    and the window skip the mask.  setmaxnreg moves registers from the
//    producer to the two consumers.  Longest query tiles launch first.
// 2. fa_mma16_kernel -- bf16, S <= 128 (the fraud scorer's 65 rows): a
//    64-row wgmma tile would compute mostly padding, and the call is
//    bound by bytes.  One block per (b, KV head) stages that head's whole
//    K and V in shared memory once (cp.async, zero-filled past S and D);
//    each warp takes 16-row query tiles of the group's heads and runs
//    mma.sync.m16n8k16 over only the keys the tile can see.
// 3. fa_simt_kernel -- float32: CUDA-core products (explicit fmaf, expf,
//    the IEEE divide) to hold the reference's 2e-5; on tensor cores
//    float32 would run as TF32.  A 64-row query tile at D <= 128, a
//    32-row one above, so the accumulator stays in registers.
// 4. fa_wide_kernel -- D > 256, float32 or bf16, on the CUDA cores: the
//    output columns split across blocks, 256 to a block; each block forms
//    the scores from all of D in 128-column slices of q and k, summed in
//    float32.
//
// In 1 and 2 the weights P are rounded to bf16 for the PV product (the
// reference model's gqa_attention rounds them the same way); the
// denominator l sums the float32 P.
//
// Layouts: per-(b, h, s) element strides with D contiguous, so the model
// passes its (B, S, H, hd) activations as transposed views without a
// copy.  The bf16 instantiations need D a multiple of 16 and 16-byte
// aligned bases and strides (TMA, cp.async); the wrapper pads or copies
// where they are not.  D up to 256 on the tiled instantiations; any D
// above on fa_wide_kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3];  // (b, h, s) element strides
  int causal, has_window, window;
  float scale;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the keys any of rows q0 .. q0 + rows - 1 can see: [k_lo, k_hi)
__device__ __forceinline__ void key_range(const Params& p, int q0, int rows,
                                          int& k_lo, int& k_hi) {
  k_lo = 0;
  k_hi = p.S;
  if (p.causal) k_hi = min(p.S, q0 + rows);
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  bool ok = key < p.S;
  if (p.causal) ok = ok && key <= row;
  if (p.has_window) ok = ok && key > row - p.window;
  return ok;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// 3. float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 128;  // threads: 16 row groups x 8 column groups

// a BQ-row query tile over BK = BQ-row KV tiles; tiles are float32 rows of
// DP + 4 floats (DP = D rounded up to 32; the padded columns are zeros and
// add nothing; the 4-float pad shifts rows by four banks, so the float4
// reads are conflict-free): 101,376 bytes at D = 128 (BQ 64), 99,840 at
// D = 256 (BQ 32), two blocks to an SM.  Thread (ty, tx) = (tid / 8,
// tid % 8) owns query rows ty + 16 i (i < BQ / 16) -- score columns
// tx + 8 j (j < BK / 8) and output columns 4 tx + 32 jj + e -- so a row's
// max and sum reduce over the 8 lanes of one warp with shuffles.
template <int DP, int BQ>
struct Simt {
  static constexpr int BK = BQ;
  static constexpr int LD = DP + 4;  // row stride of the q, k, v tiles
  static constexpr int LP = BK + 4;  // row stride of the weights
  static constexpr int RI = BQ / 16;
  static constexpr int KJ = BK / 8;
  static constexpr int CJ = DP / 32;
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)BQ * LD + cmax(BK * LD, BQ * LP) +
                            (size_t)BK * LD);
  }
};

// rows row0 .. row0 + ROWS - 1 of one head into a tile of rows of DP + 4
// floats; rows >= S and columns >= D are zeros
template <int DP, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int row0, int S, int D) {
  constexpr int LD = DP + 4;
#pragma unroll 8
  for (int it = 0; it < ROWS * DP / NT; ++it) {
    const int e = it * NT + threadIdx.x;
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (row0 + r < S && d < D) x = src[(long long)(row0 + r) * rs + d];
    dst[r * LD + d] = x;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <int DP, int BQ>
__global__ void __launch_bounds__(NT, 2) fa_simt_kernel(Params p) {
  using C = Simt<DP, BQ>;
  constexpr int BK = C::BK, LD = C::LD, LP = C::LP, RI = C::RI, KJ = C::KJ,
                CJ = C::CJ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* ps = ks;  // the weights overwrite K once the scores are taken
  float* vs = ks + cmax(BK * LD, BQ * LP);

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const long long b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  stage<DP, BQ>(qs, qg, p.sq[2], q0, p.S, p.D);

  int k_lo, k_hi;
  key_range(p, q0, BQ, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  float acc[RI][CJ][4];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's weights and values are read
    stage<DP, BK>(ks, kg, p.sk[2], k0, p.S, p.D);
    stage<DP, BK>(vs, vg, p.sv[2], k0, p.S, p.D);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 8 j
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // scale and mask; the running max over the 8 lanes of each row
    unsigned valid = 0u;
    float m_new[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const bool ok = visible(p, qp, k0 + tx + 8 * j);
        s[i][j] = ok ? s[i][j] * p.scale : NEG;
        valid |= (ok ? 1u : 0u) << (i * KJ + j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      m_new[i] = fmaxf(m[i], mx);
    }
    __syncthreads();  // every thread is done with K: the weights go there

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pw =
            (valid >> (i * KJ + j)) & 1u ? expf(s[i][j] - m_new[i]) : 0.0f;
        ps[(ty + 16 * i) * LP + tx + 8 * j] = pw;
        sum += pw;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = m[i] == NEG ? 0.0f : expf(m[i] - m_new[i]);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new[i];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * LD + 4 * tx + 32 * jj);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float pw = lane_of(pv[i], cc);
            acc[i][jj][0] = fmaf(pw, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pw, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(pw, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(pw, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = og + (long long)row * p.so[2];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 32 * jj + e;
        if (d < p.D) orow[d] = acc[i][jj][e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// 4. D > 256, float32 or bf16, on the CUDA cores
// ---------------------------------------------------------------------------

// The output's columns are split across blocks: a block owns WIDE_DO of
// them for a WIDE_BQ-row query tile, and forms each score tile from all
// of D in WIDE_DS-column slices of q and k staged in turn (the scores
// summed in float32 registers), then takes its columns of P V.  Every
// column block recomputes the scores: ~D / 256 times the QKᵀ work, for
// head dims no registry config has.  Thread (ty, tx) as in fa_simt_kernel:
// query rows ty + 16 i, score columns tx + 8 j, output columns
// 4 tx + 32 jj + e.  bf16 loads widen to float32 and P rounds to bf16 for
// P V, as in the other bf16 instantiations.
constexpr int WIDE_BQ = 32;
constexpr int WIDE_DS = 128;  // head-dim slice of a score pass
constexpr int WIDE_DO = 256;  // output columns of a block

struct Wide {
  static constexpr int BQ = WIDE_BQ, BK = WIDE_BQ;
  static constexpr int LD = WIDE_DS + 4, LV = WIDE_DO + 4, LP = BK + 4;
  static constexpr int RI = BQ / 16, KJ = BK / 8, CJ = WIDE_DO / 32;
  static constexpr size_t bytes() {
    return sizeof(float) *
           ((size_t)(BQ + BK) * LD + (size_t)BQ * LP + (size_t)BK * LV);
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// rows row0 .. row0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of one head as
// float32 rows of LDT floats; rows >= S and columns >= D are zeros
template <int ROWS, int COLS, int LDT, typename E>
__device__ __forceinline__ void stage_wide(float* dst, const E* src,
                                          long long rs, int row0, int c0,
                                          int S, int D) {
#pragma unroll 4
  for (int it = 0; it < ROWS * COLS / NT; ++it) {
    const int e = it * NT + threadIdx.x;
    const int r = e / COLS, d = e % COLS;
    float x = 0.0f;
    if (row0 + r < S && c0 + d < D)
      x = widen(src[(long long)(row0 + r) * rs + c0 + d]);
    dst[r * LDT + d] = x;
  }
}

template <typename E>
__global__ void __launch_bounds__(NT) fa_wide_kernel(Params p) {
  using C = Wide;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LV = C::LV, LP = C::LP,
                RI = C::RI, KJ = C::KJ, CJ = C::CJ;
  constexpr bool BF16 = sizeof(E) == 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* ps = ks + BK * LD;
  float* vs = ps + BQ * LP;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int nd = (p.D + WIDE_DO - 1) / WIDE_DO;
  const int bh = blockIdx.x / nd;
  const int d0 = (blockIdx.x % nd) * WIDE_DO;
  const long long b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const E* qg = static_cast<const E*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const E* kg = static_cast<const E*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const E* vg = static_cast<const E*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  E* og = static_cast<E*>(p.o) + b * p.so[0] + h * p.so[1];

  int k_lo, k_hi;
  key_range(p, q0, BQ, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  float acc[RI][CJ][4];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
    for (int c0 = 0; c0 < p.D; c0 += WIDE_DS) {
      __syncthreads();  // the last slice's (and tile's) tiles are read
      stage_wide<BQ, WIDE_DS, LD>(qs, qg, p.sq[2], q0, c0, p.S, p.D);
      stage_wide<BK, WIDE_DS, LD>(ks, kg, p.sk[2], k0, c0, p.S, p.D);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < WIDE_DS; d += 4) {
        float4 qv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
    }

    // scale, mask, the running max and the weights (the last tile's P V
    // finished before the slices' first barrier)
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
      bool ok[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        ok[j] = visible(p, qp, k0 + tx + 8 * j);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pw = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += pw;
        ps[(ty + 16 * i) * LP + tx + 8 * j] =
            BF16 ? __bfloat162float(__float2bfloat16(pw)) : pw;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = m[i] == NEG ? 0.0f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    stage_wide<BK, WIDE_DO, LV>(vs, vg, p.sv[2], k0, d0, p.S, p.D);
    __syncthreads();

    // acc += p v over this block's output columns
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * LV + 4 * tx + 32 * jj);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float pw = lane_of(pv[i], cc);
            acc[i][jj][0] = fmaf(pw, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pw, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(pw, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(pw, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    E* orow = og + (long long)row * p.so[2];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 4 * tx + 32 * jj + e;
        if (d < p.D) narrow(orow + d, acc[i][jj][e] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 helpers: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// 2. bf16, S <= 128: 16-row mma.sync tiles over K, V staged once
// ---------------------------------------------------------------------------

constexpr int SHORT_S = 128;  // longest sequence the block stages whole
constexpr int SHORT_KB = 64;  // keys a warp scores at once

// rows of DP + 8 bf16 in shared memory: a row is 2 DP + 16 bytes, so the
// 8 rows one ldmatrix reads start 4 banks apart -- conflict-free.  K and V
// take SP = S rounded up to 16 rows each, every warp a 16-row query slot:
// 34,560 bytes at the scorer's S = 65, D = 64 with 5 warps.
template <int DP>
__host__ __device__ constexpr int mma16_ld() {
  return DP + 8;
}

template <int DP>
__global__ void __launch_bounds__(256) fa_mma16_kernel(Params p) {
  constexpr int LD = mma16_ld<DP>();
  constexpr int CH = DP / 8;  // 16-byte chunks of a row
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem16);
  const int SP = (p.S + 15) / 16 * 16;
  __nv_bfloat16* vs = ks + SP * LD;
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  __nv_bfloat16* qs = vs + SP * LD + warp * 16 * LD;  // this warp's slot

  const int Hkv = p.H / p.group;
  const long long b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int T16 = SP / 16, items = p.group * T16;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0] + hk * p.sv[1];

  // item = (head of the group, 16-row query tile), into this warp's slot
  auto load_q = [&](int item) {
    const int h = hk * p.group + item / T16, q0 = item % T16 * 16;
    const __nv_bfloat16* qg =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0] + h * p.sq[1];
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = e % CH;
      const bool ok = q0 + r < p.S && c * 8 < p.D;
      cp_async16(smem_u32(qs + r * LD + c * 8),
                 ok ? qg + (long long)(q0 + r) * p.sq[2] + c * 8 : qg, ok);
    }
  };

  for (int e = threadIdx.x; e < SP * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < p.S && c * 8 < p.D;
    cp_async16(smem_u32(ks + r * LD + c * 8),
               ok ? kg + (long long)r * p.sk[2] + c * 8 : kg, ok);
    cp_async16(smem_u32(vs + r * LD + c * 8),
               ok ? vg + (long long)r * p.sv[2] + c * 8 : vg, ok);
  }
  if (warp < items) load_q(warp);
  cp_async_wait_all();
  __syncthreads();

  const int g = lane >> 2, tig = lane & 3;
  const float sl = p.scale * LOG2E;
  const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs),
                 q_base = smem_u32(qs);
  for (int item = warp; item < items; item += nw) {
    if (item != warp) {
      __syncwarp();  // the last item's reads of the slot are done
      load_q(item);
      cp_async_wait_all();
      __syncwarp();
    }
    const int h = hk * p.group + item / T16, q0 = item % T16 * 16;
    const int row0 = q0 + g, row1 = row0 + 8;
    int k_lo, k_hi;
    key_range(p, q0, 16, k_lo, k_hi);

    float o[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
    float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

    for (int kb = k_lo / 16 * 16; kb < k_hi; kb += SHORT_KB) {
      // scores of the 16 rows against keys kb .. kb + 63, by 16-key pairs
      // of 8-column mma tiles; pairs at or past k_hi are not computed
      float s[SHORT_KB / 8][4];
#pragma unroll
      for (int j = 0; j < SHORT_KB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_base + ((lane & 15) * LD + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int pp = 0; pp < SHORT_KB / 16; ++pp) {
          const int key0 = kb + pp * 16;
          if (key0 < k_hi) {
            uint32_t bb[4];
            ldsm_x4(bb, k_base + ((key0 + (lane & 7) + (lane >> 4) * 8) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8) * 2);
            mma_bf16(s[2 * pp], a, bb[0], bb[1]);
            mma_bf16(s[2 * pp + 1], a, bb[2], bb[3]);
          }
        }
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < SHORT_KB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 8 * j + 2 * tig + (e & 1);
          const float x =
              visible(p, e < 2 ? row0 : row1, key) ? s[j][e] * sl : -INFINITY;
          s[j][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = m0 == NEG ? 0.0f : exp2f(m0 - mn0);
      const float a1 = m1 == NEG ? 0.0f : exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      uint32_t pa[SHORT_KB / 16][4];
#pragma unroll
      for (int j = 0; j < SHORT_KB / 8; ++j) {
        const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
        const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      // o += p v, V's 16 x 8 tiles transposed by ldmatrix
#pragma unroll
      for (int kc = 0; kc < SHORT_KB / 16; ++kc) {
        const int key0 = kb + kc * 16;
        if (key0 < k_hi) {
#pragma unroll
          for (int jd = 0; jd < DP / 16; ++jd) {
            uint32_t bb[4];
            ldsm_x4_t(bb, v_base + ((key0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                        LD + jd * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(o[2 * jd], pa[kc], bb[0], bb[1]);
            mma_bf16(o[2 * jd + 1], pa[kc], bb[2], bb[3]);
          }
        }
      }
    }

    const float i0 = 1.0f / fmaxf(quad_sum(l0), 1e-30f);
    const float i1 = 1.0f / fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* og =
        static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tig;
      if (d < p.D) {
        if (row0 < p.S)
          store_bf16x2(og + (long long)row0 * p.so[2] + d, o[j][0] * i0,
                       o[j][1] * i0);
        if (row1 < p.S)
          store_bf16x2(og + (long long)row1 * p.so[2] + d, o[j][2] * i1,
                       o[j][3] * i1);
      }
    }
  }
}

template <int DP>
size_t mma16_bytes(int S, int warps) {
  const int SP = (S + 15) / 16 * 16;
  return (size_t)(2 * SP + 16 * warps) * mma16_ld<DP>() * 2;
}

// ---------------------------------------------------------------------------
// 1. bf16, long sequences: TMA ring + wgmma, warp-specialized
// ---------------------------------------------------------------------------

// NC consumer warpgroups of 64 query rows; BK-row KV tiles; ST ring stages
template <int DP>
struct Wg;
template <>
struct Wg<64> {
  static constexpr int NC = 2, BK = 128, ST = 2;
};
template <>
struct Wg<128> {
  static constexpr int NC = 2, BK = 128, ST = 2;
};
template <>
struct Wg<256> {
  static constexpr int NC = 1, BK = 64, ST = 2;
};

template <int DP>
struct WgLayout {
  static constexpr int NC = Wg<DP>::NC, BK = Wg<DP>::BK, ST = Wg<DP>::ST;
  static constexpr int BQ = 64 * NC;
  // a tile of R rows is DP / 64 boxes of R rows x 128 bytes (64 bf16),
  // each 128-byte swizzled by TMA
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  static constexpr uint32_t BARS = Q_BYTES + ST * 2 * KV_BYTES;
  // q_full, k_full[ST], v_full[ST], empty[ST]; 1,024 for aligning the base
  static constexpr size_t bytes() { return BARS + 8 * (1 + 3 * ST) + 1024; }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (64 columns, R rows) at (d0, s0, h, b) of a 4-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(s0), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major tiles (Q, K):
// 8-row groups 1,024 bytes apart (SBO), LBO unused.  MN-major V: 8-key
// groups 1,024 bytes apart (SBO), 64-column boxes LBO apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, "
      "%132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
}

template <int DP>
__global__ void __launch_bounds__(128 * (Wg<DP>::NC + 1), 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using L = WgLayout<DP>;
  constexpr int NC = L::NC, BK = L::BK, ST = L::ST, BQ = L::BQ, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, skv = base + L::Q_BYTES;
  const uint32_t q_full = base + L::BARS;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * ST + s); };
  auto k_tile = [&](int s) { return skv + s * 2 * L::KV_BYTES; };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  int k_lo, k_hi;
  key_range(p, q0, BQ, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int nt = max(0, (k_hi + BK - 1) / BK - t_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load(sq + nb * BQ * 128, &tq, q_full, nb * 64, q0, h, b);
      for (int i = 0; i < nt; ++i) {
        const int s = i % ST, k0 = (t_lo + i) * BK;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load(k_tile(s) + nb * BK * 128, &tk, k_full(s), nb * 64, k0, hk,
                   b);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load(k_tile(s) + L::KV_BYTES + nb * BK * 128, &tv, v_full(s),
                   nb * 64, k0, hk, b);
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
    const int r_lo = q0 + 64 * c;  // this warpgroup's first row
    const int row0 = r_lo + 16 * warp + g, row1 = row0 + 8;
    const float sl = p.scale * LOG2E;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % ST, k0 = (t_lo + i) * BK;
      const uint32_t ph = (i / ST) & 1;
      const uint32_t kt = k_tile(s), vt = kt + L::KV_BYTES;

      // S = Q Kᵀ: 64 rows x BK keys, DP / 16 steps of k16
      float sc[BK / 2];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = gmma_desc(
            sq + (kk / 4) * BQ * 128 + c * 64 * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            gmma_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss<BK>(sc, da, db, kk > 0);
      }
      wgmma_commit_wait();
      reg_fence(sc);

      // scale (log2 units) and mask; a tile inside every row's limits
      // skips the mask
      const bool inside = k0 + BK <= p.S &&
                          (!p.causal || k0 + BK - 1 <= r_lo) &&
                          (!p.has_window || k0 > r_lo + 63 - p.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl;
          if (!inside &&
              !visible(p, e < 2 ? row0 : row1, k0 + 8 * j + 2 * tig + (e & 1)))
            x = -INFINITY;
          sc[4 * j + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = m0 == NEG ? 0.0f : exp2f(m0 - mn0);
      const float a1 = m1 == NEG ? 0.0f : exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
      // P as bf16 A fragments: the accumulator's (row, 2 keys) pairs of
      // two neighbouring 8-key columns are one k16 fragment
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - m0), p1 = exp2f(sc[4 * j + 1] - m0);
        const float p2 = exp2f(sc[4 * j + 2] - m1),
                    p3 = exp2f(sc[4 * j + 3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P V: BK / 16 steps of k16, V MN-major
      mbar_wait(v_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<DP>(o, pa[kc], gmma_desc(vt + kc * 16 * 128, BK * 128, 1024));
      wgmma_commit_wait();
      reg_fence(o);
      if (tid == 0) mbar_arrive(empty(s));
    }

    const float i0 = 1.0f / fmaxf(quad_sum(l0), 1e-30f);
    const float i1 = 1.0f / fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        (long long)b * p.so[0] + (long long)h * p.so[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tig;
      if (d < p.D) {
        if (row0 < p.S)
          store_bf16x2(og + (long long)row0 * p.so[2] + d, o[4 * j] * i0,
                       o[4 * j + 1] * i0);
        if (row1 < p.S)
          store_bf16x2(og + (long long)row1 * p.so[2] + d, o[4 * j + 2] * i1,
                       o[4 * j + 3] * i1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K, typename... A>
int launch(K kernel, size_t bytes, dim3 grid, int threads, cudaStream_t st,
           A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library links only the runtime like every other kernel's
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (D, S, heads, B) bf16 map with (s, h, b) element strides st[2], st[1],
// st[0]; boxes of 64 columns x `rows` rows, 128-byte swizzled; past S and
// D the hardware fills zeros
int tensor_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
               int B, const long long* st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP>
int launch_wgmma(const Params& p, int B, int Hkv, dim3 grid, cudaStream_t st) {
  using L = WgLayout<DP>;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, p.q, p.D, p.S, p.H, B, p.sq, L::BQ);
  if (err == 0) err = tensor_map(&tk, p.k, p.D, p.S, Hkv, B, p.sk, L::BK);
  if (err == 0) err = tensor_map(&tv, p.v, p.D, p.S, Hkv, B, p.sv, L::BK);
  if (err != 0) return err;
  return launch(fa_wgmma_kernel<DP>, L::bytes(), grid, 128 * (L::NC + 1), st,
                tq, tk, tv, p);
}

template <int DP>
int launch_simt(const Params& p, dim3 grid, cudaStream_t st) {
  if constexpr (DP <= 128)
    return launch(fa_simt_kernel<DP, 64>, Simt<DP, 64>::bytes(), grid, NT, st,
                  p);
  else
    return launch(fa_simt_kernel<DP, 32>, Simt<DP, 32>::bytes(), grid, NT, st,
                  p);
}

bool aligned16(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D); element strides over (b, h, s),
// D contiguous.  variant: 0 = fa_simt_kernel (float32), 1 = fa_wgmma_kernel
// (bf16), 2 = fa_mma16_kernel (bf16, S <= 128), 3 / 4 = fa_wide_kernel
// (float32 / bf16, D > 256); tile_d the instantiation's
// head-dim tile; grid and threads as the wrapper planned them (checked
// here against the instantiation's tiles).  window is read when has_window
// is set.  Returns a cudaError_t: cudaErrorInvalidValue for a plan that
// does not fit the instantiation (tile, grid, D, strides or alignment) or a
// tensor map the driver refuses.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int variant,
    int tile_d, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, int causal, int has_window, int window, float scale,
    int grid_x, int grid_y, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 ||
      (D > tile_d && variant < 3) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.D = D;
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks,
                            svb, svh, svs, sob, soh, sos};
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = st[i];
    p.sk[i] = st[3 + i];
    p.sv[i] = st[6 + i];
    p.so[i] = st[9 + i];
  }
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  const long long BH = (long long)B * H;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = (cudaStream_t)stream;
  const int bad = (int)cudaErrorInvalidValue;

  if (variant == 3 || variant == 4) {  // fa_wide_kernel, float32 / bf16
    if (tile_d != WIDE_DO || D <= 256 ||
        (long long)grid_x != BH * ((D + WIDE_DO - 1) / WIDE_DO) ||
        grid_y != (S + WIDE_BQ - 1) / WIDE_BQ || threads != NT)
      return bad;
    if (variant == 3)
      return launch(fa_wide_kernel<float>, Wide::bytes(), grid, NT, s, p);
    return launch(fa_wide_kernel<__nv_bfloat16>, Wide::bytes(), grid, NT, s,
                  p);
  }
  if (variant == 0) {
    const int bq = tile_d <= 128 ? 64 : 32;
    if (tile_d % 32 != 0 || tile_d > 256 || D <= tile_d - 32 ||
        BH != grid_x || grid_y != (S + bq - 1) / bq || threads != NT)
      return bad;
    switch (tile_d) {
      case 32: return launch_simt<32>(p, grid, s);
      case 64: return launch_simt<64>(p, grid, s);
      case 96: return launch_simt<96>(p, grid, s);
      case 128: return launch_simt<128>(p, grid, s);
      case 160: return launch_simt<160>(p, grid, s);
      case 192: return launch_simt<192>(p, grid, s);
      case 224: return launch_simt<224>(p, grid, s);
      default: return launch_simt<256>(p, grid, s);
    }
  }
  // bf16: D a multiple of 16, 16-byte bases and strides
  if ((tile_d != 64 && tile_d != 128 && tile_d != 256) || D % 16 != 0 ||
      (tile_d > 64 && D <= tile_d / 2) || !aligned16(q, p.sq) ||
      !aligned16(k, p.sk) || !aligned16(v, p.sv) || !aligned16(o, p.so))
    return bad;
  if (variant == 1) {
    const int bq = tile_d == 256 ? 64 : 128;
    if (BH != grid_x || grid_y != (S + bq - 1) / bq ||
        threads != (tile_d == 256 ? 256 : 384))
      return bad;
    if (tile_d == 64) return launch_wgmma<64>(p, B, Hkv, grid, s);
    if (tile_d == 128) return launch_wgmma<128>(p, B, Hkv, grid, s);
    return launch_wgmma<256>(p, B, Hkv, grid, s);
  }
  if (variant == 2) {
    const int warps = threads / 32;
    if (S > SHORT_S || (long long)B * Hkv != grid_x || grid_y != 1 ||
        threads % 32 != 0 || warps < 1 || warps > 8)
      return bad;
    if (tile_d == 64)
      return launch(fa_mma16_kernel<64>, mma16_bytes<64>(S, warps), grid,
                    threads, s, p);
    if (tile_d == 128)
      return launch(fa_mma16_kernel<128>, mma16_bytes<128>(S, warps), grid,
                    threads, s, p);
    return launch(fa_mma16_kernel<256>, mma16_bytes<256>(S, warps), grid,
                  threads, s, p);
  }
  return bad;
}
