// WKV6: the chunked RWKV6 (Finch) time-mix scan.  Per (batch, head), with
// head dim D, from the state S_0 = s0:
//
//     y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
//     S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t,   w_t = exp(clamp(lw_t, -3.5, 0))
//
// Returns y (B, H, T, D) and the final state S (B, H, D, D), float32.
//
// Replaces the Pallas TPU kernel wkv6_pallas (src/repro/kernels/wkv6/
// wkv6.py, body _wkv6_kernel).  On the TPU the grid is (B, H, T/16) with
// the chunk axis sequential, the state carried in a VMEM scratch and the
// three chunk products on the MXU.  The chunk-16 factorization (cum = the
// in-chunk inclusive log-decay prefix, cum_prev = cum - lw):
//
//     r~ = r ⊙ exp(cum_prev),   k~ = k ⊙ exp(-cum)
//     y  = r~ S + tril_{-1}(r~ k~ᵀ) v + (Σ_i r_i u_i k_i) v
//     S <- exp(cum_last) ⊙ (S + k~ᵀ v)
//
// Chunk size is capped by float32 range: exp(-cum) reaches e^{16·3.5} =
// e^56 at chunk 16; at chunk 32 the exponent passes 88 and float32
// overflows.  The kernels keep chunk 16 and the clamp to [-3.5, 0], as the
// reference does (lw > 0 comes out as 0, lw < -3.5 as -3.5; NaN stays NaN).
//
// Bound on the H100: bytes -- r, k, v, lw read once, y written once (5 ·
// B·H·T·D floats), u, s0 and S (2 · B·H·D² floats) at 3.35 TB/s.  The
// chunk products (~2·B·H·T·D·(2D + 2·16) FLOP) sit just under it on the
// CUDA cores' 67 TFLOP/s, so they go to the tensor cores.  Two kernels for
// D <= 256, chosen by the wrapper (kernels/wkv6/ops.py, plan_wkv6):
//
// 1. wkv6_chunk_kernel -- T >= 16.  Column j of S, y and v forms a closed
//    recurrence, so the value columns are split: a warp owns 16 columns
//    and their slice of the state, a block four warps (D / 16 below
//    D = 64), and the grid is (B·H, D / 64) -- a block per (b, h) at
//    D = 64.  The warps of a block share the chunk's staging, r~, k~ and
//    the bonus; each computes A = tril_{-1}(r~ k~ᵀ) itself (cheap next to
//    the state products).  Blocks of 16 or 32 columns, each recomputing
//    r~, k~ and A, give the same warps with that work done four or two
//    times over, and measured slower (PERF.md, section 6).  Per chunk:
//      a. the chunk's rows of r, k, lw (all D channels) and v (the block's
//         columns) arrive by cp.async in a two-stage ring: chunk c + 1 is
//         in flight while chunk c computes; rows past T are zero-filled,
//         identity rows (r = k = v = 0, lw = 0) that touch neither y nor S;
//      b. a thread per channel (at D = 64 half the block's threads): the
//         prefix over the 16 rows, r~ and k~ written over r and k,
//         exp(cum_last), and the bonus sums (a butterfly over the warp's
//         lanes); spreading a channel over two lanes measured no faster;
//      c. each warp on the tensor cores (mma.sync.m16n8k8, TF32): y = r~ S
//         + (A + diag(bonus)) v and Sᵀ += vᵀ k~, then S scaled by
//         exp(cum_last).  Every product is 3xTF32: each float32 operand
//         split into a TF32 hi part and a TF32 lo part of the remainder,
//         and lo·hi + hi·lo + hi·hi summed in float32 -- ~2^-21 relative
//         where one TF32 product gives ~5e-4, outside the 1e-4 tolerance.
//    The warp's slice of the state, Sᵀ (16 columns x D channels), lives in
//    mma accumulator fragments, in registers, for the whole sequence.  The
//    same registers are the B operand of r~ S: the fragment's k index is
//    permuted (slot s of an 8-channel step <-> channel 2s or 2s + 1 - 8),
//    and r~ is loaded with the same permutation; A's accumulator likewise
//    is A's operand for A v.  Two barriers a chunk.
// 2. wkv6_step_kernel -- T < 16 (a decode step is T = 1): the recurrence
//    itself, one streaming pass over the state per step.  A grid of
//    (B·H, D / 32) blocks; a thread holds rows i = g, g + 32, ... of four
//    adjacent columns in registers (float4 loads and stores, coalesced on
//    j), forms its part of y_j = Σ_i r_i (S_ij + u_i k_i v_j), which is
//    reduced over the rows by shuffles and one shared-memory pass, and
//    updates S_ij = w_i S_ij + k_i v_j.  Bound: the state read and written
//    once.
//
// Layouts: r, k, v, lw and y are read and written through (b, h, t)
// element strides with D contiguous, so a model passes its (B, T, H, D)
// activations as transposed views without a copy.  The chunk kernel's
// cp.async needs 16-byte aligned bases and strides (the wrapper copies
// where they are not); u (H, D), s0 and S (B, H, D, D) are contiguous.
// Head dims 16, 32, 64, 128 and 256; the wrapper zero-pads any other D
// up to 256 (padded channels carry r = k = v = 0, lw = 0, which add
// nothing).  D above 256 runs a third kernel, wkv6_wide_kernel: the
// recurrence for any T, a block per (b, h) and 32 value columns, with
// the state in device memory (s_out), so no D is too wide.  It is off
// every model's path and right first: each step reads and writes the
// block's columns of the state through L2.  Exponentials are exp2f of log2(e)-scaled prefixes.  The
// build's -fmad=false forbids only contraction the compiler would choose;
// the kernels spell their multiply-adds with fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;
constexpr float LOG_W_MIN = -3.5f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;  // null: a zero state
  float* y;
  float* s_out;
  long long sr[3], sk[3], sv[3], sl[3], sy[3];  // (b, h, t) element strides
  int H, T;
};

__device__ __forceinline__ float clamp_lw(float x) {
  // jnp.clip order: max with the floor, then min with 0 (NaN propagates)
  x = x < LOG_W_MIN ? LOG_W_MIN : x;
  return x > 0.0f ? 0.0f : x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo + O(2^-21 |x|): hi is x rounded to TF32 by integer ops (add
// half a TF32 ulp, clear the 13 low bits: full-rate ALU work, where the
// cvt instruction would not be), lo the exact remainder, which the tensor
// core reads as TF32 by dropping its 13 low bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));  // exact
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0..a3) and a B fragment (b0, b1), split into hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ FragB(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32: the two cross terms first, then the large product
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// one butterfly step: lanes with bit 2W set keep rows W .. 2W - 1 of the
// pair's sum, the others rows 0 .. W - 1, now at v[0 .. W - 1]
template <int W>
__device__ __forceinline__ void fold_rows(float (&v)[CHUNK], int lane) {
  const bool up = lane & (2 * W);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float keep = up ? v[j + W] : v[j];
    const float send = up ? v[j] : v[j + W];
    v[j] = keep + __shfl_xor_sync(FULL, send, 2 * W);
  }
}

// v[t] per lane -> the sum over the warp's 32 lanes of v[(lane >> 1) & 15]
// (8 + 4 + 2 + 1 + 1 shuffles)
__device__ __forceinline__ float warp_sum16(float (&v)[CHUNK], int lane) {
  fold_rows<8>(v, lane);
  fold_rows<4>(v, lane);
  fold_rows<2>(v, lane);
  fold_rows<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// ---------------------------------------------------------------------------
// 1. T >= 16: chunks of 16 rows, value columns split across warps and blocks
// ---------------------------------------------------------------------------

// warps of a block, one per 16 value columns (fewer where D has fewer
// columns)
constexpr int CHUNK_WARPS = 4;

template <int D, int NW>
struct ChunkLayout {
  static constexpr int NB = 16 * NW;  // value columns of a block
  static constexpr int NT = 32 * NW;
  // row strides of D + 8 and NB + 8 floats (8 or 24 mod 32 banks): the
  // float2 fragment loads of a half-warp and the scalar ones of a warp
  // are conflict-free
  static constexpr int LD = D + 8;
  static constexpr int LV = NB + 8;
  static constexpr int STAGE = 3 * CHUNK * LD + CHUNK * LV;  // floats
  // two stages, then exp(cum_last) [D], u [D], bonus sums [NW][16]
  static constexpr size_t bytes() {
    return sizeof(float) * (2 * STAGE + 2 * D + NW * CHUNK);
  }
};

// chunk c's rows of r, k, lw (all D channels) and v (the block's NB
// columns) into ring stage c & 1 by cp.async; rows past T are zeros
template <int D, int NW>
__device__ __forceinline__ void stage_chunk(float* sm, const float* rg,
                                            const float* kg, const float* vg,
                                            const float* lg, const Args& a,
                                            int c) {
  using L = ChunkLayout<D, NW>;
  constexpr int LD = L::LD, LV = L::LV, NT = L::NT;
  constexpr int PR = D / 4, PV = L::NB / 4;  // 16-byte pieces of a row
  float* rs = sm + (c & 1) * L::STAGE;
  float* ks = rs + CHUNK * LD;
  float* ls = ks + CHUNK * LD;
  float* vs = ls + CHUNK * LD;
  const int t0 = c * CHUNK;
#pragma unroll 4
  for (int e = threadIdx.x; e < CHUNK * PR; e += NT) {
    const int t = e / PR, p = 4 * (e % PR);
    const bool ok = t0 + t < a.T;
    const long long row = ok ? t0 + t : 0;
    cp_async16(rs + t * LD + p, rg + row * a.sr[2] + p, ok);
    cp_async16(ks + t * LD + p, kg + row * a.sk[2] + p, ok);
    cp_async16(ls + t * LD + p, lg + row * a.sl[2] + p, ok);
  }
  for (int e = threadIdx.x; e < CHUNK * PV; e += NT) {
    const int t = e / PV, p = 4 * (e % PV);
    const bool ok = t0 + t < a.T;
    const long long row = ok ? t0 + t : 0;
    cp_async16(vs + t * LV + p, vg + row * a.sv[2] + p, ok);
  }
  cp_async_commit();
}

template <int D, int NW>
__global__ void __launch_bounds__(32 * NW) wkv6_chunk_kernel(Args a) {
  using L = ChunkLayout<D, NW>;
  constexpr int NB = L::NB, NT = L::NT, LD = L::LD, LV = L::LV;
  constexpr int NK = D / 8;  // 8-channel steps
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* decay = sm + 2 * L::STAGE;
  float* us = decay + D;
  float* bsum = us + D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const int h = bh % a.H;
  const int jb = blockIdx.y * NB;  // the block's first value column
  const int jw = 16 * warp;        // the warp's first column in the block
  const int T = a.T;
  const float* rg = a.r + b * a.sr[0] + h * a.sr[1];
  const float* kg = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vg = a.v + b * a.sv[0] + h * a.sv[1] + jb;
  const float* lg = a.lw + b * a.sl[0] + h * a.sl[1];
  float* yg = a.y + b * a.sy[0] + h * a.sy[1] + jb + jw;
  for (int i = tid; i < D; i += NT) us[i] = a.u[(long long)h * D + i];

  // the warp's slice of the state as Sᵀ accumulator fragments:
  // st[n][e] = S[8n + 2 tig + (e & 1)][jb + jw + gid + 8 (e >> 1)]
  float st[NK][4];
  {
    const long long o = (long long)bh * D * D + jb + jw + gid;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[n][e] = a.s0 == nullptr
                       ? 0.0f
                       : a.s0[o + (long long)(8 * n + 2 * tig + (e & 1)) * D +
                              8 * (e >> 1)];
  }

  const int nc = (T + CHUNK - 1) / CHUNK;
  if (nc > 0) stage_chunk<D, NW>(sm, rg, kg, vg, lg, a, 0);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; chunk c - 1 is done with
    if (c + 1 < nc) stage_chunk<D, NW>(sm, rg, kg, vg, lg, a, c + 1);
    float* rs = sm + (c & 1) * L::STAGE;
    float* ks = rs + CHUNK * LD;
    float* ls = ks + CHUNK * LD;
    float* vs = ls + CHUNK * LD;

    // b. per channel: prefixes, r~ and k~ in place, exp(cum_last); the
    //    bonus Σ_i r_i u_i k_i of each row
    float bp[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) bp[t] = 0.0f;
    for (int ch = tid; ch < D; ch += NT) {
      const float uu = us[ch];
      float cum = 0.0f;  // in log2 units
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const float l = clamp_lw(ls[t * LD + ch]) * LOG2E;
        cum = cum + l;              // inclusive prefix
        const float prev = cum - l;  // exclusive, as the reference forms it
        const float rv = rs[t * LD + ch], kv = ks[t * LD + ch];
        bp[t] = fmaf(rv * uu, kv, bp[t]);
        rs[t * LD + ch] = rv * exp2f(prev);
        ks[t * LD + ch] = kv * exp2f(-cum);
      }
      decay[ch] = exp2f(cum);
    }
    {
      const float s = warp_sum16(bp, lane);
      if ((lane & 1) == 0) bsum[warp * CHUNK + ((lane >> 1) & 15)] = s;
    }
    __syncthreads();

    // c. y = r~ S + A' v with A' = tril_{-1}(r~ k~ᵀ) + diag(bonus), on this
    //    warp's 16 columns (two 8-column tiles)
    // two accumulators per tile (even and odd channel steps) halve the
    // chains of dependent mma
    float yc[2][4], ac[2][4], yo[2][4], ao[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yc[x][e] = ac[x][e] = yo[x][e] = ao[x][e] = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float(&ys)[2][4] = n & 1 ? yo : yc;
      float(&as)[2][4] = n & 1 ? ao : ac;
      // r~ rows gid, gid + 8 at channels 8n + 2 tig, + 1 (the permuted k)
      const float2 r0 =
          *reinterpret_cast<const float2*>(rs + gid * LD + 8 * n + 2 * tig);
      const float2 r1 = *reinterpret_cast<const float2*>(
          rs + (gid + 8) * LD + 8 * n + 2 * tig);
      const FragA fa(r0.x, r1.x, r0.y, r1.y);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        // r~ S: S's rows 8n + 2 tig, + 1 of columns gid + 8x -- st[n]
        mma3(ys[x], fa, FragB(st[n][2 * x], st[n][2 * x + 1]));
        // r~ k~ᵀ: k~ row 8x + gid at the same channels
        const float2 kb = *reinterpret_cast<const float2*>(
            ks + (8 * x + gid) * LD + 8 * n + 2 * tig);
        mma3(as[x], fa, FragB(kb.x, kb.y));
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yc[x][e] += yo[x][e];
        ac[x][e] += ao[x][e];
      }

    float bonus[2] = {0.0f, 0.0f};  // rows gid, gid + 8
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      bonus[0] += bsum[w * CHUNK + gid];
      bonus[1] += bsum[w * CHUNK + gid + 8];
    }
    // ac[x][e] = A[gid + 8 (e >> 1)][8x + 2 tig + (e & 1)]
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = gid + 8 * (e >> 1), col = 8 * x + 2 * tig + (e & 1);
        ac[x][e] = col < t ? ac[x][e] : col == t ? bonus[e >> 1] : 0.0f;
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      // A' as the A operand, k permuted as its accumulator lies
      const FragA fa(ac[x][0], ac[x][2], ac[x][1], ac[x][3]);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int col = jw + 8 * jn + gid;
        mma3(yc[jn], fa,
             FragB(vs[(8 * x + 2 * tig) * LV + col],
                   vs[(8 * x + 2 * tig + 1) * LV + col]));
      }
    }
    const int t0 = c * CHUNK;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + gid + 8 * hf;
        if (t < T)
          *reinterpret_cast<float2*>(yg + (long long)t * a.sy[2] + 8 * jn +
                                     2 * tig) =
              make_float2(yc[jn][2 * hf], yc[jn][2 * hf + 1]);
      }

    // Sᵀ += vᵀ k~ (rows of v and k~ are the k index), then exp(cum_last)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int t = 8 * kk + tig;
      const FragA fv(vs[t * LV + jw + gid], vs[t * LV + jw + gid + 8],
                     vs[(t + 4) * LV + jw + gid],
                     vs[(t + 4) * LV + jw + gid + 8]);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3(st[n], fv,
             FragB(ks[t * LD + 8 * n + gid], ks[(t + 4) * LD + 8 * n + gid]));
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float2 dc =
          *reinterpret_cast<const float2*>(decay + 8 * n + 2 * tig);
      st[n][0] *= dc.x;
      st[n][1] *= dc.y;
      st[n][2] *= dc.x;
      st[n][3] *= dc.y;
    }
  }

  {
    const long long o = (long long)bh * D * D + jb + jw + gid;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a.s_out[o + (long long)(8 * n + 2 * tig + (e & 1)) * D +
                8 * (e >> 1)] = st[n][e];
  }
}

// ---------------------------------------------------------------------------
// 2. T < 16: the recurrence, one pass over the state per step
// ---------------------------------------------------------------------------

template <int D>
struct StepLayout {
  static constexpr int NC = D < 32 ? D : 32;  // value columns of a block
  static constexpr int CT = NC / 4;           // threads along them (float4)
  static constexpr int RG = D < 32 ? D : 32;  // row groups
  static constexpr int NT = CT * RG;
  static constexpr int RPT = D / RG;  // state rows a thread holds
  static constexpr int NWARP = NT / 32;
};

__device__ __forceinline__ void fma4(float4& acc, float r, float uk,
                                     const float4& v, const float4& s) {
  acc.x = fmaf(r, fmaf(uk, v.x, s.x), acc.x);
  acc.y = fmaf(r, fmaf(uk, v.y, s.y), acc.y);
  acc.z = fmaf(r, fmaf(uk, v.z, s.z), acc.z);
  acc.w = fmaf(r, fmaf(uk, v.w, s.w), acc.w);
}

template <int D>
__global__ void __launch_bounds__(StepLayout<D>::NT) wkv6_step_kernel(Args a) {
  using L = StepLayout<D>;
  constexpr int NC = L::NC, CT = L::CT, RG = L::RG, RPT = L::RPT;
  constexpr int NWARP = L::NWARP;
  __shared__ float4 red[2][NWARP][CT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % CT, g = tid / CT;
  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const int h = bh % a.H;
  const int j = blockIdx.y * NC + 4 * ct;  // this thread's four columns
  const float* rg = a.r + b * a.sr[0] + h * a.sr[1];
  const float* kg = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vg = a.v + b * a.sv[0] + h * a.sv[1] + j;
  const float* lg = a.lw + b * a.sl[0] + h * a.sl[1];
  float* yg = a.y + b * a.sy[0] + h * a.sy[1] + blockIdx.y * NC;
  const long long so = (long long)bh * D * D + j;

  float4 s[RPT];
  float uu[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = g + RG * q;
    s[q] = a.s0 == nullptr
               ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
               : *reinterpret_cast<const float4*>(a.s0 + so + (long long)i * D);
    uu[q] = a.u[(long long)h * D + i];
  }

  for (int t = 0; t < a.T; ++t) {
    const float* vt = vg + t * a.sv[2];
    const float4 vv = make_float4(vt[0], vt[1], vt[2], vt[3]);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float w[RPT], kq[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = g + RG * q;
      const float l = clamp_lw(lg[t * a.sl[2] + i]);
      // l - l is 0, or NaN where lw is: the chunked form's r~ carries
      // lw's NaN into the row's y, and so does this
      const float rr = rg[t * a.sr[2] + i] + (l - l);
      kq[q] = kg[t * a.sk[2] + i];
      w[q] = exp2f(l * LOG2E);
      fma4(acc, rr, uu[q] * kq[q], vv, s[q]);
    }
    // y_j: the sum over the row groups -- the lanes of equal ct, then the
    // warps
#pragma unroll
    for (int off = CT; off < 32; off <<= 1) {
      acc.x += __shfl_xor_sync(FULL, acc.x, off);
      acc.y += __shfl_xor_sync(FULL, acc.y, off);
      acc.z += __shfl_xor_sync(FULL, acc.z, off);
      acc.w += __shfl_xor_sync(FULL, acc.w, off);
    }
    if (lane < CT) red[t & 1][warp][lane] = acc;
    __syncthreads();
    if (tid < CT) {
      float4 y = red[t & 1][0][tid];
#pragma unroll
      for (int x = 1; x < NWARP; ++x) {
        const float4 p = red[t & 1][x][tid];
        y.x += p.x;
        y.y += p.y;
        y.z += p.z;
        y.w += p.w;
      }
      float* yt = yg + t * a.sy[2] + 4 * tid;
      yt[0] = y.x;
      yt[1] = y.y;
      yt[2] = y.z;
      yt[3] = y.w;
    }
    // S_ij <- w_i S_ij + k_i v_j
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      s[q].x = fmaf(w[q], s[q].x, kq[q] * vv.x);
      s[q].y = fmaf(w[q], s[q].y, kq[q] * vv.y);
      s[q].z = fmaf(w[q], s[q].z, kq[q] * vv.z);
      s[q].w = fmaf(w[q], s[q].w, kq[q] * vv.w);
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    *reinterpret_cast<float4*>(a.s_out + so + (long long)(g + RG * q) * D) =
        s[q];
}

// ---------------------------------------------------------------------------
// 3. D > 256: the recurrence with the state in device memory
// ---------------------------------------------------------------------------

constexpr int WIDE_GROUPS = 8;  // warps of a block: row groups
constexpr int WIDE_THREADS = 32 * WIDE_GROUPS;

// A block per (b, h) and 32 value columns, a lane per column, a warp per
// row group (rows g, g + 8, ...).  The block's columns of the state stay
// in s_out, which each thread reads and writes at its own (row, column)
// elements only, so no D is too wide; y_j is the row groups' sums added
// through shared memory.  Any T, D not padded (columns past D idle).
__global__ void __launch_bounds__(WIDE_THREADS)
    wkv6_wide_kernel(Args a, int D) {
  __shared__ float red[WIDE_GROUPS][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const int h = bh % a.H;
  const int j = blockIdx.y * 32 + lane;
  const bool col = j < D;
  const float* rg = a.r + b * a.sr[0] + h * a.sr[1];
  const float* kg = a.k + b * a.sk[0] + h * a.sk[1];
  const float* vg = a.v + b * a.sv[0] + h * a.sv[1];
  const float* lg = a.lw + b * a.sl[0] + h * a.sl[1];
  float* yg = a.y + b * a.sy[0] + h * a.sy[1];
  const float* uh = a.u + (long long)h * D;
  float* S = a.s_out + (long long)bh * D * D;
  if (col) {
    const float* S0 = a.s0 == nullptr ? nullptr : a.s0 + (long long)bh * D * D;
    for (int i = g; i < D; i += WIDE_GROUPS)
      S[(long long)i * D + j] = S0 == nullptr ? 0.0f : S0[(long long)i * D + j];
  }
  for (int t = 0; t < a.T; ++t) {
    const float vj = col ? vg[t * a.sv[2] + j] : 0.0f;
    float acc = 0.0f;
    for (int i = g; i < D; i += WIDE_GROUPS) {
      const float l = clamp_lw(lg[t * a.sl[2] + i]);
      // l - l: lw's NaN reaches y, as in the other kernels
      const float rr = rg[t * a.sr[2] + i] + (l - l);
      const float kk = kg[t * a.sk[2] + i];
      if (col) {
        float* sp = S + (long long)i * D + j;
        const float s = *sp;
        acc = fmaf(rr, fmaf(uh[i] * kk, vj, s), acc);
        *sp = fmaf(exp2f(l * LOG2E), s, kk * vj);
      }
    }
    red[g][lane] = acc;
    __syncthreads();
    if (g == 0 && col) {
      float y = red[0][lane];
#pragma unroll
      for (int x = 1; x < WIDE_GROUPS; ++x) y += red[x][lane];
      yg[t * a.sy[2] + j] = y;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D>
int launch_chunk(const Args& a, int BH, cudaStream_t st) {
  constexpr int NW = D / 16 < CHUNK_WARPS ? D / 16 : CHUNK_WARPS;
  using L = ChunkLayout<D, NW>;
  auto kernel = wkv6_chunk_kernel<D, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes());
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(BH, D / L::NB), L::NT, L::bytes(), st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_step(const Args& a, int BH, cudaStream_t st) {
  using L = StepLayout<D>;
  wkv6_step_kernel<D><<<dim3(BH, D / L::NC), L::NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(const float* p, const long long* st, int floats) {
  return reinterpret_cast<uintptr_t>(p) % (4 * floats) == 0 &&
         st[0] % floats == 0 && st[1] % floats == 0 && st[2] % floats == 0;
}

}  // namespace

// r, k, v, lw, y: (B, H, T, D) float32 with D contiguous; st holds their
// (b, h, t, d) element strides, 4 per tensor in that order (the stride of
// a dimension of size 1 is ignored).  u: (H, D); s0 (null for a zero
// state) and s_out: (B, H, D, D), contiguous.  variant 0 =
// wkv6_chunk_kernel (16-byte aligned bases and strides of r, k, v, lw;
// 8-byte ones of y), 1 = wkv6_step_kernel (T < 16; 16-byte aligned s0 and
// s_out), 2 = wkv6_wide_kernel (any D and T).  Returns a cudaError_t:
// cudaErrorInvalidValue for a D outside {16, 32, 64, 128, 256} (variants 0
// and 1), a negative size, D not contiguous, a variant that does not take
// T, or strides the variant cannot take.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* lw, const float* u, const float* s0,
                           float* y, float* s_out, int B, int H, int T, int D,
                           int variant, const long long* st, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || H < 0 || T < 0) return bad;
  const int BH = B * H;
  if (BH == 0) return 0;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = lw;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_out = s_out;
  long long* const to[5] = {a.sr, a.sk, a.sv, a.sl, a.sy};
  const int size[3] = {B, H, T};
  for (int x = 0; x < 5; ++x) {
    if (st[4 * x + 3] != 1) return bad;
    for (int i = 0; i < 3; ++i) to[x][i] = size[i] > 1 ? st[4 * x + i] : 0;
  }
  a.H = H;
  a.T = T;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 2) {  // any D, any T
    if (D < 1) return bad;
    wkv6_wide_kernel<<<dim3(BH, (D + 31) / 32), WIDE_THREADS, 0, s>>>(a, D);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {  // the state moves as float4
    if (T >= CHUNK || reinterpret_cast<uintptr_t>(s0) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(s_out) % 16 != 0)
      return bad;
    switch (D) {
      case 16: return launch_step<16>(a, BH, s);
      case 32: return launch_step<32>(a, BH, s);
      case 64: return launch_step<64>(a, BH, s);
      case 128: return launch_step<128>(a, BH, s);
      case 256: return launch_step<256>(a, BH, s);
      default: return bad;
    }
  }
  if (variant != 0 || !aligned(r, a.sr, 4) || !aligned(k, a.sk, 4) ||
      !aligned(v, a.sv, 4) || !aligned(lw, a.sl, 4) || !aligned(y, a.sy, 2))
    return bad;
  switch (D) {
    case 16: return launch_chunk<16>(a, BH, s);
    case 32: return launch_chunk<32>(a, BH, s);
    case 64: return launch_chunk<64>(a, BH, s);
    case 128: return launch_chunk<128>(a, BH, s);
    case 256: return launch_chunk<256>(a, BH, s);
    default: return bad;
  }
}
