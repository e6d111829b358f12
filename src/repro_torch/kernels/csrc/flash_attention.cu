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
// head at 989 TFLOP/s of bf16 tensor-core peak (float32: as three TF32
// products at 495 TFLOP/s) -- for long sequences; bytes (q, k, v read
// once, o written once at 3.35 TB/s) for short ones and for small D.  Four instantiations (five kernels), chosen by the
// wrapper (kernels/flash_attention/ops.py, plan_attention):
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
// 3. fa_f32_kernel -- float32, D <= 256, on the tensor cores: every
//    product a 3xTF32 mma.sync.m16n8k8 (tf32.cuh: each operand split
//    into a TF32 hi part and the remainder, lo·hi + hi·lo + hi·hi summed
//    in float32, ~2^-20 relative a product, which holds the reference's
//    2e-5 where one TF32 product would not; hi truncated, as the float32
//    backward splits); Q split into hi and lo planes once a block, K, V
//    and P as each warp reads them; K and V tiles through a two-stage
//    cp.async ring, P kept in registers (the S accumulator is P's A
//    fragment), the softmax in float32 with expf and the IEEE divide.  A
//    warp per 16 query rows: 128 rows a block up to D = 128, 64 above,
//    where two warps split D's columns (S's partials added through shared
//    memory); 32-row tiles for sequences of up to 96 at D <= 64.
// 4. "wide", D > 256, where a 64-row x D float32 accumulator no longer
//    fits one warpgroup's registers:
//    a. fa_wide_simt_kernel -- float32 on the CUDA cores (explicit fmaf,
//       for the 2e-5): a 32-row query tile and all output columns up to 1,024 in
//       one block, so each score is formed once;
//    b. fa_wide_wgmma_kernel -- bf16 on the tensor cores: a 64-row query
//       tile, two consumer warpgroups that split D for the scores (their
//       partial sums added through shared memory) and 512 output columns
//       between them for P V; Q, K and V move as 64 x 64 TMA boxes
//       through one ring.  Bound by operations at long sequences; the
//       K / V re-reads of each 64-row tile come from L2.
//
// In 1, 2 and 4b the weights P are rounded to bf16 for the PV product (the
// reference model's gqa_attention rounds them the same way); the
// denominator l sums the float32 P.
// Under autograd every instantiation also writes each row's log-sum-exp
// (+inf for a row that sees no key) for the backward
// (flash_attention_bwd.cu): lse = (m + log2 l) ln 2 in 1, 2 and 4b, whose
// running max is in log2 units; m + ln l in 3 and 4a, from their own m and
// l with logf as they use expf.  With a null pointer they write nothing and
// the output's bits are the same either way.
//
// The TMA, mbarrier and wgmma helpers live in hopper.cuh, shared with the
// backward; the 3xTF32 ones in tf32.cuh, shared with B7.
//
// Layouts: per-(b, h, s) element strides with D contiguous, so the model
// passes its (B, S, H, hd) activations as transposed views without a
// copy.  The bf16 instantiations need D a multiple of 16 and 16-byte
// aligned bases and strides (TMA, cp.async), fa_f32_kernel D a multiple
// of 4 and 16-byte aligned bases and strides (cp.async); the wrapper pads
// or copies where they are not.  D up to 256 on the tiled instantiations; any D
// above on the wide ones (bf16: a multiple of 8, the wrapper pads).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // (B, H, S) float32, each row's log-sum-exp of its scaled scores, +inf
  // for a row that sees no key; written by every instantiation when not
  // null (the backward's P = exp(scale * s - lse)), else nothing
  float* lse;
  int H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3];  // (b, h, s) element strides
  int causal, has_window, window;
  float scale;
};

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

// a row's log-sum-exp in natural units from its running max m (log2
// units, scale folded in) and denominator l; +inf where no key was seen,
// so that exp(scale * s - lse) is 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * LN2 : INFINITY;
}

// the same from the float32 kernels' m (natural units, scale folded in)
// and l, with expf / logf as they use them; m is -1e30 where l = 0
__device__ __forceinline__ float row_lse_f32(float m, float l) {
  return l > 0.0f ? m + logf(l) : INFINITY;
}

// the rows' lse, from the lane that holds column 0 of the quad
__device__ __forceinline__ void store_lse(const Params& p, long long b, int h,
                                          int row0, int row1, float m0,
                                          float s0, float m1, float s1) {
  float* lg = p.lse + (b * p.H + h) * (long long)p.S;
  if (row0 < p.S) lg[row0] = row_lse(m0, s0);
  if (row1 < p.S) lg[row1] = row_lse(m1, s1);
}

// ---------------------------------------------------------------------------
// cp.async, shared by 2 and 3
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// commits the thread's outstanding copies and waits for all of them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// ---------------------------------------------------------------------------
// 3. float32 on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

// fa_f32_kernel's tiles.  A block owns R row groups of 16 query rows (BM =
// 16 R) and streams BN-key tiles of K and V through a two-stage cp.async
// ring; MINB blocks share an SM (registers a thread: 65,536 / (MINB NT)).
// Each row group has W warps: warp j contracts the scores over columns
// [j KW, (j + 1) KW) of the DT-column head-dim tile and owns those output
// columns; with W = 2 (DT > 128, where a 16 x DT float32 accumulator would
// need DT / 2 registers a thread) the two warps' partial scores meet in
// shared memory and each adds them in warp order, so both hold the same
// bits.  Rows of DT + 4 floats: a pitch of 4 modulo 32 banks, so the
// fragment reads of Q (rows gid, columns tig), K (the same) and V (rows
// 2 tig, columns gid) are conflict-free.  Every operand is split as the
// float32 backward splits it (tf32.cuh's split_trunc, hi truncated: one
// ALU op a value fewer than split_tf32's rounding, ~2^-20 relative a
// product against ~2^-21, still far inside the 2e-5): Q into its hi and
// lo planes once a block, K, V and P as each warp reads them.  A
// block-wide split of K and V into planes ran no faster on the card:
// twice the shared-memory traffic for the same fragments.
template <int DT_, int W_, int R_, int BN_, int MINB_ = 1>
struct F32Fwd {
  static constexpr int DT = DT_, W = W_, R = R_, BN = BN_, MINB = MINB_;
  static constexpr int BM = 16 * R, NT = 32 * W * R, LD = DT + 4;
  static constexpr int NB = BN / 8;      // the scores' n-tiles
  static constexpr int KW = DT / W;      // a warp's columns
  static constexpr int NC = KW / 8;      // a warp's output n-tiles
  static constexpr int XF = W > 1 ? NB * 4 * 32 : 0;  // a warp's partials
  // Q's hi and lo planes, the ring's two stages of K and V, the partials
  static constexpr size_t bytes() {
    return sizeof(float) *
           (2 * BM * LD + 2 * 2 * BN * LD + (size_t)W * R * XF);
  }
};

// the instantiations by head-dim tile: 128 query rows over 8 warps up to
// DT = 128 (32-key tiles at 128, so the block fits 227 KB; at DT <= 64 two
// blocks an SM), 64 rows over 4 pairs of warps above (16-key tiles from
// DT = 224); sequences of up to F32_SHORT_S rows at DT <= 64 take 32-row
// tiles over 16-key ones, four blocks an SM (the fraud scorer's 65 rows:
// 3 tiles, not 2 of 64 whose second holds one row)
constexpr int F32_SHORT_S = 96;
constexpr int f32_keys(int dt) {
  return dt == 96 ? 64 : dt <= 192 ? 32 : 16;
}
template <int DT, bool SHORT = false>
struct F32FwdCfg {
  using C = F32Fwd<DT, (DT <= 128 ? 1 : 2), (DT <= 128 ? 8 : 4), f32_keys(DT),
                   (DT <= 64 ? 2 : 1)>;
};
template <int DT>
struct F32FwdCfg<DT, true> {
  using C = F32Fwd<DT, 1, 2, 16, 4>;
};

// rows r0 .. r0 + ROWS - 1 of one head, DT columns, into rows of DT + 4
// floats by cp.async; zeros past S and D (D a multiple of 4)
template <int ROWS, int DT, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long rs, int r0, int S,
                                           int D) {
  constexpr int CH = DT / 4, LD = DT + 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = 4 * (i % CH);
    const bool ok = r0 + r < S && c < D;
    cp_async16(smem_u32(dst + r * LD + c),
               ok ? src + (long long)(r0 + r) * rs + c : src, ok);
  }
}

// A block per (b, h, BM-row query tile), the longest tiles first; a warp
// per 16 rows (and share of D's columns) over the key tiles its rows can
// see.  Per tile: S = Q Kᵀ in 3xTF32 from Q's planes and K split as it is
// read; the online softmax on the accumulators (a row's max and sum
// over the 4 lanes of a quad, masked scores -1e30 and weights 0, alpha =
// 0 while the max is still -1e30, expf); O += P V in 3xTF32 with the S
// accumulator as P's A fragment (its k slots permuted: key 2 tig in slot
// tig, 2 tig + 1 in tig + 4) and V read as B in the same key order, so P
// never leaves registers.  A tile every row of the warp sees whole skips
// the mask.  Each thread sums its own columns of l, the quad adds them at
// the end; o = acc / max(l, 1e-30), lse = m + ln l.  No atomics: the
// same bits every run, with or without the lse.
template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB) fa_f32_kernel(Params p) {
  constexpr int DT = C::DT, W = C::W, BN = C::BN, BM = C::BM, LD = C::LD,
                NB = C::NB, KW = C::KW, NC = C::NC, NT = C::NT;
  constexpr int G = NC % 4 == 0 ? 4 : 2;  // output n-tiles issued together
  extern __shared__ float4 smem4[];
  float* const sQh = reinterpret_cast<float*>(smem4);
  float* const sQl = sQh + BM * LD;
  float* const sKV = sQl + BM * LD;  // [stage][K, V][BN][LD]
  float* const sX = sKV + 2 * 2 * BN * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / W, wj = warp % W;
  const long long b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  int k_lo, k_hi;
  key_range(p, q0, BM, k_lo, k_hi);
  const int t_lo = k_lo / BN;
  const int t_hi = k_hi > k_lo ? (k_hi + BN - 1) / BN : t_lo;
  auto stage_kv = [&](int t) {
    float* dst = sKV + ((t - t_lo) & 1) * 2 * BN * LD;
    stage_tile<BN, DT, NT>(dst, kg, p.sk[2], t * BN, p.S, p.D);
    stage_tile<BN, DT, NT>(dst + BN * LD, vg, p.sv[2], t * BN, p.S, p.D);
  };

  stage_tile<BM, DT, NT>(sQh, qg, p.sq[2], q0, p.S, p.D);
  if (t_lo < t_hi) stage_kv(t_lo);
  cp_async_wait_all();
  __syncthreads();
  // Q's hi and lo planes, in place of the staged values
  for (int i = threadIdx.x; i < BM * DT; i += NT) {
    const int at = i / DT * LD + i % DT;
    uint32_t hi, lo;
    split_trunc(sQh[at], hi, lo);
    sQh[at] = __uint_as_float(hi);
    sQl[at] = __uint_as_float(lo);
  }

  // the warp's rows, the keys they can see, its columns
  const int r0 = q0 + 16 * rg, ra = r0 + gid, rb = ra + 8;
  int w_lo, w_hi;
  key_range(p, r0, 16, w_lo, w_hi);
  const bool idle = r0 >= p.S;  // no real row: nothing to compute
  const int kb = wj * KW;  // past D the staged columns are zeros
  const float* qh = sQh + 16 * rg * LD + gid * LD + tig;
  const float* ql = sQl + 16 * rg * LD + gid * LD + tig;

  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    const float* tk = sKV + ((t - t_lo) & 1) * 2 * BN * LD;
    const float* tv = tk + BN * LD;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1 read by every warp
    if (t + 1 < t_hi) stage_kv(t + 1);
    if (idle || k0 >= w_hi || k0 + BN <= w_lo) continue;  // pairs alike

    // S = Q Kᵀ over the warp's columns, 8 at a step in ascending order:
    // with W = 1 the chain of the backward's dQ kernel, so the bits of S
    // it forms again are these (zero columns past D add +0)
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KW; kk += 8) {
      const int k = kb + kk;
      TfA fa;  // from Q's planes
      fa.hi[0] = __float_as_uint(qh[k]);
      fa.hi[1] = __float_as_uint(qh[k + 8 * LD]);
      fa.hi[2] = __float_as_uint(qh[k + 4]);
      fa.hi[3] = __float_as_uint(qh[k + 8 * LD + 4]);
      fa.lo[0] = __float_as_uint(ql[k]);
      fa.lo[1] = __float_as_uint(ql[k + 8 * LD]);
      fa.lo[2] = __float_as_uint(ql[k + 4]);
      fa.lo[3] = __float_as_uint(ql[k + 8 * LD + 4]);
      TfB fb[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float* br = tk + (8 * n + gid) * LD + k + tig;
        fb[n] = TfB(br[0], br[4]);
      }
      mma3_rows<NB>(s, fa, fb);
    }
    if constexpr (W > 1) {
      // the row group's partial scores, summed in warp order
      float* mine = sX + warp * C::XF + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = s[n][e];
      named_bar_sync(1 + rg, 32 * W);
      const float* grp = sX + rg * W * C::XF + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = grp[(n * 4 + e) * 32];
#pragma unroll
          for (int j = 1; j < W; ++j) a += grp[j * C::XF + (n * 4 + e) * 32];
          s[n][e] = a;
        }
    }

    // the online softmax: bit 4 n + e of vis says whether accumulator
    // element (n, e) -- row ra (e < 2) or rb, key k0 + 8 n + 2 tig + e % 2
    // -- is visible
    uint32_t vis = 0xffffffffu;
    const bool inside = k0 + BN <= p.S &&
                        (!p.causal || k0 + BN - 1 <= r0) &&
                        (!p.has_window || k0 > r0 + 15 - p.window);
    if (!inside) {
      vis = 0u;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible(p, e < 2 ? ra : rb, k0 + 8 * n + 2 * tig + (e & 1)))
            vis |= 1u << (4 * n + e);
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (vis >> (4 * n + e)) & 1u ? s[n][e] * p.scale : NEG;
        s[n][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = m0 == NEG ? 0.0f : expf(m0 - mn0);
    const float al1 = m1 == NEG ? 0.0f : expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = (vis >> (4 * n + e)) & 1u
                             ? expf(s[n][e] - (e < 2 ? mn0 : mn1))
                             : 0.0f;
        s[n][e] = pr;
        if (e < 2)
          ps0 += pr;
        else
          ps1 += pr;
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      o[c][0] *= al0;
      o[c][1] *= al0;
      o[c][2] *= al1;
      o[c][3] *= al1;
    }

    // O += P V: P's A fragment from the accumulator, V's rows 2 tig and
    // 2 tig + 1 of each 8-key step, columns gid of each n-tile
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      const TfA pa(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* vr = tv + (8 * kk + 2 * tig) * LD + kb + gid;
#pragma unroll
      for (int c0 = 0; c0 < NC; c0 += G) {
        TfB fb[G];
#pragma unroll
        for (int c = 0; c < G; ++c)
          fb[c] = TfB(vr[8 * (c0 + c)], vr[LD + 8 * (c0 + c)]);
        mma3_rows<G>(o + c0, pa, fb);
      }
    }
  }
  cp_async_wait_all();

  const float sa = quad_sum(l0), sb = quad_sum(l1);
  if (p.lse != nullptr && wj == 0 && tig == 0) {
    float* lg = p.lse + (b * p.H + h) * (long long)p.S;
    if (ra < p.S) lg[ra] = row_lse_f32(m0, sa);
    if (rb < p.S) lg[rb] = row_lse_f32(m1, sb);
  }
  const float da = fmaxf(sa, 1e-30f), db = fmaxf(sb, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = kb + 8 * c + 2 * tig;
    if (col >= p.D) continue;
    if (ra < p.S)
      *reinterpret_cast<float2*>(og + (long long)ra * p.so[2] + col) =
          make_float2(o[c][0] / da, o[c][1] / da);
    if (rb < p.S)
      *reinterpret_cast<float2*>(og + (long long)rb * p.so[2] + col) =
          make_float2(o[c][2] / db, o[c][3] / db);
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// ---------------------------------------------------------------------------
// 4a. D > 256, float32, on the CUDA cores
// ---------------------------------------------------------------------------

// A block owns a WIDE_BQ-row query tile and up to 64 CJ output columns: all
// of D up to 1,024, so each score is formed once; wider heads take column
// passes (blocks), each forming the scores again.  256 threads (ty, tx) =
// (tid / 16, tid % 16): query rows ty + 16 i, score columns tx + 16 j of a
// 32-key tile, output columns 4 tx + 64 jj + e.  The scores are summed in
// float32 over D in WIDE_DS-column slices of q and k staged in turn; the
// weights go through shared memory to the P V pass, which reads the tile's
// V rows over all the pass's columns, staged once.
constexpr int WIDE_NT = 256;
constexpr int WIDE_BQ = 32;   // query rows a block, keys a tile
constexpr int WIDE_DS = 128;  // head-dim slice of a score pass

template <int CJ>
struct WideSimt {
  static constexpr int BQ = WIDE_BQ, BK = WIDE_BQ, DO = 64 * CJ;
  // q and k rows of WIDE_DS + 4 floats, V rows of DO + 4 (float4 reads
  // conflict-free); P rows of BK + 16, so the two row groups of a warp
  // write to distinct banks
  static constexpr int LD = WIDE_DS + 4, LV = DO + 4, LP = BK + 16;
  static constexpr int RI = BQ / 16, KJ = BK / 16;
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)(BQ + BK) * LD + (size_t)BQ * LP +
                            (size_t)BK * LV);
  }
};

// rows row0 .. row0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of one head as
// rows of LDT floats; rows >= S and columns >= D are zeros
template <int ROWS, int COLS, int LDT>
__device__ __forceinline__ void stage_wide(float* dst, const float* src,
                                           long long rs, int row0, int c0,
                                           int S, int D) {
#pragma unroll 4
  for (int it = 0; it < ROWS * COLS / WIDE_NT; ++it) {
    const int e = it * WIDE_NT + threadIdx.x;
    const int r = e / COLS, d = e % COLS;
    float x = 0.0f;
    if (row0 + r < S && c0 + d < D) x = src[(long long)(row0 + r) * rs + c0 + d];
    dst[r * LDT + d] = x;
  }
}

template <int CJ>
__global__ void __launch_bounds__(WIDE_NT, 1) fa_wide_simt_kernel(Params p) {
  using C = WideSimt<CJ>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LV = C::LV, LP = C::LP,
                RI = C::RI, KJ = C::KJ, DO = C::DO;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* ps = ks + BK * LD;
  float* vs = ps + BQ * LP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int passes = (p.D + DO - 1) / DO;
  const int bh = blockIdx.x / passes;
  const int d0 = (blockIdx.x % passes) * DO;
  const long long b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

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
              *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
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

    // scale, mask, the running max over the 16 lanes of each row, and the
    // weights (the last tile's P V finished before the slices' first
    // barrier)
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
      bool ok[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        ok[j] = visible(p, qp, k0 + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pw = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += pw;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = pw;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = m[i] == NEG ? 0.0f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    stage_wide<BK, DO, LV>(vs, vg, p.sv[2], k0, d0, p.S, p.D);
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
              vs + (c + cc) * LV + 4 * tx + 64 * jj);
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
    // every column pass holds the row's statistics; the first writes them
    if (p.lse != nullptr && tx == 0 && d0 == 0)
      p.lse[(b * p.H + h) * (long long)p.S + row] = row_lse_f32(m[i], l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = og + (long long)row * p.so[2];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 4 * tx + 64 * jj + e;
        if (d < p.D) orow[d] = acc[i][jj][e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 helpers: ldmatrix, mma.sync
// ---------------------------------------------------------------------------

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

    const float s0 = quad_sum(l0), s1 = quad_sum(l1);
    const float i0 = 1.0f / fmaxf(s0, 1e-30f);
    const float i1 = 1.0f / fmaxf(s1, 1e-30f);
    if (p.lse != nullptr && tig == 0)
      store_lse(p, b, h, row0, row1, m0, s0, m1, s1);
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

    const float s0 = quad_sum(l0), s1 = quad_sum(l1);
    const float i0 = 1.0f / fmaxf(s0, 1e-30f);
    const float i1 = 1.0f / fmaxf(s1, 1e-30f);
    if (p.lse != nullptr && tig == 0)
      store_lse(p, b, h, row0, row1, m0, s0, m1, s1);
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
// 4b. D > 256, bf16: the tensor cores, each score formed once
// ---------------------------------------------------------------------------

// A block owns a 64-row query tile and up to WIDE_PASS 64-column boxes of
// the output: one column pass covers D <= 512; wider heads take
// ceil(D / 512) passes (blocks), each forming the scores again, since a
// 64 x D float32 accumulator does not fit two warpgroups' registers.
// Three warpgroups: a producer (one thread issues every TMA load) and two
// consumers, which share one P.  Every tile of Q, K and V moves as 64-row
// x 64-column boxes (8 KB, 128-byte swizzled) through one ring of slots in
// shared memory, each slot with a full and an empty mbarrier; K's box nb
// (and Q's box nb just before it when Q streams) belongs to consumer
// nb % 2, the pass's V box j to consumer j % 2, so each box has one
// reader.  Per 64-key tile:
//   a. consumer c forms S_c = Q Kᵀ over its boxes of D (wgmma, both
//      operands in shared memory); the two partials together form each
//      score once;
//   b. each writes S_c to shared memory and reads the other's: S = S_0 +
//      S_1, the same bits in both (float addition commutes);
//   c. both run the same online softmax (as fa_wgmma_kernel: log2 units,
//      P rounded to bf16 as A fragments in registers);
//   d. consumer c adds P V for its output boxes (wgmma, V read MN-major)
//      into up to 4 accumulators of 64 columns, 128 registers a thread.
// Each consumer releases a unit's slots once its next unit's products are
// issued (wgmma.wait_group 1); its index is a constant in its code, so no
// branch around a wgmma depends on the thread.  Q stays in shared memory for the whole
// block where it fits beside WIDE_MIN_SLOTS ring slots (D <= 1,280 with
// the 32 KB of partial scores); wider, its boxes stream through the ring
// beside K's, once a key tile.
constexpr int WIDE_ROWS = 64;               // query rows a block, keys a tile
constexpr uint32_t WIDE_BOX = 64 * 64 * 2;  // a TMA box: 64 rows x 64 bf16
constexpr int WIDE_PASS = 8;                // output boxes of a column pass
constexpr int WIDE_MIN_SLOTS = 4;
constexpr int WIDE_MAX_SLOTS = 16;
constexpr uint32_t WIDE_X = 2 * 64 * 64 * 4;  // the consumers' partial S
constexpr size_t SMEM_BLOCK_MAX = 232448;     // a block's shared memory

// the shared memory of one launch at head dim D: Q's boxes when resident,
// the ring, the partial scores, the mbarriers (q_full, full[], empty[])
struct WideWg {
  int nkb, passes, slots, q_res;
  size_t bytes;
  explicit WideWg(int D) {
    nkb = (D + 63) / 64;
    passes = (nkb + WIDE_PASS - 1) / WIDE_PASS;
    const size_t fixed = 1024 + WIDE_X + 8 * (1 + 2 * WIDE_MAX_SLOTS);
    const size_t avail = SMEM_BLOCK_MAX - fixed;
    q_res = (size_t)(nkb + WIDE_MIN_SLOTS) * WIDE_BOX <= avail;
    const size_t ring = avail - (q_res ? (size_t)nkb * WIDE_BOX : 0);
    slots = (int)(ring / WIDE_BOX < WIDE_MAX_SLOTS ? ring / WIDE_BOX
                                                    : WIDE_MAX_SLOTS);
    bytes = fixed + (size_t)((q_res ? nkb : 0) + slots) * WIDE_BOX;
  }
};

__global__ void __launch_bounds__(384, 1)
    fa_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, Params p,
                         int slots, int q_res) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int nkb = (p.D + 63) / 64;
  const int passes = (nkb + WIDE_PASS - 1) / WIDE_PASS;
  const uint32_t sq = base;
  const uint32_t ring = base + (q_res ? nkb * WIDE_BOX : 0u);
  const uint32_t xo = ring + slots * WIDE_BOX;
  float* xs = reinterpret_cast<float*>(smem_raw + (xo - raw));
  const uint32_t q_full = xo + WIDE_X;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + slots + s); };

  const int bh = blockIdx.x / passes;
  const int v0 = blockIdx.x % passes * WIDE_PASS;  // the pass's first box
  const int nvb = min(WIDE_PASS, nkb - v0);
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WIDE_ROWS;  // longest first
  int k_lo, k_hi;
  key_range(p, q0, WIDE_ROWS, k_lo, k_hi);
  const int t_lo = k_lo / WIDE_ROWS;
  const int nt = max(0, (k_hi + WIDE_ROWS - 1) / WIDE_ROWS - t_lo);
  const int nki = q_res ? nkb : 2 * nkb;  // ring items of a tile's scores

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < slots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load, ring item by ring item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      if (q_res) {
        mbar_expect_tx(q_full, nkb * WIDE_BOX);
        for (int nb = 0; nb < nkb; ++nb)
          tma_load(sq + nb * WIDE_BOX, &tq, q_full, nb * 64, q0, h, b);
      }
      int it = 0;
      for (int i = 0; i < nt; ++i) {
        const int k0 = (t_lo + i) * WIDE_ROWS;
        for (int j = 0; j < nki + nvb; ++j, ++it) {
          const int s = it % slots;
          mbar_wait(empty(s), ((it / slots) & 1) ^ 1);
          mbar_expect_tx(full(s), WIDE_BOX);
          const uint32_t dst = ring + s * WIDE_BOX;
          if (j >= nki)
            tma_load(dst, &tv, full(s), (v0 + j - nki) * 64, k0, hk, b);
          else if (!q_res && j % 2 == 0)
            tma_load(dst, &tq, full(s), j / 2 * 64, q0, h, b);
          else
            tma_load(dst, &tk, full(s), (q_res ? j : j / 2) * 64, k0, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // the consumer's index as a constant, so that no branch around its
    // wgmma depends on the thread (ptxas would serialize them)
    auto consume = [&](auto cc) {
      constexpr int c = decltype(cc)::value;
      const int tid = threadIdx.x - 128 * (c + 1);
      const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
      const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
      const float sl = p.scale * LOG2E;
      float o[WIDE_PASS / 2][32];
#pragma unroll
      for (int jb = 0; jb < WIDE_PASS / 2; ++jb)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[jb][e] = 0.0f;
      float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
      // a thread's partial scores sit at [e][tid]: thread tid of the other
      // consumer holds the same (row, key) elements
      float* x_mine = xs + c * 64 * 64;
      const float* x_other = xs + (1 - c) * 64 * 64;
      auto slot = [&](int item) { return ring + (item % slots) * WIDE_BOX; };
      auto wait_full = [&](int item) {
        mbar_wait_spin(full(item % slots), (item / slots) & 1);
      };
      // the slots of a unit whose products are done (a < 0: none)
      auto release = [&](int a, int b) {
        mbar_arrive_if(empty(a % slots), tid == 0 && a >= 0);
        mbar_arrive_if(empty(b % slots), tid == 0 && b >= 0);
      };

      if (q_res) mbar_wait(q_full, 0);
      for (int i = 0; i < nt; ++i) {
        const int k0 = (t_lo + i) * WIDE_ROWS;
        const int base = i * (nki + nvb);  // the tile's first ring item

        // a. S_c = Q Kᵀ over this consumer's boxes nb = c, c + 2, ... of
        //    D: 64 rows x 64 keys; a unit's slots are released once the
        //    next unit's products are issued
        float sc[32];
        int held = -1, held_q = -1;
        wgmma_fence();
        for (int nb = c; nb < nkb; nb += 2) {
          const int ki = base + (q_res ? nb : 2 * nb + 1);
          const int qi = q_res ? -1 : base + 2 * nb;
          wait_full(ki);
          uint32_t qa = sq + nb * WIDE_BOX;
          if (!q_res) {
            wait_full(qi);
            qa = slot(qi);
          }
          const uint32_t ka = slot(ki);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64>(sc, gmma_desc(qa + kk * 32, 16, 1024),
                         gmma_desc(ka + kk * 32, 16, 1024),
                         nb > c || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          release(held, held_q);
          held = ki;
          held_q = qi;
        }
        wgmma_wait<0>();
        reg_fence(sc);
        release(held, held_q);

        // b. S = S_0 + S_1; the first barrier holds this write until the
        //    other consumer has read the last tile's
        named_bar_sync(1, 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) x_mine[e * 128 + tid] = sc[e];
        named_bar_sync(2, 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] += x_other[e * 128 + tid];

        // c. scale (log2 units) and mask; a tile inside every row's limits
        //    skips the mask
        const bool inside = k0 + WIDE_ROWS <= p.S &&
                            (!p.causal || k0 + WIDE_ROWS - 1 <= q0) &&
                            (!p.has_window || k0 > q0 + 63 - p.window);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * sl;
            if (!inside && !visible(p, e < 2 ? row0 : row1,
                                    k0 + 8 * j + 2 * tig + (e & 1)))
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
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = exp2f(sc[4 * j] - m0),
                      p1 = exp2f(sc[4 * j + 1] - m0);
          const float p2 = exp2f(sc[4 * j + 2] - m1),
                      p3 = exp2f(sc[4 * j + 3] - m1);
          l0 += p0 + p1;
          l1 += p2 + p3;
          pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int jb = 0; jb < WIDE_PASS / 2; ++jb)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[jb][4 * j] *= a0;
            o[jb][4 * j + 1] *= a0;
            o[jb][4 * j + 2] *= a1;
            o[jb][4 * j + 3] *= a1;
          }

        // d. O += P V over this consumer's boxes j = c, c + 2, ... of the
        //    pass
        held = -1;
        wgmma_fence();
#pragma unroll
        for (int jb = 0; jb < WIDE_PASS / 2; ++jb) {
          const int j = 2 * jb + c;
          if (j < nvb) {
            const int vi = base + nki + j;
            wait_full(vi);
            const uint32_t va = slot(vi);
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
              wgmma_rs<64>(o[jb], pa[kc],
                           gmma_desc(va + kc * 16 * 128, WIDE_BOX, 1024));
            wgmma_commit();
            wgmma_wait<1>();
            release(held, -1);
            held = vi;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int jb = 0; jb < WIDE_PASS / 2; ++jb) reg_fence(o[jb]);
        release(held, -1);
      }

      const float s0 = quad_sum(l0), s1 = quad_sum(l1);
      const float i0 = 1.0f / fmaxf(s0, 1e-30f);
      const float i1 = 1.0f / fmaxf(s1, 1e-30f);
      // both consumers and every column pass hold the same m and l: the
      // first pass's consumer 0 writes the rows' lse
      if (p.lse != nullptr && c == 0 && v0 == 0 && tig == 0)
        store_lse(p, b, h, row0, row1, m0, s0, m1, s1);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                          (long long)b * p.so[0] + (long long)h * p.so[1];
#pragma unroll
      for (int jb = 0; jb < WIDE_PASS / 2; ++jb) {
        const int j = 2 * jb + c;
        if (j < nvb) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int d = (v0 + j) * 64 + 8 * n + 2 * tig;
            if (d < p.D) {
              if (row0 < p.S)
                store_bf16x2(og + (long long)row0 * p.so[2] + d,
                             o[jb][4 * n] * i0, o[jb][4 * n + 1] * i0);
              if (row1 < p.S)
                store_bf16x2(og + (long long)row1 * p.so[2] + d,
                             o[jb][4 * n + 2] * i1, o[jb][4 * n + 3] * i1);
            }
          }
        }
      }
    };
    if (wg == 1)
      consume(std::integral_constant<int, 0>{});
    else
      consume(std::integral_constant<int, 1>{});
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// float32 needs 16-byte bases and (b, h, s) strides of whole 16-byte
// groups (cp.async)
bool aligned16_f32(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

// fa_f32_kernel at head-dim tile DT (short: 32-row tiles); the grid and
// the threads as the wrapper planned them
template <int DT, bool SHORT = false>
int launch_f32(const Params& p, long long BH, dim3 grid, int threads,
               cudaStream_t st) {
  using C = typename F32FwdCfg<DT, SHORT>::C;
  static_assert(C::bytes() <= 232448, "fa_f32_kernel's tiles exceed 227 KB");
  if (BH != grid.x || grid.y != (unsigned)((p.S + C::BM - 1) / C::BM) ||
      threads != C::NT)
    return (int)cudaErrorInvalidValue;
  return launch(fa_f32_kernel<C>, C::bytes(), grid, C::NT, st, p);
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D); element strides over (b, h, s),
// D contiguous.  variant: 0 = fa_f32_kernel (float32), 1 = fa_wgmma_kernel
// (bf16), 2 = fa_mma16_kernel (bf16, S <= 128), 3 = fa_wide_simt_kernel
// (float32, D > 256), 4 = fa_wide_wgmma_kernel (bf16, D > 256, a multiple
// of 8); tile_d the instantiation's head-dim tile (for 3 and 4 the output
// columns of a block); grid and threads as the wrapper planned them (checked
// here against the instantiation's tiles).  window is read when has_window
// is set.  lse: null, or a (B, H, S) float32 output of each row's
// log-sum-exp (every instantiation).  Returns a cudaError_t:
// cudaErrorInvalidValue for a plan that does not fit the instantiation
// (tile, grid, D, strides or alignment) or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int variant,
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
  p.lse = static_cast<float*>(lse);
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

  if (variant == 3) {  // fa_wide_simt_kernel: float32, D > 256
    const int cj = D <= 512 ? 8 : 16;
    if (tile_d != 64 * cj || D <= 256 ||
        (long long)grid_x != BH * ((D + 64 * cj - 1) / (64 * cj)) ||
        grid_y != (S + WIDE_BQ - 1) / WIDE_BQ || threads != WIDE_NT)
      return bad;
    if (cj == 8)
      return launch(fa_wide_simt_kernel<8>, WideSimt<8>::bytes(), grid,
                    WIDE_NT, s, p);
    return launch(fa_wide_simt_kernel<16>, WideSimt<16>::bytes(), grid,
                  WIDE_NT, s, p);
  }
  if (variant == 4) {  // fa_wide_wgmma_kernel: bf16, D > 256
    const WideWg w(D);
    if (tile_d != 64 * WIDE_PASS || D <= 256 || D % 8 != 0 ||
        (long long)grid_x != BH * w.passes ||
        grid_y != (S + WIDE_ROWS - 1) / WIDE_ROWS || threads != 384 ||
        !aligned16(q, p.sq) || !aligned16(k, p.sk) || !aligned16(v, p.sv) ||
        !aligned16(o, p.so))
      return bad;
    CUtensorMap tq, tk, tv;
    int e = tensor_map(&tq, q, D, S, H, B, p.sq, WIDE_ROWS);
    if (e == 0) e = tensor_map(&tk, k, D, S, Hkv, B, p.sk, WIDE_ROWS);
    if (e == 0) e = tensor_map(&tv, v, D, S, Hkv, B, p.sv, WIDE_ROWS);
    if (e != 0) return e;
    return launch(fa_wide_wgmma_kernel, w.bytes, grid, 384, s, tq, tk, tv, p,
                  w.slots, w.q_res);
  }
  if (variant == 0) {  // fa_f32_kernel: float32, D a multiple of 4
    if (tile_d % 32 != 0 || tile_d > 256 || D % 4 != 0 ||
        D <= tile_d - 32 || !aligned16_f32(q, p.sq) ||
        !aligned16_f32(k, p.sk) || !aligned16_f32(v, p.sv) ||
        !aligned16_f32(o, p.so))
      return bad;
    if (tile_d <= 64 && S <= F32_SHORT_S)
      return tile_d == 32 ? launch_f32<32, true>(p, BH, grid, threads, s)
                          : launch_f32<64, true>(p, BH, grid, threads, s);
    switch (tile_d) {
      case 32: return launch_f32<32>(p, BH, grid, threads, s);
      case 64: return launch_f32<64>(p, BH, grid, threads, s);
      case 96: return launch_f32<96>(p, BH, grid, threads, s);
      case 128: return launch_f32<128>(p, BH, grid, threads, s);
      case 160: return launch_f32<160>(p, BH, grid, threads, s);
      case 192: return launch_f32<192>(p, BH, grid, threads, s);
      case 224: return launch_f32<224>(p, BH, grid, threads, s);
      default: return launch_f32<256>(p, BH, grid, threads, s);
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
