// Flash attention backward: the gradients of causal / sliding-window
// grouped-query attention (flash_attention.cu's function) with respect to
// q, k and v.  For q, o, dO (B, H, S, D) and k, v (B, Hkv, S, D), query
// head h reading KV head h / G (G = H / Hkv), with the weights P of the
// forward recomputed from q, k and the log-sum-exp the forward saves:
//
//     P    = exp(scale · Q Kᵀ − lse)            (lse from the forward)
//     Δ_i  = Σ_d dO_id · O_id                   (from the stored o)
//     dP   = dO Vᵀ,   dS = P ∘ (dP − Δ)
//     dQ   = scale · dS K
//     dK   = scale · Σ_{G heads} dSᵀ Q,   dV = Σ_{G heads} Pᵀ dO
//
// with float32 sums, the gradients written in the inputs' dtype.  The
// visible pairs are the forward's: k_pos <= q_pos (causal), k_pos > q_pos
// - window, both < S; a row with no visible key has lse = +inf, so P = 0,
// and gets zero gradients.
//
// Replaces no TPU kernel: the reference package has no backward kernel
// (its models differentiate the XLA path).  This is the gradient of
// flash_attention_pallas (src/repro/kernels/flash_attention/
// flash_attention.py) for the port, whose models run the forward kernel
// under autograd.
//
// Bound on the H100 (chip_smoke.py, _fa_bwd_cost): operations -- 2·D FLOP
// for each of the five products (S, dP, dV, dK, dQ) per visible pair and
// head, 2.5 times the forward's, at 989 TFLOP/s in bf16 and, for the
// float32 kernels, as three TF32 products at 495 TFLOP/s (3xTF32) --
// against bytes: q, k, v, o, dO read once and dq, dk, dv written once at
// 3.35 TB/s.  The two kernels each form S and dP (7 products a pair where
// the bound counts 5), the group sum adds 2·(B·H·S·D·4) bytes of float32
// partials written and read back, and the wide variants' column passes
// repeat score products; all count in the kernels' time, not in the bound.
//
// Every variant runs Δ first, then a dQ kernel and a dK / dV kernel that
// each give every query head its own blocks, and, for G > 1, a group sum
// (bwd_reduce_kernel) that adds each KV head's G per-head partials in
// ascending head order: no atomics, no block walking a group's heads one
// after another, and every gradient element summed in a fixed order, so
// two runs give the same bits.  Variants, chosen by the wrapper
// (kernels/flash_attention/ops.py, plan_attention_bwd):
//
// 1. "wgmma", bf16, D <= 256 (D a multiple of 16; the wrapper pads):
//    a. bwd_delta_kernel: Δ = rowsum(dO ∘ O) in float32, a small
//       bytes-bound pre-pass (a group of lanes a row, 16-byte loads),
//       written once for both kernels below;
//    b. bwd_dq_wgmma_kernel, a block per (b, h, query tile of 64 rows per
//       consumer warpgroup: 128 at D <= 128, 64 at 256): the forward's
//       warp-specialized shape -- a producer warpgroup whose one thread
//       loads the Q and dO tiles once and 64-key K and V tiles into a
//       two-stage TMA ring (128-byte swizzle, full / empty mbarriers) --
//       over the visible key tiles only.  Per tile: S = Q Kᵀ and
//       dP = dO Vᵀ as wgmma from shared memory; P = exp(scale·S − lse)
//       in registers; dS = P ∘ (dP − Δ) packed in place into bf16 A
//       fragments; dQ += dS K as wgmma with K read MN-major (the
//       forward's transpose bit for V).  dQ is scaled and written once;
//    c. bwd_dkdv_wgmma_kernel, a block per (b, query head h, key tile):
//       K and V of the tile loaded once, Q and dO tiles of 64 rows (with
//       the rows' lse and Δ, staged by a second producer warp) streamed
//       through the ring over the visible query tiles.  It forms the
//       transposed products, so Pᵀ and dSᵀ land in registers as A
//       operands: Sᵀ = K Qᵀ, Pᵀ = exp(scale·Sᵀ − lse), dV += Pᵀ dO,
//       dPᵀ = V dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − Δ), dK += dSᵀ Q (Q and dO read
//       MN-major).  At D <= 128 two consumer warpgroups each own 64 of a
//       128-row key tile; at D = 256 the float32 dK and dV of 64 x 256
//       would need 256 registers a thread, so the two consumers share a
//       64-row key tile and split D's columns, 128 each, both forming the
//       tile's Sᵀ and dPᵀ (2 of the 5 products done twice at D = 256).
//       With G = 1 it writes dk, dv; with G > 1 each block writes its
//       head's float32 partial dK (scaled), dV into a (2, B, H, S, D)
//       scratch;
//    d. bwd_reduce_kernel (G > 1 only): the group sum into dk, dv.
//    Tiles wholly inside the causal limit and the window skip the mask;
//    a warpgroup skips a tile it cannot see at all.  P and dS are rounded
//    to bf16 for the dV, dK and dQ products (as the forward rounds P).
// 2. "wide", bf16, D > 256 (D a multiple of 8; TMA zero-fills each
//    64-column box past D): bwd_delta_kernel, then bwd_dq_wide_kernel and
//    bwd_dkdv_wide_kernel with variant 1's passes and the forward's
//    fa_wide_wgmma_kernel shape -- a producer warpgroup and two consumers,
//    every operand a 64 x 64 TMA box through one ring of 16 slots, each
//    box read by one consumer.  The score products S = Q Kᵀ and dP = dO
//    Vᵀ (Sᵀ = K Qᵀ, dPᵀ = V dOᵀ for dK / dV) contract over D: each
//    consumer takes D's boxes c, c + 2, ... and adds the other's partial
//    once through 32 KB of shared memory, so each is formed once per tile
//    pair, with the same bits in both.  P comes from the forward's lse
//    (fa_wide_wgmma_kernel writes it under autograd), dS = P ∘ (dP − Δ);
//    P and dS are rounded to bf16 A fragments.  The output columns go in
//    passes (blocks): dQ holds 8 boxes (512 columns, 4 a consumer, 128
//    registers a thread) a block; dK and dV, two 64 x D accumulators (256
//    KB at D = 512), hold 4 boxes of each (256 columns, 2 a consumer), so
//    D = 512 takes two dK / dV passes.  Each pass forms its tile pair's S
//    and dP again: at D = 512 the kernels do 3 + 2 x 3 = 9 products of
//    2·D FLOP a visible pair against the bound's 5.  With H > Hkv the
//    group sum as in 1.
// 3. float32 on the tensor cores: every product a 3xTF32 mma.sync.m16n8k8
//    (each operand split into a TF32 hi part -- here the value with its 13
//    low bits cleared -- and the remainder, which the tensor core reads as
//    TF32; lo·hi + hi·lo + hi·hi summed in float32, ~2^-20 relative a
//    product, where one TF32 product's ~2^-11 would not hold the
//    reference's 1e-4 bound), the softmax in float32 with expf (the build
//    keeps -fmad=false), P from the lse the float32 forward saves.  wgmma
//    takes 32-bit operands K-major only, and dQ += dS K, dV += Pᵀ dO, dK
//    += dSᵀ Q read theirs MN-major, so the products are mma.sync with
//    fragments read from shared tiles of rows of a multiple of 32 plus 4
//    floats, conflict-free in either orientation; the S / dP accumulators
//    become the A fragments of the next product in registers.  Tiles move
//    by cp.async (16 bytes, zeros past S and D; the wrapper pads D to a
//    multiple of 4).  Δ comes from bwd_delta_f32_kernel, formed the way
//    each kernel forms its dP -- the same 3xTF32 chains with O in V's
//    place -- so dP − Δ is exactly 0 where a key's V is the row's O (a row
//    that sees one key, whose gradient through dS is 0 and would otherwise
//    be the difference of two roundings); two planes, one a kernel.
//    a. "f32", D <= 256: bwd_dq_f32_kernel, a block per (b, h, query tile;
//       64 rows, 128 at D = 128), a warp per 16 rows, Q and dO held, K and
//       V tiles (64 keys, 32 above D = 64) through a two-stage ring (one
//       stage at D = 256) over the visible key tiles, longest query tiles
//       first, S and dP formed in one loop; and bwd_dkdv_f32_kernel, a
//       block per (b, query head, key tile; 64 keys, 128 at D = 128, 32 at
//       256), K and V held, Q and dO tiles with their rows' lse and Δ
//       through a two-stage ring, Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, dV += Pᵀ dO, dK
//       += dSᵀ Q.  At D <= 64 a sequence of up to 96 rows takes 32-row
//       tiles both ways.  A tile pair every row sees whole skips the mask.  At D = 256 the dK and dV of 16 rows x 256 would need 256
//       registers a thread, so two warps share each 16 key rows and split
//       D: each contracts the scores over 128 of D's columns and owns 128
//       columns of dK and dV, and the two add their partial Sᵀ and dPᵀ
//       through shared memory in warp order;
//    b. "f32 wide", D > 256: bwd_dq_f32_wide_kernel and
//       bwd_dkdv_f32_wide_kernel, 32-row tiles of both sides, four warps
//       a 16-row group: the score products contract over D in chunks
//       (256 columns in dQ, 128 in dK / dV) staged in turn, each warp a
//       quarter of every chunk, their partials summed as in a; then the
//       pass's 512 output columns of K (dQ) or of Q and dO (dK / dV) are
//       staged over the chunks' memory, 128 a warp.  Wider heads take
//       column passes (blocks), each forming S and dP again: 2 P + 1
//       products in dQ and 2 P + 2 in dK / dV a visible pair for P passes
//       (7 at D <= 512) against the bound's 5;
//    c. with H > Hkv bwd_reduce_kernel's float32 build sums the group.
//
// Layouts: per-(b, h, s) element strides with D contiguous, so the model's
// (B, S, H, hd) activations go in as transposed views without a copy;
// variants 1 and 2 need 16-byte aligned bases and strides (TMA), 3 too
// (cp.async), and the wrapper copies a tensor where that does not hold.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// a launch's arguments; T the inputs' and gradients' element type
template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;  // (B, H, S): the forward's, natural units
  float* delta;      // (B, H, S): Δ, written by bwd_delta_kernel
  T* dq;
  T* dk;
  T* dv;
  float* part;  // G > 1: (2, B, H, S, D) partial dK, dV; G = 1: null
  int B, H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, has_window, window;
  float scale;
};
using WgParams = BwdParams<__nv_bfloat16>;
using F32Params = BwdParams<float>;

// ---------------------------------------------------------------------------
// 1. bf16 on the tensor cores ("wgmma")
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ bool seen(const BwdParams<T>& p, int row, int key) {
  return key < p.S && (!p.causal || key <= row) &&
         (!p.has_window || key > row - p.window);
}

// Δ of each (b, h, row): GS = 2^gs_log2 lanes a row, 8 bf16 (16 bytes) of
// o and dO a lane at a time, summed over the group by shuffles
__global__ void __launch_bounds__(256) bwd_delta_kernel(WgParams p,
                                                        int gs_log2) {
  const int GS = 1 << gs_log2;
  const long long rows = (long long)p.B * p.H * p.S;
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> gs_log2;
  const int lane = threadIdx.x & (GS - 1);
  float acc = 0.0f;
  if (row < rows) {
    const int s = (int)(row % p.S);
    const long long bh = row / p.S;
    const long long b = bh / p.H, h = bh % p.H;
    const __nv_bfloat16* orow = p.o + b * p.so[0] + h * p.so[1] + s * p.so[2];
    const __nv_bfloat16* drow =
        p.dout + b * p.sdo[0] + h * p.sdo[1] + s * p.sdo[2];
    for (int c = lane * 8; c < p.D; c += GS * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 d = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(d2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  // every lane of the warp takes part in the shuffles
  for (int off = GS / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) p.delta[row] = acc;
}

// dQ: NC consumer warpgroups of 64 query rows over 64-key tiles, ST ring
// stages.  Shared memory: the Q tile, the dO tile, then ST x (K, V) tiles;
// a tile of R rows is DP / 64 boxes of R rows x 128 bytes (64 bf16),
// 128-byte swizzled by TMA.
template <int DP>
struct DqTile {
  static constexpr int NC = DP <= 128 ? 2 : 1;
  static constexpr int BQ = 64 * NC, BK = 64, ST = 2;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  static constexpr uint32_t BARS = 2 * Q_BYTES + ST * 2 * KV_BYTES;
  // q_full, k_full[ST], v_full[ST], empty[ST]; 1,024 for aligning the base
  static constexpr size_t bytes() { return BARS + 8 * (1 + 3 * ST) + 1024; }
};

template <int DP>
__global__ void __launch_bounds__(128 * (DqTile<DP>::NC + 1), 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, WgParams p) {
  using L = DqTile<DP>;
  constexpr int NC = L::NC, BK = L::BK, ST = L::ST, BQ = L::BQ, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::Q_BYTES;
  const uint32_t skv = base + 2 * L::Q_BYTES;
  const uint32_t q_full = base + L::BARS;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * ST + s); };
  auto k_tile = [&](int s) { return skv + s * 2 * L::KV_BYTES; };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  // the keys any of the tile's rows can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = min(p.S, q0 + BQ);
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
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
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load(sq + nb * BQ * 128, &tq, q_full, nb * 64, q0, h, b);
        tma_load(sdo + nb * BQ * 128, &tdo, q_full, nb * 64, q0, h, b);
      }
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
    // the rows' lse in log2 units (+inf past S: P = 0) and Δ
    const long long bh = (long long)b * p.H + h;
    const float ls0 = row0 < p.S ? p.lse[bh * p.S + row0] * LOG2E : INFINITY;
    const float ls1 = row1 < p.S ? p.lse[bh * p.S + row1] * LOG2E : INFINITY;
    const float dl0 = row0 < p.S ? p.delta[bh * p.S + row0] : 0.0f;
    const float dl1 = row1 < p.S ? p.delta[bh * p.S + row1] : 0.0f;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % ST, k0 = (t_lo + i) * BK;
      const uint32_t ph = (i / ST) & 1;
      const uint32_t kt = k_tile(s), vt = kt + L::KV_BYTES;
      mbar_wait(k_full(s), ph);
      mbar_wait(v_full(s), ph);
      // a key tile this warpgroup's rows cannot see at all adds nothing
      const bool none = (p.causal && k0 > r_lo + 63) ||
                        (p.has_window && k0 + BK - 1 <= r_lo - p.window);
      if (!none) {
        // S = Q Kᵀ and dP = dO Vᵀ: 64 rows x BK keys, DP / 16 steps of k16
        float sc[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BK>(sc,
                       gmma_desc(sq + (kk / 4) * BQ * 128 + c * 64 * 128 +
                                     (kk % 4) * 32, 16, 1024),
                       gmma_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BK>(dp,
                       gmma_desc(sdo + (kk / 4) * BQ * 128 + c * 64 * 128 +
                                     (kk % 4) * 32, 16, 1024),
                       gmma_desc(vt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
        wgmma_commit_wait();
        reg_fence(sc);
        reg_fence(dp);

        // P from the saved lse, masked unless the tile is inside every
        // row's limits; dS as bf16 A fragments: the accumulator's (row, 2
        // keys) pairs of two neighbouring 8-key columns are one k16
        // fragment
        const bool inside = k0 + BK <= p.S &&
                            (!p.causal || k0 + BK - 1 <= r_lo) &&
                            (!p.has_window || k0 > r_lo + 63 - p.window);
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            float pr = exp2f(sc[4 * j + e] * sl - (hi ? ls1 : ls0));
            if (!inside &&
                !seen(p, hi ? row1 : row0, k0 + 8 * j + 2 * tig + (e & 1)))
              pr = 0.0f;
            ds[e] = pr * (dp[4 * j + e] - (hi ? dl1 : dl0));
          }
          da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
          da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS K: BK / 16 steps of k16, K MN-major
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
          wgmma_rs<DP>(dq, da[kc],
                       gmma_desc(kt + kc * 16 * 128, BK * 128, 1024));
        wgmma_commit_wait();
        reg_fence(dq);
      }
      if (tid == 0) mbar_arrive(empty(s));
    }

    __nv_bfloat16* dqg = p.dq + (long long)b * p.sdq[0] + (long long)h * p.sdq[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tig;
      if (d < p.D) {
        if (row0 < p.S)
          store_bf16x2(dqg + (long long)row0 * p.sdq[2] + d,
                       p.scale * dq[4 * j], p.scale * dq[4 * j + 1]);
        if (row1 < p.S)
          store_bf16x2(dqg + (long long)row1 * p.sdq[2] + d,
                       p.scale * dq[4 * j + 2], p.scale * dq[4 * j + 3]);
      }
    }
  }
}

// dK / dV: two consumer warpgroups.  At D <= 128 each owns 64 rows of a
// 128-row key tile and every column (DC = DP); at D = 256 both own the
// tile's 64 rows, DC = 128 columns each.  Shared memory: the K tile, the
// V tile, ST ring stages of (Q tile, dO tile) of BQ = 64 rows, then ST
// stages of the rows' lse (log2 units) and Δ.
template <int DP>
struct KvTile {
  static constexpr int NC = 2;
  static constexpr int DC = DP <= 128 ? DP : 128;
  static constexpr int RG = DP <= 128 ? 2 : 1;  // 64-row key groups
  static constexpr int BKV = 64 * RG, BQ = 64, ST = 2;
  static constexpr uint32_t KV_BYTES = BKV * DP * 2;
  static constexpr uint32_t QD_BYTES = BQ * DP * 2;
  static constexpr uint32_t RING = 2 * KV_BYTES;
  static constexpr uint32_t STATS = RING + ST * 2 * QD_BYTES;
  static constexpr uint32_t BARS = STATS + ST * 2 * BQ * 4;
  // kv_full, full[ST], empty[ST]; 1,024 for aligning the base
  static constexpr size_t bytes() { return BARS + 8 * (1 + 2 * ST) + 1024; }
};

template <int DP>
__global__ void __launch_bounds__(128 * (KvTile<DP>::NC + 1), 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, WgParams p) {
  using L = KvTile<DP>;
  constexpr int NC = L::NC, DC = L::DC, RG = L::RG, BKV = L::BKV, BQ = L::BQ,
                ST = L::ST, NB = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + L::KV_BYTES, ring = base + L::RING;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) + L::STATS);
  const uint32_t kv_full = base + L::BARS;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + ST + s); };
  auto q_tile = [&](int s) { return ring + s * 2 * L::QD_BYTES; };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  const int j0 = blockIdx.y * BKV;  // causal: the longest key tiles first
  // the queries any of the tile's keys is seen by: [i_lo, i_hi)
  const int j_last = min(j0 + BKV, p.S) - 1;
  const int i_lo = p.causal ? j0 : 0;
  const int i_hi = p.has_window ? min(p.S, j_last + p.window) : p.S;
  const int t_lo = i_lo / BQ;
  const int nt = max(0, (i_hi + BQ - 1) / BQ - t_lo);
  const long long bh = (long long)b * p.H + h;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread and the stats warp
      mbar_init(empty(s), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // thread 0: K and V once, then Q and dO tiles into the ring
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load(sk + nb * BKV * 128, &tk, kv_full, nb * 64, j0, hk, b);
        tma_load(sv + nb * BKV * 128, &tv, kv_full, nb * 64, j0, hk, b);
      }
      for (int i = 0; i < nt; ++i) {
        const int s = i % ST, i0 = (t_lo + i) * BQ;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::QD_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(q_tile(s) + nb * BQ * 128, &tq, full(s), nb * 64, i0, h, b);
          tma_load(q_tile(s) + L::QD_BYTES + nb * BQ * 128, &tdo, full(s),
                   nb * 64, i0, h, b);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // warp 1: each stage's lse (log2 units; +inf past S, so P = 0) and Δ
      const int lane = threadIdx.x - 32;
      for (int i = 0; i < nt; ++i) {
        const int s = i % ST, i0 = (t_lo + i) * BQ;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        float* st = stats + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int row = i0 + r;
          st[r] = row < p.S ? p.lse[bh * p.S + row] * LOG2E : INFINITY;
          st[BQ + r] = row < p.S ? p.delta[bh * p.S + row] : 0.0f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
    const int rg = RG == 2 ? c : 0, c0 = RG == 2 ? 0 : DC * c;
    const int j_lo = j0 + 64 * rg;  // this warpgroup's first key
    const int key0 = j_lo + 16 * warp + g, key1 = key0 + 8;
    const float sl = p.scale * LOG2E;
    float dk[DC / 2], dv[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.0f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % ST, i0 = (t_lo + i) * BQ;
      const uint32_t ph = (i / ST) & 1;
      const uint32_t qt = q_tile(s), dot = qt + L::QD_BYTES;
      mbar_wait(full(s), ph);
      // a query tile that sees none of this warpgroup's keys adds nothing
      const bool none = j_lo >= p.S || (p.causal && i0 + BQ - 1 < j_lo) ||
                        (p.has_window && i0 >= j_lo + 63 + p.window);
      if (!none) {
        // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 keys x BQ queries, DP / 16 k16
        float st[BQ / 2], dpt[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BQ>(st,
                       gmma_desc(sk + (kk / 4) * BKV * 128 + rg * 64 * 128 +
                                     (kk % 4) * 32, 16, 1024),
                       gmma_desc(qt + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BQ>(dpt,
                       gmma_desc(sv + (kk / 4) * BKV * 128 + rg * 64 * 128 +
                                     (kk % 4) * 32, 16, 1024),
                       gmma_desc(dot + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                                 16, 1024),
                       kk > 0);
        wgmma_commit_wait();
        reg_fence(st);
        reg_fence(dpt);

        // Pᵀ and dSᵀ as bf16 A fragments (rows: keys, columns: queries)
        const bool inside = j_lo + 64 <= p.S &&
                            (!p.causal || j_lo + 63 <= i0) &&
                            (!p.has_window || j_lo > i0 + 63 - p.window);
        const float* stage = stats + s * 2 * BQ;
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float2 ls = *reinterpret_cast<const float2*>(stage + col);
          const float2 dl = *reinterpret_cast<const float2*>(stage + BQ + col);
          float pr[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            float x = exp2f(st[4 * j + e] * sl - (odd ? ls.y : ls.x));
            if (!inside && !seen(p, i0 + col + odd, e < 2 ? key0 : key1))
              x = 0.0f;
            pr[e] = x;
            ds[e] = x * (dpt[4 * j + e] - (odd ? dl.y : dl.x));
          }
          pa[j / 2][(j % 2) * 2] = pack_bf16(pr[0], pr[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
          da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
          da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dV += Pᵀ dO and dK += dSᵀ Q over this warpgroup's DC columns:
        // BQ / 16 steps of k16, dO and Q MN-major
        const uint32_t cb = (c0 / 64) * BQ * 128;
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc)
          wgmma_rs<DC>(dv, pa[kc],
                       gmma_desc(dot + cb + kc * 16 * 128, BQ * 128, 1024));
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc)
          wgmma_rs<DC>(dk, da[kc],
                       gmma_desc(qt + cb + kc * 16 * 128, BQ * 128, 1024));
        wgmma_commit_wait();
        reg_fence(dv);
        reg_fence(dk);
      }
      if (tid == 0) mbar_arrive(empty(s));
    }

    if (p.part == nullptr) {
      // G = 1: the head's gradients are its KV head's
      __nv_bfloat16* dkg =
          p.dk + (long long)b * p.sdk[0] + (long long)hk * p.sdk[1];
      __nv_bfloat16* dvg =
          p.dv + (long long)b * p.sdv[0] + (long long)hk * p.sdv[1];
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int d = c0 + 8 * j + 2 * tig;
        if (d < p.D) {
          if (key0 < p.S) {
            store_bf16x2(dkg + (long long)key0 * p.sdk[2] + d,
                         p.scale * dk[4 * j], p.scale * dk[4 * j + 1]);
            store_bf16x2(dvg + (long long)key0 * p.sdv[2] + d, dv[4 * j],
                         dv[4 * j + 1]);
          }
          if (key1 < p.S) {
            store_bf16x2(dkg + (long long)key1 * p.sdk[2] + d,
                         p.scale * dk[4 * j + 2], p.scale * dk[4 * j + 3]);
            store_bf16x2(dvg + (long long)key1 * p.sdv[2] + d, dv[4 * j + 2],
                         dv[4 * j + 3]);
          }
        }
      }
    } else {
      // G > 1: this head's float32 partials, dK already scaled
      float* pk = p.part + bh * p.S * p.D;
      float* pv = pk + (long long)p.B * p.H * p.S * p.D;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int d = c0 + 8 * j + 2 * tig;
        if (d < p.D) {
          if (key0 < p.S) {
            *reinterpret_cast<float2*>(pk + (long long)key0 * p.D + d) =
                make_float2(p.scale * dk[4 * j], p.scale * dk[4 * j + 1]);
            *reinterpret_cast<float2*>(pv + (long long)key0 * p.D + d) =
                make_float2(dv[4 * j], dv[4 * j + 1]);
          }
          if (key1 < p.S) {
            *reinterpret_cast<float2*>(pk + (long long)key1 * p.D + d) =
                make_float2(p.scale * dk[4 * j + 2], p.scale * dk[4 * j + 3]);
            *reinterpret_cast<float2*>(pv + (long long)key1 * p.D + d) =
                make_float2(dv[4 * j + 2], dv[4 * j + 3]);
          }
        }
      }
    }
  }
}

// dk, dv of each KV head: the sum of its G heads' partials in ascending
// head order, 4 columns a thread (float4 in, 4 of T out)
template <typename T>
__global__ void __launch_bounds__(256) bwd_reduce_kernel(BwdParams<T> p) {
  const int Hkv = p.H / p.group, C4 = p.D / 4;
  const long long per = (long long)p.B * Hkv * p.S * C4;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * per) return;
  const bool is_v = t >= per;
  if (is_v) t -= per;
  const int c4 = (int)(t % C4);
  long long r = t / C4;
  const int s = (int)(r % p.S);
  r /= p.S;
  const long long hk = r % Hkv, b = r / Hkv;
  const long long hstride = (long long)p.S * p.D;
  const float* src = p.part + (is_v ? p.B * p.H * hstride : 0) +
                     (b * p.H + hk * p.group) * hstride + (long long)s * p.D +
                     4 * c4;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < p.group; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + g * hstride);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* dst = is_v ? p.dv + b * p.sdv[0] + hk * p.sdv[1] + s * p.sdv[2]
               : p.dk + b * p.sdk[0] + hk * p.sdk[1] + s * p.sdk[2];
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(dst + 4 * c4) = acc;
  } else {
    store_bf16x2(dst + 4 * c4, acc.x, acc.y);
    store_bf16x2(dst + 4 * c4 + 2, acc.z, acc.w);
  }
}

// Δ of every (b, h, row): 2^gs lanes a row, at most a warp's 32
int launch_delta(const WgParams& p, cudaStream_t st) {
  const long long rows = (long long)p.B * p.H * p.S;
  int gs_log2 = 0;
  while ((1 << gs_log2) < p.D / 8 && gs_log2 < 5) ++gs_log2;
  return launch(bwd_delta_kernel, 0,
                dim3((unsigned)(((rows << gs_log2) + 255) / 256)), 256, st, p,
                gs_log2);
}

// the group sum of G > 1 heads' partials into dk, dv
template <typename T>
int launch_reduce(const BwdParams<T>& p, int Hkv, cudaStream_t st) {
  const long long groups = 2LL * p.B * Hkv * p.S * (p.D / 4);
  return launch(bwd_reduce_kernel<T>, 0, dim3((unsigned)((groups + 255) / 256)),
                256, st, p);
}

template <int DP>
int launch_wgmma(const WgParams& p, int Hkv, cudaStream_t st) {
  using Q = DqTile<DP>;
  using K = KvTile<DP>;
  int err = launch_delta(p, st);
  if (err != 0) return err;

  CUtensorMap tq, tdo, tk, tv;
  err = tensor_map(&tq, p.q, p.D, p.S, p.H, p.B, p.sq, Q::BQ);
  if (err == 0) err = tensor_map(&tdo, p.dout, p.D, p.S, p.H, p.B, p.sdo, Q::BQ);
  if (err == 0) err = tensor_map(&tk, p.k, p.D, p.S, Hkv, p.B, p.sk, Q::BK);
  if (err == 0) err = tensor_map(&tv, p.v, p.D, p.S, Hkv, p.B, p.sv, Q::BK);
  if (err != 0) return err;
  err = launch(bwd_dq_wgmma_kernel<DP>, Q::bytes(),
               dim3(p.B * p.H, (p.S + Q::BQ - 1) / Q::BQ), 128 * (Q::NC + 1),
               st, tq, tdo, tk, tv, p);
  if (err != 0) return err;

  err = tensor_map(&tq, p.q, p.D, p.S, p.H, p.B, p.sq, K::BQ);
  if (err == 0) err = tensor_map(&tdo, p.dout, p.D, p.S, p.H, p.B, p.sdo, K::BQ);
  if (err == 0) err = tensor_map(&tk, p.k, p.D, p.S, Hkv, p.B, p.sk, K::BKV);
  if (err == 0) err = tensor_map(&tv, p.v, p.D, p.S, Hkv, p.B, p.sv, K::BKV);
  if (err != 0) return err;
  err = launch(bwd_dkdv_wgmma_kernel<DP>, K::bytes(),
               dim3(p.B * p.H, (p.S + K::BKV - 1) / K::BKV),
               128 * (K::NC + 1), st, tq, tdo, tk, tv, p);
  if (err != 0 || p.group == 1) return err;
  return launch_reduce(p, Hkv, st);
}

// ---------------------------------------------------------------------------
// 2. bf16, D > 256 ("wide")
// ---------------------------------------------------------------------------

// Three warpgroups as in the forward's
// fa_wide_wgmma_kernel: a producer (one thread issues every TMA load) and
// two consumers.  Every tile of Q, K, V and dO moves as 64-row x 64-column
// boxes (8 KB, 128-byte swizzled) through one ring of WIDE_SLOTS slots,
// each slot with a full and an empty mbarrier, and each box has one
// reader.  A score product S = Q Kᵀ or dP = dO Vᵀ contracts over D: the
// consumers split D's boxes (c, c + 2, ...), and each adds the other's
// partial through shared memory (wide_exchange), so the tile's scores are
// formed once and both hold the same bits.  A consumer releases a unit's
// slots once its next unit's products are issued.
constexpr int WIDE_ROWS = 64;               // rows of a block's tile and of the other side's
constexpr uint32_t WIDE_BOX = 64 * 64 * 2;  // a TMA box: 64 rows x 64 bf16
constexpr int WIDE_SLOTS = 16;
constexpr int WIDE_DQ_PASS = 8;  // dQ's output boxes a block, 4 a consumer
constexpr int WIDE_KV_PASS = 4;  // dK's and dV's output boxes a block, 2 a consumer
constexpr uint32_t WIDE_X = 2 * 64 * 64 * 4;  // the consumers' partial scores
// the ring, the partial scores, full[] and empty[]; 1,024 for aligning
constexpr size_t WIDE_BYTES =
    1024 + WIDE_SLOTS * WIDE_BOX + WIDE_X + 8 * 2 * WIDE_SLOTS;

struct WideRing {
  uint32_t ring, bars;
  float* xs;
  __device__ __forceinline__ uint32_t slot(int it) const {
    return ring + (it % WIDE_SLOTS) * WIDE_BOX;
  }
  __device__ __forceinline__ uint32_t full(int it) const {
    return bars + 8 * (it % WIDE_SLOTS);
  }
  __device__ __forceinline__ uint32_t empty(int it) const {
    return bars + 8 * (WIDE_SLOTS + it % WIDE_SLOTS);
  }
  __device__ __forceinline__ uint32_t phase(int it) const {
    return (it / WIDE_SLOTS) & 1;
  }
};

// the ring's layout, its mbarriers initialised by thread 0
__device__ __forceinline__ WideRing wide_ring(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  WideRing r;
  r.ring = base;
  const uint32_t xo = base + WIDE_SLOTS * WIDE_BOX;
  r.xs = reinterpret_cast<float*>(smem_raw + (xo - raw));
  r.bars = xo + WIDE_X;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIDE_SLOTS; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// the slots of ring items a .. a + n - 1 (a < 0: none), by the
// consumer's thread 0, with no branch the compiler sees
__device__ __forceinline__ void wide_release(const WideRing& R, int a, int n,
                                             int tid) {
  for (int i = 0; i < n; ++i)
    mbar_arrive_if(R.empty(a + i), tid == 0 && a >= 0);
}

// acc = Σ over this consumer's boxes nb = C, C + 2, ... < nkb of A_nb
// B_nbᵀ, 64 x 64 in float32: A_nb and B_nb the ring items a0 + 2 nb and
// a0 + 2 nb + 1, both K-major
template <int C>
__device__ __forceinline__ void wide_partial(float (&acc)[32],
                                             const WideRing& R, int a0,
                                             int nkb, int tid) {
  int held = -1;
  wgmma_fence();
  for (int nb = C; nb < nkb; nb += 2) {
    const int ai = a0 + 2 * nb;
    mbar_wait_spin(R.full(ai), R.phase(ai));
    mbar_wait_spin(R.full(ai + 1), R.phase(ai + 1));
    const uint32_t aa = R.slot(ai), ba = R.slot(ai + 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64>(acc, gmma_desc(aa + kk * 32, 16, 1024),
                   gmma_desc(ba + kk * 32, 16, 1024), nb > C || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    wide_release(R, held, 2, tid);
    held = ai;
  }
  wgmma_wait<0>();
  reg_fence(acc);
  wide_release(R, held, 2, tid);
}

// acc += the other consumer's partial of the same elements (thread tid of
// both holds the same ones): S_0 + S_1 in one, S_1 + S_0 in the other, the
// same bits.  The first barrier holds the write until the other consumer
// has read the last exchange's
template <int C>
__device__ __forceinline__ void wide_exchange(float (&acc)[32], float* xs,
                                              int tid) {
  float* mine = xs + C * 64 * 64;
  const float* other = xs + (1 - C) * 64 * 64;
  named_bar_sync(1, 256);
#pragma unroll
  for (int e = 0; e < 32; ++e) mine[e * 128 + tid] = acc[e];
  named_bar_sync(2, 256);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] += other[e * 128 + tid];
}

// dQ: a block per (b, h, column pass, 64-row query tile) over the visible
// 64-key tiles.  A key tile's ring items: (Q, K) box pairs over D for S,
// (dO, V) pairs for dP, then K's boxes of the pass, each read MN-major by
// dQ += dS K into the consumer's boxes 2 jb + c.
__global__ void __launch_bounds__(384, 1)
    bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  const WideRing R = wide_ring(smem_raw);
  const int nkb = (p.D + 63) / 64;
  const int passes = (nkb + WIDE_DQ_PASS - 1) / WIDE_DQ_PASS;
  const int bh = blockIdx.x / passes;
  const int v0 = blockIdx.x % passes * WIDE_DQ_PASS;  // the pass's first box
  const int nvb = min(WIDE_DQ_PASS, nkb - v0);
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WIDE_ROWS;  // longest first
  int k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = min(p.S, q0 + WIDE_ROWS);
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / WIDE_ROWS;
  const int nt = max(0, (k_hi + WIDE_ROWS - 1) / WIDE_ROWS - t_lo);
  const int per = 4 * nkb + nvb;  // ring items of a key tile

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = 0; i < nt; ++i) {
        const int k0 = (t_lo + i) * WIDE_ROWS;
        for (int j = 0; j < per; ++j, ++it) {
          mbar_wait(R.empty(it), R.phase(it) ^ 1);
          mbar_expect_tx(R.full(it), WIDE_BOX);
          const uint32_t dst = R.slot(it), bar = R.full(it);
          if (j >= 4 * nkb) {
            tma_load(dst, &tk, bar, (v0 + j - 4 * nkb) * 64, k0, hk, b);
          } else {
            const bool dp = j >= 2 * nkb;
            const int nb = (dp ? j - 2 * nkb : j) / 2;
            if (j % 2 == 0)
              tma_load(dst, dp ? &tdo : &tq, bar, nb * 64, q0, h, b);
            else
              tma_load(dst, dp ? &tv : &tk, bar, nb * 64, k0, hk, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    auto consume = [&](auto cc) {
      constexpr int c = decltype(cc)::value;
      const int tid = threadIdx.x - 128 * (c + 1);
      const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
      const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
      const float sl = p.scale * LOG2E;
      // the rows' lse in log2 units (+inf past S: P = 0) and Δ
      const long long bhl = (long long)b * p.H + h;
      const float ls0 = row0 < p.S ? p.lse[bhl * p.S + row0] * LOG2E : INFINITY;
      const float ls1 = row1 < p.S ? p.lse[bhl * p.S + row1] * LOG2E : INFINITY;
      const float dl0 = row0 < p.S ? p.delta[bhl * p.S + row0] : 0.0f;
      const float dl1 = row1 < p.S ? p.delta[bhl * p.S + row1] : 0.0f;
      float dq[WIDE_DQ_PASS / 2][32];
#pragma unroll
      for (int jb = 0; jb < WIDE_DQ_PASS / 2; ++jb)
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[jb][e] = 0.0f;

      for (int i = 0; i < nt; ++i) {
        const int k0 = (t_lo + i) * WIDE_ROWS;
        const int base = i * per;  // the tile's first ring item
        const bool inside = k0 + WIDE_ROWS <= p.S &&
                            (!p.causal || k0 + WIDE_ROWS - 1 <= q0) &&
                            (!p.has_window || k0 > q0 + WIDE_ROWS - 1 - p.window);
        // S, then P = exp(scale·S − lse) in place, masked unless inside
        float sc[32];
        wide_partial<c>(sc, R, base, nkb, tid);
        wide_exchange<c>(sc, R.xs, tid);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            float pr = exp2f(sc[4 * j + e] * sl - (hi ? ls1 : ls0));
            if (!inside &&
                !seen(p, hi ? row1 : row0, k0 + 8 * j + 2 * tig + (e & 1)))
              pr = 0.0f;
            sc[4 * j + e] = pr;
          }
        // dP; dS = P ∘ (dP − Δ) as bf16 A fragments
        float dp[32];
        wide_partial<c>(dp, R, base + 2 * nkb, nkb, tid);
        wide_exchange<c>(dp, R.xs, tid);
        uint32_t da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = sc[4 * j + e] * (dp[4 * j + e] - (e >= 2 ? dl1 : dl0));
          da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
          da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dQ += dS K over this consumer's boxes of the pass, K MN-major
        int held = -1;
        wgmma_fence();
#pragma unroll
        for (int jb = 0; jb < WIDE_DQ_PASS / 2; ++jb) {
          const int j = 2 * jb + c;
          if (j < nvb) {
            const int ki = base + 4 * nkb + j;
            mbar_wait_spin(R.full(ki), R.phase(ki));
            const uint32_t ka = R.slot(ki);
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
              wgmma_rs<64>(dq[jb], da[kc],
                           gmma_desc(ka + kc * 16 * 128, WIDE_BOX, 1024));
            wgmma_commit();
            wgmma_wait<1>();
            wide_release(R, held, 1, tid);
            held = ki;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int jb = 0; jb < WIDE_DQ_PASS / 2; ++jb) reg_fence(dq[jb]);
        wide_release(R, held, 1, tid);
      }

      __nv_bfloat16* dqg =
          p.dq + (long long)b * p.sdq[0] + (long long)h * p.sdq[1];
#pragma unroll
      for (int jb = 0; jb < WIDE_DQ_PASS / 2; ++jb) {
        const int j = 2 * jb + c;
        if (j < nvb)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int d = (v0 + j) * 64 + 8 * n + 2 * tig;
            if (d < p.D) {
              if (row0 < p.S)
                store_bf16x2(dqg + (long long)row0 * p.sdq[2] + d,
                             p.scale * dq[jb][4 * n], p.scale * dq[jb][4 * n + 1]);
              if (row1 < p.S)
                store_bf16x2(dqg + (long long)row1 * p.sdq[2] + d,
                             p.scale * dq[jb][4 * n + 2],
                             p.scale * dq[jb][4 * n + 3]);
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

// dK / dV: a block per (b, query head h, column pass, 64-key tile) over the
// visible 64-row query tiles.  A query tile's ring items: (K, Q) box pairs
// over D for Sᵀ = K Qᵀ, (V, dO) pairs for dPᵀ = V dOᵀ, then (dO, Q) pairs of
// the pass's boxes for dV += Pᵀ dO and dK += dSᵀ Q (read MN-major) into the
// consumer's boxes 2 jb + c.  dK and dV of 64 x D in float32 do not fit two
// warpgroups' registers above D = 256: a pass holds WIDE_KV_PASS boxes of
// each (128 registers a thread), and a wider head takes ceil(D / 256)
// passes, each forming Sᵀ and dPᵀ again.
__global__ void __launch_bounds__(384, 1)
    bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  const WideRing R = wide_ring(smem_raw);
  const int nkb = (p.D + 63) / 64;
  const int passes = (nkb + WIDE_KV_PASS - 1) / WIDE_KV_PASS;
  const int bh = blockIdx.x / passes;
  const int v0 = blockIdx.x % passes * WIDE_KV_PASS;
  const int nvb = min(WIDE_KV_PASS, nkb - v0);
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int j0 = blockIdx.y * WIDE_ROWS;  // causal: the longest key tiles first
  const int j_last = min(j0 + WIDE_ROWS, p.S) - 1;
  const int i_lo = p.causal ? j0 : 0;
  const int i_hi = p.has_window ? min(p.S, j_last + p.window) : p.S;
  const int t_lo = i_lo / WIDE_ROWS;
  const int nt = max(0, (i_hi + WIDE_ROWS - 1) / WIDE_ROWS - t_lo);
  const int per = 4 * nkb + 2 * nvb;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = 0; i < nt; ++i) {
        const int i0 = (t_lo + i) * WIDE_ROWS;
        for (int j = 0; j < per; ++j, ++it) {
          mbar_wait(R.empty(it), R.phase(it) ^ 1);
          mbar_expect_tx(R.full(it), WIDE_BOX);
          const uint32_t dst = R.slot(it), bar = R.full(it);
          if (j >= 4 * nkb) {
            const int col = (v0 + (j - 4 * nkb) / 2) * 64;
            tma_load(dst, j % 2 == 0 ? &tdo : &tq, bar, col, i0, h, b);
          } else {
            const bool dp = j >= 2 * nkb;
            const int nb = (dp ? j - 2 * nkb : j) / 2;
            if (j % 2 == 0)
              tma_load(dst, dp ? &tv : &tk, bar, nb * 64, j0, hk, b);
            else
              tma_load(dst, dp ? &tdo : &tq, bar, nb * 64, i0, h, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    auto consume = [&](auto cc) {
      constexpr int c = decltype(cc)::value;
      const int tid = threadIdx.x - 128 * (c + 1);
      const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
      const int key0 = j0 + 16 * warp + g, key1 = key0 + 8;
      const float sl = p.scale * LOG2E;
      const long long bhl = (long long)b * p.H + h;
      const float* lse = p.lse + bhl * p.S;
      const float* delta = p.delta + bhl * p.S;
      float dk[WIDE_KV_PASS / 2][32], dv[WIDE_KV_PASS / 2][32];
#pragma unroll
      for (int jb = 0; jb < WIDE_KV_PASS / 2; ++jb)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[jb][e] = dv[jb][e] = 0.0f;

      for (int i = 0; i < nt; ++i) {
        const int i0 = (t_lo + i) * WIDE_ROWS;
        const int base = i * per;
        const bool inside = j0 + WIDE_ROWS <= p.S &&
                            (!p.causal || j0 + WIDE_ROWS - 1 <= i0) &&
                            (!p.has_window || j0 > i0 + WIDE_ROWS - 1 - p.window);
        // Sᵀ (rows: keys, columns: queries), then Pᵀ in place
        float st[32];
        wide_partial<c>(st, R, base, nkb, tid);
        wide_exchange<c>(st, R.xs, tid);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {
            const int col = i0 + 8 * j + 2 * tig + odd;
            const float ls = col < p.S ? lse[col] * LOG2E : INFINITY;
#pragma unroll
            for (int e = odd; e < 4; e += 2) {
              float x = exp2f(st[4 * j + e] * sl - ls);
              if (!inside && !seen(p, col, e < 2 ? key0 : key1)) x = 0.0f;
              st[4 * j + e] = x;
            }
          }
        // dPᵀ; Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Δ) as bf16 A fragments
        float dpt[32];
        wide_partial<c>(dpt, R, base + 2 * nkb, nkb, tid);
        wide_exchange<c>(dpt, R.xs, tid);
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = i0 + 8 * j + 2 * tig;
          const float dl0 = col < p.S ? delta[col] : 0.0f;
          const float dl1 = col + 1 < p.S ? delta[col + 1] : 0.0f;
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl1 : dl0));
          pa[j / 2][(j % 2) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
          da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
          da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dV += Pᵀ dO and dK += dSᵀ Q over this consumer's boxes, dO and Q
        // MN-major
        int held = -1;
        wgmma_fence();
#pragma unroll
        for (int jb = 0; jb < WIDE_KV_PASS / 2; ++jb) {
          const int j = 2 * jb + c;
          if (j < nvb) {
            const int oi = base + 4 * nkb + 2 * j;
            mbar_wait_spin(R.full(oi), R.phase(oi));
            mbar_wait_spin(R.full(oi + 1), R.phase(oi + 1));
            const uint32_t oa = R.slot(oi), qa = R.slot(oi + 1);
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
              wgmma_rs<64>(dv[jb], pa[kc],
                           gmma_desc(oa + kc * 16 * 128, WIDE_BOX, 1024));
#pragma unroll
            for (int kc = 0; kc < 4; ++kc)
              wgmma_rs<64>(dk[jb], da[kc],
                           gmma_desc(qa + kc * 16 * 128, WIDE_BOX, 1024));
            wgmma_commit();
            wgmma_wait<1>();
            wide_release(R, held, 2, tid);
            held = oi;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int jb = 0; jb < WIDE_KV_PASS / 2; ++jb) {
          reg_fence(dv[jb]);
          reg_fence(dk[jb]);
        }
        wide_release(R, held, 2, tid);
      }

#pragma unroll
      for (int jb = 0; jb < WIDE_KV_PASS / 2; ++jb) {
        const int j = 2 * jb + c;
        if (j >= nvb) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = (v0 + j) * 64 + 8 * n + 2 * tig;
          if (d >= p.D) continue;
          const float k4[4] = {dk[jb][4 * n], dk[jb][4 * n + 1],
                               dk[jb][4 * n + 2], dk[jb][4 * n + 3]};
          const float v4[4] = {dv[jb][4 * n], dv[jb][4 * n + 1],
                               dv[jb][4 * n + 2], dv[jb][4 * n + 3]};
          if (p.part == nullptr) {
            // G = 1: the head's gradients are its KV head's
            __nv_bfloat16* dkg =
                p.dk + (long long)b * p.sdk[0] + (long long)hk * p.sdk[1] + d;
            __nv_bfloat16* dvg =
                p.dv + (long long)b * p.sdv[0] + (long long)hk * p.sdv[1] + d;
            if (key0 < p.S) {
              store_bf16x2(dkg + (long long)key0 * p.sdk[2], p.scale * k4[0],
                           p.scale * k4[1]);
              store_bf16x2(dvg + (long long)key0 * p.sdv[2], v4[0], v4[1]);
            }
            if (key1 < p.S) {
              store_bf16x2(dkg + (long long)key1 * p.sdk[2], p.scale * k4[2],
                           p.scale * k4[3]);
              store_bf16x2(dvg + (long long)key1 * p.sdv[2], v4[2], v4[3]);
            }
          } else {
            // G > 1: this head's float32 partials, dK already scaled
            float* pk = p.part + bhl * p.S * p.D + d;
            float* pv = pk + (long long)p.B * p.H * p.S * p.D;
            if (key0 < p.S) {
              *reinterpret_cast<float2*>(pk + (long long)key0 * p.D) =
                  make_float2(p.scale * k4[0], p.scale * k4[1]);
              *reinterpret_cast<float2*>(pv + (long long)key0 * p.D) =
                  make_float2(v4[0], v4[1]);
            }
            if (key1 < p.S) {
              *reinterpret_cast<float2*>(pk + (long long)key1 * p.D) =
                  make_float2(p.scale * k4[2], p.scale * k4[3]);
              *reinterpret_cast<float2*>(pv + (long long)key1 * p.D) =
                  make_float2(v4[2], v4[3]);
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

// "wide" in bf16: Δ, dQ, dK / dV (column passes of each) and, for G > 1,
// the group sum; every box 64 rows x 64 columns
int launch_wide(const WgParams& p, int Hkv, cudaStream_t st) {
  int err = launch_delta(p, st);
  if (err != 0) return err;
  CUtensorMap tq, tdo, tk, tv;
  err = tensor_map(&tq, p.q, p.D, p.S, p.H, p.B, p.sq, WIDE_ROWS);
  if (err == 0) err = tensor_map(&tdo, p.dout, p.D, p.S, p.H, p.B, p.sdo, WIDE_ROWS);
  if (err == 0) err = tensor_map(&tk, p.k, p.D, p.S, Hkv, p.B, p.sk, WIDE_ROWS);
  if (err == 0) err = tensor_map(&tv, p.v, p.D, p.S, Hkv, p.B, p.sv, WIDE_ROWS);
  if (err != 0) return err;
  const int nkb = (p.D + 63) / 64;
  const int tiles = (p.S + WIDE_ROWS - 1) / WIDE_ROWS;
  err = launch(bwd_dq_wide_kernel, WIDE_BYTES,
               dim3(p.B * p.H * ((nkb + WIDE_DQ_PASS - 1) / WIDE_DQ_PASS), tiles),
               384, st, tq, tdo, tk, tv, p);
  if (err != 0) return err;
  err = launch(bwd_dkdv_wide_kernel, WIDE_BYTES,
               dim3(p.B * p.H * ((nkb + WIDE_KV_PASS - 1) / WIDE_KV_PASS), tiles),
               384, st, tq, tdo, tk, tv, p);
  if (err != 0 || p.group == 1) return err;
  return launch_reduce(p, Hkv, st);
}

bool aligned4(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && st[0] % 2 == 0 &&
         st[1] % 2 == 0 && st[2] % 2 == 0;
}


// ---------------------------------------------------------------------------
// 3. float32 on the tensor cores in 3xTF32 ("f32", "f32 wide")
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

constexpr int F32_WIDE_COLS = 512;  // output columns of a "f32 wide" block

constexpr int cmaxi(int a, int b) { return a > b ? a : b; }

// A kernel's tiles.  A block owns R row groups of 16 rows (BM = 16 R: query
// rows in dQ, key rows in dK / dV) and streams BN-row tiles of the other
// side.  Each row group has W warps: warp j contracts the score products
// over columns [j KW, (j + 1) KW) of each staged chunk of DT columns and
// owns output columns [j DC / W, (j + 1) DC / W) of the block's DC; with
// W > 1 the warps' partial scores meet in shared memory and each adds them
// in warp order, so all hold the same bits.  Tiled (D <= DT <= 256): the
// block's own rows are staged once, the streamed tiles through ST stages,
// DC = DT.  Wide: each tile pair stages D in chunks of DT columns in turn,
// then the pass's DC = 512 columns of the output product's operand.  Rows
// of DT + 4 (DC + 4) floats: a pitch of 4 modulo 32 banks, so the fragment
// reads below are conflict-free in either orientation.
template <int DT_, int W_, int R_, int BN_, int ST_, bool WIDE_>
struct F32Tile {
  static constexpr int DT = DT_, W = W_, R = R_, BN = BN_, ST = ST_;
  static constexpr bool WIDE = WIDE_;
  static constexpr int BM = 16 * R, NT = 32 * W * R;
  static constexpr int DC = WIDE ? F32_WIDE_COLS : DT;
  static constexpr int LD = DT + 4, LC = DC + 4;
  static constexpr int NB = BN / 8;       // the scores' n-tiles
  static constexpr int NC = DC / W / 8;   // a warp's output n-tiles
  static constexpr int KW = DT / W;       // a warp's columns of a chunk
  static constexpr int XF = W > 1 ? 2 * NB * 4 * 32 : 0;  // a warp's partials
  // the block's rows and the streamed tiles (tiled), or a chunk of both and
  // the pass's operand columns (wide, over the same floats); then the
  // streamed rows' lse and Δ (dK / dV) and the partial scores
  static constexpr int MAIN_DQ =
      WIDE ? cmaxi(2 * (BM + BN) * LD, BN * LC) : 2 * (BM + ST * BN) * LD;
  static constexpr int MAIN_KV =
      WIDE ? cmaxi(2 * (BM + BN) * LD, 2 * BN * LC) : 2 * (BM + ST * BN) * LD;
  static constexpr int STATS = (WIDE ? 1 : ST) * 2 * BN;
  static constexpr size_t dq_bytes() {
    return sizeof(float) * (MAIN_DQ + W * R * XF);
  }
  static constexpr size_t kv_bytes() {
    return sizeof(float) * (MAIN_KV + STATS + W * R * XF);
  }
};

// rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of one head into
// rows of LDS floats by cp.async; zeros past S and D (D a multiple of 4)
template <int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long rs, int r0, int c0,
                                          int S, int D) {
  constexpr int CH = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = 4 * (i % CH);
    const bool ok = r0 + r < S && c0 + c < D;
    cp_async16(dst + r * LDS + c,
               ok ? src + (long long)(r0 + r) * rs + c0 + c : src, ok);
  }
}

// the two score products, s[n] += A1 B1ᵀ and dp[n] += A2 B2ᵀ (16 x 8
// each), over columns [k0, k1) (multiples of 8, k1 - k0 <= KW), formed in
// one loop: A1, A2 the warp's 16 rows at a1, a2 (pitch LA), B1, B2 the 8 NB
// rows at b1, b2 (pitch LB); unrolled over KW / 8 steps, the ones past k1
// skipped
template <int NB, int LA, int LB, int KW>
__device__ __forceinline__ void score_mma(float (&s)[NB][4],
                                          float (&dp)[NB][4],
                                          const float* a1, const float* b1,
                                          const float* a2, const float* b2,
                                          int k0, int k1, int gid, int tig) {
#pragma unroll
  for (int kk = 0; kk < KW; kk += 8) {
    const int k = k0 + kk;
    if (k < k1) {
      const float* ar1 = a1 + gid * LA + k + tig;
      const float* ar2 = a2 + gid * LA + k + tig;
      const TfA fa1(ar1[0], ar1[8 * LA], ar1[4], ar1[8 * LA + 4]);
      const TfA fa2(ar2[0], ar2[8 * LA], ar2[4], ar2[8 * LA + 4]);
      TfB fb1[NB], fb2[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float* br1 = b1 + (8 * n + gid) * LB + k + tig;
        const float* br2 = b2 + (8 * n + gid) * LB + k + tig;
        fb1[n] = TfB(br1[0], br1[4]);
        fb2[n] = TfB(br2[0], br2[4]);
      }
      mma3_rows<NB>(s, fa1, fb1);
      mma3_rows<NB>(dp, fa2, fb2);
    }
  }
}

// out[c] (16 x 8) += P B: P the 16 x 8 NK product in accumulators (an
// accumulator is an A fragment with its k slots permuted: tf32.cuh), B the
// 8 NK rows at b (pitch LB) over the warp's 8 NC columns from b
template <int NK, int NC, int LB>
__device__ __forceinline__ void out_mma(float (&out)[NC][4],
                                        const float (&pm)[NK][4],
                                        const float* b, int gid, int tig) {
  constexpr int G = NC % 4 == 0 ? 4 : NC;  // columns interleaved at a time
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const TfA fa(pm[kk][0], pm[kk][2], pm[kk][1], pm[kk][3]);
    const float* br = b + (8 * kk + 2 * tig) * LB + gid;
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += G) {
      TfB fb[G];
#pragma unroll
      for (int c = 0; c < G; ++c)
        fb[c] = TfB(br[8 * (c0 + c)], br[LB + 8 * (c0 + c)]);
      mma3_rows<G>(out + c0, fa, fb);
    }
  }
}

// W > 1: the row group's W warps' partial scores summed in warp order, the
// same bits in each warp; x is the block's partials region
template <class C>
__device__ __forceinline__ void exchange(float (&s)[C::NB][4],
                                         float (&dp)[C::NB][4], float* x,
                                         int warp, int rg, int lane) {
  if constexpr (C::W > 1) {
    constexpr int NB = C::NB;
    float* mine = x + warp * C::XF + lane;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32] = s[n][e];
        mine[((NB + n) * 4 + e) * 32] = dp[n][e];
      }
    __syncthreads();
    const float* grp = x + rg * C::W * C::XF + lane;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = grp[(n * 4 + e) * 32], d = grp[((NB + n) * 4 + e) * 32];
#pragma unroll
        for (int j = 1; j < C::W; ++j) {
          a += grp[j * C::XF + (n * 4 + e) * 32];
          d += grp[j * C::XF + ((NB + n) * 4 + e) * 32];
        }
        s[n][e] = a;
        dp[n][e] = d;
      }
  }
}

__device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

// Δ = rowsum(dO ∘ O) for the float32 kernels, formed the way each forms its
// dP: as the dQ kernel's dP = dO Vᵀ (A = dO rows, B = O rows) and as the
// dK / dV kernel's dPᵀ = V dOᵀ (A = O rows, B = dO rows), each row's Δ the
// diagonal element of its warp's 16 x 16 product, from the same 3xTF32
// chains over the same column shares -- warp j of a row group of the
// consumer's tiles C over columns [j KW, (j + 1) KW) of each DT-column
// chunk, ascending, the W partials then summed in warp order -- so dP − Δ
// is exactly 0 where a key's V equals the row's O, as on a row that sees
// one key, whose gradient through dS is 0; a float32 rowsum beside
// tensor-core dP would leave the two roundings' difference there.  Two
// (B, H, S) planes, the dQ kernel's Δ then the dK / dV kernel's.  A block
// of 4 warps takes 64 rows of a head, O and dO staged 64 columns at a time
// by cp.async; each 8-column step goes to the partial of the share that
// holds it.
constexpr int DELTA_ROWS = 64, DELTA_COLS = 64, DELTA_LD = DELTA_COLS + 4;

template <class C, int NP>
__device__ __forceinline__ void delta_step(float (&part)[NP][2][4], int k,
                                           const TfA& a, const TfB (&b)[2]) {
  const int j = (k % C::DT) / C::KW;
#pragma unroll
  for (int jj = 0; jj < NP; ++jj)
    if (jj == j) mma3_rows<2>(part[jj], a, b);
}

template <class Q, class K>
__device__ __forceinline__ void delta_f32(const F32Params& p) {
  __shared__ float4 so4[DELTA_ROWS * DELTA_LD / 4];
  __shared__ float4 sd4[DELTA_ROWS * DELTA_LD / 4];
  float* const so = reinterpret_cast<float*>(so4);
  float* const sd = reinterpret_cast<float*>(sd4);
  constexpr int LD = DELTA_LD, NT = 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int row0 = blockIdx.y * DELTA_ROWS, r0 = row0 + 16 * warp;
  const float* og = p.o + b * p.so[0] + h * p.so[1];
  const float* dog = p.dout + b * p.sdo[0] + h * p.sdo[1];
  float pq[Q::W][2][4] = {}, pk[K::W][2][4] = {};
  const int kend = round8(p.D);
  for (int c0 = 0; c0 < p.D; c0 += DELTA_COLS) {
    __syncthreads();  // the last chunk read by every warp
    stage_f32<DELTA_ROWS, DELTA_COLS, LD, NT>(so, og, p.so[2], row0, c0, p.S,
                                              p.D);
    stage_f32<DELTA_ROWS, DELTA_COLS, LD, NT>(sd, dog, p.sdo[2], row0, c0,
                                              p.S, p.D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float* o = so + 16 * warp * LD;
    const float* d = sd + 16 * warp * LD;
#pragma unroll 2
    for (int kk = 0; kk < DELTA_COLS && c0 + kk < kend; kk += 8) {
      const float* ar = d + gid * LD + kk + tig;
      const float* br = o + gid * LD + kk + tig;
      const TfA a_do(ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]);
      const TfA a_o(br[0], br[8 * LD], br[4], br[8 * LD + 4]);
      const TfB b_o[2] = {TfB(br[0], br[4]), TfB(br[8 * LD], br[8 * LD + 4])};
      const TfB b_do[2] = {TfB(ar[0], ar[4]), TfB(ar[8 * LD], ar[8 * LD + 4])};
      delta_step<Q>(pq, c0 + kk, a_do, b_o);
      delta_step<K>(pk, c0 + kk, a_o, b_do);
    }
  }
#pragma unroll
  for (int j = 1; j < Q::W; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pq[0][t][e] += pq[j][t][e];
#pragma unroll
  for (int j = 1; j < K::W; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[0][t][e] += pk[j][t][e];
  // row gid's diagonal element is in lane (gid, gid / 2), e = gid % 2;
  // row gid + 8's in the second n-tile, e = 2 + gid % 2
  if (tig != (gid >> 1)) return;
  const long long plane = (long long)p.B * p.H * p.S;
  float* out = p.delta + (long long)bh * p.S + r0 + gid;
  const int e = gid & 1;
  if (r0 + gid < p.S) {
    out[0] = pq[0][0][e];
    out[plane] = pk[0][0][e];
  }
  if (r0 + gid + 8 < p.S) {
    out[8] = pq[0][1][2 + e];
    out[plane + 8] = pk[0][1][2 + e];
  }
}

// dQ: a block per (b, query head, [column pass,] BM-row query tile), the
// visible key tiles in ascending order, the longest query tiles first
template <class C>
__device__ __forceinline__ void dq_f32(const F32Params& p) {
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NB = C::NB, NC = C::NC,
                DT = C::DT, NT = C::NT;
  constexpr int LB = C::WIDE ? C::LC : LD;  // pitch of the output's operand
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const sQ = sm;
  float* const sdO = sm + BM * LD;
  float* const sKV = sm + 2 * BM * LD;  // [stage][K, V][BN][LD]
  float* const sX = sm + C::MAIN_DQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / C::W, wj = warp % C::W;
  const int passes = C::WIDE ? (p.D + C::DC - 1) / C::DC : 1;
  const int bh = blockIdx.x / passes;
  const int d0 = (blockIdx.x % passes) * C::DC;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const float* qg = p.q + b * p.sq[0] + h * p.sq[1];
  const float* dog = p.dout + b * p.sdo[0] + h * p.sdo[1];
  const float* kg = p.k + b * p.sk[0] + hk * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + hk * p.sv[1];

  // the thread's rows: their lse and Δ
  const int ra = q0 + 16 * rg + gid, rb = ra + 8;
  const long long lrow = (long long)bh * p.S;
  const float lse_a = ra < p.S ? p.lse[lrow + ra] : INFINITY;
  const float lse_b = rb < p.S ? p.lse[lrow + rb] : INFINITY;
  const float dl_a = ra < p.S ? p.delta[lrow + ra] : 0.0f;
  const float dl_b = rb < p.S ? p.delta[lrow + rb] : 0.0f;

  int k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = min(p.S, q0 + BM);
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BN;
  const int t_hi = k_hi > k_lo ? (k_hi + BN - 1) / BN : t_lo;

  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  auto stage_kv = [&](float* dst, int k0, int c0) {
    stage_f32<BN, DT, LD, NT>(dst, kg, p.sk[2], k0, c0, p.S, p.D);
    stage_f32<BN, DT, LD, NT>(dst + BN * LD, vg, p.sv[2], k0, c0, p.S, p.D);
  };
  if constexpr (!C::WIDE) {
    stage_f32<BM, DT, LD, NT>(sQ, qg, p.sq[2], q0, 0, p.S, p.D);
    stage_f32<BM, DT, LD, NT>(sdO, dog, p.sdo[2], q0, 0, p.S, p.D);
    if (t_lo < t_hi) stage_kv(sKV, t_lo * BN, 0);
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    const float* tk;  // the tile the output product reads
    if constexpr (!C::WIDE) {
      float* cur = sKV + ((t - t_lo) % C::ST) * 2 * BN * LD;
      if constexpr (C::ST == 2) {
        cp_async_wait_all();
        __syncthreads();  // tile t landed; tile t - 1 read by every warp
        if (t + 1 < t_hi)
          stage_kv(sKV + ((t + 1 - t_lo) % 2) * 2 * BN * LD, k0 + BN, 0);
        cp_async_commit();
      } else {
        if (t > t_lo) {
          __syncthreads();
          stage_kv(cur, k0, 0);
          cp_async_commit();
        }
        cp_async_wait_all();
        __syncthreads();
      }
      const int kb = wj * C::KW, ke = min(kb + C::KW, round8(p.D));
      score_mma<NB, LD, LD, C::KW>(s, dp, sQ + 16 * rg * LD, cur,
                                   sdO + 16 * rg * LD, cur + BN * LD, kb, ke,
                                   gid, tig);
      tk = cur;
    } else {
      for (int c0 = 0; c0 < p.D; c0 += DT) {
        __syncthreads();  // the last chunk (or tile) read by every warp
        stage_f32<BM, DT, LD, NT>(sQ, qg, p.sq[2], q0, c0, p.S, p.D);
        stage_f32<BM, DT, LD, NT>(sdO, dog, p.sdo[2], q0, c0, p.S, p.D);
        stage_kv(sKV, k0, c0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        const int kb = wj * C::KW, ke = min(kb + C::KW, round8(p.D - c0));
        score_mma<NB, LD, LD, C::KW>(s, dp, sQ + 16 * rg * LD, sKV,
                                     sdO + 16 * rg * LD, sKV + BN * LD, kb,
                                     ke, gid, tig);
      }
      __syncthreads();  // every chunk read: the pass's K columns go there
      stage_f32<BN, C::DC, C::LC, NT>(sm, kg, p.sk[2], k0, d0, p.S, p.D);
      cp_async_commit();
      tk = sm;
    }
    exchange<C>(s, dp, sX, warp, rg, lane);
    if constexpr (C::WIDE) {
      cp_async_wait_all();
      __syncthreads();
    }

    // P from the forward's lse, dS = P ∘ (dP − Δ), in place of s; a tile
    // every row of the block sees whole skips the mask (rows past S have
    // lse = +inf, so P = 0 there)
    const bool inside = k0 + BN <= p.S &&
                        (!p.causal || k0 + BN - 1 <= q0) &&
                        (!p.has_window || k0 > q0 + BM - 1 - p.window);
    auto weights = [&](auto all) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int key = k0 + 8 * n + 2 * tig + (e & 1);
          const float pr =
              decltype(all)::value || (row < p.S && seen(p, row, key))
                  ? expf(p.scale * s[n][e] - (e < 2 ? lse_a : lse_b))
                  : 0.0f;
          s[n][e] = pr * (dp[n][e] - (e < 2 ? dl_a : dl_b));
        }
    };
    if (inside)
      weights(std::true_type{});
    else
      weights(std::false_type{});
    out_mma<NB, NC, LB>(acc, s, tk + wj * (C::DC / C::W), gid, tig);
  }
  cp_async_wait_all();

  float* dqg = p.dq + b * p.sdq[0] + h * p.sdq[1];
  const int c0 = d0 + wj * (C::DC / C::W) + 2 * tig;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + 8 * c;
    if (col >= p.D) continue;
    if (ra < p.S)
      *reinterpret_cast<float2*>(dqg + (long long)ra * p.sdq[2] + col) =
          make_float2(p.scale * acc[c][0], p.scale * acc[c][1]);
    if (rb < p.S)
      *reinterpret_cast<float2*>(dqg + (long long)rb * p.sdq[2] + col) =
          make_float2(p.scale * acc[c][2], p.scale * acc[c][3]);
  }
}

// dK, dV: a block per (b, query head, [column pass,] BM-row key tile), its
// K and V rows held (tiled) and the visible query tiles streamed in
// ascending order with their rows' lse and Δ; the transposed products
// Sᵀ = K Qᵀ, dPᵀ = V dOᵀ put Pᵀ and dSᵀ in accumulators, the A operands of
// dV += Pᵀ dO and dK += dSᵀ Q.  With G = 1 it writes dk, dv; with G > 1 its
// head's partial dK (scaled), dV into the (2, B, H, S, D) scratch.
template <class C>
__device__ __forceinline__ void dkdv_f32(const F32Params& p) {
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, NB = C::NB, NC = C::NC,
                DT = C::DT, NT = C::NT;
  constexpr int LB = C::WIDE ? C::LC : LD;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const sK = sm;
  float* const sV = sm + BM * LD;
  float* const sQD = sm + 2 * BM * LD;  // [stage][Q, dO][BN][LD]
  float* const sStat = sm + C::MAIN_KV;  // [stage][lse, Δ][BN]
  float* const sX = sStat + C::STATS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / C::W, wj = warp % C::W;
  const int passes = C::WIDE ? (p.D + C::DC - 1) / C::DC : 1;
  const int bh = blockIdx.x / passes;
  const int d0 = (blockIdx.x % passes) * C::DC;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const int j0 = blockIdx.y * BM;  // the first key tiles see the most rows
  const float* qg = p.q + b * p.sq[0] + h * p.sq[1];
  const float* dog = p.dout + b * p.sdo[0] + h * p.sdo[1];
  const float* kg = p.k + b * p.sk[0] + hk * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + hk * p.sv[1];
  const long long lrow = (long long)bh * p.S;
  const float* delta = p.delta + (long long)p.B * p.H * p.S;  // its own Δ

  const int ka = j0 + 16 * rg + gid, kb = ka + 8;  // the thread's keys
  const int j_last = min(j0 + BM, p.S) - 1;
  int i_lo = p.causal ? j0 : 0, i_hi = p.S;
  if (p.has_window) i_hi = min(p.S, j_last + p.window);
  const int t_lo = i_lo / BN;
  const int t_hi = i_hi > i_lo ? (i_hi + BN - 1) / BN : t_lo;

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.0f;

  // the query rows' lse (+inf past S: P = 0) and Δ
  auto stage_stats = [&](float* dst, int i0) {
    for (int r = threadIdx.x; r < BN; r += NT) {
      const bool in = i0 + r < p.S;
      dst[r] = in ? p.lse[lrow + i0 + r] : INFINITY;
      dst[BN + r] = in ? delta[lrow + i0 + r] : 0.0f;
    }
  };
  auto stage_qd = [&](float* dst, int i0, int c0) {
    stage_f32<BN, DT, LD, NT>(dst, qg, p.sq[2], i0, c0, p.S, p.D);
    stage_f32<BN, DT, LD, NT>(dst + BN * LD, dog, p.sdo[2], i0, c0, p.S,
                              p.D);
  };
  if constexpr (!C::WIDE) {
    stage_f32<BM, DT, LD, NT>(sK, kg, p.sk[2], j0, 0, p.S, p.D);
    stage_f32<BM, DT, LD, NT>(sV, vg, p.sv[2], j0, 0, p.S, p.D);
    if (t_lo < t_hi) {
      stage_qd(sQD, t_lo * BN, 0);
      stage_stats(sStat, t_lo * BN);
    }
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int i0 = t * BN;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    const float* tq;  // Q's rows for dK, then dO's for dV (pitch LB)
    const float* tdo;
    const float* st;  // the rows' lse, then Δ
    if constexpr (!C::WIDE) {
      const int cur = (t - t_lo) % C::ST;
      float* qd = sQD + cur * 2 * BN * LD;
      st = sStat + cur * 2 * BN;
      if constexpr (C::ST == 2) {
        cp_async_wait_all();
        __syncthreads();
        if (t + 1 < t_hi) {
          const int nx = (t + 1 - t_lo) % 2;
          stage_qd(sQD + nx * 2 * BN * LD, i0 + BN, 0);
          stage_stats(sStat + nx * 2 * BN, i0 + BN);
        }
        cp_async_commit();
      } else {
        if (t > t_lo) {
          __syncthreads();
          stage_qd(qd, i0, 0);
          stage_stats(sStat, i0);
          cp_async_commit();
        }
        cp_async_wait_all();
        __syncthreads();
      }
      const int k0 = wj * C::KW, k1 = min(k0 + C::KW, round8(p.D));
      score_mma<NB, LD, LD, C::KW>(s, dp, sK + 16 * rg * LD, qd,
                                   sV + 16 * rg * LD, qd + BN * LD, k0, k1,
                                   gid, tig);
      tq = qd;
      tdo = qd + BN * LD;
    } else {
      for (int c0 = 0; c0 < p.D; c0 += DT) {
        __syncthreads();  // the last chunk (or tile) read by every warp
        stage_f32<BM, DT, LD, NT>(sK, kg, p.sk[2], j0, c0, p.S, p.D);
        stage_f32<BM, DT, LD, NT>(sV, vg, p.sv[2], j0, c0, p.S, p.D);
        stage_qd(sQD, i0, c0);
        cp_async_commit();
        if (c0 == 0) stage_stats(sStat, i0);
        cp_async_wait_all();
        __syncthreads();
        const int k0 = wj * C::KW, k1 = min(k0 + C::KW, round8(p.D - c0));
        score_mma<NB, LD, LD, C::KW>(s, dp, sK + 16 * rg * LD, sQD,
                                     sV + 16 * rg * LD, sQD + BN * LD, k0,
                                     k1, gid, tig);
      }
      __syncthreads();  // every chunk read: the pass's Q, dO columns go there
      stage_f32<BN, C::DC, C::LC, NT>(sm, qg, p.sq[2], i0, d0, p.S, p.D);
      stage_f32<BN, C::DC, C::LC, NT>(sm + BN * C::LC, dog, p.sdo[2], i0, d0,
                                      p.S, p.D);
      cp_async_commit();
      tq = sm;
      tdo = sm + BN * C::LC;
      st = sStat;
    }
    exchange<C>(s, dp, sX, warp, rg, lane);
    if constexpr (C::WIDE) {
      cp_async_wait_all();
      __syncthreads();
    }

    // Pᵀ from the forward's lse in s, dSᵀ = Pᵀ ∘ (dPᵀ − Δ) in dp; a tile
    // every key of the block sees whole skips the mask (query rows past S
    // have lse = +inf, so P = 0 there)
    const bool inside = j0 + BM <= p.S &&
                        (!p.causal || i0 >= j0 + BM - 1) &&
                        (!p.has_window || i0 + BN - 1 < j0 + p.window);
    auto weights = [&](auto all) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * tig + (e & 1), row = i0 + qi;
          const float pr =
              decltype(all)::value || (row < p.S && seen(p, row, e < 2 ? ka : kb))
                  ? expf(p.scale * s[n][e] - st[qi])
                  : 0.0f;
          s[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - st[BN + qi]);
        }
    };
    if (inside)
      weights(std::true_type{});
    else
      weights(std::false_type{});
    const int co = wj * (C::DC / C::W);
    out_mma<NB, NC, LB>(dv, s, tdo + co, gid, tig);
    out_mma<NB, NC, LB>(dk, dp, tq + co, gid, tig);
  }
  cp_async_wait_all();

  float *dkg, *dvg;
  long long rs_k, rs_v;
  if (p.group == 1) {
    dkg = p.dk + b * p.sdk[0] + hk * p.sdk[1];
    dvg = p.dv + b * p.sdv[0] + hk * p.sdv[1];
    rs_k = p.sdk[2];
    rs_v = p.sdv[2];
  } else {
    const long long plane = (long long)p.B * p.H * p.S * p.D;
    dkg = p.part + (long long)bh * p.S * p.D;
    dvg = dkg + plane;
    rs_k = rs_v = p.D;
  }
  const int c0 = d0 + wj * (C::DC / C::W) + 2 * tig;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + 8 * c;
    if (col >= p.D) continue;
    if (ka < p.S) {
      *reinterpret_cast<float2*>(dkg + ka * rs_k + col) =
          make_float2(p.scale * dk[c][0], p.scale * dk[c][1]);
      *reinterpret_cast<float2*>(dvg + ka * rs_v + col) =
          make_float2(dv[c][0], dv[c][1]);
    }
    if (kb < p.S) {
      *reinterpret_cast<float2*>(dkg + kb * rs_k + col) =
          make_float2(p.scale * dk[c][2], p.scale * dk[c][3]);
      *reinterpret_cast<float2*>(dvg + kb * rs_v + col) =
          make_float2(dv[c][2], dv[c][3]);
    }
  }
}

// the instantiations by head-dim tile, 512 for "f32 wide" (32 and 64 share
// a shape), and at D <= 64 by sequence length: up to F32_SHORT_S rows
// (SHORT = 1) take 32-row tiles both ways, so a short sequence's tiles
// hold mostly its own rows (the scorer's 72 fill 64-row tiles by a fifth);
// Q the dQ kernel's tiles, K the dK / dV kernel's
constexpr int F32_SHORT_S = 96;
template <int DT, int SHORT = 0>
struct F32Cfg {
  using Q = F32Tile<DT, 1, 4, 64, 2, false>;
  using K = F32Tile<DT, 1, 4, 64, 2, false>;
};
template <int DT>
struct F32Cfg<DT, 1> {
  using Q = F32Tile<DT, 1, 2, 32, 2, false>;
  using K = F32Tile<DT, 1, 2, 32, 2, false>;
};
template <>
struct F32Cfg<128> {
  using Q = F32Tile<128, 1, 8, 32, 2, false>;
  using K = F32Tile<128, 1, 8, 32, 2, false>;
};
template <>
struct F32Cfg<256> {
  using Q = F32Tile<256, 1, 4, 32, 1, false>;
  using K = F32Tile<256, 2, 2, 32, 2, false>;
};
template <>
struct F32Cfg<F32_WIDE_COLS> {
  using Q = F32Tile<256, 4, 2, 32, 1, true>;
  using K = F32Tile<128, 4, 2, 32, 1, true>;
};

// Δ's chains depend on W, DT and KW alone, which SHORT leaves as they are
template <int DT>
__global__ void __launch_bounds__(128) bwd_delta_f32_kernel(F32Params p) {
  delta_f32<typename F32Cfg<DT>::Q, typename F32Cfg<DT>::K>(p);
}
template <int DT, int SHORT>
__global__ void __launch_bounds__(F32Cfg<DT, SHORT>::Q::NT)
    bwd_dq_f32_kernel(F32Params p) {
  dq_f32<typename F32Cfg<DT, SHORT>::Q>(p);
}
template <int DT, int SHORT>
__global__ void __launch_bounds__(F32Cfg<DT, SHORT>::K::NT)
    bwd_dkdv_f32_kernel(F32Params p) {
  dkdv_f32<typename F32Cfg<DT, SHORT>::K>(p);
}
using F32Wide = F32Cfg<F32_WIDE_COLS>;
__global__ void __launch_bounds__(F32Wide::Q::NT)
    bwd_dq_f32_wide_kernel(F32Params p) {
  dq_f32<F32Wide::Q>(p);
}
__global__ void __launch_bounds__(F32Wide::K::NT)
    bwd_dkdv_f32_wide_kernel(F32Params p) {
  dkdv_f32<F32Wide::K>(p);
}

// Δ (two planes), dQ, dK / dV and, for G > 1, the group sum
template <int DT, int SHORT, typename FQ, typename FK>
int launch_f32(const F32Params& p, int Hkv, cudaStream_t st, FQ dq,
               FK dkdv) {
  using Q = typename F32Cfg<DT, SHORT>::Q;
  using K = typename F32Cfg<DT, SHORT>::K;
  const int passes = Q::WIDE ? (p.D + Q::DC - 1) / Q::DC : 1;
  if ((p.S + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
  int err = launch(bwd_delta_f32_kernel<DT>, 0,
                   dim3(p.B * p.H, (p.S + DELTA_ROWS - 1) / DELTA_ROWS), 128,
                   st, p);
  if (err != 0) return err;
  err = launch(dq, Q::dq_bytes(),
               dim3(p.B * p.H * passes, (p.S + Q::BM - 1) / Q::BM), Q::NT, st,
               p);
  if (err != 0) return err;
  err = launch(dkdv, K::kv_bytes(),
               dim3(p.B * p.H * passes, (p.S + K::BM - 1) / K::BM), K::NT, st,
               p);
  if (err != 0 || p.group == 1) return err;
  return launch_reduce(p, Hkv, st);
}

template <int DT>
int launch_f32_tiled(const F32Params& p, int Hkv, cudaStream_t st) {
  if constexpr (DT <= 64) {
    if (p.S <= F32_SHORT_S)
      return launch_f32<DT, 1>(p, Hkv, st, bwd_dq_f32_kernel<DT, 1>,
                               bwd_dkdv_f32_kernel<DT, 1>);
  }
  return launch_f32<DT, 0>(p, Hkv, st, bwd_dq_f32_kernel<DT, 0>,
                           bwd_dkdv_f32_kernel<DT, 0>);
}

bool aligned16_f32(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

// a launch's arguments from the C entry points' (strides per (b, h, s) in
// the order q, k, v, o, dO, dq, dk, dv)
template <typename T>
BwdParams<T> bwd_params(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        float* part, int B, int H, int Hkv, int S, int D,
                        const long long* strides, int causal, int has_window,
                        int window, float scale) {
  BwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.part = part;
  p.B = B;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.D = D;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  return p;
}

}  // namespace

// Variant "wgmma" (bf16): tile_d 64, 128 or 256; D (a multiple of 16,
// D <= tile_d, above tile_d / 2 past 64) as the tensors hold it; "wide"
// (bf16): tile_d 512, D > 256 a multiple of 8.  Strides per (b, head, s) in
// elements, D contiguous, in the order q, k, v, o, dO, dq, dk, dv; lse the
// forward's (B, H, S) float32; delta a float32 scratch of B·H·S; part a
// float32 scratch of 2·B·H·S·D when H > Hkv, else null.  Bases and strides
// of q, k, v, o, dO 16-byte aligned (TMA, 16-byte loads), of dq, dk, dv
// 4-byte.  Three launches on `stream` (delta, dq, dkdv), a fourth (reduce)
// when H > Hkv.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* part, int tile_d, int B, int H, int Hkv, int S, int D,
    const long long* strides, int causal, int has_window, int window,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  const bool wide = tile_d == 64 * WIDE_DQ_PASS;
  const bool tiled_bad = (tile_d != 64 && tile_d != 128 && tile_d != 256) ||
                         D % 16 != 0 || D < 16 || D > tile_d ||
                         (tile_d > 64 && D <= tile_d / 2);
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (wide ? D % 8 != 0 || D <= 256 : tiled_bad) ||
      (part == nullptr) != (H == Hkv) || (S + 63) / 64 > 65535)
    return bad;
  const WgParams p = bwd_params<__nv_bfloat16>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, H, Hkv, S, D,
      strides, causal, has_window, window, scale);
  const void* in[5] = {q, k, v, o, dout};
  const long long* st5[5] = {p.sq, p.sk, p.sv, p.so, p.sdo};
  for (int t = 0; t < 5; ++t)
    if (!aligned16(in[t], st5[t])) return bad;
  void* out[3] = {dq, dk, dv};
  const long long* st3[3] = {p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 3; ++t)
    if (!aligned4(out[t], st3[t])) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) return launch_wide(p, Hkv, st);
  if (tile_d == 64) return launch_wgmma<64>(p, Hkv, st);
  if (tile_d == 128) return launch_wgmma<128>(p, Hkv, st);
  return launch_wgmma<256>(p, Hkv, st);
}

// Float32 ("f32", tile_d 32, 64, 128 or 256 with D <= tile_d; "f32 wide",
// tile_d 512, D > 256): D a multiple of 4 as the tensors hold it, every
// base 16-byte aligned and every (b, h, s) stride a multiple of 4 elements
// (cp.async); delta a float32 scratch of 2·B·H·S (each kernel's Δ); the
// other arguments as above, in float32.  Three launches on `stream`
// (delta, dq, dkdv), a fourth (reduce) when H > Hkv.
extern "C" int flash_attention_bwd_f32_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* part, int tile_d, int B, int H, int Hkv, int S, int D,
    const long long* strides, int causal, int has_window, int window,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  const bool wide = tile_d == F32_WIDE_COLS;
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 4 ||
      D % 4 != 0 || (wide ? D <= 256 : D > tile_d) ||
      (part == nullptr) != (H == Hkv))
    return bad;
  const F32Params p = bwd_params<float>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, part, B, H, Hkv, S, D,
      strides, causal, has_window, window, scale);
  const void* all[8] = {q, k, v, o, dout, dq, dk, dv};
  const long long* sts[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk,
                             p.sdv};
  for (int t = 0; t < 8; ++t)
    if (!aligned16_f32(all[t], sts[t])) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return launch_f32<F32_WIDE_COLS, 0>(p, Hkv, st, bwd_dq_f32_wide_kernel,
                                        bwd_dkdv_f32_wide_kernel);
  switch (tile_d) {
    case 32: return launch_f32_tiled<32>(p, Hkv, st);
    case 64: return launch_f32_tiled<64>(p, Hkv, st);
    case 128: return launch_f32_tiled<128>(p, Hkv, st);
    case 256: return launch_f32_tiled<256>(p, Hkv, st);
    default: return bad;
  }
}
