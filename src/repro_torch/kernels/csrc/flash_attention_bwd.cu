// Flash attention backward: the gradients of causal / sliding-window
// grouped-query attention (flash_attention.cu's function) with respect to
// q, k and v.  For q, o, dO (B, H, S, D) and k, v (B, Hkv, S, D), query
// head h reading KV head h / G (G = H / Hkv), with the weights P of the
// forward recomputed from q and k:
//
//     Δ_i  = Σ_d dO_id · O_id                   (from the stored o)
//     dP   = dO Vᵀ,   dS = P ∘ (dP − Δ)
//     dQ   = scale · dS K
//     dK   = scale · Σ_{G heads} dSᵀ Q,   dV = Σ_{G heads} Pᵀ dO
//
// with float32 sums, the gradients written in the inputs' dtype.  The
// visible pairs are the forward's: k_pos <= q_pos (causal), k_pos > q_pos
// - window, both < S; a row with no visible key has P = 0 and gets zero
// gradients.
//
// Replaces no TPU kernel: the reference package has no backward kernel
// (its models differentiate the XLA path).  This is the gradient of
// flash_attention_pallas (src/repro/kernels/flash_attention/
// flash_attention.py) for the port, whose models run the forward kernel
// under autograd.
//
// Bound on the H100 (chip_smoke.py, _fa_bwd_cost): operations -- 2·D FLOP
// for each of the five products (S, dP, dV, dK, dQ) per visible pair and
// head, 2.5 times the forward's, at 989 TFLOP/s in bf16 (67 TFLOP/s in
// float32) -- against bytes: q, k, v, o, dO read once and dq, dk, dv
// written once at 3.35 TB/s.  The group sum of variants 1 and 3a adds
// 2·(B·H·S·D·4) bytes of float32 partials written and read back, and 3's
// column passes repeat score products; both count in the kernels' time,
// not in the bound.
//
// Three variants, chosen by the wrapper (kernels/flash_attention/ops.py,
// plan_attention_bwd), none with atomics: every gradient element is
// summed in a fixed order, so two runs give the same bits.
//
// 1. "wgmma", bf16, D <= 256 (D a multiple of 16; the wrapper pads), up
//    to four launches:
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
//       in registers from the forward's saved log-sum-exp (no second pass
//       for the row statistics); dS = P ∘ (dP − Δ) packed in place into
//       bf16 A fragments; dQ += dS K as wgmma with K read MN-major (the
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
//    d. bwd_reduce_kernel (G > 1 only): sums each KV head's G partials in
//       ascending head order and writes dk, dv -- the group sum with no
//       atomics and no block walking the group's heads one after another.
//    Tiles wholly inside the causal limit and the window skip the mask;
//    a warpgroup skips a tile it cannot see at all.  P and dS are rounded
//    to bf16 for the dV, dK and dQ products (as the forward rounds P).
//    Against the float32 kernels below, run in bf16, this design: runs
//    every product on the tensor cores; forms S once per kernel (the saved
//    lse replaces the statistics pass); gives each query head its own
//    blocks (no serial walk over a KV head's G heads); loads bf16 tiles by
//    TMA into swizzled shared memory instead of float32 element by element.
// 2. "simt", float32 (the reference's 1e-4 bound does not survive TF32),
//    the first kernels, on the CUDA cores: bwd_dq_simt_kernel, a
//    block per (b, h, query tile of BT rows): Δ for its rows, the row
//    statistics (running max m and denominator l) over the visible key
//    tiles in ascending order, then a second pass forming P, dP, dS
//    (staged in shared memory) and accumulating dQ in registers; it writes
//    m, l and Δ of each row.  bwd_dkdv_simt_kernel, a block per (b, KV
//    head, key tile of BT rows) holding its K and V tile: for each of the
//    group's G heads in order, for each visible query tile in ascending
//    order, P and dS staged in shared memory, then dK and dV accumulated
//    in registers.  Float32 tiles with an odd row pitch (DT + 1); 256
//    threads as 16 x 16; DT (D <= DT) is 32, 64, 128 or 256, BT 64 (32 at
//    DT = 256).  Products spell fmaf (the build has -fmad=false).
// 3. "wide", D > 256, where a 64 x D float32 accumulator no longer fits
//    a warpgroup's registers (the forward's "wide" case):
//    a. bf16 (D a multiple of 8; TMA zero-fills each 64-column box past
//       D): bwd_delta_kernel, then bwd_dq_wide_kernel and
//       bwd_dkdv_wide_kernel with the tiled variant's passes and the
//       forward's fa_wide_wgmma_kernel shape -- a producer warpgroup and
//       two consumers, every operand a 64 x 64 TMA box through one ring of
//       16 slots, each box read by one consumer.  The score products S =
//       Q Kᵀ and dP = dO Vᵀ (Sᵀ = K Qᵀ, dPᵀ = V dOᵀ for dK / dV) contract
//       over D: each consumer takes D's boxes c, c + 2, ... and adds the
//       other's partial once through 32 KB of shared memory, so each is
//       formed once per tile pair, with the same bits in both.  P comes
//       from the forward's lse (fa_wide_wgmma_kernel writes it under
//       autograd), dS = P ∘ (dP − Δ); P and dS are rounded to bf16 A
//       fragments.  The output columns go in passes (blocks): dQ holds 8
//       boxes (512 columns, 4 a consumer, 128 registers a thread) a
//       block; dK and dV, two 64 x D accumulators (256 KB at D = 512),
//       hold 4 boxes of each (256 columns, 2 a consumer), so D = 512
//       takes two dK / dV passes.  The choice among the issue's three (a
//       pass per column group; dK and dV in separate passes; one
//       accumulator in shared memory): column passes of both, which keeps
//       P and dS in registers for the two products that read each of them
//       and needs no second copy of the ring.  Each pass forms its tile
//       pair's S and dP again: at D = 512 the kernels do 3 + 2 x 3 = 9
//       products of 2·D FLOP a visible pair against the bound's 5 (1.8x
//       its operations).  With H > Hkv each head writes float32 partials
//       and bwd_reduce_kernel sums each group in head order, as variant 1.
//    b. float32: bwd_dq_wide_simt_kernel and bwd_dkdv_wide_simt_kernel,
//       the simt kernels on 32-row tiles with the scores summed over D in
//       64-column slices staged in turn and the output columns in passes
//       of 512 (a block each; each pass forms its scores once, a second
//       pass again): the row statistics, P and dS as in 2, then Q's, dO's
//       or K's rows over the pass's columns staged and accumulated.
//
// Layouts: per-(b, h, s) element strides with D contiguous, so the model's
// (B, S, H, hd) activations go in as transposed views without a copy;
// variant 1 needs 16-byte aligned bases and strides (TMA), and the wrapper
// copies a tensor where that does not hold.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// 2. float32 on the CUDA cores ("simt")
// ---------------------------------------------------------------------------

constexpr int NT = 256;

struct SimtParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (3, B, H, S): m, l, Δ
  int B, H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, has_window, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ bool simt_visible(const SimtParams& p, int i,
                                             int j) {
  return i < p.S && j < p.S && (!p.causal || j <= i) &&
         (!p.has_window || j > i - p.window);
}

// rows [r0, r0 + BT) of a (b, head) slice into a BT x (DT + 1) float tile,
// zero past S and D
template <typename T, int BT, int DT>
__device__ void load_tile(float* dst, const T* base, const long long* st,
                          int b, int head, int r0, const SimtParams& p) {
  const T* src = base + b * st[0] + head * st[1];
  for (int idx = threadIdx.x; idx < BT * DT; idx += NT) {
    const int r = idx / DT, c = idx % DT;
    const int row = r0 + r;
    float x = 0.f;
    if (row < p.S && c < p.D) x = to_f(src[row * st[2] + c]);
    dst[r * (DT + 1) + c] = x;
  }
}

// a sum over the 16 lanes of a half-warp (the tx of one ty)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

// s[a][b] = scale · q_row(ty + 16a) · k_row(tx + 16b), from shared tiles
template <int BT, int DT>
__device__ __forceinline__ void scores(float (&s)[BT / 16][BT / 16],
                                       const float* sQ, const float* sK,
                                       int ty, int tx, int D) {
  constexpr int R = BT / 16, LD = DT + 1;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) s[a][b] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qa[R], kb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < R; ++b) kb[b] = sK[(tx + 16 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
  }
}

template <typename T, int BT, int DT>
__global__ void __launch_bounds__(NT) bwd_dq_simt_kernel(SimtParams p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BT * LD;
  float* sK = sDO + BT * LD;
  float* sV = sK + BT * LD;
  float* sDS = sV + BT * LD;  // BT x (BT + 1)

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int i0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile<T, BT, DT>(sQ, q, p.sq, b, h, i0, p);
  load_tile<T, BT, DT>(sDO, dout, p.sdo, b, h, i0, p);

  // Δ of the thread's rows: its columns, then the half-warp's sum
  float delta[R];
  {
    const T* ob = o + b * p.so[0] + h * p.so[1];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty + 16 * a, row = i0 + r;
      float part = 0.f;
      if (row < p.S)
        for (int d = tx; d < p.D; d += 16)
          part = fmaf(sDO[r * LD + d], to_f(ob[row * p.so[2] + d]), part);
      delta[a] = sum16(part);
    }
  }

  // the visible key range of the tile's rows
  const int i_last = min(i0 + BT, p.S) - 1;
  int jlo = 0, jhi = p.causal ? i_last + 1 : p.S;
  if (p.has_window) jlo = max(0, i0 - p.window + 1);

  // pass 1: running max and denominator, keys ascending
  float m[R], l[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int j0 = jlo; j0 < jhi; j0 += BT) {
    __syncthreads();
    load_tile<T, BT, DT>(sK, k, p.sk, b, kvh, j0, p);
    __syncthreads();
    float s[R][R];
    scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = i0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = simt_visible(p, i, j0 + tx + 16 * c) ? s[a][c] * p.scale
                                                   : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = max16(mx);
      // every lane of the warp takes part in the shuffles: a row with
      // nothing visible yet keeps m = -inf, l = 0
      const float m_new = fmaxf(m[a], mx);
      const bool none = m_new == -INFINITY;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) part += expf(s[a][c] - (none ? 0.f : m_new));
      part = sum16(part);
      l[a] = none ? 0.f : l[a] * expf(m[a] - m_new) + part;
      m[a] = m_new;
    }
  }

  // pass 2: dS, dQ
  float acc[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[a][c] = 0.f;
  for (int j0 = jlo; j0 < jhi; j0 += BT) {
    __syncthreads();
    load_tile<T, BT, DT>(sK, k, p.sk, b, kvh, j0, p);
    load_tile<T, BT, DT>(sV, v, p.sv, b, kvh, j0, p);
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
    scores<BT, DT>(dp, sDO, sV, ty, tx, p.D);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int col = tx + 16 * c;
        float ds = 0.f;
        if (simt_visible(p, i, j0 + col) && l[a] > 0.f) {
          const float pr = expf(s[a][c] * p.scale - m[a]) / l[a];
          ds = pr * (dp[a][c] - delta[a]);
        }
        sDS[r * (BT + 1) + col] = ds;
      }
    }
    __syncthreads();
    const int jn = min(BT, p.S - j0);
    for (int j = 0; j < jn; ++j) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float ds = sDS[(ty + 16 * a) * (BT + 1) + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[a][c] = fmaf(ds, kv[c], acc[a][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
  const long long plane = (long long)p.B * p.H * p.S;
  float* st = p.stats + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) dq[row * p.sdq[2] + d] = from_f<T>(p.scale * acc[a][c]);
    }
    if (tx == 0) {
      st[row] = m[a];
      st[plane + row] = l[a];
      st[2 * plane + row] = delta[a];
    }
  }
}

template <typename T, int BT, int DT>
__global__ void __launch_bounds__(NT) bwd_dkdv_simt_kernel(SimtParams p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sDO = sQ + BT * LD;
  float* sP = sDO + BT * LD;      // BT x (BT + 1), [query][key]
  float* sDS = sP + BT * (BT + 1);
  float* sStat = sDS + BT * (BT + 1);  // m, l, Δ of the query tile's rows

  const int Hkv = p.H / p.group;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int j0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const long long plane = (long long)p.B * p.H * p.S;

  load_tile<T, BT, DT>(sK, static_cast<const T*>(p.k), p.sk, b, kvh, j0, p);
  load_tile<T, BT, DT>(sV, static_cast<const T*>(p.v), p.sv, b, kvh, j0, p);

  // the visible query range of the tile's keys
  const int j_last = min(j0 + BT, p.S) - 1;
  const int ilo = p.causal ? j0 : 0;
  int ihi = p.S;
  if (p.has_window) ihi = min(p.S, j_last + p.window);

  float dk[R][C], dv[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const float* st = p.stats + ((long long)b * p.H + h) * p.S;
    for (int i0 = ilo; i0 < ihi; i0 += BT) {
      __syncthreads();
      load_tile<T, BT, DT>(sQ, q, p.sq, b, h, i0, p);
      load_tile<T, BT, DT>(sDO, dout, p.sdo, b, h, i0, p);
      for (int r = threadIdx.x; r < BT; r += NT) {
        const int row = i0 + r;
        const bool in = row < p.S;
        sStat[r] = in ? st[row] : 0.f;
        sStat[BT + r] = in ? st[plane + row] : 0.f;
        sStat[2 * BT + r] = in ? st[2 * plane + row] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
      scores<BT, DT>(dp, sDO, sV, ty, tx, p.D);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = ty + 16 * a, i = i0 + r;
        const float m = sStat[r], l = sStat[BT + r], delta = sStat[2 * BT + r];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int col = tx + 16 * c;
          float pr = 0.f, ds = 0.f;
          if (simt_visible(p, i, j0 + col) && l > 0.f) {
            pr = expf(s[a][c] * p.scale - m) / l;
            ds = pr * (dp[a][c] - delta);
          }
          sP[r * (BT + 1) + col] = pr;
          sDS[r * (BT + 1) + col] = ds;
        }
      }
      __syncthreads();
      const int rn = min(BT, p.S - i0);
      for (int r = 0; r < rn; ++r) {
        float qv[C], dov[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qv[c] = sQ[r * LD + tx + 16 * c];
          dov[c] = sDO[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const int j = ty + 16 * a;
          const float pr = sP[r * (BT + 1) + j];
          const float ds = sDS[r * (BT + 1) + j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv[a][c] = fmaf(pr, dov[c], dv[a][c]);
            dk[a][c] = fmaf(ds, qv[c], dk[a][c]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk[0] + kvh * p.sdk[1];
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv[0] + kvh * p.sdv[1];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = j0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) {
        dkp[row * p.sdk[2] + d] = from_f<T>(p.scale * dk[a][c]);
        dvp[row * p.sdv[2] + d] = from_f<T>(dv[a][c]);
      }
    }
  }
}

template <int BT, int DT>
constexpr size_t simt_dq_bytes() {
  return sizeof(float) * (4 * BT * (DT + 1) + BT * (BT + 1));
}
template <int BT, int DT>
constexpr size_t simt_dkdv_bytes() {
  return sizeof(float) * (4 * BT * (DT + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <int DT>
int launch_simt(const SimtParams& p, int Hkv, cudaStream_t st) {
  constexpr int BT = DT <= 128 ? 64 : 32;
  const int tiles = (p.S + BT - 1) / BT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  int err = launch(bwd_dq_simt_kernel<float, BT, DT>, simt_dq_bytes<BT, DT>(),
                   dim3(p.B * p.H, tiles), NT, st, p);
  if (err != 0) return err;
  return launch(bwd_dkdv_simt_kernel<float, BT, DT>,
                simt_dkdv_bytes<BT, DT>(), dim3(p.B * Hkv, tiles), NT, st, p);
}

// ---------------------------------------------------------------------------
// 1. bf16 on the tensor cores ("wgmma")
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

struct WgParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, S): the forward's, natural units
  float* delta;      // (B, H, S): Δ, written by bwd_delta_kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;  // G > 1: (2, B, H, S, D) partial dK, dV; G = 1: null
  int B, H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, has_window, window;
  float scale;
};

__device__ __forceinline__ bool seen(const WgParams& p, int row, int key) {
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
// head order, 4 columns a thread (float4 in, 4 bf16 out)
__global__ void __launch_bounds__(256) bwd_reduce_kernel(WgParams p) {
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
  __nv_bfloat16* dst =
      is_v ? p.dv + b * p.sdv[0] + hk * p.sdv[1] + s * p.sdv[2]
           : p.dk + b * p.sdk[0] + hk * p.sdk[1] + s * p.sdk[2];
  store_bf16x2(dst + 4 * c4, acc.x, acc.y);
  store_bf16x2(dst + 4 * c4 + 2, acc.z, acc.w);
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
int launch_reduce(const WgParams& p, int Hkv, cudaStream_t st) {
  const long long groups = 2LL * p.B * Hkv * p.S * (p.D / 4);
  return launch(bwd_reduce_kernel, 0, dim3((unsigned)((groups + 255) / 256)),
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
// 3. D > 256 ("wide")
// ---------------------------------------------------------------------------

// 3a. bf16 on the tensor cores.  Three warpgroups as in the forward's
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

// 3b. float32 on the CUDA cores, to hold the 1e-4 float32 bound: the simt
// kernels with the scores summed over D in WS_DS-column slices staged in
// turn, and the output columns in passes of WS_DC (a block each), each
// pass forming the scores once.  256 threads (ty, tx) = (tid / 16, tid %
// 16); a 32-row tile: rows ty + 16 a, score columns tx + 16 c, output
// columns 4 tx + 64 jj + e of the pass.  Shared tiles have rows of a
// multiple of 4 floats plus 4, so each thread reads float4s: 16
// multiply-adds for 4 loads in the scores, 8 or 16 for 1 or 2 in the
// output products.
constexpr int WS_BT = 32;          // rows of a query or key tile
constexpr int WS_DS = 64;          // head-dim slice of a score pass
constexpr int WS_LS = WS_DS + 4;
constexpr int WS_DC = 512;         // output columns of a block
constexpr int WS_LC = WS_DC + 4;
constexpr int WS_CJ = WS_DC / 64;  // a thread's float4s of output columns
constexpr int WS_LP = WS_BT + 1;

// rows r0 .. r0 + WS_BT - 1, columns c0 .. c0 + COLS - 1 of one head into
// rows of LD floats; zeros past S and D
template <int COLS, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long rs, int r0, int c0,
                                          int S, int D) {
  for (int idx = threadIdx.x; idx < WS_BT * COLS; idx += NT) {
    const int r = idx / COLS, c = idx % COLS;
    float x = 0.0f;
    if (r0 + r < S && c0 + c < D) x = src[(long long)(r0 + r) * rs + c0 + c];
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a · b over the 4 lanes of two float4s, in lane order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[0 .. 3] += x · v
__device__ __forceinline__ void axpy4(float (&acc)[4], float x, float4 v) {
  acc[0] = fmaf(x, v.x, acc[0]);
  acc[1] = fmaf(x, v.y, acc[1]);
  acc[2] = fmaf(x, v.z, acc[2]);
  acc[3] = fmaf(x, v.w, acc[3]);
}

// s[a][c] += X[ty + 16 a] · Y[tx + 16 c] over a staged slice
__device__ __forceinline__ void slice_scores(float (&s)[2][2], const float* X,
                                             const float* Y, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < WS_DS; d += 4) {
    const float4 x0 = ld4(X + ty * WS_LS + d), x1 = ld4(X + (ty + 16) * WS_LS + d);
    const float4 y0 = ld4(Y + tx * WS_LS + d), y1 = ld4(Y + (tx + 16) * WS_LS + d);
    s[0][0] = dot4(x0, y0, s[0][0]);
    s[0][1] = dot4(x0, y1, s[0][1]);
    s[1][0] = dot4(x1, y0, s[1][0]);
    s[1][1] = dot4(x1, y1, s[1][1]);
  }
}

// dQ: a block per (b, h, column pass, 32-row query tile): Δ of its rows,
// the row statistics (pass 1), then P, dP, dS (staged in shared memory)
// and dQ += dS K over the pass's columns; the first pass writes m, l, Δ
__global__ void __launch_bounds__(NT) bwd_dq_wide_simt_kernel(SimtParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + WS_BT * WS_LS;
  float* sK = sDO + WS_BT * WS_LS;
  float* sV = sK + WS_BT * WS_LS;
  float* sDS = sV + WS_BT * WS_LS;  // [query][key]
  float* sKc = sDS + WS_BT * WS_LP;  // K's rows over the pass's columns

  const int passes = (p.D + WS_DC - 1) / WS_DC;
  const int bh = blockIdx.x / passes, d0 = blockIdx.x % passes * WS_DC;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int i0 = blockIdx.y * WS_BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* k = static_cast<const float*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const float* v = static_cast<const float*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const float* o = static_cast<const float*>(p.o) + b * p.so[0] + h * p.so[1];
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];

  // Δ of the thread's rows: its columns, then the half-warp's sum
  float delta[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = i0 + ty + 16 * a;
    float part = 0.f;
    if (row < p.S)
      for (int d = tx; d < p.D; d += 16)
        part = fmaf(dout[row * p.sdo[2] + d], o[row * p.so[2] + d], part);
    delta[a] = sum16(part);
  }

  const int i_last = min(i0 + WS_BT, p.S) - 1;
  int jlo = 0, jhi = p.causal ? i_last + 1 : p.S;
  if (p.has_window) jlo = max(0, i0 - p.window + 1);

  // pass 1: running max and denominator, keys ascending
  float m[2], l[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int j0 = jlo; j0 < jhi; j0 += WS_BT) {
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c0 = 0; c0 < p.D; c0 += WS_DS) {
      __syncthreads();
      stage_f32<WS_DS, WS_LS>(sQ, q, p.sq[2], i0, c0, p.S, p.D);
      stage_f32<WS_DS, WS_LS>(sK, k, p.sk[2], j0, c0, p.S, p.D);
      __syncthreads();
      slice_scores(s, sQ, sK, ty, tx);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[a][c] = simt_visible(p, i, j0 + tx + 16 * c) ? s[a][c] * p.scale
                                                       : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = max16(mx);
      const float m_new = fmaxf(m[a], mx);
      const bool none = m_new == -INFINITY;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) part += expf(s[a][c] - (none ? 0.f : m_new));
      part = sum16(part);
      l[a] = none ? 0.f : l[a] * expf(m[a] - m_new) + part;
      m[a] = m_new;
    }
  }

  // pass 2: dS, dQ over the pass's columns
  float acc[2][WS_CJ][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int jj = 0; jj < WS_CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][jj][e] = 0.f;
  for (int j0 = jlo; j0 < jhi; j0 += WS_BT) {
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c0 = 0; c0 < p.D; c0 += WS_DS) {
      __syncthreads();
      stage_f32<WS_DS, WS_LS>(sQ, q, p.sq[2], i0, c0, p.S, p.D);
      stage_f32<WS_DS, WS_LS>(sK, k, p.sk[2], j0, c0, p.S, p.D);
      stage_f32<WS_DS, WS_LS>(sDO, dout, p.sdo[2], i0, c0, p.S, p.D);
      stage_f32<WS_DS, WS_LS>(sV, v, p.sv[2], j0, c0, p.S, p.D);
      __syncthreads();
      slice_scores(s, sQ, sK, ty, tx);
      slice_scores(dp, sDO, sV, ty, tx);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 16 * c;
        float ds = 0.f;
        if (simt_visible(p, i, j0 + col) && l[a] > 0.f) {
          const float pr = expf(s[a][c] * p.scale - m[a]) / l[a];
          ds = pr * (dp[a][c] - delta[a]);
        }
        sDS[r * WS_LP + col] = ds;
      }
    }
    stage_f32<WS_DC, WS_LC>(sKc, k, p.sk[2], j0, d0, p.S, p.D);
    __syncthreads();
    const int jn = min(WS_BT, p.S - j0);
    for (int j = 0; j < jn; ++j) {
      const float ds0 = sDS[ty * WS_LP + j], ds1 = sDS[(ty + 16) * WS_LP + j];
#pragma unroll
      for (int jj = 0; jj < WS_CJ; ++jj) {
        const float4 kv = ld4(sKc + j * WS_LC + 4 * tx + 64 * jj);
        axpy4(acc[0][jj], ds0, kv);
        axpy4(acc[1][jj], ds1, kv);
      }
    }
  }

  float* dq = static_cast<float*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
  const long long plane = (long long)p.B * p.H * p.S;
  float* stt = p.stats + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int jj = 0; jj < WS_CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 4 * tx + 64 * jj + e;
        if (d < p.D) dq[row * p.sdq[2] + d] = p.scale * acc[a][jj][e];
      }
    if (tx == 0 && d0 == 0) {
      stt[row] = m[a];
      stt[plane + row] = l[a];
      stt[2 * plane + row] = delta[a];
    }
  }
}

// dK / dV: a block per (b, KV head, column pass, 32-key tile) holding its
// keys' dK and dV over the pass's columns in registers; for each of the
// group's G heads in order, each visible query tile in ascending order:
// the scores over D's slices, P and dS from the row statistics (staged in
// shared memory), then Q's and dO's rows over the pass's columns staged
// and dK, dV accumulated
__global__ void __launch_bounds__(NT) bwd_dkdv_wide_simt_kernel(SimtParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + WS_BT * WS_LS;
  float* sK = sDO + WS_BT * WS_LS;
  float* sV = sK + WS_BT * WS_LS;
  float* sP = sV + WS_BT * WS_LS;  // [query][key]
  float* sDS = sP + WS_BT * WS_LP;
  float* sStat = sDS + WS_BT * WS_LP;  // m, l, Δ of the query tile's rows
  float* sQc = sStat + 3 * WS_BT;
  float* sDOc = sQc + WS_BT * WS_LC;

  const int Hkv = p.H / p.group;
  const int passes = (p.D + WS_DC - 1) / WS_DC;
  const int bk = blockIdx.x / passes, d0 = blockIdx.x % passes * WS_DC;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int j0 = blockIdx.y * WS_BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* k = static_cast<const float*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const float* v = static_cast<const float*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const long long plane = (long long)p.B * p.H * p.S;

  const int j_last = min(j0 + WS_BT, p.S) - 1;
  const int ilo = p.causal ? j0 : 0;
  int ihi = p.S;
  if (p.has_window) ihi = min(p.S, j_last + p.window);

  float dk[2][WS_CJ][4], dv[2][WS_CJ][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int jj = 0; jj < WS_CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[a][jj][e] = dv[a][jj][e] = 0.f;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const float* q = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
    const float* dout =
        static_cast<const float*>(p.dout) + b * p.sdo[0] + h * p.sdo[1];
    const float* st = p.stats + ((long long)b * p.H + h) * p.S;
    for (int i0 = ilo; i0 < ihi; i0 += WS_BT) {
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int c0 = 0; c0 < p.D; c0 += WS_DS) {
        __syncthreads();
        stage_f32<WS_DS, WS_LS>(sQ, q, p.sq[2], i0, c0, p.S, p.D);
        stage_f32<WS_DS, WS_LS>(sK, k, p.sk[2], j0, c0, p.S, p.D);
        stage_f32<WS_DS, WS_LS>(sDO, dout, p.sdo[2], i0, c0, p.S, p.D);
        stage_f32<WS_DS, WS_LS>(sV, v, p.sv[2], j0, c0, p.S, p.D);
        if (c0 == 0)
          for (int r = threadIdx.x; r < WS_BT; r += NT) {
            const int row = i0 + r;
            const bool in = row < p.S;
            sStat[r] = in ? st[row] : 0.f;
            sStat[WS_BT + r] = in ? st[plane + row] : 0.f;
            sStat[2 * WS_BT + r] = in ? st[2 * plane + row] : 0.f;
          }
        __syncthreads();
        slice_scores(s, sQ, sK, ty, tx);
        slice_scores(dp, sDO, sV, ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty + 16 * a, i = i0 + r;
        const float m = sStat[r], l = sStat[WS_BT + r],
                    delta = sStat[2 * WS_BT + r];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          float pr = 0.f, ds = 0.f;
          if (simt_visible(p, i, j0 + col) && l > 0.f) {
            pr = expf(s[a][c] * p.scale - m) / l;
            ds = pr * (dp[a][c] - delta);
          }
          sP[r * WS_LP + col] = pr;
          sDS[r * WS_LP + col] = ds;
        }
      }
      stage_f32<WS_DC, WS_LC>(sQc, q, p.sq[2], i0, d0, p.S, p.D);
      stage_f32<WS_DC, WS_LC>(sDOc, dout, p.sdo[2], i0, d0, p.S, p.D);
      __syncthreads();
      const int rn = min(WS_BT, p.S - i0);
      for (int r = 0; r < rn; ++r) {
        const float p0 = sP[r * WS_LP + ty], p1 = sP[r * WS_LP + ty + 16];
        const float s0 = sDS[r * WS_LP + ty], s1 = sDS[r * WS_LP + ty + 16];
#pragma unroll
        for (int jj = 0; jj < WS_CJ; ++jj) {
          const float4 qv = ld4(sQc + r * WS_LC + 4 * tx + 64 * jj);
          const float4 dov = ld4(sDOc + r * WS_LC + 4 * tx + 64 * jj);
          axpy4(dv[0][jj], p0, dov);
          axpy4(dv[1][jj], p1, dov);
          axpy4(dk[0][jj], s0, qv);
          axpy4(dk[1][jj], s1, qv);
        }
      }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.sdk[0] + kvh * p.sdk[1];
  float* dvp = static_cast<float*>(p.dv) + b * p.sdv[0] + kvh * p.sdv[1];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = j0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int jj = 0; jj < WS_CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 4 * tx + 64 * jj + e;
        if (d < p.D) {
          dkp[row * p.sdk[2] + d] = p.scale * dk[a][jj][e];
          dvp[row * p.sdv[2] + d] = dv[a][jj][e];
        }
      }
  }
}

constexpr size_t WS_DQ_BYTES =
    sizeof(float) * (4 * WS_BT * WS_LS + WS_BT * WS_LP + WS_BT * WS_LC);
constexpr size_t WS_KV_BYTES =
    sizeof(float) *
    (4 * WS_BT * WS_LS + 2 * WS_BT * WS_LP + 3 * WS_BT + 2 * WS_BT * WS_LC);

int launch_wide_simt(const SimtParams& p, int Hkv, cudaStream_t st) {
  const int passes = (p.D + WS_DC - 1) / WS_DC;
  const int tiles = (p.S + WS_BT - 1) / WS_BT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  int err = launch(bwd_dq_wide_simt_kernel, WS_DQ_BYTES,
                   dim3(p.B * p.H * passes, tiles), NT, st, p);
  if (err != 0) return err;
  return launch(bwd_dkdv_wide_simt_kernel, WS_KV_BYTES,
                dim3(p.B * Hkv * passes, tiles), NT, st, p);
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

}  // namespace

// Variant "simt" (float32): tile_d the head-dim tile (32, 64, 128 or 256,
// D <= tile_d); strides per (b, head, s) in elements, D contiguous, in the
// order q, k, v, o, dO, dq, dk, dv; stats a float32 scratch of 3·B·H·S.
// Two kernel launches on `stream`.
extern "C" int flash_attention_bwd_simt_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* stats, int tile_d,
    int B, int H, int Hkv, int S, int D, const long long* strides, int causal,
    int has_window, int window, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool wide = tile_d == WS_DC;
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 ||
      (wide ? D <= 256 : D > tile_d))
    return (int)cudaErrorInvalidValue;
  SimtParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = stats;
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
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) return launch_wide_simt(p, Hkv, st);
  switch (tile_d) {
    case 32: return launch_simt<32>(p, Hkv, st);
    case 64: return launch_simt<64>(p, Hkv, st);
    case 128: return launch_simt<128>(p, Hkv, st);
    case 256: return launch_simt<256>(p, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Variant "wgmma" (bf16): tile_d 64, 128 or 256; D (a multiple of 16,
// D <= tile_d, above tile_d / 2 past 64) as the tensors hold it; strides as
// above; lse the forward's (B, H, S) float32; delta a float32 scratch of
// B·H·S; part a float32 scratch of 2·B·H·S·D when H > Hkv, else null.
// Bases and strides of q, k, v, o, dO 16-byte aligned (TMA, 16-byte
// loads), of dq, dk, dv 4-byte.  Three launches on `stream` (delta, dq,
// dkdv), a fourth (reduce) when H > Hkv.
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
  WgParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
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
  const void* in[5] = {q, k, v, o, dout};
  for (int t = 0; t < 5; ++t)
    if (!aligned16(in[t], dst[t])) return bad;
  void* out[3] = {dq, dk, dv};
  for (int t = 0; t < 3; ++t)
    if (!aligned4(out[t], dst[5 + t])) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) return launch_wide(p, Hkv, st);
  if (tile_d == 64) return launch_wgmma<64>(p, Hkv, st);
  if (tile_d == 128) return launch_wgmma<128>(p, Hkv, st);
  return launch_wgmma<256>(p, Hkv, st);
}
