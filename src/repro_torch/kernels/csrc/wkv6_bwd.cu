// WKV6 backward (B7-bwd): the gradients of the RWKV6 (Finch) time-mix scan
// of wkv6.cu.  Per (batch, head), with head dim D, rows t = 0 .. T-1, the
// state S_{-1} = s0 and w_t = exp(clamp(lw_t, -3.5, 0)):
//
//     y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
//     S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
//
// and dS_t the gradient of the state after row t (dS_{T-1} = ds_fin, or 0):
//
//     dS_{t-1} = diag(w_t) dS_t + r_t ⊗ dy_t
//     dr_t  = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
//     dk_t  = dS_t v_t + u ⊙ r_t (v_t · dy_t)
//     dv_t  = dS_tᵀ k_t + (Σ_i r_ti u_i k_ti) dy_t
//     du    = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)
//     dlw_t = w_t ⊙ Σ_j dS_t[:, j] ⊙ S_{t-1}[:, j], where lw_t lies in
//             [-3.5, 0] (ends included, torch.clamp's rule), else 0
//     ds0   = dS_{-1}
//
// Replaces no TPU kernel: the reference has no backward kernel (its model
// differentiates the XLA chunked scan, src/repro/kernels/wkv6/ops.py,
// _wkv6_xla_chunked); this is the gradient of the port's B7 (wkv6.cu,
// which replaces wkv6_pallas, src/repro/kernels/wkv6/wkv6.py:99).  The
// plain version is wkv6_bwd_ref (kernels/wkv6/ref.py).
//
// The forward's chunk-16 factorisation, run backwards.  Per chunk of C = 16
// rows: g = clamp(lw), cum its in-chunk inclusive prefix, cp = cum - g,
// r~ = r ⊙ e^{cp}, k~ = k ⊙ e^{-cum}, L = the last row's cum, vdy_t =
// v_t · dy_t, tril_{-1} / triu_{+1} the strictly lower / upper 16 x 16
// triangles.  Two kernels on one stream:
//
// 1. wkv6_bwd_fwd_kernel, the chunks in order from s0, carrying the state
//    S at the chunk's start (the forward kernel's update):
//        dr' = e^{cp} ⊙ (dy Sᵀ + tril_{-1}(dy vᵀ) k~),  dr = dr' + u ⊙ k vdy
//        q   = r ⊙ dr',   du += Σ_t r ⊙ k vdy,   S <- e^{L} ⊙ (S + k~ᵀ v)
//    q_t (t >= 1) waits in dlw's row t; row 0 gets P_fin = Σ_j ds_fin ⊙
//    S_{T-1} (q_0 is never needed).
// 2. wkv6_bwd_rev_kernel, the chunks in reverse from ds_fin, carrying dS at
//    the chunk's end; it needs no state:
//        dk' = e^{L-cum} ⊙ (v dSᵀ) + e^{-cum} ⊙ (triu_{+1}(v dyᵀ) r~)
//        dk  = dk' + u ⊙ r vdy
//        dv  = triu_{+1}(k~ r~ᵀ) dy + (k ⊙ e^{L-cum}) dS + bonus ⊙ dy
//        dS <- e^{L} ⊙ dS + r~ᵀ dy   (e^{L} scales the rows)
//    and dlw from two suffix sums: since w_t S_{t-1} = S_t - k_t ⊗ v_t,
//        dlw_t = P_t - k_t ⊙ dk'_t,   P_{t-1} = dlw_t + q_t,   P_{T-1} = P_fin
//    a serial walk over the rows, a lane per channel, in the float32
//    rounding class of a walk over the states.
//
// Every product is on the tensor cores (mma.sync.m16n8k8) in 3xTF32
// (tf32.cuh), as the forward's.  e^{cp} and e^{-cum} multiply the finished
// 16 x D tiles; e^{L-cum} is one exponent.  Chunk 16 keeps e^{-cum} <=
// e^{56}, inside float32 and TF32 range.
//
// Layout.  Row i of S and of dS is a closed recurrence, so the forward
// sweep, and the reverse sweep's dk and dlw, split by groups of 16
// channels with no sums across warps: a "rows" warp holds its 16 rows of S
// (or dS) as accumulator fragments (rows = channels, 8 tiles of 8
// columns), which are also the B operand of dy Sᵀ (v dSᵀ) with the k index
// permuted.  dv sums over all channels, so "cols" warps form it, 16 value
// columns each, reading dS from a shared tile the rows warps write at each
// chunk's end (double-buffered: no extra barrier).  Beside them, staging
// warps keep a three-slot ring of 16-row
// chunks in flight by cp.async (rows past T zero-filled: identity rows,
// r = k = v = dy = 0 and lw = 0) and prepare chunk c + 1 while the others
// work on chunk c, one block barrier a chunk: the per-channel prefixes
// (two lanes a channel, eight rows each), the tiles the others read
// (e^{cp}, k~; r~, k~, k ⊙ e^{L-cum}, e^{-cum}, e^{L-cum}; e^{L}; the
// bonus), and the 16 x 16 products once a block instead of once a warp:
// tril_{-1}(dy vᵀ) or triu_{+1}(v dyᵀ) with its diagonal vdy, and
// triu_{+1}(k~ r~ᵀ).  The reverse sweep's staging warps also bring q back
// from dlw's rows a chunk ahead.
//
//   forward: a block per (b, h): 4 rows warps, 4 staging warps;
//   reverse: a block per (b, h): 4 rows warps, 4 cols warps, 4 staging
//            warps (384 threads, one block an SM).  The rows warps carry
//            dS whenever the kernel runs: dv reads it too.
//
// Inputs are read through (b, h, t) strides with D contiguous (16-byte
// aligned bases and strides); dr, dk, dv, dlw are written through their
// own strides, so the model's (B, T, H, D) views take their gradients in
// place.  Any output may be null (not computed; a kernel none of whose
// outputs is asked for is not launched); s0 and ds_fin null mean zero.
// du's per-(b, h) partials go to du_part (B, H, D), summed over b by the
// wrapper: no atomics, so two runs give the same bits.  Only D = 64 is
// built (RWKV_HEAD_DIM, every registry model's); the wrapper zero-pads a
// smaller D and refuses a wider one.
//
// Bound on the H100: r, k, v, lw, dy read and dr, dk, dv, dlw written
// (9 · B·H·T·D floats) at 3.35 TB/s, against 12 D² FLOP a (b, h, t) on
// the tensor cores (TF32, 495 TFLOP/s, three products each): bytes bind,
// 0.0564 ms at (2, 40, 1024, 64).  The kernels do more: q goes through
// dlw's rows and dS through shared memory.  At that shape there are 80 (b, h),
// so 80 of the 132 SMs work, each walking 64 dependent chunks; the SM's
// issue slots bind, a third of them spent splitting operands into their
// TF32 halves.  The build's -fmad=false forbids contraction the compiler
// would choose; the multiply-adds are spelled with fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int D = 64;            // the one head dim built
constexpr int CHUNK = 16;        // rows of a chunk
constexpr int GROUP = 16;        // channels (columns) of a warp
constexpr int NK = D / 8;        // 8-wide steps over D
constexpr int LF = D + 8;        // row stride of a staged all-D tile
constexpr int NP = 128;          // staging threads of a block (4 warps)
constexpr int NIN = 5;           // inputs: r, k, lw, v, dy
constexpr float LOG_W_MIN = -3.5f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* in[NIN];  // r, k, lw, v, dy: (B, H, T, D) through strides
  const float* u;        // (H, D)
  const float* s0;       // (B, H, D, D) contiguous, or null (zeros)
  const float* ds_fin;   // (B, H, D, D) contiguous, or null (zeros)
  float* out[4];         // dr, dk, dv, dlw: (B, H, T, D), or null
  float* du_part;        // (B, H, D), or null
  float* ds0;            // (B, H, D, D) contiguous, or null
  long long si[NIN][3];  // (b, h, t) element strides of the inputs
  long long so[4][3];    // ... and of the outputs
  int H, T;
};

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

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float clamp_lw(float x) {
  // jnp.clip order, as wkv6.cu: max with the floor, then min with 0
  x = x < LOG_W_MIN ? LOG_W_MIN : x;
  return x > 0.0f ? 0.0f : x;
}

constexpr int HALF = CHUNK / 2;  // rows of a lane's half chunk

// one butterfly step: lanes with bit 2W set keep rows W .. 2W - 1 of the
// pair's sum, the others rows 0 .. W - 1, now at v[0 .. W - 1]
template <int W>
__device__ __forceinline__ void fold_rows(float (&v)[HALF], int lane) {
  const bool up = lane & (2 * W);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float keep = up ? v[j + W] : v[j];
    const float send = up ? v[j] : v[j + W];
    v[j] = keep + __shfl_xor_sync(FULL, send, 2 * W);
  }
}

// v[j] per lane -> the sum over the 16 lanes of the lane's half warp of
// v[(lane >> 1) & 7]
__device__ __forceinline__ float half_warp_sum8(float (&v)[HALF], int lane) {
  fold_rows<4>(v, lane);
  fold_rows<2>(v, lane);
  fold_rows<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// A chunk's per-channel prefixes, two lanes a channel: lane l (l & 16 == 0)
// holds rows 0 .. 7 and lane l ^ 16 rows 8 .. 15 of one channel.  From the
// half's lw (clamped here) gives cum, the in-chunk inclusive prefix, and
// prev = cum - g, both in log2 units; returns L, the chunk's total, the
// same bits in both lanes.  The upper half adds the lower half's total to
// its own prefix: one rounding more than a walk over 16 rows.
__device__ __forceinline__ float half_prefix(const float (&lv)[HALF],
                                             float (&cum)[HALF],
                                             float (&prev)[HALF],
                                             bool upper) {
  float g[HALF], c = 0.0f;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    g[j] = clamp_lw(lv[j]) * LOG2E;
    c = c + g[j];
    cum[j] = c;
  }
  const float other = __shfl_xor_sync(FULL, c, 16);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    if (upper) cum[j] = other + cum[j];
    prev[j] = cum[j] - g[j];
  }
  return upper ? other + c : c + other;
}

// the (channel, half) of prefix item it (it = thread + k · block size)
__device__ __forceinline__ int item_channel(int it) {
  return (it & 15) + 16 * (it >> 5);
}

// rows t0 .. t0 + 15 of one input into dst (row stride LF), by the NP
// staging threads (p the caller's index among them); rows past T are
// zeros (their source is not read).  A thread keeps one 16-byte piece of
// every (NP / N4)-th row, so each address is the previous one plus a
// stride: a few integer instructions a piece, not a 64-bit product
__device__ __forceinline__ void stage_rows(float* dst, const float* g,
                                           long long ts, int t0, int T,
                                           int p) {
  constexpr int N4 = D / 4, RS = NP / N4, PER = CHUNK / RS;
  static_assert(CHUNK % RS == 0, "every thread stages as many rows");
  const int tf = p / N4, c4 = 4 * (p % N4);
  const float* src = g + (long long)(t0 + tf) * ts + c4;
  const long long step = RS * ts;
  float* d = dst + tf * LF + c4;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    cp_async16(d + i * RS * LF, src, t0 + tf + i * RS < T);
    src += step;
  }
}

// the staging threads' own barrier (barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void prep_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NP) : "memory");
}

// per (b, h): the inputs' bases and row strides, the outputs' bases
struct Head {
  const float* g[NIN];
  long long ts[NIN];
  float* o[4];
  long long to[4];
  long long b;
  int h, bh;
  __device__ __forceinline__ Head(const Args& a) {
    bh = blockIdx.x;
    b = bh / a.H;
    h = bh % a.H;
#pragma unroll
    for (int x = 0; x < NIN; ++x) {
      g[x] = a.in[x] + b * a.si[x][0] + h * a.si[x][1];
      ts[x] = a.si[x][2];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      o[x] = a.out[x] == nullptr ? nullptr
                                 : a.out[x] + b * a.so[x][0] + h * a.so[x][1];
      to[x] = a.so[x][2];
    }
  }
};

// x[0 .. 3] of a 16 x 16 accumulator pair (tiles x = 0, 1 of 8 columns):
// the element at row gid + 8 (e >> 1), column 8 x + 2 tig + (e & 1)
__device__ __forceinline__ int acc_row(int gid, int e) {
  return gid + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int x, int tig, int e) {
  return 8 * x + 2 * tig + (e & 1);
}

constexpr int LA = CHUNK + 8;  // row stride of a staged 16 x 16 tile

// tile x (columns 8x .. 8x + 7) of P Qᵀ over D, P and Q 16-row tiles of
// row stride LF: four accumulators over the 8-wide steps
__device__ __forceinline__ void pqt_tile(const float* P, const float* Q, int x,
                                         int gid, int tig, float (&acc)[4]) {
  float a4[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) a4[q][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const float2 p0 =
        *reinterpret_cast<const float2*>(P + gid * LF + 8 * n + 2 * tig);
    const float2 p1 =
        *reinterpret_cast<const float2*>(P + (gid + 8) * LF + 8 * n + 2 * tig);
    const float2 q0 = *reinterpret_cast<const float2*>(
        Q + (8 * x + gid) * LF + 8 * n + 2 * tig);
    mma3(a4[n & 3], FragA(p0.x, p1.x, p0.y, p1.y), FragB(q0.x, q0.y));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    acc[e] = (a4[0][e] + a4[1][e]) + (a4[2][e] + a4[3][e]);
}

// tile x of a 16 x 16 product into A (row stride LA), strictly lower
// (s < t) or strictly upper (s > t) triangle kept; its diagonal into diag
// (if not null)
__device__ __forceinline__ void store_tri(float* A, float* diag,
                                          const float (&acc)[4], int x,
                                          int gid, int tig, bool lower) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = acc_row(gid, e), sc = acc_col(x, tig, e);
    A[t * LA + sc] = (lower ? sc < t : sc > t) ? acc[e] : 0.0f;
    if (diag != nullptr && sc == t) diag[t] = acc[e];
  }
}

// tile x of a stored triangle as the A operand (its columns the k index,
// permuted as an accumulator's)
__device__ __forceinline__ FragA tri_frag(const float* A, int x, int gid,
                                          int tig) {
  const float2 a0 =
      *reinterpret_cast<const float2*>(A + gid * LA + 8 * x + 2 * tig);
  const float2 a1 =
      *reinterpret_cast<const float2*>(A + (gid + 8) * LA + 8 * x + 2 * tig);
  return FragA(a0.x, a1.x, a0.y, a1.y);
}

// ---------------------------------------------------------------------------
// 1. the forward sweep: dr, q (in dlw's rows), P_fin, du's partials
// ---------------------------------------------------------------------------

// shared memory begins with a ring of three stages, each a chunk of the
// five inputs r, k, lw, v, dy (all D)
struct Ring {
  static constexpr int TILE = CHUNK * LF;
  static constexpr int K = TILE, LWS = 2 * TILE, V = 3 * TILE, Y = 4 * TILE;
  static constexpr int STAGE = NIN * TILE;
};

// chunk c of the five inputs into ring stage s
__device__ __forceinline__ void stage_chunk(float* s, const Head& hd, int T,
                                            int c, int p) {
#pragma unroll
  for (int x = 0; x < NIN; ++x)
    stage_rows(s + x * Ring::TILE, hd.g[x], hd.ts[x], c * CHUNK, T, p);
}

// 4 rows warps (a group of 16 channels each), then 4 staging warps
struct FwdLayout : Ring {
  static constexpr int NT = 2 * NP;
  // after the ring, two of each (by chunk parity): k~ [16][LF], e^{L} [D],
  // tril_{-1}(dy vᵀ) [16][LA], vdy [16]; u [D]
  static constexpr int KT = 3 * STAGE, DECAY = KT + 2 * TILE;
  static constexpr int AB = DECAY + 2 * D, VDY = AB + 2 * CHUNK * LA;
  static constexpr int US = VDY + 2 * CHUNK;
  static constexpr size_t bytes() { return sizeof(float) * (US + D); }
};

// chunk c's per-channel terms, two staging lanes a channel: e^{cp} over lw,
// k~, e^{L}.  Each phase loads what it reads before it stores: a store
// through one pointer keeps the compiler from moving a later load through
// another above it
__device__ __forceinline__ void fwd_prep(float* sm, int c, int p) {
  using L = FwdLayout;
  float* s = sm + (c % 3) * L::STAGE;
  const float* ks = s + L::K;
  float* ls = s + L::LWS;
  float* kt = sm + L::KT + (c & 1) * L::TILE;
  float* decay = sm + L::DECAY + (c & 1) * D;
  const int ch = item_channel(p);  // 2 D items, one a staging thread
  const bool upper = p & 16;
  const int o = (upper ? HALF * LF : 0) + ch;
  float lv[HALF], kv[HALF], cum[HALF], prev[HALF];
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    lv[j] = ls[o + j * LF];
    kv[j] = ks[o + j * LF];
  }
  const float tot = half_prefix(lv, cum, prev, upper);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    ls[o + j * LF] = exp2f(prev[j]);
    kt[o + j * LF] = kv[j] * exp2f(-cum[j]);
  }
  if (!upper) decay[ch] = exp2f(tot);
  // A = tril_{-1}(dy vᵀ) and vdy, a tile on each of staging warps 0, 1
  if (p < 64) {
    const int gid = (p & 31) >> 2, tig = p & 3;
    float acc[4];
    pqt_tile(s + L::Y, s + L::V, p >> 5, gid, tig, acc);
    store_tri(sm + L::AB + (c & 1) * CHUNK * LA,
              sm + L::VDY + (c & 1) * CHUNK, acc, p >> 5, gid, tig, true);
  }
}

__global__ void __launch_bounds__(FwdLayout::NT) wkv6_bwd_fwd_kernel(Args a) {
  using L = FwdLayout;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* us = sm + L::US;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool staging = warp >= 4;
  const int p = tid - NP;           // index among the staging threads
  const Head hd(a);
  const int cw = GROUP * warp;      // a rows warp's first channel
  const int T = a.T, nc = (T + CHUNK - 1) / CHUNK;
  const long long sb = (long long)hd.bh * D * D;
  float* dr = hd.o[0];
  float* dlw = hd.o[3];
  for (int i = tid; i < D; i += L::NT) us[i] = a.u[(long long)hd.h * D + i];

  // a rows warp's rows of S: st[n][e] = S[cw + acc_row][acc_col(n, .)]
  float st[NK][4];
  const long long so = sb + (long long)(cw + gid) * D + 2 * tig;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[n][e] = staging || a.s0 == nullptr
                     ? 0.0f
                     : a.s0[so + (e >> 1) * 8 * D + 8 * n + (e & 1)];
  float du[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // channels acc_col(x, tig, p)

  // the staging warps keep chunk c + 2 in flight and prepare c + 1 while
  // the rows warps work on chunk c: one block barrier a chunk
  if (staging) {
    if (nc > 0) stage_chunk(sm, hd, T, 0, p);
    cp_async_commit();
    if (nc > 1) stage_chunk(sm + L::STAGE, hd, T, 1, p);
    cp_async_commit();
    cp_async_wait_prior();
    prep_sync();
    if (nc > 0) fwd_prep(sm, 0, p);
  }
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    if (staging) {
      if (c + 2 < nc)
        stage_chunk(sm + ((c + 2) % 3) * L::STAGE, hd, T, c + 2, p);
      cp_async_commit();
      cp_async_wait_prior();
      prep_sync();
      if (c + 1 < nc) fwd_prep(sm, c + 1, p);
      __syncthreads();
      continue;
    }
    const float* rs = sm + (c % 3) * L::STAGE;
    const float* ks = rs + L::K;
    const float* ls = rs + L::LWS;  // e^{cp}
    const float* vs = rs + L::V;
    const float* ys = rs + L::Y;
    const float* kt = sm + L::KT + (c & 1) * L::TILE;
    const float* decay = sm + L::DECAY + (c & 1) * D;
    const float* Ab = sm + L::AB + (c & 1) * CHUNK * LA;
    const float* vdyb = sm + L::VDY + (c & 1) * CHUNK;

    // X = dy Sᵀ (t, the warp's channels): four accumulators over the
    // 8-wide steps shorten the chains of dependent mma
    float xq[4][2][4], xc[2][4], ac[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) xq[q][x][e] = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float2 y0 =
          *reinterpret_cast<const float2*>(ys + gid * LF + 8 * n + 2 * tig);
      const float2 y1 = *reinterpret_cast<const float2*>(
          ys + (gid + 8) * LF + 8 * n + 2 * tig);
      const FragA fy(y0.x, y1.x, y0.y, y1.y);
      mma3x2(xq[n & 3][0], fy, FragB(st[n][0], st[n][1]), xq[n & 3][1], fy,
             FragB(st[n][2], st[n][3]));
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xc[x][e] = (xq[0][x][e] + xq[1][x][e]) + (xq[2][x][e] + xq[3][x][e]);
    const float vdy[2] = {vdyb[gid], vdyb[gid + 8]};
    // X += tril_{-1}(dy vᵀ) k~
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const FragA fa = tri_frag(Ab, x, gid, tig);
      const float* kr = kt + (8 * x + 2 * tig) * LF + cw + gid;
      mma3x2(xc[0], fa, FragB(kr[0], kr[LF]), xc[1], fa,
             FragB(kr[8], kr[LF + 8]));
    }

    // dr' = e^{cp} X; dr, q and du (stored after S's update)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = acc_row(gid, e), il = cw + acc_col(x, tig, e);
        const float drp = xc[x][e] * ls[tl * LF + il];
        const float rv = rs[tl * LF + il], kv = ks[tl * LF + il];
        du[2 * x + (e & 1)] = fmaf(rv * kv, vdy[e >> 1], du[2 * x + (e & 1)]);
        ac[x][e] = fmaf(us[il] * kv, vdy[e >> 1], drp);  // dr
        xc[x][e] = rv * drp;                               // q
      }

    // S <- e^{L} (S + k~ᵀ v)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int t = 8 * kk + tig;
      const FragA fk(kt[t * LF + cw + gid], kt[t * LF + cw + gid + 8],
                     kt[(t + 4) * LF + cw + gid],
                     kt[(t + 4) * LF + cw + gid + 8]);
      const float* v0 = vs + t * LF + gid;
#pragma unroll
      for (int n = 0; n < NK; n += 4)
        mma3x4(st[n], fk, FragB(v0[8 * n], v0[4 * LF + 8 * n]), st[n + 1], fk,
               FragB(v0[8 * n + 8], v0[4 * LF + 8 * n + 8]), st[n + 2], fk,
               FragB(v0[8 * n + 16], v0[4 * LF + 8 * n + 16]), st[n + 3], fk,
               FragB(v0[8 * n + 24], v0[4 * LF + 8 * n + 24]));
    }
    const float d0 = decay[cw + gid], d1 = decay[cw + gid + 8];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      st[n][0] *= d0;
      st[n][1] *= d0;
      st[n][2] *= d1;
      st[n][3] *= d1;
    }
    const int t0 = c * CHUNK + gid;  // rows t0 and t0 + 8
    const int i0 = cw + 2 * tig;
    if (dr) {
      float* o = dr + (long long)t0 * hd.to[0] + i0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf, o += 8 * hd.to[0])
        if (t0 + 8 * hf < T)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            o[8 * x] = ac[x][2 * hf];
            o[8 * x + 1] = ac[x][2 * hf + 1];
          }
    }
    if (dlw) {  // q_t, t >= 1
      float* o = dlw + (long long)t0 * hd.to[3] + i0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf, o += 8 * hd.to[3])
        if (t0 + 8 * hf < T && t0 + 8 * hf > 0)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            o[8 * x] = xc[x][2 * hf];
            o[8 * x + 1] = xc[x][2 * hf + 1];
          }
    }
    __syncthreads();
  }
  if (staging) return;

  // S is S_{T-1}: P_fin = Σ_j ds_fin S_{T-1} into dlw's row 0
  if (dlw != nullptr && T > 0) {
    float pf[2] = {0.0f, 0.0f};
    if (a.ds_fin != nullptr)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pf[e >> 1] = fmaf(a.ds_fin[so + (e >> 1) * 8 * D + 8 * n + (e & 1)],
                            st[n][e], pf[e >> 1]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      pf[hf] += __shfl_xor_sync(FULL, pf[hf], 1);
      pf[hf] += __shfl_xor_sync(FULL, pf[hf], 2);
    }
    if (tig == 0) {
      dlw[cw + gid] = pf[0];
      dlw[cw + gid + 8] = pf[1];
    }
  }
  if (a.du_part != nullptr) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      du[x] += __shfl_xor_sync(FULL, du[x], 4);
      du[x] += __shfl_xor_sync(FULL, du[x], 8);
      du[x] += __shfl_xor_sync(FULL, du[x], 16);
    }
    if (gid == 0)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          a.du_part[(long long)hd.bh * D + cw + 8 * x + 2 * tig + q] =
              du[2 * x + q];
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse sweep: dk, dlw, ds0 (rows warps) and dv (cols warps)
// ---------------------------------------------------------------------------

// a block per (b, h): 4 rows warps (16 channels each), 4 cols warps (16
// value columns each), 4 staging warps
struct RevLayout : Ring {
  static constexpr int NT = 3 * NP;
  // after the ring, two of each (by step parity): r~, k~, k ⊙ e^{L-cum}, e^{-cum},
  // e^{L-cum} (one block of 5 tiles), q [16][LF], e^{L} [D], the staging
  // warps' bonus sums [4][16], triu_{+1}(v dyᵀ) and triu_{+1}(k~ r~ᵀ)
  // [16][LA], vdy [16]; then k ⊙ dk' [16][LF]; dS at a chunk's end, two
  // [D][LS] (the rows warps write it for the cols warps' next step; a row
  // stride of 76 keeps the cols warps' B loads off each other's banks); u
  static constexpr int DER = 3 * STAGE, RT = 0, KT = TILE, KE = 2 * TILE;
  static constexpr int EMC = 3 * TILE, ELC = 4 * TILE, DSIZE = 5 * TILE;
  static constexpr int Q = DER + 2 * DSIZE, DECAY = Q + 2 * TILE;
  static constexpr int BSUM = DECAY + 2 * D;
  static constexpr int AV = BSUM + 2 * 4 * CHUNK, AK = AV + 2 * CHUNK * LA;
  static constexpr int VDY = AK + 2 * CHUNK * LA, KDK = VDY + 2 * CHUNK;
  static constexpr int LS = D + 12;
  static constexpr int DS = KDK + TILE, US = DS + 2 * D * LS;
  static constexpr size_t bytes() { return sizeof(float) * (US + D); }
};

// a staging thread's 8 q_t of chunk c from dlw's rows (rows past T and row
// 0, which holds P_fin, as 0): channel p % 64, rows 8 (p / 64) + j
__device__ __forceinline__ void rev_load_q(const float* dlw, long long tq,
                                           int T, int c, int p,
                                           float (&qv)[HALF]) {
  const int r0 = c * CHUNK + (p >> 6) * HALF;
  const float* g = dlw + (long long)r0 * tq + (p & 63);
#pragma unroll
  for (int j = 0; j < HALF; ++j, g += tq)
    qv[j] = dlw != nullptr && r0 + j < T && r0 + j > 0 ? *g : 0.0f;
}

// step's chunk c: r~, k~, k ⊙ e^{L-cum}, e^{-cum}, e^{L-cum}, e^{L}, each
// row's bonus Σ_i r_i u_i k_i (per staging warp), q (loaded by
// rev_load_q); then triu_{+1}(v dyᵀ) with vdy (staging warps 0, 1: a tile
// each) and triu_{+1}(k~ r~ᵀ) (2, 3)
__device__ __forceinline__ void rev_prep(float* sm, const float* us,
                                         const float (&qv)[HALF], int step,
                                         int p) {
  using L = RevLayout;
  const float* s = sm + (step % 3) * L::STAGE;
  float* der = sm + L::DER + (step & 1) * L::DSIZE;
  const int ch = item_channel(p);
  const bool upper = p & 16;
  const int o = (upper ? HALF * LF : 0) + ch;
  const float uu = us[ch];
  float lv[HALF], rv[HALF], kv[HALF], cum[HALF], prev[HALF], bp[HALF];
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    lv[j] = s[L::LWS + o + j * LF];
    rv[j] = s[o + j * LF];
    kv[j] = s[L::K + o + j * LF];
  }
  const float tot = half_prefix(lv, cum, prev, upper);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float em = exp2f(-cum[j]), el = exp2f(tot - cum[j]);
    bp[j] = rv[j] * uu * kv[j];
    der[L::RT + o + j * LF] = rv[j] * exp2f(prev[j]);
    der[L::KT + o + j * LF] = kv[j] * em;
    der[L::KE + o + j * LF] = kv[j] * el;
    der[L::EMC + o + j * LF] = em;
    der[L::ELC + o + j * LF] = el;
  }
  if (!upper) sm[L::DECAY + (step & 1) * D + ch] = exp2f(tot);
  const int lane = p & 31;
  const float sum = half_warp_sum8(bp, lane);
  if ((lane & 1) == 0)
    sm[L::BSUM + (step & 1) * 4 * CHUNK + (p >> 5) * CHUNK +
       (upper ? HALF : 0) + ((lane >> 1) & 7)] = sum;
  {
    float* q = sm + L::Q + (step & 1) * L::TILE + (p >> 6) * HALF * LF +
               (p & 63);
#pragma unroll
    for (int j = 0; j < HALF; ++j) q[j * LF] = qv[j];
  }
  prep_sync();  // r~ and k~ of every channel
  const int pw = p >> 5, x = pw & 1, gid = (lane >> 2), tig = lane & 3;
  float acc[4];
  if (pw < 2) {
    pqt_tile(s + L::V, s + L::Y, x, gid, tig, acc);
    store_tri(sm + L::AV + (step & 1) * CHUNK * LA,
              sm + L::VDY + (step & 1) * CHUNK, acc, x, gid, tig, false);
  } else {
    pqt_tile(der + L::KT, der + L::RT, x, gid, tig, acc);
    store_tri(sm + L::AK + (step & 1) * CHUNK * LA, nullptr, acc, x, gid, tig,
              false);
  }
}

// a rows warp's dS rows into dS's tile [D][LS]
__device__ __forceinline__ void publish_ds(float* dst, const float (&ds)[NK][4],
                                           int cw, int gid, int tig) {
  constexpr int LS = RevLayout::LS;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(dst + (cw + gid + 8 * hf) * LS + 8 * n +
                                 2 * tig) =
          make_float2(ds[n][2 * hf], ds[n][2 * hf + 1]);
}

__global__ void __launch_bounds__(RevLayout::NT, 1)
    wkv6_bwd_rev_kernel(Args a) {
  using L = RevLayout;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* us = sm + L::US;
  float* kdk = sm + L::KDK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool rows = warp < 4, cols = warp >= 4 && warp < 8;
  const bool staging = warp >= 8;
  const int p = tid - 256;  // index among the staging threads
  const Head hd(a);
  const int T = a.T, nc = (T + CHUNK - 1) / CHUNK;
  float* dk = hd.o[1];
  float* dv = hd.o[2];
  float* dlw = hd.o[3];
  for (int i = tid; i < D; i += L::NT) us[i] = a.u[(long long)hd.h * D + i];

  // a rows warp's 16 rows of dS, ds[n][e] = dS[cw + acc_row][acc_col(n,
  // .)], published each step in dS's tile for the cols warps (the cols
  // warps' 16 value columns start at cw too)
  const int cw = GROUP * (warp & 3);
  float ds[NK][4];
  const long long so =
      (long long)hd.bh * D * D + (long long)(cw + gid) * D + 2 * tig;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[n][e] = !rows || a.ds_fin == nullptr
                     ? 0.0f
                     : a.ds_fin[so + (e >> 1) * 8 * D + 8 * n + (e & 1)];
  if (rows) publish_ds(sm + L::DS, ds, cw, gid, tig);
  // dlw: a rows lane per channel (lanes 0 .. 15), P from P_fin in row 0
  const bool scan = rows && dlw != nullptr && lane < GROUP;
  float P = scan && T > 0 ? dlw[cw + lane] : 0.0f;
  __syncthreads();  // u

  // the staging warps keep step s + 2 in flight and prepare s + 1 while
  // the others work on step s (chunk nc - 1 - s): one block barrier a step
  float qv[HALF];
  if (staging) {
    if (nc > 0) stage_chunk(sm, hd, T, nc - 1, p);
    cp_async_commit();
    if (nc > 1) stage_chunk(sm + L::STAGE, hd, T, nc - 2, p);
    cp_async_commit();
    rev_load_q(dlw, hd.to[3], T, nc - 1, p, qv);
    cp_async_wait_prior();
    prep_sync();
    if (nc > 0) rev_prep(sm, us, qv, 0, p);
  }
  __syncthreads();
  for (int s = 0; s < nc; ++s) {
    const int c = nc - 1 - s;
    if (staging) {
      if (s + 2 < nc)
        stage_chunk(sm + ((s + 2) % 3) * L::STAGE, hd, T, c - 2, p);
      cp_async_commit();
      rev_load_q(dlw, hd.to[3], T, c - 1, p, qv);  // in flight meanwhile
      cp_async_wait_prior();
      prep_sync();
      if (s + 1 < nc) rev_prep(sm, us, qv, s + 1, p);
      __syncthreads();
      continue;
    }
    const float* rs = sm + (s % 3) * L::STAGE;
    const float* ks = rs + L::K;
    const float* ls = rs + L::LWS;
    const float* vs = rs + L::V;
    const float* ys = rs + L::Y;
    const float* der = sm + L::DER + (s & 1) * L::DSIZE;
    const float* rt = der + L::RT;
    const float* decay = sm + L::DECAY + (s & 1) * D;
    const int t0 = c * CHUNK;
    const int n_rows = min(CHUNK, T - t0);

    if (rows) {  // dS for every output, dv's too
      const float* emc = der + L::EMC;
      const float* elc = der + L::ELC;
      const float* Ab = sm + L::AV + (s & 1) * CHUNK * LA;
      const float* vdyb = sm + L::VDY + (s & 1) * CHUNK;
      // X1 = v dSᵀ (t, the warp's channels), four accumulators
      float xq[4][2][4], xc[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) xq[q][x][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 v0 =
            *reinterpret_cast<const float2*>(vs + gid * LF + 8 * n + 2 * tig);
        const float2 v1 = *reinterpret_cast<const float2*>(
            vs + (gid + 8) * LF + 8 * n + 2 * tig);
        const FragA fv(v0.x, v1.x, v0.y, v1.y);
        mma3x2(xq[n & 3][0], fv, FragB(ds[n][0], ds[n][1]), xq[n & 3][1], fv,
               FragB(ds[n][2], ds[n][3]));
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xc[x][e] =
              (xq[0][x][e] + xq[1][x][e]) + (xq[2][x][e] + xq[3][x][e]);
      const float vdy[2] = {vdyb[gid], vdyb[gid + 8]};
      // X2 = triu_{+1}(v dyᵀ) r~
      float x2[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) x2[x][e] = 0.0f;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const FragA fa = tri_frag(Ab, x, gid, tig);
        const float* rr = rt + (8 * x + 2 * tig) * LF + cw + gid;
        mma3x2(x2[0], fa, FragB(rr[0], rr[LF]), x2[1], fa,
               FragB(rr[8], rr[LF + 8]));
      }

      // dk' = e^{L-cum} X1 + e^{-cum} X2; dk (stored at the step's end);
      // k ⊙ dk' for dlw
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ti = acc_row(gid, e) * LF + cw + acc_col(x, tig, e);
          const float dkp = fmaf(elc[ti], xc[x][e], emc[ti] * x2[x][e]);
          xc[x][e] = fmaf(us[cw + acc_col(x, tig, e)] * rs[ti], vdy[e >> 1],
                          dkp);
          x2[x][e] = ks[ti] * dkp;
        }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kdk[acc_row(gid, e) * LF + cw + acc_col(x, tig, e)] = x2[x][e];

      // dS <- e^{L} dS + r~ᵀ dy
      const float d0 = decay[cw + gid], d1 = decay[cw + gid + 8];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        ds[n][0] *= d0;
        ds[n][1] *= d0;
        ds[n][2] *= d1;
        ds[n][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int t = 8 * kk + tig;
        const FragA fr(rt[t * LF + cw + gid], rt[t * LF + cw + gid + 8],
                       rt[(t + 4) * LF + cw + gid],
                       rt[(t + 4) * LF + cw + gid + 8]);
        const float* y0 = ys + t * LF + gid;
#pragma unroll
        for (int n = 0; n < NK; n += 4)
          mma3x4(ds[n], fr, FragB(y0[8 * n], y0[4 * LF + 8 * n]), ds[n + 1],
                 fr, FragB(y0[8 * n + 8], y0[4 * LF + 8 * n + 8]), ds[n + 2],
                 fr, FragB(y0[8 * n + 16], y0[4 * LF + 8 * n + 16]), ds[n + 3],
                 fr, FragB(y0[8 * n + 24], y0[4 * LF + 8 * n + 24]));
      }
      publish_ds(sm + L::DS + ((s + 1) & 1) * D * L::LS, ds, cw, gid, tig);

      // dlw_t = P_t - k_t dk'_t, P_{t-1} = dlw_t + q_t, the rows in reverse
      // (rows past T carry k = 0 and q = 0: P goes through them unchanged)
      __syncwarp();
      if (scan) {
        const float* q = sm + L::Q + (s & 1) * L::TILE + cw + lane;
        float kd[CHUNK], lv[CHUNK], qv[CHUNK];
#pragma unroll
        for (int tt = 0; tt < CHUNK; ++tt) {
          kd[tt] = kdk[tt * LF + cw + lane];
          lv[tt] = ls[tt * LF + cw + lane];
          qv[tt] = q[tt * LF];
        }
#pragma unroll
        for (int tt = CHUNK - 1; tt >= 0; --tt) {
          const float g = P - kd[tt];
          P = g + qv[tt];
          kd[tt] = (lv[tt] >= LOG_W_MIN && lv[tt] <= 0.0f) ? g : 0.0f;
        }
        float* o = dlw + (long long)t0 * hd.to[3] + cw + lane;
#pragma unroll
        for (int tt = 0; tt < CHUNK; ++tt, o += hd.to[3])
          if (tt < n_rows) *o = kd[tt];
      }
      if (dk) {
        float* o = dk + (long long)(t0 + gid) * hd.to[1] + cw + 2 * tig;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf, o += 8 * hd.to[1])
          if (gid + 8 * hf < n_rows)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              o[8 * x] = xc[x][2 * hf];
              o[8 * x + 1] = xc[x][2 * hf + 1];
            }
      }
    } else if (cols && dv != nullptr) {
      const float* ke = der + L::KE;
      const float* bsum = sm + L::BSUM + (s & 1) * 4 * CHUNK;
      float bonus[2] = {0.0f, 0.0f};  // rows gid, gid + 8
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        bonus[0] += bsum[w * CHUNK + gid];
        bonus[1] += bsum[w * CHUNK + gid + 8];
      }
      const float* Ab = sm + L::AK + (s & 1) * CHUNK * LA;
      // V = (k ⊙ e^{L-cum}) dS (t, the warp's columns), dS from the rows
      // warps' tile, four accumulators
      const float* db = sm + L::DS + (s & 1) * D * L::LS + cw + gid;
      float vq[4][2][4], vc[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) vq[q][x][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 e0 =
            *reinterpret_cast<const float2*>(ke + gid * LF + 8 * n + 2 * tig);
        const float2 e1 = *reinterpret_cast<const float2*>(
            ke + (gid + 8) * LF + 8 * n + 2 * tig);
        const FragA fe(e0.x, e1.x, e0.y, e1.y);
        const float* d0 = db + (8 * n + 2 * tig) * L::LS;
        mma3x2(vq[n & 3][0], fe, FragB(d0[0], d0[L::LS]), vq[n & 3][1], fe,
               FragB(d0[8], d0[L::LS + 8]));
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vc[x][e] =
              (vq[0][x][e] + vq[1][x][e]) + (vq[2][x][e] + vq[3][x][e]);
      // V += triu_{+1}(k~ r~ᵀ) dy
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const FragA fa = tri_frag(Ab, x, gid, tig);
        const float* yr = ys + (8 * x + 2 * tig) * LF + cw + gid;
        mma3x2(vc[0], fa, FragB(yr[0], yr[LF]), vc[1], fa,
               FragB(yr[8], yr[LF + 8]));
      }
      // dv = V + bonus dy (stored at the step's end)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vc[x][e] = fmaf(bonus[e >> 1],
                          ys[acc_row(gid, e) * LF + cw + acc_col(x, tig, e)],
                          vc[x][e]);

      float* o = dv + (long long)(t0 + gid) * hd.to[2] + cw + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf, o += 8 * hd.to[2])
        if (gid + 8 * hf < n_rows)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            o[8 * x] = vc[x][2 * hf];
            o[8 * x + 1] = vc[x][2 * hf + 1];
          }
    }
    __syncthreads();
  }
  if (rows && a.ds0 != nullptr)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a.ds0[so + (e >> 1) * 8 * D + 8 * n + (e & 1)] = ds[n][e];
}

bool aligned16(const float* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

int launch_fwd(const Args& a, int BH, cudaStream_t st) {
  using L = FwdLayout;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes());
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_fwd_kernel<<<BH, L::NT, L::bytes(), st>>>(a);
  return (int)cudaGetLastError();
}

int launch_rev(const Args& a, int BH, cudaStream_t st) {
  using L = RevLayout;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_rev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes());
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_rev_kernel<<<BH, L::NT, L::bytes(), st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernels wkv6_bwd_launch launches for these outputs (each flag
// nonzero where the output is asked for): bit 0 wkv6_bwd_fwd_kernel, where
// dr, dlw or du is; bit 1 wkv6_bwd_rev_kernel, where dk, dv, dlw or ds0 is.
extern "C" int wkv6_bwd_kernels(int dr, int dk, int dv, int dlw, int du,
                                int ds0) {
  return ((dr || dlw || du) ? 1 : 0) | ((dk || dv || dlw || ds0) ? 2 : 0);
}

// r, k, v, lw, dy: (B, H, T, D) float32 with D contiguous, 16-byte aligned
// bases and (b, h, t) strides; dr, dk, dv, dlw: (B, H, T, D) float32 with
// D contiguous, or null (not computed).  st holds the (b, h, t, d) element
// strides of r, k, v, lw, dy, dr, dk, dv, dlw, 4 per tensor in that order
// (the stride of a dimension of size 1 is ignored; a null output's are not
// read).  u: (H, D); s0, ds_fin (null: zeros) and ds0 (null: not
// computed): (B, H, D, D) contiguous; du_part (null: not computed):
// (B, H, D), each (b, h)'s share of du.  Launches the kernels of
// wkv6_bwd_kernels, wkv6_bwd_fwd_kernel first.  Returns a cudaError_t:
// cudaErrorInvalidValue for D != 64, a negative size, D not contiguous or
// an input not 16-byte aligned.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* lw, const float* dy,
                               const float* u, const float* s0,
                               const float* ds_fin, float* dr, float* dk,
                               float* dv, float* dlw, float* du_part,
                               float* ds0, int B, int H, int T, int Dh,
                               const long long* st, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || H < 0 || T < 0 || Dh != D) return bad;
  const int BH = B * H;
  if (BH == 0) return 0;
  Args a;
  const float* const ins[NIN] = {r, k, lw, v, dy};
  const int in_st[NIN] = {0, 1, 3, 2, 4};  // where each input's strides are
  float* const outs[4] = {dr, dk, dv, dlw};
  const int size[3] = {B, H, T};
  for (int x = 0; x < NIN; ++x) {
    const long long* s = st + 4 * in_st[x];
    if (s[3] != 1) return bad;
    a.in[x] = ins[x];
    for (int d = 0; d < 3; ++d) a.si[x][d] = size[d] > 1 ? s[d] : 0;
    if (!aligned16(ins[x], a.si[x])) return bad;
  }
  for (int x = 0; x < 4; ++x) {
    const long long* s = st + 4 * (NIN + x);
    a.out[x] = outs[x];
    for (int d = 0; d < 3; ++d) a.so[x][d] = size[d] > 1 ? s[d] : 0;
    if (outs[x] != nullptr && s[3] != 1) return bad;
  }
  a.u = u;
  a.s0 = s0;
  a.ds_fin = ds_fin;
  a.du_part = du_part;
  a.ds0 = ds0;
  a.H = H;
  a.T = T;
  cudaStream_t s = (cudaStream_t)stream;
  const int run = wkv6_bwd_kernels(dr != nullptr, dk != nullptr, dv != nullptr,
                                   dlw != nullptr, du_part != nullptr,
                                   ds0 != nullptr);
  if (run & 1) {
    const int e = launch_fwd(a, BH, s);
    if (e != 0) return e;
  }
  return run & 2 ? launch_rev(a, BH, s) : 0;
}
