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
// wrapper: no atomics, so two runs give the same bits.  The kernels above
// are built for D = 64 (RWKV_HEAD_DIM, every registry model's); the
// wrapper zero-pads a smaller D.
//
// Above D = 64 ("wide", section 3 below): the block above keeps a (b, h)'s
// D x D state on chip -- 64 KB at D = 128, 256 KB at 256, more than a
// block holds.  Column j of S evolves alone in the forward sweep and of
// dS in the reverse one, so a block owns 16 value columns J of a (b, h)
// and carries S[:, J] or dS[:, J] in registers over all its channels: 8
// warps, each the 16 channels 128 s + 16 warp .. of every 128-channel
// slice s, the slices staged in turn through a two-item cp.async ring
// (at D <= 128 two blocks share an SM).  A block holds up to 16 slices
// (2,048 channels); a wider head takes channel passes.  The
// same chunk-16 formulas with every sum over the value columns taken over
// J only: dr, dk, dlw (its P_fin and q, so its own suffix sums) and du
// are each group's partials, written to scratch; dv, a sum over the
// channels, is whole in a block (the warps' partials of (k e^{L-cum}) dS,
// k~ r~ᵀ and the bonus added in warp order through shared memory), or a
// channel pass's partial.  wkv6_bwd_wide_fwd_kernel and
// wkv6_bwd_wide_rev_kernel run the two sweeps; wkv6_bwd_wide_reduce_kernel
// adds the partials in group (pass) order.  The wrapper zero-pads D
// above 64 to a multiple of 4.  The partials are 3 B·H·T·D floats for
// each of the D / 16 groups (0.5 GB at (2, 20, 1024, 128)), a size that
// grows as D²; past WB_SCRATCH_CAP floats (1 GiB) the groups run in
// batches, each batch's sweeps then its sum, which continues the
// previous batches' sums from the outputs in the same order: the same
// bits as one batch, scratch bounded by the cap or one group's partials.
// r, k, lw are staged again by each group's block from L2.
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

// ---------------------------------------------------------------------------
// 3. D > 64 ("wide"): the value columns split across blocks
// ---------------------------------------------------------------------------

// Column j of S and of dS is a closed recurrence in both sweeps, so a block
// owns 16 value columns J of one (b, h) and carries S[:, J] (forward sweep)
// or dS[:, J] (reverse sweep) over all of its channels: 8 warps, each the
// 16 channels 128 s + 16 warp .. + 15 of every 128-channel slice s, the
// slices staged in turn through a two-item cp.async ring (item = chunk,
// slice): the next item lands while this one computes.  At D <= 128 (one
// slice) each sweep's shared memory fits two blocks on an SM, so its 8
// warps are not alone there.  A block holds up to
// WB_MAX_SLICES slices (2,048 channels); a wider head takes channel passes
// (blocks), each over its own channels.  What sums over the value columns
// -- dr, dk, dlw (q and P_fin with it) and du -- each block writes as its
// group's partial; dv, which sums over the channels, each block forms
// whole (the warps' partials added in warp order through shared memory),
// or, with channel passes, as its pass's partial.  A last launch
// (wkv6_bwd_wide_reduce_kernel) adds the partials in group (pass) order:
// no atomics, two runs the same bits.  Every product is 3xTF32 mma.sync.
constexpr int WB_SLICE = 128;          // channels of a staged slice
constexpr int WB_WARPS = 8;            // 16 channels of each slice a warp
constexpr int WB_NT = 32 * WB_WARPS;
constexpr int WB_COLS = 16;            // value columns a block
constexpr int WB_MAX_SLICES = 16;      // channels a block: 2,048
constexpr int WB_STAGES = 2;
constexpr int WB_LD = WB_SLICE + 8;    // row stride of a slice tile
constexpr int WB_LV = WB_COLS + 8;     // row stride of a 16-column tile
constexpr int WB_TILE = CHUNK * WB_LD;
// a ring item: r, k, lw rows of the slice, then its e^{L} (by channel)
constexpr int WB_STAGE = 3 * WB_TILE + WB_SLICE;
constexpr int WB_VBUF = 2 * CHUNK * WB_LV;  // a chunk's v and dy (J)
// floats of group partials a call's scratch holds at most, unless one
// group's alone need more: past it the groups run in batches
constexpr long long WB_SCRATCH_CAP = 1LL << 28;

struct WideArgs {
  const float* in[NIN];  // r, k, lw, v, dy: (B, H, T, D) through strides
  long long si[NIN][3];
  const float* u;        // (H, D)
  const float* s0;       // (B, H, D, D) contiguous, or null (zeros)
  const float* ds_fin;   // (B, H, D, D) contiguous, or null (zeros)
  float* dv;             // (B, H, T, D) through sdv (one channel pass), or null
  long long sdv[3];
  float* ds0;            // (B, H, D, D) contiguous, or null
  // partials, each (groups or passes, B, H, T, D) contiguous, or null:
  // dr's and dk's, q then dlw's (row 0: P_fin's), dv's (channel passes)
  float* drp;
  float* dkp;
  float* qp;
  float* dvp;
  float* dup;  // (G, B, H, D) du's, or null
  int H, T, D;
  int g0;      // the batch's first value column group (blockIdx.y = 0)
};

// per block: (b, h), the first value column, the first channel
struct WideBlock {
  long long b;
  int h, bh, jb, cb;
  __device__ __forceinline__ WideBlock(const WideArgs& a) {
    bh = blockIdx.x;
    b = bh / a.H;
    h = bh % a.H;
    jb = (a.g0 + blockIdx.y) * WB_COLS;
    cb = blockIdx.z * WB_MAX_SLICES * WB_SLICE;
  }
  // offset of (t, channel ch) in a (groups, B, H, T, D) partial's group g
  // (of the batch)
  __device__ __forceinline__ long long part(const WideArgs& a, int g, int t,
                                            int ch) const {
    return (((long long)g * gridDim.x + bh) * a.T + t) * a.D + ch;
  }
};

// ring item it = (chunk c, slice s): r, k, lw rows c·16 .. + 15 at the
// slice's channels into a stage and, with slice 0, the chunk's v and dy at
// the block's columns into vbuf[c % 3]; rows past T and channels past D
// are zeros
__device__ __forceinline__ void wb_stage(float* stg, float* vbuf,
                                         const WideArgs& a,
                                         const WideBlock& w, int c, int s) {
  constexpr int PR = WB_SLICE / 4;  // 16-byte pieces of a row
  const int t0 = c * CHUNK, c0 = w.cb + s * WB_SLICE;
  const int xs[3] = {0, 1, 2};  // r, k, lw
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float* g = a.in[xs[x]] + w.b * a.si[xs[x]][0] + w.h * a.si[xs[x]][1];
#pragma unroll
    for (int e = threadIdx.x; e < CHUNK * PR; e += WB_NT) {
      const int t = e / PR, p = 4 * (e % PR);
      const bool ok = t0 + t < a.T && c0 + p < a.D;
      cp_async16(stg + x * WB_TILE + t * WB_LD + p,
                 g + (ok ? (long long)(t0 + t) * a.si[xs[x]][2] + c0 + p : 0),
                 ok);
    }
  }
  if (s == 0 && threadIdx.x < 2 * CHUNK * 4) {
    const int x = threadIdx.x < CHUNK * 4 ? 3 : 4;  // v, dy
    const int e = threadIdx.x % (CHUNK * 4), t = e / 4, p = 4 * (e % 4);
    const bool ok = t0 + t < a.T && w.jb + p < a.D;
    const float* g = a.in[x] + w.b * a.si[x][0] + w.h * a.si[x][1];
    cp_async16(vbuf + (c % 3) * WB_VBUF + (x - 3) * CHUNK * WB_LV + t * WB_LV + p,
               g + (ok ? (long long)(t0 + t) * a.si[x][2] + w.jb + p : 0), ok);
  }
  cp_async_commit();
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a warp's 16 channels of the staged slice, two lanes a channel (rows 0 ..
// 7 and 8 .. 15): half_prefix over the lane's 8 rows of lw
__device__ __forceinline__ float wb_prefix(const float* ls, int ch, int r0,
                                           int lane, float (&cum)[HALF],
                                           float (&prev)[HALF]) {
  float lv[HALF];
#pragma unroll
  for (int t = 0; t < HALF; ++t) lv[t] = ls[(r0 + t) * WB_LD + ch];
  return half_prefix(lv, cum, prev, lane & 16);
}

// the chunk's 16 x 16 product P Qᵀ over the block's 16 columns (P, Q
// tiles of row stride WB_LV) as two accumulator tiles (columns 8x ..), the
// k index permuted as pqt_tile's
__device__ __forceinline__ void wb_pqt(const float* P, const float* Q,
                                       int gid, int tig, float (&acc)[2][4]) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float2 p0 =
        *reinterpret_cast<const float2*>(P + gid * WB_LV + 8 * n + 2 * tig);
    const float2 p1 = *reinterpret_cast<const float2*>(
        P + (gid + 8) * WB_LV + 8 * n + 2 * tig);
    const FragA fa(p0.x, p1.x, p0.y, p1.y);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float2 q0 = *reinterpret_cast<const float2*>(
          Q + (8 * x + gid) * WB_LV + 8 * n + 2 * tig);
      mma3(acc[x], fa, FragB(q0.x, q0.y));
    }
  }
}

// v_t · dy_t over the block's columns for rows gid and gid + 8
__device__ __forceinline__ void wb_vdy(const float* vs, const float* ys,
                                       int gid, float (&vdy)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float x = 0.0f;
#pragma unroll
    for (int j = 0; j < WB_COLS; ++j)
      x = fmaf(vs[(gid + 8 * hf) * WB_LV + j], ys[(gid + 8 * hf) * WB_LV + j], x);
    vdy[hf] = x;
  }
}

// 3a. the forward sweep: each group's partial dr and q (in dlw's partial
// rows; row 0 P_fin), du's partial
template <int NSL>
__global__ void __launch_bounds__(WB_NT, NSL == 1 ? 2 : 1)
    wkv6_bwd_wide_fwd_kernel(WideArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* vbuf = sm + WB_STAGES * WB_STAGE;      // [3][v, dy][16][LV]
  float* kts = vbuf + 3 * WB_VBUF;             // k~ of the item [16][LD]
  float* us = kts + WB_TILE;                   // u [NSL·128]
  float* dus = us + NSL * WB_SLICE;            // du's partial [NSL·128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const WideBlock w(a);
  const int T = a.T, nc = (T + CHUNK - 1) / CHUNK;
  for (int i = tid; i < NSL * WB_SLICE; i += WB_NT) {
    const int ch = w.cb + i;
    us[i] = ch < a.D ? a.u[(long long)w.h * a.D + ch] : 0.0f;
    dus[i] = 0.0f;
  }

  // st[s][n][e] = S[cb + 128 s + 16 warp + gid + 8 (e >> 1)][jb + 8 n + 2
  // tig + (e & 1)]: rows are channels, as the D = 64 kernel's
  float st[NSL][2][4];
  const long long sbase = (long long)w.bh * a.D * a.D;
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = w.cb + WB_SLICE * s + 16 * warp + gid + 8 * (e >> 1);
        const int col = w.jb + 8 * n + 2 * tig + (e & 1);
        st[s][n][e] = a.s0 != nullptr && ch < a.D && col < a.D
                          ? a.s0[sbase + (long long)ch * a.D + col]
                          : 0.0f;
      }

  const int items = nc * NSL;
#pragma unroll
  for (int i = 0; i < WB_STAGES - 1; ++i) {
    if (i < items)
      wb_stage(sm + i * WB_STAGE, vbuf, a, w, i / NSL, i % NSL);
    else
      cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    const float* vs = vbuf + (c % 3) * WB_VBUF;
    const float* ys = vs + CHUNK * WB_LV;
    const int t0 = c * CHUNK;
    float ay[2][4], vdy[2];
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      const int it = c * NSL + s;
      cp_async_wait_n<WB_STAGES - 2>();
      __syncthreads();  // item it has landed; item it - 1 is done with
      {
        const int nx = it + WB_STAGES - 1;
        if (nx < items)
          wb_stage(sm + (nx % WB_STAGES) * WB_STAGE, vbuf, a, w, nx / NSL,
                   nx % NSL);
        else
          cp_async_commit();
      }
      if (s == 0) {
        // tril_{-1}(dy vᵀ) over the block's columns, and vdy
        wb_pqt(ys, vs, gid, tig, ay);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(acc_col(x, tig, e) < acc_row(gid, e))) ay[x][e] = 0.0f;
        wb_vdy(vs, ys, gid, vdy);
      }
      float* rs = sm + (it % WB_STAGES) * WB_STAGE;
      const float* ks = rs + WB_TILE;
      float* ls = rs + 2 * WB_TILE;
      float* decay = rs + 3 * WB_TILE;
      const int cw = 16 * warp;  // the warp's channels in the slice

      // a. prefixes: e^{cp} over lw, k~, e^{L}
      {
        const int ch = cw + (lane & 15), r0 = HALF * (lane >> 4);
        float cum[HALF], prev[HALF];
        const float tot = wb_prefix(ls, ch, r0, lane, cum, prev);
#pragma unroll
        for (int t = 0; t < HALF; ++t) {
          const int o = (r0 + t) * WB_LD + ch;
          ls[o] = exp2f(prev[t]);
          kts[o] = ks[o] * exp2f(-cum[t]);
        }
        if (lane >> 4) decay[ch] = exp2f(tot);
      }
      __syncwarp();

      // b. X = dy Sᵀ + tril_{-1}(dy vᵀ) k~ (t, the warp's channels)
      float xc[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) xc[x][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 y0 =
            *reinterpret_cast<const float2*>(ys + gid * WB_LV + 8 * n + 2 * tig);
        const float2 y1 = *reinterpret_cast<const float2*>(
            ys + (gid + 8) * WB_LV + 8 * n + 2 * tig);
        const FragA fy(y0.x, y1.x, y0.y, y1.y);
        mma3x2(xc[0], fy, FragB(st[s][n][0], st[s][n][1]), xc[1], fy,
               FragB(st[s][n][2], st[s][n][3]));
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const FragA fa(ay[x][0], ay[x][2], ay[x][1], ay[x][3]);
        const float* kr = kts + (8 * x + 2 * tig) * WB_LD + cw + gid;
        mma3x2(xc[0], fa, FragB(kr[0], kr[WB_LD]), xc[1], fa,
               FragB(kr[8], kr[WB_LD + 8]));
      }

      // c. dr' = e^{cp} X; dr's and q's partials; du's
      float dr[2][4];
      float du[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // channels 8x + 2 tig + q
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = acc_row(gid, e) * WB_LD + cw + acc_col(x, tig, e);
          const float drp = xc[x][e] * ls[o];
          const float rv = rs[o], kv = ks[o];
          du[2 * x + (e & 1)] =
              fmaf(rv * kv, vdy[e >> 1], du[2 * x + (e & 1)]);
          dr[x][e] = fmaf(us[WB_SLICE * s + cw + acc_col(x, tig, e)] * kv,
                          vdy[e >> 1], drp);
          xc[x][e] = rv * drp;  // q
        }
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
            dus[WB_SLICE * s + cw + 8 * x + 2 * tig + q] += du[2 * x + q];
      const int chg = w.cb + WB_SLICE * s + cw;  // the warp's first channel
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + gid + 8 * hf;
        if (t >= T) continue;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int ch = chg + 8 * x + 2 * tig;  // D is even: ch + 1 < D too
          if (ch >= a.D) continue;
          const long long o = w.part(a, blockIdx.y, t, ch);
          if (a.drp != nullptr)
            *reinterpret_cast<float2*>(a.drp + o) =
                make_float2(dr[x][2 * hf], dr[x][2 * hf + 1]);
          if (a.qp != nullptr && t > 0)
            *reinterpret_cast<float2*>(a.qp + o) =
                make_float2(xc[x][2 * hf], xc[x][2 * hf + 1]);
        }
      }

      // d. S <- e^{L} (S + k~ᵀ v)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int t = 8 * kk + tig;
        const FragA fk(kts[t * WB_LD + cw + gid], kts[t * WB_LD + cw + gid + 8],
                       kts[(t + 4) * WB_LD + cw + gid],
                       kts[(t + 4) * WB_LD + cw + gid + 8]);
        const float* v0 = vs + t * WB_LV + gid;
        mma3x2(st[s][0], fk, FragB(v0[0], v0[4 * WB_LV]), st[s][1], fk,
               FragB(v0[8], v0[4 * WB_LV + 8]));
      }
      const float d0 = decay[cw + gid], d1 = decay[cw + gid + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        st[s][n][0] *= d0;
        st[s][n][1] *= d0;
        st[s][n][2] *= d1;
        st[s][n][3] *= d1;
      }
      __syncwarp();  // k~ is read; the next item overwrites it
    }
  }

  // S is S_{T-1}: P_fin's partial Σ_{j in J} ds_fin S_{T-1} into q's row 0
  if (a.qp != nullptr && T > 0)
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      const int ch = w.cb + WB_SLICE * s + 16 * warp + gid;
      float pf[2] = {0.0f, 0.0f};
      if (a.ds_fin != nullptr)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = ch + 8 * (e >> 1);
            const int col = w.jb + 8 * n + 2 * tig + (e & 1);
            if (r < a.D && col < a.D)
              pf[e >> 1] =
                  fmaf(a.ds_fin[sbase + (long long)r * a.D + col], st[s][n][e],
                       pf[e >> 1]);
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        pf[hf] += __shfl_xor_sync(FULL, pf[hf], 1);
        pf[hf] += __shfl_xor_sync(FULL, pf[hf], 2);
      }
      if (tig == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (ch + 8 * hf < a.D)
            a.qp[w.part(a, blockIdx.y, 0, ch + 8 * hf)] = pf[hf];
    }
  if (a.dup != nullptr) {
    __syncthreads();
    for (int i = tid; i < NSL * WB_SLICE; i += WB_NT)
      if (w.cb + i < a.D)
        a.dup[((long long)blockIdx.y * gridDim.x + w.bh) * a.D + w.cb + i] =
            dus[i];
  }
}

// 3b. the reverse sweep: each group's partial dk and dlw (over q's rows),
// dv (whole, or its channel pass's partial), ds0 at the block's columns
template <int NSL>
__global__ void __launch_bounds__(WB_NT, NSL == 1 ? 2 : 1)
    wkv6_bwd_wide_rev_kernel(WideArgs a, int want_dk, int want_dlw) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* vbuf = sm + WB_STAGES * WB_STAGE;  // [3][v, dy][16][LV]
  float* der = vbuf + 3 * WB_VBUF;  // r~, k~ (then k ⊙ dk'), e^{-cum}, e^{L-cum}
  float* dsw = der + 4 * WB_TILE;   // each warp's dS [8][16][LV]
  float* bsum = dsw + WB_WARPS * CHUNK * WB_LV;  // [8][16]
  float* us = bsum + WB_WARPS * CHUNK;           // u [NSL·128]
  // the warps' chunk-end partials [8][4][32] go over the derived tiles,
  // which a chunk's end no longer reads
  float4* part = reinterpret_cast<float4*>(der);
  float* rt = der;
  float* kt = der + WB_TILE;
  float* kdk = kt;
  float* emc = der + 2 * WB_TILE;
  float* elc = der + 3 * WB_TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const WideBlock w(a);
  const int T = a.T, nc = (T + CHUNK - 1) / CHUNK;
  const int cw = 16 * warp;
  for (int i = tid; i < NSL * WB_SLICE; i += WB_NT) {
    const int ch = w.cb + i;
    us[i] = ch < a.D ? a.u[(long long)w.h * a.D + ch] : 0.0f;
  }

  float ds[NSL][2][4];
  const long long sbase = (long long)w.bh * a.D * a.D;
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = w.cb + WB_SLICE * s + cw + gid + 8 * (e >> 1);
        const int col = w.jb + 8 * n + 2 * tig + (e & 1);
        ds[s][n][e] = a.ds_fin != nullptr && ch < a.D && col < a.D
                          ? a.ds_fin[sbase + (long long)ch * a.D + col]
                          : 0.0f;
      }
  // dlw: lanes 0 .. 15 a channel each, P from P_fin's partial in q's row 0
  const bool scan = want_dlw && lane < 16;
  float P[NSL];
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    const int ch = w.cb + WB_SLICE * s + cw + lane;
    P[s] = scan && T > 0 && ch < a.D ? a.qp[w.part(a, blockIdx.y, 0, ch)]
                                     : 0.0f;
  }
  __syncthreads();  // u

  const int items = nc * NSL;
#pragma unroll
  for (int i = 0; i < WB_STAGES - 1; ++i) {
    if (i < items)
      wb_stage(sm + i * WB_STAGE, vbuf, a, w, nc - 1 - i / NSL, i % NSL);
    else
      cp_async_commit();
  }
  for (int step = 0; step < nc; ++step) {
    const int c = nc - 1 - step;
    const float* vs = vbuf + (c % 3) * WB_VBUF;
    const float* ys = vs + CHUNK * WB_LV;
    const int t0 = c * CHUNK, n_rows = min(CHUNK, T - t0);
    float av[2][4], vdy[2];
    // the chunk's partial sums over the warp's channels: V = (k e^{L-cum})
    // dS (t, j), K = k~ r~ᵀ (t, s), the bonus Σ r u k of rows 8 (lane >>
    // 4) + t
    float vw[2][4], aw[2][4], bp[HALF];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) vw[x][e] = aw[x][e] = 0.0f;
#pragma unroll
    for (int t = 0; t < HALF; ++t) bp[t] = 0.0f;
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      const int it = step * NSL + s;
      cp_async_wait_n<WB_STAGES - 2>();
      __syncthreads();
      {
        const int nx = it + WB_STAGES - 1;
        if (nx < items)
          wb_stage(sm + (nx % WB_STAGES) * WB_STAGE, vbuf, a, w,
                   nc - 1 - nx / NSL, nx % NSL);
        else
          cp_async_commit();
      }
      if (s == 0) {
        // triu_{+1}(v dyᵀ) over the block's columns, and vdy
        wb_pqt(vs, ys, gid, tig, av);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(acc_col(x, tig, e) > acc_row(gid, e))) av[x][e] = 0.0f;
        wb_vdy(vs, ys, gid, vdy);
      }
      float* rs = sm + (it % WB_STAGES) * WB_STAGE;
      const float* ks = rs + WB_TILE;
      const float* ls = rs + 2 * WB_TILE;
      float* decay = rs + 3 * WB_TILE;

      // a. prefixes: r~, k~, k e^{L-cum}, e^{-cum}, e^{L-cum}, e^{L}; the
      //    bonus terms of the lane's rows
      {
        const int ch = cw + (lane & 15), r0 = HALF * (lane >> 4);
        const float uu = us[WB_SLICE * s + ch];
        float cum[HALF], prev[HALF];
        const float tot = wb_prefix(ls, ch, r0, lane, cum, prev);
#pragma unroll
        for (int t = 0; t < HALF; ++t) {
          const int o = (r0 + t) * WB_LD + ch;
          const float rv = rs[o], kv = ks[o];
          const float em = exp2f(-cum[t]), el = exp2f(tot - cum[t]);
          bp[t] = fmaf(rv * uu, kv, bp[t]);
          rt[o] = rv * exp2f(prev[t]);
          kt[o] = kv * em;
          emc[o] = em;
          elc[o] = el;
        }
        if (lane >> 4) decay[ch] = exp2f(tot);
      }
      // the warp's rows of dS at the chunk's end, for V
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(dsw + warp * CHUNK * WB_LV +
                                     (gid + 8 * hf) * WB_LV + 8 * n + 2 * tig) =
              make_float2(ds[s][n][2 * hf], ds[s][n][2 * hf + 1]);
      __syncwarp();

      // b. V += (k e^{L-cum}) dS and K += k~ r~ᵀ over the warp's channels
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int o0 = gid * WB_LD + cw + 8 * kk + tig, o1 = o0 + 8 * WB_LD;
        const FragA fe(ks[o0] * elc[o0], ks[o1] * elc[o1],
                       ks[o0 + 4] * elc[o0 + 4], ks[o1 + 4] * elc[o1 + 4]);
        const float* dw = dsw + warp * CHUNK * WB_LV + (8 * kk + tig) * WB_LV + gid;
        mma3x2(vw[0], fe, FragB(dw[0], dw[4 * WB_LV]), vw[1], fe,
               FragB(dw[8], dw[4 * WB_LV + 8]));
        const FragA fk(kt[o0], kt[o1], kt[o0 + 4], kt[o1 + 4]);
        mma3x2(aw[0], fk, FragB(rt[o0], rt[o0 + 4]), aw[1], fk,
               FragB(rt[o1], rt[o1 + 4]));
      }
      __syncwarp();  // k~ is read: k ⊙ dk' goes over it

      if (want_dk || want_dlw) {
        // c. X1 = v dSᵀ, X2 = triu_{+1}(v dyᵀ) r~ (t, the warp's channels)
        float x1[2][4], x2[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) x1[x][e] = x2[x][e] = 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 v0 = *reinterpret_cast<const float2*>(
              vs + gid * WB_LV + 8 * n + 2 * tig);
          const float2 v1 = *reinterpret_cast<const float2*>(
              vs + (gid + 8) * WB_LV + 8 * n + 2 * tig);
          const FragA fv(v0.x, v1.x, v0.y, v1.y);
          mma3x2(x1[0], fv, FragB(ds[s][n][0], ds[s][n][1]), x1[1], fv,
                 FragB(ds[s][n][2], ds[s][n][3]));
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const FragA fa(av[x][0], av[x][2], av[x][1], av[x][3]);
          const float* rr = rt + (8 * x + 2 * tig) * WB_LD + cw + gid;
          mma3x2(x2[0], fa, FragB(rr[0], rr[WB_LD]), x2[1], fa,
                 FragB(rr[8], rr[WB_LD + 8]));
        }
        // dk' = e^{L-cum} X1 + e^{-cum} X2; dk's partial; k ⊙ dk' for dlw
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = acc_row(gid, e) * WB_LD + cw + acc_col(x, tig, e);
            const float dkp = fmaf(elc[o], x1[x][e], emc[o] * x2[x][e]);
            x1[x][e] = fmaf(us[WB_SLICE * s + cw + acc_col(x, tig, e)] * rs[o],
                            vdy[e >> 1], dkp);
            kdk[o] = ks[o] * dkp;
          }
        const int chg = w.cb + WB_SLICE * s + cw;
        if (want_dk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int ch = chg + 8 * x + 2 * tig;
              if (gid + 8 * hf < n_rows && ch < a.D)
                *reinterpret_cast<float2*>(
                    a.dkp + w.part(a, blockIdx.y, t0 + gid + 8 * hf, ch)) =
                    make_float2(x1[x][2 * hf], x1[x][2 * hf + 1]);
            }
        __syncwarp();
        // dlw_t = P_t - k_t dk'_t, P_{t-1} = dlw_t + q_t, the rows in
        // reverse (rows past T carry k = 0 and q = 0)
        if (scan && chg + lane < a.D) {
          const int ch = chg + lane;
          float kd[CHUNK], qv[CHUNK];
#pragma unroll
          for (int t = 0; t < CHUNK; ++t) {
            kd[t] = kdk[t * WB_LD + cw + lane];
            qv[t] = t0 + t < T && t0 + t > 0
                        ? a.qp[w.part(a, blockIdx.y, t0 + t, ch)]
                        : 0.0f;
          }
#pragma unroll
          for (int t = CHUNK - 1; t >= 0; --t) {
            const float g = P[s] - kd[t];
            P[s] = g + qv[t];
            const float lv = ls[t * WB_LD + cw + lane];
            kd[t] = (lv >= LOG_W_MIN && lv <= 0.0f) ? g : 0.0f;
          }
#pragma unroll
          for (int t = 0; t < CHUNK; ++t)
            if (t < n_rows) a.qp[w.part(a, blockIdx.y, t0 + t, ch)] = kd[t];
        }
      }

      // d. dS <- e^{L} dS + r~ᵀ dy
      const float d0 = decay[cw + gid], d1 = decay[cw + gid + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        ds[s][n][0] *= d0;
        ds[s][n][1] *= d0;
        ds[s][n][2] *= d1;
        ds[s][n][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int t = 8 * kk + tig;
        const FragA fr(rt[t * WB_LD + cw + gid], rt[t * WB_LD + cw + gid + 8],
                       rt[(t + 4) * WB_LD + cw + gid],
                       rt[(t + 4) * WB_LD + cw + gid + 8]);
        const float* y0 = ys + t * WB_LV + gid;
        mma3x2(ds[s][0], fr, FragB(y0[0], y0[4 * WB_LV]), ds[s][1], fr,
               FragB(y0[8], y0[4 * WB_LV + 8]));
      }
      __syncwarp();  // the derived tiles are read; the next item rewrites them
    }

    // the warps' partial sums, added in warp order by warp 0: dv = V +
    // (triu_{+1}(K) + diag(bonus)) dy; the barrier holds them until every
    // warp is done with the derived tiles they go over
    __syncthreads();
    {
      const float sb = half_warp_sum8(bp, lane);
      if ((lane & 1) == 0)
        bsum[warp * CHUNK + 8 * (lane >> 4) + ((lane >> 1) & 7)] = sb;
    }
    float4* pw = part + warp * 4 * 32 + lane;
    pw[0] = make_float4(vw[0][0], vw[0][1], vw[0][2], vw[0][3]);
    pw[32] = make_float4(vw[1][0], vw[1][1], vw[1][2], vw[1][3]);
    pw[64] = make_float4(aw[0][0], aw[0][1], aw[0][2], aw[0][3]);
    pw[96] = make_float4(aw[1][0], aw[1][1], aw[1][2], aw[1][3]);
    __syncthreads();
    if (warp == 0 && (a.dv != nullptr || a.dvp != nullptr)) {
      float y[2][4], ac[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[x][e] = ac[x][e] = 0.0f;
      float bonus[2] = {0.0f, 0.0f};  // rows gid, gid + 8
      for (int wi = 0; wi < WB_WARPS; ++wi) {
        const float4* q = part + wi * 4 * 32 + lane;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float4 yv = q[32 * x], kv = q[64 + 32 * x];
          y[x][0] += yv.x;
          y[x][1] += yv.y;
          y[x][2] += yv.z;
          y[x][3] += yv.w;
          ac[x][0] += kv.x;
          ac[x][1] += kv.y;
          ac[x][2] += kv.z;
          ac[x][3] += kv.w;
        }
        bonus[0] += bsum[wi * CHUNK + gid];
        bonus[1] += bsum[wi * CHUNK + gid + 8];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = acc_row(gid, e), col = acc_col(x, tig, e);
          ac[x][e] = col > t ? ac[x][e] : col == t ? bonus[e >> 1] : 0.0f;
        }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const FragA fa(ac[x][0], ac[x][2], ac[x][1], ac[x][3]);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
          mma3(y[jn], fa,
               FragB(ys[(8 * x + 2 * tig) * WB_LV + 8 * jn + gid],
                     ys[(8 * x + 2 * tig + 1) * WB_LV + 8 * jn + gid]));
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = t0 + gid + 8 * hf, col = w.jb + 8 * jn + 2 * tig;
          if (t >= T || col >= a.D) continue;
          const float2 val = make_float2(y[jn][2 * hf], y[jn][2 * hf + 1]);
          if (a.dvp != nullptr)
            *reinterpret_cast<float2*>(a.dvp + w.part(a, blockIdx.z, t, col)) =
                val;
          else
            *reinterpret_cast<float2*>(
                a.dv + w.b * a.sdv[0] + w.h * a.sdv[1] + t * a.sdv[2] + col) =
                val;
        }
    }
  }
  if (a.ds0 != nullptr)
#pragma unroll
    for (int s = 0; s < NSL; ++s)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = w.cb + WB_SLICE * s + cw + gid + 8 * (e >> 1);
          const int col = w.jb + 8 * n + 2 * tig + (e & 1);
          if (ch < a.D && col < a.D)
            a.ds0[sbase + (long long)ch * a.D + col] = ds[s][n][e];
        }
}

// 3c. the partials added in group (pass) order: dr, dk, dlw at every (b,
// h, t, channel), du at every (b, h, channel), dv at every (b, h, t,
// column) when there were channel passes.  A batch after the first adds
// its G groups to what the outputs hold, the sum of the groups before it
// in the same order, so a sum's bits do not depend on the batches.
struct ReduceArgs {
  const float* drp;
  const float* dkp;
  const float* qp;
  const float* dvp;
  const float* dup;
  float* out[4];  // dr, dk, dv, dlw through their strides, or null
  long long so[4][3];
  float* du_part;  // (B, H, D)
  int H, T, D, G, passes;
  int first;       // the first batch: the outputs hold nothing yet
};

__global__ void __launch_bounds__(256) wkv6_bwd_wide_reduce_kernel(ReduceArgs a,
                                                                  long long BH) {
  const long long n = BH * a.T * a.D;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) {
    const int ch = (int)(e % a.D);
    const long long row = e / a.D;
    const int t = (int)(row % a.T);
    const long long bh = row / a.T;
    const long long b = bh / a.H, h = bh % a.H;
    const float* srcs[4] = {a.drp, a.dkp, a.dvp, a.qp};
    const int count[4] = {a.G, a.G, a.passes, a.G};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (a.out[x] == nullptr || srcs[x] == nullptr) continue;
      float* o = a.out[x] + b * a.so[x][0] + h * a.so[x][1] + t * a.so[x][2] + ch;
      const bool carry = !a.first && x != 2;  // dv's passes sum at once
      float acc = carry ? *o : srcs[x][e];
      for (int g = carry ? 0 : 1; g < count[x]; ++g) acc += srcs[x][g * n + e];
      *o = acc;
    }
  }
  if (a.dup != nullptr && e < BH * a.D) {
    float acc = a.first ? a.dup[e] : a.du_part[e];
    for (int g = a.first ? 1 : 0; g < a.G; ++g) acc += a.dup[g * BH * a.D + e];
    a.du_part[e] = acc;
  }
}

template <int NSL>
constexpr size_t wb_fwd_bytes() {
  return sizeof(float) * ((size_t)WB_STAGES * WB_STAGE + 3 * WB_VBUF +
                          WB_TILE + 2 * NSL * WB_SLICE);
}
template <int NSL>
constexpr size_t wb_rev_bytes() {
  static_assert(WB_WARPS * 4 * 32 * 4 <= 4 * WB_TILE, "the partials fit");
  return sizeof(float) *
         ((size_t)WB_STAGES * WB_STAGE + 3 * WB_VBUF + 4 * WB_TILE +
          WB_WARPS * CHUNK * WB_LV + WB_WARPS * CHUNK + NSL * WB_SLICE);
}

template <int NSL>
int launch_wide_sweeps(const WideArgs& a, dim3 grid, int run, int want_dk,
                       int want_dlw, cudaStream_t st) {
  if (run & 1) {
    auto k = wkv6_bwd_wide_fwd_kernel<NSL>;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wb_fwd_bytes<NSL>());
    if (err != cudaSuccess) return (int)err;
    k<<<grid, WB_NT, wb_fwd_bytes<NSL>(), st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (run & 2) {
    auto k = wkv6_bwd_wide_rev_kernel<NSL>;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wb_rev_bytes<NSL>());
    if (err != cudaSuccess) return (int)err;
    k<<<grid, WB_NT, wb_rev_bytes<NSL>(), st>>>(a, want_dk, want_dlw);
    return (int)cudaGetLastError();
  }
  return 0;
}

int launch_reduce_wide(const ReduceArgs& r, long long BH, cudaStream_t st) {
  const long long n = BH * r.T * r.D, m = BH * r.D;
  const long long top = n > m ? n : m;
  if (top == 0) return 0;
  wkv6_bwd_wide_reduce_kernel<<<(unsigned)((top + 255) / 256), 256, 0, st>>>(
      r, BH);
  return (int)cudaGetLastError();
}

// the value column groups and channel passes of head dim D
int wide_groups(int D) { return (D + WB_COLS - 1) / WB_COLS; }
int wide_passes(int D) {
  return (D + WB_MAX_SLICES * WB_SLICE - 1) / (WB_MAX_SLICES * WB_SLICE);
}

// The scratch of a wide call: `group` floats for each value column group
// of a batch (its partial dr, dk and q / dlw, B·H·T·D each where asked
// for, and du's B·H·D) and `fixed` for the whole call (with channel
// passes each pass's partial dv)
struct WideScratch {
  long long group, fixed;
  WideScratch(long long B, long long H, long long T, int Dh, int dr, int dk,
              int dv, int dlw, int du) {
    const long long n = B * H * T * Dh;
    group = n * ((dr ? 1 : 0) + (dk ? 1 : 0) + (dlw ? 1 : 0)) +
            (du ? B * H * Dh : 0);
    fixed = dv && wide_passes(Dh) > 1 ? wide_passes(Dh) * n : 0;
  }
  // groups a batch takes when `floats` of scratch are given: the G groups
  // in as few batches as fit, evened out; 0 when not even one group fits
  int batch(int Dh, long long floats) const {
    const int G = wide_groups(Dh);
    if (floats < fixed + group) return 0;
    if (group == 0) return G;
    const long long fit = (floats - fixed) / group;
    const int most = fit < G ? (int)fit : G;
    const int batches = (G + most - 1) / most;
    return (G + batches - 1) / batches;
  }
};
}  // namespace

// Floats of scratch wkv6_bwd_launch is given at head dim Dh > 64 for these
// outputs (each flag nonzero where it is asked for): every group's
// partials, or where those pass WB_SCRATCH_CAP the fewest even batches of
// groups within it (one group at the least), and the channel passes' dv.
// 0 at Dh = 64.
extern "C" long long wkv6_bwd_scratch_floats(int B, int H, int T, int Dh,
                                             int dr, int dk, int dv, int dlw,
                                             int du) {
  if (Dh <= D) return 0;
  const WideScratch w(B, H, T, Dh, dr, dk, dv, dlw, du);
  const long long all = w.group * wide_groups(Dh);
  const long long room = all < WB_SCRATCH_CAP ? all : WB_SCRATCH_CAP;
  return w.group * w.batch(Dh, w.fixed + (room > w.group ? room : w.group)) +
         w.fixed;
}

// The launches wkv6_bwd_launch makes at head dim Dh for these outputs,
// given `scratch_floats` of scratch, into launches[0 .. 2].  Dh = 64:
// wkv6_bwd_fwd_kernel once where dr, dlw or du is asked for,
// wkv6_bwd_rev_kernel once where dk, dv, dlw or ds0 is, no third.  Dh >
// 64: wkv6_bwd_wide_fwd_kernel and wkv6_bwd_wide_rev_kernel likewise once
// a batch of groups, wkv6_bwd_wide_reduce_kernel once a batch where dr,
// dk, dlw or du is, else once where dv is with channel passes (Dh >
// 2,048).  Returns cudaErrorInvalidValue where the scratch holds less
// than one group's partials, else 0.
extern "C" int wkv6_bwd_kernels(int B, int H, int T, int Dh, int dr, int dk,
                                int dv, int dlw, int du, int ds0,
                                long long scratch_floats, int* launches) {
  const int fwd = dr || dlw || du, rev = dk || dv || dlw || ds0;
  launches[0] = fwd;
  launches[1] = rev;
  launches[2] = 0;
  if (Dh <= D) return 0;
  const WideScratch w(B, H, T, Dh, dr, dk, dv, dlw, du);
  const int per = w.batch(Dh, scratch_floats);
  if (per == 0) return (int)cudaErrorInvalidValue;
  const int batches = (wide_groups(Dh) + per - 1) / per;
  launches[0] *= batches;
  launches[1] *= batches;
  launches[2] = (dr || dk || dlw || du) ? batches
                : (dv && wide_passes(Dh) > 1) ? 1 : 0;
  return 0;
}

// r, k, v, lw, dy: (B, H, T, D) float32 with D contiguous, 16-byte aligned
// bases and (b, h, t) strides; dr, dk, dv, dlw: (B, H, T, D) float32 with
// D contiguous, or null (not computed).  st holds the (b, h, t, d) element
// strides of r, k, v, lw, dy, dr, dk, dv, dlw, 4 per tensor in that order
// (the stride of a dimension of size 1 is ignored; a null output's are not
// read).  u: (H, D); s0, ds_fin (null: zeros) and ds0 (null: not
// computed): (B, H, D, D) contiguous; du_part (null: not computed):
// (B, H, D), each (b, h)'s share of du.  D = 64 (wkv6_bwd_fwd_kernel, then
// wkv6_bwd_rev_kernel) or any D > 64 that is a multiple of 4 (the wide
// sweeps, then the sum of their partials, batch by batch of groups), with
// `scratch` a float32 buffer of `scratch_floats`: what
// wkv6_bwd_scratch_floats gives, or any size that holds one group's
// partials, the groups then batched to fit (null at D = 64).  Launches
// the kernels wkv6_bwd_kernels counts.  Returns a cudaError_t:
// cudaErrorInvalidValue for another D, a negative size, D not contiguous,
// an input not 16-byte aligned or too little scratch.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* lw, const float* dy,
                               const float* u, const float* s0,
                               const float* ds_fin, float* dr, float* dk,
                               float* dv, float* dlw, float* du_part,
                               float* ds0, float* scratch,
                               long long scratch_floats, int B, int H, int T,
                               int Dh, const long long* st, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || H < 0 || T < 0 || (Dh != D && (Dh < D || Dh % 4 != 0)))
    return bad;
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
  int runs[3];
  if (wkv6_bwd_kernels(B, H, T, Dh, dr != nullptr, dk != nullptr,
                       dv != nullptr, dlw != nullptr, du_part != nullptr,
                       ds0 != nullptr, scratch_floats, runs) != 0)
    return bad;
  const int run = (runs[0] ? 1 : 0) | (runs[1] ? 2 : 0) | (runs[2] ? 4 : 0);
  if (Dh == D) {
    if (run & 1) {
      const int e = launch_fwd(a, BH, s);
      if (e != 0) return e;
    }
    return run & 2 ? launch_rev(a, BH, s) : 0;
  }

  // D > 64: carve the partials; each batch of groups runs the sweeps,
  // then adds its partials to the outputs
  const int G = wide_groups(Dh), P = wide_passes(Dh);
  const WideScratch need(B, H, T, Dh, dr != nullptr, dk != nullptr,
                         dv != nullptr, dlw != nullptr, du_part != nullptr);
  const int per = need.batch(Dh, scratch_floats);
  if (per > 65535 || P > 65535) return bad;
  const long long n = (long long)BH * T * Dh;
  float* next = scratch;
  auto carve = [&](bool on, long long floats) {
    float* ptr = on ? next : nullptr;
    if (on) next += floats;
    return ptr;
  };
  WideArgs w;
  for (int x = 0; x < NIN; ++x) {
    w.in[x] = a.in[x];
    for (int d = 0; d < 3; ++d) w.si[x][d] = a.si[x][d];
  }
  w.u = u;
  w.s0 = s0;
  w.ds_fin = ds_fin;
  w.dv = P == 1 ? dv : nullptr;
  for (int d = 0; d < 3; ++d) w.sdv[d] = a.so[2][d];
  w.ds0 = ds0;
  w.drp = carve(dr != nullptr, per * n);
  w.dkp = carve(dk != nullptr, per * n);
  w.qp = carve(dlw != nullptr, per * n);
  w.dup = carve(du_part != nullptr, (long long)per * BH * Dh);
  w.dvp = carve(dv != nullptr && P > 1, P * n);
  w.H = H;
  w.T = T;
  w.D = Dh;
  const int slices = (Dh + WB_SLICE - 1) / WB_SLICE;
  const int dk_on = dk != nullptr, dlw_on = dlw != nullptr;
  const bool sums = dr != nullptr || dk != nullptr || dlw != nullptr ||
                    du_part != nullptr;
  for (int g0 = 0; g0 < G; g0 += per) {
    const int groups = G - g0 < per ? G - g0 : per;
    const bool last = g0 + groups == G;
    w.g0 = g0;
    const dim3 grid(BH, groups, P);
    int e;
    if (slices <= 1)
      e = launch_wide_sweeps<1>(w, grid, run, dk_on, dlw_on, s);
    else if (slices <= 2)
      e = launch_wide_sweeps<2>(w, grid, run, dk_on, dlw_on, s);
    else if (slices <= 3)
      e = launch_wide_sweeps<3>(w, grid, run, dk_on, dlw_on, s);
    else if (slices <= 4)
      e = launch_wide_sweeps<4>(w, grid, run, dk_on, dlw_on, s);
    else if (slices <= 8)
      e = launch_wide_sweeps<8>(w, grid, run, dk_on, dlw_on, s);
    else
      e = launch_wide_sweeps<16>(w, grid, run, dk_on, dlw_on, s);
    if (e != 0) return e;
    if (!(run & 4) || !(sums || last)) continue;
    ReduceArgs ra;
    ra.drp = w.drp;
    ra.dkp = w.dkp;
    ra.qp = w.qp;
    ra.dvp = last ? w.dvp : nullptr;  // dv's passes, once every group is in
    ra.dup = w.dup;
    for (int x = 0; x < 4; ++x) {
      ra.out[x] = outs[x];
      for (int d = 0; d < 3; ++d) ra.so[x][d] = a.so[x][d];
    }
    if (P == 1) ra.out[2] = nullptr;  // dv is whole already
    ra.du_part = du_part;
    ra.H = H;
    ra.T = T;
    ra.D = Dh;
    ra.G = groups;
    ra.passes = P;
    ra.first = g0 == 0;
    e = launch_reduce_wide(ra, BH, s);
    if (e != 0) return e;
  }
  return 0;
}
