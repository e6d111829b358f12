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
// three chunk products on the MXU.  On Hopper one thread block owns one
// (b, h) and loops over the chunks in order, so nothing is carried between
// blocks.  The same chunk-16 factorization (cum = in-chunk inclusive
// log-decay prefix, cum_prev = cum - lw):
//
//     r~ = r ⊙ exp(cum_prev),   k~ = k ⊙ exp(-cum)
//     y  = r~ S + tril_{-1}(r~ k~ᵀ) v + (Σ_i r_i u_i k_i) v
//     S <- exp(cum_last) ⊙ (S + k~ᵀ v)
//
// Chunk size is capped by float32 range: exp(-cum) reaches e^{16·3.5} =
// e^56 at chunk 16; at chunk 32 the exponent passes 88 and float32
// overflows.  The kernel keeps chunk 16 and the clamp to [-3.5, 0], as the
// reference does (lw > 0 comes out as 0, lw < -3.5 as -3.5; NaN stays NaN).
//
// Layout: 4·D threads (D ∈ {16, 32, 64}); thread (g, j) = (tid / D,
// tid % D) owns state column j, rows g·D/4 .. g·D/4 + D/4 - 1, in
// registers, and output rows g·4 .. g·4 + 3 of column j.  Per chunk the
// r, k, v, lw rows are staged in shared memory (rows past T are identity
// rows r = k = v = 0, lw = 0, never read from or written to device memory:
// a decode step, T = 1, moves one row), the prefixes are computed per
// channel, then A = tril_{-1}(r~ k~ᵀ), y and the state update.  A shared
// copy of S (16 KB at D = 64) feeds the r~ S product; 42.7 KB of static
// shared memory in all at D = 64.  Products use explicit fmaf (the build's
// -fmad=false forbids only contraction the compiler would choose).
//
// Bound on the H100: bytes — r, k, v, lw read once, y written once (5 ·
// B·H·T·D floats), u, s0 and S (2 · B·H·D² floats) — over 3.35 TB/s; the
// chunk products (~2·B·H·T·D·(2D + 2·16) FLOP) are below the float32 peak
// of 67 TFLOP/s at the model's shapes.  This first version computes from
// shared memory with one block per (b, h): a batch-1 prefill (40 heads)
// fills 40 of the 132 SMs.  Splitting the value columns across blocks,
// tensor-core MMA for the 16 × 64 products and async copies are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;
constexpr float LOG_W_MIN = -3.5f;

template <int D>
struct Smem {
  float r[CHUNK][D];
  float k[CHUNK][D];
  float v[CHUNK][D];
  float lw[CHUNK][D];         // clamped
  float rt[CHUNK][D + 1];     // r~; rows padded against bank conflicts
  float kt[CHUNK][D + 1];     // k~
  float S[D][D];              // the state at the chunk's start
  float A[CHUNK][CHUNK];      // tril_{-1}(r~ k~ᵀ)
  float diag[CHUNK];          // Σ_i r_i u_i k_i per row
  float decay[D];             // exp(cum_last)
  float u[D];
};

__device__ __forceinline__ float clamp_lw(float x) {
  // jnp.clip order: max with the floor, then min with 0 (NaN propagates)
  x = x < LOG_W_MIN ? LOG_W_MIN : x;
  return x > 0.0f ? 0.0f : x;
}

template <int D>
__global__ void __launch_bounds__(4 * D)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int H, int T) {
  constexpr int NT = 4 * D;
  constexpr int RPT = D / 4;      // state rows a thread owns
  constexpr int YPT = CHUNK / 4;  // output rows a thread owns
  __shared__ Smem<D> sm;

  const int tid = threadIdx.x;
  const int j = tid % D;
  const int g = tid / D;
  const int bh = blockIdx.x;
  const size_t seq = (size_t)bh * T * D;  // this (b, h)'s rows
  const size_t st = (size_t)bh * D * D;   // this (b, h)'s state

  float s[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = g * RPT + q;
    s[q] = s0 != nullptr ? s0[st + (size_t)i * D + j] : 0.0f;
    sm.S[i][j] = s[q];
  }
  if (tid < D) sm.u[tid] = u[(size_t)(bh % H) * D + tid];

  const int nc = (T + CHUNK - 1) / CHUNK;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CHUNK;
    const int n = min(CHUNK, T - t0);  // valid rows of this chunk

    // 1. stage the chunk; rows past T are identity rows
    for (int e = tid; e < CHUNK * D; e += NT) {
      const int t = e / D, i = e % D;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, lv = 0.0f;
      if (t < n) {
        const size_t o = seq + (size_t)(t0 + t) * D + i;
        rv = r[o];
        kv = k[o];
        vv = v[o];
        lv = clamp_lw(lw[o]);
      }
      sm.r[t][i] = rv;
      sm.k[t][i] = kv;
      sm.v[t][i] = vv;
      sm.lw[t][i] = lv;
    }
    __syncthreads();

    // 2. per channel: the in-chunk log-decay prefixes, r~, k~, exp(cum_last)
    if (tid < D) {
      const int i = tid;
      float cum = 0.0f;
      for (int t = 0; t < CHUNK; ++t) {
        const float l = sm.lw[t][i];
        cum = cum + l;                // inclusive prefix
        const float prev = cum - l;   // exclusive, as the reference forms it
        sm.rt[t][i] = sm.r[t][i] * expf(prev);
        sm.kt[t][i] = sm.k[t][i] * expf(-cum);
      }
      sm.decay[i] = expf(cum);
    }
    __syncthreads();

    // 3. A = tril_{-1}(r~ k~ᵀ) and the bonus coefficient of each row
    for (int e = tid; e < CHUNK * CHUNK + CHUNK; e += NT) {
      float acc = 0.0f;
      if (e < CHUNK * CHUNK) {
        const int t = e / CHUNK, a = e % CHUNK;
        if (a < t)
          for (int i = 0; i < D; ++i) acc = fmaf(sm.rt[t][i], sm.kt[a][i], acc);
        sm.A[t][a] = acc;
      } else {
        const int t = e - CHUNK * CHUNK;
        for (int i = 0; i < D; ++i) acc = fmaf(sm.r[t][i] * sm.u[i], sm.k[t][i], acc);
        sm.diag[t] = acc;
      }
    }
    __syncthreads();

    // 4. y rows g*YPT ..: r~ S + A v + bonus · v
    float acc[YPT];
#pragma unroll
    for (int q = 0; q < YPT; ++q) acc[q] = 0.0f;
    for (int i = 0; i < D; ++i) {
      const float sij = sm.S[i][j];
#pragma unroll
      for (int q = 0; q < YPT; ++q) acc[q] = fmaf(sm.rt[g * YPT + q][i], sij, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < YPT; ++q) {
      const int t = g * YPT + q;
      float intra = 0.0f;
      for (int a = 0; a < t; ++a) intra = fmaf(sm.A[t][a], sm.v[a][j], intra);
      const float out = acc[q] + intra + sm.diag[t] * sm.v[t][j];
      if (t < n) y[seq + (size_t)(t0 + t) * D + j] = out;
    }

    // 5. S <- exp(cum_last) ⊙ (S + k~ᵀ v), kept in registers
    float kv[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) kv[q] = 0.0f;
    for (int a = 0; a < CHUNK; ++a) {
      const float va = sm.v[a][j];
#pragma unroll
      for (int q = 0; q < RPT; ++q) kv[q] = fmaf(sm.kt[a][g * RPT + q], va, kv[q]);
    }
    __syncthreads();  // every thread has read the old S for its y rows
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = g * RPT + q;
      s[q] = sm.decay[i] * (s[q] + kv[q]);
      sm.S[i][j] = s[q];
    }
    __syncthreads();  // S whole again; the chunk buffers are free
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q)
    s_out[st + (size_t)(g * RPT + q) * D + j] = s[q];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* s_out, int BH,
           int H, int T, cudaStream_t stream) {
  wkv6_kernel<D><<<BH, 4 * D, 0, stream>>>(r, k, v, lw, u, s0, y, s_out, H, T);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, lw, y: (B, H, T, D) float32, contiguous; u: (H, D); s0 (may be
// null for a zero state) and s_out: (B, H, D, D).  Returns a cudaError_t
// (cudaErrorInvalidValue for D outside {16, 32, 64} or a negative size).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* lw, const float* u, const float* s0,
                           float* y, float* s_out, int B, int H, int T, int D,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || H < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int BH = B * H;
  if (BH == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(r, k, v, lw, u, s0, y, s_out, BH, H, T, s);
    case 32: return launch<32>(r, k, v, lw, u, s0, y, s_out, BH, H, T, s);
    case 64: return launch<64>(r, k, v, lw, u, s0, y, s_out, BH, H, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
