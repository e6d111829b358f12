// Flash attention: causal / sliding-window grouped-query attention with an
// online softmax.  For q (B, H, S, D), k and v (B, Hkv, S, D), query head h
// reads KV head h / (H / Hkv), and per query row q_pos
//
//     o = Σ_k softmax_k(scale · q·k) v,   over k_pos < S, k_pos <= q_pos
//                                          (causal), k_pos > q_pos - window
//
// in float32, the output in q's dtype (float32 or bf16).
//
// Replaces the Pallas TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py, body flash_attention_kernel).  On the
// TPU the grid is (B, H, S/bq, S/bk) with the KV axis sequential, the
// running max, denominator and accumulator in VMEM scratch, and every KV
// block computed, masked or not.  On Hopper one 128-thread block owns one
// (b·H + h, 64-row query tile) -- the flattened (b, h) in gridDim.x, since
// gridDim.y caps at 65,535 -- and loops over 64-row KV tiles itself, so
// nothing is carried between blocks.  The loop runs only over the tiles
// the causal limit and the window can reach (a skipped tile is all masked,
// and adds nothing to the running state on the TPU either).  What is kept
// of the reference's arithmetic: float32 running max m, denominator l and
// accumulator; masked scores -1e30 and masked weights 0; alpha = 0 while
// m is still -1e30 (a fully masked prefix); the final divide by
// max(l, 1e-30).  The weights p stay float32 for the PV product.
//
// Layout: dynamic shared memory holds the query tile, a KV tile of K
// (reused for the 64 x 64 weights once the scores are in registers) and
// one of V, as float32 rows of DP + 4 floats (DP = D rounded up to 32; the
// padded columns are zeros and add nothing; the 4-float pad shifts rows by
// four banks, so the float4 reads below are conflict-free): 101,376 bytes
// at D = 128, two blocks to an SM.  Thread (ty, tx) = (tid / 8, tid % 8)
// owns query rows ty + 16 i (i < 4) -- score columns tx + 8 j (j < 8) and
// output columns 4 tx + 32 jj + e -- so a row's max and sum reduce over
// the 8 lanes of one warp with shuffles.  Tiles are staged with strided
// element loads (per-(b, h, s) strides, D contiguous), so the model passes
// its (B, S, H, hd) activations as transposed views without a copy.
// Products use explicit fmaf (the build's -fmad=false forbids only
// contraction the compiler would choose); expf and the divide are the
// accurate ones, to hold 2e-5 against the plain version.
//
// Bound on the H100: operations -- 4·B·H·D per visible (q, k) pair (about
// half of S² when causal) at 989 TFLOP/s of bf16 tensor-core peak -- above
// bytes (q, k, v read once, o written once) at 3.35 TB/s.  This first
// version computes on the CUDA cores (67 TFLOP/s float32) from shared
// memory with no prefetch of the next tile: tensor-core MMA (mma.sync or
// wgmma), TMA loads and a pipelined KV ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows of a block
constexpr int BK = 64;   // key rows of a tile
constexpr int NT = 128;  // threads: 16 row groups x 8 column groups
constexpr int LP = BK + 4;
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DP + 4) + cmax(BK * (DP + 4), BQ * LP) +
         (size_t)BK * (DP + 4);
}

// rows row0 .. row0 + 63 of one head into a tile of rows of DP + 4 floats;
// rows >= S and columns >= D are zeros
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int row0, int S, int D) {
  constexpr int LD = DP + 4;
#pragma unroll 8
  for (int it = 0; it < 64 * DP / NT; ++it) {
    const int e = it * NT + threadIdx.x;
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (row0 + r < S && d < D) x = widen(src[(long long)(row0 + r) * rs + d]);
    dst[r * LD + d] = x;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 2) flash_attention_kernel(Params p) {
  constexpr int LD = DP + 4;  // row stride of the q, k, v tiles
  constexpr int CJ = DP / 32; // float4 column groups of the output a thread owns
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
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  stage<T, DP>(qs, qg, p.sq[2], q0, p.S, p.D);

  // the keys any row of this tile can see
  int k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = min(p.S, q0 + BQ);
  if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  float acc[4][CJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    stage<T, DP>(ks, kg, p.sk[2], k0, p.S, p.D);
    stage<T, DP>(vs, vg, p.sv[2], k0, p.S, p.D);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // scale and mask; the running max over the 8 lanes of each row
    unsigned valid = 0u;
    float m_new[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool ok = kp < p.S;
        if (p.causal) ok = ok && kp <= qp;
        if (p.has_window) ok = ok && kp > qp - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : NEG;
        valid |= (ok ? 1u : 0u) << (i * 8 + j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      m_new[i] = fmaxf(m[i], mx);
    }
    __syncthreads();  // every thread is done with K: the weights go there

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pw =
            (valid >> (i * 8 + j)) & 1u ? expf(s[i][j] - m_new[i]) : 0.0f;
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
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * LD + 4 * tx + 32 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
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
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = og + (long long)row * p.so[2];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 32 * jj + e;
        if (d < p.D) narrow(orow + d, acc[i][jj][e] / denom);
      }
  }
}

template <typename T, int DP>
int launch(const Params& p, int BH, int nq, cudaStream_t stream) {
  const int bytes = (int)(sizeof(float) * smem_floats<DP>());
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<T, DP><<<dim3(BH, nq), NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int BH, int nq, cudaStream_t s) {
  if (p.D <= 32) return launch<T, 32>(p, BH, nq, s);
  if (p.D <= 64) return launch<T, 64>(p, BH, nq, s);
  if (p.D <= 96) return launch<T, 96>(p, BH, nq, s);
  return launch<T, 128>(p, BH, nq, s);
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D); element strides over (b, h, s),
// D contiguous; dtype 0 = float32, 1 = bf16 (all four tensors).  window is
// read when has_window is set.  Returns a cudaError_t
// (cudaErrorInvalidValue for D outside 1..128, H not a multiple of Hkv, or
// a grid the card cannot launch).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hkv, int S, int D, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sob, long long soh, long long sos, int causal,
    int has_window, int window, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 ||
      D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const long long BH = (long long)B * H;
  const int nq = (S + BQ - 1) / BQ;
  if (BH > 0x7fffffffLL || nq > 65535) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(p, (int)BH, nq, s)
                    : dispatch<__nv_bfloat16>(p, (int)BH, nq, s);
}
