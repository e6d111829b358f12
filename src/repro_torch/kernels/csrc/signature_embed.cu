// Signature embedding: out[i] = sum_j w_j * f32(table[ids[i, j]]), the k
// probes of a multi-hash embedding combined in probe order.
//
// Replaces the Pallas TPU kernel signature_embed_pallas
// (src/repro/kernels/signature/signature.py, body _sig_embed_kernel).  On
// the TPU the row ids are scalar-prefetched into SMEM and each (row, probe)
// grid step DMAs one (1, D) table row into VMEM, the k probes of a row
// accumulating into a VMEM-resident output row.  On Hopper one warp owns
// one output row: lanes 0..k-1 load the row's ids and the weights once
// into shared memory, where the whole warp reads them; the lanes then
// cover D with 16-byte loads (4 floats or 8 bf16 values; scalar loads when
// D or an address does not allow that) and keep the sums in registers.  Within each element the
// probes are added in order, starting from 0.0f, with __fmul_rn and
// __fadd_rn (never a fused multiply-add), so the result equals the plain
// version (kernels/signature/ref.py) bit for bit.  A bf16 table is widened
// to float, and the float sum is rounded once with __float2bfloat16_rn,
// as the reference's astype does.  No atomics, no host synchronization.
//
// An id outside [0, V) makes its row NaN instead of reading outside the
// table (the dispatcher's ids come from multi_hash_ids and are always in
// range).
//
// Bound on the H100: bytes moved — each distinct table row the batch
// probes (D x the element size), the ids, the weights and the output,
// over 3.35 TB/s.  A probe is a random row, so the table reads miss L2 on
// a large table; a warp keeps k independent 16-byte loads in flight per
// lane and chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_PROBES = 32;

template <typename T>
struct Vec16;  // 16 bytes of T

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(x[e]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// VEC: 16-byte chunks (D a multiple of Vec16<T>::N, pointers aligned) or
// one element per lane step
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
signature_embed_kernel(const T* __restrict__ table,
                       const int32_t* __restrict__ ids,
                       const float* __restrict__ weights,
                       T* __restrict__ out, int n, int k, int D, int V) {
  __shared__ int32_t s_id[WARPS_PER_BLOCK][MAX_PROBES];
  __shared__ float s_w[WARPS_PER_BLOCK][MAX_PROBES];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (row >= n) return;  // the whole warp: one warp, one row

  // the row's ids and the weights, read once by lanes 0..k-1
  bool bad = false;
  if (lane < k) {
    const int32_t id = ids[(size_t)row * k + lane];
    s_id[warp][lane] = id;
    s_w[warp][lane] = weights[lane];
    bad = id < 0 || id >= V;
  }
  __syncwarp();  // the shared writes are seen by the whole warp
  bad = __any_sync(0xFFFFFFFFu, bad);
  T* o = out + (size_t)row * D;
  if (bad) {
    for (int d = lane; d < D; d += 32) narrow(o + d, __int_as_float(0x7FC00000));
    return;
  }
  const int32_t* rid = s_id[warp];
  const float* rw = s_w[warp];

  if (VEC) {
    constexpr int W = Vec16<T>::N;
    for (int c = lane * W; c < D; c += 32 * W) {
      float acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float w = rw[j];
        float x[W];
        Vec16<T>::load(table + (size_t)rid[j] * D + c, x);
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w, x[e]));
      }
      Vec16<T>::store(o + c, acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(rw[j], widen(table[(size_t)rid[j] * D + d])));
      narrow(o + d, acc);
    }
  }
}

template <typename T>
int launch(const void* table, const int32_t* ids, const float* weights,
           void* out, int n, int k, int D, int V, int vec,
           cudaStream_t stream) {
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const dim3 threads(WARPS_PER_BLOCK * 32);
  if (vec) {
    signature_embed_kernel<T, true><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), ids, weights, static_cast<T*>(out), n,
        k, D, V);
  } else {
    signature_embed_kernel<T, false><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), ids, weights, static_cast<T*>(out), n,
        k, D, V);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 table and output, 1 = bfloat16 table and output.
// vec: 1 when D is a multiple of 16 bytes' worth of elements and the
// table and output pointers are 16-byte aligned.  Returns a cudaError_t
// (cudaErrorInvalidValue for k outside [1, 32] or an unknown dtype).
extern "C" int signature_embed_launch(const void* table, const int32_t* ids,
                                      const float* weights, void* out, int n,
                                      int k, int D, int V, int dtype, int vec,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > MAX_PROBES || D < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(table, ids, weights, out, n, k, D, V, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, ids, weights, out, n, k, D, V, vec, s);
  return (int)cudaErrorInvalidValue;
}
