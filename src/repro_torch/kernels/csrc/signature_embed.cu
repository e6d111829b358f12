// Signature embedding: out[i] = sum_j w_j * f32(table[h_j(sig[i])]), the k
// probes of a multi-hash embedding combined in probe order.
//
// Replaces the Pallas TPU kernel signature_embed_pallas
// (src/repro/kernels/signature/signature.py, body _sig_embed_kernel),
// together with the id hashing its wrapper runs in front of it
// (multi_hash_ids, src/repro/kernels/signature/ops.py).  On the TPU the row
// ids are scalar-prefetched into SMEM and each (row, probe) grid step DMAs
// one (1, D) table row into VMEM, the k probes of a row accumulating into
// a VMEM-resident output row.
//
// On Hopper one warp owns one output row.  Lanes 0..k-1 compute the row's
// k ids from its signature in registers -- h_j = mix64(sig, salt = 0x85EB
// (j + 1) + 17, bits = 31) % V, as repro_torch/core/signature.py's
// multi_hash_ids: the multiplies on uint32 (wrap-around), the shifts
// arithmetic on int32, and abs on uint32 (INT32_MIN & 0x7FFFFFFF = 0, as
// torch's abs wraps) -- and put them and the weights in shared memory,
// where the whole warp reads them.  A second instantiation takes the ids
// already hashed, (N, k) int32; an id outside [0, V) there makes its row
// NaN instead of reading outside the table.
//
// The lanes cover D with 16-byte loads (4 floats or 8 bf16 values; scalar
// loads when D or an address does not allow that).  A lane issues all of a
// step's loads -- GROUP_CHUNKS 16-byte chunks x GROUP_PROBES probes, 8 in
// flight, which at D = 512 float32 and k = 2 is the whole row -- before the
// adds, so the random table rows' latencies overlap.  Within each element
// the probes are added in order, starting from 0.0f, with __fmul_rn and
// __fadd_rn (never a fused multiply-add), so the result equals the plain
// version (kernels/signature/ref.py) bit for bit.  A bf16 table is widened
// to float, and the float sum is rounded once with __float2bfloat16_rn, as
// the reference's astype does.  No atomics, no host synchronization.
//
// Bound on the H100: bytes moved -- each distinct table row the batch
// probes (D x the element size), the signatures, the weights and the
// output, over 3.35 TB/s.  A probe is a random row, so the table reads
// miss L2 on a large table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_PROBES = 32;
constexpr int GROUP_CHUNKS = 4;  // 16-byte chunks a lane loads per step
constexpr int GROUP_PROBES = 2;  // probes a lane loads per step

// mix32 of repro_torch/core/hashing.py: the murmur3 finalizer on int32
__device__ __forceinline__ int32_t mix32(int32_t x, uint32_t salt) {
  int32_t h = x ^ (int32_t)(salt & 0x7FFFFFFFu);
  h ^= h >> 16;
  h = (int32_t)((uint32_t)h * 0x85EBCA6Bu);
  h ^= (h >> 13) & 0x0007FFFF;
  h = (int32_t)((uint32_t)h * 0xC2B2AE35u);
  h ^= (h >> 16) & 0x0000FFFF;
  return h;
}

// probe j's id of signature s in a table of V rows: multi_hash_ids
__device__ __forceinline__ int32_t probe_id(int32_t s, int j, uint32_t V) {
  const uint32_t salt = 0x85EBu * (uint32_t)(j + 1) + 17u;
  const int32_t h1 = mix32(s, salt);
  const int32_t h2 = mix32(h1 ^ 0x5BD1E995, salt ^ 0x27D4EB2Fu);
  const int32_t h = h1 ^ (int32_t)((uint32_t)h2 * 5u + 0x38495AB5u);
  const uint32_t a = (h < 0 ? 0u - (uint32_t)h : (uint32_t)h) & 0x7FFFFFFFu;
  return (int32_t)(a % V);
}

template <typename T>
struct Vec16;  // 16 bytes of T

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& v, float* x) {
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
// one element per lane step.  HASH: ids from the signatures, else from ids.
template <typename T, bool VEC, bool HASH>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
signature_embed_kernel(const T* __restrict__ table,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ sig,
                       const float* __restrict__ weights,
                       T* __restrict__ out, int n, int k, int D, int V) {
  __shared__ int32_t s_id[WARPS_PER_BLOCK][MAX_PROBES];
  __shared__ float s_w[WARPS_PER_BLOCK][MAX_PROBES];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (row >= n) return;  // the whole warp: one warp, one row

  // the row's ids and the weights, by lanes 0..k-1
  bool bad = false;
  if (HASH) {
    const int32_t s = sig[row];
    if (lane < k) s_id[warp][lane] = probe_id(s, lane, (uint32_t)V);
  } else if (lane < k) {
    const int32_t id = ids[(size_t)row * k + lane];
    s_id[warp][lane] = id;
    bad = id < 0 || id >= V;
  }
  if (lane < k) s_w[warp][lane] = weights[lane];
  __syncwarp();  // the shared writes are seen by the whole warp
  T* o = out + (size_t)row * D;
  if (!HASH && __any_sync(0xFFFFFFFFu, bad)) {
    for (int d = lane; d < D; d += 32) narrow(o + d, __int_as_float(0x7FC00000));
    return;
  }
  const int32_t* rid = s_id[warp];
  const float* rw = s_w[warp];

  if (VEC) {
    constexpr int W = Vec16<T>::N;
    const int chunks = D / W;
    for (int cb = 0; cb < chunks; cb += 32 * GROUP_CHUNKS) {
      float acc[GROUP_CHUNKS][W];
#pragma unroll
      for (int a = 0; a < GROUP_CHUNKS; ++a)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[a][e] = 0.0f;
      for (int j0 = 0; j0 < k; j0 += GROUP_PROBES) {
        uint4 raw[GROUP_CHUNKS][GROUP_PROBES];
#pragma unroll
        for (int b = 0; b < GROUP_PROBES; ++b) {
          if (j0 + b < k) {
            const uint4* src = reinterpret_cast<const uint4*>(
                table + (size_t)rid[j0 + b] * D);
#pragma unroll
            for (int a = 0; a < GROUP_CHUNKS; ++a) {
              const int c = cb + 32 * a + lane;
              if (c < chunks) raw[a][b] = __ldg(src + c);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < GROUP_PROBES; ++b) {
          if (j0 + b < k) {
            const float w = rw[j0 + b];
#pragma unroll
            for (int a = 0; a < GROUP_CHUNKS; ++a) {
              if (cb + 32 * a + lane < chunks) {
                float x[W];
                Vec16<T>::widen(raw[a][b], x);
#pragma unroll
                for (int e = 0; e < W; ++e)
                  acc[a][e] = __fadd_rn(acc[a][e], __fmul_rn(w, x[e]));
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < GROUP_CHUNKS; ++a) {
        const int c = cb + 32 * a + lane;
        if (c < chunks) Vec16<T>::store(o + (size_t)c * W, acc[a]);
      }
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

template <typename T, bool HASH>
int launch(const void* table, const int32_t* ids, const int32_t* sig,
           const float* weights, void* out, int n, int k, int D, int V,
           int vec, cudaStream_t stream) {
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const dim3 threads(WARPS_PER_BLOCK * 32);
  if (vec) {
    signature_embed_kernel<T, true, HASH><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), ids, sig, weights,
        static_cast<T*>(out), n, k, D, V);
  } else {
    signature_embed_kernel<T, false, HASH><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(table), ids, sig, weights,
        static_cast<T*>(out), n, k, D, V);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, const int32_t* ids, const int32_t* sig,
           const float* weights, void* out, int n, int k, int D, int V,
           int vec, cudaStream_t stream) {
  return sig != nullptr
             ? launch<T, true>(table, ids, sig, weights, out, n, k, D, V, vec,
                               stream)
             : launch<T, false>(table, ids, sig, weights, out, n, k, D, V,
                                vec, stream);
}

}  // namespace

// Exactly one of ids ((n, k) int32) and sig ((n,) int32) is non-null: the
// ids given, or hashed from the signatures in the kernel.  dtype: 0 =
// float32 table and output, 1 = bfloat16 table and output.  vec: 1 when D
// is a multiple of 16 bytes' worth of elements and the table and output
// pointers are 16-byte aligned.  Returns a cudaError_t
// (cudaErrorInvalidValue for k outside [1, 32], V < 1, an unknown dtype or
// not exactly one of ids and sig).
extern "C" int signature_embed_launch(const void* table, const int32_t* ids,
                                      const int32_t* sig,
                                      const float* weights, void* out, int n,
                                      int k, int D, int V, int dtype, int vec,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > MAX_PROBES || D < 1 || V < 1 ||
      (ids == nullptr) == (sig == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(table, ids, sig, weights, out, n, k, D, V, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, ids, sig, weights, out, n, k, D, V,
                                 vec, s);
  return (int)cudaErrorInvalidValue;
}
