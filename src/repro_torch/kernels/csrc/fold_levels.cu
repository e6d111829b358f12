// Fold levels: the doubling levels of a segmented idempotent combine
// (min, max or bitwise or) over (key, ts)-sorted rows.
//
//   level 0     = x
//   level k + 1 = op(L_k[i], i - 2^k >= seg_i ? L_k[i - 2^k] : identity)
//
// so level k at row i is op over rows [max(i - 2^k + 1, seg_i), i].  The
// output is (KL, N), KL = floor(log2 N) + 1, with no padding.
//
// Replaces the Pallas TPU kernel fold_levels_pallas
// (src/repro/kernels/window_agg/window_agg.py, body _fold_levels_kernel).
// That kernel lays the rows out as (R, 128) lane tiles, keeps every level
// of a row tile in VMEM and carries the tile boundary between sequential
// grid steps with DMAs.  None of that is needed on Hopper: blocks run in
// no order, so each level is one elementwise pass over device memory, one
// thread per row, launched in sequence on the caller's stream (level 0 is
// a device-to-device copy).  One call of fold_levels_launch issues KL - 1
// launches, one per level, and the wrapper counts each of them.
//
// Exactness: min, max and or are exact, so the result equals the plain
// version (kernels/window_agg/ref.py) bit for bit.  Min and max are the
// reference's jnp.minimum / jnp.maximum, written as selects on the bit
// patterns: the operands are ordered by the first one's sign bit, the
// smaller (larger) is taken with an ordered compare, and a NaN in the
// first-ordered operand wins with its own bits — so NaN propagates and
// -0.0 orders below +0.0.  fminf / fmaxf would drop a NaN operand.
//
// Bound on the H100: bytes.  The function must read x and seg once and
// write KL levels: N * (8 + 4 * KL) bytes, 0.54 ms at N = 2^24 (KL = 25)
// at 3.35 TB/s.  One pass per level reads L_k twice (at i and i - 2^k;
// the shifted read hits L2 while 2^k * 4 bytes is small) and seg once, so
// it moves about 12-16 bytes per row per level, 2-3x the bound.  Keeping
// the low levels of a row tile in shared memory with a halo would cut the
// small-shift passes; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OP_MIN = 0;
constexpr int OP_MAX = 1;
constexpr int OP_OR = 2;

__device__ __forceinline__ bool is_nan_bits(uint32_t u) {
  return (u & 0x7FFFFFFFu) > 0x7F800000u;
}

// jnp.minimum on float32, bit for bit (see the header)
__device__ __forceinline__ uint32_t min_bits(uint32_t a, uint32_t b) {
  const bool neg = (a >> 31) != 0;
  const uint32_t nx = neg ? b : a;
  const uint32_t ny = neg ? a : b;
  const bool lt = __uint_as_float(nx) < __uint_as_float(ny);
  const uint32_t pick = lt ? nx : ny;
  return is_nan_bits(nx) ? nx : pick;
}

// jnp.maximum on float32, bit for bit
__device__ __forceinline__ uint32_t max_bits(uint32_t a, uint32_t b) {
  const bool neg = (a >> 31) != 0;
  const uint32_t nx = neg ? a : b;
  const uint32_t ny = neg ? b : a;
  const bool gt = __uint_as_float(nx) > __uint_as_float(ny);
  const uint32_t pick = gt ? nx : ny;
  return is_nan_bits(nx) ? nx : pick;
}

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  if (OP == OP_MIN) return min_bits(a, b);
  if (OP == OP_MAX) return max_bits(a, b);
  return a | b;
}

// One doubling level.  Values travel as their 32-bit patterns: float32
// for min / max, int32 for or.
template <int OP>
__global__ void fold_level_kernel(const uint32_t* __restrict__ prev,
                                  uint32_t* __restrict__ next,
                                  const int32_t* __restrict__ seg, int n,
                                  int half, uint32_t ident) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t a = prev[i];
  const uint32_t b = (i - half >= seg[i]) ? prev[i - half] : ident;
  next[i] = combine<OP>(a, b);
}

template <int OP>
cudaError_t run_levels(const uint32_t* x, const int32_t* seg, uint32_t* out,
                       int n, int levels, uint32_t ident,
                       cudaStream_t stream) {
  cudaError_t err = cudaMemcpyAsync(out, x, sizeof(uint32_t) * (size_t)n,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const int blocks = (n + THREADS - 1) / THREADS;
  for (int k = 0; k + 1 < levels; ++k) {
    fold_level_kernel<OP><<<blocks, THREADS, 0, stream>>>(
        out + (size_t)k * n, out + (size_t)(k + 1) * n, seg, n, 1 << k,
        ident);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x: (n,) float32 (min / max) or int32 (or); seg: (n,) int32; out:
// (levels, n) of x's type.  op: 0 min, 1 max, 2 or.
extern "C" int fold_levels_launch(const void* x, const int32_t* seg,
                                  void* out, int n, int levels, int op,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const uint32_t* xs = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_MIN:  // identity float32(3.0e38)
      err = run_levels<OP_MIN>(xs, seg, o, n, levels, 0x7F61B1E6u, s);
      break;
    case OP_MAX:  // identity float32(-3.0e38)
      err = run_levels<OP_MAX>(xs, seg, o, n, levels, 0xFF61B1E6u, s);
      break;
    case OP_OR:
      err = run_levels<OP_OR>(xs, seg, o, n, levels, 0u, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
