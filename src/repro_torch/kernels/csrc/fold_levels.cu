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
// grid steps with DMAs.  Blocks on Hopper run in no order, so this kernel
// gives each block a tile of its own plus a halo of the rows before it.
//
// Bound on the H100: bytes.  The function must read x and seg once and
// write KL levels: N * (8 + 4 * KL) bytes, 0.54 ms at N = 2^24 (KL = 25)
// at 3.35 TB/s -- almost all of it the level stores.  The design moves
// close to that in one launch:
//
// 1. Tile phase.  A block takes a tile of T rows and the H rows before it
//    (the plan's tile and halo, kernels/window_agg/ops.py), reads their x
//    and seg once into shared memory and runs the recurrence above there,
//    level by level over all T + H rows.  Row i's level k is right in the
//    tile when its window [max(i - 2^k + 1, seg_i), i] starts at or after
//    the halo's first row; those values are written with coalesced stores.
//    A row saturates once 2^k > i - seg_i: every higher level is then
//    op(L_k[i], identity), one value applied once and then stable, so when
//    every row of the tile is saturated or has left it, the remaining
//    levels are stores of that register value.  On the main path's data
//    (Poisson(32) segments) that happens near level 7, so most of the 25
//    levels are plain stores.
// 2. Long rows: rows whose segment starts before the halo ("long rows":
//    a hot key, one segment over all rows) leave the tile at some level.
//    A tile holding one appends itself to a device list.  After a grid
//    barrier the blocks walk the listed tiles' rows level by level, from
//    the first level a row can leave its tile, computing only the levels
//    of rows that left it from the previous level in device memory, with a
//    grid barrier between levels.  With no long row the list is empty and
//    the kernel ends after the first barrier.
//
// One cooperative launch a call (its blocks all resident, which the grid
// barrier needs: one persistent block per slot, a grid-stride loop over
// the tiles).  The barrier state and the list are the wrapper's scratch.
//
// Exactness: min, max and or are exact, and both phases combine in the
// plain version's (kernels/window_agg/ref.py) own tree order, so the
// result equals it bit for bit -- which of two NaNs wins depends on that
// order.  Min and max are the reference's jnp.minimum / jnp.maximum,
// written as selects on the bit patterns: the operands are ordered by the
// first one's sign bit, the smaller (larger) is taken with an ordered
// compare, and a NaN in the first-ordered operand wins with its own bits
// -- so NaN propagates and -0.0 orders below +0.0.  fminf / fmaxf would
// drop a NaN operand.  The saturated value op(L, identity) is not L: min
// takes +inf to the identity 3.0e38 and max -inf to -3.0e38, while a NaN
// keeps its payload.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
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

struct Params {
  const uint32_t* x;    // (n,) float32 or int32 bit patterns
  const int32_t* seg;   // (n,)
  uint32_t* out;        // (levels, n)
  unsigned* sync;       // [0] barrier arrivals, [1] barrier generation,
                        // [2] long tiles listed; zeroed by the wrapper
  int32_t* long_tiles;  // (tiles,) the listed tiles
  int n, levels, tile, halo, tiles, first_long;
  uint32_t ident;
};

// Row i's level k lies inside the tile whose halo starts at row lo: its
// window [max(i - 2^k + 1, seg_i), i] starts at or after lo.  A tile whose
// halo reaches row 0 holds every window (rows before 0 are the identity).
__device__ __forceinline__ bool in_tile(long long i, int s, int k,
                                        long long lo) {
  const long long start = i - (1LL << k) + 1;
  return lo <= 0 || (start > s ? start : (long long)s) >= lo;
}

// A barrier over the whole grid; every block is resident (cooperative
// launch).  Arrivals count up to the grid size; the last one resets the
// count and bumps the generation the others wait on.
__device__ void grid_sync(unsigned* sync) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
    fold_levels_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int rows_max = p.tile + p.halo;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + rows_max;
  int32_t* sseg = reinterpret_cast<int32_t*>(smem + 2 * rows_max);
  const uint32_t ident = p.ident;

  // 1. tile phase
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long t0 = (long long)t * p.tile;
    const long long lo = t0 - p.halo;
    const int rows = p.halo + (int)min((long long)p.tile, p.n - t0);
    for (int r = tid; r < rows; r += THREADS) {
      const long long g = lo + r;
      buf0[r] = g >= 0 ? p.x[g] : ident;
      sseg[r] = g >= 0 ? p.seg[g] : 0;
    }
    __syncthreads();
    for (int r = p.halo + tid; r < rows; r += THREADS)
      p.out[lo + r] = buf0[r];  // level 0: every row's window is itself
    uint32_t* cur = buf0;
    uint32_t* nxt = buf1;
    int k = 0;
    while (k + 1 < p.levels) {
      // go on while a row of the tile is in it at level k and unsaturated
      bool more = false;
      for (int r = p.halo + tid; r < rows; r += THREADS) {
        const long long i = lo + r;
        const int s = sseg[r];
        more |= i - s >= (1LL << k) && in_tile(i, s, k, lo);
      }
      if (!__syncthreads_or(more)) break;
      const int half = 1 << k;
      for (int r = tid; r < rows; r += THREADS) {
        const long long i = lo + r;
        const bool take = i - half >= sseg[r] && i - half >= 0 && r >= half;
        nxt[r] = combine<OP>(cur[r], take ? cur[r - half] : ident);
      }
      __syncthreads();
      uint32_t* sw = cur;
      cur = nxt;
      nxt = sw;
      ++k;
      for (int r = p.halo + tid; r < rows; r += THREADS) {
        const long long i = lo + r;
        if (in_tile(i, sseg[r], k, lo)) p.out[(long long)k * p.n + i] = cur[r];
      }
    }
    // the rows still in the tile are saturated: op(L_k, identity) above
    bool lng = false;
    for (int r = p.halo + tid; r < rows; r += THREADS) {
      const long long i = lo + r;
      const int s = sseg[r];
      if (in_tile(i, s, k, lo)) {
        const uint32_t v = combine<OP>(cur[r], ident);
        for (int kk = k + 1; kk < p.levels; ++kk)
          p.out[(long long)kk * p.n + i] = v;
      }
      lng |= !in_tile(i, s, p.levels - 1, lo);
    }
    if (__syncthreads_or(lng) && tid == 0)
      p.long_tiles[atomicAdd(p.sync + 2, 1u)] = t;
  }

  // 2. long rows, level by level over the listed tiles
  if (p.first_long >= p.levels) return;  // no row can leave its tile
  grid_sync(p.sync);
  const int listed = (int)atomicAdd(p.sync + 2, 0u);
  if (listed == 0) return;
  const long long items = (long long)listed * p.tile;
  const long long stride = (long long)gridDim.x * THREADS;
  for (int k = p.first_long; k < p.levels; ++k) {
    const long long half = 1LL << (k - 1);
    const uint32_t* prev = p.out + (long long)(k - 1) * p.n;
    for (long long w = (long long)blockIdx.x * THREADS + tid; w < items;
         w += stride) {
      const long long t0 = (long long)p.long_tiles[w / p.tile] * p.tile;
      const long long i = t0 + w % p.tile;
      if (i >= p.n) continue;
      const int s = p.seg[i];
      if (in_tile(i, s, k, t0 - p.halo)) continue;
      const long long j = i - half;
      const uint32_t b = (j >= s && j >= 0) ? __ldcg(prev + j) : ident;
      p.out[(long long)k * p.n + i] = combine<OP>(__ldcg(prev + i), b);
    }
    if (k + 1 < p.levels) grid_sync(p.sync);
  }
}

template <int OP>
cudaError_t launch(Params p, int device, cudaStream_t stream) {
  auto kernel = fold_levels_kernel<OP>;
  const size_t smem = sizeof(uint32_t) * 3 * (size_t)(p.tile + p.halo);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = (long long)per_sm * sms;
  const int grid = (int)(slots < p.tiles ? slots : p.tiles);
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                     dim3(THREADS), args, smem, stream);
}

}  // namespace

// x: (n,) float32 (min / max) or int32 (or); seg: (n,) int32; out:
// (levels, n) of x's type.  op: 0 min, 1 max, 2 or.  tile, halo: the
// plan's (kernels/window_agg/ops.py plan_fold_levels); first_long: the
// lowest level a row can leave its tile.  sync: 3 zeroed uint32;
// long_tiles: ceil(n / tile) int32 of scratch.  One cooperative launch.
extern "C" int fold_levels_launch(const void* x, const int32_t* seg,
                                  void* out, void* sync, void* long_tiles,
                                  int n, int levels, int op, int tile,
                                  int halo, int first_long, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  if (tile < 1 || halo < 0 || levels < 1 || first_long < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint32_t*>(x);
  p.seg = seg;
  p.out = static_cast<uint32_t*>(out);
  p.sync = static_cast<unsigned*>(sync);
  p.long_tiles = static_cast<int32_t*>(long_tiles);
  p.n = n;
  p.levels = levels;
  p.tile = tile;
  p.halo = halo;
  p.tiles = (int)(((long long)n + tile - 1) / tile);
  p.first_long = first_long;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_MIN:  // identity float32(3.0e38)
      p.ident = 0x7F61B1E6u;
      err = launch<OP_MIN>(p, device, s);
      break;
    case OP_MAX:  // identity float32(-3.0e38)
      p.ident = 0xFF61B1E6u;
      err = launch<OP_MAX>(p, device, s);
      break;
    case OP_OR:
      p.ident = 0u;
      err = launch<OP_OR>(p, device, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
