// Route rank: each row's exclusive rank within its shard, in batch order,
// plus the rows per shard.  One kernel, two instantiations:
//
//   * shard ids in (route_rank): ids outside [0, S) (padding) get rank 0
//     and count nowhere;
//   * keys in (route_keys): each key is first walked through the Feistel
//     permutation of repro_torch/core/hashing.py (KeyPermutation), giving
//     shard = perm(key) % S and local = perm(key) / S, then ranked; the
//     kernel also counts the rows of each shard that the valid mask keeps.
//     A key outside the domain [0, upper) is not walked (its walk need not
//     end): local = shard = -1, rank 0, counted nowhere.
//
// Replaces the Pallas TPU kernel route_rank_pallas
// (src/repro/kernels/route/route.py, body _route_rank_kernel), together
// with the walk in front of it (KeyPermutation.device_call, a lax.while_loop
// in the reference's jitted program).  The TPU kernel keeps the whole
// (rows, 128) shard-id tile in VMEM and runs one sequential grid step per
// shard, each a masked cumsum over the tile.
//
// The walk.  A thread walks its key home: x = once(key), then x = once(x)
// while x >= upper, where once is the Feistel pass (rounds of mix32 on
// half-width halves).  It ends because the pass is a bijection on
// [0, size) and the key lies in [0, upper): the key's own cycle comes
// back below upper.  The multiplies run on uint32 (wrap-around, never
// signed overflow), the shifts are arithmetic on int32 (as torch's and
// numpy's >>), and each round's salt is masked to 31 bits as mix32 masks
// it, so the ids equal KeyPermutation.__call__ bit for bit.
//
// The rank: tiles of THREADS rows, a thread a row.
//   pass 1  each block walks its tiles' keys (or reads the shard ids),
//           writes shard / local, and counts its rows per shard: the rows of
//           one shard in a warp find each other with __match_any_sync and
//           the lowest adds their number to a shared counter;
//   sync    with several blocks, each writes its counts to scratch and all
//           meet at a grid barrier; a block's base is then the sum of the
//           counts of the blocks before it, and the last block writes the
//           totals;
//   pass 2  each block sweeps its tiles in batch order: a row's rank inside
//           its warp is the popcount of its peers below it, the lowest peer
//           records the warp's count, one exclusive scan over the tile's
//           warps per shard (shuffles) lifts those onto the running base.
//
// Why blocks and a barrier, not one block sweeping the batch: the walk is
// the work (about 57 integer operations a pass, two passes a key on
// average at the main path's domain, and a warp runs as long as its
// longest walk), so one SM would walk a 4,096-key batch 16 tiles in a
// row, where 16 blocks walk one tile each on their own SMs.  A tile-count pass
// behind a grid barrier was chosen over a decoupled look-back because the
// barrier's state restores itself at every call (the last arrival resets
// the count), where look-back flags would have to be cleared before each
// call, which is another launch.  The barrier needs every block resident:
// a cooperative launch with at most as many blocks as fit on the card, each
// taking a contiguous run of tiles.  A batch of one tile is one block and
// a plain launch.
//
// Bound on the H100: the bytes (keys, valid flags, three (N,) outputs, two
// (S,) ones) and the walk's integer operations are each well under a
// microsecond at request-batch sizes, so the launch itself dominates;
// route_empty_launch is an empty kernel behind the same ctypes path, the
// launch floor this kernel is read against.  Integer-only: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // rows a tile, threads a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SHARDS = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Feistel {
  int half;        // bits of a half
  int32_t mask;    // 2^half - 1
  int32_t upper;   // the domain [0, upper)
  int rounds;
  uint32_t salt;   // low 32 bits of the permutation's salt
};

struct Params {
  const int32_t* in;      // (n,) keys, or shard ids
  const uint8_t* valid;   // (n,) bool, keys only
  int32_t* local;         // (n,) keys only
  int32_t* shard;         // (n,) keys only: written in pass 1, read in pass 2
  int32_t* rank;          // (n,)
  int32_t* counts;        // (S,)
  int32_t* valid_counts;  // (S,) keys only
  int32_t* block_counts;  // (blocks, 2S) scratch
  unsigned* sync;         // [0] barrier arrivals, [1] generation: zeroed
                          // once by the wrapper, left so by every call
  int n, S, tiles, per_block;
  Feistel f;
};

__device__ __forceinline__ int32_t mul_wrap(int32_t a, uint32_t m) {
  return (int32_t)((uint32_t)a * m);
}

// mix32 of repro_torch/core/hashing.py: the murmur3 finalizer on int32
__device__ __forceinline__ int32_t mix32(int32_t x, uint32_t salt) {
  int32_t h = x ^ (int32_t)(salt & 0x7FFFFFFFu);
  h ^= h >> 16;
  h = mul_wrap(h, 0x85EBCA6Bu);
  h ^= (h >> 13) & 0x0007FFFF;
  h = mul_wrap(h, 0xC2B2AE35u);
  h ^= (h >> 16) & 0x0000FFFF;
  return h;
}

// one Feistel pass (KeyPermutation._once); both halves stay below 2^half
__device__ __forceinline__ int32_t feistel_once(int32_t x, const Feistel& f) {
  int32_t left = x >> f.half;
  int32_t right = x & f.mask;
#pragma unroll 4
  for (int r = 0; r < f.rounds; ++r) {
    const int32_t g =
        mix32(right, f.salt + 0x9E37u * (uint32_t)(r + 1)) & f.mask;
    const int32_t t = left ^ g;
    left = right;
    right = t;
  }
  return (left << f.half) | right;
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
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool KEYS>
__global__ void __launch_bounds__(THREADS) route_kernel(Params p) {
  __shared__ int32_t s_base[MAX_SHARDS];       // rows of a shard before the tile
  __shared__ int32_t s_cnt[2 * MAX_SHARDS];    // the block's rows, valid rows
  __shared__ int32_t s_warp[2][MAX_SHARDS * WARPS];  // (shard, warp) counts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = p.S;
  const int t_lo = blockIdx.x * p.per_block;
  const int t_hi = min(t_lo + p.per_block, p.tiles);

  for (int j = tid; j < 2 * MAX_SHARDS; j += THREADS) s_cnt[j] = 0;
  for (int j = tid; j < 2 * MAX_SHARDS * WARPS; j += THREADS)
    (&s_warp[0][0])[j] = 0;
  __syncthreads();

  // pass 1: shard ids and the block's counts
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t * THREADS + tid;
    int s = -1;
    bool v = false;
    if (i < p.n) {
      const int32_t x = p.in[i];
      if (KEYS) {
        int32_t loc = -1;
        if (x >= 0 && x < p.f.upper) {
          int32_t y = feistel_once(x, p.f);
          while (y >= p.f.upper) y = feistel_once(y, p.f);
          s = y % S;
          loc = y / S;
        }
        p.local[i] = loc;
        p.shard[i] = s;
        v = s >= 0 && p.valid[i] != 0;
      } else {
        s = (x >= 0 && x < S) ? x : -1;
      }
    }
    const unsigned peers = __match_any_sync(FULL, s);
    const unsigned vpeers = peers & __ballot_sync(FULL, v);
    if (s >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s_cnt[s], __popc(peers));
      if (KEYS) atomicAdd(&s_cnt[MAX_SHARDS + s], __popc(vpeers));
    }
  }
  __syncthreads();

  if (gridDim.x > 1) {
    int32_t* mine = p.block_counts + (size_t)blockIdx.x * 2 * S;
    for (int j = tid; j < S; j += THREADS) {
      mine[j] = s_cnt[j];
      mine[S + j] = s_cnt[MAX_SHARDS + j];
    }
    grid_sync(p.sync);
  }

  // the block's base per shard: the rows of the blocks before it (a warp a
  // shard, its lanes striding over those blocks); the last block also
  // writes the totals
  const bool last = blockIdx.x == gridDim.x - 1;
  for (int sh = warp; sh < S; sh += WARPS) {
    int before = 0, vbefore = 0;
    for (int b = lane; b < (int)blockIdx.x; b += 32) {
      before += __ldcg(p.block_counts + (size_t)b * 2 * S + sh);
      if (KEYS && last)
        vbefore += __ldcg(p.block_counts + (size_t)b * 2 * S + S + sh);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(FULL, before, o);
      vbefore += __shfl_xor_sync(FULL, vbefore, o);
    }
    if (lane == 0) {
      s_base[sh] = before;
      if (last) {
        p.counts[sh] = before + s_cnt[sh];
        if (KEYS) p.valid_counts[sh] = vbefore + s_cnt[MAX_SHARDS + sh];
      }
    }
  }
  __syncthreads();

  // pass 2: ranks, tile by tile in batch order; the (shard, warp) counts
  // alternate between two buffers, the one not in use cleared meanwhile
  int buf = 0;
  for (int t = t_lo; t < t_hi; ++t, buf ^= 1) {
    const int i = t * THREADS + tid;
    int s = -1;
    if (i < p.n) {
      s = KEYS ? p.shard[i] : p.in[i];
      if (s < 0 || s >= S) s = -1;
    }
    const unsigned peers = __match_any_sync(FULL, s);
    const int wrank = __popc(peers & ((1u << lane) - 1u));
    int32_t* wc = s_warp[buf];
    if (s >= 0 && lane == __ffs(peers) - 1) wc[s * WARPS + warp] = __popc(peers);
    __syncthreads();

    // per shard, an exclusive scan over the tile's warps (groups of WARPS
    // lanes, one group a shard) on top of the running base
    for (int j0 = 0; j0 < S * WARPS; j0 += THREADS) {
      const int j = j0 + tid;
      const bool on = j < S * WARPS;
      const int sh = j / WARPS;
      const int c = on ? wc[j] : 0;
      const int base = on ? s_base[sh] : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < WARPS; o <<= 1) {
        const int u = __shfl_up_sync(FULL, inc, o, WARPS);
        if ((j & (WARPS - 1)) >= o) inc += u;
      }
      __syncwarp();
      if (on) {
        wc[j] = base + inc - c;
        if ((j & (WARPS - 1)) == WARPS - 1) s_base[sh] = base + inc;
      }
    }
    for (int j = tid; j < S * WARPS; j += THREADS) s_warp[buf ^ 1][j] = 0;
    __syncthreads();

    if (i < p.n) p.rank[i] = s >= 0 ? wc[s * WARPS + warp] + wrank : 0;
  }
}

__global__ void empty_kernel() {}

template <bool KEYS>
cudaError_t launch(Params p, int device, cudaStream_t stream) {
  auto kernel = route_kernel<KEYS>;
  if (p.tiles == 1) {
    p.per_block = 1;
    kernel<<<1, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  // resident blocks on this device, asked once (the answer does not change)
  static int slots[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (slots[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots[device] = per_sm * sms;
  }
  p.per_block = (p.tiles + slots[device] - 1) / slots[device];
  const int grid = (p.tiles + p.per_block - 1) / p.per_block;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                     dim3(THREADS), args, 0, stream);
}

}  // namespace

// keys != 0: ``in`` holds keys, walked with (half, mask, upper, rounds,
// salt), and valid / local / shard / valid_counts are written; else ``in``
// holds shard ids and those four are unused (may be null).  block_counts:
// 2 * S * ceil(n / 256) int32 of scratch; sync: 2 uint32, zero before the
// first call on a stream (every call leaves them zero).  Returns a
// cudaError_t (cudaErrorInvalidValue for S outside [1, 64]).
extern "C" int route_launch(int keys, const int32_t* in, const uint8_t* valid,
                            int32_t* local, int32_t* shard, int32_t* rank,
                            int32_t* counts, int32_t* valid_counts,
                            int32_t* block_counts, void* sync, int n, int S,
                            int half, int mask, int upper, int rounds,
                            unsigned salt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || S > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params p;
  p.in = in;
  p.valid = valid;
  p.local = local;
  p.shard = shard;
  p.rank = rank;
  p.counts = counts;
  p.valid_counts = valid_counts;
  p.block_counts = block_counts;
  p.sync = static_cast<unsigned*>(sync);
  p.n = n;
  p.S = S;
  p.tiles = (n + THREADS - 1) / THREADS;
  p.per_block = 1;
  p.f.half = half;
  p.f.mask = mask;
  p.f.upper = upper;
  p.f.rounds = rounds;
  p.f.salt = salt;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(keys ? launch<true>(p, device, s) : launch<false>(p, device, s));
}

// The launch floor: an empty kernel behind the same ctypes path.
extern "C" int route_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
