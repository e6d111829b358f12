// Route rank: each row's exclusive rank within its shard, in batch order,
// plus the rows per shard.
//
// Replaces the Pallas TPU kernel route_rank_pallas
// (src/repro/kernels/route/route.py, body _route_rank_kernel).  That kernel
// keeps the whole (rows, 128) shard-id tile resident in VMEM and runs one
// sequential grid step per shard, each a masked cumsum over the tile.  On
// Hopper the batch is cut into tiles of 1024 rows, one block each, in one
// launch with no host synchronization:
//
//   1. per-block, per-shard count of every row before the block's tile
//      (shared-memory integer atomics: exact in any order) — the block's
//      exclusive base, i.e. the scan over earlier blocks;
//   2. within each warp, the rows of one shard find each other with
//      __match_any_sync; a row's rank inside its warp is the popcount of
//      its peers below it (__popc), and the lowest peer records the warp's
//      count for that shard;
//   3. per shard, an exclusive scan over the block's 32 warps on top of
//      the base gives every row its rank; the last block also writes the
//      per-shard totals.
//
// Rows whose id is outside [0, S) (padding) get rank 0 and count nowhere.
// Integer-only, so the result is exact and equals the plain version.
//
// Bound on the H100: bytes moved (4 bytes read and 4 written per row, 4 per
// shard count) — a few microseconds' worth at request-batch sizes, so the
// launch itself dominates.  Step 1 re-reads earlier rows once per block,
// O(N^2 / 1024) reads in all: about 6 K extra reads at the 4,096-row
// request batch, which stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int WARPS = TILE / 32;

__global__ void route_rank_kernel(const int32_t* __restrict__ shard,
                                  int32_t* __restrict__ rank,
                                  int32_t* __restrict__ counts, int n, int S) {
  extern __shared__ int32_t smem[];
  int32_t* base = smem;        // [S]      rows of each shard before the tile
  int32_t* wcnt = smem + S;    // [WARPS][S] per-warp counts, then prefixes
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * TILE;

  for (int j = tid; j < S * (WARPS + 1); j += TILE) smem[j] = 0;
  __syncthreads();

  // 1. exclusive base of this tile: counts over all earlier rows
  for (int j = tid; j < t0; j += TILE) {
    const int s = shard[j];
    if (s >= 0 && s < S) atomicAdd(&base[s], 1);
  }

  // 2. rank within the warp
  const int i = t0 + tid;
  const int s = (i < n) ? shard[i] : -1;
  const bool ok = (i < n) && s >= 0 && s < S;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? s : -1);
  const int wrank = __popc(peers & ((1u << lane) - 1u));
  if (ok && lane == __ffs(peers) - 1) wcnt[warp * S + s] = __popc(peers);
  __syncthreads();

  // 3. per shard: exclusive scan over the warps, on top of the base
  for (int sh = tid; sh < S; sh += TILE) {
    int run = base[sh];
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w * S + sh];
      wcnt[w * S + sh] = run;
      run += c;
    }
    if (blockIdx.x == gridDim.x - 1) counts[sh] = run;
  }
  __syncthreads();

  if (i < n) rank[i] = ok ? wcnt[warp * S + s] + wrank : 0;
}

}  // namespace

extern "C" int route_rank_launch(const int32_t* shard, int32_t* rank,
                                 int32_t* counts, int n, int S, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int blocks = (n + TILE - 1) / TILE;
  const size_t shmem = sizeof(int32_t) * (size_t)S * (WARPS + 1);
  route_rank_kernel<<<blocks, TILE, shmem, (cudaStream_t)stream>>>(
      shard, rank, counts, n, S);
  return (int)cudaGetLastError();
}
