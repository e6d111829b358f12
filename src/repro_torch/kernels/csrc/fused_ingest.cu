// Fused ingest: ring scatter + bucket pre-aggregate merge in one launch,
// read straight from the batch and the state (no plan).
//
// Replaces the Pallas TPU kernel fused_ingest_pallas
// (src/repro/kernels/ingest/ingest.py, body _fused_ingest_kernel).  That
// kernel walks the (key, ts)-sorted batch row by row over a sequential
// grid, carrying a per-(key, bucket) accumulator in VMEM from one grid step
// to the next.  Blocks on Hopper run in no order, so nothing may carry
// between them.  Here the unit of work is a key run (a key's rows, which
// the sort makes contiguous; pads, key == K, form no run) and each run
// has one owner, so no two threads write one state element:
//
//   * P lanes of a warp per row (F's next power of two, at most 32: the
//     fraud view's 2 lanes take 2, 16 rows a warp), each lane of the
//     group folding and merging its share of the F value lanes; the group
//     on a run's first row (key[i] differs from key[i - 1]) owns the run.
//     It scans up to SHORT_RUN rows for the run's end.  A shorter run it
//     applies alone: the cursor read and written once (cursor + run
//     length), the run's last C rows written to ring slots (cursor +
//     rank) % C -- only the last C, so slots never collide and the last
//     row wins, as in the plain version's scatter -- and each (key,
//     bucket) segment folded;
//   * a run of SHORT_RUN rows or more (a hot key) goes to the owner's
//     warp.  The warp finds the run's end and each segment's end with a
//     32-way search (32 probes a round, keys and bucket ids are sorted
//     inside a run), writes the last C rows' ring slots 32 at a time, and
//     folds each segment 32 rows at a time: the lanes load the rows and
//     hash them for the distinct bitmap in parallel (an or, order-free),
//     then every lane adds the rows in row order from shuffles;
//   * a segment's fold, ((ident + r0) + r1) ..., is merged into bucket
//     slot bucket_id % NB of its key, reset to identity first when the
//     slot holds another (stale) bucket id, and the bucket id is written.
//     No atomics and no tree: the row-order fold is what keeps the float
//     sums bit-exact.  Segments own distinct (key, slot) pairs (a batch
//     spans fewer than NB buckets).
//
// Exactness: built with -fmad=false, and every add / multiply is an
// explicit __fadd_rn / __fmul_rn, so the sumsq increment is the rounded
// v*v the plain version materializes (no fused multiply-add).  The
// distinct-bitmap hash (mix32 chain, salt 77) runs in uint32_t, where
// wrap-around is defined; the reference's arithmetic first shift is
// reproduced on the int32 view.
//
// Bound on the H100: bytes moved.  A batch of N rows and F lanes must
// read the batch (key, ts, lanes) once, write one ring slot per written
// row (4 + 4F bytes), read and write one bucket slot per segment (2 x
// (20F + 4F) + 4 bytes) and the cursor per run; there is no arithmetic to
// speak of.  Without a plan the kernel reads nothing else: the batch's
// key and ts twice at most (the run and segment scans) and the state
// elements it updates once.  The writes land in scattered 32-byte
// sectors (one key's slots are contiguous, keys are not), and each run is
// a chain of dependent trips to memory (its keys and ts, then its state),
// which is what keeps it from the streaming rate.  The design keeps that
// chain short: a thread loads its row's key, its neighbours' keys and
// its ts together, and then a segment's whole bucket slot with the cursor
// before it uses any of them (a warp stalls at the first use of a load),
// so a run of one row costs two trips; splitting a row's value lanes over
// threads doubles the loads in flight at the fraud view's two lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// a run this long or longer is applied by its owner's warp
// (kernels/ingest/ops.py SHORT_RUN)
constexpr int SHORT_RUN = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NUM_STATS = 5;
constexpr float POS_INF = 3.0e38f;
constexpr float NEG_INF = -3.0e38f;

struct Args {
  int32_t* ring_ts;     // (K, C)
  float* ring_vals;     // (K, C, F)
  int32_t* cursor;      // (K,)
  float* bstats;        // (K, NB, F, 5)
  int32_t* bbitmap;     // (K, NB, F)
  int32_t* bbucket;     // (K, NB)
  const int32_t* key;   // (n,)
  const int32_t* ts;    // (n,)
  const float* vals;    // (n, F)
  int n, F, C, NB, K, bucket_size;
};

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t salt) {
  h ^= salt & 0x7FFFFFFFu;
  h ^= (uint32_t)(((int32_t)h) >> 16);  // arithmetic shift, unmasked
  h *= 0x85EBCA6Bu;
  h ^= (h >> 13) & 0x0007FFFFu;
  h *= 0xC2B2AE35u;
  h ^= (h >> 16) & 0x0000FFFFu;
  return h;
}

// aggregates.row_bitmap: 1 << (|mix64(bits(v), salt=77)| % 32)
__device__ __forceinline__ int32_t row_bitmap(float v) {
  uint32_t h1 = mix32(__float_as_uint(v), 77u);
  uint32_t h2 = mix32(h1 ^ 0x5BD1E995u, 77u ^ 0x27D4EB2Fu);
  uint32_t h = h1 ^ (h2 * 5u + 0x38495AB5u);
  uint32_t a = ((int32_t)h < 0) ? (0u - h) : h;  // abs, INT_MIN wraps
  return (int32_t)(1u << (a & 31u));
}

// Python's floor division and modulo (the plain version's torch ops)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int m = a % b;
  return (m != 0 && ((m < 0) != (b < 0))) ? m + b : m;
}

__device__ __forceinline__ bool is_key(const Args& a, int k) {
  return (unsigned)k < (unsigned)a.K;
}

__device__ __forceinline__ int bucket_of(const Args& a, int j) {
  return floor_div(a.ts[j], a.bucket_size);
}

// ring slot of the run's row of this rank: (cursor + rank) % C, in the
// plain version's int32 arithmetic
__device__ __forceinline__ long long ring_slot(const Args& a, int k,
                                               int32_t cur0, int rank) {
  const int32_t c = (int32_t)((uint32_t)cur0 + (uint32_t)rank);
  return (long long)k * a.C + floor_mod(c, a.C);
}

__device__ __forceinline__ void write_ring_row(const Args& a, long long r,
                                               int j) {
  a.ring_ts[r] = a.ts[j];
  for (int f = 0; f < a.F; ++f)
    a.ring_vals[r * a.F + f] = a.vals[(long long)j * a.F + f];
}

struct Fold {
  float s, c, mn, mx, sq;
  int32_t bm;
};

__device__ __forceinline__ Fold fold_init() {
  return Fold{0.0f, 0.0f, POS_INF, NEG_INF, 0.0f, 0};
}

// one row into the fold, in row order (the bitmap apart)
__device__ __forceinline__ void fold_row(Fold& q, float v) {
  q.s = __fadd_rn(q.s, v);
  q.c = __fadd_rn(q.c, 1.0f);
  q.mn = fminf(q.mn, v);
  q.mx = fmaxf(q.mx, v);
  q.sq = __fadd_rn(q.sq, __fmul_rn(v, v));
}

// lane f of bucket slot sl as stored: its stats and distinct bitmap
struct Slot {
  float st[NUM_STATS];
  int32_t bm;
};

__device__ __forceinline__ Slot load_slot(const Args& a, long long sl,
                                          int f) {
  const float* st = a.bstats + (sl * a.F + f) * NUM_STATS;
  Slot old;
#pragma unroll
  for (int x = 0; x < NUM_STATS; ++x) old.st[x] = st[x];
  old.bm = a.bbitmap[sl * a.F + f];
  return old;
}

// merge a segment's fold of lane f into bucket slot sl, whose stored
// value is old (stale: reset to identity first)
__device__ __forceinline__ void merge(const Args& a, long long sl, int f,
                                      bool stale, const Slot& old,
                                      const Fold& q) {
  float* st = a.bstats + (sl * a.F + f) * NUM_STATS;
  st[0] = __fadd_rn(stale ? 0.0f : old.st[0], q.s);
  st[1] = __fadd_rn(stale ? 0.0f : old.st[1], q.c);
  st[2] = fminf(stale ? POS_INF : old.st[2], q.mn);
  st[3] = fmaxf(stale ? NEG_INF : old.st[3], q.mx);
  st[4] = __fadd_rn(stale ? 0.0f : old.st[4], q.sq);
  a.bbitmap[sl * a.F + f] = (stale ? 0 : old.bm) | q.bm;
}

// the slot of bucket bid in key k's ring, and whether it holds another id
__device__ __forceinline__ long long bucket_slot(const Args& a, int k,
                                                 int bid, bool* stale) {
  const long long sl = (long long)k * a.NB + floor_mod(bid, a.NB);
  const int32_t stored = a.bbucket[sl];
  *stale = stored != bid && stored != -1;
  return sl;
}

// A run of fewer than SHORT_RUN rows, [s, e) of key k, by its first row's
// P lanes (lanes q, q + P, ... of the F value lanes to lane q of the
// group); t_s is ts[s].  A warp issues its loads in order and stalls at
// the first use of one, so each segment loads its bucket slot -- id,
// stats and bitmap -- and its rows before it uses any of them: one trip to
// device memory a segment (the cursor's load rides with the first).
// group: the row's lanes, which all take this same path; they have all
// read the slot's id and the cursor before lane 0 writes them.
__device__ void apply_short_run(const Args& a, int k, int s, int e, int t_s,
                                int q, int P, unsigned group) {
  const int32_t cur0 = a.cursor[k];
  int bid = floor_div(t_s, a.bucket_size);
  for (int b0 = s; b0 < e;) {
    int b1 = b0 + 1, next = bid;
    while (b1 < e && (next = bucket_of(a, b1)) == bid) ++b1;
    bool stale;
    const long long sl = bucket_slot(a, k, bid, &stale);
    for (int f = q; f < a.F; f += P) {
      const Slot old = load_slot(a, sl, f);
      Fold fq = fold_init();
      for (int j = b0; j < b1; ++j) {
        const float v = a.vals[(long long)j * a.F + f];
        fold_row(fq, v);
        fq.bm |= row_bitmap(v);
      }
      merge(a, sl, f, stale, old, fq);
    }
    __syncwarp(group);
    if (q == 0) a.bbucket[sl] = bid;
    b0 = b1;
    bid = next;
  }
  for (int j = max(s, e - a.C); j < e; ++j) {
    const long long r = ring_slot(a, k, cur0, j - s);
    if (q == 0) a.ring_ts[r] = a.ts[j];
    for (int f = q; f < a.F; f += P)
      a.ring_vals[r * a.F + f] = a.vals[(long long)j * a.F + f];
  }
  __syncwarp(group);
  if (q == 0) a.cursor[k] = (int32_t)((uint32_t)cur0 + (uint32_t)(e - s));
}

// The first row after lo at which pred turns false, or hi; pred holds at
// lo and is monotone (true, then false) on [lo, hi).  32 probes a round.
template <typename Pred>
__device__ __forceinline__ int warp_find_end(int lo, int hi, int lane,
                                             Pred pred) {
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + step * (lane + 1);
    const unsigned eq = __ballot_sync(FULL, probe < hi && pred(probe));
    lo += step * __popc(eq);
    hi = min(hi, lo + step);
  }
  return hi;
}

// A run of SHORT_RUN rows or more starting at s, key k, by the whole warp.
__device__ void apply_long_run(const Args& a, int k, int s, int lane) {
  const int e = warp_find_end(s + SHORT_RUN, a.n, lane,
                              [&](int j) { return a.key[j] == k; });
  int32_t cur0 = 0;
  if (lane == 0) cur0 = a.cursor[k];
  cur0 = __shfl_sync(FULL, cur0, 0);
  if (lane == 0) a.cursor[k] = (int32_t)((uint32_t)cur0 + (uint32_t)(e - s));
  for (int j = max(s, e - a.C) + lane; j < e; j += 32)
    write_ring_row(a, ring_slot(a, k, cur0, j - s), j);
  for (int b0 = s; b0 < e;) {
    const int bid = bucket_of(a, b0);
    const int b1 = warp_find_end(b0, e, lane,
                                 [&](int j) { return bucket_of(a, j) == bid; });
    bool stale;
    const long long sl = bucket_slot(a, k, bid, &stale);
    for (int f = 0; f < a.F; ++f) {
      Fold q = fold_init();
      for (int base = b0; base < b1; base += 32) {
        const int j = base + lane;
        const float mine = j < b1 ? a.vals[(long long)j * a.F + f] : 0.0f;
        if (j < b1) q.bm |= row_bitmap(mine);
        const int cnt = min(32, b1 - base);
        for (int t = 0; t < cnt; ++t) fold_row(q, __shfl_sync(FULL, mine, t));
      }
      q.bm = (int32_t)__reduce_or_sync(FULL, (unsigned)q.bm);
      if (lane == 0) merge(a, sl, f, stale, load_slot(a, sl, f), q);
    }
    __syncwarp();
    if (lane == 0) a.bbucket[sl] = bid;
    b0 = b1;
  }
}

// P lanes a row (a power of two, P >= F up to 32): 32 / P rows a warp.
__global__ void __launch_bounds__(THREADS)
    fused_ingest_kernel(Args a, int P) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (P - 1);
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long row = warp * (32 / P) + lane / P;
  const unsigned group =
      P == 32 ? FULL : ((1u << P) - 1u) << (lane & ~(P - 1));
  const int i = (int)(row < a.n ? row : a.n);
  // this row's key and ts and its neighbours' keys, loaded together
  int k = a.K, k_prev = -1, k_next = -1, t_i = 0;
  if (i < a.n) {
    k = a.key[i];
    k_prev = i > 0 ? a.key[i - 1] : -1;
    k_next = i + 1 < a.n ? a.key[i + 1] : -1;
    t_i = a.ts[i];
  }
  const bool owner = i < a.n && is_key(a, k) && k_prev != k;
  bool long_run = false;
  if (owner) {
    int e = i + 1;
    if (k_next == k) {
      const int lim = min(a.n, i + SHORT_RUN);
      for (e = i + 2; e < lim && a.key[e] == k;) ++e;
      long_run = e == i + SHORT_RUN && e < a.n && a.key[e] == k;
    }
    if (!long_run) apply_short_run(a, k, i, e, t_i, q, P, group);
  }
  // every lane is here (no early return): the warp takes its long runs in
  // turn
  for (unsigned todo = __ballot_sync(FULL, long_run && q == 0); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    apply_long_run(a, __shfl_sync(FULL, k, src), __shfl_sync(FULL, i, src),
                   lane);
  }
}

}  // namespace

// State arrays as named in Args, updated in place; key, ts: (n,) int32
// sorted by (key, ts) with pads (key == K) leading or trailing; vals:
// (n, F) float32.  One launch, P threads a row.  Returns a cudaError_t.
extern "C" int fused_ingest_launch(
    int32_t* ring_ts, float* ring_vals, int32_t* cursor, float* bstats,
    int32_t* bbitmap, int32_t* bbucket, const int32_t* key,
    const int32_t* ts, const float* vals, int n, int F, int C, int NB, int K,
    int bucket_size, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  if (F < 1 || C < 1 || NB < 1 || K < 1 || bucket_size < 1)
    return (int)cudaErrorInvalidValue;
  Args a{ring_ts, ring_vals, cursor, bstats, bbitmap, bbucket, key, ts, vals,
         n, F, C, NB, K, bucket_size};
  int P = 1;  // lanes a row: F's next power of two, at most a warp
  while (P < F && P < 32) P *= 2;
  const long long threads = ((long long)n * P + 31) / 32 * 32;
  const int grid = (int)((threads + THREADS - 1) / THREADS);
  fused_ingest_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, P);
  return (int)cudaGetLastError();
}
