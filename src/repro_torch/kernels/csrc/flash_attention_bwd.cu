// Flash attention backward: the gradients of causal / sliding-window
// grouped-query attention (flash_attention.cu's function) with respect to
// q, k and v.  For q, o, dO (B, H, S, D) and k, v (B, Hkv, S, D), query
// head h reading KV head h / G (G = H / Hkv), with the weights P of the
// forward recomputed from q and k:
//
//     Δ_i  = Σ_d dO_id · O_id                   (from the stored o)
//     dP   = dO Vᵀ,   dS = P ∘ (dP − Δ)
//     dQ   = scale · dS K
//     dK   = scale · Σ_{G heads} dSᵀ Q,   dV = Σ_{G heads} Pᵀ dO
//
// in float32 from float32 or bf16 inputs, the gradients written in the
// inputs' dtype.  The visible pairs are the forward's: k_pos <= q_pos
// (causal), k_pos > q_pos - window, both < S; a row with no visible key
// has P = 0 and gets zero gradients.
//
// The reference package has no backward kernel (its models differentiate
// the XLA path); this is the gradient of flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py) for the port,
// whose models run the forward kernel under autograd.
//
// A simple design on the CUDA cores, two kernels, no atomics -- every
// gradient element is summed by one thread in a fixed order, so two runs
// give the same bits:
//
// 1. bwd_dq_kernel, a block per (b, h, query tile of BT rows): Δ for its
//    rows, then the row statistics (running max m and denominator l) over
//    the visible key tiles in ascending order, then a second pass over the
//    same tiles forming P = exp(s - m) / l, dP, dS (staged in shared
//    memory) and accumulating dQ in registers.  It writes m, l and Δ of
//    each row for kernel 2.
// 2. bwd_dkdv_kernel, a block per (b, KV head, key tile of BT rows),
//    holding its K and V tile: for each of the group's G heads in order,
//    for each visible query tile in ascending order, P and dS of the
//    (query, key) tile (from kernel 1's m, l, Δ) staged in shared memory,
//    then dK and dV accumulated in registers, query rows ascending.
//
// Tiles live in shared memory as float32 with an odd row pitch (DT + 1),
// so the 16 rows a half-warp reads at one column fall in distinct banks.
// 256 threads as 16 x 16: thread (ty, tx) owns score rows ty + 16a and
// columns tx + 16b of a BT x BT tile, and output rows ty + 16a, columns
// tx + 16c of a BT x DT tile.  DT (the head-dim tile, D <= DT) is 32, 64,
// 128 or 256; BT is 64, or 32 at DT = 256 to stay within shared memory.
// Products spell fmaf (the build has -fmad=false).
//
// Bound on the H100: operations -- 2·D FLOP for each of the five products
// (S recomputed, dP, dQ, dK, dV) per visible pair and head, 2.5 times the
// forward's two; this kernel recomputes S once more for the statistics --
// over the peak of the dtype's units.  wgmma, TMA and a forward that saves
// its log-sum-exp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (3, B, H, S): m, l, Δ
  int B, H, group, S, D;
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, has_window, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return i < p.S && j < p.S && (!p.causal || j <= i) &&
         (!p.has_window || j > i - p.window);
}

// rows [r0, r0 + BT) of a (b, head) slice into a BT x (DT + 1) float tile,
// zero past S and D
template <typename T, int BT, int DT>
__device__ void load_tile(float* dst, const T* base, const long long* st,
                          int b, int head, int r0, const Params& p) {
  const T* src = base + b * st[0] + head * st[1];
  for (int idx = threadIdx.x; idx < BT * DT; idx += NT) {
    const int r = idx / DT, c = idx % DT;
    const int row = r0 + r;
    float x = 0.f;
    if (row < p.S && c < p.D) x = to_f(src[row * st[2] + c]);
    dst[r * (DT + 1) + c] = x;
  }
}

// a sum over the 16 lanes of a half-warp (the tx of one ty)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

// s[a][b] = scale · q_row(ty + 16a) · k_row(tx + 16b), from shared tiles
template <int BT, int DT>
__device__ __forceinline__ void scores(float (&s)[BT / 16][BT / 16],
                                       const float* sQ, const float* sK,
                                       int ty, int tx, int D) {
  constexpr int R = BT / 16, LD = DT + 1;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) s[a][b] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qa[R], kb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < R; ++b) kb[b] = sK[(tx + 16 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
  }
}

template <typename T, int BT, int DT>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Params p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BT * LD;
  float* sK = sDO + BT * LD;
  float* sV = sK + BT * LD;
  float* sDS = sV + BT * LD;  // BT x (BT + 1)

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int i0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile<T, BT, DT>(sQ, q, p.sq, b, h, i0, p);
  load_tile<T, BT, DT>(sDO, dout, p.sdo, b, h, i0, p);

  // Δ of the thread's rows: its columns, then the half-warp's sum
  float delta[R];
  {
    const T* ob = o + b * p.so[0] + h * p.so[1];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty + 16 * a, row = i0 + r;
      float part = 0.f;
      if (row < p.S)
        for (int d = tx; d < p.D; d += 16)
          part = fmaf(sDO[r * LD + d], to_f(ob[row * p.so[2] + d]), part);
      delta[a] = sum16(part);
    }
  }

  // the visible key range of the tile's rows
  const int i_last = min(i0 + BT, p.S) - 1;
  int jlo = 0, jhi = p.causal ? i_last + 1 : p.S;
  if (p.has_window) jlo = max(0, i0 - p.window + 1);

  // pass 1: running max and denominator, keys ascending
  float m[R], l[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int j0 = jlo; j0 < jhi; j0 += BT) {
    __syncthreads();
    load_tile<T, BT, DT>(sK, k, p.sk, b, kvh, j0, p);
    __syncthreads();
    float s[R][R];
    scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = i0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = visible(p, i, j0 + tx + 16 * c) ? s[a][c] * p.scale
                                                   : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = max16(mx);
      // every lane of the warp takes part in the shuffles: a row with
      // nothing visible yet keeps m = -inf, l = 0
      const float m_new = fmaxf(m[a], mx);
      const bool none = m_new == -INFINITY;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) part += expf(s[a][c] - (none ? 0.f : m_new));
      part = sum16(part);
      l[a] = none ? 0.f : l[a] * expf(m[a] - m_new) + part;
      m[a] = m_new;
    }
  }

  // pass 2: dS, dQ
  float acc[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[a][c] = 0.f;
  for (int j0 = jlo; j0 < jhi; j0 += BT) {
    __syncthreads();
    load_tile<T, BT, DT>(sK, k, p.sk, b, kvh, j0, p);
    load_tile<T, BT, DT>(sV, v, p.sv, b, kvh, j0, p);
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
    scores<BT, DT>(dp, sDO, sV, ty, tx, p.D);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int col = tx + 16 * c;
        float ds = 0.f;
        if (visible(p, i, j0 + col) && l[a] > 0.f) {
          const float pr = expf(s[a][c] * p.scale - m[a]) / l[a];
          ds = pr * (dp[a][c] - delta[a]);
        }
        sDS[r * (BT + 1) + col] = ds;
      }
    }
    __syncthreads();
    const int jn = min(BT, p.S - j0);
    for (int j = 0; j < jn; ++j) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float ds = sDS[(ty + 16 * a) * (BT + 1) + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[a][c] = fmaf(ds, kv[c], acc[a][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
  const long long plane = (long long)p.B * p.H * p.S;
  float* st = p.stats + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) dq[row * p.sdq[2] + d] = from_f<T>(p.scale * acc[a][c]);
    }
    if (tx == 0) {
      st[row] = m[a];
      st[plane + row] = l[a];
      st[2 * plane + row] = delta[a];
    }
  }
}

template <typename T, int BT, int DT>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(Params p) {
  constexpr int R = BT / 16, C = DT / 16, LD = DT + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sDO = sQ + BT * LD;
  float* sP = sDO + BT * LD;      // BT x (BT + 1), [query][key]
  float* sDS = sP + BT * (BT + 1);
  float* sStat = sDS + BT * (BT + 1);  // m, l, Δ of the query tile's rows

  const int Hkv = p.H / p.group;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int j0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const long long plane = (long long)p.B * p.H * p.S;

  load_tile<T, BT, DT>(sK, static_cast<const T*>(p.k), p.sk, b, kvh, j0, p);
  load_tile<T, BT, DT>(sV, static_cast<const T*>(p.v), p.sv, b, kvh, j0, p);

  // the visible query range of the tile's keys
  const int j_last = min(j0 + BT, p.S) - 1;
  const int ilo = p.causal ? j0 : 0;
  int ihi = p.S;
  if (p.has_window) ihi = min(p.S, j_last + p.window);

  float dk[R][C], dv[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const float* st = p.stats + ((long long)b * p.H + h) * p.S;
    for (int i0 = ilo; i0 < ihi; i0 += BT) {
      __syncthreads();
      load_tile<T, BT, DT>(sQ, q, p.sq, b, h, i0, p);
      load_tile<T, BT, DT>(sDO, dout, p.sdo, b, h, i0, p);
      for (int r = threadIdx.x; r < BT; r += NT) {
        const int row = i0 + r;
        const bool in = row < p.S;
        sStat[r] = in ? st[row] : 0.f;
        sStat[BT + r] = in ? st[plane + row] : 0.f;
        sStat[2 * BT + r] = in ? st[2 * plane + row] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      scores<BT, DT>(s, sQ, sK, ty, tx, p.D);
      scores<BT, DT>(dp, sDO, sV, ty, tx, p.D);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = ty + 16 * a, i = i0 + r;
        const float m = sStat[r], l = sStat[BT + r], delta = sStat[2 * BT + r];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int col = tx + 16 * c;
          float pr = 0.f, ds = 0.f;
          if (visible(p, i, j0 + col) && l > 0.f) {
            pr = expf(s[a][c] * p.scale - m) / l;
            ds = pr * (dp[a][c] - delta);
          }
          sP[r * (BT + 1) + col] = pr;
          sDS[r * (BT + 1) + col] = ds;
        }
      }
      __syncthreads();
      const int rn = min(BT, p.S - i0);
      for (int r = 0; r < rn; ++r) {
        float qv[C], dov[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qv[c] = sQ[r * LD + tx + 16 * c];
          dov[c] = sDO[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const int j = ty + 16 * a;
          const float pr = sP[r * (BT + 1) + j];
          const float ds = sDS[r * (BT + 1) + j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv[a][c] = fmaf(pr, dov[c], dv[a][c]);
            dk[a][c] = fmaf(ds, qv[c], dk[a][c]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk[0] + kvh * p.sdk[1];
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv[0] + kvh * p.sdv[1];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = j0 + ty + 16 * a;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) {
        dkp[row * p.sdk[2] + d] = from_f<T>(p.scale * dk[a][c]);
        dvp[row * p.sdv[2] + d] = from_f<T>(dv[a][c]);
      }
    }
  }
}

template <int BT, int DT>
constexpr size_t dq_bytes() {
  return sizeof(float) * (4 * BT * (DT + 1) + BT * (BT + 1));
}
template <int BT, int DT>
constexpr size_t dkdv_bytes() {
  return sizeof(float) * (4 * BT * (DT + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <class K>
int launch(K kernel, size_t bytes, dim3 grid, cudaStream_t st, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_both(const Params& p, int Hkv, cudaStream_t st) {
  constexpr int BT = DT <= 128 ? 64 : 32;
  const int tiles = (p.S + BT - 1) / BT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  int err = launch(bwd_dq_kernel<T, BT, DT>, dq_bytes<BT, DT>(),
                   dim3(p.B * p.H, tiles), st, p);
  if (err != 0) return err;
  return launch(bwd_dkdv_kernel<T, BT, DT>, dkdv_bytes<BT, DT>(),
                dim3(p.B * Hkv, tiles), st, p);
}

template <typename T>
int launch_dtype(const Params& p, int Hkv, int tile_d, cudaStream_t st) {
  switch (tile_d) {
    case 32: return launch_both<T, 32>(p, Hkv, st);
    case 64: return launch_both<T, 64>(p, Hkv, st);
    case 128: return launch_both<T, 128>(p, Hkv, st);
    case 256: return launch_both<T, 256>(p, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bf16; tile_d the head-dim tile (32, 64, 128 or
// 256, D <= tile_d); strides per (b, head, s) in elements, D contiguous,
// in the order q, k, v, o, dO, dq, dk, dv; stats a float32 scratch of
// 3·B·H·S.  Two kernel launches on `stream`.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* stats, int dtype,
    int tile_d, int B, int H, int Hkv, int S, int D, const long long* strides,
    int causal, int has_window, int window, float scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 ||
      D > tile_d)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = stats;
  p.B = B;
  p.H = H;
  p.group = H / Hkv;
  p.S = S;
  p.D = D;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_dtype<float>(p, Hkv, tile_d, st);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(p, Hkv, tile_d, st);
  return (int)cudaErrorInvalidValue;
}
