// WKV6 backward (B7-bwd): the gradients of the RWKV6 (Finch) time-mix scan
// of wkv6.cu.  Per (batch, head), with head dim D, rows t = 0 .. T-1, the
// state S_{-1} = s0 and w_t = exp(clamp(lw_t, -3.5, 0)):
//
//     y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
//     S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
//
// and dS_t the gradient of the state after row t (dS_{T-1} = ds_fin, or 0):
//
//     dS_{t-1} = diag(w_t) dS_t + r_t ⊗ dy_t
//     dr_t  = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)
//     dk_t  = dS_t v_t + u ⊙ r_t (v_t · dy_t)
//     dv_t  = dS_tᵀ k_t + (Σ_i r_ti u_i k_ti) dy_t
//     du    = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t)
//     dlw_t = w_t ⊙ Σ_j dS_t[:, j] ⊙ S_{t-1}[:, j], where lw_t lies in
//             [-3.5, 0] (ends included, torch.clamp's rule), else 0
//     ds0   = dS_{-1}
//
// Replaces no TPU kernel: the reference has no backward kernel (its model
// differentiates the XLA chunked scan, src/repro/kernels/wkv6/ops.py,
// _wkv6_xla_chunked); this is the gradient of the port's B7 (wkv6.cu,
// which replaces wkv6_pallas, src/repro/kernels/wkv6/wkv6.py:99).  The
// plain version is wkv6_bwd_ref (kernels/wkv6/ref.py).
//
// Design (CUDA cores, float32, one launch).  Row i of S and of dS is a
// closed recurrence (S_t[i, :] = w_ti S_{t-1}[i, :] + k_ti v_t), and so is
// column j of dS.  dr, dk and dlw of channel i need row i of S and dS
// only; dv of column j needs column j of dS.  So a block is one warp, two
// lanes to a row (or column) and 32 of its elements in each lane's
// registers, 16 rows (or columns) a block, and the grid is (B·H, 8):
//
// * blockIdx.y < 4 ("rows"): a forward sweep over t rebuilds S row by row
//   and writes dr_t, q_t = r_ti (S_{t-1} dy_t)_i and the block's share of
//   du; then a reverse sweep carries dS and writes dk_t and dlw_t.  dlw
//   needs S_{t-1} and dS_t together, which the two sweeps visit in
//   opposite orders.  Instead of storing the states (B·H·T·D² floats, or
//   per chunk and recomputed) it carries P_t = Σ_j dS_t[i, j] S_t[i, j]
//   backwards: since w_t S_{t-1} = S_t - k_t ⊗ v_t,
//       dlw_t = P_t - k_ti (dS_t v_t)_i,   P_{t-1} = dlw_t + q_t,
//   from P_{T-1} = Σ_j ds_fin[i, j] S_{T-1}[i, j] (S_{T-1} is what the
//   forward sweep ends with).  q_t waits in dlw's own slot between the two
//   sweeps, and comes back a chunk ahead of its use.  The terms of P are of the size of dlw's (S_t and w_t S_{t-1}
//   differ by one row's k ⊗ v), so the recurrence adds rounding of the
//   order of T^½ float32 ulps of P;
// * blockIdx.y >= 4 ("cols"): a reverse sweep carries columns of dS and
//   writes dv_t; each staged chunk's w and Σ_i r u k are formed once in
//   shared memory.
//
// The two lanes of a row add their halves with one shuffle, each getting
// the same bits.  du's per-(b, h) partials go to du_part (B, H, D) and the
// wrapper sums them over b with one torch.sum in a fixed order: no
// atomics, so two runs give the same bits.  Inputs r, k, lw, v, dy arrive
// by cp.async in a two-stage ring of 8-row chunks (all D channels of each,
// rows past T zero-filled), read through (b, h, t) strides with D
// contiguous (16-byte aligned bases and strides); dr, dk, dv, dlw are
// written through their own strides, so the model's (B, T, H, D) views
// take their gradients in place.  Any output may be null (not computed);
// s0 and ds_fin null mean zero.  Only D = 64 is built (RWKV_HEAD_DIM, the
// head dim of every registry model); the wrapper zero-pads a smaller D
// (padded channels carry r = k = v = dy = 0, lw = 0, which add nothing),
// and refuses a wider one.
//
// Bound on the H100: r, k, v, lw, dy read and dr, dk, dv, dlw written
// (9 · B·H·T·D floats) at 3.35 TB/s against 12 D² FLOP a (b, h, t) (the
// state's rebuild 3 D², dS's 3 D², dr, dk and dv's sums 2 D² each; dlw
// takes O(D) a row through the telescoping P) at the CUDA cores' 67
// TFLOP/s: operations bind, ~0.060 ms at (2, 40, 1024, 64).  This kernel
// does 15 D² (dS twice, one per block kind) at one warp a block, and
// is latency-bound: each step's sums over a lane's 32 elements are chains
// of dependent fmaf split two ways.  Tensor cores, TMA and a chunked form
// are for a later redesign.  The build's -fmad=false forbids contraction
// the compiler would choose; the multiply-adds are spelled with fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;           // the one head dim built
constexpr int HALF = D / 2;     // elements of a row (column) in one lane
constexpr int OWN = 16;         // rows (columns) of a block: 32 lanes / 2
constexpr int GROUPS = D / OWN; // blocks of each kind per (b, h)
constexpr int CH = 8;           // rows of a staged chunk
// a staged row: channels 0..31 at 0..31, channels 32..63 at 36..67, so
// the two halves' float4 broadcasts fall in different banks
constexpr int LS = D + 4;
constexpr int NIN = 5;          // staged inputs: r, k, lw, v, dy
constexpr int STAGE = NIN * CH * LS;  // floats
constexpr float LOG_W_MIN = -3.5f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* in[NIN];  // r, k, lw, v, dy: (B, H, T, D) through strides
  const float* u;        // (H, D)
  const float* s0;       // (B, H, D, D) contiguous, or null (zeros)
  const float* ds_fin;   // (B, H, D, D) contiguous, or null (zeros)
  float* out[4];         // dr, dk, dv, dlw: (B, H, T, D), or null
  float* du_part;        // (B, H, D), or null
  float* ds0;            // (B, H, D, D) contiguous, or null
  long long si[NIN][3];  // (b, h, t) element strides of the inputs
  long long so[4][3];    // ... and of the outputs
  int H, T;
};

__device__ __forceinline__ int sidx(int c) { return c + ((c >> 5) << 2); }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float clamp_lw(float x) {
  // jnp.clip order, as wkv6.cu: max with the floor, then min with 0
  x = x < LOG_W_MIN ? LOG_W_MIN : x;
  return x > 0.0f ? 0.0f : x;
}

// chunk c's rows of the five inputs into ring slot ``slot``
__device__ __forceinline__ void stage(float* sm, const float* const (&g)[NIN],
                                      const long long (&ts)[NIN], int T,
                                      int c, int slot) {
  float* base = sm + slot * STAGE;
  const int t0 = c * CH;
  constexpr int PIECES = D / 4;  // 16-byte pieces of a row
#pragma unroll
  for (int x = 0; x < NIN; ++x)
#pragma unroll
    for (int e = threadIdx.x; e < CH * PIECES; e += 32) {
      const int t = e / PIECES, p = e % PIECES;
      const bool ok = t0 + t < T;
      const long long row = ok ? t0 + t : 0;
      cp_async16(base + (x * CH + t) * LS + sidx(4 * p),
                 g[x] + row * ts[x] + 4 * p, ok);
    }
  cp_async_commit();
}

// the sum of a lane's part and its pair's (both lanes get the same bits)
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(FULL, x, 1);
}

__global__ void __launch_bounds__(32) wkv6_bwd_kernel(Args a) {
  __shared__ __align__(16) float sm[2 * STAGE];
  __shared__ float us[D];
  __shared__ float bonus[CH];

  const int lane = threadIdx.x;
  const int bh = blockIdx.x;
  const long long b = bh / a.H;
  const int h = bh % a.H;
  const bool rows = blockIdx.y < GROUPS;
  const int own = (blockIdx.y % GROUPS) * OWN + (lane >> 1);
  const int c0 = (lane & 1) * HALF;  // the lane's first element
  const bool lead = (lane & 1) == 0; // the pair's writer
  const int T = a.T;
  const int nc = (T + CH - 1) / CH;
  const long long sb = (long long)bh * D * D;

  if (rows ? !(a.out[0] || a.out[1] || a.out[3] || a.du_part || a.ds0)
           : !a.out[2])
    return;

  const float* g[NIN];
  long long ts[NIN];
#pragma unroll
  for (int x = 0; x < NIN; ++x) {
    g[x] = a.in[x] + b * a.si[x][0] + h * a.si[x][1];
    ts[x] = a.si[x][2];
  }
  float* og[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    og[x] = a.out[x] == nullptr ? nullptr
                                : a.out[x] + b * a.so[x][0] + h * a.so[x][1];
  for (int i = lane; i < D; i += 32) us[i] = a.u[(long long)h * D + i];

  if (rows) {
    const int i = own;
    float S[HALF];
#pragma unroll
    for (int e = 0; e < HALF; ++e)
      S[e] = a.s0 == nullptr ? 0.0f : a.s0[sb + (long long)i * D + c0 + e];
    float du = 0.0f;
    float* dlw = og[3];

    // the chunks in order (forward sweep), then in reverse (backward)
    if (nc > 0) stage(sm, g, ts, T, 0, 0);
    for (int s = 0; s < nc; ++s) {
      cp_async_wait_all();
      __syncthreads();
      stage(sm, g, ts, T, s + 1 < nc ? s + 1 : nc - 1, (s + 1) & 1);
      const float* st = sm + (s & 1) * STAGE;
      const int t0 = s * CH, n = min(CH, T - t0);
      const float uu = us[i];
      for (int tt = 0; tt < n; ++tt) {
        const float* rr = st + (0 * CH + tt) * LS;
        const float* kr = st + (1 * CH + tt) * LS;
        const float* lr = st + (2 * CH + tt) * LS;
        const float* vr = st + (3 * CH + tt) * LS + sidx(c0);
        const float* yr = st + (4 * CH + tt) * LS + sidx(c0);
        const float ri = rr[sidx(i)], ki = kr[sidx(i)];
        const float w = exp2f(clamp_lw(lr[sidx(i)]) * LOG2E);
        float sdy0 = 0.0f, sdy1 = 0.0f, vdy0 = 0.0f, vdy1 = 0.0f;
#pragma unroll
        for (int q = 0; q < HALF / 4; ++q) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * q);
          const float4 yy = *reinterpret_cast<const float4*>(yr + 4 * q);
          sdy0 = fmaf(S[4 * q + 0], yy.x, sdy0);
          sdy1 = fmaf(S[4 * q + 1], yy.y, sdy1);
          sdy0 = fmaf(S[4 * q + 2], yy.z, sdy0);
          sdy1 = fmaf(S[4 * q + 3], yy.w, sdy1);
          vdy0 = fmaf(vv.x, yy.x, vdy0);
          vdy1 = fmaf(vv.y, yy.y, vdy1);
          vdy0 = fmaf(vv.z, yy.z, vdy0);
          vdy1 = fmaf(vv.w, yy.w, vdy1);
          S[4 * q + 0] = fmaf(w, S[4 * q + 0], ki * vv.x);
          S[4 * q + 1] = fmaf(w, S[4 * q + 1], ki * vv.y);
          S[4 * q + 2] = fmaf(w, S[4 * q + 2], ki * vv.z);
          S[4 * q + 3] = fmaf(w, S[4 * q + 3], ki * vv.w);
        }
        const float sdy = pair_sum(sdy0 + sdy1);  // (S_{t-1} dy_t)_i
        const float vdy = pair_sum(vdy0 + vdy1);  // v_t · dy_t
        const long long t = t0 + tt;
        if (lead) {
          if (og[0]) og[0][t * a.so[0][2] + i] = fmaf(uu * ki, vdy, sdy);
          if (dlw) dlw[t * a.so[3][2] + i] = ri * sdy;  // q_t, for later
        }
        du = fmaf(ri * ki, vdy, du);
      }
    }

    // S is S_{T-1}: start dS from ds_fin and P from Σ_j ds_fin S_{T-1}
    float dS[HALF];
    float P = 0.0f;
#pragma unroll
    for (int e = 0; e < HALF; ++e) {
      dS[e] = a.ds_fin == nullptr ? 0.0f
                                  : a.ds_fin[sb + (long long)i * D + c0 + e];
      P = fmaf(dS[e], S[e], P);
    }
    P = pair_sum(P);

    // the q_t of a chunk are read one chunk ahead, into registers: P's
    // chain then waits on no load
    const bool with_q = dlw != nullptr && lead;
    float qn[CH];
#pragma unroll
    for (int x = 0; x < CH; ++x)
      qn[x] = with_q && (nc - 1) * CH + x < T
                  ? dlw[((long long)(nc - 1) * CH + x) * a.so[3][2] + i]
                  : 0.0f;
    for (int s = 0; s < nc; ++s) {
      const int c = nc - 1 - s;  // slot (nc + s) & 1 holds chunk c
      cp_async_wait_all();
      __syncthreads();
      if (c > 0) stage(sm, g, ts, T, c - 1, (nc + s + 1) & 1);
      const float* st = sm + ((nc + s) & 1) * STAGE;
      const int t0 = c * CH, n = min(CH, T - t0);
      const float uu = us[i];
      float qc[CH];
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        qc[x] = qn[x];
        if (with_q && c > 0)  // chunk c - 1 is whole
          qn[x] = dlw[((long long)(c - 1) * CH + x) * a.so[3][2] + i];
      }
#pragma unroll
      for (int tt = CH - 1; tt >= 0; --tt) {
        if (tt >= n) continue;
        const float* rr = st + (0 * CH + tt) * LS;
        const float* kr = st + (1 * CH + tt) * LS;
        const float* lr = st + (2 * CH + tt) * LS;
        const float* vr = st + (3 * CH + tt) * LS + sidx(c0);
        const float* yr = st + (4 * CH + tt) * LS + sidx(c0);
        const float ri = rr[sidx(i)], ki = kr[sidx(i)], lwi = lr[sidx(i)];
        const float w = exp2f(clamp_lw(lwi) * LOG2E);
        float dsv0 = 0.0f, dsv1 = 0.0f, vdy0 = 0.0f, vdy1 = 0.0f;
#pragma unroll
        for (int q = 0; q < HALF / 4; ++q) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * q);
          const float4 yy = *reinterpret_cast<const float4*>(yr + 4 * q);
          dsv0 = fmaf(dS[4 * q + 0], vv.x, dsv0);
          dsv1 = fmaf(dS[4 * q + 1], vv.y, dsv1);
          dsv0 = fmaf(dS[4 * q + 2], vv.z, dsv0);
          dsv1 = fmaf(dS[4 * q + 3], vv.w, dsv1);
          vdy0 = fmaf(vv.x, yy.x, vdy0);
          vdy1 = fmaf(vv.y, yy.y, vdy1);
          vdy0 = fmaf(vv.z, yy.z, vdy0);
          vdy1 = fmaf(vv.w, yy.w, vdy1);
          dS[4 * q + 0] = fmaf(w, dS[4 * q + 0], ri * yy.x);
          dS[4 * q + 1] = fmaf(w, dS[4 * q + 1], ri * yy.y);
          dS[4 * q + 2] = fmaf(w, dS[4 * q + 2], ri * yy.z);
          dS[4 * q + 3] = fmaf(w, dS[4 * q + 3], ri * yy.w);
        }
        const float dsv = pair_sum(dsv0 + dsv1);  // (dS_t v_t)_i
        const float vdy = pair_sum(vdy0 + vdy1);
        const long long t = t0 + tt;
        if (lead) {
          if (og[1]) og[1][t * a.so[1][2] + i] = fmaf(uu * ri, vdy, dsv);
          if (dlw) {
            float* p = dlw + t * a.so[3][2] + i;
            const float g_lw = fmaf(-ki, dsv, P);  // P_t - k_ti (dS_t v_t)_i
            P = g_lw + qc[tt];                     // + q_t: P_{t-1}
            *p = (lwi >= LOG_W_MIN && lwi <= 0.0f) ? g_lw : 0.0f;
          }
        }
      }
    }
    if (a.ds0)
#pragma unroll
      for (int e = 0; e < HALF; ++e)
        a.ds0[sb + (long long)i * D + c0 + e] = dS[e];
    if (a.du_part && lead) a.du_part[(long long)bh * D + i] = du;
    return;
  }

  // columns: column j of dS over rows c0 .. c0 + 31, in reverse
  const int j = own;
  float dS[HALF];
#pragma unroll
  for (int e = 0; e < HALF; ++e)
    dS[e] = a.ds_fin == nullptr ? 0.0f
                                : a.ds_fin[sb + (long long)(c0 + e) * D + j];
  if (nc > 0) stage(sm, g, ts, T, nc - 1, 0);
  for (int s = 0; s < nc; ++s) {
    const int c = nc - 1 - s;
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) stage(sm, g, ts, T, c - 1, (s + 1) & 1);
    float* st = sm + (s & 1) * STAGE;
    const int t0 = c * CH, n = min(CH, T - t0);
    // w in place of lw, and each row's Σ_i r_i u_i k_i: four lanes a row
    for (int e = lane; e < CH * D; e += 32) {
      float* p = st + (2 * CH + e / D) * LS + sidx(e % D);
      *p = exp2f(clamp_lw(*p) * LOG2E);
    }
    {
      const int t = lane >> 2, part = (lane & 3) * (D / 4);
      const float* rr = st + (0 * CH + t) * LS;
      const float* kr = st + (1 * CH + t) * LS;
      float acc = 0.0f;
#pragma unroll
      for (int e = 0; e < D / 4; ++e) {
        const int ch = part + e;
        acc = fmaf(rr[sidx(ch)] * us[ch], kr[sidx(ch)], acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      if ((lane & 3) == 0) bonus[t] = acc;
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      const float* rr = st + (0 * CH + tt) * LS + sidx(c0);
      const float* kr = st + (1 * CH + tt) * LS + sidx(c0);
      const float* wr = st + (2 * CH + tt) * LS + sidx(c0);
      const float yj = st[(4 * CH + tt) * LS + sidx(j)];
      float dv0 = 0.0f, dv1 = 0.0f;
#pragma unroll
      for (int q = 0; q < HALF / 4; ++q) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * q);
        const float4 ww = *reinterpret_cast<const float4*>(wr + 4 * q);
        const float4 rv = *reinterpret_cast<const float4*>(rr + 4 * q);
        dv0 = fmaf(dS[4 * q + 0], kk.x, dv0);
        dv1 = fmaf(dS[4 * q + 1], kk.y, dv1);
        dv0 = fmaf(dS[4 * q + 2], kk.z, dv0);
        dv1 = fmaf(dS[4 * q + 3], kk.w, dv1);
        dS[4 * q + 0] = fmaf(ww.x, dS[4 * q + 0], rv.x * yj);
        dS[4 * q + 1] = fmaf(ww.y, dS[4 * q + 1], rv.y * yj);
        dS[4 * q + 2] = fmaf(ww.z, dS[4 * q + 2], rv.z * yj);
        dS[4 * q + 3] = fmaf(ww.w, dS[4 * q + 3], rv.w * yj);
      }
      const float dv = pair_sum(dv0 + dv1);  // (dS_tᵀ k_t)_j
      if (lead)
        og[2][(t0 + tt) * a.so[2][2] + j] = fmaf(bonus[tt], yj, dv);
    }
  }
}

bool aligned16(const float* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

}  // namespace

// r, k, v, lw, dy: (B, H, T, D) float32 with D contiguous, 16-byte aligned
// bases and (b, h, t) strides; dr, dk, dv, dlw: (B, H, T, D) float32 with
// D contiguous, or null (not computed).  st holds the (b, h, t, d) element
// strides of r, k, v, lw, dy, dr, dk, dv, dlw, 4 per tensor in that order
// (the stride of a dimension of size 1 is ignored; a null output's are not
// read).  u: (H, D); s0, ds_fin (null: zeros) and ds0 (null: not
// computed): (B, H, D, D) contiguous; du_part (null: not computed):
// (B, H, D), each (b, h)'s share of du.  Returns a cudaError_t:
// cudaErrorInvalidValue for D != 64, a negative size, D not contiguous or
// an input not 16-byte aligned.
extern "C" int wkv6_bwd_launch(const float* r, const float* k, const float* v,
                               const float* lw, const float* dy,
                               const float* u, const float* s0,
                               const float* ds_fin, float* dr, float* dk,
                               float* dv, float* dlw, float* du_part,
                               float* ds0, int B, int H, int T, int Dh,
                               const long long* st, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || H < 0 || T < 0 || Dh != D) return bad;
  const int BH = B * H;
  if (BH == 0) return 0;
  Args a;
  const float* const ins[NIN] = {r, k, lw, v, dy};
  const int in_st[NIN] = {0, 1, 3, 2, 4};  // where each input's strides are
  float* const outs[4] = {dr, dk, dv, dlw};
  const int size[3] = {B, H, T};
  for (int x = 0; x < NIN; ++x) {
    const long long* s = st + 4 * in_st[x];
    if (s[3] != 1) return bad;
    a.in[x] = ins[x];
    for (int d = 0; d < 3; ++d) a.si[x][d] = size[d] > 1 ? s[d] : 0;
    if (!aligned16(ins[x], a.si[x])) return bad;
  }
  for (int x = 0; x < 4; ++x) {
    const long long* s = st + 4 * (NIN + x);
    a.out[x] = outs[x];
    for (int d = 0; d < 3; ++d) a.so[x][d] = size[d] > 1 ? s[d] : 0;
    if (outs[x] != nullptr && s[3] != 1) return bad;
  }
  a.u = u;
  a.s0 = s0;
  a.ds_fin = ds_fin;
  a.du_part = du_part;
  a.ds0 = ds0;
  a.H = H;
  a.T = T;
  wkv6_bwd_kernel<<<dim3(BH, 2 * GROUPS), 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
