// 3xTF32 tensor-core products shared by B7's forward and backward kernels
// (wkv6.cu, wkv6_bwd.cu) and B6's float32 ones (flash_attention.cu,
// flash_attention_bwd.cu): mma.sync.m16n8k8 with TF32 operands and
// float32 accumulators, each float32 operand split into a TF32 hi part
// and a TF32 lo part of the remainder, and lo·hi + hi·lo + hi·hi summed in
// float32 -- ~2^-21 relative, where one TF32 product gives ~5e-4.
// Included by each source, which is its own library: everything here has
// internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x = hi + lo + O(2^-21 |x|): hi is x rounded to TF32 by integer ops (add
// half a TF32 ulp, clear the 13 low bits: full-rate ALU work, where the
// cvt instruction would not be), lo the exact remainder, which the tensor
// core reads as TF32 by dropping its 13 low bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));  // exact
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0..a3) and a B fragment (b0, b1), split into hi and lo.
// With gid = lane / 4 and tig = lane % 4: a0 = A[gid][tig], a1 =
// A[gid + 8][tig], a2 = A[gid][tig + 4], a3 = A[gid + 8][tig + 4]; b0 =
// B[tig][gid], b1 = B[tig + 4][gid]; the accumulator d holds D[gid][2 tig],
// D[gid][2 tig + 1], D[gid + 8][2 tig], D[gid + 8][2 tig + 1].  The k index
// may be permuted as long as A and B agree: an accumulator's pair of
// columns (2 tig, 2 tig + 1) is then the k slots (tig, tig + 4), so an
// accumulator is an A operand (FragA(d0, d2, d1, d3)) or a B operand
// (FragB(d0, d1) for its rows gid) without moving through shared memory.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ FragB(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32: the two cross terms first, then the large product
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// two (four) independent products in 3xTF32, the passes interleaved so that
// no mma waits on the one just before it; each accumulator sees the terms
// in mma3's order, so the sums are mma3's bits
__device__ __forceinline__ void mma3x2(float (&d0)[4], const FragA& a0,
                                       const FragB& b0, float (&d1)[4],
                                       const FragA& a1, const FragB& b1) {
  mma_tf32(d0, a0.lo, b0.hi[0], b0.hi[1]);
  mma_tf32(d1, a1.lo, b1.hi[0], b1.hi[1]);
  mma_tf32(d0, a0.hi, b0.lo[0], b0.lo[1]);
  mma_tf32(d1, a1.hi, b1.lo[0], b1.lo[1]);
  mma_tf32(d0, a0.hi, b0.hi[0], b0.hi[1]);
  mma_tf32(d1, a1.hi, b1.hi[0], b1.hi[1]);
}

__device__ __forceinline__ void mma3x4(float (&d0)[4], const FragA& a0,
                                       const FragB& b0, float (&d1)[4],
                                       const FragA& a1, const FragB& b1,
                                       float (&d2)[4], const FragA& a2,
                                       const FragB& b2, float (&d3)[4],
                                       const FragA& a3, const FragB& b3) {
  mma_tf32(d0, a0.lo, b0.hi[0], b0.hi[1]);
  mma_tf32(d1, a1.lo, b1.hi[0], b1.hi[1]);
  mma_tf32(d2, a2.lo, b2.hi[0], b2.hi[1]);
  mma_tf32(d3, a3.lo, b3.hi[0], b3.hi[1]);
  mma_tf32(d0, a0.hi, b0.lo[0], b0.lo[1]);
  mma_tf32(d1, a1.hi, b1.lo[0], b1.lo[1]);
  mma_tf32(d2, a2.hi, b2.lo[0], b2.lo[1]);
  mma_tf32(d3, a3.hi, b3.lo[0], b3.lo[1]);
  mma_tf32(d0, a0.hi, b0.hi[0], b0.hi[1]);
  mma_tf32(d1, a1.hi, b1.hi[0], b1.hi[1]);
  mma_tf32(d2, a2.hi, b2.hi[0], b2.hi[1]);
  mma_tf32(d3, a3.hi, b3.hi[0], b3.hi[1]);
}

// 3xTF32 operands as split_tf32 splits them, but with hi the float32
// value truncated to TF32 (its 13 low bits cleared, one ALU op) rather
// than rounded (two): x = hi + lo exactly, |lo| < 2^-10 |x|, the tensor core
// reading lo as TF32 by dropping its own 13 low bits -- ~2^-20 relative a
// product where the rounded split gives ~2^-21, for a third fewer split
// instructions
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));  // exact
}

struct TfA {
  uint32_t hi[4], lo[4];
  TfA() = default;  // or filled by the caller from split planes
  __device__ __forceinline__ TfA(float a0, float a1, float a2, float a3) {
    split_trunc(a0, hi[0], lo[0]);
    split_trunc(a1, hi[1], lo[1]);
    split_trunc(a2, hi[2], lo[2]);
    split_trunc(a3, hi[3], lo[3]);
  }
};

struct TfB {
  uint32_t hi[2], lo[2];
  TfB() = default;
  __device__ __forceinline__ TfB(float b0, float b1) {
    split_trunc(b0, hi[0], lo[0]);
    split_trunc(b1, hi[1], lo[1]);
  }
};

// the NB products acc[n] += a b[n] in 3xTF32, lo·hi, hi·lo, then hi·hi
// into each accumulator (mma3's order), the passes interleaved across n
template <int NB>
__device__ __forceinline__ void mma3_rows(float (*acc)[4], const TfA& a,
                                          const TfB (&b)[NB]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32(acc[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32(acc[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32(acc[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

}  // namespace
