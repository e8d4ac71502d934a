// bf16 tensor-core products for the bf16 entries of the fused-MHA kernels
// (fused_mha_fwd.cu, fused_mha_bwd.cu), on mma.sync m16n8k16 with bf16
// operands and float32 accumulation: one pass, since a bf16 operand needs
// no big/small split (mma_tf32.cuh's scheme is for float32 operands).
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4).  Each 32-bit
// register holds two bf16, the lower k index in the low half:
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):             c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The C fragments of two neighbouring n tiles (columns 0-7 and 8-15) are
// the A operand of a product over those 16 columns as k, with no shuffle:
// a0 = (c0, c1) and a1 = (c2, c3) of the first tile, a2 and a3 the same of
// the second (act3d_bf16_c_as_a).  So a B operand is two bf16 of one
// column at neighbouring k: the kernels keep such operands transposed in
// shared memory ([n][k]), where the pair is one aligned 32-bit word, as it
// is for a row-major A and for B = X^T with X stored [n][k].
//
// Shared-memory tiles are uint16_t arrays of bf16 bits with an even row stride of
// width + 8 elements, which keeps the fragment reads below free of bank
// conflicts for widths 16, 32, 64 and 128.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// bf16 values travel as their 16 bits (uint16_t): loads, stores and
// copies need no conversion, and a bf16 zero is 0.
__device__ __forceinline__ uint16_t act3d_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float act3d_from_bf16(uint16_t x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// A float32 result stored as float32 or as bf16, by the output's type.
__device__ __forceinline__ void act3d_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void act3d_store(uint16_t* p, float x) { *p = act3d_to_bf16(x); }

// Two floats rounded to nearest bf16, lo in the low half.
__device__ __forceinline__ uint32_t act3d_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// c += a * b, one bf16 tensor-core product (16 x 8 x 16), float32 sums.
__device__ __forceinline__ void act3d_mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 32-bit word of the two bf16 at x[i], x[i + 1] (i even).
__device__ __forceinline__ uint32_t act3d_word(const uint16_t* x, int i) {
  return *reinterpret_cast<const uint32_t*>(x + i);
}

// A fragment (rows r0..r0+15, k columns k0..k0+15) of a row-major
// [row][stride] tile.
__device__ __forceinline__ void act3d_bf16_load_a(const uint16_t* x, int stride, int r0, int k0,
                                                  int g, int t, uint32_t (&a)[4]) {
  const int i0 = (r0 + g) * stride + k0 + 2 * t;
  const int i1 = i0 + 8 * stride;
  a[0] = act3d_word(x, i0);
  a[1] = act3d_word(x, i1);
  a[2] = act3d_word(x, i0 + 8);
  a[3] = act3d_word(x, i1 + 8);
}

// B fragment (k0..k0+15 x n0..n0+7) of a tile stored [n][stride] (its k
// along the row): b0 = X[n0+g][k0+2t..], b1 = X[n0+g][k0+2t+8..].
__device__ __forceinline__ void act3d_bf16_load_b(const uint16_t* x, int stride, int n0, int k0,
                                                  int g, int t, uint32_t (&b)[2]) {
  const int i = (n0 + g) * stride + k0 + 2 * t;
  b[0] = act3d_word(x, i);
  b[1] = act3d_word(x, i + 8);
}

// A operand (16 rows x 16 k) from the C fragments of two neighbouring n
// tiles, each value rounded to bf16 here.
__device__ __forceinline__ void act3d_bf16_c_as_a(const float (&c0)[4], const float (&c1)[4],
                                                  uint32_t (&a)[4]) {
  a[0] = act3d_pack_bf16(c0[0], c0[1]);
  a[1] = act3d_pack_bf16(c0[2], c0[3]);
  a[2] = act3d_pack_bf16(c1[0], c1[1]);
  a[3] = act3d_pack_bf16(c1[2], c1[3]);
}

// Stages rows [0, rows) x [0, DP) of a head slice (row stride E elements;
// n valid rows, d valid columns, zeros elsewhere) into a row-major tile
// [row][sr] and, where trans is not null, into its transpose [col][st]
// (rowmaj may be null too).  Each thread issues kBatch loads before its
// stores, so they are in flight together.
template <int DP>
__device__ __forceinline__ void act3d_stage_bf16(const uint16_t* __restrict__ src, int E,
                                                 int n, int rows, int d, uint16_t* rowmaj,
                                                 int sr, uint16_t* trans, int st) {
  constexpr int kBatch = 4;
  const int total = rows * DP;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    uint16_t x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / DP;
      const int c = i % DP;
      x[u] = (i < total && j < n && c < d) ? src[(size_t)j * E + c] : (uint16_t)0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int j = i / DP;
        const int c = i % DP;
        if (rowmaj) rowmaj[j * sr + c] = x[u];
        if (trans) trans[c * st + j] = x[u];
      }
    }
  }
}
