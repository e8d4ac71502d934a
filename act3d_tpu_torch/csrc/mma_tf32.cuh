// Tensor-core products at float32 accuracy ("3xTF32") for the fused-MHA
// kernels (fused_mha_fwd.cu, fused_mha_bwd.cu), on mma.sync m16n8k8 TF32.
//
// A float32 x is split into big = tf32(x) (cvt.rna: 10 explicit mantissa
// bits, the low 13 bits of the float zero) and small = tf32(x - big).  The
// product a*b is accumulated in float32 as small_a*big_b + big_a*small_b +
// big_a*big_b; the dropped small*small term is below 2^-22 relative, so the
// result keeps float32's accuracy.  This is CUTLASS's "fast f32" scheme
// (OpMultiplyAddFastF32).  One TF32 pass alone keeps ~10 bits and would not.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A C fragment becomes the A operand of the next product without shuffles
// when that product's k index is permuted: A column t <-> k = 2t and column
// t+4 <-> k = 2t+1, i.e. a = (c0, c2, c1, c3), and the B operand is read at
// rows 2t and 2t+1 (act3d_c_as_a, act3d_load_b_perm).  The product pairs
// A's column j with B's row j; permuting both alike leaves it unchanged.

#pragma once

#include <stdint.h>

struct Tf32Pair {
  uint32_t big;
  uint32_t small;
};

__device__ __forceinline__ uint32_t act3d_to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Tf32Pair act3d_split_tf32(float x) {
  const uint32_t big = act3d_to_tf32(x);
  return {big, act3d_to_tf32(x - __uint_as_float(big))};
}

// c += a * b, one TF32 tensor-core product (16 x 8 x 8).
__device__ __forceinline__ void act3d_mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at float32 accuracy: three TF32 products, small terms first.
__device__ __forceinline__ void act3d_mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                                 const uint32_t (&as)[4],
                                                 const uint32_t (&bb)[2],
                                                 const uint32_t (&bs)[2]) {
  act3d_mma_tf32(c, as, bb);
  act3d_mma_tf32(c, ab, bs);
  act3d_mma_tf32(c, ab, bb);
}

// A operand (big, small) from a C fragment of the previous product, with
// the k permutation described above.
__device__ __forceinline__ void act3d_c_as_a(const float (&c)[4], uint32_t (&ab)[4],
                                             uint32_t (&as)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Pair p = act3d_split_tf32(a[i]);
    ab[i] = p.big;
    as[i] = p.small;
  }
}

// Shared-memory tiles hold operands already split: two float arrays (big,
// small) of the same [row][stride] layout.  Row stride = padded width + 4
// keeps the fragment reads below free of bank conflicts for widths 8, 16,
// 32 and 64.

// A fragment (rows r0..r0+15, k columns k0..k0+7) of a [row][stride] tile.
__device__ __forceinline__ void act3d_load_a(const float* big, const float* small,
                                             int stride, int r0, int k0, int g, int t,
                                             uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const int i0 = (r0 + g) * stride + k0 + t;
  const int i1 = i0 + 8 * stride;
  ab[0] = __float_as_uint(big[i0]);
  ab[1] = __float_as_uint(big[i1]);
  ab[2] = __float_as_uint(big[i0 + 4]);
  ab[3] = __float_as_uint(big[i1 + 4]);
  as[0] = __float_as_uint(small[i0]);
  as[1] = __float_as_uint(small[i1]);
  as[2] = __float_as_uint(small[i0 + 4]);
  as[3] = __float_as_uint(small[i1 + 4]);
}

// B fragment of X^T for X stored [n][stride]: b0 = X[n0+g][k0+t],
// b1 = X[n0+g][k0+t+4] (the key tile of q k^T, the row tile of k q^T).
__device__ __forceinline__ void act3d_load_bt(const float* big, const float* small,
                                              int stride, int n0, int k0, int g, int t,
                                              uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const int i = (n0 + g) * stride + k0 + t;
  bb[0] = __float_as_uint(big[i]);
  bb[1] = __float_as_uint(big[i + 4]);
  bs[0] = __float_as_uint(small[i]);
  bs[1] = __float_as_uint(small[i + 4]);
}

// B fragment of X stored [k][stride] under the k permutation of act3d_c_as_a:
// b0 = X[k0+2t][n0+g], b1 = X[k0+2t+1][n0+g] (v in p v, dO in p^T dO).
__device__ __forceinline__ void act3d_load_b_perm(const float* big, const float* small,
                                                  int stride, int k0, int n0, int g, int t,
                                                  uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const int i = (k0 + 2 * t) * stride + n0 + g;
  bb[0] = __float_as_uint(big[i]);
  bb[1] = __float_as_uint(big[i + stride]);
  bs[0] = __float_as_uint(small[i]);
  bs[1] = __float_as_uint(small[i + stride]);
}

// Stores x split into a [row][stride] tile pair.
__device__ __forceinline__ void act3d_store_split(float* big, float* small, int i, float x) {
  const Tf32Pair p = act3d_split_tf32(x);
  big[i] = __uint_as_float(p.big);
  small[i] = __uint_as_float(p.small);
}

// Stages rows [0, n8) x [0, DP) of two head slices (row stride E floats; n
// valid rows, d valid columns, zeros elsewhere) into split tile pairs of
// row stride SD: k and v, or q and dO.  Each thread issues kBatch loads of
// each source before its stores, so the loads are in flight together.
template <int DP, int SD>
__device__ __forceinline__ void act3d_stage_pair(const float* __restrict__ a,
                                                 const float* __restrict__ b, int E,
                                                 int n, int n8, int d, float* a_big,
                                                 float* a_small, float* b_big,
                                                 float* b_small) {
  constexpr int kBatch = 4;
  const int total = n8 * DP;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float xa[kBatch], xb[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / DP;
      const int c = i % DP;
      xa[u] = 0.f;
      xb[u] = 0.f;
      if (i < total && j < n && c < d) {
        xa[u] = a[(size_t)j * E + c];
        xb[u] = b[(size_t)j * E + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int at = (i / DP) * SD + i % DP;
        act3d_store_split(a_big, a_small, at, xa[u]);
        act3d_store_split(b_big, b_small, at, xb[u]);
      }
    }
  }
}
