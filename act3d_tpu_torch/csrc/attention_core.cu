// Single-head-layout attention forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel act3d_tpu/kernels/attention.py::
// _attention_core_fwd_impl (bodies _attn_kernel and _attn_kernel_masked,
// reached through attention_core).  Same contract:
//   q (BH, L, D) already scaled and rotated, k/v (BH, S, D), one head per
//   leading index, D any width up to 64; optional mask (BH, S) bytes
//   (non-zero = masked out).  Masked keys score -1e30 (not -inf), so a
//   fully masked row gets uniform weights, as on the TPU.
//   out (BH, L, D) = softmax(q k^T) v per leading index; no row stats.
// The TPU kernel has no backward kernel (its VJP is jnp), so neither has
// this one: the port's backward is plain PyTorch.
//
// What bounds it on the H100: 4*BH*L*S*D FLOPs (q k^T and p v, two FLOPs
// per multiply-add) against 67 TFLOP/s of float32 outside the tensor cores,
// plus BH*L*S exponentials; the bytes (q, k, v, out, each once) are a few
// MB at the training sites, so it is bound by operations.
//
// Design (simple and correct first; tensor cores and TMA are later work):
//   * the Pallas kernel keeps a whole (L-tile, S) score block in VMEM; at
//     S = 3126 (the Act3D ghost site) or S ~ 10^4 that does not fit a
//     block's shared memory, so the scores are never stored: K/V stream
//     through shared memory in tiles of 64 keys with an online softmax
//     (running max, running sum, D-wide accumulator in registers).
//   * one block per (query tile, leading index); 128 threads; a query row
//     is owned by a group of `tpr` threads of one warp (tpr a power of two
//     <= 32, chosen by the wrapper so that small-L calls fill the card); a
//     thread visits every tpr-th key, and the tpr partial states of a row
//     are merged with warp shuffles at the end.
//   * the shared-memory row stride is odd (D | 1) so the tpr lanes of a
//     group read distinct banks; loads are scalar (D = 15 rows are not
//     16-byte aligned).
//   * ragged L and S edges are masked in the kernel: rows >= L compute and
//     write nothing, keys >= S are never visited.
//   * head dims up to 64 (templated register arrays of 16, 32 or 64).
//   * exp is the accurate expf: the port holds the kernel to atol 2e-5
//     against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 64;
constexpr float kMaskedScore = -1e30f;

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int L, int S, int D, int tpr) {
  extern __shared__ float smem[];
  const int ds = D | 1;  // odd row stride
  float* k_s = smem;                 // [kKeyTile][ds]
  float* v_s = k_s + kKeyTile * ds;  // [kKeyTile][ds]
  uint8_t* m_s = reinterpret_cast<uint8_t*>(v_s + kKeyTile * ds);  // [kKeyTile]

  const size_t bh = blockIdx.y;
  const int rows_per_block = kThreads / tpr;
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int row = blockIdx.x * rows_per_block + group;
  const bool active = row < L;

  float qr[DMAX];
  float acc[DMAX];
  const float* q_row = q + (bh * L + (active ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    qr[c] = (active && c < D) ? q_row[c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const float* k_b = k + bh * S * D;
  const float* v_b = v + bh * S * D;
  const uint8_t* mask_b = mask ? mask + bh * S : nullptr;

  for (int s0 = 0; s0 < S; s0 += kKeyTile) {
    const int n = min(kKeyTile, S - s0);
    __syncthreads();  // the previous tile is no longer read
    // the tile's n rows of K and V are one contiguous span of n * D floats
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      k_s[j * ds + c] = k_b[(size_t)s0 * D + i];
      v_s[j * ds + c] = v_b[(size_t)s0 * D + i];
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      m_s[j] = mask_b ? mask_b[s0 + j] : 0;
    }
    __syncthreads();
    if (active) {
      for (int j = lane; j < n; j += tpr) {
        const float* kj = k_s + j * ds;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DMAX; ++c) {
          if (c < D) s = fmaf(qr[c], kj[c], s);
        }
        if (m_s[j]) s = kMaskedScore;
        if (s > m) {
          const float scale = expf(m - s);  // 0 while m is still -inf
          l *= scale;
#pragma unroll
          for (int c = 0; c < DMAX; ++c) acc[c] *= scale;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
        const float* vj = v_s + j * ds;
#pragma unroll
        for (int c = 0; c < DMAX; ++c) {
          if (c < D) acc[c] = fmaf(p, vj[c], acc[c]);
        }
      }
    }
  }

  // Merge the tpr partial states of each row.  A group is tpr consecutive
  // lanes of one warp, so xor offsets below tpr stay inside it; every lane
  // of the warp takes part (full mask), inactive rows carry (-inf, 0, 0).
  for (int off = tpr >> 1; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float sa = (m == -INFINITY) ? 0.f : expf(m - mn);
    const float sb = (mo == -INFINITY) ? 0.f : expf(mo - mn);
    l = l * sa + lo * sb;
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[c], off);
      acc[c] = acc[c] * sa + ao * sb;
    }
    m = mn;
  }

  if (active && lane == 0) {
    const float inv = 1.f / l;
    float* o_row = out + (bh * L + row) * D;
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      if (c < D) o_row[c] = acc[c] * inv;
    }
  }
}

template <int DMAX>
void launch(const float* q, const float* k, const float* v, const uint8_t* mask, float* out,
            int BH, int L, int S, int D, int tpr, cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const dim3 grid((L + rows_per_block - 1) / rows_per_block, BH);
  const size_t smem = 2 * kKeyTile * (D | 1) * sizeof(float) + kKeyTile;
  attention_core_kernel<DMAX><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, L, S, D,
                                                                tpr);
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; mask may be null.  Returns cudaGetLastError() after
// the launch (0 = success).
extern "C" int act3d_attention_core_f32(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int BH, int L, int S,
                                        int D, int tpr, void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || S < 1 || D < 1 || D > 64 || tpr < 1 || tpr > 32 ||
      (tpr & (tpr - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) {
    launch<16>(qf, kf, vf, mf, of, BH, L, S, D, tpr, st);
  } else if (D <= 32) {
    launch<32>(qf, kf, vf, mf, of, BH, L, S, D, tpr, st);
  } else {
    launch<64>(qf, kf, vf, mf, of, BH, L, S, D, tpr, st);
  }
  return (int)cudaGetLastError();
}
