// Fused multi-head attention forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel act3d_tpu/kernels/attention.py::_mha_fwd_body
// (plain, key-padding-masked and the two dropout variants; reached through
// fused_mha / _fused_mha_fwd_impl).  Same contract:
//   q (B, L, E) already scaled and rotated, k/v (B, S, E), optional
//   mask (B, S) bytes (non-zero = masked out), E = H * d.  Heads are the
//   contiguous lane slices [h*d, (h+1)*d) of E, read in place: no
//   (B, H, L, d) copy is made.  Masked keys score -1e30 (not -inf), so a
//   fully masked row gets uniform weights, as on the TPU.
//   out (B, L, E) = softmax(q k^T) v per head; stats (B, L, 2H) float32
//   with the row max m at lane 2h and l = sum exp(s - m) at lane 2h+1.
//   Dropout (rate > 0): l is summed before dropout, so the stats are the
//   same with and without it; only kept keys enter the p v sum, and the
//   row is scaled by 1 / ((1 - rate) l) at the end.  The keep mask comes
//   from dropout_hash.cuh, keyed on absolute (seed, b, h, row, col).
//
// What bounds it on the H100 at the serving shapes: 4*L*S*E FLOPs per
// call (q k^T and p v, two FLOPs per multiply-add) against 67 TFLOP/s of
// float32 outside the tensor cores, e.g. 2.5 GFLOP = 37 us for the
// ghost-point site L=3333, S=3126, E=60; plus L*S*H exponentials on the
// special-function units (42 M at that site).  The bytes are small (q, k,
// v are a few MB), so the kernel is bound by operations, not memory.
// Dropout adds one hash per score: 11 integer instructions (two of them
// 32-bit multiplies, dropout_hash.cuh) beside the score's 2d FMAs and one
// exponential, i.e. L*S*H hashes, as many as there are exponentials
// (e.g. 20.9 M at the training site L=3072, S=53, H=8, B=16).  The
// no-dropout instantiation compiles the hash out (template flag).
//
// Design (simple and correct first; wgmma, TMA and padding d to 16 for
// the tensor cores are later work):
//   * one block per (query tile, head, batch); 128 threads.
//   * each query row is owned by a group of `tpr` threads of one warp
//     (tpr a power of two <= 32, chosen by the wrapper so that small-L
//     calls still fill the card); a thread visits every tpr-th key.
//   * K/V of the head are streamed through shared memory in tiles of 64
//     keys; the row stride is odd so the tpr lanes of a group read
//     distinct banks, and every other group reads the same words
//     (broadcast).  Loads are scalar: 15-float head slices are not
//     16-byte aligned.
//   * online softmax in registers (running max, running sum, d-wide
//     accumulator), then the tpr partial states of a row are merged with
//     warp shuffles; the 1/l scale is applied to the (1, d) output row.
//   * ragged L and S edges are masked in the kernel: rows >= L compute
//     nothing and write nothing, keys >= S are never visited.
//   * head dims up to 64 (templated register arrays of 16, 32 or 64).
//   * exp is the accurate expf: the port holds the kernel to atol 2e-5
//     against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 64;
constexpr float kMaskedScore = -1e30f;

template <int DMAX, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
fused_mha_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out,
                     float* __restrict__ stats,
                     int L, int S, int H, int d, int tpr,
                     uint32_t seed, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  const int ds = d | 1;  // odd row stride
  float* k_s = smem;                   // [kKeyTile][ds]
  float* v_s = k_s + kKeyTile * ds;    // [kKeyTile][ds]
  uint8_t* m_s = reinterpret_cast<uint8_t*>(v_s + kKeyTile * ds);  // [kKeyTile]

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int rows_per_block = kThreads / tpr;
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int row = blockIdx.x * rows_per_block + group;
  const bool active = row < L;

  float qr[DMAX];
  float acc[DMAX];
  const float* q_row = q + ((size_t)b * L + (active ? row : 0)) * E + h * d;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    qr[c] = (active && c < d) ? q_row[c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  const uint32_t row_key =
      DROPOUT ? act3d_dropout_row_key(seed, b, h, active ? row : 0) : 0u;

  const float* k_b = k + (size_t)b * S * E + h * d;
  const float* v_b = v + (size_t)b * S * E + h * d;
  const uint8_t* mask_b = mask ? mask + (size_t)b * S : nullptr;

  for (int s0 = 0; s0 < S; s0 += kKeyTile) {
    const int n = min(kKeyTile, S - s0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * d; i += kThreads) {
      const int j = i / d;
      const int c = i - j * d;
      const size_t g = (size_t)(s0 + j) * E + c;
      k_s[j * ds + c] = k_b[g];
      v_s[j * ds + c] = v_b[g];
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
          if (c < d) s = fmaf(qr[c], kj[c], s);
        }
        if (m_s[j]) s = kMaskedScore;
        if (s > m) {
          const float scale = expf(m - s);  // 0 while m is still -inf
          l *= scale;
#pragma unroll
          for (int c = 0; c < DMAX; ++c) acc[c] *= scale;
          m = s;
        }
        float p = expf(s - m);
        l += p;  // l is the sum before dropout
        if (DROPOUT && !act3d_dropout_keep(row_key, s0 + j, threshold)) p = 0.f;
        const float* vj = v_s + j * ds;
#pragma unroll
        for (int c = 0; c < DMAX; ++c) {
          if (c < d) acc[c] = fmaf(p, vj[c], acc[c]);
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
    const float inv = DROPOUT ? inv_keep / l : 1.f / l;
    float* o_row = out + ((size_t)b * L + row) * E + h * d;
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      if (c < d) o_row[c] = acc[c] * inv;
    }
    float* st = stats + ((size_t)b * L + row) * (2 * H) + 2 * h;
    st[0] = m;
    st[1] = l;
  }
}

template <int DMAX>
void launch(const float* q, const float* k, const float* v,
            const uint8_t* mask, float* out, float* stats, int B, int L,
            int S, int H, int d, int tpr, int dropout, uint32_t seed,
            uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const dim3 grid((L + rows_per_block - 1) / rows_per_block, H, B);
  const size_t smem = 2 * kKeyTile * (d | 1) * sizeof(float) + kKeyTile;
  if (dropout) {
    fused_mha_fwd_kernel<DMAX, true><<<grid, kThreads, smem, stream>>>(
        q, k, v, mask, out, stats, L, S, H, d, tpr, seed, threshold, inv_keep);
  } else {
    fused_mha_fwd_kernel<DMAX, false><<<grid, kThreads, smem, stream>>>(
        q, k, v, mask, out, stats, L, S, H, d, tpr, 0u, 0u, 1.f);
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; mask may be null.  dropout != 0 selects the dropout
// instantiation with the keep threshold and 1/(1-rate) computed on the
// host.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int act3d_fused_mha_fwd_f32(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, void* stats, int B, int L,
                                       int S, int H, int d, int tpr,
                                       int dropout, unsigned int seed,
                                       unsigned int threshold, float inv_keep,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || H > 65535 || B > 65535 || d < 1 ||
      d > 64 || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) {
    launch<16>(qf, kf, vf, mf, of, sf, B, L, S, H, d, tpr, dropout, seed, threshold,
               inv_keep, st);
  } else if (d <= 32) {
    launch<32>(qf, kf, vf, mf, of, sf, B, L, S, H, d, tpr, dropout, seed, threshold,
               inv_keep, st);
  } else {
    launch<64>(qf, kf, vf, mf, of, sf, B, L, S, H, d, tpr, dropout, seed, threshold,
               inv_keep, st);
  }
  return (int)cudaGetLastError();
}
