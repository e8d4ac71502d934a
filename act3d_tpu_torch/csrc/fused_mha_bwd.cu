// Fused multi-head attention backward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel act3d_tpu/kernels/attention.py::_mha_bwd_body
// (reached through _fused_mha_bwd_impl; its four variants: plain, masked,
// dropout, masked + dropout).  Same contract:
//   q, dO (B, L, E); k, v (B, S, E); optional mask (B, S) bytes (non-zero =
//   masked out); stats (B, L, 2H) float32 from the forward (m at lane 2h,
//   l at lane 2h+1, l summed before dropout); delta (B, L, H) float32 =
//   rowsum(dO * O) per head, computed by the caller.  Heads are the lane
//   slices [h*d, (h+1)*d) of E, read and written in place.  With
//   p = exp(s - m) / l, keep from dropout_hash.cuh and kp = keep / (1-rate)
//   (kp = 1 without dropout):
//     dv_j = sum_i p_ij kp_ij dO_i
//     ds_ij = p_ij (kp_ij dO_i . v_j - delta_i)
//     dq_i = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
//   As on the TPU, masked keys score -1e30 and ds is not zeroed there, so a
//   fully masked row (uniform p) gives the TPU kernel's dq and dk.
//
// What bounds it on the H100: 10*B*L*S*E FLOPs (five (L, S, d) products
// per head: q k^T, dO v^T, p^T dO, ds k, ds^T q) against 67 TFLOP/s of
// float32 outside the tensor cores, e.g. 2.95 GFLOP = 44 us at the
// training site B=16, L=50, S=3074, E=120; the bytes (q, dO, dq: B*L*E
// each; k, v, dk, dv: B*S*E each; stats and delta) are 95 MB there, 28 us
// at 3.35 TB/s.  So it is bound by operations, plus L*S*H exponentials.
//
// Design (simple, deterministic; wgmma, TMA and padding d to 16 are later
// work).  Hopper blocks run in no order, so the TPU's sequential walk over
// L-tiles with dk/dv carried in VMEM becomes two passes of one source:
//   (a) dk/dv pass: one block per (key tile, head, batch, L split).  Each
//       key is owned by a group of `tpk` threads of one warp that visit
//       every tpk-th query row; q, dO, m, 1/l, delta (and the dropout row
//       keys) stream through shared memory in tiles of 64 rows.  dk and dv
//       of the key accumulate in registers and are merged over the group
//       with warp shuffles.  When B*H*key-tiles gives too few blocks (the
//       L=3072, S=53 site has 128), L is split over `nsplit` blocks whose
//       partial dk/dv go to a workspace and are summed in a fixed order by
//       a third kernel, so the result is the same on every run.
//   (b) dq pass: the forward's layout, one block per (query tile, head,
//       batch), `tpr` threads per row, K/V (and the mask) stream through
//       shared memory in tiles of 64 keys; dq merged with warp shuffles.
//   Both passes recompute p = exp(s - m) / l from the saved stats and
//   regenerate the keep mask from the hash; 7d FMAs per score in all
//   (s twice, dO . v twice, dv, dk, dq) against the 5d of the bound.
//   Ragged L and S edges are masked in the kernels; head dims up to 64
//   (templated register arrays of 16, 32 or 64); shared-memory row strides
//   are odd so the lanes of a group read distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 64;
constexpr int kKeyTile = 64;
constexpr float kMaskedScore = -1e30f;

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
};

template <int DMAX>
__device__ __forceinline__ float head_dot(const float* a, const float* b, int d) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    if (c < d) s = fmaf(a[c], b[c], s);
  }
  return s;
}

// Pass (a): dk and dv.  grid (key tiles * nsplit, H, B); blockIdx.x =
// split * key_tiles + tile.  Writes dk/dv (nsplit == 1) or the split's
// partial slab of the workspace (B, S, E) * split.
template <int DMAX, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, float* __restrict__ dk,
                    float* __restrict__ dv, int B, int L, int S, int H, int d,
                    int tpk, int key_tiles, int rows_per_split, Dropout drop) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  float* q_s = smem;                       // [kRowTile][ds]
  float* do_s = q_s + kRowTile * ds;       // [kRowTile][ds]
  float* m_s = do_s + kRowTile * ds;       // [kRowTile]
  float* r_s = m_s + kRowTile;             // [kRowTile] 1 / l
  float* dl_s = r_s + kRowTile;            // [kRowTile] delta
  uint32_t* rk_s = reinterpret_cast<uint32_t*>(dl_s + kRowTile);  // row keys

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x % key_tiles;
  const int split = blockIdx.x / key_tiles;
  const int keys_per_block = kThreads / tpk;
  const int group = threadIdx.x / tpk;
  const int lane = threadIdx.x % tpk;
  const int j = tile * keys_per_block + group;
  const bool active = j < S;

  float kr[DMAX], vr[DMAX], dkr[DMAX], dvr[DMAX];
  const size_t kv_off = ((size_t)b * S + (active ? j : 0)) * E + h * d;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    kr[c] = (active && c < d) ? k[kv_off + c] : 0.f;
    vr[c] = (active && c < d) ? v[kv_off + c] : 0.f;
    dkr[c] = 0.f;
    dvr[c] = 0.f;
  }
  const bool masked = active && mask && mask[(size_t)b * S + j];

  const int r0 = split * rows_per_split;
  const int r1 = min(L, r0 + rows_per_split);
  const float* q_b = q + (size_t)b * L * E + h * d;
  const float* do_b = dout + (size_t)b * L * E + h * d;

  for (int i0 = r0; i0 < r1; i0 += kRowTile) {
    const int n = min(kRowTile, r1 - i0);
    __syncthreads();  // the previous tile is no longer read
    for (int x = threadIdx.x; x < n * d; x += kThreads) {
      const int i = x / d;
      const int c = x - i * d;
      const size_t g = (size_t)(i0 + i) * E + c;
      q_s[i * ds + c] = q_b[g];
      do_s[i * ds + c] = do_b[g];
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const size_t row = (size_t)b * L + i0 + i;
      m_s[i] = stats[row * (2 * H) + 2 * h];
      r_s[i] = 1.f / stats[row * (2 * H) + 2 * h + 1];
      dl_s[i] = delta[row * H + h];
      if (DROPOUT) rk_s[i] = act3d_dropout_row_key(drop.seed, b, h, i0 + i);
    }
    __syncthreads();
    if (active) {
      for (int i = lane; i < n; i += tpk) {
        const float* qi = q_s + i * ds;
        const float* doi = do_s + i * ds;
        const float s = masked ? kMaskedScore : head_dot<DMAX>(qi, kr, d);
        const float p = expf(s - m_s[i]) * r_s[i];
        float dp = head_dot<DMAX>(doi, vr, d);
        float pk = p;
        if (DROPOUT) {
          const bool keep = act3d_dropout_keep(rk_s[i], j, drop.threshold);
          pk = keep ? p * drop.inv_keep : 0.f;
          dp = keep ? dp * drop.inv_keep : 0.f;
        }
        const float dsc = p * (dp - dl_s[i]);
#pragma unroll
        for (int c = 0; c < DMAX; ++c) {
          if (c < d) {
            dvr[c] = fmaf(pk, doi[c], dvr[c]);
            dkr[c] = fmaf(dsc, qi[c], dkr[c]);
          }
        }
      }
    }
  }

  // Merge the tpk partial sums of each key (tpk consecutive lanes of one
  // warp; every lane takes part, inactive keys carry zeros).
  for (int off = tpk >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      dkr[c] += __shfl_xor_sync(0xffffffffu, dkr[c], off);
      dvr[c] += __shfl_xor_sync(0xffffffffu, dvr[c], off);
    }
  }
  if (active && lane == 0) {
    const size_t off = (size_t)split * B * S * E + kv_off;
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      if (c < d) {
        dk[off + c] = dkr[c];
        dv[off + c] = dvr[c];
      }
    }
  }
}

// Sums the nsplit partial slabs of dk and dv, in split order.
__global__ void mha_bwd_reduce_kernel(const float* __restrict__ dk_parts,
                                      const float* __restrict__ dv_parts,
                                      float* __restrict__ dk,
                                      float* __restrict__ dv, size_t n,
                                      int nsplit) {
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      a += dk_parts[s * n + x];
      c += dv_parts[s * n + x];
    }
    dk[x] = a;
    dv[x] = c;
  }
}

// Pass (b): dq.  grid (query tiles, H, B), tpr threads per row.
template <int DMAX, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ stats,
                  const float* __restrict__ delta,
                  const uint8_t* __restrict__ mask, float* __restrict__ dq,
                  int L, int S, int H, int d, int tpr, Dropout drop) {
  extern __shared__ float smem[];
  const int ds = d | 1;
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

  float qr[DMAX], dor[DMAX], acc[DMAX];
  const size_t row_off = ((size_t)b * L + (active ? row : 0)) * E + h * d;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    qr[c] = (active && c < d) ? q[row_off + c] : 0.f;
    dor[c] = (active && c < d) ? dout[row_off + c] : 0.f;
    acc[c] = 0.f;
  }
  const size_t st = (size_t)b * L + (active ? row : 0);
  const float m = stats[st * (2 * H) + 2 * h];
  const float r = 1.f / stats[st * (2 * H) + 2 * h + 1];
  const float dl = delta[st * H + h];
  const uint32_t row_key =
      DROPOUT ? act3d_dropout_row_key(drop.seed, b, h, active ? row : 0) : 0u;

  const float* k_b = k + (size_t)b * S * E + h * d;
  const float* v_b = v + (size_t)b * S * E + h * d;
  const uint8_t* mask_b = mask ? mask + (size_t)b * S : nullptr;

  for (int s0 = 0; s0 < S; s0 += kKeyTile) {
    const int n = min(kKeyTile, S - s0);
    __syncthreads();
    for (int x = threadIdx.x; x < n * d; x += kThreads) {
      const int j = x / d;
      const int c = x - j * d;
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
        const float s = m_s[j] ? kMaskedScore : head_dot<DMAX>(qr, kj, d);
        const float p = expf(s - m) * r;
        float dp = head_dot<DMAX>(dor, v_s + j * ds, d);
        if (DROPOUT) {
          dp = act3d_dropout_keep(row_key, s0 + j, drop.threshold)
                   ? dp * drop.inv_keep : 0.f;
        }
        const float dsc = p * (dp - dl);
#pragma unroll
        for (int c = 0; c < DMAX; ++c) {
          if (c < d) acc[c] = fmaf(dsc, kj[c], acc[c]);
        }
      }
    }
  }

  for (int off = tpr >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
  if (active && lane == 0) {
#pragma unroll
    for (int c = 0; c < DMAX; ++c) {
      if (c < d) dq[row_off + c] = acc[c];
    }
  }
}

template <int DMAX, bool DROPOUT>
void launch(const float* q, const float* k, const float* v, const float* dout,
            const float* stats, const float* delta, const uint8_t* mask,
            float* dq, float* dk, float* dv, float* work, int B, int L, int S,
            int H, int d, int tpr, int tpk, int nsplit, Dropout drop,
            cudaStream_t stream) {
  const int ds = d | 1;
  const int keys_per_block = kThreads / tpk;
  const int key_tiles = (S + keys_per_block - 1) / keys_per_block;
  const int rows_per_split = (L + nsplit - 1) / nsplit;
  const size_t n = (size_t)B * S * H * d;
  float* dk_dst = nsplit > 1 ? work : dk;
  float* dv_dst = nsplit > 1 ? work + nsplit * n : dv;
  const size_t smem_a = (2 * kRowTile * ds + 4 * kRowTile) * sizeof(float);
  mha_bwd_dkdv_kernel<DMAX, DROPOUT>
      <<<dim3(key_tiles * nsplit, H, B), kThreads, smem_a, stream>>>(
          q, k, v, dout, stats, delta, mask, dk_dst, dv_dst, B, L, S, H, d,
          tpk, key_tiles, rows_per_split, drop);
  if (nsplit > 1) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    mha_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(work, work + nsplit * n,
                                                      dk, dv, n, nsplit);
  }
  const int rows_per_block = kThreads / tpr;
  const size_t smem_b = 2 * kKeyTile * ds * sizeof(float) + kKeyTile;
  mha_bwd_dq_kernel<DMAX, DROPOUT>
      <<<dim3((L + rows_per_block - 1) / rows_per_block, H, B), kThreads,
          smem_b, stream>>>(q, k, v, dout, stats, delta, mask, dq, L, S, H, d,
                            tpr, drop);
}

template <int DMAX>
void launch_d(bool dropout, const float* q, const float* k, const float* v,
              const float* dout, const float* stats, const float* delta,
              const uint8_t* mask, float* dq, float* dk, float* dv,
              float* work, int B, int L, int S, int H, int d, int tpr,
              int tpk, int nsplit, Dropout drop, cudaStream_t stream) {
  if (dropout) {
    launch<DMAX, true>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work, B,
                       L, S, H, d, tpr, tpk, nsplit, drop, stream);
  } else {
    launch<DMAX, false>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work,
                        B, L, S, H, d, tpr, tpk, nsplit, drop, stream);
  }
}

bool pow2_upto_32(int x) { return x >= 1 && x <= 32 && (x & (x - 1)) == 0; }

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous float32 tensors (mask: bytes, may be null).  `work` holds
// 2 * nsplit * B*S*E floats when nsplit > 1 (may be null otherwise).
// dropout != 0 selects the dropout instantiations, with the keep threshold
// and 1/(1-rate) computed on the host.  Returns cudaGetLastError() after
// the launches (0 = success).
extern "C" int act3d_fused_mha_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, const void* delta, const void* mask, void* dq,
    void* dk, void* dv, void* work, int B, int L, int S, int H, int d,
    int tpr, int tpk, int nsplit, int dropout, unsigned int seed,
    unsigned int threshold, float inv_keep, void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || H > 65535 || B > 65535 || d < 1 ||
      d > 64 || !pow2_upto_32(tpr) || !pow2_upto_32(tpk) || nsplit < 1 ||
      (nsplit > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{seed, threshold, inv_keep};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* sf = static_cast<const float*>(stats);
  const float* lf = static_cast<const float*>(delta);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) {
    launch_d<16>(dropout != 0, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf,
                 B, L, S, H, d, tpr, tpk, nsplit, drop, st);
  } else if (d <= 32) {
    launch_d<32>(dropout != 0, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf,
                 B, L, S, H, d, tpr, tpk, nsplit, drop, st);
  } else {
    launch_d<64>(dropout != 0, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf,
                 B, L, S, H, d, tpr, tpk, nsplit, drop, st);
  }
  return (int)cudaGetLastError();
}
