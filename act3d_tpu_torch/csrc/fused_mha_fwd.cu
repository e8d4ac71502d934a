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
//   from dropout_hash.cuh, keyed on absolute (seed, b0 + b, h, row, col):
//   b0 is the rows' offset in the global batch under data parallelism, so
//   each rank drops what a one-device run drops for its rows (0 on one
//   device, where every mask is the one of earlier releases).
//
// It also replaces the single-head-layout TPU kernel
// act3d_tpu/kernels/attention.py::_attention_core_fwd_impl (bodies
// _attn_kernel and _attn_kernel_masked, reached through attention_core):
// q (BH, L, D) and k/v (BH, S, D) are this contract at B = BH, H = 1,
// E = D, rate 0, with a (BH, S) mask and no stats.  A null stats pointer
// selects instantiations without them (STATS = false): neither kernel
// writes any to HBM, and the fused sites' instantiations stay as they were.
//
// What bounds it on the H100: 4*L*S*E FLOPs per call (q k^T and p v) and
// L*S*H exponentials.  On the tensor cores at float32 accuracy (3xTF32,
// three TF32 products per product: 495 / 3 = 165 TFLOP/s) the ghost-point
// site L=3333, S=3126, E=60 is 15 us of products and 42 M exponentials
// (132 SMs x 16 per clock: ~10 us at 1.98 GHz); q, k, v are a few MB.
// The serving sites with L <= 50 are a few MFLOP: there the bound is the
// launch and the card's width.
//
// Design:
//   * products on the tensor cores: mma.sync m16n8k8 TF32 in the 3xTF32
//     split of mma_tf32.cuh; d is padded with zeros to DP = 8, 16, 32 or
//     64 in shared memory (the global tensors stay unpadded).
//   * one block per (query tile, head, batch, key chunk); `warps` warps of
//     16 query rows each (the wrapper's plan: fewer warps for short L).
//     Each warp keeps its q fragments (split once) and its output
//     accumulator in registers, the score tile (16 x 32) too; p goes from
//     the score fragment to the p v operand without shuffles (k permuted).
//   * K/V of the head stream through shared memory in tiles of 32 keys,
//     split into (big, small) once per block when staged, so no warp
//     converts them again.  Neighbouring threads read neighbouring floats
//     of a head slice, several loads in flight per thread; a block has at
//     least 4 warps, so at L = 1 three warps stage keys for the one that
//     owns the row.
//   * online softmax per row (running max, running sum); the four lanes of
//     a quad that share a row reduce with shuffles.
//   * split over S (flash-decoding): when query tiles x H x B cannot fill
//     the card (L = 1 and the L = 50 sampler sites), the keys are cut into
//     `nsplit` chunks of `chunk` keys, each block writes its partial
//     (m, l, unnormalised acc) to a workspace, and a second kernel launched
//     from the same C call combines the chunks in chunk order (no atomics,
//     the same result on every run).
//   * ragged edges masked in the kernel: rows >= L compute on zeros and
//     write nothing, keys past the chunk score -inf (weight 0).
//   * exp is the accurate expf: the port holds the kernel to atol 2e-5
//     against the plain version.
//
// The bf16 entry (act3d_fused_mha_fwd_bf16, --mixed_precision 1 training)
// takes q, k, v and writes out in bf16; stats and the workspace stay
// float32.  It computes what the TPU kernel computes on bf16 inputs: s =
// q k^T with bf16 operands and float32 sums; the softmax in float32; the
// unnormalised weights rounded to bf16 before p v (ex.astype(v.dtype));
// p v summed in float32, scaled by 1 / ((1 - rate) l) and rounded to bf16.
// The one difference is where it rounds: the TPU rounds exp(s - m) with
// the row's final max, this kernel exp(s - m) with its running max, which
// the online softmax then rescales in float32 (a relative change of one
// bf16 rounding either way).  Products on mma.sync m16n8k16 bf16
// (mma_bf16.cuh): 989 TFLOP/s dense, one product per product, no split;
// d padded with zeros to DP = 16, 32 or 64.  Grid, plan, key tiles, split
// and combine are the float32 kernel's; K is staged row-major and V
// transposed, so every B operand is one 32-bit shared-memory word.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

// keys staged per step; scripts/ab_fused_mha_plans.py builds 16 and 64
#ifndef ACT3D_FWD_KEY_TILE
#define ACT3D_FWD_KEY_TILE 32
#endif
constexpr int kKeyTile = ACT3D_FWD_KEY_TILE;
static_assert(kKeyTile <= 128, "one mask byte per thread of a 128-thread block");
constexpr int kMaxWarps = 8;
// a block has at least this many warps: those without query rows (short
// L) still stage K/V, so one warp never loads a tile alone
constexpr int kMinWarps = 4;
constexpr float kMaskedScore = -1e30f;

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  uint32_t b0;  // the rows' offset in the global batch (data parallelism)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (q_tiles * nsplit, H, B), blockIdx.x = split * q_tiles + tile;
// blockDim 32 * max(row_warps, kMinWarps); warps [0, row_warps) own 16
// query rows each.  part_acc == nullptr: one chunk, write out/stats;
// else write the chunk's partial acc (nsplit, B, L, E) and (m, l)
// (nsplit, B, L, H, 2).  STATS = false writes no stats.
template <int DP, bool DROPOUT, bool STATS>
__global__ void __launch_bounds__(32 * kMaxWarps)
mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ mask,
               float* __restrict__ out, float* __restrict__ stats,
               float* __restrict__ part_acc, float* __restrict__ part_ml, int B,
               int L, int S, int H, int d, int row_warps, int q_tiles, int chunk,
               Dropout drop) {
  constexpr int SD = DP + 4;  // shared row stride: conflict-free fragments
  constexpr int KD = DP / 8;  // k-steps of q k^T, n-tiles of p v
  extern __shared__ float smem[];
  float* kb = smem;
  float* ks = kb + kKeyTile * SD;
  float* vb = ks + kKeyTile * SD;
  float* vs = vb + kKeyTile * SD;
  uint8_t* m_s = reinterpret_cast<uint8_t*>(vs + kKeyTile * SD);

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x % q_tiles;
  const int split = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const bool has_rows = warp < row_warps;
  const int row_a = (tile * row_warps + warp) * 16 + g;
  const int row_b = row_a + 8;
  const int kdu = (d + 7) >> 3;  // k-steps / n-tiles that hold real dims

  // q fragments: loaded here, split after the first K/V tile is staged, so
  // their load latency overlaps the staging's
  uint32_t qb[KD][4], qs[KD][4];
  const float* q_b = q + (size_t)b * L * E + h * d;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c0 = kk * 8 + t;
    const int c1 = c0 + 4;
    qb[kk][0] = (row_a < L && c0 < d) ? __float_as_uint(q_b[(size_t)row_a * E + c0]) : 0u;
    qb[kk][1] = (row_b < L && c0 < d) ? __float_as_uint(q_b[(size_t)row_b * E + c0]) : 0u;
    qb[kk][2] = (row_a < L && c1 < d) ? __float_as_uint(q_b[(size_t)row_a * E + c1]) : 0u;
    qb[kk][3] = (row_b < L && c1 < d) ? __float_as_uint(q_b[(size_t)row_b * E + c1]) : 0u;
  }

  float o[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[kk][i] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t rk_a = 0u, rk_b = 0u;
  if (DROPOUT) {
    rk_a = act3d_dropout_row_key(drop.seed, drop.b0 + b, h, row_a);
    rk_b = act3d_dropout_row_key(drop.seed, drop.b0 + b, h, row_b);
  }

  const float* k_b = k + (size_t)b * S * E + h * d;
  const float* v_b = v + (size_t)b * S * E + h * d;
  const uint8_t* mask_b = mask ? mask + (size_t)b * S : nullptr;
  const int c_begin = split * chunk;
  const int c_end = min(S, c_begin + chunk);

  for (int s0 = c_begin; s0 < c_end; s0 += kKeyTile) {
    const int n = min(kKeyTile, c_end - s0);
    const int n8 = (n + 7) & ~7;
    __syncthreads();  // the previous tile is no longer read
    // the mask bytes are loaded before the K/V stores wait on their loads
    const int j_m = threadIdx.x;  // blockDim >= 128 >= kKeyTile
    const uint8_t masked = (j_m < n && mask_b) ? mask_b[s0 + j_m] : 0;
    act3d_stage_pair<DP, SD>(k_b + (size_t)s0 * E, v_b + (size_t)s0 * E, E, n, n8, d, kb,
                             ks, vb, vs);
    if (j_m < n8) m_s[j_m] = masked;
    __syncthreads();
    if (!has_rows) continue;
    if (s0 == c_begin) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Tf32Pair p = act3d_split_tf32(__uint_as_float(qb[kk][i]));
          qb[kk][i] = p.big;
          qs[kk][i] = p.small;
        }
      }
    }

    const int ntn = n8 >> 3;  // n-tiles of 8 keys in this tile
    float s[kKeyTile / 8][4];
    float t_a = -INFINITY, t_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      if (nt < ntn) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk < kdu) {
            uint32_t bb[2], bs[2];
            act3d_load_bt(kb, ks, SD, nt * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(s[nt], qb[kk], qs[kk], bb, bs);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * t + (i & 1);
          float x = s[nt][i];
          if (j >= n) x = -INFINITY;
          else if (m_s[j]) x = kMaskedScore;
          s[nt][i] = x;
          if (i < 2) t_a = fmaxf(t_a, x);
          else t_b = fmaxf(t_b, x);
        }
      }
    }
    // every tile holds a key of the chunk, so the new max is finite
    const float n_a = fmaxf(m_a, quad_max(t_a));
    const float n_b = fmaxf(m_b, quad_max(t_b));
    const float sc_a = expf(m_a - n_a);  // 0 while m is still -inf
    const float sc_b = expf(m_b - n_b);
    m_a = n_a;
    m_b = n_b;
    l_a *= sc_a;
    l_b *= sc_b;
    // the tile's p v goes to a fresh accumulator that is added to the
    // running one in float32: the tensor cores do not round to nearest as
    // they accumulate, so no sum longer than a tile stays in them
    float ot[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ot[kk][i] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kKeyTile / 8; ++nt) {
      if (nt < ntn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = expf(s[nt][i] - (i < 2 ? m_a : m_b));
          if (i < 2) l_a += p;  // l is the sum before dropout
          else l_b += p;
          if (DROPOUT && !act3d_dropout_keep(i < 2 ? rk_a : rk_b,
                                             s0 + nt * 8 + 2 * t + (i & 1),
                                             drop.threshold)) {
            p = 0.f;
          }
          s[nt][i] = p;
        }
        uint32_t ab[4], as[4];
        act3d_c_as_a(s[nt], ab, as);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk < kdu) {
            uint32_t bb[2], bs[2];
            act3d_load_b_perm(vb, vs, SD, nt * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(ot[kk], ab, as, bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      o[kk][0] = fmaf(o[kk][0], sc_a, ot[kk][0]);
      o[kk][1] = fmaf(o[kk][1], sc_a, ot[kk][1]);
      o[kk][2] = fmaf(o[kk][2], sc_b, ot[kk][2]);
      o[kk][3] = fmaf(o[kk][3], sc_b, ot[kk][3]);
    }
  }
  if (!has_rows) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  const int rows[2] = {row_a, row_b};
  const float ms[2] = {m_a, m_b};
  const float ls[2] = {l_a, l_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= L) continue;
    const size_t bl = (size_t)b * L + row;
    float* dst;
    float scale;
    if (part_acc == nullptr) {
      dst = out + bl * E + h * d;
      scale = (DROPOUT ? drop.inv_keep : 1.f) / ls[r];
      if (STATS && t == 0) {
        stats[bl * (2 * H) + 2 * h] = ms[r];
        stats[bl * (2 * H) + 2 * h + 1] = ls[r];
      }
    } else {
      const size_t sbl = (size_t)split * B * L + bl;
      dst = part_acc + sbl * E + h * d;
      scale = 1.f;
      if (t == 0) {
        part_ml[(sbl * H + h) * 2] = ms[r];
        part_ml[(sbl * H + h) * 2 + 1] = ls[r];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 8 + 2 * t;
      if (c < d) dst[c] = o[kk][2 * r] * scale;
      if (c + 1 < d) dst[c + 1] = o[kk][2 * r + 1] * scale;
    }
  }
}

// Combines the nsplit chunks of every (row, head) in chunk order: one warp
// per (row, head), lane s reading chunk s (and s + 32, ...), so every
// chunk's loads are in flight at once; the chunks' weights and sums are
// reduced with a fixed butterfly, which leaves every lane the same bits.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP, bool STATS, typename OutT>
__global__ void mha_fwd_combine_kernel(const float* __restrict__ part_acc,
                                       const float* __restrict__ part_ml,
                                       OutT* __restrict__ out,
                                       float* __restrict__ stats, int B, int L, int H,
                                       int d, int nsplit, float inv_keep) {
  const int E = H * d;
  const size_t bl_n = (size_t)B * L;
  const int lane = threadIdx.x & 31;
  const size_t items = bl_n * H;
  const size_t warps = ((size_t)gridDim.x * blockDim.x) >> 5;
  for (size_t w = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < items;
       w += warps) {
    const size_t bl = w / H;
    const int h = (int)(w - bl * H);
    float m = -INFINITY;
    for (int s = lane; s < nsplit; s += 32) {
      m = fmaxf(m, part_ml[((s * bl_n + bl) * H + h) * 2]);
    }
    m = warp_max(m);
    float l = 0.f;
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const size_t ml = ((s * bl_n + bl) * H + h) * 2;
      const float wt = expf(part_ml[ml] - m);
      l += part_ml[ml + 1] * wt;
      const float* a = part_acc + (s * bl_n + bl) * E + h * d;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        if (c < d) acc[c] += a[c] * wt;
      }
    }
    l = warp_sum(l);
    const float scale = inv_keep / l;
    OutT* o = out + bl * E + h * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) {
        const float x = warp_sum(acc[c]);
        if ((c & 31) == lane) act3d_store(o + c, x * scale);
      }
    }
    if (STATS && lane == 0) {
      stats[bl * (2 * H) + 2 * h] = m;
      stats[bl * (2 * H) + 2 * h + 1] = l;
    }
  }
}

template <int DP, bool DROPOUT, bool STATS>
cudaError_t launch_dp(const float* q, const float* k, const float* v,
                      const uint8_t* mask, float* out, float* stats, float* work,
                      int B, int L, int S, int H, int d, int warps, int chunk,
                      int nsplit, Dropout drop, cudaStream_t stream) {
  const int q_tiles = (L + 16 * warps - 1) / (16 * warps);
  const int threads = 32 * (warps > kMinWarps ? warps : kMinWarps);
  const size_t smem = 4 * kKeyTile * (DP + 4) * sizeof(float) + kKeyTile;
  auto kernel = mha_fwd_kernel<DP, DROPOUT, STATS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  float* part_acc = nsplit > 1 ? work : nullptr;
  float* part_ml = nsplit > 1 ? work + (size_t)nsplit * B * L * H * d : nullptr;
  kernel<<<dim3(q_tiles * nsplit, H, B), threads, smem, stream>>>(
      q, k, v, mask, out, stats, part_acc, part_ml, B, L, S, H, d, warps, q_tiles, chunk,
      drop);
  if (nsplit > 1) {
    const size_t items = (size_t)B * L * H;  // one warp each
    const int blocks = (int)((items + 7) / 8 < 8192 ? (items + 7) / 8 : 8192);
    mha_fwd_combine_kernel<DP, STATS, float><<<blocks, 256, 0, stream>>>(
        part_acc, part_ml, out, stats, B, L, H, d, nsplit,
        DROPOUT ? drop.inv_keep : 1.f);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(bool dropout, const float* q, const float* k, const float* v,
                   const uint8_t* mask, float* out, float* stats, float* work, int B,
                   int L, int S, int H, int d, int warps, int chunk, int nsplit,
                   Dropout drop, cudaStream_t stream) {
  if (stats == nullptr) {  // the single-head-layout core: no dropout, no stats
    return launch_dp<DP, false, false>(q, k, v, mask, out, stats, work, B, L, S, H, d,
                                       warps, chunk, nsplit, drop, stream);
  }
  if (dropout) {
    return launch_dp<DP, true, true>(q, k, v, mask, out, stats, work, B, L, S, H, d, warps,
                                     chunk, nsplit, drop, stream);
  }
  return launch_dp<DP, false, true>(q, k, v, mask, out, stats, work, B, L, S, H, d, warps,
                                    chunk, nsplit, drop, stream);
}

// ---------------------------------------------------------------- bf16
// The bf16 kernel: mha_fwd_kernel's grid, block and online softmax with
// bf16 tensor-core products (see the header comment).  Shared memory: the
// key tile's K [key][DP + 8] and V^T [dim][kKeyTile + 8] (bf16 bits), and
// the mask bytes.
template <int DP, bool DROPOUT, bool STATS>
__global__ void __launch_bounds__(32 * kMaxWarps)
mha_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint8_t* __restrict__ mask,
                    uint16_t* __restrict__ out, float* __restrict__ stats,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int B,
                    int L, int S, int H, int d, int row_warps, int q_tiles, int chunk,
                    Dropout drop) {
  constexpr int SK = DP + 8;        // K tile row stride (bf16)
  constexpr int SV = kKeyTile + 8;  // V^T tile row stride
  constexpr int KS = DP / 16;       // k-steps of q k^T
  constexpr int NO = DP / 8;        // n-tiles of p v
  constexpr int NT = kKeyTile / 8;  // n-tiles of scores per key tile
  static_assert(NT % 2 == 0, "p v takes the score tiles in pairs");
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* k_s = smem16;
  uint16_t* vt_s = k_s + kKeyTile * SK;
  uint8_t* m_s = reinterpret_cast<uint8_t*>(vt_s + DP * SV);

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x % q_tiles;
  const int split = blockIdx.x / q_tiles;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const bool has_rows = warp < row_warps;
  const int row_a = (tile * row_warps + warp) * 16 + g;
  const int row_b = row_a + 8;
  const int ksu = (d + 15) >> 4;  // k-steps that hold real dims
  const int nou = (d + 7) >> 3;   // output n-tiles that hold real dims

  // q fragments (the A operand of q k^T), zeros past L and d
  const uint16_t* q_b = q + (size_t)b * L * E + h * d;
  auto qbits = [&](int row, int c) -> uint32_t {
    return (row < L && c < d) ? (uint32_t)q_b[(size_t)row * E + c] : 0u;
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qa[kk][0] = qbits(row_a, c0) | (qbits(row_a, c0 + 1) << 16);
    qa[kk][1] = qbits(row_b, c0) | (qbits(row_b, c0 + 1) << 16);
    qa[kk][2] = qbits(row_a, c0 + 8) | (qbits(row_a, c0 + 9) << 16);
    qa[kk][3] = qbits(row_b, c0 + 8) | (qbits(row_b, c0 + 9) << 16);
  }

  float o[NO][4];
#pragma unroll
  for (int on = 0; on < NO; ++on) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[on][i] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t rk_a = 0u, rk_b = 0u;
  if (DROPOUT) {
    rk_a = act3d_dropout_row_key(drop.seed, drop.b0 + b, h, row_a);
    rk_b = act3d_dropout_row_key(drop.seed, drop.b0 + b, h, row_b);
  }

  const uint16_t* k_b = k + (size_t)b * S * E + h * d;
  const uint16_t* v_b = v + (size_t)b * S * E + h * d;
  const uint8_t* mask_b = mask ? mask + (size_t)b * S : nullptr;
  const int c_begin = split * chunk;
  const int c_end = min(S, c_begin + chunk);

  for (int s0 = c_begin; s0 < c_end; s0 += kKeyTile) {
    const int n = min(kKeyTile, c_end - s0);
    __syncthreads();  // the previous tile is no longer read
    const int j_m = threadIdx.x;  // blockDim >= 128 >= kKeyTile
    const uint8_t masked = (j_m < n && mask_b) ? mask_b[s0 + j_m] : 0;
    // whole tiles, zeros past n: p v reads the keys in steps of 16
    act3d_stage_bf16<DP>(k_b + (size_t)s0 * E, E, n, kKeyTile, d, k_s, SK, nullptr, 0);
    act3d_stage_bf16<DP>(v_b + (size_t)s0 * E, E, n, kKeyTile, d, nullptr, 0, vt_s, SV);
    if (j_m < kKeyTile) m_s[j_m] = masked;
    __syncthreads();
    if (!has_rows) continue;

    const int ntn = (n + 7) >> 3;  // n-tiles of 8 keys that hold keys
    float s[NT][4];
    float t_a = -INFINITY, t_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      if (nt < ntn) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk < ksu) {
            uint32_t bb[2];
            act3d_bf16_load_b(k_s, SK, nt * 8, kk * 16, g, t, bb);
            act3d_mma_bf16(s[nt], qa[kk], bb);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * t + (i & 1);
          float x = s[nt][i];
          if (j >= n) x = -INFINITY;
          else if (m_s[j]) x = kMaskedScore;
          s[nt][i] = x;
          if (i < 2) t_a = fmaxf(t_a, x);
          else t_b = fmaxf(t_b, x);
        }
      }
    }
    const float n_a = fmaxf(m_a, quad_max(t_a));
    const float n_b = fmaxf(m_b, quad_max(t_b));
    const float sc_a = expf(m_a - n_a);  // 0 while m is still -inf
    const float sc_b = expf(m_b - n_b);
    m_a = n_a;
    m_b = n_b;
    l_a *= sc_a;
    l_b *= sc_b;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.f;  // n-tiles past the keys: weight 0 in p v
        if (nt < ntn) {
          p = expf(s[nt][i] - (i < 2 ? m_a : m_b));
          if (i < 2) l_a += p;  // l is the sum before dropout and rounding
          else l_b += p;
          if (DROPOUT && !act3d_dropout_keep(i < 2 ? rk_a : rk_b,
                                             s0 + nt * 8 + 2 * t + (i & 1),
                                             drop.threshold)) {
            p = 0.f;
          }
        }
        s[nt][i] = p;
      }
    }
    // the tile's p v into a fresh float32 accumulator, as the float32 kernel
    float ot[NO][4];
#pragma unroll
    for (int on = 0; on < NO; ++on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ot[on][i] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      if (2 * kt < ntn) {
        uint32_t pa[4];
        act3d_bf16_c_as_a(s[2 * kt], s[2 * kt + 1], pa);  // p rounded to bf16
#pragma unroll
        for (int on = 0; on < NO; ++on) {
          if (on < nou) {
            uint32_t bb[2];
            act3d_bf16_load_b(vt_s, SV, on * 8, kt * 16, g, t, bb);
            act3d_mma_bf16(ot[on], pa, bb);
          }
        }
      }
    }
#pragma unroll
    for (int on = 0; on < NO; ++on) {
      o[on][0] = fmaf(o[on][0], sc_a, ot[on][0]);
      o[on][1] = fmaf(o[on][1], sc_a, ot[on][1]);
      o[on][2] = fmaf(o[on][2], sc_b, ot[on][2]);
      o[on][3] = fmaf(o[on][3], sc_b, ot[on][3]);
    }
  }
  if (!has_rows) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  const int rows[2] = {row_a, row_b};
  const float ms[2] = {m_a, m_b};
  const float ls[2] = {l_a, l_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= L) continue;
    const size_t bl = (size_t)b * L + row;
    if (part_acc == nullptr) {
      uint16_t* dst = out + bl * E + h * d;
      const float scale = (DROPOUT ? drop.inv_keep : 1.f) / ls[r];
      if (STATS && t == 0) {
        stats[bl * (2 * H) + 2 * h] = ms[r];
        stats[bl * (2 * H) + 2 * h + 1] = ls[r];
      }
#pragma unroll
      for (int on = 0; on < NO; ++on) {
        const int c = on * 8 + 2 * t;
        if (c < d) dst[c] = act3d_to_bf16(o[on][2 * r] * scale);
        if (c + 1 < d) dst[c + 1] = act3d_to_bf16(o[on][2 * r + 1] * scale);
      }
    } else {
      const size_t sbl = (size_t)split * B * L + bl;
      float* dst = part_acc + sbl * E + h * d;
      if (t == 0) {
        part_ml[(sbl * H + h) * 2] = ms[r];
        part_ml[(sbl * H + h) * 2 + 1] = ls[r];
      }
#pragma unroll
      for (int on = 0; on < NO; ++on) {
        const int c = on * 8 + 2 * t;
        if (c < d) dst[c] = o[on][2 * r];
        if (c + 1 < d) dst[c + 1] = o[on][2 * r + 1];
      }
    }
  }
}

template <int DP, bool DROPOUT, bool STATS>
cudaError_t launch_bf16_dp(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                           const uint8_t* mask, uint16_t* out, float* stats, float* work,
                           int B, int L, int S, int H, int d, int warps, int chunk,
                           int nsplit, Dropout drop, cudaStream_t stream) {
  const int q_tiles = (L + 16 * warps - 1) / (16 * warps);
  const int threads = 32 * (warps > kMinWarps ? warps : kMinWarps);
  const size_t smem =
      (size_t)(kKeyTile * (DP + 8) + DP * (kKeyTile + 8)) * sizeof(uint16_t) + kKeyTile;
  auto kernel = mha_fwd_bf16_kernel<DP, DROPOUT, STATS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  float* part_acc = nsplit > 1 ? work : nullptr;
  float* part_ml = nsplit > 1 ? work + (size_t)nsplit * B * L * H * d : nullptr;
  kernel<<<dim3(q_tiles * nsplit, H, B), threads, smem, stream>>>(
      q, k, v, mask, out, stats, part_acc, part_ml, B, L, S, H, d, warps, q_tiles, chunk,
      drop);
  if (nsplit > 1) {
    const size_t items = (size_t)B * L * H;  // one warp each
    const int blocks = (int)((items + 7) / 8 < 8192 ? (items + 7) / 8 : 8192);
    mha_fwd_combine_kernel<DP, STATS, uint16_t><<<blocks, 256, 0, stream>>>(
        part_acc, part_ml, out, stats, B, L, H, d, nsplit,
        DROPOUT ? drop.inv_keep : 1.f);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(bool dropout, const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const uint8_t* mask, uint16_t* out, float* stats,
                        float* work, int B, int L, int S, int H, int d, int warps, int chunk,
                        int nsplit, Dropout drop, cudaStream_t stream) {
  if (stats == nullptr) {  // the single-head-layout core: no dropout, no stats
    return launch_bf16_dp<DP, false, false>(q, k, v, mask, out, stats, work, B, L, S, H, d,
                                            warps, chunk, nsplit, drop, stream);
  }
  if (dropout) {
    return launch_bf16_dp<DP, true, true>(q, k, v, mask, out, stats, work, B, L, S, H, d,
                                          warps, chunk, nsplit, drop, stream);
  }
  return launch_bf16_dp<DP, false, true>(q, k, v, mask, out, stats, work, B, L, S, H, d,
                                         warps, chunk, nsplit, drop, stream);
}

bool bad_args(int B, int L, int S, int H, int d, int warps, int chunk, int nsplit,
              const void* stats, const void* work, int dropout) {
  const bool warps_ok = warps == 1 || warps == 2 || warps == 4 || warps == 8;
  return B < 1 || L < 1 || S < 1 || H < 1 || H > 65535 || B > 65535 || d < 1 || d > 64 ||
         !warps_ok || chunk < 1 || nsplit < 1 || (long long)(nsplit - 1) * chunk >= S ||
         (long long)nsplit * chunk < S || (nsplit > 1 && work == nullptr) ||
         (stats == nullptr && dropout != 0);
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; mask may be null.  The launch plan comes from the
// wrapper (kernels/attention.py::fwd_plan): `warps` (1, 2, 4 or 8) warps
// of 16 query rows per block; the keys cut into `nsplit` chunks of `chunk`
// keys (nsplit = ceil(S / chunk), no chunk empty).  With nsplit > 1,
// `work` holds nsplit * B * L * (E + 2H) floats: the partial accumulators,
// then the partial (m, l).  dropout != 0 selects the dropout instantiation
// with the keep threshold, 1/(1-rate) and the batch offset b0 computed on
// the host.  stats may be null where dropout is 0 (the core): then no stats are written.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int act3d_fused_mha_fwd_f32(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, void* stats, void* work, int B,
                                       int L, int S, int H, int d, int warps,
                                       int chunk, int nsplit, int dropout,
                                       unsigned int seed, unsigned int threshold,
                                       float inv_keep, unsigned int b0, void* stream) {
  if (bad_args(B, L, S, H, d, warps, chunk, nsplit, stats, work, dropout)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{seed, threshold, inv_keep, b0};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(stats);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dr = dropout != 0;
  cudaError_t err;
  if (d <= 8) {
    err = launch<8>(dr, qf, kf, vf, mf, of, sf, wf, B, L, S, H, d, warps, chunk, nsplit,
                    drop, st);
  } else if (d <= 16) {
    err = launch<16>(dr, qf, kf, vf, mf, of, sf, wf, B, L, S, H, d, warps, chunk, nsplit,
                     drop, st);
  } else if (d <= 32) {
    err = launch<32>(dr, qf, kf, vf, mf, of, sf, wf, B, L, S, H, d, warps, chunk, nsplit,
                     drop, st);
  } else {
    err = launch<64>(dr, qf, kf, vf, mf, of, sf, wf, B, L, S, H, d, warps, chunk, nsplit,
                     drop, st);
  }
  return (int)err;
}

// The bf16 entry: the float32 entry's interface with q, k, v and out bf16
// tensors (stats and work float32, the same sizes).  d is padded to 16, 32
// or 64.
extern "C" int act3d_fused_mha_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* out, void* stats, void* work, int B,
                                        int L, int S, int H, int d, int warps,
                                        int chunk, int nsplit, int dropout,
                                        unsigned int seed, unsigned int threshold,
                                        float inv_keep, unsigned int b0, void* stream) {
  if (bad_args(B, L, S, H, d, warps, chunk, nsplit, stats, work, dropout)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{seed, threshold, inv_keep, b0};
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  uint16_t* oh = static_cast<uint16_t*>(out);
  float* sf = static_cast<float*>(stats);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dr = dropout != 0;
  cudaError_t err;
  if (d <= 16) {
    err = launch_bf16<16>(dr, qh, kh, vh, mf, oh, sf, wf, B, L, S, H, d, warps, chunk,
                          nsplit, drop, st);
  } else if (d <= 32) {
    err = launch_bf16<32>(dr, qh, kh, vh, mf, oh, sf, wf, B, L, S, H, d, warps, chunk,
                          nsplit, drop, st);
  } else {
    err = launch_bf16<64>(dr, qh, kh, vh, mf, oh, sf, wf, B, L, S, H, d, warps, chunk,
                          nsplit, drop, st);
  }
  return (int)err;
}
