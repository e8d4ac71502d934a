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
// bf16 rounding either way).  It has two bodies, picked by the wrapper's
// plan (kernels/attention.py::fwd_plan_bf16) by shape:
//   * wgmma (Hopper; csrc/mha_wgmma_bf16.cuh), for L > 16 and d <= 32.  At
//     d = 15 the bound is the exponentials, B*L*S*H on 132 x 16 special-
//     function lanes (the ghost site: 66.6 M, 16 us), not the products (4
//     GFLOP, 4 us at 989 TFLOP/s) or the bytes (a few MB).  A block is one
//     64-row query tile of one batch row for a group of heads, one
//     warpgroup per head, over one chunk of the keys.  Warp 0 stages the
//     query tile and the chunk's key tiles of all heads (K, V, the mask
//     bytes: each a contiguous run) by 1-D bulk copies into a 4-stage ring
//     (mbarrier completion); the warpgroup that releases a stage last
//     refills it, so no warpgroup waits for another.  Each warpgroup re-lays
//     its head's lane slice into wgmma operands, s = q k^T on wgmma m64n64k16
//     (q in registers), the online softmax in exp2 units (one FFMA and one
//     ex2.approx per score; the stats keep m in natural units), and p v on
//     mma.sync m16n8k16 per warp with p taken from the s accumulator in
//     registers (an A/B against wgmma m64n16k16 chose it, PERF.md).  A mask
//     is a template flag (unmasked sites read none).  With nsplit > 1 each
//     block writes its chunk's (m, l, acc) and the last block of a tile to
//     arrive (a counter) combines the chunks in chunk order in the same
//     launch: no atomics on data, the same bits on every run.
//   * mma.sync m16n8k16 (mma_bf16.cuh), for L <= 16 (one row of a 64-row
//     wgmma tile) and d > 32: the float32 kernel's grid, plan, key tiles,
//     split and combine, d padded with zeros to DP = 16, 32 or 64; K is
//     staged row-major and V transposed, so every B operand is one 32-bit
//     shared-memory word.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "mha_wgmma_bf16.cuh"

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
  const uint32_t* slot;  // the seed in device memory (the entries' seed_slot), or null
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
    const uint32_t seed = act3d_dropout_seed(drop.seed, drop.slot);
    rk_a = act3d_dropout_row_key(seed, drop.b0 + b, h, row_a);
    rk_b = act3d_dropout_row_key(seed, drop.b0 + b, h, row_b);
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
    const uint32_t seed = act3d_dropout_seed(drop.seed, drop.slot);
    rk_a = act3d_dropout_row_key(seed, drop.b0 + b, h, row_a);
    rk_b = act3d_dropout_row_key(seed, drop.b0 + b, h, row_b);
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

// ------------------------------------------------- bf16 on wgmma (Hopper)
// The bf16 body of the sites with more than 16 query rows and d <= 32 (see
// the header comment): a block is one 64-row query tile of one batch row for
// a group of G heads (G warpgroups, one head and 64 rows each), over one
// chunk of the keys.  Warp 0 stages the query tile once and the chunk's first
// key tiles of all heads (K, V and the mask bytes) into a ring of kWgStages
// stages; the warpgroup that releases a stage last refills it.  Each
// warpgroup re-lays its head's slice of a stage into operands (K [key][DP],
// V^T [DP][key], two buffers each), then s = q k^T (wgmma m64 n64 k16, q in
// registers), the online softmax in exp2 units and p v (mma.sync, p from the
// s accumulator in registers) into the running output.  With nsplit > 1 each block writes
// its chunk's (m, l, unnormalised acc); the last block of a tile to arrive
// (a counter) combines the chunks in chunk order and writes out and stats.
struct WgFwdArgs {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint8_t* mask;
  uint16_t* out;
  float* stats;
  float* part_acc;
  float* part_ml;
  int* counters;
  const char* keyrec;  // key records (PREP), [b][key tile][h]
  int B, L, S, H, d, G, q_tiles, chunk, nsplit;
  Dropout drop;
};

constexpr size_t kMaxSmem = 232448;  // bytes a block may use on the H100

// Shared bytes of a block: barriers, the ring (K, V and mask bytes of a key
// tile; with key records each head's V^T and K and the mask bytes), the query
// tile, and without records each head's operand buffers (K and V^T twice
// each: a warp re-lays tile it + 2 into a buffer once every warp of its
// warpgroup has passed tile it + 1's barrier, past its reads of tile it).
size_t wg_fwd_smem(int E, int dp, int G, bool prep) {
  const size_t op = act3d_op_bytes(dp);
  const size_t stage = (prep ? (size_t)G * 2 * op
                             : 2 * act3d_wg_run_bytes((size_t)kWgKeys * E * 2)) +
                       act3d_wg_run_bytes(kWgKeys);
  return 128 + kWgStages * stage + act3d_wg_run_bytes((size_t)kWgRows * E * 2) +
         (prep ? 0 : (size_t)G * 4 * op);
}

// PREP: the key tiles come as records (act3d_prep_kernel), staged by bulk
// copies and read in place; every warp releases a stage after its tile.
template <int DP, bool MASK, bool DROPOUT, bool STATS, bool PREP>
__global__ void __launch_bounds__(128 * act3d_wg_max_group(DP), 1)
mha_fwd_bf16_wgmma_kernel(const WgFwdArgs a) {
  constexpr int NK = kWgKeys;
  constexpr int KS = DP / 16;
  extern __shared__ __align__(128) char smem_raw[];
  const int E = a.H * a.d;
  const int G = a.G;
  const int b = blockIdx.z;
  const int hg = blockIdx.y;
  const int tile = blockIdx.x % a.q_tiles;
  const int split = blockIdx.x / a.q_tiles;
  const int r0 = tile * kWgRows;
  const int nr = min(kWgRows, a.L - r0);
  const int c_begin = split * a.chunk;
  const int c_end = min(a.S, c_begin + a.chunk);
  const int n_tiles = (c_end - c_begin + NK - 1) / NK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  Act3dCarve cv{smem_raw};
  uint64_t* full = cv.take<uint64_t>(128);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = full + 2 * kWgStages;
  int& last_block = reinterpret_cast<int*>(full)[31];  // past the barriers
  const size_t kv_run = act3d_wg_run_bytes((size_t)NK * E * 2);
  const size_t op = act3d_op_bytes(DP);
  const size_t mask_at = PREP ? G * 2 * op : 2 * kv_run;  // K, V (or records), mask bytes
  const size_t stage_bytes = mask_at + act3d_wg_run_bytes(NK);
  char* stages = cv.take<char>(kWgStages * stage_bytes);
  char* q_raw = cv.take<char>(act3d_wg_run_bytes((size_t)kWgRows * E * 2));
  unsigned* released = reinterpret_cast<unsigned*>(full) + 20;  // bytes 80-95
  const int arrivals = PREP ? 4 * G : G;  // releases of a stage
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      act3d_mbar_init(&full[i], 32);
      act3d_mbar_init(&empty[i], arrivals);
      released[i] = 0u;
    }
    act3d_mbar_init(qbar, 32);
    act3d_mbar_init_fence();
  }
  __syncthreads();

  const uint16_t* q_src = a.q + ((size_t)b * a.L + r0) * E;
  // warp 0 stages the query tile and the first stages; each later stage is
  // refilled by the warpgroup that releases it last
  const bool stager = warp == 0;
  const uint16_t* kv_end = a.k + (size_t)a.B * a.S * E;
  const uint16_t* v_end = a.v + (size_t)a.B * a.S * E;
  const uint8_t* mask_end = a.mask + (size_t)a.B * a.S;
  const int key_tiles = (a.S + NK - 1) / NK;
  const size_t krec = act3d_record_bytes(kFwdKeys, DP);  // V^T, K
  const char* krec_end = a.keyrec + (size_t)a.B * key_tiles * a.H * krec;
  auto stage_tile = [&](int it) {
    const int k0 = c_begin + it * NK;
    const int n = min(NK, c_end - k0);
    char* base = stages + (it % kWgStages) * stage_bytes;
    const uint8_t* m0 = a.mask + (size_t)b * a.S + k0;
    const Act3dRun mrun = {base + mask_at, m0, MASK ? (uint32_t)n : 0u, a.mask, mask_end};
    if (PREP) {  // the group's records: one contiguous run
      const char* rec = a.keyrec + (((size_t)b * key_tiles + k0 / NK) * a.H + hg * G) * krec;
      const Act3dRun runs[2] = {{base, rec, (uint32_t)(G * krec), a.keyrec, krec_end}, mrun};
      act3d_stage_runs(runs, &full[it % kWgStages], lane);
    } else {
      const size_t off = ((size_t)b * a.S + k0) * E;
      const Act3dRun runs[3] = {{base, a.k + off, (uint32_t)(n * E * 2), a.k, kv_end},
                                {base + kv_run, a.v + off, (uint32_t)(n * E * 2), a.v, v_end},
                                mrun};
      act3d_stage_runs(runs, &full[it % kWgStages], lane);
    }
  };
  if (stager) {
    const Act3dRun qrun[1] = {{q_raw, q_src, (uint32_t)(nr * E * 2), a.q,
                               a.q + (size_t)a.B * a.L * E}};
    act3d_stage_runs(qrun, qbar, lane);
    for (int it = 0; it < n_tiles && it < kWgStages; ++it) stage_tile(it);
  }

  // warpgroup wg: head h, rows r0 + 16 * wl + g (+ 8)
  char* mine = cv.p + (size_t)wg * 4 * op;  // without records: K and V^T twice each
  const int h = hg * G + wg;
  const int tid = threadIdx.x & 127;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = r0 + 16 * wl + g;
  const int row_b = row_a + 8;

  act3d_mbar_wait(qbar, 0);
  const uint16_t* qs = act3d_run_at<uint16_t>(q_raw, q_src) + h * a.d;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) act3d_wg_load_a(qa[kk], qs, E, nr, a.d, 16 * wl, 16 * kk, g, t);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t rk_a = 0u, rk_b = 0u;
  if (DROPOUT) {
    const uint32_t seed = act3d_dropout_seed(a.drop.seed, a.drop.slot);
    rk_a = act3d_dropout_row_key(seed, a.drop.b0 + b, h, row_a);
    rk_b = act3d_dropout_row_key(seed, a.drop.b0 + b, h, row_b);
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const int k0 = c_begin + it * NK;
    const int n = min(NK, c_end - k0);
    act3d_mbar_wait(&full[st], (it / kWgStages) & 1);
    const char* base = stages + st * stage_bytes;
    const size_t off = ((size_t)b * a.S + k0) * E;
    uint16_t* kop = reinterpret_cast<uint16_t*>(mine + (it & 1) * op);
    uint16_t* vop = reinterpret_cast<uint16_t*>(mine + (2 + (it & 1)) * op);
    if (PREP) {
      vop = reinterpret_cast<uint16_t*>(const_cast<char*>(base) + wg * 2 * op);
      kop = vop + 64 * DP;
    } else {
      act3d_wg_direct<NK, DP>(kop, act3d_run_at<uint16_t>(base, a.k + off) + h * a.d, E, n,
                              a.d, tid);
      act3d_wg_trans<NK, DP, false>(
          vop, act3d_run_at<uint16_t>(base + kv_run, a.v + off) + h * a.d, E, n, a.d, tid,
          nullptr);
    }
    // this thread's mask bytes (keys 8i + 2t + u), read before the stage is released
    uint32_t mbits = 0u;
    if (MASK) {
      const uint8_t* mrow = act3d_run_at<uint8_t>(base + mask_at, a.mask + (size_t)b * a.S + k0);
#pragma unroll
      for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (8 * i + 2 * t + u < n && mrow[8 * i + 2 * t + u]) mbits |= 1u << (2 * i + u);
        }
      }
    }
    if (!PREP) {  // the re-laid operands are this warpgroup's own: release the stage now
      act3d_fence_proxy_async();
      act3d_named_bar(1 + wg, 128);
      if (wl == 0) {
        act3d_release_stage(&empty[st], &released[st], arrivals, it / kWgStages,
                            it + kWgStages, n_tiles, lane, stage_tile);
      }
    }

    // s = q k^T on wgmma
    float s[NK / 2];
    act3d_wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      act3d_wgmma_rs_n64(s, qa[kk], act3d_wg_desc(kop + kk * 128, DP * 16), kk > 0);
    }
    act3d_wg_commit();
    act3d_wg_wait<0>();
    act3d_reg_fence(s);

    // element 4i + e of s: row g (e < 2) or g + 8, key 8i + 2t + (e & 1)
    if (MASK || n < NK) {
#pragma unroll
      for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * t + (e & 1);
          if (col >= n) {
            s[4 * i + e] = -INFINITY;
          } else if (MASK && ((mbits >> (2 * i + (e & 1))) & 1u)) {
            s[4 * i + e] = kMaskedScore;
          }
        }
      }
    }
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
      ta = fmaxf(ta, fmaxf(s[4 * i], s[4 * i + 1]));
      tb = fmaxf(tb, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    // every tile holds a key of the chunk, so the new max is finite
    const float na = fmaxf(m_a, quad_max(ta));
    const float nb = fmaxf(m_b, quad_max(tb));
    const float sa = act3d_ex2((m_a - na) * kLog2e);  // 0 while m is still -inf
    const float sb = act3d_ex2((m_b - nb) * kLog2e);
    m_a = na;
    m_b = nb;
    l_a *= sa;
    l_b *= sb;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= sa;
      o[4 * j + 1] *= sa;
      o[4 * j + 2] *= sb;
      o[4 * j + 3] *= sb;
    }
    const float ma2 = m_a * kLog2e, mb2 = m_b * kLog2e;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ra = e < 2;
        // masked scores sit at -1e30: (s - m) first, so a fully masked row
        // (m = -1e30) gets exp(0) exactly; elsewhere one FFMA
        float p = MASK ? act3d_ex2((s[4 * i + e] - (ra ? m_a : m_b)) * kLog2e)
                       : act3d_ex2(fmaf(s[4 * i + e], kLog2e, -(ra ? ma2 : mb2)));
        if (ra) l_a += p;  // l is the sum before dropout and rounding
        else l_b += p;
        if (DROPOUT && !act3d_dropout_keep(ra ? rk_a : rk_b, k0 + 8 * i + 2 * t + (e & 1),
                                           a.drop.threshold)) {
          p = 0.f;
        }
        s[4 * i + e] = p;
      }
    }
    uint32_t pa[NK / 16][4];  // p rounded to bf16: the A operand of p v
#pragma unroll
    for (int kt = 0; kt < NK / 16; ++kt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pa[kt][u] = act3d_pack_bf16(s[8 * kt + 2 * u], s[8 * kt + 2 * u + 1]);
      }
    }
#pragma unroll
    for (int kt = 0; kt < NK / 16; ++kt) {  // p v on mma.sync, B from the V^T tile
      if (16 * kt < n) act3d_mma_rs<DP, NK>(o, pa[kt], vop, 16 * kt, g, t);
    }
    if (PREP) {  // this warp's reads of the stage are done
      act3d_release_stage(&empty[st], &released[st], arrivals, it / kWgStages, it + kWgStages,
                          n_tiles, lane, stage_tile);
    }
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  const int rows[2] = {row_a, row_b};
  const float ms[2] = {m_a, m_b};
  const float ls[2] = {l_a, l_b};
  const float inv_keep = DROPOUT ? a.drop.inv_keep : 1.f;
  if (a.nsplit == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= a.L) continue;
      const size_t bl = (size_t)b * a.L + rows[r];
      uint16_t* dst = a.out + bl * E + h * a.d;
      const float scale = inv_keep / ls[r];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.d) dst[c] = act3d_to_bf16(o[4 * j + 2 * r] * scale);
        if (c + 1 < a.d) dst[c + 1] = act3d_to_bf16(o[4 * j + 2 * r + 1] * scale);
      }
      if (STATS && t == 0) {
        a.stats[bl * (2 * a.H) + 2 * h] = ms[r];
        a.stats[bl * (2 * a.H) + 2 * h + 1] = ls[r];
      }
    }
    return;
  }

  // a chunk of a split tile: the partial, then the last block combines
  const size_t bl_n = (size_t)a.B * a.L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.L) continue;
    const size_t sbl = (size_t)split * bl_n + (size_t)b * a.L + rows[r];
    float* dst = a.part_acc + sbl * E + h * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < a.d) dst[c] = o[4 * j + 2 * r];
      if (c + 1 < a.d) dst[c + 1] = o[4 * j + 2 * r + 1];
    }
    if (t == 0) {
      a.part_ml[(sbl * a.H + h) * 2] = ms[r];
      a.part_ml[(sbl * a.H + h) * 2 + 1] = ls[r];
    }
  }
  __threadfence();
  act3d_named_bar(8, 128 * G);
  if (threadIdx.x == 0) {
    const int unit = (b * gridDim.y + hg) * a.q_tiles + tile;
    last_block = atomicAdd(&a.counters[unit], 1) == a.nsplit - 1;
  }
  act3d_named_bar(8, 128 * G);
  if (!last_block) return;
  __threadfence();
  const int gd = G * a.d;
  for (int idx = threadIdx.x; idx < nr * gd; idx += 128 * G) {
    const int lr = idx / gd;
    const int hd = hg * G + (idx % gd) / a.d;
    const int c = idx % a.d;
    const size_t bl = (size_t)b * a.L + r0 + lr;
    float m = -INFINITY;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      m = fmaxf(m, __ldcg(a.part_ml + ((sp * bl_n + bl) * a.H + hd) * 2));
    }
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const size_t ml = ((sp * bl_n + bl) * a.H + hd) * 2;
      const float w = expf(__ldcg(a.part_ml + ml) - m);
      l += __ldcg(a.part_ml + ml + 1) * w;
      acc += __ldcg(a.part_acc + (sp * bl_n + bl) * E + hd * a.d + c) * w;
    }
    a.out[bl * E + hd * a.d + c] = act3d_to_bf16(acc * (inv_keep / l));
    if (STATS && c == 0) {
      a.stats[bl * (2 * a.H) + 2 * hd] = m;
      a.stats[bl * (2 * a.H) + 2 * hd + 1] = l;
    }
  }
}

template <int DP, bool MASK, bool DROPOUT, bool STATS, bool PREP>
cudaError_t launch_wg_dp(const WgFwdArgs& a, cudaStream_t stream) {
  auto kernel = mha_fwd_bf16_wgmma_kernel<DP, MASK, DROPOUT, STATS, PREP>;
  static bool sized = false;  // the attribute is a ceiling: set it once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  if (PREP) {
    const Act3dPrepArgs p{a.k, a.v, nullptr, nullptr, const_cast<char*>(a.keyrec), a.B, a.S,
                          a.H, a.d, (a.S + kWgKeys - 1) / kWgKeys, 0u, 0u, 0u, 1.f};
    const cudaError_t err = act3d_prep<DP, kFwdKeys>(p, stream);
    if (err != cudaSuccess) return err;
  }
  if (a.nsplit > 1) {
    const size_t units = (size_t)a.q_tiles * (a.H / a.G) * a.B;
    const cudaError_t err = cudaMemsetAsync(a.counters, 0, units * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.q_tiles * a.nsplit, a.H / a.G, a.B), 128 * a.G,
           wg_fwd_smem(a.H * a.d, DP, a.G, PREP), stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool PREP>
cudaError_t launch_wg_prep(const WgFwdArgs& a, bool masked, bool dropout, cudaStream_t stream) {
  if (a.stats == nullptr) {  // the single-head-layout core: no dropout, no stats
    return masked ? launch_wg_dp<DP, true, false, false, PREP>(a, stream)
                  : launch_wg_dp<DP, false, false, false, PREP>(a, stream);
  }
  if (dropout) {
    return masked ? launch_wg_dp<DP, true, true, true, PREP>(a, stream)
                  : launch_wg_dp<DP, false, true, true, PREP>(a, stream);
  }
  return masked ? launch_wg_dp<DP, true, false, true, PREP>(a, stream)
                : launch_wg_dp<DP, false, false, true, PREP>(a, stream);
}

template <int DP>
cudaError_t launch_wg(const WgFwdArgs& a, bool masked, bool dropout, cudaStream_t stream) {
  return a.keyrec ? launch_wg_prep<DP, true>(a, masked, dropout, stream)
                  : launch_wg_prep<DP, false>(a, masked, dropout, stream);
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
// the host, and the seed: `seed`, or, where `seed_slot` is not null, the
// uint32 word it points to in device memory, read when the kernels run (a
// CUDA graph captured over it drops with the seed the slot holds at each
// replay).  stats may be null where dropout is 0 (the core): then no stats are written.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int act3d_fused_mha_fwd_f32(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, void* stats, void* work, int B,
                                       int L, int S, int H, int d, int warps,
                                       int chunk, int nsplit, int dropout,
                                       unsigned int seed, const void* seed_slot,
                                       unsigned int threshold, float inv_keep,
                                       unsigned int b0, void* stream) {
  if (bad_args(B, L, S, H, d, warps, chunk, nsplit, stats, work, dropout)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop{seed, threshold, inv_keep, b0, static_cast<const uint32_t*>(seed_slot)};
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
// tensors (stats and work float32), and one more int, `group`, which picks
// the body.  group = 0: the mma.sync body above with the float32 entry's
// plan (warps, chunk, nsplit; d padded to 16, 32 or 64), for L <= 16 and
// d > 32.
// group >= 1: the wgmma body, `group` heads per block (1, 2 or 4, at most
// 64 / DP, dividing H), ceil(L / 64) query tiles, the keys in `nsplit`
// chunks of `chunk` keys; with nsplit > 1 `work` holds nsplit * B * L *
// (E + 2H) floats (partial accumulators, then partial (m, l)) followed by
// q_tiles * (H / group) * B int counters, zeroed here.  prep != 0 (the
// wgmma body): a prep kernel first writes the key records (V^T and K,
// act3d_record_bytes(kFwdKeys, DP) bytes per head and 64-key tile,
// [b][tile][h]) to the start of `work`, the partials (if any) following.
extern "C" int act3d_fused_mha_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* out, void* stats, void* work, int B,
                                        int L, int S, int H, int d, int warps,
                                        int chunk, int nsplit, int dropout, int group,
                                        int prep, unsigned int seed, const void* seed_slot,
                                        unsigned int threshold, float inv_keep,
                                        unsigned int b0, void* stream) {
  const Dropout drop{seed, threshold, inv_keep, b0, static_cast<const uint32_t*>(seed_slot)};
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  uint16_t* oh = static_cast<uint16_t*>(out);
  float* sf = static_cast<float*>(stats);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dr = dropout != 0;
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : 64;
  if (group != 0) {
    const bool group_ok = (group == 1 || group == 2 || group == 4) && dp <= 32 &&
                          group <= act3d_wg_max_group(dp) && H % group == 0;
    if (bad_args(B, L, S, H, d, 1, chunk, nsplit, stats, work, dropout) || !group_ok ||
        (prep && (work == nullptr || (nsplit > 1 && chunk % kWgKeys != 0))) ||
        wg_fwd_smem(H * d, dp, group, prep != 0) > kMaxSmem) {
      return (int)cudaErrorInvalidValue;
    }
    WgFwdArgs a{qh, kh, vh, mf, oh, sf, nullptr, nullptr, nullptr, nullptr,
                B, L, S, H, d, group, (L + kWgRows - 1) / kWgRows, chunk, nsplit, drop};
    float* w = wf;
    if (prep) {
      a.keyrec = reinterpret_cast<const char*>(w);
      w += (size_t)B * ((S + kWgKeys - 1) / kWgKeys) * H * act3d_record_bytes(kFwdKeys, dp) / 4;
    }
    if (nsplit > 1) {
      a.part_acc = w;
      a.part_ml = w + (size_t)nsplit * B * L * H * d;
      a.counters = reinterpret_cast<int*>(a.part_ml + (size_t)nsplit * B * L * H * 2);
    }
    const cudaError_t err = dp == 16 ? launch_wg<16>(a, mf != nullptr, dr, st)
                                     : launch_wg<32>(a, mf != nullptr, dr, st);
    return (int)err;
  }
  if (bad_args(B, L, S, H, d, warps, chunk, nsplit, stats, work, dropout)) {
    return (int)cudaErrorInvalidValue;
  }
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
