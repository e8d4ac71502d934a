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
//   p = exp(s - m) / l, keep from dropout_hash.cuh (keyed on the global
//   batch row b0 + b, as in the forward) and kp = keep / (1-rate)
//   (kp = 1 without dropout):
//     dv_j = sum_i p_ij kp_ij dO_i
//     ds_ij = p_ij (kp_ij dO_i . v_j - delta_i)
//     dq_i = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
//   As on the TPU, masked keys score -1e30 and ds is not zeroed there, so a
//   fully masked row (uniform p) gives the TPU kernel's dq and dk.
//
// What bounds it on the H100: 10*B*L*S*E FLOPs (five (L, S, d) products
// per head: k q^T, v dO^T, p^T dO, ds^T q, ds k) and L*S*H exponentials.
// At float32 accuracy on the tensor cores (3xTF32, 165 TFLOP/s) the
// training site B=16, L=50, S=3074, E=120 is 18 us of products; the bytes
// (q, dO, dq: B*L*E each; k, v, dk, dv: B*S*E each) are 95 MB, 28 us at
// 3.35 TB/s.
//
// Design: one pass, 5d multiply-adds per score (the bound's count).
//   * one block per (key tile, head, batch, L split); `key_warps` warps of
//     16 keys each.  The block's K and V are staged once, split into
//     (big, small) TF32 halves in shared memory, d padded with zeros to
//     DP = 8, 16, 32 or 64.
//   * the block walks its rows in tiles of 32 (fewer when a split has
//     fewer rows: more blocks fit on an SM at L = 1), q and dO split into
//     shared memory with m, 1/l, delta and the dropout row keys.  For every 8
//     rows each warp computes s^T = k q^T and dp^T = v dO^T for its 16
//     keys (tensor cores, 3xTF32), then p, the keep mask and ds once per
//     score, and accumulates dv += p^T dO and dk += ds^T q in registers;
//     the score fragments feed those products directly (mma_tf32.cuh).
//   * ds of the row tile goes to shared memory; after a barrier the warps
//     share the tile's dq = ds k (16 rows x 8 dims per task) over the
//     block's keys.  With one key tile (S <= 16 * key_warps) dq is written
//     directly; otherwise each key tile writes its own slab of a workspace
//     and a second kernel sums the slabs in tile order.
//   * when key tiles x H x B alone cannot fill the card (S = 53 sites), L
//     is split over `nsplit` blocks: each writes partial dk/dv slabs and the
//     same summing kernel adds them in split order.  No atomics: a run
//     repeated gives the same bits.
//   * ragged L and S edges are masked in the kernel (p = 0 past the last
//     key, zero rows past the last row; nothing written for either).
//
// The bf16 entry (act3d_fused_mha_bwd_bf16, --mixed_precision 1 training)
// takes q, k, v, dO and writes dq, dk, dv in bf16; stats, delta and the
// workspace stay float32.  It rounds where the TPU kernel's _mha_bwd_body
// does on bf16 inputs, with ex = exp(s - m) unnormalised and r = 1 / l:
//     dof = bf16(dO r / (1 - rate)),  dv_j = sum_i bf16(ex_ij keep_ij) dof_i
//     ds_ij = bf16(ex_ij (keep_ij dO_i . v_j / (1 - rate) - delta_i))
//     dq_i = (sum_j ds_ij k_j) r_i,  dk_j = sum_i ds_ij bf16(q_i r_i)
// with bf16 products and float32 sums.  Two bodies, picked by the wrapper's
// plan (kernels/attention.py::bwd_plan_bf16) by shape:
//   * wgmma (Hopper; csrc/mha_wgmma_bf16.cuh), for L > 64 and d <= 32: two
//     passes from one C call, each with the forward's staging (bulk copies
//     into a 4-stage ring, refilled by the warpgroup that releases a stage
//     last).  dk/dv per 64-key block of a head group: s^T = k q^T and dp^T
//     = v dO^T on wgmma m64n64k16 (k and v in registers, q and dO from
//     the row records a prep kernel writes once per call), then dv +=
//     ex_kept^T dof and dk += ds^T qf on mma.sync from the score
//     accumulators (qf, dof rounded as above, in the same records; an A/B
//     against re-laying each row tile in the block where one key tile reads
//     it found no gain, PERF.md);
//     the L splits of the S = 53 sites write float32 dk/dv slabs that
//     sum_slabs adds in split order.  dq per 64-row query tile of a head
//     group, over key records: s = q k^T and dp = dO v^T on wgmma, ds from
//     the stats, dq += ds k on mma.sync; it recomputes the exponentials (one more pass of
//     them: the bound's B*L*S*H twice) instead of writing ds or per-key-tile
//     dq slabs (63 MB at the Act3D ghost site); its key splits are combined
//     in chunk order by the last block of a tile.  exp2 as in the forward.
//   * mma.sync m16n8k16 (mma_bf16.cuh), for L <= 64 (one row tile per key
//     block, where its single pass beat the two wgmma passes) and d > 32:
//     the float32 kernel's grid, plan, slabs and summing kernel (the slabs
//     float32, rounded to bf16 once summed); rows go 16 at a time, since two
//     8-row score fragments make one k = 16 operand.  K, V, q and dO are
//     staged row-major, K^T and the scaled q and dO transposed, so every B
//     operand is one 32-bit shared-memory word.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "mha_wgmma_bf16.cuh"

namespace {

// rows staged per step; scripts/ab_fused_mha_plans.py builds 16 and 64
#ifndef ACT3D_BWD_ROW_TILE
#define ACT3D_BWD_ROW_TILE 32
#endif
constexpr int kRowTile = ACT3D_BWD_ROW_TILE;
constexpr int kMaxKeyWarps = 8;
constexpr float kMaskedScore = -1e30f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on the H100

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  uint32_t b0;  // the rows' offset in the global batch (data parallelism)
  const uint32_t* slot;  // the seed in device memory (the entries' seed_slot), or null
};

__host__ __device__ constexpr int ds_stride(int key_block) { return key_block + 8; }

// Rows staged per step of one launch: kRowTile, or fewer when a split has
// fewer rows (the L = 1 site), so more blocks fit on an SM; a multiple of
// 16, since the dq tasks read ds in 16-row groups.
int row_tile(int rows_per_split) {
  const int r16 = (rows_per_split + 15) & ~15;
  return r16 < kRowTile ? r16 : kRowTile;
}

size_t smem_bytes(int dp, int key_warps, int rt) {
  const int kb = 16 * key_warps;
  const int sd = dp + 4;
  const size_t floats =
      (size_t)4 * kb * sd + 4 * rt * sd + 2 * rt * ds_stride(kb) + 4 * rt;
  return floats * sizeof(float) + kb;
}

// grid (key_tiles * nsplit, H, B), blockIdx.x = split * key_tiles + tile;
// blockDim 32 * key_warps.  dq_parts == nullptr: write dq, else the tile's
// slab dq_parts[tile] (key_tiles, B, L, E).  dkv_parts == nullptr: write
// dk/dv, else the split's slabs dk: dkv_parts[split], dv:
// dkv_parts[nsplit + split] (each B, S, E).
template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(32 * kMaxKeyWarps)
mha_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ stats, const float* __restrict__ delta,
               const uint8_t* __restrict__ mask, float* __restrict__ dq,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dq_parts, float* __restrict__ dkv_parts, int B,
               int L, int S, int H, int d, int key_tiles, int nsplit,
               int rows_per_split, int rt, Dropout drop) {
  const uint32_t seed = DROPOUT ? act3d_dropout_seed(drop.seed, drop.slot) : 0u;
  constexpr int SD = DP + 4;
  constexpr int KD = DP / 8;
  const int kw = blockDim.x >> 5;
  const int KB = 16 * kw;
  const int DS = ds_stride(KB);
  extern __shared__ float smem[];
  float* kb = smem;                        // [KB][SD] k, big
  float* ks = kb + KB * SD;                //          k, small
  float* vb = ks + KB * SD;                // [KB][SD] v
  float* vs = vb + KB * SD;
  float* qb = vs + KB * SD;                // [rt][SD] q
  float* qs = qb + rt * SD;
  float* ob = qs + rt * SD;                // [rt][SD] dO
  float* os = ob + rt * SD;
  float* db = os + rt * SD;                // [rt][DS] ds (row, key)
  float* dsm = db + rt * DS;
  float* m_s = dsm + rt * DS;              // [rt] m
  float* r_s = m_s + rt;                   //      1 / l
  float* dl_s = r_s + rt;                  //      delta
  uint32_t* rk_s = reinterpret_cast<uint32_t*>(dl_s + rt);  // row keys
  uint8_t* km_s = reinterpret_cast<uint8_t*>(rk_s + rt);    // [KB] mask

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x % key_tiles;
  const int split = blockIdx.x / key_tiles;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int kdu = (d + 7) >> 3;
  const int k0 = tile * KB;
  const int nk = min(KB, S - k0);
  const int nk8 = (nk + 7) & ~7;
  const bool warp_keys = warp * 16 < nk;

  float* dq_out = dq_parts ? dq_parts + (size_t)tile * B * L * E : dq;
  const size_t bse = (size_t)B * S * E;
  float* dk_out = dkv_parts ? dkv_parts + (size_t)split * bse : dk;
  float* dv_out = dkv_parts ? dkv_parts + (size_t)(nsplit + split) * bse : dv;

  const float* k_b = k + ((size_t)b * S + k0) * E + h * d;
  const float* v_b = v + ((size_t)b * S + k0) * E + h * d;
  act3d_stage_pair<DP, SD>(k_b, v_b, E, nk, KB, d, kb, ks, vb, vs);  // zero rows past S
  for (int j = threadIdx.x; j < KB; j += blockDim.x) {
    km_s[j] = (j < nk && mask) ? mask[(size_t)b * S + k0 + j] : 0;
  }

  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dka[kk][i] = 0.f;
      dva[kk][i] = 0.f;
    }
  }

  const int r_begin = split * rows_per_split;
  const int r_end = min(L, r_begin + rows_per_split);
  const float* q_b = q + (size_t)b * L * E + h * d;
  const float* o_b = dout + (size_t)b * L * E + h * d;

  for (int i0 = r_begin; i0 < r_end; i0 += rt) {
    const int n = min(rt, r_end - i0);
    const int n8 = (n + 7) & ~7;
    __syncthreads();  // the previous row tile (q, dO, ds) is no longer read
    act3d_stage_pair<DP, SD>(q_b + (size_t)i0 * E, o_b + (size_t)i0 * E, E, n, n8, d, qb, qs,
                             ob, os);
    for (int r = threadIdx.x; r < n8; r += blockDim.x) {
      float mv = 0.f, rv = 0.f, dlv = 0.f;  // rows past L: p = 0, ds = 0
      uint32_t rk = 0u;
      if (r < n) {
        const size_t row = (size_t)b * L + i0 + r;
        mv = stats[row * (2 * H) + 2 * h];
        rv = 1.f / stats[row * (2 * H) + 2 * h + 1];
        dlv = delta[row * H + h];
        if (DROPOUT) rk = act3d_dropout_row_key(seed, drop.b0 + b, h, i0 + r);
      }
      m_s[r] = mv;
      r_s[r] = rv;
      dl_s[r] = dlv;
      rk_s[r] = rk;
    }
    __syncthreads();

    if (warp_keys) {
      // this row tile's dk and dv go to fresh accumulators, added to the
      // running sums in float32 after the tile (the tensor cores do not
      // round to nearest as they accumulate)
      float dkt[KD][4], dvt[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dkt[kk][i] = 0.f;
          dvt[kk][i] = 0.f;
        }
      }
      for (int rc = 0; rc < (n8 >> 3); ++rc) {
        // s^T and dp^T for the warp's 16 keys and 8 rows: C fragment
        // element e is (key g + 8 (e >= 2), row 2t + (e & 1)).
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        float dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk < kdu) {
            uint32_t ab[4], as[4], bb[2], bs[2];
            act3d_load_a(kb, ks, SD, warp * 16, kk * 8, g, t, ab, as);
            act3d_load_bt(qb, qs, SD, rc * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(st, ab, as, bb, bs);
            act3d_load_a(vb, vs, SD, warp * 16, kk * 8, g, t, ab, as);
            act3d_load_bt(ob, os, SD, rc * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(dpt, ab, as, bb, bs);
          }
        }
        float pk[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = warp * 16 + g + (e >= 2 ? 8 : 0);
          const int il = rc * 8 + 2 * t + (e & 1);
          const float s = km_s[jl] ? kMaskedScore : st[e];
          const float p = jl < nk ? expf(s - m_s[il]) * r_s[il] : 0.f;
          float dp = dpt[e];
          float pkv = p;
          if (DROPOUT) {
            const bool keep = act3d_dropout_keep(rk_s[il], k0 + jl, drop.threshold);
            pkv = keep ? p * drop.inv_keep : 0.f;
            dp = keep ? dp * drop.inv_keep : 0.f;
          }
          pk[e] = pkv;
          dsv[e] = p * (dp - dl_s[il]);
        }
        uint32_t pab[4], pas[4], dab[4], das[4];
        act3d_c_as_a(pk, pab, pas);
        act3d_c_as_a(dsv, dab, das);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk < kdu) {
            uint32_t bb[2], bs[2];
            act3d_load_b_perm(ob, os, SD, rc * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(dvt[kk], pab, pas, bb, bs);
            act3d_load_b_perm(qb, qs, SD, rc * 8, kk * 8, g, t, bb, bs);
            act3d_mma_3xtf32(dkt[kk], dab, das, bb, bs);
          }
        }
        const int ra = (rc * 8 + 2 * t) * DS + warp * 16 + g;
        act3d_store_split(db, dsm, ra, dsv[0]);
        act3d_store_split(db, dsm, ra + DS, dsv[1]);
        act3d_store_split(db, dsm, ra + 8, dsv[2]);
        act3d_store_split(db, dsm, ra + DS + 8, dsv[3]);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dka[kk][i] += dkt[kk][i];
          dva[kk][i] += dvt[kk][i];
        }
      }
    }
    __syncthreads();

    // dq of the row tile: tasks of (16 rows, 8 dims) over the block's keys;
    // ds in the A operand under the k permutation (float2 reads).
    const int tasks = ((n + 15) >> 4) * kdu;
    for (int task = warp; task < tasks; task += kw) {
      const int rg = task / kdu;
      const int on = task % kdu;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < (nk8 >> 3); ++kk) {
        const int i_a = (rg * 16 + g) * DS + kk * 8 + 2 * t;
        const int i_b = i_a + 8 * DS;
        const float2 xa = *reinterpret_cast<const float2*>(db + i_a);
        const float2 xb = *reinterpret_cast<const float2*>(db + i_b);
        const float2 ya = *reinterpret_cast<const float2*>(dsm + i_a);
        const float2 yb = *reinterpret_cast<const float2*>(dsm + i_b);
        const uint32_t ab[4] = {__float_as_uint(xa.x), __float_as_uint(xb.x),
                                __float_as_uint(xa.y), __float_as_uint(xb.y)};
        const uint32_t as[4] = {__float_as_uint(ya.x), __float_as_uint(yb.x),
                                __float_as_uint(ya.y), __float_as_uint(yb.y)};
        uint32_t bb[2], bs[2];
        act3d_load_b_perm(kb, ks, SD, kk * 8, on * 8, g, t, bb, bs);
        act3d_mma_3xtf32(acc, ab, as, bb, bs);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;
        if (row >= n) continue;
        float* dst = dq_out + ((size_t)b * L + i0 + row) * E + h * d;
        const int c = on * 8 + 2 * t;
        if (c < d) dst[c] = acc[2 * r];
        if (c + 1 < d) dst[c + 1] = acc[2 * r + 1];
      }
    }
  }

  if (warp_keys) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jl = warp * 16 + g + 8 * r;
      if (jl >= nk) continue;
      const size_t off = ((size_t)b * S + k0 + jl) * E + h * d;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int c = kk * 8 + 2 * t;
        if (c < d) {
          dk_out[off + c] = dka[kk][2 * r];
          dv_out[off + c] = dva[kk][2 * r];
        }
        if (c + 1 < d) {
          dk_out[off + c + 1] = dka[kk][2 * r + 1];
          dv_out[off + c + 1] = dva[kk][2 * r + 1];
        }
      }
    }
  }
}

// out[x] = sum over s of parts[s * n + x], in slab order (and the same for
// a second array when out2 is given).  The slabs are read in batches of
// kBatch loads in flight, then added in order.
template <typename OutT>
__global__ void sum_slabs_kernel(const float* __restrict__ parts, OutT* __restrict__ out,
                                 const float* __restrict__ parts2,
                                 OutT* __restrict__ out2, size_t n, int nslab) {
  constexpr int kBatch = 8;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s0 = 0; s0 < nslab; s0 += kBatch) {
      float pa[kBatch], pc[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = s0 + u < nslab;
        pa[u] = live ? parts[(s0 + u) * n + x] : 0.f;
        pc[u] = live && out2 ? parts2[(s0 + u) * n + x] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < nslab) {
          a += pa[u];
          c += pc[u];
        }
      }
    }
    act3d_store(out + x, a);
    if (out2) act3d_store(out2 + x, c);
  }
}

template <typename OutT>
void sum_slabs(const float* parts, OutT* out, const float* parts2, OutT* out2,
               size_t n, int nslab, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  sum_slabs_kernel<<<blocks, 256, 0, stream>>>(parts, out, parts2, out2, n, nslab);
}

template <int DP, bool DROPOUT>
cudaError_t launch_dp(const float* q, const float* k, const float* v, const float* dout,
                      const float* stats, const float* delta, const uint8_t* mask,
                      float* dq, float* dk, float* dv, float* work, int B, int L, int S,
                      int H, int d, int key_warps, int rows_per_split, int nsplit,
                      Dropout drop, cudaStream_t stream) {
  const int key_tiles = (S + 16 * key_warps - 1) / (16 * key_warps);
  const int rt = row_tile(rows_per_split);
  const size_t smem = smem_bytes(DP, key_warps, rt);
  auto kernel = mha_bwd_kernel<DP, DROPOUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const size_t ble = (size_t)B * L * H * d;
  const size_t bse = (size_t)B * S * H * d;
  float* dq_parts = key_tiles > 1 ? work : nullptr;
  float* dkv_parts = nsplit > 1 ? work + (key_tiles > 1 ? key_tiles * ble : 0) : nullptr;
  kernel<<<dim3(key_tiles * nsplit, H, B), 32 * key_warps, smem, stream>>>(
      q, k, v, dout, stats, delta, mask, dq, dk, dv, dq_parts, dkv_parts, B, L, S, H, d,
      key_tiles, nsplit, rows_per_split, rt, drop);
  if (dq_parts) sum_slabs<float>(dq_parts, dq, nullptr, nullptr, ble, key_tiles, stream);
  if (dkv_parts) {
    sum_slabs<float>(dkv_parts, dk, dkv_parts + nsplit * bse, dv, bse, nsplit, stream);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(bool dropout, const float* q, const float* k, const float* v,
                   const float* dout, const float* stats, const float* delta,
                   const uint8_t* mask, float* dq, float* dk, float* dv, float* work,
                   int B, int L, int S, int H, int d, int key_warps, int rows_per_split,
                   int nsplit, Dropout drop, cudaStream_t stream) {
  if (dropout) {
    return launch_dp<DP, true>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work, B, L,
                               S, H, d, key_warps, rows_per_split, nsplit, drop, stream);
  }
  return launch_dp<DP, false>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work, B, L,
                              S, H, d, key_warps, rows_per_split, nsplit, drop, stream);
}

// ---------------------------------------------------------------- bf16
size_t smem_bytes_bf16(int dp, int key_warps, int rt) {
  const int kb = 16 * key_warps;
  const size_t halves = (size_t)2 * kb * (dp + 8) + (size_t)dp * (kb + 8) +
                        (size_t)2 * rt * (dp + 8) + (size_t)2 * dp * (rt + 8) +
                        (size_t)rt * (kb + 8);
  return halves * sizeof(uint16_t) + 4 * rt * sizeof(float) + kb;
}

// mha_bwd_kernel's grid and block at bf16 (see the header comment).
// dq_parts == nullptr: write dq (bf16), else the tile's float32 slab;
// dkv_parts == nullptr: write dk/dv (bf16), else the split's slabs.
template <int DP, bool DROPOUT>
__global__ void __launch_bounds__(32 * kMaxKeyWarps)
mha_bwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ stats, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, uint16_t* __restrict__ dq,
                    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                    float* __restrict__ dq_parts, float* __restrict__ dkv_parts, int B,
                    int L, int S, int H, int d, int key_tiles, int nsplit,
                    int rows_per_split, int rt, Dropout drop) {
  const uint32_t seed = DROPOUT ? act3d_dropout_seed(drop.seed, drop.slot) : 0u;
  constexpr int SK = DP + 8;  // [key or row][dim] tiles
  constexpr int KS = DP / 16; // k-steps over dims
  constexpr int NO = DP / 8;  // n-tiles over dims
  const int kw = blockDim.x >> 5;
  const int KB = 16 * kw;
  const int SKB = KB + 8;  // [dim][key] and [row][key] tiles
  const int SR = rt + 8;   // [dim][row] tiles
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* k_s = smem16;             // [KB][SK] k
  uint16_t* v_s = k_s + KB * SK;      // [KB][SK] v
  uint16_t* kt_s = v_s + KB * SK;     // [DP][SKB] k^T
  uint16_t* q_s = kt_s + DP * SKB;    // [rt][SK] q
  uint16_t* o_s = q_s + rt * SK;      // [rt][SK] dO
  uint16_t* qft_s = o_s + rt * SK;    // [DP][SR] bf16(q r)^T
  uint16_t* oft_s = qft_s + DP * SR;  // [DP][SR] bf16(dO r / (1 - rate))^T
  uint16_t* ds_s = oft_s + DP * SR;   // [rt][SKB] bf16(ds)
  float* m_s = reinterpret_cast<float*>(ds_s + rt * SKB);  // [rt] m
  float* r_s = m_s + rt;                                   //      1 / l
  float* dl_s = r_s + rt;                                  //      delta
  uint32_t* rk_s = reinterpret_cast<uint32_t*>(dl_s + rt); //      row keys
  uint8_t* km_s = reinterpret_cast<uint8_t*>(rk_s + rt);   // [KB] mask

  const int E = H * d;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x % key_tiles;
  const int split = blockIdx.x / key_tiles;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int ksu = (d + 15) >> 4;
  const int nou = (d + 7) >> 3;
  const int k0 = tile * KB;
  const int nk = min(KB, S - k0);
  const int nk16 = (nk + 15) & ~15;
  const bool warp_keys = warp * 16 < nk;
  const float inv_keep = DROPOUT ? drop.inv_keep : 1.f;

  const size_t bse = (size_t)B * S * E;
  float* dq_slab = dq_parts ? dq_parts + (size_t)tile * B * L * E : nullptr;
  float* dk_slab = dkv_parts ? dkv_parts + (size_t)split * bse : nullptr;
  float* dv_slab = dkv_parts ? dkv_parts + (size_t)(nsplit + split) * bse : nullptr;

  const uint16_t* k_b = k + ((size_t)b * S + k0) * E + h * d;
  const uint16_t* v_b = v + ((size_t)b * S + k0) * E + h * d;
  act3d_stage_bf16<DP>(k_b, E, nk, KB, d, k_s, SK, kt_s, SKB);  // zero rows past S
  act3d_stage_bf16<DP>(v_b, E, nk, KB, d, v_s, SK, nullptr, 0);
  for (int j = threadIdx.x; j < KB; j += blockDim.x) {
    km_s[j] = (j < nk && mask) ? mask[(size_t)b * S + k0 + j] : 0;
  }

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int on = 0; on < NO; ++on) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dka[on][i] = 0.f;
      dva[on][i] = 0.f;
    }
  }

  const int r_begin = split * rows_per_split;
  const int r_end = min(L, r_begin + rows_per_split);
  const uint16_t* q_b = q + (size_t)b * L * E + h * d;
  const uint16_t* o_b = dout + (size_t)b * L * E + h * d;

  for (int i0 = r_begin; i0 < r_end; i0 += rt) {
    const int n = min(rt, r_end - i0);
    const int n16 = (n + 15) & ~15;
    __syncthreads();  // the previous row tile is no longer read
    for (int r = threadIdx.x; r < n16; r += blockDim.x) {
      float mv = 0.f, rv = 0.f, dlv = 0.f;  // rows past L: zero operands, ds = 0
      uint32_t rk = 0u;
      if (r < n) {
        const size_t row = (size_t)b * L + i0 + r;
        mv = stats[row * (2 * H) + 2 * h];
        rv = 1.f / stats[row * (2 * H) + 2 * h + 1];
        dlv = delta[row * H + h];
        if (DROPOUT) rk = act3d_dropout_row_key(seed, drop.b0 + b, h, i0 + r);
      }
      m_s[r] = mv;
      r_s[r] = rv;
      dl_s[r] = dlv;
      rk_s[r] = rk;
    }
    act3d_stage_bf16<DP>(q_b + (size_t)i0 * E, E, n, n16, d, q_s, SK, nullptr, 0);
    act3d_stage_bf16<DP>(o_b + (size_t)i0 * E, E, n, n16, d, o_s, SK, nullptr, 0);
    __syncthreads();
    // the row-scaled operands of dk and dv, rounded as the TPU kernel rounds
    // qf and dof, transposed
    for (int i = threadIdx.x; i < n16 * DP; i += blockDim.x) {
      const int j = i / DP;
      const int c = i % DP;
      qft_s[c * SR + j] = act3d_to_bf16(act3d_from_bf16(q_s[j * SK + c]) * r_s[j]);
      oft_s[c * SR + j] =
          act3d_to_bf16(act3d_from_bf16(o_s[j * SK + c]) * (r_s[j] * inv_keep));
    }
    __syncthreads();

    if (warp_keys) {
      // this row tile's dk and dv in fresh float32 accumulators, added to
      // the running sums after the tile, as the float32 kernel does
      float dkt[NO][4], dvt[NO][4];
#pragma unroll
      for (int on = 0; on < NO; ++on) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dkt[on][i] = 0.f;
          dvt[on][i] = 0.f;
        }
      }
      for (int rc = 0; rc < (n16 >> 4); ++rc) {
        // s^T and dp^T for the warp's 16 keys and 16 rows, two n-tiles of
        // 8 rows: element e of tile j is (key g + 8 (e >= 2), row
        // 8 j + 2t + (e & 1))
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            dpt[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk < ksu) {
            uint32_t ka[4], va[4];
            act3d_bf16_load_a(k_s, SK, warp * 16, kk * 16, g, t, ka);
            act3d_bf16_load_a(v_s, SK, warp * 16, kk * 16, g, t, va);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t bb[2];
              act3d_bf16_load_b(q_s, SK, rc * 16 + j * 8, kk * 16, g, t, bb);
              act3d_mma_bf16(st[j], ka, bb);
              act3d_bf16_load_b(o_s, SK, rc * 16 + j * 8, kk * 16, g, t, bb);
              act3d_mma_bf16(dpt[j], va, bb);
            }
          }
        }
        float exk[2][4], dsv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = warp * 16 + g + (e >= 2 ? 8 : 0);
            const int il = rc * 16 + j * 8 + 2 * t + (e & 1);
            const float s = km_s[jl] ? kMaskedScore : st[j][e];
            const float ex = (jl < nk && il < n) ? expf(s - m_s[il]) : 0.f;
            float dp = dpt[j][e];
            float kept = ex;
            if (DROPOUT) {
              const bool keep = act3d_dropout_keep(rk_s[il], k0 + jl, drop.threshold);
              kept = keep ? ex : 0.f;
              dp = keep ? dp * inv_keep : 0.f;
            }
            exk[j][e] = kept;
            dsv[j][e] = ex * (dp - dl_s[il]);
          }
        }
        uint32_t pa[4], da[4];
        act3d_bf16_c_as_a(exk[0], exk[1], pa);  // rounded to bf16 here
        act3d_bf16_c_as_a(dsv[0], dsv[1], da);
#pragma unroll
        for (int on = 0; on < NO; ++on) {
          if (on < nou) {
            uint32_t bb[2];
            act3d_bf16_load_b(oft_s, SR, on * 8, rc * 16, g, t, bb);
            act3d_mma_bf16(dvt[on], pa, bb);
            act3d_bf16_load_b(qft_s, SR, on * 8, rc * 16, g, t, bb);
            act3d_mma_bf16(dkt[on], da, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = warp * 16 + g + (e >= 2 ? 8 : 0);
            const int il = rc * 16 + j * 8 + 2 * t + (e & 1);
            ds_s[il * SKB + jl] = act3d_to_bf16(dsv[j][e]);
          }
        }
      }
#pragma unroll
      for (int on = 0; on < NO; ++on) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dka[on][i] += dkt[on][i];
          dva[on][i] += dvt[on][i];
        }
      }
    }
    __syncthreads();

    // dq of the row tile: tasks of (16 rows, 8 dims) over the block's keys
    // (keys past nk carry ds = 0 and k = 0), scaled by r afterwards
    const int tasks = (n16 >> 4) * nou;
    for (int task = warp; task < tasks; task += kw) {
      const int rg = task / nou;
      const int on = task % nou;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < (nk16 >> 4); ++kk) {
        uint32_t a[4], bb[2];
        act3d_bf16_load_a(ds_s, SKB, rg * 16, kk * 16, g, t, a);
        act3d_bf16_load_b(kt_s, SKB, on * 8, kk * 16, g, t, bb);
        act3d_mma_bf16(acc, a, bb);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rg * 16 + g + 8 * r;
        if (row >= n) continue;
        const float rr = r_s[row];
        const size_t off = ((size_t)b * L + i0 + row) * E + h * d;
        const int c = on * 8 + 2 * t;
        if (dq_slab) {
          if (c < d) dq_slab[off + c] = acc[2 * r] * rr;
          if (c + 1 < d) dq_slab[off + c + 1] = acc[2 * r + 1] * rr;
        } else {
          if (c < d) dq[off + c] = act3d_to_bf16(acc[2 * r] * rr);
          if (c + 1 < d) dq[off + c + 1] = act3d_to_bf16(acc[2 * r + 1] * rr);
        }
      }
    }
  }

  if (warp_keys) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jl = warp * 16 + g + 8 * r;
      if (jl >= nk) continue;
      const size_t off = ((size_t)b * S + k0 + jl) * E + h * d;
#pragma unroll
      for (int on = 0; on < NO; ++on) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = on * 8 + 2 * t + u;
          if (c >= d) continue;
          if (dkv_parts) {
            dk_slab[off + c] = dka[on][2 * r + u];
            dv_slab[off + c] = dva[on][2 * r + u];
          } else {
            dk[off + c] = act3d_to_bf16(dka[on][2 * r + u]);
            dv[off + c] = act3d_to_bf16(dva[on][2 * r + u]);
          }
        }
      }
    }
  }
}

template <int DP, bool DROPOUT>
cudaError_t launch_bf16_dp(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                           const uint16_t* dout, const float* stats, const float* delta,
                           const uint8_t* mask, uint16_t* dq, uint16_t* dk, uint16_t* dv,
                           float* work, int B, int L, int S, int H, int d, int key_warps,
                           int rows_per_split, int nsplit, Dropout drop,
                           cudaStream_t stream) {
  const int key_tiles = (S + 16 * key_warps - 1) / (16 * key_warps);
  const int rt = row_tile(rows_per_split);
  const size_t smem = smem_bytes_bf16(DP, key_warps, rt);
  auto kernel = mha_bwd_bf16_kernel<DP, DROPOUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const size_t ble = (size_t)B * L * H * d;
  const size_t bse = (size_t)B * S * H * d;
  float* dq_parts = key_tiles > 1 ? work : nullptr;
  float* dkv_parts = nsplit > 1 ? work + (key_tiles > 1 ? key_tiles * ble : 0) : nullptr;
  kernel<<<dim3(key_tiles * nsplit, H, B), 32 * key_warps, smem, stream>>>(
      q, k, v, dout, stats, delta, mask, dq, dk, dv, dq_parts, dkv_parts, B, L, S, H, d,
      key_tiles, nsplit, rows_per_split, rt, drop);
  if (dq_parts) sum_slabs<uint16_t>(dq_parts, dq, nullptr, nullptr, ble, key_tiles, stream);
  if (dkv_parts) {
    sum_slabs<uint16_t>(dkv_parts, dk, dkv_parts + nsplit * bse, dv, bse, nsplit, stream);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(bool dropout, const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, const uint16_t* dout, const float* stats,
                        const float* delta, const uint8_t* mask, uint16_t* dq, uint16_t* dk,
                        uint16_t* dv, float* work, int B, int L, int S, int H, int d,
                        int key_warps, int rows_per_split, int nsplit, Dropout drop,
                        cudaStream_t stream) {
  if (dropout) {
    return launch_bf16_dp<DP, true>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work, B,
                                    L, S, H, d, key_warps, rows_per_split, nsplit, drop,
                                    stream);
  }
  return launch_bf16_dp<DP, false>(q, k, v, dout, stats, delta, mask, dq, dk, dv, work, B,
                                   L, S, H, d, key_warps, rows_per_split, nsplit, drop,
                                   stream);
}

// ------------------------------------------------- bf16 on wgmma (Hopper)
// The bf16 backward of the sites with more than 64 query rows (see the
// header comment): two passes launched from one C call.
//   dk/dv: a block is one 64-key tile of one batch row for a group of G
//   heads (G warpgroups, one head and the 64 keys each), over one split of
//   the rows.  A prep kernel first writes each row tile's records (q and dO
//   [row][DP]; bf16(q r) and bf16(dO r / (1 - rate)) as [DP][row], the TPU
//   kernel's qf and dof, rounded as it rounds them; the per-row values).
//   Warp 0 stages the tile's K, V and mask bytes once and the group's
//   records of the first row tiles in the ring, refilled by the warpgroup
//   that releases a stage last; each warpgroup reads its head's record in
//   place and computes s^T = k q^T and dp^T = v dO^T (m64 n64, k and v in registers),
//   then ex, the keep bit and ds per score, and dv += ex_kept^T dof, dk +=
//   ds^T qf (the score accumulators as A in registers).  With
//   nsplit > 1 (the S = 53 sites) each split writes float32 dk/dv slabs that
//   sum_slabs adds in split order.
//   dq: a block is one 64-row query tile for G heads over one chunk of the
//   keys, as the forward, over the key records (K, V and K^T per head,
//   written by a prep kernel): s = q k^T and dp = dO v^T (m64 nNK), ds from
//   the stats, dq += ds k; dq = (sum) r.  It recomputes s, the
//   exponentials and dp rather than writing ds or per-key-tile dq slabs.
//   With dq_nsplit > 1 each chunk writes a float32 partial and the last
//   block of a tile to arrive sums the chunks in chunk order.
struct WgBwdArgs {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* stats;
  const float* delta;
  const uint8_t* mask;
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  float* dkv_parts;
  float* dq_part;
  int* counters;
  const char* rowrec;  // row records (the dk/dv pass), [b][row tile][h]
  const char* keyrec;  // key records (the dq pass), [b][key tile][h]
  int B, L, S, H, d;
  int G;                          // heads per block of the launch
  int key_tiles, rows_per_split, nsplit;  // dk/dv pass
  int q_tiles, dq_chunk, dq_nsplit;       // dq pass
  Dropout drop;
};

constexpr int kWgKeyRows = 64;  // keys of a dk/dv block: the products' M

// Shared bytes of a dk/dv block: barriers, K, V and the mask bytes, and the
// ring (the group's row records of a row tile).
size_t wg_dkdv_smem(int E, int dp, int G) {
  const size_t kv = act3d_wg_run_bytes((size_t)kWgKeyRows * E * 2);
  return 128 + 2 * kv + act3d_wg_run_bytes(kWgKeyRows) +
         kWgStages * (size_t)G * act3d_record_bytes(kRows, dp);
}

// Shared bytes of a dq block: barriers, the ring (the group's key records of
// a key tile and its mask bytes), and the row tile's q, dO, stats and delta.
size_t wg_dq_smem(int E, int H, int dp, int G) {
  const size_t stage = (size_t)G * act3d_record_bytes(kDqKeys, dp) + act3d_wg_run_bytes(kWgKeys);
  const size_t once = 2 * act3d_wg_run_bytes((size_t)kWgRows * E * 2) +
                      act3d_wg_run_bytes((size_t)kWgRows * 2 * H * 4) +
                      act3d_wg_run_bytes((size_t)kWgRows * H * 4);
  return 128 + kWgStages * stage + once;
}

// The row tiles come as records (act3d_prep_kernel), staged by one bulk copy
// and read in place; every warp releases a stage after its tile.
template <int DP, bool MASK, bool DROPOUT>
__global__ void __launch_bounds__(128 * act3d_wg_max_group(DP), 1)
mha_bwd_dkdv_bf16_wgmma_kernel(const WgBwdArgs a) {
  constexpr int NK = kWgKeyRows;
  constexpr int RT = kWgRows;
  constexpr int KS = DP / 16;
  extern __shared__ __align__(128) char smem_raw[];
  const int E = a.H * a.d;
  const int G = a.G;
  const int b = blockIdx.z;
  const int hg = blockIdx.y;
  const int tile = blockIdx.x % a.key_tiles;
  const int split = blockIdx.x / a.key_tiles;
  const int k0 = tile * NK;
  const int nk = min(NK, a.S - k0);
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.L, r_begin + a.rows_per_split);
  const int n_tiles = (r_end - r_begin + RT - 1) / RT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  Act3dCarve cv{smem_raw};
  uint64_t* full = cv.take<uint64_t>(128);
  uint64_t* empty = full + kWgStages;
  uint64_t* kvbar = full + 2 * kWgStages;
  const size_t kv_run = act3d_wg_run_bytes((size_t)NK * E * 2);
  char* k_raw = cv.take<char>(kv_run);
  char* v_raw = cv.take<char>(kv_run);
  char* m_raw = cv.take<char>(act3d_wg_run_bytes(NK));
  const size_t rrec = act3d_record_bytes(kRows, DP);
  const size_t stage_bytes = G * rrec;
  char* stages = cv.take<char>(kWgStages * stage_bytes);
  unsigned* released = reinterpret_cast<unsigned*>(full) + 20;  // bytes 80-95
  const int arrivals = 4 * G;  // releases of a stage: every warp's
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      act3d_mbar_init(&full[i], 32);
      act3d_mbar_init(&empty[i], arrivals);
      released[i] = 0u;
    }
    act3d_mbar_init(kvbar, 32);
    act3d_mbar_init_fence();
  }
  __syncthreads();

  const size_t koff = ((size_t)b * a.S + k0) * E;
  // warp 0 stages K, V and the first row tiles; each later stage is
  // refilled by the warpgroup that releases it last
  const bool stager = warp == 0;
  auto stage_tile = [&](int it) {  // the group's records: one contiguous run
    const int i0 = r_begin + it * RT;
    char* base = stages + (it % kWgStages) * stage_bytes;
    const size_t tiles = (a.L + RT - 1) / RT;
    const char* rec = a.rowrec + (((size_t)b * tiles + i0 / RT) * a.H + hg * G) * rrec;
    const Act3dRun runs[1] = {{base, rec, (uint32_t)(G * rrec), a.rowrec,
                               a.rowrec + (size_t)a.B * tiles * a.H * rrec}};
    act3d_stage_runs(runs, &full[it % kWgStages], lane);
  };
  if (stager) {
    const size_t bs = (size_t)a.B * a.S;
    const Act3dRun kv[3] = {
        {k_raw, a.k + koff, (uint32_t)(nk * E * 2), a.k, a.k + bs * E},
        {v_raw, a.v + koff, (uint32_t)(nk * E * 2), a.v, a.v + bs * E},
        {m_raw, a.mask + (size_t)b * a.S + k0, MASK ? (uint32_t)nk : 0u, a.mask, a.mask + bs}};
    act3d_stage_runs(kv, kvbar, lane);
    for (int it = 0; it < n_tiles && it < kWgStages; ++it) stage_tile(it);
  }

  // warpgroup wg: head h, keys k0 + 16 * wl + g (+ 8)
  const int h = hg * G + wg;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float inv_keep = DROPOUT ? a.drop.inv_keep : 1.f;

  act3d_mbar_wait(kvbar, 0);
  const uint16_t* ks = act3d_run_at<uint16_t>(k_raw, a.k + koff) + h * a.d;
  const uint16_t* vs = act3d_run_at<uint16_t>(v_raw, a.v + koff) + h * a.d;
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    act3d_wg_load_a(ka[kk], ks, E, nk, a.d, 16 * wl, 16 * kk, g, t);
    act3d_wg_load_a(va[kk], vs, E, nk, a.d, 16 * wl, 16 * kk, g, t);
  }
  const int key_l[2] = {16 * wl + g, 16 * wl + g + 8};
  bool key_live[2], key_masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_live[r] = key_l[r] < nk;
    key_masked[r] = MASK && key_live[r] &&
                    act3d_run_at<uint8_t>(m_raw, a.mask + (size_t)b * a.S + k0)[key_l[r]];
  }
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const int i0 = r_begin + it * RT;
    const int n = min(RT, r_end - i0);
    act3d_mbar_wait(&full[st], (it / kWgStages) & 1);
    // this head's record: q, dO, qf^T, dof^T, then per column (query row i
    // of the tile) m log2 e, m, delta and the row key; rows past the tile:
    // m = +inf (ex = 0), delta 0
    const uint16_t* qop =
        reinterpret_cast<const uint16_t*>(stages + st * stage_bytes + wg * rrec);
    const uint16_t* oop = qop + 64 * DP;
    const uint16_t* qfop = oop + 64 * DP;
    const uint16_t* ofop = qfop + 64 * DP;
    const float* cm2 = reinterpret_cast<const float*>(ofop + 64 * DP);
    const float* cm = cm2 + RT;
    const float* cdl = cm + RT;
    const uint32_t* crk = reinterpret_cast<const uint32_t*>(cdl + RT);

    float sT[RT / 2], dpT[RT / 2];
    act3d_wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      act3d_wgmma_rs_n64(sT, ka[kk], act3d_wg_desc(qop + kk * 128, DP * 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      act3d_wgmma_rs_n64(dpT, va[kk], act3d_wg_desc(oop + kk * 128, DP * 16), kk > 0);
    }
    act3d_wg_commit();
    act3d_wg_wait<0>();
    act3d_reg_fence(sT);
    act3d_reg_fence(dpT);

    // element 4i + e: key g (e < 2) or g + 8, query row 8i + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < RT / 8; ++i) {
      const int c0 = 8 * i + 2 * t;
      const float2 m2 = *reinterpret_cast<const float2*>(cm2 + c0);
      const float2 mn = *reinterpret_cast<const float2*>(cm + c0);
      const float2 dl = *reinterpret_cast<const float2*>(cdl + c0);
      uint2 rk = make_uint2(0u, 0u);
      if (DROPOUT) rk = *reinterpret_cast<const uint2*>(crk + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool odd = e & 1;
        float ex = 0.f;
        if (key_live[r]) {
          // a masked key scores -1e30: (s - m) first, so that a fully
          // masked row (m = -1e30) gets exp(0) exactly; elsewhere one FFMA
          ex = (MASK && key_masked[r])
                   ? act3d_ex2((kMaskedScore - (odd ? mn.y : mn.x)) * kLog2e)
                   : act3d_ex2(fmaf(sT[4 * i + e], kLog2e, -(odd ? m2.y : m2.x)));
        }
        float dp = dpT[4 * i + e];
        float kept = ex;
        if (DROPOUT) {
          const bool keep = act3d_dropout_keep(odd ? rk.y : rk.x, k0 + key_l[r],
                                               a.drop.threshold);
          kept = keep ? ex : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        sT[4 * i + e] = kept;
        dpT[4 * i + e] = ex * (dp - (odd ? dl.y : dl.x));
      }
    }
    uint32_t pa[RT / 16][4], da[RT / 16][4];  // rounded to bf16 here
#pragma unroll
    for (int kt = 0; kt < RT / 16; ++kt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pa[kt][u] = act3d_pack_bf16(sT[8 * kt + 2 * u], sT[8 * kt + 2 * u + 1]);
        da[kt][u] = act3d_pack_bf16(dpT[8 * kt + 2 * u], dpT[8 * kt + 2 * u + 1]);
      }
    }
#pragma unroll
    for (int kt = 0; kt < RT / 16; ++kt) {  // dv and dk on mma.sync
      if (16 * kt < n) {
        act3d_mma_rs<DP, RT>(dva, pa[kt], ofop, 16 * kt, g, t);
        act3d_mma_rs<DP, RT>(dka, da[kt], qfop, 16 * kt, g, t);
      }
    }
    // this warp's reads of the stage are done
    act3d_release_stage(&empty[st], &released[st], arrivals, it / kWgStages, it + kWgStages,
                        n_tiles, lane, stage_tile);
  }

  const size_t bse = (size_t)a.B * a.S * E;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_live[r]) continue;
    const size_t off = ((size_t)b * a.S + k0 + key_l[r]) * E + h * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 8 * j + 2 * t + u;
        if (c >= a.d) continue;
        const float x = dka[4 * j + 2 * r + u], y = dva[4 * j + 2 * r + u];
        if (a.dkv_parts) {
          a.dkv_parts[split * bse + off + c] = x;
          a.dkv_parts[(a.nsplit + split) * bse + off + c] = y;
        } else {
          a.dk[off + c] = act3d_to_bf16(x);
          a.dv[off + c] = act3d_to_bf16(y);
        }
      }
    }
  }
}

// The key tiles come as records (act3d_prep_kernel), staged by bulk copies
// and read in place; every warp releases a stage after its tile.
template <int DP, bool MASK, bool DROPOUT>
__global__ void __launch_bounds__(128 * act3d_wg_max_group(DP), 1)
mha_bwd_dq_bf16_wgmma_kernel(const WgBwdArgs a) {
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
  const int c_begin = split * a.dq_chunk;
  const int c_end = min(a.S, c_begin + a.dq_chunk);
  const int n_tiles = (c_end - c_begin + NK - 1) / NK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  Act3dCarve cv{smem_raw};
  uint64_t* full = cv.take<uint64_t>(128);
  uint64_t* empty = full + kWgStages;
  uint64_t* obar = full + 2 * kWgStages;
  int& last_block = reinterpret_cast<int*>(full)[31];  // past the barriers
  const size_t op_bytes = act3d_op_bytes(DP);
  const size_t krec = act3d_record_bytes(kDqKeys, DP);  // K, V, K^T
  const size_t mask_at = G * krec;                      // the records, then the mask bytes
  const size_t stage_bytes = mask_at + act3d_wg_run_bytes(NK);
  char* stages = cv.take<char>(kWgStages * stage_bytes);
  const size_t row_run = act3d_wg_run_bytes((size_t)kWgRows * E * 2);
  char* q_raw = cv.take<char>(row_run);
  char* o_raw = cv.take<char>(row_run);
  char* s_raw = cv.take<char>(act3d_wg_run_bytes((size_t)kWgRows * 2 * a.H * 4));
  char* d_raw = cv.take<char>(act3d_wg_run_bytes((size_t)kWgRows * a.H * 4));
  unsigned* released = reinterpret_cast<unsigned*>(full) + 20;  // bytes 80-95
  const int arrivals = 4 * G;  // releases of a stage: every warp's
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      act3d_mbar_init(&full[i], 32);
      act3d_mbar_init(&empty[i], arrivals);
      released[i] = 0u;
    }
    act3d_mbar_init(obar, 32);
    act3d_mbar_init_fence();
  }
  __syncthreads();

  const size_t row0 = (size_t)b * a.L + r0;
  // warp 0 stages the row tile and the first key tiles; each later stage
  // is refilled by the warpgroup that releases it last
  const bool stager = warp == 0;
  auto stage_tile = [&](int it) {
    const int k0 = c_begin + it * NK;
    const int n = min(NK, c_end - k0);
    char* base = stages + (it % kWgStages) * stage_bytes;
    const size_t bs = (size_t)a.B * a.S;
    // the group's records (K, V, K^T each): one contiguous run
    const int tiles = (a.S + NK - 1) / NK;
    const char* rec = a.keyrec + (((size_t)b * tiles + k0 / NK) * a.H + hg * G) * krec;
    const Act3dRun runs[2] = {
        {base, rec, (uint32_t)(G * krec), a.keyrec, a.keyrec + (size_t)a.B * tiles * a.H * krec},
        {base + mask_at, a.mask + (size_t)b * a.S + k0, MASK ? (uint32_t)n : 0u, a.mask,
         a.mask + bs}};
    act3d_stage_runs(runs, &full[it % kWgStages], lane);
  };
  if (stager) {
    const size_t bl = (size_t)a.B * a.L;
    const Act3dRun once[4] = {
        {q_raw, a.q + row0 * E, (uint32_t)(nr * E * 2), a.q, a.q + bl * E},
        {o_raw, a.dout + row0 * E, (uint32_t)(nr * E * 2), a.dout, a.dout + bl * E},
        {s_raw, a.stats + row0 * 2 * a.H, (uint32_t)(nr * 2 * a.H * 4), a.stats,
         a.stats + bl * 2 * a.H},
        {d_raw, a.delta + row0 * a.H, (uint32_t)(nr * a.H * 4), a.delta, a.delta + bl * a.H}};
    act3d_stage_runs(once, obar, lane);
    for (int it = 0; it < n_tiles && it < kWgStages; ++it) stage_tile(it);
  }

  // warpgroup wg: head h, rows r0 + 16 * wl + g (+ 8)
  const int h = hg * G + wg;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float inv_keep = DROPOUT ? a.drop.inv_keep : 1.f;

  act3d_mbar_wait(obar, 0);
  const uint16_t* qs = act3d_run_at<uint16_t>(q_raw, a.q + row0 * E) + h * a.d;
  const uint16_t* os = act3d_run_at<uint16_t>(o_raw, a.dout + row0 * E) + h * a.d;
  const float* sr = act3d_run_at<float>(s_raw, a.stats + row0 * 2 * a.H);
  const float* dr = act3d_run_at<float>(d_raw, a.delta + row0 * a.H);
  uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    act3d_wg_load_a(qa[kk], qs, E, nr, a.d, 16 * wl, 16 * kk, g, t);
    act3d_wg_load_a(oa[kk], os, E, nr, a.d, 16 * wl, 16 * kk, g, t);
  }
  // rows g and g + 8: m (+inf past the tile: ex = 0), m log2 e, delta, r, row key
  float m[2], m2[2], dl[2], rr[2];
  uint32_t rk[2];
  const uint32_t seed = DROPOUT ? act3d_dropout_seed(a.drop.seed, a.drop.slot) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * wl + g + 8 * r;
    m[r] = INFINITY;
    dl[r] = 0.f;
    rr[r] = 0.f;
    rk[r] = 0u;
    if (i < nr) {
      m[r] = sr[i * 2 * a.H + 2 * h];
      rr[r] = 1.f / sr[i * 2 * a.H + 2 * h + 1];
      dl[r] = dr[i * a.H + h];
      if (DROPOUT) rk[r] = act3d_dropout_row_key(seed, a.drop.b0 + b, h, r0 + i);
    }
    m2[r] = m[r] * kLog2e;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const int k0 = c_begin + it * NK;
    const int n = min(NK, c_end - k0);
    act3d_mbar_wait(&full[st], (it / kWgStages) & 1);
    const char* base = stages + st * stage_bytes;
    const uint16_t* kop = reinterpret_cast<const uint16_t*>(base + wg * krec);
    const uint16_t* vop = kop + 64 * DP;
    const uint16_t* ktop = vop + 64 * DP;
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
    float s[NK / 2], dp[NK / 2];
    act3d_wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      act3d_wgmma_rs_n64(s, qa[kk], act3d_wg_desc(kop + kk * 128, DP * 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      act3d_wgmma_rs_n64(dp, oa[kk], act3d_wg_desc(vop + kk * 128, DP * 16), kk > 0);
    }
    act3d_wg_commit();
    act3d_wg_wait<0>();
    act3d_reg_fence(s);
    act3d_reg_fence(dp);

    // element 4i + e: row g (e < 2) or g + 8, key 8i + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = 8 * i + 2 * t + (e & 1);
        float ex = 0.f;
        if (col < n) {
          ex = (MASK && ((mbits >> (2 * i + (e & 1))) & 1u))
                   ? act3d_ex2((kMaskedScore - m[r]) * kLog2e)
                   : act3d_ex2(fmaf(s[4 * i + e], kLog2e, -m2[r]));
        }
        float dpv = dp[4 * i + e];
        if (DROPOUT) {
          dpv = act3d_dropout_keep(rk[r], k0 + col, a.drop.threshold) ? dpv * inv_keep : 0.f;
        }
        s[4 * i + e] = ex * (dpv - dl[r]);
      }
    }
    uint32_t da[NK / 16][4];  // ds rounded to bf16
#pragma unroll
    for (int kt = 0; kt < NK / 16; ++kt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        da[kt][u] = act3d_pack_bf16(s[8 * kt + 2 * u], s[8 * kt + 2 * u + 1]);
      }
    }
#pragma unroll
    for (int kt = 0; kt < NK / 16; ++kt) {  // dq on mma.sync, B from the K^T tile
      if (16 * kt < n) act3d_mma_rs<DP, NK>(acc, da[kt], ktop, 16 * kt, g, t);
    }
    // this warp's reads of the stage are done
    act3d_release_stage(&empty[st], &released[st], arrivals, it / kWgStages, it + kWgStages,
                        n_tiles, lane, stage_tile);
  }

  const size_t bl_n = (size_t)a.B * a.L;
  if (a.dq_nsplit == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * wl + g + 8 * r;
      if (i >= nr) continue;
      uint16_t* dst = a.dq + (row0 + i) * E + h * a.d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < a.d) dst[c] = act3d_to_bf16(acc[4 * j + 2 * r] * rr[r]);
        if (c + 1 < a.d) dst[c + 1] = act3d_to_bf16(acc[4 * j + 2 * r + 1] * rr[r]);
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * wl + g + 8 * r;
    if (i >= nr) continue;
    float* dst = a.dq_part + (split * bl_n + row0 + i) * E + h * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < a.d) dst[c] = acc[4 * j + 2 * r];
      if (c + 1 < a.d) dst[c + 1] = acc[4 * j + 2 * r + 1];
    }
  }
  __threadfence();
  act3d_named_bar(8, 128 * G);
  if (threadIdx.x == 0) {
    const int unit = (b * gridDim.y + hg) * a.q_tiles + tile;
    last_block = atomicAdd(&a.counters[unit], 1) == a.dq_nsplit - 1;
  }
  act3d_named_bar(8, 128 * G);
  if (!last_block) return;
  __threadfence();
  const int gd = G * a.d;
  for (int idx = threadIdx.x; idx < nr * gd; idx += 128 * G) {
    const int i = idx / gd;
    const int hd = hg * G + (idx % gd) / a.d;
    const int c = idx % a.d;
    float x = 0.f;
    for (int sp = 0; sp < a.dq_nsplit; ++sp) {
      x += __ldcg(a.dq_part + (sp * bl_n + row0 + i) * E + hd * a.d + c);
    }
    a.dq[(row0 + i) * E + hd * a.d + c] =
        act3d_to_bf16(x * (1.f / a.stats[(row0 + i) * 2 * a.H + 2 * hd + 1]));
  }
}

template <typename Kernel>
cudaError_t wg_size(Kernel kernel, bool& sized) {
  if (sized) return cudaSuccess;  // the attribute is a ceiling: set it once
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  sized = err == cudaSuccess;
  return err;
}

template <int DP, bool MASK, bool DROPOUT>
cudaError_t launch_wg_dp(WgBwdArgs a, int group, int dq_group, cudaStream_t stream) {
  static bool sized_dkdv = false, sized_dq = false;
  auto dkdv = mha_bwd_dkdv_bf16_wgmma_kernel<DP, MASK, DROPOUT>;
  auto dq = mha_bwd_dq_bf16_wgmma_kernel<DP, MASK, DROPOUT>;
  cudaError_t err = wg_size(dkdv, sized_dkdv);
  if (err == cudaSuccess) err = wg_size(dq, sized_dq);
  if (err != cudaSuccess) return err;
  const int E = a.H * a.d;
  const Dropout& dr = a.drop;
  const Act3dPrepArgs rows{a.q, a.dout, a.stats, a.delta, const_cast<char*>(a.rowrec), a.B,
                           a.L, a.H, a.d, (a.L + kWgRows - 1) / kWgRows, dr.seed, dr.b0,
                           DROPOUT ? 1u : 0u, DROPOUT ? dr.inv_keep : 1.f, dr.slot};
  err = act3d_prep<DP, kRows>(rows, stream);
  if (err != cudaSuccess) return err;
  const Act3dPrepArgs keys{a.k, a.v, nullptr, nullptr, const_cast<char*>(a.keyrec), a.B, a.S,
                           a.H, a.d, (a.S + kWgKeys - 1) / kWgKeys, 0u, 0u, 0u, 1.f};
  err = act3d_prep<DP, kDqKeys>(keys, stream);
  if (err != cudaSuccess) return err;
  a.G = group;
  dkdv<<<dim3(a.key_tiles * a.nsplit, a.H / group, a.B), 128 * group,
         wg_dkdv_smem(E, DP, group), stream>>>(a);
  if (a.nsplit > 1) {
    const size_t bse = (size_t)a.B * a.S * E;
    sum_slabs<uint16_t>(a.dkv_parts, a.dk, a.dkv_parts + a.nsplit * bse, a.dv, bse, a.nsplit,
                        stream);
  }
  if (a.dq_nsplit > 1) {
    const size_t units = (size_t)a.q_tiles * (a.H / dq_group) * a.B;
    err = cudaMemsetAsync(a.counters, 0, units * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  a.G = dq_group;
  dq<<<dim3(a.q_tiles * a.dq_nsplit, a.H / dq_group, a.B), 128 * dq_group,
       wg_dq_smem(E, a.H, DP, dq_group), stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wg(const WgBwdArgs& a, int group, int dq_group, bool masked, bool dropout,
                      cudaStream_t stream) {
  if (dropout) {
    return masked ? launch_wg_dp<DP, true, true>(a, group, dq_group, stream)
                  : launch_wg_dp<DP, false, true>(a, group, dq_group, stream);
  }
  return masked ? launch_wg_dp<DP, true, false>(a, group, dq_group, stream)
                : launch_wg_dp<DP, false, false>(a, group, dq_group, stream);
}

bool bad_args(int B, int L, int S, int H, int d, int key_warps, int rows_per_split,
              int nsplit, const void* work) {
  const bool warps_ok =
      key_warps == 1 || key_warps == 2 || key_warps == 4 || key_warps == 8;
  const int key_tiles = warps_ok ? (S + 16 * key_warps - 1) / (16 * key_warps) : 0;
  return B < 1 || L < 1 || S < 1 || H < 1 || H > 65535 || B > 65535 || d < 1 || d > 64 ||
         !warps_ok || rows_per_split < 1 || nsplit < 1 ||
         (long long)(nsplit - 1) * rows_per_split >= L ||
         (long long)nsplit * rows_per_split < L ||
         ((key_tiles > 1 || nsplit > 1) && work == nullptr);
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous float32 tensors (mask: bytes, may be null).  The launch plan
// comes from the wrapper (kernels/attention.py::bwd_plan): `key_warps`
// (1, 2, 4 or 8) warps of 16 keys per block, so key_tiles =
// ceil(S / (16 * key_warps)); L cut into nsplit = ceil(L / rows_per_split)
// splits.  `work` holds, in this order, key_tiles * B*L*E floats of dq
// slabs when key_tiles > 1 and 2 * nsplit * B*S*E floats of dk, dv slabs
// when nsplit > 1 (may be null when neither).  dropout != 0 selects the
// dropout instantiations, with the keep threshold, 1/(1-rate) and the
// batch offset b0 computed on the host, and the seed: `seed`, or, where
// `seed_slot` is not null, the uint32 word it points to in device memory
// (as act3d_fused_mha_fwd_f32).  Returns cudaGetLastError() after the launches (0 =
// success).
extern "C" int act3d_fused_mha_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, const void* delta, const void* mask, void* dq,
    void* dk, void* dv, void* work, int B, int L, int S, int H, int d,
    int key_warps, int rows_per_split, int nsplit, int dropout, unsigned int seed,
    const void* seed_slot, unsigned int threshold, float inv_keep, unsigned int b0,
    void* stream) {
  if (bad_args(B, L, S, H, d, key_warps, rows_per_split, nsplit, work)) {
    return (int)cudaErrorInvalidValue;
  }
  const int dp = d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 64;
  if (smem_bytes(dp, key_warps, row_tile(rows_per_split)) > kMaxSmem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const Dropout drop{seed, threshold, inv_keep, b0, static_cast<const uint32_t*>(seed_slot)};
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
  const bool dr = dropout != 0;
  cudaError_t err;
  switch (dp) {
    case 8:
      err = launch<8>(dr, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf, B, L, S, H, d,
                      key_warps, rows_per_split, nsplit, drop, st);
      break;
    case 16:
      err = launch<16>(dr, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf, B, L, S, H, d,
                       key_warps, rows_per_split, nsplit, drop, st);
      break;
    case 32:
      err = launch<32>(dr, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf, B, L, S, H, d,
                       key_warps, rows_per_split, nsplit, drop, st);
      break;
    default:
      err = launch<64>(dr, qf, kf, vf, of, sf, lf, mf, dqf, dkf, dvf, wf, B, L, S, H, d,
                       key_warps, rows_per_split, nsplit, drop, st);
  }
  return (int)err;
}

// The bf16 entry: the float32 entry's interface with q, k, v, dout, dq,
// dk and dv bf16 tensors (stats, delta and work float32), and four more
// ints after `dropout`, which pick the body.  group = 0: the mma.sync body
// above with the float32 entry's plan (d padded to 16, 32 or 64), for
// L <= 64 and d > 32.  group >= 1: the two wgmma passes (d <= 32).  dk/dv: `group` heads per
// block, ceil(S / 64) key tiles, L cut into nsplit = ceil(L /
// rows_per_split) splits (key_warps unused).  dq: `dq_group` heads per
// block, ceil(L / 64) query tiles, the keys in dq_nsplit chunks of dq_chunk
// keys.  Groups are 1, 2 or 4, at most 64 / DP, and divide H.  `work`
// holds 2 * nsplit * B*S*E floats of dk, dv slabs when nsplit > 1, then
// dq_nsplit * B*L*E floats of dq partials and q_tiles * (H / dq_group) * B
// int counters (zeroed here) when dq_nsplit > 1.  Prep kernels first write
// the row records (act3d_record_bytes(kRows, DP) bytes per head and 64-row
// tile) for the dk/dv pass and the key records (K, V, K^T:
// act3d_record_bytes(kDqKeys, DP) per head and 64-key tile) for the dq pass
// to the start of `work`, in that order, the slabs and partials following
// them.
extern "C" int act3d_fused_mha_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, const void* delta, const void* mask, void* dq,
    void* dk, void* dv, void* work, int B, int L, int S, int H, int d,
    int key_warps, int rows_per_split, int nsplit, int dropout, int group, int dq_group,
    int dq_chunk, int dq_nsplit, unsigned int seed, const void* seed_slot,
    unsigned int threshold, float inv_keep, unsigned int b0, void* stream) {
  const Dropout drop{seed, threshold, inv_keep, b0, static_cast<const uint32_t*>(seed_slot)};
  const uint16_t* qh = static_cast<const uint16_t*>(q);
  const uint16_t* kh = static_cast<const uint16_t*>(k);
  const uint16_t* vh = static_cast<const uint16_t*>(v);
  const uint16_t* oh = static_cast<const uint16_t*>(dout);
  const float* sf = static_cast<const float*>(stats);
  const float* lf = static_cast<const float*>(delta);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  uint16_t* dqh = static_cast<uint16_t*>(dq);
  uint16_t* dkh = static_cast<uint16_t*>(dk);
  uint16_t* dvh = static_cast<uint16_t*>(dv);
  float* wf = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dr = dropout != 0;
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : 64;
  if (group != 0) {
    auto group_ok = [&](int gr) {
      return (gr == 1 || gr == 2 || gr == 4) && dp <= 32 && gr <= act3d_wg_max_group(dp) &&
             H % gr == 0;
    };
    const int E = H * d;
    if (B < 1 || L < 1 || S < 1 || H < 1 || B > 65535 || d < 1 || d > 64 || !group_ok(group) ||
        !group_ok(dq_group) || rows_per_split < 1 || nsplit < 1 ||
        (long long)(nsplit - 1) * rows_per_split >= L || (long long)nsplit * rows_per_split < L ||
        dq_chunk < 1 || dq_nsplit < 1 || (long long)(dq_nsplit - 1) * dq_chunk >= S ||
        (long long)dq_nsplit * dq_chunk < S ||
        !work || (nsplit > 1 && rows_per_split % kWgRows != 0) ||
        (dq_nsplit > 1 && dq_chunk % kWgKeys != 0) || wg_dkdv_smem(E, dp, group) > kMaxSmem ||
        wg_dq_smem(E, H, dp, dq_group) > kMaxSmem) {
      return (int)cudaErrorInvalidValue;
    }
    WgBwdArgs a{qh, kh, vh, oh, sf, lf, mf, dqh, dkh, dvh, nullptr, nullptr, nullptr, nullptr,
                nullptr, B, L, S, H, d, group, (S + kWgKeyRows - 1) / kWgKeyRows,
                rows_per_split, nsplit, (L + kWgRows - 1) / kWgRows, dq_chunk, dq_nsplit, drop};
    float* w = wf;
    a.rowrec = reinterpret_cast<const char*>(w);
    w += (size_t)B * a.q_tiles * H * act3d_record_bytes(kRows, dp) / 4;
    a.keyrec = reinterpret_cast<const char*>(w);
    w += (size_t)B * ((S + kWgKeys - 1) / kWgKeys) * H * act3d_record_bytes(kDqKeys, dp) / 4;
    if (nsplit > 1) {
      a.dkv_parts = w;
      w += (size_t)2 * nsplit * B * S * E;
    }
    if (dq_nsplit > 1) {
      a.dq_part = w;
      a.counters = reinterpret_cast<int*>(w + (size_t)dq_nsplit * B * L * E);
    }
    const cudaError_t err =
        dp == 16 ? launch_wg<16>(a, group, dq_group, mf != nullptr, dr, st)
                 : launch_wg<32>(a, group, dq_group, mf != nullptr, dr, st);
    return (int)err;
  }
  if (bad_args(B, L, S, H, d, key_warps, rows_per_split, nsplit, work)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes_bf16(dp, key_warps, row_tile(rows_per_split)) > kMaxSmem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err;
  switch (dp) {
    case 16:
      err = launch_bf16<16>(dr, qh, kh, vh, oh, sf, lf, mf, dqh, dkh, dvh, wf, B, L, S, H,
                            d, key_warps, rows_per_split, nsplit, drop, st);
      break;
    case 32:
      err = launch_bf16<32>(dr, qh, kh, vh, oh, sf, lf, mf, dqh, dkh, dvh, wf, B, L, S, H,
                            d, key_warps, rows_per_split, nsplit, drop, st);
      break;
    default:
      err = launch_bf16<64>(dr, qh, kh, vh, oh, sf, lf, mf, dqh, dkh, dvh, wf, B, L, S, H,
                            d, key_warps, rows_per_split, nsplit, drop, st);
  }
  return (int)err;
}
