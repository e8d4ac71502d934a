// Row-gather adjoint for unique indices, float32 and bf16, for Hopper (sm_90a).
//
// Replaces three TPU kernels of act3d_tpu/kernels/gather.py:
//   * onehot_scatter_rows_sorted (unique, ascending indices: the VJP of
//     gather_tokens(..., sorted_indices=True), Act3D's fine-context gather);
//   * onehot_scatter_rows (unique indices in any order);
//   * onehot_scatter_rows_chunked (the sorted function again, with the
//     tiles of one batch row split into n_chunks runs on the TPU's grid).
// Same contract:
//   g (B, K, C) float32, unit stride along C, any batch and row strides;
//   idx (B, K) int64, unique per batch row, in [0, P);
//   out (B, P, C) contiguous, out[b, p, :] = g[b, j, :] where idx[b, j] == p,
//   and 0 where no j picks p.
// Each output row is one copy (or zeros), so the result is exact and the
// same from run to run.
//
// What bounds it on the H100: bytes.  The function writes B*P*C floats and
// reads B*K*C floats and B*K indices; there is no arithmetic.  At the Act3D
// fine levels (B=16, K=3072, C=60, P=49152) that is 188.7 MB written plus
// 12.2 MB read = 200.9 MB, 60 us at 3.35 TB/s.  The TPU kernel spent MXU
// work on a one-hot (P-tile x window) product to avoid the TPU's slow
// gather unit; here a row copy is the cheapest form, so the design only has
// to write each output byte once, coalesced.
//
// Design:
//   * gather form: one block writes whole tiles of output rows of one batch
//     row; it writes every row of a tile exactly once, the matching g row
//     or zeros.  No zero-fill pass, no atomics.
//   * sorted body (the sorted function, so also the chunked one): one block
//     per tile of kTile = 128 rows, grid (ceil(P / kTile), B): 6144 blocks of
//     8 warps at the Act3D shape, so every SM holds blocks from the first
//     wave to the last.  Unique ascending indices put every hit of a tile
//     [p0, p0 + rows) in one contiguous window [j_lo, j_hi) of idx[b],
//     found by two warps at once, one bound each, in a 32-way search (each
//     round one load per lane and a ballot: 3 rounds for K = 3072, where a
//     single thread's binary search waits on 12 dependent loads); the
//     other warps zero the slot table meanwhile.  The window's j + 1 go
//     into a slot table of kTile ints in shared memory.  No (B, P) buffer.
//   * the chunked function: p_tile and n_chunks split P into tiles and
//     chunks on the TPU (a sequential grid over VMEM-resident tiles, to
//     amortise the TPU's grid-step cost) and never change the result.  The
//     card has no such cost, so its grid does not follow them: the wrapper
//     (kernels/gather.py::scatter_rows_chunked) checks them as JAX's
//     contract and launches the sorted entry, grid (ceil(P / kTile), B),
//     where JAX's grid of (n_chunks, B) blocks gave 64 blocks for 132 SMs
//     at its defaults.  Rows >= P are never written.
//   * unsorted entry: JAX's slot map (act3d_tpu/ops/geometry.py:93-105):
//     a first kernel writes inv[b, idx[b, j]] = j + 1 into an int32 (B, P)
//     map zeroed by cudaMemsetAsync; one block per tile of kTile rows reads
//     its slots from inv.
//   * stores: a tile is one contiguous span of rows * C elements of out;
//     consecutive threads write consecutive words of 16 bytes where the
//     rows allow (C % 4 == 0 and 16-byte aligned float32 rows, e.g. C = 60
//     is 15 float4s), else of 8, 4 or 2 bytes.  One writer serves every
//     entry: each thread loads kUnroll g-row words before it stores any,
//     so it keeps kUnroll loads and stores in flight.
//   * bf16 (the *_bf16 entries, --mixed_precision 1): the same copies of
//     2-byte elements, bit-exact as at float32 (JAX's one-hot product
//     computes one copy per row too).  A C = 60 row is 120 bytes, no
//     multiple of 16, so the Act3D rows go in 8-byte words (4 bf16); the
//     bytes bound halves.
//   * an index outside a tile's range never lands in it, so indices that
//     break the precondition give a wrong result but no stray write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // output rows per block
constexpr int kUnroll = 4;  // g-row loads in flight per thread before its stores

// The first j in [0, n) with a[j] >= v (n if none), for ascending a, found
// by the 32 lanes of one warp together: each round every lane tests one of
// 32 evenly spaced probes and a ballot counts those below v, which cuts
// the span 32-fold.  Every lane returns the same value.
__device__ __forceinline__ int warp_lower_bound(const int64_t* a, int n, int64_t v, int lane) {
  int lo = 0;  // a[j] < v for every j < lo
  int hi = n;  // a[j] >= v for every j in [hi, n)
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int j = lo + (lane + 1) * step - 1;
    const bool below = j < hi && a[j] < v;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    hi = min(hi, lo + (c + 1) * step - 1);  // probe c is not below v
    lo += c * step;
  }
  return lo;
}

// Writes `rows` rows of cw words W at out_t, one contiguous span: row r is
// g row slot[r] - 1 (g_b's rows g_sj words apart), or zeros where slot[r]
// is 0.  A word is 2, 4, 8 or 16 bytes of a row copied as they are (a
// float4, 8 bf16, ...).  Consecutive threads take consecutive words, and
// each thread loads kUnroll of them before it stores any.
template <typename W>
__device__ __forceinline__ void write_rows(const int* slot, const W* __restrict__ g_b,
                                           int64_t g_sj, W* __restrict__ out_t, int rows,
                                           int cw) {
  const int n = rows * cw;
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kThreads) {
    W val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      val[u] = W{};
      if (i < n) {
        const int r = i / cw;
        const int s = slot[r];
        if (s) val[u] = __ldg(g_b + (size_t)(s - 1) * g_sj + (i - r * cw));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) out_t[i] = val[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
slot_map_kernel(const int64_t* __restrict__ idx, int* __restrict__ inv, int K, int64_t P) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= K) return;
  const int64_t p = idx[(size_t)b * K + j];
  if (p >= 0 && p < P) inv[(size_t)b * P + p] = j + 1;
}

// The unsorted body: block (x, b) writes rows [x * kTile, x * kTile + rows)
// of out[b] from the slot map inv.  Rows are cw words; strides in words.
template <typename W>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const W* __restrict__ g, const int* __restrict__ inv,
                    W* __restrict__ out, int64_t P, int cw, int64_t g_sb, int64_t g_sj) {
  __shared__ int slot_s[kTile];  // j + 1 of the g row that lands on tile row r; 0 = none
  const int b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, P - p0);
  const int* inv_t = inv + (size_t)b * P + p0;
  for (int r = threadIdx.x; r < kTile; r += kThreads) slot_s[r] = r < rows ? inv_t[r] : 0;
  __syncthreads();
  write_rows<W>(slot_s, g + (size_t)b * g_sb, g_sj, out + ((size_t)b * P + p0) * cw, rows,
                cw);
}

// The sorted body: block (x, b) writes the same rows, its slots found from
// the ascending idx[b].
template <typename W>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_kernel(const W* __restrict__ g, const int64_t* __restrict__ idx,
                      W* __restrict__ out, int K, int64_t P, int cw, int64_t g_sb,
                      int64_t g_sj) {
  __shared__ int slot_s[kTile];  // j + 1 of the g row that lands on tile row r; 0 = none
  __shared__ int window[2];
  const int b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, P - p0);
  const int64_t* idx_b = idx + (size_t)b * K;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0 finds j_lo, warp 1 j_hi
    const int lane = threadIdx.x & 31;
    const int w = warp_lower_bound(idx_b, K, warp ? p0 + rows : p0, lane);
    if (lane == 0) window[warp] = w;
  } else {
    for (int r = threadIdx.x - 64; r < kTile; r += kThreads - 64) slot_s[r] = 0;
  }
  __syncthreads();
  for (int j = window[0] + threadIdx.x; j < window[1]; j += kThreads) {
    const int64_t r = idx_b[j] - p0;
    if (r >= 0 && r < rows) slot_s[r] = j + 1;
  }
  __syncthreads();
  write_rows<W>(slot_s, g + (size_t)b * g_sb, g_sj, out + ((size_t)b * P + p0) * cw, rows,
                cw);
}

dim3 tile_grid(int B, int64_t P) { return dim3((unsigned)((P + kTile - 1) / kTile), B); }

bool bad_shape(int B, int K, int64_t P, int C) {
  return B < 1 || B > 65535 || K < 1 || P < 1 || C < 1 ||
         (P + kTile - 1) / kTile > 0x7fffffff || P * (int64_t)C > ((int64_t)1 << 40);
}

// Rows of `width`-byte words: the row (c_bytes) and the strides (bytes)
// in words.  The callers check that width divides each.
template <typename W>
cudaError_t launch_sorted(const void* g, const void* idx, void* out, int B, int K, int64_t P,
                          int64_t c_bytes, int64_t sb_bytes, int64_t sj_bytes,
                          cudaStream_t st) {
  constexpr int w = sizeof(W);
  scatter_sorted_kernel<W><<<tile_grid(B, P), kThreads, 0, st>>>(
      static_cast<const W*>(g), static_cast<const int64_t*>(idx), static_cast<W*>(out), K, P,
      (int)(c_bytes / w), sb_bytes / w, sj_bytes / w);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_unsorted(const void* g, const void* idx, int* inv, void* out, int B, int K,
                            int64_t P, int64_t c_bytes, int64_t sb_bytes, int64_t sj_bytes,
                            cudaStream_t st) {
  constexpr int w = sizeof(W);
  cudaError_t err = cudaMemsetAsync(inv, 0, (size_t)B * P * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const dim3 slot_grid((K + kThreads - 1) / kThreads, B);
  slot_map_kernel<<<slot_grid, kThreads, 0, st>>>(static_cast<const int64_t*>(idx), inv, K, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_rows_kernel<W><<<tile_grid(B, P), kThreads, 0, st>>>(
      static_cast<const W*>(g), inv, static_cast<W*>(out), P, (int)(c_bytes / w),
      sb_bytes / w, sj_bytes / w);
  return cudaGetLastError();
}

// One entry of either kind, its rows in `width`-byte words (2, 4, 8 or 16)
// of elements of `esize` bytes; g_sb / g_sj in elements.  Invalid when the
// width does not divide the row and both strides.
int scatter(bool sorted, const void* g, const void* idx, void* inv, void* out, int B, int K,
            int64_t P, int C, int esize, int64_t g_sb, int64_t g_sj, int width,
            void* stream) {
  const int64_t c_bytes = (int64_t)C * esize;
  const int64_t sb = g_sb * esize;
  const int64_t sj = g_sj * esize;
  if (bad_shape(B, K, P, C) || (width != 2 && width != 4 && width != 8 && width != 16) ||
      width < esize || c_bytes % width || sb % width || sj % width) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inv_i = static_cast<int*>(inv);
  cudaError_t err;
  switch (width) {
    case 2:
      err = sorted ? launch_sorted<uint16_t>(g, idx, out, B, K, P, c_bytes, sb, sj, st)
                   : launch_unsorted<uint16_t>(g, idx, inv_i, out, B, K, P, c_bytes, sb, sj,
                                               st);
      break;
    case 4:
      err = sorted ? launch_sorted<uint32_t>(g, idx, out, B, K, P, c_bytes, sb, sj, st)
                   : launch_unsorted<uint32_t>(g, idx, inv_i, out, B, K, P, c_bytes, sb, sj,
                                               st);
      break;
    case 8:
      err = sorted ? launch_sorted<uint2>(g, idx, out, B, K, P, c_bytes, sb, sj, st)
                   : launch_unsorted<uint2>(g, idx, inv_i, out, B, K, P, c_bytes, sb, sj, st);
      break;
    default:
      err = sorted ? launch_sorted<uint4>(g, idx, out, B, K, P, c_bytes, sb, sj, st)
                   : launch_unsorted<uint4>(g, idx, inv_i, out, B, K, P, c_bytes, sb, sj, st);
  }
  return (int)err;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; out is a
// contiguous (B, P, C) float32 tensor, idx a contiguous (B, K) int64 one;
// g_sb / g_sj are g's batch and row strides in floats (its C stride is 1).
// vec != 0 selects float4 accesses: the caller checks C % 4 == 0, a 16-byte
// aligned g and strides that are multiples of 4.  Returns the first CUDA
// error of the launches (0 = success).
extern "C" int act3d_scatter_rows_sorted_f32(const void* g, const void* idx, void* out,
                                             int B, int K, int64_t P, int C,
                                             int64_t g_sb, int64_t g_sj, int vec,
                                             void* stream) {
  return scatter(true, g, idx, nullptr, out, B, K, P, C, 4, g_sb, g_sj, vec ? 16 : 4,
                 stream);
}

// The unsorted entry also takes inv, an int32 (B, P) scratch buffer that it
// zeroes and fills itself.
extern "C" int act3d_scatter_rows_f32(const void* g, const void* idx, void* inv, void* out,
                                      int B, int K, int64_t P, int C, int64_t g_sb,
                                      int64_t g_sj, int vec, void* stream) {
  return scatter(false, g, idx, inv, out, B, K, P, C, 4, g_sb, g_sj, vec ? 16 : 4, stream);
}

// The bf16 entries: the same with g and out bf16 tensors, strides in bf16
// elements, and `width` the bytes of each access (2, 4, 8 or 16; the
// wrapper picks the widest that the rows and g's alignment allow: 8 at
// C = 60, whose 120-byte rows are no multiple of 16).
extern "C" int act3d_scatter_rows_sorted_bf16(const void* g, const void* idx, void* out,
                                              int B, int K, int64_t P, int C,
                                              int64_t g_sb, int64_t g_sj, int width,
                                              void* stream) {
  return scatter(true, g, idx, nullptr, out, B, K, P, C, 2, g_sb, g_sj, width, stream);
}

extern "C" int act3d_scatter_rows_bf16(const void* g, const void* idx, void* inv, void* out,
                                       int B, int K, int64_t P, int C, int64_t g_sb,
                                       int64_t g_sj, int width, void* stream) {
  return scatter(false, g, idx, inv, out, B, K, P, C, 2, g_sb, g_sj, width, stream);
}

// The grid and block of the row-writing kernel of every entry for (B, P):
// shape[0..3] = grid x, grid y, threads per block, output rows per block.
extern "C" void act3d_scatter_rows_launch_shape(int B, int64_t P, int64_t* shape) {
  const dim3 grid = tile_grid(B, P);
  shape[0] = grid.x;
  shape[1] = grid.y;
  shape[2] = kThreads;
  shape[3] = kTile;
}
