// Row-gather adjoint for unique indices, float32, for Hopper (sm_90a).
//
// Replaces three TPU kernels of act3d_tpu/kernels/gather.py:
//   * onehot_scatter_rows_sorted (unique, ascending indices: the VJP of
//     gather_tokens(..., sorted_indices=True), Act3D's fine-context gather);
//   * onehot_scatter_rows (unique indices in any order);
//   * onehot_scatter_rows_chunked (the sorted function again, with the
//     tiles of one batch row split into n_chunks runs walked in-kernel).
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
// Design (simple and correct first):
//   * gather form: one block writes whole tiles of output rows of one batch
//     row; it writes every row of a tile exactly once, the matching g row
//     or zeros.  No zero-fill pass, no atomics.
//   * sorted entries (sorted and chunked): unique ascending indices put
//     every hit of a tile [p0, p0 + p_tile) in one contiguous window
//     [j_lo, j_hi) of idx[b], found by two binary searches (two warps, one
//     each); the window's j + 1 are written into a slot table of p_tile
//     ints in dynamic shared memory.  No (B, P) buffer.  One kernel body
//     serves both: one block per (b, chunk) walks its n_inner tiles in
//     order.  The sorted entry launches it with p_tile = kTile and one tile
//     per block.  The chunked entry keeps the TPU kernel's split: grid
//     (B, n_chunks), each step looping over n_inner P-tiles of p_tile rows
//     (on the TPU against a VMEM-resident (K, C) cotangent, to amortise the
//     per-grid-step overhead).  The TPU's padding of P to p_tile * n_chunks
//     sets only which rows each chunk owns; rows >= P are never written.
//     There is no Mosaic tiling rule on the card, so every K, p_tile (up to
//     the shared memory of a block) and n_chunks is taken, with no fallback
//     to the sorted entry.  With few chunks the grid is small (B * n_chunks
//     blocks: 64 at JAX's default of 4 chunks and B = 16, for 132 SMs), so
//     that entry is no faster than the sorted one; it has no model path, in
//     JAX as here.
//   * unsorted entry: JAX's slot map (act3d_tpu/ops/geometry.py:93-105):
//     a first kernel writes inv[b, idx[b, j]] = j + 1 into an int32 (B, P)
//     map zeroed by cudaMemsetAsync; one block per tile of kTile rows reads
//     its slots from inv.
//   * stores: a tile is one contiguous span of rows * C floats of out;
//     consecutive threads write consecutive 16-byte float4s (C % 4 == 0 and
//     16-byte aligned rows, e.g. C = 60 is 15 float4s), else floats.
//   * an index outside a tile's range never lands in it, so indices that
//     break the precondition give a wrong result but no stray write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // output rows per block
constexpr int kMaxChunkedTile = 57344;  // p_tile ints in 224 KB of shared memory

__device__ __forceinline__ int lower_bound(const int64_t* a, int n, int64_t v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Writes `rows` rows of C floats at out_t, one contiguous span: row r is g
// row slot[r] - 1 (g_b's rows g_sj floats apart), or zeros where slot[r] is
// 0.  Consecutive threads store consecutive float4s when VEC.
template <bool VEC>
__device__ __forceinline__ void write_tile(const int* slot, const float* __restrict__ g_b,
                                           int64_t g_sj, float* __restrict__ out_t, int rows,
                                           int C) {
  if (VEC) {
    const int c4 = C / 4;
    const int n = rows * c4;
    float4* out4 = reinterpret_cast<float4*>(out_t);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / c4;
      const int c = i - r * c4;
      const int s = slot[r];
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s) val = reinterpret_cast<const float4*>(g_b + (size_t)(s - 1) * g_sj)[c];
      out4[i] = val;
    }
  } else {
    const int n = rows * C;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      const int s = slot[r];
      out_t[i] = s ? g_b[(size_t)(s - 1) * g_sj + c] : 0.f;
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

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ g, const int* __restrict__ inv,
                    float* __restrict__ out, int64_t P, int C, int64_t g_sb, int64_t g_sj) {
  __shared__ int slot_s[kTile];  // j + 1 of the g row that lands on tile row r; 0 = none
  const int b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, P - p0);
  const int* inv_t = inv + (size_t)b * P + p0;
  for (int r = threadIdx.x; r < kTile; r += kThreads) slot_s[r] = r < rows ? inv_t[r] : 0;
  __syncthreads();
  write_tile<VEC>(slot_s, g + (size_t)b * g_sb, g_sj, out + ((size_t)b * P + p0) * C, rows, C);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_chunked_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                            float* __restrict__ out, int K, int64_t P, int C, int64_t g_sb,
                            int64_t g_sj, int p_tile, int64_t n_inner) {
  extern __shared__ int chunk_slots[];  // [p_tile]
  __shared__ int window[2];
  const int b = blockIdx.y;
  const int64_t* idx_b = idx + (size_t)b * K;
  const float* g_b = g + (size_t)b * g_sb;
  for (int64_t t = (int64_t)blockIdx.x * n_inner; t < (int64_t)(blockIdx.x + 1) * n_inner;
       ++t) {
    const int64_t p0 = t * p_tile;
    if (p0 >= P) break;  // the padded tail of the last chunks
    const int rows = (int)min((int64_t)p_tile, P - p0);
    __syncthreads();  // the previous tile's slots and window are no longer read
    if (threadIdx.x == 0) window[0] = lower_bound(idx_b, K, p0);
    if (threadIdx.x == 32) window[1] = lower_bound(idx_b, K, p0 + p_tile);
    for (int r = threadIdx.x; r < rows; r += kThreads) chunk_slots[r] = 0;
    __syncthreads();
    for (int j = window[0] + threadIdx.x; j < window[1]; j += kThreads) {
      const int64_t r = idx_b[j] - p0;
      if (r >= 0 && r < rows) chunk_slots[r] = j + 1;
    }
    __syncthreads();
    write_tile<VEC>(chunk_slots, g_b, g_sj, out + ((size_t)b * P + p0) * C, rows, C);
  }
}

// Launches the sorted-index body on a (n_chunks, B) grid, each block
// walking n_inner = ceil(P / (p_tile * n_chunks)) tiles of p_tile rows.
int launch_chunked(const void* g, const void* idx, void* out, int B, int K, int64_t P, int C,
                   int64_t g_sb, int64_t g_sj, int vec, int p_tile, int n_chunks,
                   cudaStream_t stream) {
  const int64_t per_chunk = (int64_t)p_tile * n_chunks;
  const int64_t n_inner = (P + per_chunk - 1) / per_chunk;  // tiles per chunk
  const size_t smem = (size_t)p_tile * sizeof(int);
  auto kernel = vec ? scatter_rows_chunked_kernel<true> : scatter_rows_chunked_kernel<false>;
  if (smem > 48 * 1024) {  // above the default limit only by opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(n_chunks, B), kThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const int64_t*>(idx), static_cast<float*>(out),
      K, P, C, g_sb, g_sj, p_tile, n_inner);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int K, int64_t P, int C) {
  return B < 1 || B > 65535 || K < 1 || P < 1 || C < 1 ||
         (P + kTile - 1) / kTile > 0x7fffffff || P * (int64_t)C > ((int64_t)1 << 40);
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
  if (bad_shape(B, K, P, C)) return (int)cudaErrorInvalidValue;
  return launch_chunked(g, idx, out, B, K, P, C, g_sb, g_sj, vec, kTile,
                        (int)((P + kTile - 1) / kTile), static_cast<cudaStream_t>(stream));
}

// The unsorted entry also takes inv, an int32 (B, P) scratch buffer that it
// zeroes and fills itself.
extern "C" int act3d_scatter_rows_f32(const void* g, const void* idx, void* inv, void* out,
                                      int B, int K, int64_t P, int C, int64_t g_sb,
                                      int64_t g_sj, int vec, void* stream) {
  if (bad_shape(B, K, P, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inv_i = static_cast<int*>(inv);
  cudaError_t err = cudaMemsetAsync(inv_i, 0, (size_t)B * P * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 slot_grid((K + kThreads - 1) / kThreads, B);
  slot_map_kernel<<<slot_grid, kThreads, 0, st>>>(static_cast<const int64_t*>(idx), inv_i,
                                                   K, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P + kTile - 1) / kTile), B);
  if (vec) {
    scatter_rows_kernel<true><<<grid, kThreads, 0, st>>>(static_cast<const float*>(g), inv_i,
                                                          static_cast<float*>(out), P, C, g_sb,
                                                          g_sj);
  } else {
    scatter_rows_kernel<false><<<grid, kThreads, 0, st>>>(static_cast<const float*>(g), inv_i,
                                                           static_cast<float*>(out), P, C, g_sb,
                                                           g_sj);
  }
  return (int)cudaGetLastError();
}

// The chunked entry: the sorted entry's arguments plus p_tile (output rows
// per tile, at most kMaxChunkedTile) and n_chunks (blocks per batch row).
// P is split as the TPU kernel splits it: padded to a multiple of
// p_tile * n_chunks, each chunk owning n_tiles / n_chunks consecutive tiles.
extern "C" int act3d_scatter_rows_chunked_f32(const void* g, const void* idx, void* out,
                                              int B, int K, int64_t P, int C, int64_t g_sb,
                                              int64_t g_sj, int vec, int p_tile, int n_chunks,
                                              void* stream) {
  if (bad_shape(B, K, P, C) || p_tile < 1 || p_tile > kMaxChunkedTile || n_chunks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_chunked(g, idx, out, B, K, P, C, g_sb, g_sj, vec, p_tile, n_chunks,
                        static_cast<cudaStream_t>(stream));
}
