// Row-gather adjoint for unique indices, float32, for Hopper (sm_90a).
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
//   * stores: a tile is one contiguous span of rows * C floats of out;
//     consecutive threads write consecutive 16-byte float4s (C % 4 == 0 and
//     16-byte aligned rows, e.g. C = 60 is 15 float4s), else floats.  One
//     writer serves every entry: each thread loads kUnroll g-row elements
//     before it stores any, so it keeps kUnroll loads and stores in flight.
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

// Writes `rows` rows of C floats at out_t, one contiguous span: row r is g
// row slot[r] - 1 (g_b's rows g_sj floats apart), or zeros where slot[r] is
// 0.  Consecutive threads take consecutive elements (VEC false: floats;
// true: float4s), and each thread loads kUnroll of them before it stores
// any.
template <bool VEC>
__device__ __forceinline__ void write_rows(const int* slot, const float* __restrict__ g_b,
                                           int64_t g_sj, float* __restrict__ out_t, int rows,
                                           int C) {
  if (!VEC) {
    const int n = rows * C;
    for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kThreads) {
      float val[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        val[u] = 0.f;
        if (i < n) {
          const int r = i / C;
          const int s = slot[r];
          if (s) val[u] = __ldg(g_b + (size_t)(s - 1) * g_sj + (i - r * C));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) out_t[i] = val[u];
      }
    }
    return;
  }
  const int c4 = C >> 2;
  const int n = rows * c4;
  const float4* g4 = reinterpret_cast<const float4*>(g_b);
  const int64_t g_sj4 = g_sj >> 2;
  float4* out4 = reinterpret_cast<float4*>(out_t);
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kThreads) {
    float4 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n) {
        const int r = i / c4;
        const int s = slot[r];
        if (s) val[u] = __ldg(g4 + (size_t)(s - 1) * g_sj4 + (i - r * c4));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) out4[i] = val[u];
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
// of out[b] from the slot map inv.
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
  write_rows<VEC>(slot_s, g + (size_t)b * g_sb, g_sj, out + ((size_t)b * P + p0) * C, rows, C);
}

// The sorted body: block (x, b) writes the same rows, its slots found from
// the ascending idx[b].
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                      float* __restrict__ out, int K, int64_t P, int C, int64_t g_sb,
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
  write_rows<VEC>(slot_s, g + (size_t)b * g_sb, g_sj, out + ((size_t)b * P + p0) * C, rows, C);
}

dim3 tile_grid(int B, int64_t P) { return dim3((unsigned)((P + kTile - 1) / kTile), B); }

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
  auto kernel = vec ? scatter_sorted_kernel<true> : scatter_sorted_kernel<false>;
  kernel<<<tile_grid(B, P), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int64_t*>(idx), static_cast<float*>(out),
      K, P, C, g_sb, g_sj);
  return (int)cudaGetLastError();
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
  auto kernel = vec ? scatter_rows_kernel<true> : scatter_rows_kernel<false>;
  kernel<<<tile_grid(B, P), kThreads, 0, st>>>(static_cast<const float*>(g), inv_i,
                                              static_cast<float*>(out), P, C, g_sb, g_sj);
  return (int)cudaGetLastError();
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
