// Row-gather adjoint for unique indices, float32, for Hopper (sm_90a).
//
// Replaces two TPU kernels of act3d_tpu/kernels/gather.py:
//   * onehot_scatter_rows_sorted (unique, ascending indices: the VJP of
//     gather_tokens(..., sorted_indices=True), Act3D's fine-context gather);
//   * onehot_scatter_rows (unique indices in any order).
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
//   * gather form: one block per tile of kTile output rows of one batch
//     row; it writes every row of the tile exactly once, the matching g row
//     or zeros.  No zero-fill pass, no atomics.
//   * sorted entry: unique ascending indices put every hit of the tile
//     [p0, p0 + kTile) in one contiguous window [j_lo, j_hi) of idx[b],
//     found by two binary searches (two warps, one each); the window's
//     j + 1 are written into a shared slot table of the tile.  No (B, P)
//     buffer.
//   * unsorted entry: JAX's slot map (act3d_tpu/ops/geometry.py:93-105):
//     a first kernel writes inv[b, idx[b, j]] = j + 1 into an int32 (B, P)
//     map zeroed by cudaMemsetAsync; the tile pass reads its slots from inv.
//   * stores: the tile is one contiguous span of rows * C floats of out;
//     consecutive threads write consecutive 16-byte float4s (C % 4 == 0 and
//     16-byte aligned rows, e.g. C = 60 is 15 float4s), else floats.
//   * an index outside the tile's range never lands in it, so indices that
//     break the precondition give a wrong result but no stray write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // output rows per block

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

__global__ void __launch_bounds__(kThreads)
slot_map_kernel(const int64_t* __restrict__ idx, int* __restrict__ inv, int K, int64_t P) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= K) return;
  const int64_t p = idx[(size_t)b * K + j];
  if (p >= 0 && p < P) inv[(size_t)b * P + p] = j + 1;
}

template <bool SORTED, bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ g, const int64_t* __restrict__ idx,
                    const int* __restrict__ inv, float* __restrict__ out, int K,
                    int64_t P, int C, int64_t g_sb, int64_t g_sj) {
  __shared__ int slot_s[kTile];  // j + 1 of the g row that lands on tile row r; 0 = none
  __shared__ int window[2];
  const int b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int rows = (int)min((int64_t)kTile, P - p0);

  if (SORTED) {
    const int64_t* idx_b = idx + (size_t)b * K;
    if (threadIdx.x == 0) window[0] = lower_bound(idx_b, K, p0);
    if (threadIdx.x == 32) window[1] = lower_bound(idx_b, K, p0 + kTile);
    for (int r = threadIdx.x; r < kTile; r += kThreads) slot_s[r] = 0;
    __syncthreads();
    for (int j = window[0] + threadIdx.x; j < window[1]; j += kThreads) {
      const int64_t r = idx_b[j] - p0;
      if (r >= 0 && r < kTile) slot_s[r] = j + 1;
    }
  } else {
    const int* inv_t = inv + (size_t)b * P + p0;
    for (int r = threadIdx.x; r < kTile; r += kThreads) slot_s[r] = r < rows ? inv_t[r] : 0;
  }
  __syncthreads();

  const float* g_b = g + (size_t)b * g_sb;
  float* out_t = out + ((size_t)b * P + p0) * C;
  if (VEC) {
    const int c4 = C / 4;
    const int n = rows * c4;
    float4* out4 = reinterpret_cast<float4*>(out_t);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / c4;
      const int c = i - r * c4;
      const int s = slot_s[r];
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s) val = reinterpret_cast<const float4*>(g_b + (size_t)(s - 1) * g_sj)[c];
      out4[i] = val;
    }
  } else {
    const int n = rows * C;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      const int s = slot_s[r];
      out_t[i] = s ? g_b[(size_t)(s - 1) * g_sj + c] : 0.f;
    }
  }
}

template <bool SORTED>
void launch_tiles(const float* g, const int64_t* idx, const int* inv, float* out, int B,
                  int K, int64_t P, int C, int64_t g_sb, int64_t g_sj, int vec,
                  cudaStream_t stream) {
  const dim3 grid((unsigned)((P + kTile - 1) / kTile), B);
  if (vec) {
    scatter_rows_kernel<SORTED, true><<<grid, kThreads, 0, stream>>>(
        g, idx, inv, out, K, P, C, g_sb, g_sj);
  } else {
    scatter_rows_kernel<SORTED, false><<<grid, kThreads, 0, stream>>>(
        g, idx, inv, out, K, P, C, g_sb, g_sj);
  }
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
  launch_tiles<true>(static_cast<const float*>(g), static_cast<const int64_t*>(idx),
                     nullptr, static_cast<float*>(out), B, K, P, C, g_sb, g_sj, vec,
                     static_cast<cudaStream_t>(stream));
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
  launch_tiles<false>(static_cast<const float*>(g), static_cast<const int64_t*>(idx), inv_i,
                      static_cast<float*>(out), B, K, P, C, g_sb, g_sj, vec, st);
  return (int)cudaGetLastError();
}
