// Hopper machinery of the bf16 fused-MHA bodies (fused_mha_fwd.cu's forward,
// fused_mha_bwd.cu's dk/dv and dq passes): asynchronous bulk copies into a
// ring of shared-memory stages, completion on mbarriers, warpgroup matrix
// products (wgmma) with A in registers, exp2 on the special-function units.
// They replace the bf16 use of act3d_tpu/kernels/attention.py::_mha_fwd_body
// and _mha_bwd_body (see the two sources' headers).
//
// Staging.  A key tile of all heads, (keys x E) bf16, is one contiguous run
// of global memory, and so is a query tile (rows x E), a tile of the stats
// (rows x 2H float32) and of delta (rows x H).  One producer warp copies a
// run into a stage with one cp.async.bulk (1-D TMA, the async proxy) of its
// 16-byte-aligned middle, and its unaligned head and tail (under 16 bytes
// each) with 2-byte loads of 16 lanes.  The run lands at the stage's base +
// (address mod 16), so the bulk part keeps the 16-byte alignment the copy
// needs on both sides, whatever E is: a bf16 row of E = 60 is 120 bytes, so
// the rows of a (B, S, E) tensor start 8 bytes apart from 16-byte lines and a
// 2-D tensor map (16-byte strides) cannot describe it.  Where the run's
// 16-byte-aligned cover stays inside its tensor (all but a tensor's
// unaligned ends) one bulk copy moves the cover and no plain load is made.
// The staging warp is warp 0 of the block at the start and, later, warp 0
// of the warpgroup that releases a stage last.  The stage's full barrier
// counts the warp's 32 arrivals (each lane releases its own plain stores)
// and the bulk bytes (expect_tx); its empty barrier counts one arrival per
// warpgroup once it has re-laid the stage out, or, where the stage holds
// records read in place, one per warp once the warp is done with it.
//
// Operands.  A head's lane slice starts h * d elements into a row (30 h
// bytes at d = 15: not even 4-byte aligned for odd h), so a head's slice is
// re-laid (into records by act3d_prep_kernel, or, in the forward without
// records, by each consumer warpgroup once per stage) into wgmma's canonical
// K-major layout without swizzle: 8 x 8 core matrices of 16-byte rows, 128
// bytes each; a descriptor's leading byte offset (LBO, the next 8 k) is 128
// and its stride byte offset (SBO, the next 8 rows) is (k extent) * 16.  d is
// padded with zeros to DP = 16, 32 or 64 (one, two or four k16 steps), rows
// past the run are zeros.  The register A operand (64 rows, one warp per 16)
// has mma.sync m16n8k16's A layout, and so a float32 accumulator of two
// neighbouring 8-column blocks is the A operand of a product over those 16
// columns (mma_bf16.cuh's act3d_bf16_c_as_a): scores become the p v operand
// in registers.  The products whose N is the head dim (p v, dv, dk, dq: N =
// 16 at d = 15) run on mma.sync per warp (act3d_mma_rs), their B fragments
// read from the same core-matrix tiles: an A/B against wgmma m64n16k16
// chose it (PERF.md).
//
// Every wait on an mbarrier gives up after 10 s with a trap, so a fault in
// the byte counts ends the kernel with an error instead of hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

// stages of the ring; the A/B script builds 2 and 3
#ifndef ACT3D_WG_STAGES
#define ACT3D_WG_STAGES 4
#endif

constexpr int kWgKeys = 64;  // keys of a stage of the forward and the dq pass
constexpr int kWgRows = 64;  // query rows of a tile: wgmma's M
constexpr int kWgStages = ACT3D_WG_STAGES;
constexpr float kLog2e = 1.4426950408889634f;
// the first 128 bytes hold 2 * kWgStages + 1 barriers, kWgStages release
// counters from byte 80 and an int at byte 124
static_assert(kWgStages >= 2 && kWgStages <= 4, "the ring's depth");

// the most warpgroups (one head each) a block holds at head dim DP: the
// block has 128 * G + 32 threads and the accumulators of G heads
__host__ __device__ constexpr int act3d_wg_max_group(int dp) { return 64 / dp; }

__host__ __device__ constexpr size_t act3d_wg_align(size_t x) { return (x + 127) & ~(size_t)127; }

// shared bytes of a staged run of `bytes` bytes: 16 for the landing offset
__host__ __device__ constexpr size_t act3d_wg_run_bytes(size_t bytes) {
  return act3d_wg_align(bytes + 16);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ uint32_t act3d_smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void act3d_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(act3d_smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void act3d_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void act3d_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(act3d_smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void act3d_mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   act3d_smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t act3d_globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the completion of the phase of `bar` with parity `parity`.
__device__ __forceinline__ void act3d_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = act3d_smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t t = act3d_globaltimer();
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// ------------------------------------------------------- staged runs
__device__ __forceinline__ void act3d_bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(act3d_smem_u32(dst)), "l"(src), "r"(bytes), "r"(act3d_smem_u32(bar))
      : "memory");
}

// Where byte 0 of a run from `src` lands in the stage buffer `base`.
template <typename T>
__device__ __forceinline__ const T* act3d_run_at(const void* base, const void* src) {
  return reinterpret_cast<const T*>(static_cast<const char*>(base) + ((uintptr_t)src & 15));
}

// A contiguous run of `bytes` bytes at `src` inside the tensor [lo, hi),
// staged into the 16-byte-aligned buffer `base` (act3d_wg_run_bytes(bytes)
// long) so that byte 0 lands at base + (src mod 16).
struct Act3dRun {
  void* base;
  const void* src;
  uint32_t bytes;
  const void* lo;
  const void* hi;
};

// The bulk part of a run: its 16-byte-aligned cover [s0, s1) when that stays
// inside the tensor (the few bytes read past the run land in the buffer's
// slack), else its aligned middle; the rest, under 16 bytes at each end,
// goes by plain loads.
struct Act3dBulk {
  uintptr_t s0, s1;
};

__device__ __forceinline__ Act3dBulk act3d_run_cover(const Act3dRun& r) {
  const uintptr_t s = (uintptr_t)r.src, e = s + r.bytes;
  if (r.bytes == 0) return {s, s};  // an empty run (no mask): nothing to copy
  const uintptr_t c0 = s & ~(uintptr_t)15, c1 = (e + 15) & ~(uintptr_t)15;
  if (c0 >= (uintptr_t)r.lo && c1 <= (uintptr_t)r.hi) return {c0, c1};
  const uintptr_t a0 = (s + 15) & ~(uintptr_t)15, a1 = e & ~(uintptr_t)15;
  return a1 > a0 ? Act3dBulk{a0, a1} : Act3dBulk{s, s};  // {s, s}: all plain
}

// Lanes 0-14 copy the bytes of [src, bulk start) and lanes 16-30 those of
// [bulk end, src + bytes): empty unless the run touches an unaligned end of
// its tensor.
__device__ __forceinline__ void act3d_run_plain(const Act3dRun& r, const Act3dBulk& c, int lane) {
  const uintptr_t s = (uintptr_t)r.src, e = s + r.bytes;
  char* dst = static_cast<char*>(r.base) + (s & 15);
  uintptr_t p = 0;
  bool live = false;
  if (c.s1 == c.s0) {  // no bulk part: [s, e) is under 32 bytes
    p = s + lane;
    live = p < e;
  } else if (lane < 16) {
    p = s + lane;
    live = p < c.s0;
  } else {
    p = (c.s1 > s ? c.s1 : s) + (lane - 16);
    live = p >= c.s1 && p < e;
  }
  if (live) dst[p - s] = *reinterpret_cast<const char*>(p);
}

// Stages N runs into one stage, completed on `bar` (count 32): the warp's
// plain bytes, then lane 0's expect_tx and bulk copies.
template <int N>
__device__ __forceinline__ void act3d_stage_runs(const Act3dRun (&runs)[N], uint64_t* bar,
                                                 int lane) {
  Act3dBulk cover[N];
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cover[i] = act3d_run_cover(runs[i]);
    act3d_run_plain(runs[i], cover[i], lane);
    tx += (uint32_t)(cover[i].s1 - cover[i].s0);
  }
  __syncwarp();
  if (lane == 0) {
    act3d_mbar_arrive_tx(bar, tx);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (cover[i].s1 > cover[i].s0) {
        // byte x of the tensor lands at base + x - (src rounded down to 16)
        act3d_bulk_g2s(static_cast<char*>(runs[i].base) +
                           (cover[i].s0 - ((uintptr_t)runs[i].src & ~(uintptr_t)15)),
                       reinterpret_cast<const void*>(cover[i].s0),
                       (uint32_t)(cover[i].s1 - cover[i].s0), bar);
      }
    }
  } else {
    act3d_mbar_arrive(bar);
  }
}

// A warp done reading a stage releases it for its warpgroup (the caller
// says which warps release: warp 0 of each warpgroup after the warpgroup's
// named barrier, or every warp), one arrival on `empty`, whose phase counts
// `arrivals`; the warp that releases it last (`released` counts them)
// refills it with tile `next`, so that no warpgroup waits for another.  Its
// wait on `empty` acquires every release before the copy overwrites the
// stage.
template <typename Refill>
__device__ __forceinline__ void act3d_release_stage(uint64_t* empty, unsigned* released,
                                                    int arrivals, int round, int next,
                                                    int n_tiles, int lane, Refill refill) {
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    act3d_mbar_arrive(empty);
    last = atomicAdd(released, 1u) == (unsigned)(arrivals - 1);
    if (last) *released = 0u;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last && next < n_tiles) {
    act3d_mbar_wait(empty, round & 1);
    refill(next);
  }
}

// ------------------------------------------------------------- wgmma
__device__ __forceinline__ void act3d_named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void act3d_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void act3d_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void act3d_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void act3d_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand registers
// across the asynchronous issue and wait.
template <int M>
__device__ __forceinline__ void act3d_reg_fence(float (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle.
__device__ __forceinline__ uint64_t act3d_wg_desc(const void* smem, uint32_t sbo) {
  const uint32_t a = act3d_smem_u32(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 64 float32, this thread's 32) = or += a (64 x 16, registers) times
// B (16 x 64, the descriptor's K-major tile).  scale_d = 0 overwrites d.
__device__ __forceinline__ void act3d_wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// 2^x on the special-function unit (one MUFU.EX2); -inf gives 0.
__device__ __forceinline__ float act3d_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------------- re-layout
// Operand tile `op` of R rows x DP columns (a K-major B operand whose k is
// the slab's columns), from a staged slab whose row r starts at src + r * E
// (the head's lane slice already added): zeros at rows >= n or columns >= d.
// Element (r, c) sits at ((r / 8) * (DP / 8) + c / 8) * 64 + (r % 8) * 8 +
// c % 8: the descriptor's SBO is DP * 16 bytes.  Threads tid of [0, 128).
template <int R, int DP>
__device__ __forceinline__ void act3d_wg_direct(uint16_t* __restrict__ op,
                                                const uint16_t* __restrict__ src, int E, int n,
                                                int d, int tid) {
  constexpr int kTasks = R * (DP / 8);
#pragma unroll
  for (int task = tid; task < kTasks; task += 128) {
    const int r = task / (DP / 8);
    const int c0 = (task % (DP / 8)) * 8;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 2 * u;
      const uint32_t lo = (r < n && c < d) ? src[r * E + c] : 0u;
      const uint32_t hi = (r < n && c + 1 < d) ? src[r * E + c + 1] : 0u;
      w[u] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(op + ((r >> 3) * (DP / 8) + (c0 >> 3)) * 64 + (r & 7) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Operand tile of DP rows x C columns, the transpose of the slab's head
// slice (row c of the tile = column c of the slab, k = the slab's rows): a
// K-major B operand whose k is the slab's rows.  Element (c, j) sits at
// ((c / 8) * (C / 8) + j / 8) * 64 + (c % 8) * 8 + j % 8: SBO = C * 16
// bytes.  With SCALED each value is multiplied by scale[j] in float32 and
// rounded to bf16.
template <int C, int DP, bool SCALED>
__device__ __forceinline__ void act3d_wg_trans(uint16_t* __restrict__ op,
                                               const uint16_t* __restrict__ src, int E, int n,
                                               int d, int tid, const float* scale) {
  constexpr int kTasks = DP * (C / 8);
#pragma unroll
  for (int task = tid; task < kTasks; task += 128) {
    const int c = task % DP;
    const int j0 = (task / DP) * 8;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t x[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int j = j0 + 2 * u + v;
        uint16_t bits = (j < n && c < d) ? src[j * E + c] : (uint16_t)0;
        if (SCALED) bits = act3d_to_bf16(act3d_from_bf16(bits) * scale[j]);
        x[v] = bits;
      }
      w[u] = x[0] | (x[1] << 16);
    }
    *reinterpret_cast<uint4*>(op + ((c >> 3) * (C / 8) + (j0 >> 3)) * 64 + (c & 7) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The register A operand of one k16 step: this warp's rows r0 + g and
// r0 + g + 8 (r0 = 16 * warp), columns k0 + 2t, 2t + 1, 2t + 8, 2t + 9 of
// a staged slab (row stride E), zeros at rows >= n or columns >= d.
__device__ __forceinline__ void act3d_wg_load_a(uint32_t (&a)[4], const uint16_t* src, int E,
                                                int n, int d, int r0, int k0, int g, int t) {
  auto x = [&](int r, int c) -> uint32_t {
    return (r < n && c < d) ? (uint32_t)src[r * E + c] : 0u;
  };
  const int ra = r0 + g, rb = ra + 8, c = k0 + 2 * t;
  a[0] = x(ra, c) | (x(ra, c + 1) << 16);
  a[1] = x(rb, c) | (x(rb, c + 1) << 16);
  a[2] = x(ra, c + 8) | (x(ra, c + 9) << 16);
  a[3] = x(rb, c + 8) | (x(rb, c + 9) << 16);
}

// d (64 x N, this warp's 16 rows) += a (the k16 step's register A
// operand) times B (16 x N) of a K-major operand tile in the core-matrix
// layout whose k extent is C: the N / 8 tiles of 8 columns on mma.sync
// m16n8k16, each B fragment two 32-bit words of one core-matrix row.  The
// accumulator holds wgmma's layout, which is mma.sync's C layout per tile.
template <int N, int C>
__device__ __forceinline__ void act3d_mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                             const uint16_t* op, int k0, int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint16_t* row = op + (j * (C / 8) + (k0 >> 3)) * 64 + g * 8 + 2 * t;
    const uint32_t b[2] = {act3d_word(row, 0), act3d_word(row, 64)};
    float(&c)[4] = *reinterpret_cast<float(*)[4]>(&d[4 * j]);
    act3d_mma_bf16(c, a, b);
  }
}

// Carves 128-byte-aligned buffers out of the dynamic shared memory.
struct Act3dCarve {
  char* p;
  template <typename T>
  __device__ __forceinline__ T* take(size_t bytes) {
    T* r = reinterpret_cast<T*>(p);
    p += act3d_wg_align(bytes);
    return r;
  }
};

// ------------------------------------------------------ operand records
// act3d_prep_kernel writes the operand tiles of every key tile (the dq
// pass; the forward where several query tiles read each key tile) and of
// every row tile (the dk/dv pass) once per call to a workspace, and the main
// kernels stage them with one bulk copy per stage and re-lay nothing: no
// re-layout, no fence and no named barrier per tile.  The forward re-lays
// in the block where one query tile reads the keys (an A/B chose each).
// A record covers one head over one 64-long tile; records are [b][tile][h],
// each a multiple of 128 bytes, so the heads of a group are one contiguous
// run.  The kinds (each main kernel reads all of its kind):
//   kFwdKeys: V^T, K (64 x DP each, the layouts above), for the forward;
//   kDqKeys:  K, V, K^T, for the dq pass;
//   kRows:    q, dO, bf16(q r)^T, bf16(dO r / (1 - rate))^T, then per row
//             m log2 e, m (+inf past the tile: ex = 0), delta, the dropout
//             row key, for the dk/dv pass.
enum Act3dRecord { kFwdKeys = 0, kDqKeys = 1, kRows = 2 };

__host__ __device__ constexpr size_t act3d_op_bytes(int dp) { return (size_t)64 * dp * 2; }
__host__ __device__ constexpr size_t act3d_record_bytes(int kind, int dp) {
  return kind == kFwdKeys ? 2 * act3d_op_bytes(dp)
         : kind == kDqKeys ? 3 * act3d_op_bytes(dp)
                           : 4 * act3d_op_bytes(dp) + 4 * 64 * 4;
}

struct Act3dPrepArgs {
  const uint16_t* x0;  // k or q (B, N, E)
  const uint16_t* x1;  // v or dO
  const float* stats;  // kRows: (B, N, 2H) float32
  const float* delta;  // kRows: (B, N, H) float32
  char* out;
  int B, N, H, d, tiles;
  uint32_t seed, b0, dropout;
  float inv_keep;
  const uint32_t* seed_slot;  // the seed in device memory (dropout_hash.cuh), or null
};

// grid (ceil(N / 64), H, B), 128 threads: the record of one head and tile.
template <int DP, int KIND>
__global__ void __launch_bounds__(128) act3d_prep_kernel(const Act3dPrepArgs p) {
  __shared__ float scale[2][64];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int E = p.H * p.d;
  const int n0 = tile * 64;
  const int n = min(64, p.N - n0);
  uint16_t* op = reinterpret_cast<uint16_t*>(
      p.out + (((size_t)b * p.tiles + tile) * p.H + h) * act3d_record_bytes(KIND, DP));
  const uint16_t* x0 = p.x0 + ((size_t)b * p.N + n0) * E + h * p.d;
  const uint16_t* x1 = p.x1 + ((size_t)b * p.N + n0) * E + h * p.d;
  constexpr int kOp = 64 * DP;  // elements of one operand tile
  if (KIND == kFwdKeys) {
    act3d_wg_trans<64, DP, false>(op, x1, E, n, p.d, tid, nullptr);  // V^T
    act3d_wg_direct<64, DP>(op + kOp, x0, E, n, p.d, tid);           // K
    return;
  }
  if (KIND == kDqKeys) {
    act3d_wg_direct<64, DP>(op, x0, E, n, p.d, tid);                           // K
    act3d_wg_direct<64, DP>(op + kOp, x1, E, n, p.d, tid);                     // V
    act3d_wg_trans<64, DP, false>(op + 2 * kOp, x0, E, n, p.d, tid, nullptr);  // K^T
    return;
  }
  float* cols = reinterpret_cast<float*>(op + 4 * kOp);
  if (tid < 64) {
    const int i = tid;
    float m = INFINITY, r = 0.f, dl = 0.f;
    uint32_t rk = 0u;
    if (i < n) {
      const size_t row = (size_t)b * p.N + n0 + i;
      m = p.stats[row * 2 * p.H + 2 * h];
      r = 1.f / p.stats[row * 2 * p.H + 2 * h + 1];
      dl = p.delta[row * p.H + h];
      if (p.dropout) {
        rk = act3d_dropout_row_key(act3d_dropout_seed(p.seed, p.seed_slot), p.b0 + b, h, n0 + i);
      }
    }
    cols[i] = m * kLog2e;
    cols[64 + i] = m;
    cols[128 + i] = dl;
    reinterpret_cast<uint32_t*>(cols)[192 + i] = rk;
    scale[0][i] = r;
    scale[1][i] = r * p.inv_keep;
  }
  __syncthreads();
  act3d_wg_direct<64, DP>(op, x0, E, n, p.d, tid);                           // q
  act3d_wg_direct<64, DP>(op + kOp, x1, E, n, p.d, tid);                     // dO
  act3d_wg_trans<64, DP, true>(op + 2 * kOp, x0, E, n, p.d, tid, scale[0]);  // qf^T
  act3d_wg_trans<64, DP, true>(op + 3 * kOp, x1, E, n, p.d, tid, scale[1]);  // dof^T
}

// The records of one call: grid (tiles, H, B).
template <int DP, int KIND>
cudaError_t act3d_prep(const Act3dPrepArgs& p, cudaStream_t stream) {
  act3d_prep_kernel<DP, KIND><<<dim3(p.tiles, p.H, p.B), 128, 0, stream>>>(p);
  return cudaGetLastError();
}
