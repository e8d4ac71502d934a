// Counter-based keep mask of the attention-weight dropout, shared by the
// fused-MHA forward (fused_mha_fwd.cu) and backward (fused_mha_bwd.cu).
//
// Replaces the TPU kernel's in-kernel PRNG
// (act3d_tpu/kernels/attention.py::_dropout_bits / _dropout_keep, seeded
// per (seed, batch, L-tile, head)).  Here the bits are a pure function of
// (seed, b, h, row, col) in absolute coordinates, so the mask depends on
// no tile size and every pass (forward, both backward passes, the plain
// PyTorch version in kernels/attention.py) regenerates it exactly:
//
//   mix(x)      = lowbias32: x ^= x>>16; x *= 0x7feb352d; x ^= x>>15;
//                 x *= 0x846ca68b; x ^= x>>16          (all mod 2^32)
//   row_key     = mix(mix(mix(mix(seed ^ 0x85ebca6b) ^ b) ^ h) ^ row)
//   bits(col)   = mix(row_key ^ col * 0x9e3779b9)
//   keep        = bits >= threshold,  threshold = min(floor(rate * 2^32),
//                 2^32 - 1), computed on the host as _keep_threshold does.
// (mix(0) = 0; the constant keeps an int31 seed of 0 off that fixed point.)
// b is the row of the global batch: the kernels pass b0 + (local row),
// with b0 the rows' offset under data parallelism.
//
// The seed is a launch argument, or, where an entry of the two sources is
// given a `seed_slot`, the uint32 word there in device memory, read by each
// thread once before its first row key: a step replayed from a CUDA graph
// (train/step_graph.py) writes its seeds to those words before the replay.
//
// The row key is computed once per query row; each score then costs 11
// integer instructions (one IMAD for col * golden, the xor, the 8 of mix
// with its two 32-bit multiplies, the compare).

#pragma once

#include <stdint.h>

__host__ __device__ __forceinline__ uint32_t act3d_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t act3d_dropout_seed(uint32_t seed, const uint32_t* slot) {
  return slot != nullptr ? __ldg(slot) : seed;
}

__host__ __device__ __forceinline__ uint32_t act3d_dropout_row_key(
    uint32_t seed, uint32_t b, uint32_t h, uint32_t row) {
  return act3d_mix32(
      act3d_mix32(act3d_mix32(act3d_mix32(seed ^ 0x85ebca6bu) ^ b) ^ h) ^ row);
}

__host__ __device__ __forceinline__ bool act3d_dropout_keep(
    uint32_t row_key, uint32_t col, uint32_t threshold) {
  return act3d_mix32(row_key ^ (col * 0x9e3779b9u)) >= threshold;
}
