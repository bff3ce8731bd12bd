// Attention-probability dropout mask: a stateless hash of absolute
// (seed, batch*head, row, col) coordinates.
//
// Replaces the inlined helpers _mix32 / _dropout_keep / _dropout_threshold of
// distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py.
// The mask must be bit-identical to the JAX one for the same uint32 seed, so
// every value is uint32_t and every multiply wraps modulo 2^32. The threshold
// min(floor((1 - rate) * 2^32), 2^32 - 1) is computed on the host by the
// Python wrapper, exactly as _dropout_threshold does, and passed in.
#pragma once

#include <stdint.h>

namespace flash {

// murmur3-style 32-bit finalizer (two multiplies, three xor-shifts).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Per-(batch*head) stream base: mix32(seed + bh * golden-ratio constant).
__device__ __forceinline__ uint32_t dropout_bh_base(uint32_t seed, uint32_t bh) {
  return mix32(seed + bh * 0x9E3779B9u);
}

// Per-row stream base, folded from the (batch*head) base.
__device__ __forceinline__ uint32_t dropout_row_base(uint32_t bh_base, uint32_t row) {
  return mix32(bh_base + row * 0x85EBCA6Bu);
}

// keep = mix32(row base + col) < threshold.
__device__ __forceinline__ bool dropout_keep(uint32_t row_base, uint32_t col,
                                             uint32_t threshold) {
  return mix32(row_base + col) < threshold;
}

}  // namespace flash
