// Decisions every attention kernel of this directory shares: the bf16
// operand type, the 64-row tile (the ring's global tile bases qoff / koff,
// ops/ring_attention.py, count in it) and the masked score NEG_INF, -1e30
// and not -inf, as in the JAX kernels.
#pragma once

#include <cuda_bf16.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;          // rows of a q tile and of a k tile
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernels

}  // namespace flash
