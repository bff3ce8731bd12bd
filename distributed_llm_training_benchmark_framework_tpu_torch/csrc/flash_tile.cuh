// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the shared-memory layout of one tile, the global ->
// shared tile copy, warp reductions and the two tensor-core tile products.
//
// Design (first, simple version): one CTA of 4 warps works on 64-row tiles.
// Each warp owns 16 rows of every 64-row tile it produces, so the softmax
// statistics of a row live in one warp and no inter-warp reduction exists.
// Products run on the tensor cores through nvcuda::wmma (bf16 operands,
// fp32 accumulation, 16x16x16 fragments) with operands and accumulators
// staged in shared memory. Rows are padded (+8 bf16 / +4 fp32) to spread
// the row starts over the banks; every fragment pointer stays 32-byte
// aligned, as wmma::load_matrix_sync requires.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;                    // rows of a q tile and of a k tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr float kNegInf = -1e30f;             // NEG_INF of the JAX kernels

// Shared-memory strides (elements) and sizes (bytes) for head dim D.
template <int D>
struct Layout {
  static constexpr int ld_tile = D + 8;           // bf16 (64, D) operand tile
  static constexpr int ld_acc = D + 4;            // fp32 (64, D) accumulator
  static constexpr int ld_score = kTile + 4;      // fp32 (64, 64) score tile
  static constexpr int ld_prob = kTile + 8;       // bf16 (64, 64) operand tile
  static constexpr int tile_bytes = kTile * ld_tile * 2;
  static constexpr int acc_bytes = kTile * ld_acc * 4;
  static constexpr int score_bytes = kTile * ld_score * 4;
  static constexpr int prob_bytes = kTile * ld_prob * 2;
};

// Copy a (64, D) bf16 tile from a row-major (rows, D) global matrix into
// padded shared memory, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int tid) {
  constexpr int chunks = D / 8;
#pragma unroll 4
  for (int i = tid; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::ld_tile + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * 8);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float* acc, int tid) {
  for (int i = tid; i < kTile * Layout<D>::ld_acc; i += kThreads) acc[i] = 0.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

namespace wm = nvcuda::wmma;
typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> FragBt;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> FragB;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> FragC;

// One warp: C(16, 64) = A(16, D) . B(64, D)^T, a product over the head dim
// (scores q.k^T, or dO.v^T). A and B are padded bf16 tiles; C is fp32.
template <int D>
__device__ __forceinline__ void warp_mm_abt(float* c, const bf16* a, const bf16* b) {
  constexpr int lda = Layout<D>::ld_tile;
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC acc;
    wm::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      FragA fa;
      FragBt fb;
      wm::load_matrix_sync(fa, a + k, lda);
      wm::load_matrix_sync(fb, b + n * 16 * lda + k, lda);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(c + n * 16, acc, Layout<D>::ld_score, wm::mem_row_major);
  }
}

// One warp: C(16, D) += A(16, 64) . B(64, D), a product over the 64 columns
// of a probability tile (p.v, ds.k, p^T.dO, ds^T.q). C is an fp32 shared
// accumulator, A a padded bf16 (64, 64) tile, B a padded bf16 (64, D) tile.
template <int D>
__device__ __forceinline__ void warp_mm_ab_acc(float* c, const bf16* a, const bf16* b) {
  constexpr int ldb = Layout<D>::ld_tile;
  constexpr int ldc = Layout<D>::ld_acc;
#pragma unroll 2
  for (int n = 0; n < D / 16; ++n) {
    FragC acc;
    wm::load_matrix_sync(acc, c + n * 16, ldc, wm::mem_row_major);
#pragma unroll
    for (int k = 0; k < kTile; k += 16) {
      FragA fa;
      FragB fb;
      wm::load_matrix_sync(fa, a + k, Layout<D>::ld_prob);
      wm::load_matrix_sync(fb, b + k * ldb + n * 16, ldb);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(c + n * 16, acc, ldc, wm::mem_row_major);
  }
}

__device__ __forceinline__ void store_out(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }

// Write a warp's 16 rows of an fp32 accumulator to global memory as OutT:
// bf16 (the flash backward's gradients) or fp32 (the per-hop partials of
// the ring backward, summed over hops before one final cast).
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(OutT* __restrict__ dst, const float* acc, int r0,
                                           int lane) {
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = r0 + rr;
    for (int d = lane; d < D; d += 32)
      store_out(dst + (size_t)r * D + d, acc[r * Layout<D>::ld_acc + d]);
  }
}

}  // namespace flash
