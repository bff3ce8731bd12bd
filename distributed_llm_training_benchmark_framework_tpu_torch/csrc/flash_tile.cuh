// Shared pieces of the one first-design kernel left in fwd_variants.cu (the
// microbench's matmul-only forward K8): the tile geometry, the shared-memory
// layout of one tile, the global -> shared tile copies and the tensor-core
// tile products. The other attention kernels (K1-K7, K9: flash_fwd_sm90.cuh
// and flash_bwd.cu) run wgmma mainloops.
//
// Design (first, simple version): one CTA of 4 warps works on 64-row tiles.
// Each warp owns 16 rows of every 64-row tile it produces. Products run on
// the tensor cores through nvcuda::wmma (bf16 operands, fp32 accumulation,
// 16x16x16 fragments) with operands and accumulators staged in shared
// memory. Rows are padded (+8 bf16 / +4 fp32) to spread the row starts over
// the banks; every fragment pointer stays 32-byte aligned, as
// wmma::load_matrix_sync requires.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16

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

namespace wm = nvcuda::wmma;
typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> FragBt;
typedef wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> FragB;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> FragC;

// One warp: C(16, 64) = A(16, D) . B(64, D)^T, a product over the head dim
// (the scores q.k^T). A and B are padded bf16 tiles; C is fp32.
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
// of a score tile (bf16(scale s).v). C is an fp32 shared
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

}  // namespace flash
