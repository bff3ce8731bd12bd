// The attention forward mainloop for Hopper (sm_90a), shared by the flash
// forward K1 (flash_fwd.cu), the ring block forward K4 (ring_fwd.cu) and the
// microbench's five forwards K5-K9 (fwd_variants.cu).
//
// One warpgroup (128 threads) runs on one 64-row q tile of one batch*head;
// it walks that head's 64-row k/v tiles with an online softmax. The kernels
// differ only in their coordinates (which k tiles are live, where each lies
// in the global sequence, which batch*head id keys the dropout hash), the
// layout of k, the number of warpgroups in a CTA and their epilogues, so
// the loop is one template over a `Coords` type that gives
//     int q_off;                      global row of the q tile's first row
//     int n_kt;                       k tiles in the block
//     __device__ int k_off(int kt);   global column of k tile kt's first key
//     __device__ int next_live(int kt);  first live k tile >= kt (n_kt: none)
//
// Design, for this card:
//   - Operands never pass through registers on their way in: one thread
//     issues TMA copies (cp.async.bulk.tensor, 2-D tensor maps over the
//     (BH*S, D) q, k and v, 64 x 64 boxes) that land in the 128-byte
//     swizzled layout the wgmma descriptors describe. A D = 128 tile is two
//     64-column blocks of 8 KB. K and V tiles rotate through two stages
//     (one mbarrier each); the copy of tile i + 2 is issued as soon as
//     every warp has finished tile i, so it runs under the products of tile
//     i + 1.
//   - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major); the fp32 scores stay in registers, 32 per thread.
//   - The online softmax runs on that accumulator fragment: a thread holds
//     two rows' values (rows 16w + lane/4 and +8, columns 8j + 2(lane%4) and
//     +1), so a row's max is two shuffles within the quad and the row sum is
//     kept per thread and reduced once at the end. exp2 takes the scale
//     folded into log2(e); the running max stays in raw score units, so the
//     max written out is exactly the scaled one and a row with no live key
//     keeps exactly NEG_INF.
//   - P becomes bf16 in registers and is the register A operand of wgmma
//     m64n64k16 for O += P.V, one instruction per 64-column block of V; V is
//     read from shared memory through a transposed (MN-major) descriptor,
//     so no transposed copy of V exists. O stays in registers (32 fp32 per
//     thread per 64 columns) until the epilogue, and the alpha rescale is a
//     multiply on registers.
//   - The causal mask is evaluated only on tiles that reach past the
//     diagonal of some row; tiles wholly in the future are never loaded.
//   - Dropout hashes each element from its global (row, col): the row base
//     of a thread's two rows is computed once per CTA.
//   - K_T (K7): k arrives transposed, (BH, D, S), mapped as a (BH * D, S)
//     matrix; a k tile is D rows x 64 keys, D / 64 boxes of 64 x 64, and
//     S = Q.K^T reads it through an MN-major descriptor exactly as P.V reads
//     V. No transposed copy exists and a stage holds the same bytes.
//   - WG = 2 (K6): two warpgroups share a CTA, each on its own head of the
//     same q tile, each with its own shared-memory region (Q, the K/V
//     stages, the mbarriers), its own producer thread and its own named
//     barrier in place of __syncthreads, so neither waits for the other.
//   - Q_SCALE (K9): once Q has landed, the warpgroup rewrites it in shared
//     memory as bf16(q * bf16(q_scale)), 16 bytes per thread per step (the
//     operation is elementwise, so the swizzle does not matter), and each
//     writer fences its writes over to the async proxy that wgmma reads
//     through before the warpgroup meets and the first product is issued.
//     The caller passes scale 1, so the scores are left unscaled.
//   - MATMUL_ONLY (K8): the two products alone. Each tile's P is
//     bf16(s * scale), the fp32 score times the fp32 scale rounded once;
//     there is no mask, running max, exponential, rescale of O or row sum,
//     so m and l keep their initial values (kNegInf, 0). The scale is not
//     folded into Q: at D 128 it is not a power of two, and bf16(q * scale)
//     would be another function.
//
// The PTX helpers (mbarriers, TMA, wgmma, descriptors) and the tensor-map
// encoder live in sm90_ptx.cuh, shared with the backward pair (flash_bwd.cu).
#pragma once

#include "dropout_hash.cuh"
#include "sm90_ptx.cuh"

namespace flash {
namespace sm90 {

// Two K/V stages at both head dims: 41 KB of shared memory at D 64 (five
// CTAs per SM, as the 90-96 registers allow too), 81 KB at D 128 (two CTAs
// per SM). The CTAs resident on an SM overlap each other's softmax with
// their products; a third stage gave no gain.
constexpr int kStages = 2;

// One warpgroup's region: Q, kStages x (K, V), one mbarrier per stage and
// one for Q. A second warpgroup's region starts on the next 1024-byte
// boundary after the first's barriers.
template <int D>
__host__ __device__ constexpr int region_stride() {
  return (D / 64) * kBlockBytes * (1 + 2 * kStages) + 1024;
}

// WG regions and 1 KB of slack to align the tiles to the 1024-byte period
// of the swizzle: 41 KB (one warpgroup) or 82 KB (two) at D 64, 81 KB or
// 162 KB at D 128.
template <int D, int WG = 1>
__host__ __device__ constexpr int smem_bytes() {
  return (WG - 1) * region_stride<D>() + (D / 64) * kBlockBytes * (1 + 2 * kStages) +
         8 * (kStages + 1) + 1024;
}

// Every warp of the calling warpgroup has arrived. Named barrier 1 + wg is
// warpgroup wg's own, in place of __syncthreads when a CTA holds two.
template <int WG>
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (WG == 1)
    __syncthreads();
  else
    named_bar_sync(1 + wg, kThreads);
}

// Every k tile of the row range is live (K1 and the microbench's layouts).
struct FlashCoords {
  int q_off, n_kt;
  __device__ int k_off(int kt) const { return kt * kTile; }
  __device__ int next_live(int kt) const { return kt; }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The mainloop
// ---------------------------------------------------------------------------

// S = Q . K^T over the head dim, one wgmma group. Q (64 x D) is K-major: a
// k step of 16 columns is 32 bytes inside a 64-column block, and the next
// block starts 8 KB on. K (64 keys x D) is K-major as Q; K^T (D x 64 keys,
// K_T) is MN-major and read as V is: 16 rows of the head dim are 2 KB on.
template <int D, bool K_T>
__device__ __forceinline__ void score_product(float (&sc)[32], uint64_t q_desc, uint64_t k_desc,
                                              uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t off = ((kk / 4) * kBlockBytes + (kk % 4) * 32) >> 4;
    if (K_T)
      wgmma_ss<1>(sc, q_desc + off,
                  sw128_desc(sK + (kk / 4) * kBlockBytes + (kk % 4) * 2048, kBlockBytes, 1024),
                  kk > 0);
    else
      wgmma_ss(sc, q_desc + off, k_desc + off, kk > 0);
  }
}

// O += P . V, one wgmma group: V (64 keys x D) is MN-major; 16 keys are 2 KB
// on, and each 64-column block of V is its own 8 KB block (one n64 product
// each). P is the bf16 register operand.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 64][32], const uint32_t (&pa)[4][4],
                                           uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      wgmma_rs(o[b], pa[kk], sw128_desc(sV + b * kBlockBytes + kk * 2048, kBlockBytes, 1024));
}

// Runs the online softmax of one q tile over every live k tile of `co`.
// q_row / kv_row: the tile's row in the (BH*S, D) q tensor map, and the row
// of k tile 0 in the k and v maps; with K_T, kt_row is the head's first row
// in the (BH*D, S) k^T map instead of kv_row. On return o holds the unnormalized
// accumulator (fragment layout: element 4j + c of block b is row
// frag_row(tid, c / 2), column 64 b + frag_col(tid, j) + c % 2), m the
// running max of the RAW scores of the thread's two rows (exactly kNegInf
// where a row met no live key) and l their full row sums of the UN-dropped
// p. Must be called by all 128 threads of each of the CTA's WG warpgroups
// (warpgroup wg = threadIdx.x / 128); returns early, uniformly over the
// warpgroup and with no copy in flight, when no k tile is live. With Q_SCALE,
// q_scale multiplies Q in bf16 before the first product; with MATMUL_ONLY, o
// is sum_k bf16(scale * s) . v and m, l stay as initialised (see above).
template <int D, bool CAUSAL, bool DROPOUT, bool K_T = false, int WG = 1, bool Q_SCALE = false,
          bool MATMUL_ONLY = false, class Coords>
__device__ __forceinline__ void fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const Coords& co,
                                             int q_row, int kv_row, float scale,
                                             uint32_t bh_hash, uint32_t threshold,
                                             float inv_keep, float (&o)[D / 64][32],
                                             float (&m)[2], float (&l)[2], int kt_row = 0,
                                             float q_scale = 1.f) {
  static_assert(WG == 1 || WG == 2, "one or two warpgroups per CTA");
  constexpr int kBlocks = D / 64;
  constexpr uint32_t kTileBytes = kBlocks * kBlockBytes;
  extern __shared__ unsigned char smem_raw[];
  const int wg = WG == 1 ? 0 : threadIdx.x / kThreads;
  const int tid = WG == 1 ? threadIdx.x : threadIdx.x % kThreads;
  const uint32_t base = ((smem_addr(smem_raw) + 1023u) & ~1023u) + wg * region_stride<D>();
  const uint32_t sQ = base;
  const uint32_t bars = base + kTileBytes * (1 + 2 * kStages);  // full[s], then Q's
  const uint32_t q_bar = bars + 8 * kStages;

#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  warpgroup_sync<WG>(wg);

  int kt = co.next_live(0);
  // Uniform over the warpgroup: a block with no live tile issues no copy and
  // leaves with the empty statistics; nothing of shared memory is read.
  if (kt >= co.n_kt) return;

  // The warpgroup's thread 0 is also its producer: its cursor runs kStages
  // live tiles ahead.
  int kt_load = kt;
  auto load_kv = [&](int s, int t) {
    const uint32_t bar = bars + 8 * s;
    const uint32_t sK = base + kTileBytes * (1 + 2 * s);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      if (K_T)  // rows 64b .. 64b + 63 of the head dim, keys of tile t
        tma_load(sK + b * kBlockBytes, tk, bar, t * kTile, kt_row + 64 * b);
      else
        tma_load(sK + b * kBlockBytes, tk, bar, 64 * b, kv_row + t * kTile);
      tma_load(sK + kTileBytes + b * kBlockBytes, tv, bar, 64 * b, kv_row + t * kTile);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(q_bar, kTileBytes);
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) tma_load(sQ + b * kBlockBytes, tq, q_bar, 64 * b, q_row);
    for (int s = 0; s < kStages && kt_load < co.n_kt; ++s) {
      load_kv(s, kt_load);
      kt_load = co.next_live(kt_load + 1);
    }
  }

  const float sl2 = scale * kLog2e;
  int rows[2];
  uint32_t row_base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = co.q_off + frag_row(tid, h);
    row_base[h] = DROPOUT ? dropout_row_base(bh_hash, static_cast<uint32_t>(rows[h])) : 0u;
  }
  // Q: 64 x D, K-major; a k step of 16 columns is 32 bytes inside a 64-column
  // block, and the next block starts 8 KB on. Rows are 128 bytes, so the
  // 8-row stride (SBO) is 1024 bytes; LBO is unused by swizzled K-major.
  const uint64_t q_desc = sw128_desc(sQ, 16, 1024);

  // P as the bf16 A operand of P . V: 16 keys per k step, fragment
  // registers {row r, cols 0-7 of the step}, {r + 8, 0-7}, {r, 8-15},
  // {r + 8, 8-15}, which are accumulator chunks j = 2 kk and 2 kk + 1.
  // Every tile writes all of it before P . V reads it. It is declared and
  // zeroed here, not in the loop: declared in the loop, ptxas selects other
  // instructions for K1 and K4 (same count) than those of the machine code
  // their times in PERF.md were taken on.
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = 0u;
  mbar_wait(q_bar, 0);
  if constexpr (Q_SCALE) {
    const float qs = __bfloat162float(__float2bfloat16(q_scale));
    uint4* q16 = reinterpret_cast<uint4*>(smem_raw + (sQ - smem_addr(smem_raw)));
#pragma unroll
    for (int j = 0; j < kTileBytes / 16 / kThreads; ++j) {
      uint4 x = q16[j * kThreads + tid];
      x.x = scale_bf16x2(x.x, qs);
      x.y = scale_bf16x2(x.y, qs);
      x.z = scale_bf16x2(x.z, qs);
      x.w = scale_bf16x2(x.w, qs);
      q16[j * kThreads + tid] = x;
    }
    fence_proxy_async_smem();
    warpgroup_sync<WG>(wg);
  }
  for (int it = 0; kt < co.n_kt; ++it) {
    const int s = it % kStages;
    const uint32_t sK = base + kTileBytes * (1 + 2 * s);
    const uint32_t sV = sK + kTileBytes;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    // S = Q . K^T over the head dim.
    wgmma_fence();
    score_product<D, K_T>(sc, q_desc, sw128_desc(sK, 16, 1024), sK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if constexpr (MATMUL_ONLY) {
      // P = bf16(s * scale), rounded once from the fp32 product.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pa[j / 2][2 * (j % 2) + h] =
              pack_bf16(sc[4 * j + 2 * h] * scale, sc[4 * j + 2 * h + 1] * scale);
    } else {
      // Online softmax on the fragment.
      const int k_off = co.k_off(kt);
      const bool diag = CAUSAL && co.q_off < k_off + kTile - 1;  // some element is masked
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (diag && rows[c / 2] < k_off + frag_col(tid, j) + c % 2) sc[4 * j + c] = kNegInf;
          mx[c / 2] = fmaxf(mx[c / 2], sc[4 * j + c]);
        }
      float alpha[2], mb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        alpha[h] = fast_exp2((m[h] - mx[h]) * sl2);
        m[h] = mx[h];
        mb[h] = mx[h] * sl2;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = k_off + frag_col(tid, j);
          float p0 = fast_exp2(fmaf(sc[4 * j + 2 * h], sl2, -mb[h]));
          float p1 = fast_exp2(fmaf(sc[4 * j + 2 * h + 1], sl2, -mb[h]));
          if (diag) {
            if (rows[h] < col) p0 = 0.f;
            if (rows[h] < col + 1) p1 = 0.f;
          }
          l[h] += p0 + p1;
          if (DROPOUT) {
            p0 = dropout_keep(row_base[h], static_cast<uint32_t>(col), threshold)
                     ? p0 * inv_keep
                     : 0.f;
            p1 = dropout_keep(row_base[h], static_cast<uint32_t>(col + 1), threshold)
                     ? p1 * inv_keep
                     : 0.f;
          }
          pa[j / 2][2 * (j % 2) + h] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[b][i] *= alpha[(i % 4) / 2];
    }

#pragma unroll
    for (int b = 0; b < kBlocks; ++b) fence_regs(o[b]);
    // O += P . V.
    wgmma_fence();
    pv_product<D>(o, pa, sV);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) fence_regs(o[b]);

    // Every warp of the warpgroup has finished reading stage s: refill it.
    warpgroup_sync<WG>(wg);
    if (tid == 0 && kt_load < co.n_kt) {
      load_kv(s, kt_load);
      kt_load = co.next_live(kt_load + 1);
    }
    kt = co.next_live(kt + 1);
  }
  if constexpr (!MATMUL_ONLY) {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  }
}

}  // namespace sm90
}  // namespace flash
