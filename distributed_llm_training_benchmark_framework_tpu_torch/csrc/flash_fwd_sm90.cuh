// The attention forward mainloop for Hopper (sm_90a), shared by the flash
// forward K1 (flash_fwd.cu) and the ring block forward K4 (ring_fwd.cu).
//
// One CTA is one warpgroup (128 threads) on one 64-row q tile of one
// batch*head; it walks that head's 64-row k/v tiles with an online softmax.
// The two kernels differ only in their coordinates (which k tiles are live,
// where each lies in the global sequence, which batch*head id keys the
// dropout hash) and their epilogues, so the loop is one template over a
// `Coords` type that gives
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
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"

namespace flash {
namespace sm90 {

constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockBytes = kTile * 128;  // 64 rows x 64 bf16 columns, 128-byte swizzled

// Two K/V stages at both head dims: 41 KB of shared memory at D 64 (five
// CTAs per SM, as the 90-96 registers allow too), 81 KB at D 128 (two CTAs
// per SM). The CTAs resident on an SM overlap each other's softmax with
// their products; a third stage gave no gain.
constexpr int kStages = 2;

// Q, kStages x (K, V), one mbarrier per stage and one for Q, and 1 KB of
// slack to align the tiles to the 1024-byte period of the swizzle.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (D / 64) * kBlockBytes * (1 + 2 * kStages) + 8 * (kStages + 1) + 1024;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait longer than this is a copy that never lands.
constexpr uint64_t kWaitLimitNs = 1000000000ull;  // 1 s

// Spin until the barrier's phase of the given parity has completed. A copy
// that never lands traps after kWaitLimitNs of the card's global timer
// instead of hanging the card. The trap is asynchronous: the launch itself
// reports success, and the error surfaces at the next synchronization as a
// sticky error that ends the process's CUDA context.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > kWaitLimitNs) __trap();
}

// Copy the 64 x 64 box at (col, row) of a 2-D tensor map into shared memory
// at dst; the copy's bytes complete a transaction on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63. Base offset 0: every tile starts on
// a 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of wgmma accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 fp32) = [d +] A . B: A 64 x 16 and B 64 x 16, both K-major in
// shared memory (descriptors a and b); accumulate != 0 adds to d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 fp32) += A . B: A 64 x 16 bf16 from registers (four b32 per
// thread, the m16n8k16 A fragment of the thread's warp's 16 rows), B 16 x 64
// in shared memory, MN-major (transposed operand).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The (row, column) a thread's accumulator element 4j + c stands for, local
// to the 64 x 64 tile: row 16 * warp + lane / 4 + 8 * (c / 2), column
// 8 * j + 2 * (lane % 4) + c % 2.
__device__ __forceinline__ int frag_row(int tid, int half) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * half;
}
__device__ __forceinline__ int frag_col(int tid, int j) { return 8 * j + 2 * (tid % 4); }

// ---------------------------------------------------------------------------
// The mainloop
// ---------------------------------------------------------------------------

// Runs the online softmax of one q tile over every live k tile of `co`.
// q_row / kv_row: the tile's row in the (BH*S, D) q tensor map, and the row
// of k tile 0 in the k and v maps. On return o holds the unnormalized
// accumulator (fragment layout: element 4j + c of block b is row
// frag_row(tid, c / 2), column 64 b + frag_col(tid, j) + c % 2), m the
// running max of the RAW scores of the thread's two rows (exactly kNegInf
// where a row met no live key) and l their full row sums of the UN-dropped
// p. Must be called by all 128 threads; returns early, CTA-uniformly and
// with no copy in flight, when no k tile is live.
template <int D, bool CAUSAL, bool DROPOUT, class Coords>
__device__ __forceinline__ void fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const Coords& co,
                                             int q_row, int kv_row, float scale,
                                             uint32_t bh_hash, uint32_t threshold,
                                             float inv_keep, float (&o)[D / 64][32],
                                             float (&m)[2], float (&l)[2]) {
  constexpr int kBlocks = D / 64;
  constexpr uint32_t kTileBytes = kBlocks * kBlockBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + kTileBytes * (1 + 2 * kStages);  // full[s], then Q's
  const uint32_t q_bar = bars + 8 * kStages;
  const int tid = threadIdx.x;

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
  __syncthreads();

  int kt = co.next_live(0);
  // Uniform over the CTA: a block with no live tile issues no copy and
  // leaves with the empty statistics; nothing of shared memory is read.
  if (kt >= co.n_kt) return;

  // Thread 0 is also the producer: its cursor runs kStages live tiles ahead.
  int kt_load = kt;
  auto load_kv = [&](int s, int t) {
    const uint32_t bar = bars + 8 * s;
    const uint32_t sK = base + kTileBytes * (1 + 2 * s);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
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

  mbar_wait(q_bar, 0);
  for (int it = 0; kt < co.n_kt; ++it) {
    const int s = it % kStages;
    const uint32_t sK = base + kTileBytes * (1 + 2 * s);
    const uint32_t sV = sK + kTileBytes;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);

    // S = Q . K^T over the head dim.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint64_t k_desc = sw128_desc(sK, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t off = ((kk / 4) * kBlockBytes + (kk % 4) * 32) >> 4;
      wgmma_ss(sc, q_desc + off, k_desc + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

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
    // P as the bf16 A operand of P . V: 16 keys per k step, fragment
    // registers {row r, cols 0-7 of the step}, {r + 8, 0-7}, {r, 8-15},
    // {r + 8, 8-15}, which are accumulator chunks j = 2 kk and 2 kk + 1.
    uint32_t pa[4][4];
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
          p0 = dropout_keep(row_base[h], static_cast<uint32_t>(col), threshold) ? p0 * inv_keep
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

    // O += P . V: V (64 keys x D) is MN-major; 16 keys are 2 KB on, and each
    // 64-column block of V is its own 8 KB block (one n64 product each).
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) fence_regs(o[b]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
        wgmma_rs(o[b], pa[kk], sw128_desc(sV + b * kBlockBytes + kk * 2048, kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) fence_regs(o[b]);

    // Every warp has finished reading stage s: refill it.
    __syncthreads();
    if (tid == 0 && kt_load < co.n_kt) {
      load_kv(s, kt_load);
      kt_load = co.next_live(kt_load + 1);
    }
    kt = co.next_live(kt + 1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (so the library needs no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &status);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (e == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over a row-major (rows, D) bf16 matrix with 64 x 64 boxes
// in the 128-byte swizzle.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, int rows, int D) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, kTile};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor maps of q, k and v, all (BH*S, D).
inline cudaError_t make_qkv_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                                 const void* v, int rows, int D) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t e = make_tile_map(&maps[i], ptrs[i], rows, D);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace flash
