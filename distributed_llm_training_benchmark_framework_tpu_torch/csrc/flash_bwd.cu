// Flash-attention backward for Hopper (sm_90a), CUDA C++ written by hand:
// two kernels, no atomics, the same split as the JAX package.
//
// flash_bwd_dq_kernel replaces the Pallas TPU kernel _bwd_dq_kernel and
// flash_bwd_dkv_kernel replaces _bwd_dkv_kernel
// (distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py,
// launched there by _flash_bwd_rule, and by ring attention's
// _block_bwd_kernel in ops/ring_attention.py). Both recompute the
// probabilities of a (64 q rows, 64 k cols) tile from the saved lse,
//   p  = exp(s * scale - lse)            (masked by global position if causal)
//   dp = dO . v^T, dropped and rescaled with the forward's coordinate mask
//   ds = p * (dp - delta) * scale        (delta = rowsum(dO * out), from torch)
// and accumulate in fp32:
//   dq kernel:  one CTA per (batch*head, q tile), looping over k tiles,
//               dq += ds . k;
//   dkv kernel: one CTA per (batch*head, k tile), looping over q tiles,
//               dv += (D*p)^T . dO and dk += ds^T . q.
// The rounding points are the JAX kernels': the dropped p and ds are
// rounded to bf16 before their products, ds takes the fp32 p, and dp is
// dropped and rescaled before delta is subtracted. Like the Pallas kernels,
// both take per-tile global bases for rows (qoff) and columns (koff) and a
// global batch*head vector (bhv), so that causal masking and the dropout
// hash see absolute coordinates; plain flash passes identity vectors, ring
// attention (ops/ring_attention.py) the bases of the block at this hop. The
// output type is a template parameter: bf16 for flash (the JAX launches in
// flash_attention.py write the input dtype) and fp32 for the ring, whose
// per-hop partials are summed over the hops before one cast.
//
// Bound on the H100: 6*Dh tensor FLOPs per live score element for dq (the
// s, dp and dq products) and 8*Dh for dk/dv, plus, with dropout, the hash's
// ~10 integer operations per live element, which is the larger of the two
// at Dh 64 (the parity rows). The bytes (inputs once, outputs once) are far
// below either. Design, for this card (the forward's machinery,
// sm90_ptx.cuh):
//   - One warpgroup (128 threads) per CTA. The tile the CTA owns (Q and dO
//     for dq; K and V for dk/dv) is TMA-loaded once into 128-byte-swizzled
//     shared memory; the tiles it walks (K and V; Q and dO with their 64 lse
//     and delta values) rotate through two stages on one mbarrier each,
//     the copy of tile i + 2 issued as soon as every warp has finished tile
//     i, so it runs under the products of tile i + 1.
//   - The two products over the head dim (S = Q.K^T and dP = dO.V^T; in
//     dk/dv their transposes S^T = K.Q^T and dP^T = V.dO^T) are wgmma
//     m64n64k16 chains with both operands K-major in shared memory, into
//     register fragments (32 fp32 per thread each).
//   - p, the dropped p and ds are formed on those fragments: a thread holds
//     two fragment rows and sixteen fragment columns. In dq the rows are q
//     rows, so lse, delta and the dropout row base are two registers each,
//     loaded once; in dk/dv the rows are keys and the columns q rows, so the
//     causal test, lse, delta and the hash's row base are indexed by
//     fragment column (lse and delta come with the stage; the row bases are
//     hashed once per q tile by 64 threads into shared memory). The causal
//     mask is evaluated only on tiles that cross the diagonal.
//   - ds (and the dropped p) are rounded to bf16 in registers and are the
//     register A operand of wgmma against a 64-row tile read MN-major
//     (K for dQ += dS.K; Q and dO for dK += dS^T.Q and dV += P^T.dO), so no
//     score tile and no transposed operand ever exists in shared memory.
//     dQ, dK and dV stay in registers (32 fp32 per thread per 64 columns)
//     until the epilogue.
//   - Each loop starts at its first live tile and skips dead ones without
//     loading them; a CTA with no live tile (a ring block wholly in the q
//     shard's future) issues no copy and writes exact zeros. Under causal
//     masking the heaviest CTAs run first (dq: the last q tiles; dk/dv: the
//     first k tiles).
#include "dropout_hash.cuh"
#include "sm90_ptx.cuh"

namespace flash {
namespace bwd {

using sm90::kBlockBytes;
using sm90::kLog2e;
using sm90::kThreads;

// Two stages of the walked tiles. Shared memory per CTA at S 2048: 48 KB
// (dq) and 51 KB (dk/dv) at Dh 64, 97 KB and 99 KB at Dh 128, so two CTAs
// share an SM at Dh 128 and registers set the count at Dh 64.
constexpr int kStages = 2;
constexpr uint32_t kStatBytes = 2 * kTile * 4;  // a stage's lse and delta (dk/dv)
constexpr uint32_t kRowBaseBytes = kTile * 4;   // a stage's dropout row bases (dk/dv)

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (D / 64) * kBlockBytes;
}

// Owned tile pair, kStages walked tile pairs, (dk/dv: per-stage lse, delta
// and row bases), one mbarrier per stage and one for the owned pair, the
// walked side's n tile bases, and 1 KB of slack to align the tiles to the
// 1024-byte period of the swizzle.
template <int D, bool DKV>
int smem_bytes(int n_tiles) {
  return 2 * tile_bytes<D>() * (1 + kStages) +
         (DKV ? (kStatBytes + kRowBaseBytes) * kStages : 0) + 8 * (kStages + 1) + 4 * n_tiles +
         1024;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write a 64 x D accumulator held as fragments (element 4j + c of block b
// is row frag_row(tid, c / 2), column 64 b + frag_col(tid, j) + c % 2) to
// rows row0 .. row0 + 63 of a row-major (rows, D) matrix.
template <int D, typename OutT>
__device__ __forceinline__ void store_tile(OutT* __restrict__ dst, size_t row0,
                                           const float (&acc)[D / 64][32], int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    OutT* row = dst + (row0 + sm90::frag_row(tid, h)) * D;
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(row + 64 * b + sm90::frag_col(tid, j), acc[b][4 * j + 2 * h],
               acc[b][4 * j + 2 * h + 1]);
  }
}

// acc (64 x 64) = A . B^T over the head dim, A and B 64 x D K-major tiles in
// shared memory: D / 16 wgmma steps, issued but not waited for.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a, uint32_t b) {
  const uint64_t a_desc = sm90::sw128_desc(a, 16, 1024);
  const uint64_t b_desc = sm90::sw128_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns are 32 bytes inside a 64-column block; the next block
    // starts 8 KB on.
    const uint64_t off = ((kk / 4) * kBlockBytes + (kk % 4) * 32) >> 4;
    sm90::wgmma_ss(acc, a_desc + off, b_desc + off, kk > 0);
  }
}

// acc (64 x D) += A . B, A 64 x 64 bf16 in registers (the fragment of four
// 16-column k steps), B a 64 x D tile in shared memory read MN-major: 16
// rows are 2 KB on, and each 64-column block is its own n64 product.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 64][32], const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int blk = 0; blk < D / 64; ++blk)
      sm90::wgmma_rs(acc[blk], a[kk],
                     sm90::sw128_desc(b + blk * kBlockBytes + kk * 2048, kBlockBytes, 1024));
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N][32]) {
#pragma unroll
  for (int b = 0; b < N; ++b) sm90::fence_regs(r[b]);
}

// The walked side's tile bases, staged in shared memory (the live scans
// read them every tile), and the live test against the owned tile: a q tile
// at q_off and a k tile at k_off share a live element unless causal and
// q_off + 63 < k_off.
template <bool CAUSAL>
struct Walk {
  const int* off;  // shared memory
  int n, own;      // tiles walked; the owned tile's base
  bool owned_is_q;
  __device__ bool live(int t) const {
    return !CAUSAL || (owned_is_q ? own + kTile - 1 >= off[t] : off[t] + kTile - 1 >= own);
  }
  __device__ int next_live(int t) const {
    if (CAUSAL)
      while (t < n && !live(t)) ++t;
    return t;
  }
};

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                        const float* __restrict__ delta, OutT* __restrict__ dq,
                        const int* __restrict__ qoff, const int* __restrict__ koff,
                        const int* __restrict__ bhv, int S, float scale, uint32_t seed,
                        uint32_t threshold, float inv_keep) {
  constexpr int kBlocks = D / 64;
  constexpr uint32_t T = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + T;  // then stage s: K at 2T(1 + s), V after it
  const uint32_t bars = base + 2 * T * (1 + kStages);  // full[s], then Q/dO's
  const uint32_t qd_bar = bars + 8 * kStages;
  int* s_koff = reinterpret_cast<int*>(smem_raw + (qd_bar + 8 - raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int n_kt = S / kTile;
  const int q_off = qoff[qt];
  const size_t row0 = (size_t)bh * S + qt * kTile;  // the q tile's first row

  for (int i = tid; i < n_kt; i += kThreads) s_koff[i] = koff[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(bars + 8 * s, 1);
    sm90::mbar_init(qd_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kBlocks][32];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;

  const Walk<CAUSAL> walk{s_koff, n_kt, q_off, true};
  int kt = walk.next_live(0);
  // Uniform over the CTA: with no live k tile nothing is loaded and the
  // tile's dq is exactly zero.
  if (kt < n_kt) {
    const int kv_row = bh * S;
    int kt_load = kt;  // thread 0's producer cursor, kStages live tiles ahead
    auto load_kv = [&](int s, int t) {
      const uint32_t bar = bars + 8 * s;
      const uint32_t sK = base + 2 * T * (1 + s);
      sm90::mbar_arrive_expect_tx(bar, 2 * T);
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        sm90::tma_load(sK + b * kBlockBytes, &tk, bar, 64 * b, kv_row + t * kTile);
        sm90::tma_load(sK + T + b * kBlockBytes, &tv, bar, 64 * b, kv_row + t * kTile);
      }
    };
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(qd_bar, 2 * T);
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        sm90::tma_load(sQ + b * kBlockBytes, &tq, qd_bar, 64 * b, (int)row0);
        sm90::tma_load(sdO + b * kBlockBytes, &tdo, qd_bar, 64 * b, (int)row0);
      }
      for (int s = 0; s < kStages && kt_load < n_kt; ++s) {
        load_kv(s, kt_load);
        kt_load = walk.next_live(kt_load + 1);
      }
    }

    // The thread's two fragment rows: lse (in log2 units), delta and the
    // dropout row base, once per CTA.
    const uint32_t bh_hash = DROPOUT ? dropout_bh_base(seed, static_cast<uint32_t>(bhv[bh])) : 0u;
    int rows[2];
    float lse2[2], dlt[2];
    uint32_t row_base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm90::frag_row(tid, h);
      rows[h] = q_off + r;
      lse2[h] = lse[row0 + r] * kLog2e;
      dlt[h] = delta[row0 + r];
      row_base[h] = DROPOUT ? dropout_row_base(bh_hash, static_cast<uint32_t>(rows[h])) : 0u;
    }
    const float sl2 = scale * kLog2e;

    sm90::mbar_wait(qd_bar, 0);
    for (int it = 0; kt < n_kt; ++it) {
      const int s = it % kStages;
      const uint32_t sK = base + 2 * T * (1 + s);
      const uint32_t sV = sK + T;
      sm90::mbar_wait(bars + 8 * s, (it / kStages) & 1);

      // S = Q . K^T and dP = dO . V^T, one commit group.
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      sm90::wgmma_fence();
      issue_ss<D>(sc, sQ, sK);
      issue_ss<D>(dp, sdO, sV);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // ds on the fragment, rounded to bf16 as the A operand of dS . K:
      // 16 keys per k step, registers {row r, cols 0-7 of the step},
      // {r + 8, 0-7}, {r, 8-15}, {r + 8, 8-15}, i.e. chunks j = 2 kk, 2 kk + 1.
      const int k_off = s_koff[kt];
      const bool diag = CAUSAL && q_off < k_off + kTile - 1;  // some element is masked
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = k_off + sm90::frag_col(tid, j);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = sm90::fast_exp2(fmaf(sc[i], sl2, -lse2[h]));
            if (diag && rows[h] < col + e) p = 0.f;
            float d = dp[i];
            if (DROPOUT)
              d = dropout_keep(row_base[h], static_cast<uint32_t>(col + e), threshold)
                      ? d * inv_keep
                      : 0.f;
            ds[e] = p * (d - dlt[h]) * scale;
          }
          da[j / 2][2 * (j % 2) + h] = sm90::pack_bf16(ds[0], ds[1]);
        }

      // dQ += dS . K, K read MN-major.
      fence_all(acc);
      sm90::wgmma_fence();
      issue_rs<D>(acc, da, sK);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      fence_all(acc);

      // Every warp has finished reading stage s: refill it.
      __syncthreads();
      if (tid == 0 && kt_load < n_kt) {
        load_kv(s, kt_load);
        kt_load = walk.next_live(kt_load + 1);
      }
      kt = walk.next_live(kt + 1);
    }
  }
  store_tile<D>(dq, row0, acc, tid);
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                         const float* __restrict__ delta, OutT* __restrict__ dk,
                         OutT* __restrict__ dv, const int* __restrict__ qoff,
                         const int* __restrict__ koff, const int* __restrict__ bhv, int S,
                         float scale, uint32_t seed, uint32_t threshold, float inv_keep) {
  constexpr int kBlocks = D / 64;
  constexpr uint32_t T = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + T;  // then stage s: Q at 2T(1 + s), dO after it
  const uint32_t stats = base + 2 * T * (1 + kStages);       // stage s: lse[64], delta[64]
  const uint32_t row_bases = stats + kStatBytes * kStages;   // stage s: 64 row bases
  const uint32_t bars = row_bases + kRowBaseBytes * kStages;  // full[s], then K/V's
  const uint32_t kv_bar = bars + 8 * kStages;
  const float* s_stats = reinterpret_cast<const float*>(smem_raw + (stats - raw));
  uint32_t* s_row_base = reinterpret_cast<uint32_t*>(smem_raw + (row_bases - raw));
  int* s_qoff = reinterpret_cast<int*>(smem_raw + (kv_bar + 8 - raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // under causal masking k tile 0 sees the most q tiles
  const int n_qt = S / kTile;
  const int k_off = koff[kt];
  const size_t row0 = (size_t)bh * S + kt * kTile;  // the k tile's first row

  for (int i = tid; i < n_qt; i += kThreads) s_qoff[i] = qoff[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(bars + 8 * s, 1);
    sm90::mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float dk_acc[kBlocks][32], dv_acc[kBlocks][32];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.f;

  const Walk<CAUSAL> walk{s_qoff, n_qt, k_off, false};
  int qt = walk.next_live(0);
  // Uniform over the CTA: with no live q tile nothing is loaded and the
  // tile's dk and dv are exactly zero.
  if (qt < n_qt) {
    const int q_row = bh * S;
    const uint32_t bh_hash = DROPOUT ? dropout_bh_base(seed, static_cast<uint32_t>(bhv[bh])) : 0u;
    // Stage s takes q tile t: Q and dO by TMA, lse and delta by bulk copy,
    // all on the stage's mbarrier (thread 0); the 64 dropout row bases are
    // hashed by threads 0-63.
    auto load_q = [&](int s, int t) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * s;
        const uint32_t sQ = base + 2 * T * (1 + s);
        sm90::mbar_arrive_expect_tx(bar, 2 * T + kStatBytes);
#pragma unroll
        for (int b = 0; b < kBlocks; ++b) {
          sm90::tma_load(sQ + b * kBlockBytes, &tq, bar, 64 * b, q_row + t * kTile);
          sm90::tma_load(sQ + T + b * kBlockBytes, &tdo, bar, 64 * b, q_row + t * kTile);
        }
        const size_t r = (size_t)q_row + t * kTile;
        sm90::bulk_load(stats + kStatBytes * s, lse + r, kStatBytes / 2, bar);
        sm90::bulk_load(stats + kStatBytes * s + kStatBytes / 2, delta + r, kStatBytes / 2, bar);
      }
      if (DROPOUT && tid < kTile)
        s_row_base[kTile * s + tid] =
            dropout_row_base(bh_hash, static_cast<uint32_t>(s_qoff[t] + tid));
    };
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(kv_bar, 2 * T);
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        sm90::tma_load(sK + b * kBlockBytes, &tk, kv_bar, 64 * b, (int)row0);
        sm90::tma_load(sV + b * kBlockBytes, &tv, kv_bar, 64 * b, (int)row0);
      }
    }
    int qt_load = qt;  // every thread's producer cursor, kStages live tiles ahead
    for (int s = 0; s < kStages && qt_load < n_qt; ++s) {
      load_q(s, qt_load);
      qt_load = walk.next_live(qt_load + 1);
    }
    if (DROPOUT) __syncthreads();  // the first row bases

    // The thread's two fragment rows are keys.
    int keys[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) keys[h] = k_off + sm90::frag_row(tid, h);
    const float sl2 = scale * kLog2e;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; qt < n_qt; ++it) {
      const int s = it % kStages;
      const uint32_t sQ = base + 2 * T * (1 + s);
      const uint32_t sdO = sQ + T;
      sm90::mbar_wait(bars + 8 * s, (it / kStages) & 1);

      // S^T = K . Q^T and dP^T = V . dO^T, one commit group.
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      sm90::wgmma_fence();
      issue_ss<D>(st, sK, sQ);
      issue_ss<D>(dpt, sV, sdO);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // p^T, its dropped form and ds^T on the transposed fragment: a
      // thread's rows are keys, its columns q rows, so lse, delta, the row
      // base and the causal test follow the column.
      const int q_off = s_qoff[qt];
      const bool diag = CAUSAL && q_off < k_off + kTile - 1;  // some element is masked
      const float* s_lse = s_stats + 2 * kTile * s;
      const float* s_delta = s_lse + kTile;
      const uint32_t* s_rb = s_row_base + kTile * s;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = sm90::frag_col(tid, j);  // q row in the tile (and c + 1)
        const float2 l2 = *reinterpret_cast<const float2*>(s_lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(s_delta + c);
        uint2 rb2 = make_uint2(0u, 0u);
        if (DROPOUT) rb2 = *reinterpret_cast<const uint2*>(s_rb + c);
        const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dlt[2] = {d2.x, d2.y};
        const uint32_t rb[2] = {rb2.x, rb2.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = sm90::fast_exp2(fmaf(st[i], sl2, -lse2[e]));
            if (diag && q_off + c + e < keys[h]) p = 0.f;
            float d = dpt[i];
            pd[e] = p;
            if (DROPOUT) {
              const bool keep = dropout_keep(rb[e], static_cast<uint32_t>(keys[h]), threshold);
              pd[e] = keep ? p * inv_keep : 0.f;
              d = keep ? d * inv_keep : 0.f;
            }
            ds[e] = p * (d - dlt[e]) * scale;
          }
          pa[j / 2][2 * (j % 2) + h] = sm90::pack_bf16(pd[0], pd[1]);
          da[j / 2][2 * (j % 2) + h] = sm90::pack_bf16(ds[0], ds[1]);
        }
      }

      // dV += P^T . dO and dK += dS^T . Q, dO and Q read MN-major.
      fence_all(dv_acc);
      fence_all(dk_acc);
      sm90::wgmma_fence();
      issue_rs<D>(dv_acc, pa, sdO);
      issue_rs<D>(dk_acc, da, sQ);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      fence_all(dv_acc);
      fence_all(dk_acc);

      // Every warp has finished reading stage s: refill it.
      __syncthreads();
      if (qt_load < n_qt) {
        load_q(s, qt_load);
        qt_load = walk.next_live(qt_load + 1);
      }
      qt = walk.next_live(qt + 1);
    }
  }
  store_tile<D>(dk, row0, dk_acc, tid);
  store_tile<D>(dv, row0, dv_acc, tid);
}

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  const int *qoff, *koff, *bhv;
  int BH, S;
  float scale;
  uint32_t seed, threshold;
  float inv_keep;
  cudaStream_t stream;
};

// The tensor maps of q, k, v and dout, all (BH*S, D); the bulk copies of lse
// and delta need 16-byte-aligned rows.
template <int D>
cudaError_t make_maps(CUtensorMap (&maps)[4], const BwdArgs& a) {
  if (reinterpret_cast<uintptr_t>(a.lse) % 16 || reinterpret_cast<uintptr_t>(a.delta) % 16)
    return cudaErrorMisalignedAddress;
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  return sm90::make_tile_maps(maps, ptrs, a.BH * a.S, D);
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
cudaError_t launch_dq(const BwdArgs& a) {
  auto kern = flash_bwd_dq_kernel<D, CAUSAL, DROPOUT, OutT>;
  const int smem = smem_bytes<D, false>(a.S / kTile);
  CUtensorMap maps[4];
  cudaError_t e = make_maps<D>(maps, a);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.BH, a.S / kTile), kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<OutT*>(a.dq), a.qoff, a.koff, a.bhv, a.S,
      a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
cudaError_t launch_dkv(const BwdArgs& a) {
  auto kern = flash_bwd_dkv_kernel<D, CAUSAL, DROPOUT, OutT>;
  const int smem = smem_bytes<D, true>(a.S / kTile);
  CUtensorMap maps[4];
  cudaError_t e = make_maps<D>(maps, a);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.BH, a.S / kTile), kThreads, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<OutT*>(a.dk), static_cast<OutT*>(a.dv),
      a.qoff, a.koff, a.bhv, a.S, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

// Template dispatch over (Dh, causal, dropout) for one of the two launchers
// and one output type.
template <template <int, bool, bool, typename> class Launch, typename OutT>
cudaError_t dispatch_out(int Dh, int causal, int dropout, const BwdArgs& a) {
#define FLASH_BWD_CASE(D)                                                     \
  if (Dh == D) {                                                              \
    if (causal && dropout) return Launch<D, true, true, OutT>::run(a);        \
    if (causal) return Launch<D, true, false, OutT>::run(a);                  \
    if (dropout) return Launch<D, false, true, OutT>::run(a);                 \
    return Launch<D, false, false, OutT>::run(a);                             \
  }
  FLASH_BWD_CASE(64)
  FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

template <template <int, bool, bool, typename> class Launch>
cudaError_t dispatch(int Dh, int causal, int dropout, int out_fp32, const BwdArgs& a) {
  return out_fp32 ? dispatch_out<Launch, float>(Dh, causal, dropout, a)
                  : dispatch_out<Launch, bf16>(Dh, causal, dropout, a);
}

template <int D, bool C, bool DR, typename OutT>
struct DqLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dq<D, C, DR, OutT>(a); }
};

template <int D, bool C, bool DR, typename OutT>
struct DkvLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dkv<D, C, DR, OutT>(a); }
};

}  // namespace bwd
}  // namespace flash

// C entries, bound with ctypes. q, k, v, dout: (BH, S, Dh) bf16 contiguous;
// lse, delta: (BH, S) fp32, 16-byte aligned; qoff/koff: (S/64,) int32 global
// tile bases; bhv: (BH,) int32 global batch*head ids. Outputs are (BH, S,
// Dh), bf16 or, with out_fp32, fp32. S must be a multiple of 64 and Dh 64
// or 128 (the Python wrappers check both). Each launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, const void* qoff,
                            const void* koff, const void* bhv, int BH, int S, int Dh,
                            int causal, int dropout, int out_fp32, float scale,
                            unsigned int seed, unsigned int threshold, float inv_keep,
                            void* stream) {
  flash::bwd::BwdArgs a{q,        k,     v,    dout,      lse,      delta,
                        dq,       nullptr, nullptr,
                        static_cast<const int*>(qoff), static_cast<const int*>(koff),
                        static_cast<const int*>(bhv),
                        BH,       S,     scale, seed,     threshold, inv_keep,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      flash::bwd::dispatch<flash::bwd::DqLaunch>(Dh, causal, dropout, out_fp32, a));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const void* qoff, const void* koff, const void* bhv, int BH,
                             int S, int Dh, int causal, int dropout, int out_fp32, float scale,
                             unsigned int seed, unsigned int threshold, float inv_keep,
                             void* stream) {
  flash::bwd::BwdArgs a{q,        k,     v,    dout,      lse,      delta,
                        nullptr,  dk,    dv,
                        static_cast<const int*>(qoff), static_cast<const int*>(koff),
                        static_cast<const int*>(bhv),
                        BH,       S,     scale, seed,     threshold, inv_keep,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      flash::bwd::dispatch<flash::bwd::DkvLaunch>(Dh, causal, dropout, out_fp32, a));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
