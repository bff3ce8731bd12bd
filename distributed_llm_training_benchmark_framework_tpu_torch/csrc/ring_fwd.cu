// One ring-attention block, flash-attention forward for Hopper (sm_90a),
// CUDA C++ written by hand.
//
// Replaces the Pallas TPU kernel _ring_fwd_block_kernel
// (distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py),
// launched there by _block_stats_kernel once per ring hop.
//
// Same tile math as flash_fwd_kernel (flash_fwd.cu): per (batch*head, 64-row
// q tile), an online softmax over the block's k tiles with fp32 running max
// m, running sum l and output accumulator over bf16 operands, scale
// 1/sqrt(Dh), the normalizer summing the UN-dropped p and the accumulator the
// dropped p / (1 - rate). It differs in three ways, as the Pallas kernel
// does:
//   - rows and columns are GLOBAL positions: qoff / koff hold the global
//     base of every 64-row q / k tile of this block (a shard's offset, or the
//     bases of the two zigzag half-chunks), and bhv the global batch*head id
//     of every grid row, so the causal mask and the dropout hash see the
//     coordinates flash sees over the whole sequence;
//   - a k tile is skipped when it lies wholly in the q tile's future
//     (q_off + 63 < k_off), so a block wholly in the shard's future costs no
//     products and still writes m = NEG_INF, l = 0, o = 0 for every row;
//   - nothing is normalized: it writes fp32 m, l (BH, S) as plain rows and
//     the fp32 accumulator o (BH, S, Dh); the ring merges the blocks outside
//     (ops/ring_attention.py). The TPU's (8, S) sublane broadcast of m and l
//     is left out.
//
// Bound on the H100: 4*BH*Dh tensor FLOPs per live score element (a block
// with the causal mask keeps only its live part), plus the hash's integer
// work per live element when rate > 0; the bytes moved (q, k, v in bf16, o
// in fp32, m and l once) are far below that at Sl = 2048. This first design
// shares K1's (flash_tile.cuh: wmma 16x16x16 products staged through shared
// memory, 4 warps per CTA each owning 16 rows, no copy/compute overlap) and
// does as little about the bound.
#include "dropout_hash.cuh"
#include "flash_tile.cuh"

namespace flash {

template <int D>
constexpr int ring_fwd_smem_bytes() {
  // q, k, v tiles; fp32 scores; bf16 probabilities; fp32 output accumulator.
  return 3 * Layout<D>::tile_bytes + Layout<D>::score_bytes + Layout<D>::prob_bytes +
         Layout<D>::acc_bytes;
}

template <int D, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    ring_fwd_block_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, float* __restrict__ m_out,
                          float* __restrict__ l_out, float* __restrict__ o,
                          const int* __restrict__ qoff, const int* __restrict__ koff,
                          const int* __restrict__ bhv, int S, float scale, uint32_t seed,
                          uint32_t threshold, float inv_keep) {
  typedef Layout<D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::tile_bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * L::tile_bytes);
  float* sS = reinterpret_cast<float*>(smem + 3 * L::tile_bytes);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * L::tile_bytes + L::score_bytes);
  float* sO = reinterpret_cast<float*>(smem + 3 * L::tile_bytes + L::score_bytes +
                                       L::prob_bytes);

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRowsPerWarp;
  const size_t base = (size_t)bh * S * D;
  const int q_off = qoff[qt];

  load_tile<D>(sQ, q + base + (size_t)qt * kTile * D, tid);
  zero_acc<D>(sO, tid);
  const uint32_t bh_base = DROPOUT ? dropout_bh_base(seed, (uint32_t)bhv[bh]) : 0u;

  // Row statistics of this warp's 16 rows; every lane holds all of them.
  float m_row[kRowsPerWarp], l_row[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_row[rr] = kNegInf;
    l_row[rr] = 0.f;
  }

  for (int kt = 0; kt < S / kTile; ++kt) {
    const int k_off = koff[kt];
    // Uniform over the CTA, so the barriers below stay matched.
    if (CAUSAL && q_off + kTile - 1 < k_off) continue;  // tile wholly masked
    __syncthreads();  // every warp is done reading the previous k/v tiles
    load_tile<D>(sK, k + base + (size_t)kt * kTile * D, tid);
    load_tile<D>(sV, v + base + (size_t)kt * kTile * D, tid);
    __syncthreads();

    warp_mm_abt<D>(sS + r0 * L::ld_score, sQ + r0 * L::ld_tile, sK);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const int row = q_off + r;
      float s[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        s[h] = sS[r * L::ld_score + c] * scale;
        live[h] = !CAUSAL || row >= k_off + c;
        if (!live[h]) s[h] = kNegInf;
      }
      const float m_prev = m_row[rr];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m_prev - m_new);
      const uint32_t row_base = DROPOUT ? dropout_row_base(bh_base, (uint32_t)row) : 0u;
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float p = expf(s[h] - m_new);
        if (!live[h]) p = 0.f;
        psum += p;
        float p_acc = p;
        if (DROPOUT)
          p_acc = dropout_keep(row_base, (uint32_t)(k_off + c), threshold) ? p * inv_keep
                                                                           : 0.f;
        sP[r * L::ld_prob + c] = __float2bfloat16(p_acc);
      }
      l_row[rr] = alpha * l_row[rr] + warp_sum(psum);
      m_row[rr] = m_new;
      for (int d = lane; d < D; d += 32) sO[r * L::ld_acc + d] *= alpha;
    }
    __syncwarp();
    warp_mm_ab_acc<D>(sO + r0 * L::ld_acc, sP + r0 * L::ld_prob, sV);
  }
  // The zeroed accumulator rows were written by other warps; when every k
  // tile was skipped no barrier has run since.
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = r0 + rr;
    const size_t row = (size_t)bh * S + (size_t)qt * kTile + r;
    float* dst = o + row * D;
    for (int d = lane; d < D; d += 32) dst[d] = sO[r * L::ld_acc + d];
    if (lane == 0) {
      m_out[row] = m_row[rr];
      l_out[row] = l_row[rr];
    }
  }
}

template <int D, bool CAUSAL, bool DROPOUT>
cudaError_t launch_ring_fwd(const void* q, const void* k, const void* v, void* m, void* l,
                            void* o, const int* qoff, const int* koff, const int* bhv, int BH,
                            int S, float scale, uint32_t seed, uint32_t threshold,
                            float inv_keep, cudaStream_t stream) {
  auto kern = ring_fwd_block_kernel<D, CAUSAL, DROPOUT>;
  constexpr int smem = ring_fwd_smem_bytes<D>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(S / kTile, BH), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(o), qoff, koff, bhv,
      S, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_ring_fwd(int causal, int dropout, const void* q, const void* k,
                              const void* v, void* m, void* l, void* o, const int* qoff,
                              const int* koff, const int* bhv, int BH, int S, float scale,
                              uint32_t seed, uint32_t threshold, float inv_keep,
                              cudaStream_t st) {
#define RING_FWD_LAUNCH(C, DR)                                                            \
  return launch_ring_fwd<D, C, DR>(q, k, v, m, l, o, qoff, koff, bhv, BH, S, scale, seed, \
                                   threshold, inv_keep, st)
  if (causal && dropout) RING_FWD_LAUNCH(true, true);
  if (causal) RING_FWD_LAUNCH(true, false);
  if (dropout) RING_FWD_LAUNCH(false, true);
  RING_FWD_LAUNCH(false, false);
#undef RING_FWD_LAUNCH
}

}  // namespace flash

// C entry, bound with ctypes. q, k, v: (BH, S, Dh) bf16 contiguous (one ring
// block: the shard's queries and the keys/values resident at this hop);
// qoff/koff: (S/64,) int32 global tile bases; bhv: (BH,) int32 global
// batch*head ids. Writes m, l: (BH, S) fp32 and the unnormalized o: (BH, S,
// Dh) fp32. S must be a multiple of 64 and Dh 64 or 128 (the Python wrapper
// checks both). Launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int ring_fwd_block(const void* q, const void* k, const void* v, void* m, void* l,
                              void* o, const void* qoff, const void* koff, const void* bhv,
                              int BH, int S, int Dh, int causal, int dropout, float scale,
                              unsigned int seed, unsigned int threshold, float inv_keep,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(qoff);
  const int* ko = static_cast<const int*>(koff);
  const int* bv = static_cast<const int*>(bhv);
  if (Dh == 64)
    return flash::dispatch_ring_fwd<64>(causal, dropout, q, k, v, m, l, o, qo, ko, bv, BH, S,
                                        scale, seed, threshold, inv_keep, st);
  if (Dh == 128)
    return flash::dispatch_ring_fwd<128>(causal, dropout, q, k, v, m, l, o, qo, ko, bv, BH, S,
                                         scale, seed, threshold, inv_keep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ring_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
