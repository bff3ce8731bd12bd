// One ring-attention block, flash-attention forward for Hopper (sm_90a),
// CUDA C++ written by hand.
//
// Replaces the Pallas TPU kernel _ring_fwd_block_kernel
// (distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py),
// launched there by _block_stats_kernel once per ring hop.
//
// Same tile math as flash_fwd_kernel (flash_fwd.cu), and the same mainloop
// (flash_fwd_sm90.cuh): per (batch*head, 64-row q tile), an online softmax
// over the block's k tiles with fp32 running max m, running sum l and output
// accumulator over bf16 operands, scale 1/sqrt(Dh), the normalizer summing
// the UN-dropped p and the accumulator the dropped p / (1 - rate). It
// differs in three ways, as the Pallas kernel does:
//   - rows and columns are GLOBAL positions: qoff / koff hold the global
//     base of every 64-row q / k tile of this block (a shard's offset, or the
//     bases of the two zigzag half-chunks), and bhv the global batch*head id
//     of every grid row, so the causal mask and the dropout hash see the
//     coordinates flash sees over the whole sequence; the mask is evaluated
//     only on tiles that reach past some row's diagonal;
//   - a k tile is skipped, never loaded, when it lies wholly in the q tile's
//     future (q_off + 63 < k_off), so a block wholly in the shard's future
//     costs no products, issues no copy, and still writes m = NEG_INF,
//     l = 0, o = 0 for every row (from registers: no shared memory is read
//     after the early exit, so no barrier is owed to other warps' writes);
//   - nothing is normalized: it writes fp32 m, l (BH, S) as plain rows and
//     the fp32 accumulator o (BH, S, Dh); the ring merges the blocks outside
//     (ops/ring_attention.py). The TPU's (8, S) sublane broadcast of m and l
//     is left out.
//
// Bound on the H100: 4*BH*Dh tensor FLOPs per live score element (a block
// with the causal mask keeps only its live part), plus the hash's integer
// work per live element when rate > 0; the bytes moved (q, k, v in bf16, o
// in fp32, m and l once) are far below that at Sl = 2048. The design is
// K1's: TMA-fed K/V stages, wgmma for both products, S, P and O in
// registers.
#include "dropout_hash.cuh"
#include "flash_fwd_sm90.cuh"

namespace flash {

// K4's coordinates: global tile bases from qoff / koff; a k tile is live
// unless causal and wholly in the q tile's future.
template <bool CAUSAL>
struct RingCoords {
  const int* __restrict__ koff;
  int q_off, n_kt;
  __device__ int k_off(int kt) const { return koff[kt]; }
  __device__ int next_live(int kt) const {
    if (CAUSAL)
      while (kt < n_kt && q_off + kTile - 1 < koff[kt]) ++kt;
    return kt;
  }
};

template <int D, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(sm90::kThreads)
    ring_fwd_block_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, float* __restrict__ m_out,
                          float* __restrict__ l_out, float* __restrict__ o_out,
                          const int* __restrict__ qoff, const int* __restrict__ koff,
                          const int* __restrict__ bhv, int S, float scale, uint32_t seed,
                          uint32_t threshold, float inv_keep) {
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const RingCoords<CAUSAL> co{koff, qoff[qt], S / kTile};
  float o[D / 64][32], m[2], l[2];
  sm90::fwd_mainloop<D, CAUSAL, DROPOUT>(
      &tq, &tk, &tv, co, bh * S + qt * kTile, bh * S, scale,
      DROPOUT ? dropout_bh_base(seed, static_cast<uint32_t>(bhv[bh])) : 0u, threshold,
      inv_keep, o, m, l);

  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * S + qt * kTile + sm90::frag_row(tid, h);
    float* dst = o_out + row * D;
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * b + sm90::frag_col(tid, j)) =
            make_float2(o[b][4 * j + 2 * h], o[b][4 * j + 2 * h + 1]);
    if (tid % 4 == 0) {
      m_out[row] = m[h] == kNegInf ? kNegInf : m[h] * scale;
      l_out[row] = l[h];
    }
  }
}

template <int D, bool CAUSAL, bool DROPOUT>
cudaError_t launch_ring_fwd(const void* q, const void* k, const void* v, void* m, void* l,
                            void* o, const int* qoff, const int* koff, const int* bhv, int BH,
                            int S, float scale, uint32_t seed, uint32_t threshold,
                            float inv_keep, cudaStream_t stream) {
  auto kern = ring_fwd_block_kernel<D, CAUSAL, DROPOUT>;
  constexpr int smem = sm90::smem_bytes<D>();
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  cudaError_t e = sm90::make_tile_maps(maps, ptrs, BH * S, D);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, S / kTile), sm90::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(o), qoff, koff, bhv, S, scale, seed, threshold, inv_keep);
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
