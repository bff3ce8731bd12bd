// Flash-attention forward for Hopper (sm_90a), CUDA C++ written by hand.
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel
// (distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py),
// launched there by _flash_forward.
//
// Computes, per (batch*head, 64-row q tile), the online-softmax attention
// over all k tiles with fp32 running max m, running sum l and output
// accumulator over bf16 operands, scale 1/sqrt(Dh):
//   - causal: mask by global position; k tiles wholly above the diagonal are
//     skipped (with equal 64-row tiles: only k tiles kt <= qt run), and only
//     the diagonal tile evaluates the mask;
//   - dropout: the normalizer l sums the UN-dropped p while the accumulator
//     takes keep ? p / (1 - rate) : 0, with the coordinate-hash mask of
//     dropout_hash.cuh (bit-identical to JAX's), keyed by (bh, row, col);
//   - writes out = acc / l (bf16) and lse = m + log(l), with l == 0 -> 1.
//
// Bound on the H100: 4*BH*S^2*Dh tensor FLOPs (halved when causal), plus
// the hash's integer work per score element when rate > 0; the bytes moved
// (q, k, v, out once) are far below either at S = 2048.
// Design: the shared Hopper mainloop of flash_fwd_sm90.cuh (TMA-fed K/V
// stages, wgmma for both products, scores, probabilities and the output
// accumulator in registers, the softmax on the accumulator fragment). The
// grid runs the q tiles of every head from the last (heaviest when causal)
// to the first, so the long causal tiles start in the first wave.
#include "dropout_hash.cuh"
#include "flash_fwd_sm90.cuh"

namespace flash {

// One (batch*head, q tile) of K1. BHV: the hash's batch*head id is
// bhv[blockIdx.x] (a head shard's global ids, which no single offset gives
// once B > 1) instead of blockIdx.x itself; the two kernels below are this
// body's two instances.
template <int D, bool CAUSAL, bool DROPOUT, bool BHV>
__device__ __forceinline__ void fwd_tile(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, bf16* __restrict__ out,
                                         float* __restrict__ lse, int S, float scale,
                                         uint32_t seed, uint32_t threshold, float inv_keep,
                                         const int* __restrict__ bhv) {
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  // Every k tile below the causal limit is live.
  const sm90::FlashCoords co{qt * kTile, CAUSAL ? qt + 1 : S / kTile};
  float o[D / 64][32], m[2], l[2];
  sm90::fwd_mainloop<D, CAUSAL, DROPOUT>(
      tq, tk, tv, co, bh * S + qt * kTile, bh * S, scale,
      DROPOUT ? dropout_bh_base(seed, static_cast<uint32_t>(BHV ? bhv[bh] : bh)) : 0u,
      threshold, inv_keep, o, m, l);

  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qt * kTile + sm90::frag_row(tid, h);
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    bf16* dst = out + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * b + sm90::frag_col(tid, j)) =
            __floats2bfloat162_rn(o[b][4 * j + 2 * h] / l_safe,
                                  o[b][4 * j + 2 * h + 1] / l_safe);
    if (tid % 4 == 0) {
      const float m_out = m[h] == kNegInf ? kNegInf : m[h] * scale;
      lse[(size_t)bh * S + row] = m_out + logf(l_safe);
    }
  }
}

template <int D, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(sm90::kThreads)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, float scale, uint32_t seed,
                     uint32_t threshold, float inv_keep) {
  fwd_tile<D, CAUSAL, DROPOUT, false>(&tq, &tk, &tv, out, lse, S, scale, seed, threshold,
                                      inv_keep, nullptr);
}

template <int D, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(sm90::kThreads)
    flash_fwd_bhv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                         float* __restrict__ lse, int S, float scale, uint32_t seed,
                         uint32_t threshold, float inv_keep, const int* __restrict__ bhv) {
  fwd_tile<D, CAUSAL, DROPOUT, true>(&tq, &tk, &tv, out, lse, S, scale, seed, threshold,
                                     inv_keep, bhv);
}

template <int D, bool CAUSAL, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       const int* bhv, int BH, int S, float scale, uint32_t seed,
                       uint32_t threshold, float inv_keep, cudaStream_t stream) {
  constexpr int smem = sm90::smem_bytes<D>();
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  cudaError_t e = sm90::make_tile_maps(maps, ptrs, BH * S, D);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, S / kTile);
  if (bhv) {
    auto kern = flash_fwd_bhv_kernel<D, CAUSAL, DROPOUT>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, sm90::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<bf16*>(out), static_cast<float*>(lse), S,
        scale, seed, threshold, inv_keep, bhv);
  } else {
    auto kern = flash_fwd_kernel<D, CAUSAL, DROPOUT>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, sm90::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], static_cast<bf16*>(out), static_cast<float*>(lse), S,
        scale, seed, threshold, inv_keep);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_fwd(int causal, int dropout, const void* q, const void* k,
                         const void* v, void* out, void* lse, const int* bhv, int BH, int S,
                         float scale, uint32_t seed, uint32_t threshold, float inv_keep,
                         cudaStream_t st) {
#define FLASH_FWD_LAUNCH(C, DR)                                                        \
  return launch_fwd<D, C, DR>(q, k, v, out, lse, bhv, BH, S, scale, seed, threshold, \
                              inv_keep, st)
  if (causal && dropout) FLASH_FWD_LAUNCH(true, true);
  if (causal) FLASH_FWD_LAUNCH(true, false);
  if (dropout) FLASH_FWD_LAUNCH(false, true);
  FLASH_FWD_LAUNCH(false, false);
#undef FLASH_FWD_LAUNCH
}

}  // namespace flash

// C entries, bound with ctypes. q, k, v, out: (BH, S, Dh) bf16 contiguous;
// lse: (BH, S) fp32. S must be a multiple of 64 and Dh 64 or 128 (the
// Python wrapper checks both). flash_fwd keys the hash by each grid row's
// own index (a contiguous offset rides in the seed); flash_fwd_bhv by
// bhv: (BH,) int32 global batch*head ids. Each launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
static int flash_fwd_entry(const void* q, const void* k, const void* v, void* out, void* lse,
                           const int* bhv, int BH, int S, int Dh, int causal, int dropout,
                           float scale, unsigned int seed, unsigned int threshold,
                           float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return flash::dispatch_fwd<64>(causal, dropout, q, k, v, out, lse, bhv, BH, S, scale,
                                   seed, threshold, inv_keep, st);
  if (Dh == 128)
    return flash::dispatch_fwd<128>(causal, dropout, q, k, v, out, lse, bhv, BH, S, scale,
                                    seed, threshold, inv_keep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int S, int Dh, int causal, int dropout, float scale,
                         unsigned int seed, unsigned int threshold, float inv_keep,
                         void* stream) {
  return flash_fwd_entry(q, k, v, out, lse, nullptr, BH, S, Dh, causal, dropout, scale, seed,
                         threshold, inv_keep, stream);
}

extern "C" int flash_fwd_bhv(const void* q, const void* k, const void* v, void* out,
                             void* lse, const void* bhv, int BH, int S, int Dh, int causal,
                             int dropout, float scale, unsigned int seed,
                             unsigned int threshold, float inv_keep, void* stream) {
  if (!bhv) return static_cast<int>(cudaErrorInvalidValue);
  return flash_fwd_entry(q, k, v, out, lse, static_cast<const int*>(bhv), BH, S, Dh, causal,
                         dropout, scale, seed, threshold, inv_keep, stream);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
