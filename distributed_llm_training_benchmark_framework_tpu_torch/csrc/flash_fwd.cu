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
//     skipped (with equal 64-row tiles: only k tiles kt <= qt run);
//   - dropout: the normalizer l sums the UN-dropped p while the accumulator
//     takes keep ? p / (1 - rate) : 0, with the coordinate-hash mask of
//     dropout_hash.cuh (bit-identical to JAX's);
//   - writes out = acc / l (bf16) and lse = m + log(l), with l == 0 -> 1.
//
// Bound on the H100: 4*BH*S^2*Dh tensor FLOPs (halved when causal), plus
// the hash's integer work per score element when rate > 0; the bytes moved
// (q, k, v, out once) are far below either at S = 2048.
// This design does little about that bound yet: wmma 16x16x16 products with
// operands and the accumulator staged in shared memory, 4 warps per CTA, no
// copy/compute overlap. wgmma, TMA and warp specialisation come later.
#include "dropout_hash.cuh"
#include "flash_tile.cuh"

namespace flash {

template <int D>
constexpr int fwd_smem_bytes() {
  // q, k, v tiles; fp32 scores; bf16 probabilities; fp32 output accumulator.
  return 3 * Layout<D>::tile_bytes + Layout<D>::score_bytes + Layout<D>::prob_bytes +
         Layout<D>::acc_bytes;
}

template <int D, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, float scale, uint32_t seed,
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
  const int q0 = qt * kTile;
  const size_t base = (size_t)bh * S * D;

  load_tile<D>(sQ, q + base + (size_t)q0 * D, tid);
  zero_acc<D>(sO, tid);
  const uint32_t bh_base = DROPOUT ? dropout_bh_base(seed, (uint32_t)bh) : 0u;

  // Row statistics of this warp's 16 rows; every lane holds all of them.
  float m_row[kRowsPerWarp], l_row[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_row[rr] = kNegInf;
    l_row[rr] = 0.f;
  }

  const int n_kt = CAUSAL ? qt + 1 : S / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done reading the previous k/v tiles
    load_tile<D>(sK, k + base + (size_t)kt * kTile * D, tid);
    load_tile<D>(sV, v + base + (size_t)kt * kTile * D, tid);
    __syncthreads();

    warp_mm_abt<D>(sS + r0 * L::ld_score, sQ + r0 * L::ld_tile, sK);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const int row = q0 + r;
      float s[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        s[h] = sS[r * L::ld_score + c] * scale;
        live[h] = !CAUSAL || row >= kt * kTile + c;
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
          p_acc = dropout_keep(row_base, (uint32_t)(kt * kTile + c), threshold)
                      ? p * inv_keep
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
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = r0 + rr;
    const float l_safe = l_row[rr] == 0.f ? 1.f : l_row[rr];
    bf16* dst = out + base + (size_t)(q0 + r) * D;
    for (int d = lane; d < D; d += 32)
      dst[d] = __float2bfloat16(sO[r * L::ld_acc + d] / l_safe);
    if (lane == 0) lse[(size_t)bh * S + q0 + r] = m_row[rr] + logf(l_safe);
  }
}

template <int D, bool CAUSAL, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int BH, int S, float scale, uint32_t seed, uint32_t threshold,
                       float inv_keep, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, CAUSAL, DROPOUT>;
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S / kTile, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_fwd(int causal, int dropout, const void* q, const void* k,
                         const void* v, void* out, void* lse, int BH, int S, float scale,
                         uint32_t seed, uint32_t threshold, float inv_keep,
                         cudaStream_t st) {
  if (causal && dropout)
    return launch_fwd<D, true, true>(q, k, v, out, lse, BH, S, scale, seed, threshold,
                                     inv_keep, st);
  if (causal)
    return launch_fwd<D, true, false>(q, k, v, out, lse, BH, S, scale, seed, threshold,
                                      inv_keep, st);
  if (dropout)
    return launch_fwd<D, false, true>(q, k, v, out, lse, BH, S, scale, seed, threshold,
                                      inv_keep, st);
  return launch_fwd<D, false, false>(q, k, v, out, lse, BH, S, scale, seed, threshold,
                                     inv_keep, st);
}

}  // namespace flash

// C entry, bound with ctypes. q, k, v, out: (BH, S, Dh) bf16 contiguous;
// lse: (BH, S) fp32. S must be a multiple of 64 and Dh 64 or 128 (the
// Python wrapper checks both). Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int S, int Dh, int causal, int dropout, float scale,
                         unsigned int seed, unsigned int threshold, float inv_keep,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return flash::dispatch_fwd<64>(causal, dropout, q, k, v, out, lse, BH, S, scale, seed,
                                   threshold, inv_keep, st);
  if (Dh == 128)
    return flash::dispatch_fwd<128>(causal, dropout, q, k, v, out, lse, BH, S, scale, seed,
                                    threshold, inv_keep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
