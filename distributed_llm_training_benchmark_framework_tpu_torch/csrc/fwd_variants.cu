// The five attention-forward variants of the head-dim-64 microbench, for
// Hopper (sm_90a), CUDA C++ written by hand.
//
// Replaces the Pallas TPU kernels of scripts/microbench_flash_fwd.py:
//   fwd_current      _fwd_kernel_current      softmax attention forward
//   fwd_headpair     _fwd_kernel_headpair     the same, two heads per program
//   fwd_kt           _fwd_kernel_kt           the same, k given as (BH, D, S)
//   fwd_matmul_only  _fwd_kernel_matmul_only  o = bf16(sum_k bf16(scale*q.k^T).v)
//   fwd_qscaled      _fwd_kernel_qscaled      the softmax with the scale folded
//                                             into q (q*bf16(scale) in bf16)
// All non-causal, no dropout, bf16 in and out, no lse, scale 1/sqrt(Dh).
//
// One kernel template serves all five: K1's non-causal, no-dropout loop
// (flash_fwd.cu) over 64-row tiles, 4 warps per head, each warp owning 16
// rows, so a row's max and sum are warp shuffles. Per k tile: s = q.k^T on
// the tensor cores (fp32), then
//   - softmax variants: online max / sum in fp32, p rounded to bf16, the fp32
//     accumulator rescaled and p.v added; out = bf16(acc / l) at the end;
//   - matmul-only: acc += bf16(s * scale).v, no max or sum; out = bf16(acc).
// The variants differ only where their Pallas kernels do:
//   - qscaled multiplies the q tile in shared memory once by bf16(scale)
//     (bf16 x bf16 -> bf16, as q_ref[0] * jnp.asarray(scale, q.dtype)) and
//     leaves the scores unscaled. At Dh 64 the scale is 2^-3, every product
//     and partial sum of q.k^T scales exactly, and the output is bit-equal
//     to fwd_current's;
//   - kt reads k as (BH, D, S): its tile is D rows of 64 contiguous columns
//     (load_tile_t), and the score product reads that tile row-major
//     (warp_mm_ab) instead of transposing a (64, D) tile;
//   - headpair runs 8 warps per CTA, warps 0-3 on head 2p and 4-7 on head
//     2p + 1 of the same q tile, each group with its own shared memory
//     (2 x 70 KB at Dh 64, 2 x 110 KB = 225,280 bytes at Dh 128, under the
//     232,448-byte limit). It is the Hopper reading of "two heads per
//     program": the two heads share a CTA, nothing else.
// The TPU's 1024-wide blocks, (bq, 8) lane-broadcast scratch and sequential
// k grid axis do not carry over: the k-tile loop runs inside the CTA and the
// grid is (S / 64, BH) (BH / 2 for headpair).
//
// Bound on the H100: 4*BH*S^2*Dh tensor FLOPs (bf16, 989 TFLOP/s); the
// softmax variants also take BH*S^2 exponentials (16 per SM per clock, about
// as long as the products at Dh 64); the bytes moved (q, k, v, out once) are
// a third of either at S 2048. This design does nothing about either bound
// yet: wmma 16x16x16 products staged through shared memory, no copy/compute
// overlap, one exp per score element in plain expf. It exists to split a
// forward's time between the products (matmul-only) and the softmax around
// them on this card; wgmma, TMA and warp specialisation come later.
#include "flash_tile.cuh"

namespace flash {

enum Variant { kCurrent = 0, kKt = 1, kMatmulOnly = 2, kQScaled = 3 };

// Shared memory of one head: q tile, v tile, k tile (transposed for kt);
// fp32 scores; bf16 probabilities; fp32 output accumulator. Every size is a
// multiple of 32 bytes, so each region (and the second head's copy) stays
// aligned.
template <int D, int V>
struct VariantSmem {
  static constexpr int k_bytes = V == kKt ? LayoutT<D>::bytes : Layout<D>::tile_bytes;
  static constexpr int bytes = 2 * Layout<D>::tile_bytes + k_bytes + Layout<D>::score_bytes +
                               Layout<D>::prob_bytes + Layout<D>::acc_bytes;
};

template <int D, int V, int HEADS>
__global__ void __launch_bounds__(kThreads * HEADS)
    fwd_variant_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                       float scale) {
  typedef Layout<D> L;
  constexpr bool SOFTMAX = V != kMatmulOnly;
  extern __shared__ __align__(128) unsigned char smem_all[];
  const int group = threadIdx.x / kThreads;  // which head of the CTA's HEADS
  unsigned char* smem = smem_all + group * VariantSmem<D, V>::bytes;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::tile_bytes);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::tile_bytes);
  unsigned char* rest = smem + 2 * L::tile_bytes + VariantSmem<D, V>::k_bytes;
  float* sS = reinterpret_cast<float*>(rest);
  bf16* sP = reinterpret_cast<bf16*>(rest + L::score_bytes);
  float* sO = reinterpret_cast<float*>(rest + L::score_bytes + L::prob_bytes);

  const int qt = blockIdx.x, bh = blockIdx.y * HEADS + group;
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRowsPerWarp;
  const int q0 = qt * kTile;
  const size_t base = (size_t)bh * S * D;

  load_tile<D>(sQ, q + base + (size_t)q0 * D, tid);
  zero_acc<D>(sO, tid);
  if (V == kQScaled) {
    __syncthreads();  // the whole q tile is in shared memory
    const float qs = __bfloat162float(__float2bfloat16(scale));
    for (int i = tid; i < kTile * D; i += kThreads) {
      bf16* x = sQ + (i / D) * L::ld_tile + i % D;
      // A bf16 x bf16 product is exact in fp32; one rounding back to bf16.
      *x = __float2bfloat16(__bfloat162float(*x) * qs);
    }
  }
  const float s_scale = V == kQScaled ? 1.f : scale;

  float m_row[kRowsPerWarp], l_row[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_row[rr] = kNegInf;
    l_row[rr] = 0.f;
  }

  for (int kt = 0; kt < S / kTile; ++kt) {
    __syncthreads();  // every warp is done reading the previous k/v tiles
    if (V == kKt)
      load_tile_t<D>(sK, k + base + (size_t)kt * kTile, S, tid);
    else
      load_tile<D>(sK, k + base + (size_t)kt * kTile * D, tid);
    load_tile<D>(sV, v + base + (size_t)kt * kTile * D, tid);
    __syncthreads();

    if (V == kKt)
      warp_mm_ab<D>(sS + r0 * L::ld_score, sQ + r0 * L::ld_tile, sK);
    else
      warp_mm_abt<D>(sS + r0 * L::ld_score, sQ + r0 * L::ld_tile, sK);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) s[h] = sS[r * L::ld_score + lane + 32 * h] * s_scale;
      if (!SOFTMAX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) sP[r * L::ld_prob + lane + 32 * h] = __float2bfloat16(s[h]);
        continue;
      }
      const float m_prev = m_row[rr];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = expf(s[h] - m_new);
        psum += p;
        sP[r * L::ld_prob + lane + 32 * h] = __float2bfloat16(p);
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
    bf16* dst = out + base + (size_t)(q0 + r) * D;
    for (int d = lane; d < D; d += 32) {
      const float acc = sO[r * L::ld_acc + d];
      dst[d] = __float2bfloat16(SOFTMAX ? acc / l_row[rr] : acc);
    }
  }
}

template <int D, int V, int HEADS>
cudaError_t launch_variant(const void* q, const void* k, const void* v, void* out, int BH,
                           int S, float scale, cudaStream_t stream) {
  auto kern = fwd_variant_kernel<D, V, HEADS>;
  constexpr int smem = HEADS * VariantSmem<D, V>::bytes;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S / kTile, BH / HEADS);
  kern<<<grid, kThreads * HEADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, scale);
  return cudaGetLastError();
}

template <int V, int HEADS>
int dispatch_variant(const void* q, const void* k, const void* v, void* out, int BH, int S,
                     int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch_variant<64, V, HEADS>(q, k, v, out, BH, S, scale, st);
  if (Dh == 128) return launch_variant<128, V, HEADS>(q, k, v, out, BH, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash

// C entries, bound with ctypes. q, v, out: (BH, S, Dh) bf16 contiguous; k
// the same, except (BH, Dh, S) for fwd_kt. S must be a multiple of 64, Dh 64
// or 128, and BH even for fwd_headpair (the Python wrappers check all
// three). `scale` is 1/sqrt(Dh). Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
#define FWD_VARIANT_ENTRY(NAME, V, HEADS)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, int BH, int S, \
                      int Dh, float scale, void* stream) {                                  \
    return flash::dispatch_variant<V, HEADS>(q, k, v, out, BH, S, Dh, scale, stream);       \
  }

FWD_VARIANT_ENTRY(fwd_current, flash::kCurrent, 1)
FWD_VARIANT_ENTRY(fwd_headpair, flash::kCurrent, 2)
FWD_VARIANT_ENTRY(fwd_kt, flash::kKt, 1)
FWD_VARIANT_ENTRY(fwd_matmul_only, flash::kMatmulOnly, 1)
FWD_VARIANT_ENTRY(fwd_qscaled, flash::kQScaled, 1)

extern "C" const char* fwd_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
