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
// Bound on the H100: 4*BH*S^2*Dh tensor FLOPs (bf16, 989 TFLOP/s); the
// softmax variants also take BH*S^2 exponentials (16 per SM per clock, about
// as long as the products at Dh 64); the bytes moved (q, k, v, out once) are
// a third of either at S 2048.
//
// All five run the Hopper forward mainloop of K1 and K4
// (flash_fwd_sm90.cuh: TMA-fed K/V stages, wgmma for both products, the
// scores, probabilities and output accumulator in registers), one warpgroup
// per head on one 64-row q tile, and walk the k tiles inside the CTA (the
// TPU's 1024-wide blocks and sequential k grid axis do not carry over). The
// four softmax variants run it at rate 0, non-causal, with an epilogue that
// writes out = bf16(o / l) and no lse (JAX's acc / l). Their arithmetic is
// K1's, so their output is K1's bit for bit:
//   - fwd_current is the loop's plain instance: one warpgroup per CTA on
//     one q tile of one head, k as (BH * S, D).
//   - fwd_kt reads k^T as a (BH * D, S) matrix: a k tile is D rows x 64 keys
//     loaded as D / 64 TMA boxes, and Q.K^T reads it through an MN-major
//     wgmma descriptor, as P.V reads V. No transposed copy is made; a stage
//     holds the bytes K1's does. This is the Hopper reading of feeding k
//     pre-transposed: the tensor core takes either major-ness at one rate.
//   - fwd_headpair puts two warpgroups in a CTA, on heads 2p and 2p + 1 of
//     the same q tile, each with its own shared-memory region, producer
//     thread and named barrier (82 KB at Dh 64, 162 KB at Dh 128). It is the
//     Hopper reading of "two contractions per pass": one warpgroup's softmax
//     can run under the other's products. The two run free: FA3's ping-pong
//     order (turns at the tensor cores handed over by named barriers) was
//     slower on the card (PERF.md).
//   - fwd_qscaled sets the loop's Q_SCALE: once the q tile has landed, the
//     warpgroup multiplies it in shared memory by bf16(scale) (bf16 x bf16
//     -> bf16, as q_ref[0] * jnp.asarray(scale, q.dtype)), fences those
//     writes over to the async proxy wgmma reads through, and runs the loop
//     with scale 1, the scores unscaled. At Dh 64 the scale is 2^-3, which
//     commutes with every rounding of the loop, so the output is
//     fwd_current's (and K1's) bit for bit. It has its own kernel,
//     fwd_qscaled_kernel, so the layout kernel's instances keep their names.
// fwd_matmul_only sets the loop's MATMUL_ONLY: per k tile, s = q.k^T (fp32),
// then o += bf16(s * scale).v, no mask, max, exponential or sum; out =
// bf16(o). It is fwd_current's loop less the softmax, so fwd_matmul_only
// beside fwd_current splits one design's forward into its products and its
// softmax. Its own kernel, fwd_matmul_kernel, keeps the other names as they
// are.
#include "flash_fwd_sm90.cuh"

namespace flash {

// Writes bf16(o / l) for the thread's two rows of the 64 x D tile whose
// first row is `dst` (row-major, D columns), l == 0 read as 1 (JAX's
// acc / l with its safe denominator; K8's loop leaves l at 0, so for K8 this
// is bf16(o)).
template <int D>
__device__ __forceinline__ void store_normalized(bf16* dst, int tid, const float (&o)[D / 64][32],
                                                 const float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    bf16* row = dst + (size_t)sm90::frag_row(tid, h) * D;
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * b + sm90::frag_col(tid, j)) =
            __floats2bfloat162_rn(o[b][4 * j + 2 * h] / l_safe, o[b][4 * j + 2 * h + 1] / l_safe);
  }
}

// WG warpgroups per CTA, warpgroup wg on batch*head WG * blockIdx.x + wg and
// q tile blockIdx.y; k as (BH * S, D), or as k^T (BH * D, S) with K_T.
template <int D, bool K_T, int WG>
__global__ void __launch_bounds__(WG * sm90::kThreads)
    fwd_layout_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int S,
                      float scale) {
  const int bh = WG * blockIdx.x + threadIdx.x / sm90::kThreads;
  const int qt = blockIdx.y;
  const sm90::FlashCoords co{qt * kTile, S / kTile};
  float o[D / 64][32], m[2], l[2];
  sm90::fwd_mainloop<D, false, false, K_T, WG>(
      &tq, &tk, &tv, co, bh * S + qt * kTile, bh * S, scale, 0u, 0u, 1.f, o, m, l, bh * D);
  store_normalized<D>(out + ((size_t)bh * S + qt * kTile) * D,
                      threadIdx.x % sm90::kThreads, o, l);
}

// K9: K5's kernel with the mainloop's Q pass; q_scale scales q in bf16 and
// the scores are left unscaled.
template <int D>
__global__ void __launch_bounds__(sm90::kThreads)
    fwd_qscaled_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int S,
                       float q_scale) {
  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const sm90::FlashCoords co{qt * kTile, S / kTile};
  float o[D / 64][32], m[2], l[2];
  sm90::fwd_mainloop<D, false, false, false, 1, true>(
      &tq, &tk, &tv, co, bh * S + qt * kTile, bh * S, 1.f, 0u, 0u, 1.f, o, m, l, 0, q_scale);
  store_normalized<D>(out + ((size_t)bh * S + qt * kTile) * D, threadIdx.x, o, l);
}

// K8: K5's kernel with the mainloop's MATMUL_ONLY; o is left unnormalized.
template <int D>
__global__ void __launch_bounds__(sm90::kThreads)
    fwd_matmul_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int S,
                      float scale) {
  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const sm90::FlashCoords co{qt * kTile, S / kTile};
  float o[D / 64][32], m[2], l[2];
  sm90::fwd_mainloop<D, false, false, false, 1, false, true>(
      &tq, &tk, &tv, co, bh * S + qt * kTile, bh * S, scale, 0u, 0u, 1.f, o, m, l);
  store_normalized<D>(out + ((size_t)bh * S + qt * kTile) * D, threadIdx.x, o, l);
}

// The kernel launch_layout launches: the layout kernel, or K9's or K8's
// (both with K_T false and WG 1).
enum Kernel { kLayout, kQScaled, kMatmulOnly };

template <int D, bool K_T, int WG, Kernel KERN>
cudaError_t launch_layout(const void* q, const void* k, const void* v, void* out, int BH, int S,
                          float scale, cudaStream_t stream) {
  auto kern = fwd_layout_kernel<D, K_T, WG>;
  if constexpr (KERN == kQScaled) kern = fwd_qscaled_kernel<D>;
  if constexpr (KERN == kMatmulOnly) kern = fwd_matmul_kernel<D>;
  constexpr int smem = sm90::smem_bytes<D, WG>();
  CUtensorMap maps[3];
  cudaError_t e = sm90::make_tile_map(&maps[0], q, BH * S, D);
  if (e == cudaSuccess)
    e = K_T ? sm90::make_tile_map(&maps[1], k, BH * D, S)
            : sm90::make_tile_map(&maps[1], k, BH * S, D);
  if (e == cudaSuccess) e = sm90::make_tile_map(&maps[2], v, BH * S, D);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH / WG, S / kTile), WG * sm90::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), S, scale);
  return cudaGetLastError();
}

template <bool K_T, int WG, Kernel KERN = kLayout>
int dispatch_layout(const void* q, const void* k, const void* v, void* out, int BH, int S,
                    int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch_layout<64, K_T, WG, KERN>(q, k, v, out, BH, S, scale, st);
  if (Dh == 128) return launch_layout<128, K_T, WG, KERN>(q, k, v, out, BH, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash

// C entries, bound with ctypes. q, v, out: (BH, S, Dh) bf16 contiguous; k
// the same, except (BH, Dh, S) for fwd_kt. S must be a multiple of 64, Dh 64
// or 128, and BH even for fwd_headpair (the Python wrappers check all
// three). `scale` is 1/sqrt(Dh). Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
#define FWD_ENTRY(NAME, ...)                                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, int BH, int S, \
                      int Dh, float scale, void* stream) {                                  \
    return flash::__VA_ARGS__(q, k, v, out, BH, S, Dh, scale, stream);                      \
  }

FWD_ENTRY(fwd_current, dispatch_layout<false, 1>)
FWD_ENTRY(fwd_headpair, dispatch_layout<false, 2>)
FWD_ENTRY(fwd_kt, dispatch_layout<true, 1>)
FWD_ENTRY(fwd_matmul_only, dispatch_layout<false, 1, flash::kMatmulOnly>)
FWD_ENTRY(fwd_qscaled, dispatch_layout<false, 1, flash::kQScaled>)

extern "C" const char* fwd_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
