// Flash-attention backward for Hopper (sm_90a), CUDA C++ written by hand:
// two kernels, no atomics, the same split as the JAX package.
//
// flash_bwd_dq_kernel replaces the Pallas TPU kernel _bwd_dq_kernel and
// flash_bwd_dkv_kernel replaces _bwd_dkv_kernel
// (distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py,
// launched there by _flash_bwd_rule). Both recompute the probabilities of a
// (64 q rows, 64 k cols) tile from the saved lse,
//   p  = exp(s * scale - lse)            (masked by global position if causal)
//   dp = dO . v^T, dropped and rescaled with the forward's coordinate mask
//   ds = p * (dp - delta) * scale        (delta = rowsum(dO * out), from torch)
// and accumulate in fp32:
//   dq kernel:  one CTA per (batch*head, q tile), looping over k tiles,
//               dq += ds . k;
//   dkv kernel: one CTA per (batch*head, k tile), looping over q tiles,
//               dv += (D*p)^T . dO and dk += ds^T . q.
// p (dropped) and ds are rounded to bf16 before their products, as in JAX.
// Like the Pallas kernels, both take per-tile global bases for rows (qoff)
// and columns (koff) and a global batch*head vector (bhv), so that causal
// masking and the dropout hash see absolute coordinates; plain flash passes
// identity vectors, ring attention (ops/ring_attention.py) the bases of the
// block that sits at this hop. A tile is skipped, in either loop, when its
// last row lies before its first column, so a block wholly in the q shard's
// future costs no products. The output type is a template parameter: bf16
// for flash (the JAX launches in flash_attention.py write the input dtype)
// and fp32 for the ring (_block_bwd_kernel in ring_attention.py writes fp32
// partials that the ring sums over its hops before one cast).
//
// Bound on the H100: 6*BH*S^2*Dh tensor FLOPs for dq (s, dp, dq products)
// and 8*BH*S^2*Dh for dk/dv, halved when causal, plus the hash's integer
// work per score element when rate > 0. This first design does little
// about it: wmma 16x16x16 products staged through shared memory, 4 warps
// per CTA, fp32 accumulators in shared memory (the dk/dv pair at Dh = 128
// is 64 KB, beyond what 128 threads' registers hold), no copy/compute
// overlap.
#include "dropout_hash.cuh"
#include "flash_tile.cuh"

namespace flash {

template <int D>
constexpr int dq_smem_bytes() {
  // q, dO, k, v tiles; fp32 s and dp; bf16 ds; fp32 dq accumulator.
  return 4 * Layout<D>::tile_bytes + 2 * Layout<D>::score_bytes + Layout<D>::prob_bytes +
         Layout<D>::acc_bytes;
}

template <int D>
constexpr int dkv_smem_bytes() {
  // k, v, q, dO tiles; fp32 s^T and dp^T; bf16 (D*p)^T and ds^T; fp32 dk and
  // dv accumulators; per-q-row lse, delta and dropout row base.
  return 4 * Layout<D>::tile_bytes + 2 * Layout<D>::score_bytes +
         2 * Layout<D>::prob_bytes + 2 * Layout<D>::acc_bytes + 3 * kTile * 4;
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        OutT* __restrict__ dq, const int* __restrict__ qoff,
                        const int* __restrict__ koff, const int* __restrict__ bhv, int S,
                        float scale, uint32_t seed, uint32_t threshold, float inv_keep) {
  typedef Layout<D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::tile_bytes);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::tile_bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * L::tile_bytes);
  float* sS = reinterpret_cast<float*>(smem + 4 * L::tile_bytes);
  float* sdP = reinterpret_cast<float*>(smem + 4 * L::tile_bytes + L::score_bytes);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * L::tile_bytes + 2 * L::score_bytes);
  float* sAcc = reinterpret_cast<float*>(smem + 4 * L::tile_bytes + 2 * L::score_bytes +
                                         L::prob_bytes);

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRowsPerWarp;
  const size_t base = (size_t)bh * S * D;
  const int q_off = qoff[qt];

  load_tile<D>(sQ, q + base + (size_t)qt * kTile * D, tid);
  load_tile<D>(sdO, dout + base + (size_t)qt * kTile * D, tid);
  zero_acc<D>(sAcc, tid);

  const uint32_t bh_base = DROPOUT ? dropout_bh_base(seed, (uint32_t)bhv[bh]) : 0u;
  float lse_row[kRowsPerWarp], delta_row[kRowsPerWarp];
  uint32_t rb_row[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const size_t i = (size_t)bh * S + qt * kTile + r0 + rr;
    lse_row[rr] = lse[i];
    delta_row[rr] = delta[i];
    rb_row[rr] = DROPOUT ? dropout_row_base(bh_base, (uint32_t)(q_off + r0 + rr)) : 0u;
  }

  for (int kt = 0; kt < S / kTile; ++kt) {
    const int k_off = koff[kt];
    if (CAUSAL && q_off + kTile - 1 < k_off) continue;  // tile wholly masked
    __syncthreads();
    load_tile<D>(sK, k + base + (size_t)kt * kTile * D, tid);
    load_tile<D>(sV, v + base + (size_t)kt * kTile * D, tid);
    __syncthreads();

    warp_mm_abt<D>(sS + r0 * L::ld_score, sQ + r0 * L::ld_tile, sK);
    warp_mm_abt<D>(sdP + r0 * L::ld_score, sdO + r0 * L::ld_tile, sV);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const int row = q_off + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int col = k_off + c;
        const bool live = !CAUSAL || row >= col;
        float s = sS[r * L::ld_score + c] * scale;
        if (!live) s = kNegInf;
        float p = expf(s - lse_row[rr]);
        if (!live) p = 0.f;
        float dp = sdP[r * L::ld_score + c];
        if (DROPOUT)
          dp = dropout_keep(rb_row[rr], (uint32_t)col, threshold) ? dp * inv_keep : 0.f;
        sdS[r * L::ld_prob + c] = __float2bfloat16(p * (dp - delta_row[rr]) * scale);
      }
    }
    __syncwarp();
    warp_mm_ab_acc<D>(sAcc + r0 * L::ld_acc, sdS + r0 * L::ld_prob, sK);
  }
  __syncthreads();
  store_rows<D>(dq + base + (size_t)qt * kTile * D, sAcc, r0, lane);
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         OutT* __restrict__ dk, OutT* __restrict__ dv,
                         const int* __restrict__ qoff, const int* __restrict__ koff,
                         const int* __restrict__ bhv, int S, float scale, uint32_t seed,
                         uint32_t threshold, float inv_keep) {
  typedef Layout<D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* sK = reinterpret_cast<bf16*>(p);
  p += L::tile_bytes;
  bf16* sV = reinterpret_cast<bf16*>(p);
  p += L::tile_bytes;
  bf16* sQ = reinterpret_cast<bf16*>(p);
  p += L::tile_bytes;
  bf16* sdO = reinterpret_cast<bf16*>(p);
  p += L::tile_bytes;
  float* sST = reinterpret_cast<float*>(p);  // (k row, q col) scores
  p += L::score_bytes;
  float* sdPT = reinterpret_cast<float*>(p);
  p += L::score_bytes;
  bf16* sPT = reinterpret_cast<bf16*>(p);  // dropped p, transposed
  p += L::prob_bytes;
  bf16* sdST = reinterpret_cast<bf16*>(p);
  p += L::prob_bytes;
  float* sdK = reinterpret_cast<float*>(p);
  p += L::acc_bytes;
  float* sdV = reinterpret_cast<float*>(p);
  p += L::acc_bytes;
  float* sLse = reinterpret_cast<float*>(p);
  float* sDelta = sLse + kTile;
  uint32_t* sRowBase = reinterpret_cast<uint32_t*>(sDelta + kTile);

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRowsPerWarp;
  const size_t base = (size_t)bh * S * D;
  const int k_off = koff[kt];

  load_tile<D>(sK, k + base + (size_t)kt * kTile * D, tid);
  load_tile<D>(sV, v + base + (size_t)kt * kTile * D, tid);
  zero_acc<D>(sdK, tid);
  zero_acc<D>(sdV, tid);
  const uint32_t bh_base = DROPOUT ? dropout_bh_base(seed, (uint32_t)bhv[bh]) : 0u;

  for (int qt = 0; qt < S / kTile; ++qt) {
    const int q_off = qoff[qt];
    if (CAUSAL && q_off + kTile - 1 < k_off) continue;  // tile wholly masked
    __syncthreads();
    load_tile<D>(sQ, q + base + (size_t)qt * kTile * D, tid);
    load_tile<D>(sdO, dout + base + (size_t)qt * kTile * D, tid);
    if (tid < kTile) {
      const size_t i = (size_t)bh * S + qt * kTile + tid;
      sLse[tid] = lse[i];
      sDelta[tid] = delta[i];
      sRowBase[tid] = DROPOUT ? dropout_row_base(bh_base, (uint32_t)(q_off + tid)) : 0u;
    }
    __syncthreads();

    warp_mm_abt<D>(sST + r0 * L::ld_score, sK + r0 * L::ld_tile, sQ);
    warp_mm_abt<D>(sdPT + r0 * L::ld_score, sV + r0 * L::ld_tile, sdO);
    __syncwarp();

#pragma unroll 4
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int j = r0 + rr;  // k row within the tile
      const int col = k_off + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;  // q row within the tile
        const bool live = !CAUSAL || q_off + i >= col;
        float s = sST[j * L::ld_score + i] * scale;
        if (!live) s = kNegInf;
        float pr = expf(s - sLse[i]);
        if (!live) pr = 0.f;
        float dp = sdPT[j * L::ld_score + i];
        float pd = pr;
        if (DROPOUT) {
          const bool keep = dropout_keep(sRowBase[i], (uint32_t)col, threshold);
          pd = keep ? pr * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        sPT[j * L::ld_prob + i] = __float2bfloat16(pd);
        sdST[j * L::ld_prob + i] = __float2bfloat16(pr * (dp - sDelta[i]) * scale);
      }
    }
    __syncwarp();
    warp_mm_ab_acc<D>(sdV + r0 * L::ld_acc, sPT + r0 * L::ld_prob, sdO);
    warp_mm_ab_acc<D>(sdK + r0 * L::ld_acc, sdST + r0 * L::ld_prob, sQ);
  }
  __syncthreads();
  store_rows<D>(dk + base + (size_t)kt * kTile * D, sdK, r0, lane);
  store_rows<D>(dv + base + (size_t)kt * kTile * D, sdV, r0, lane);
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

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
cudaError_t launch_dq(const BwdArgs& a) {
  auto kern = flash_bwd_dq_kernel<D, CAUSAL, DROPOUT, OutT>;
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.S / kTile, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<OutT*>(a.dq), a.qoff, a.koff, a.bhv, a.S, a.scale, a.seed, a.threshold,
      a.inv_keep);
  return cudaGetLastError();
}

template <int D, bool CAUSAL, bool DROPOUT, typename OutT>
cudaError_t launch_dkv(const BwdArgs& a) {
  auto kern = flash_bwd_dkv_kernel<D, CAUSAL, DROPOUT, OutT>;
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.S / kTile, a.BH), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<OutT*>(a.dk), static_cast<OutT*>(a.dv), a.qoff, a.koff, a.bhv, a.S,
      a.scale, a.seed, a.threshold, a.inv_keep);
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

}  // namespace flash

// C entries, bound with ctypes. q, k, v, dout: (BH, S, Dh) bf16 contiguous;
// lse, delta: (BH, S) fp32; qoff/koff: (S/64,) int32 global tile bases;
// bhv: (BH,) int32 global batch*head ids. Outputs are (BH, S, Dh), bf16 or,
// with out_fp32, fp32. Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, const void* qoff,
                            const void* koff, const void* bhv, int BH, int S, int Dh,
                            int causal, int dropout, int out_fp32, float scale,
                            unsigned int seed, unsigned int threshold, float inv_keep,
                            void* stream) {
  flash::BwdArgs a{q,        k,     v,    dout,      lse,      delta,
                   dq,       nullptr, nullptr,
                   static_cast<const int*>(qoff), static_cast<const int*>(koff),
                   static_cast<const int*>(bhv),
                   BH,       S,     scale, seed,     threshold, inv_keep,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      flash::dispatch<flash::DqLaunch>(Dh, causal, dropout, out_fp32, a));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const void* qoff, const void* koff, const void* bhv, int BH,
                             int S, int Dh, int causal, int dropout, int out_fp32, float scale,
                             unsigned int seed, unsigned int threshold, float inv_keep,
                             void* stream) {
  flash::BwdArgs a{q,        k,     v,    dout,      lse,      delta,
                   nullptr,  dk,    dv,
                   static_cast<const int*>(qoff), static_cast<const int*>(koff),
                   static_cast<const int*>(bhv),
                   BH,       S,     scale, seed,     threshold, inv_keep,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      flash::dispatch<flash::DkvLaunch>(Dh, causal, dropout, out_fp32, a));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
