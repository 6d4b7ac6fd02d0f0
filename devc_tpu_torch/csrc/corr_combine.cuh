// The merge of K1's key-range splits, shared by the fp32 kernel
// (corr_fwd.cu) and the bf16 one (corr_fwd_bf16.cu).
//
// Where too few query tiles fill the card, K1 splits the keys into ranges
// of whole tiles, one block per (query tile, range), and each block writes
// its rows' partial (m, l, acc[3]) to part[split][row]. This kernel merges
// them in split order, exactly as the keys-sharded path does
// (devc_tpu/parallel/sharded_corr.py): every partial is rescaled by
// exp((m_s - m) * inv_t), formed in fp32 and fed to expf, so a tie at the
// row max keeps weight exactly 1 and the merge is deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace devc {

constexpr int kCorrV = 3;              // the warped values' width
constexpr int kCorrPart = 2 + kCorrV;  // a partial result: m, l, acc[3]

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// out in bf16: round to nearest even (the Pallas kernel's out dtype is
// theta's)
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Merge the partials of `splits` key ranges into out / sim / l_out.
template <typename T>
__global__ void corr_combine_kernel(const float* __restrict__ part,
                                    T* __restrict__ out,
                                    float* __restrict__ sim,
                                    float* __restrict__ l_out, int rows,
                                    int splits, float inv_t) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, part[((size_t)s * rows + r) * kCorrPart]);
  float l = 0.f, acc[kCorrV] = {0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * rows + r) * kCorrPart;
    const float w = expf((p[0] - m) * inv_t);  // every split's m is finite
    l = fmaf(w, p[1], l);
#pragma unroll
    for (int v = 0; v < kCorrV; ++v) acc[v] = fmaf(w, p[2 + v], acc[v]);
  }
#pragma unroll
  for (int v = 0; v < kCorrV; ++v)
    store_out(out + (size_t)r * kCorrV + v, acc[v] / l);
  sim[r] = m;
  if (l_out != nullptr) l_out[r] = l;
}

}  // namespace devc
