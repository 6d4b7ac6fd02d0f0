// Shared by the fp32 correspondence kernels: K1 (corr_fwd.cu) and its two
// backward kernels (corr_bwd.cu).
#pragma once

#include <cuda_runtime.h>

// One channel's term of the score s = theta_q . phi_k.
//
// The backward kernels recompute every score and route the sim gradient
// to the keys whose score equals K1's saved row max (s == m, as
// devc_tpu/ops/pallas_corr.py::_grad_tile does). That equality holds only
// if every kernel forms a score bit for bit alike: start from 0.f, add
// the channels in ascending order, one fmaf each, theta's value first.
// This function is that rule; every score in these kernels goes through it.
// The rule binds K1's fp32 kernel, K2b and K3. K1's bf16 kernel
// (corr_fwd_bf16.cu) is exempt: it sums on the tensor cores, and nothing
// reads its m (the differentiable path is fp32 only).
__device__ __forceinline__ float corr_score_step(float s, float theta_c,
                                                 float phi_c) {
  return fmaf(theta_c, phi_c, s);
}
