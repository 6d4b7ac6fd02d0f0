// Kernel K2: the tridiagonal solves of the fast global smoother.
//
// Replaces devc_tpu/ops/fgs.py::_tridiag_pcr_pallas (the Pallas TPU kernel
// the smoother calls for each of its 1-D weighted-least-squares passes).
// Two entries over one solver core:
//
//   devc_smooth_pass  one whole pass of fast_global_smoother in one launch:
//                     reads src [B, H, W, 2] and the guides [B, H, W] (or
//                     one guide [H, W] shared by all B images) in place
//                     (rows or columns, no transposed copy), builds the
//                     coefficients from the guide, solves both ab channels
//                     as two right-hand sides of one system and writes
//                     [B, H, W, 2]. The grid's second axis is the image,
//                     so a pass over B images (B clip slots, or R
//                     exemplars against one frame's guide) is one launch,
//                     and a step's six passes are six launches for any B.
//   devc_tridiag_pcr  the general batched solve: coefficients given,
//                     [B, L] row-major systems.
//
// What bounds it on the H100: device-memory traffic and latency. A pass
// reads src and the guide and writes the result once (20 bytes per
// pixel, 6.6 MB at 432x768, 2 us at 3.35 TB/s); its arithmetic is a few
// dozen FLOP per pixel. The XLA formulation around the TPU kernel built
// four coefficient arrays per channel in device memory around every solve
// and transposed the column passes; here nothing but src, guide and the
// result touches device memory. What is left is latency: a handful of
// dependent reduction steps per pass.
//
// The solver core (solve below), for systems of length L:
//   * a system gets T threads (T a power of two, T >= L / RMAX); thread t
//     holds the R = ceil(L / T) unknowns t, t + T, t + 2T, ... in
//     registers, with its coefficients and right-hand sides;
//   * log2 T steps of parallel cyclic reduction (PCR) decouple them: after
//     the steps with strides 1, 2, ..., T/2 every unknown couples only to
//     the unknowns T away, so thread t's R unknowns form a system of their
//     own. Each step exchanges the rows through shared memory,
//     double-buffered, with one barrier per step; like devc_tpu's PCR,
//     every step reads its neighbours' pre-step rows, and a neighbour
//     outside the system is the row a = 0, b = 1, c = 0, d = 0;
//   * each thread then solves its own system by the Thomas algorithm in
//     registers (2R dependent steps, no barrier).
// RMAX = 8 sets the split between the two: of 4, 8, 16 and 32 unknowns a
// thread, 8 ran the frame's passes fastest (fewer threads per system
// leave the card idle, more add PCR steps). The loads all go out at
// once, before any arithmetic, and the divisions are a reciprocal with
// one Newton step: with IEEE division's slow-path branch in the unrolled
// loops the kernel ran three times slower.
// A block holds S = max(1, 256 / T) systems side by side; for the column
// passes those are S neighbouring columns, and consecutive threads take
// consecutive columns, so the loads coalesce. Rows past L (padding up to
// R T) are the identity row a = 0, b = 1, c = 0, d = 0, which is also the
// PCR fill, so they change nothing.
//
// The systems are diagonally dominant (b = 1 + |a| + |c| for the
// smoother), which PCR preserves, so Thomas needs no pivoting.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RMAX = 8;         // unknowns a thread holds, at most
constexpr int BLOCK = 256;      // threads per block the plan aims at
constexpr int MAX_THREADS = 512;  // so L <= RMAX * 512 = 4096

// 1 / x for a pivot: the hardware estimate and one Newton step, within an
// ulp or two of the rounded quotient and, unlike IEEE division, free of
// the branch to its slow path, which would split the unrolled loops and
// serialise them. Pivots of a diagonally dominant system, which PCR and
// Thomas without pivoting need anyway, are normal and nonzero (the
// smoother's are >= 1).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Thread t's unknowns t + r T, r < R: coefficients and NRHS right-hand
// sides. After solve, d holds the solution.
template <int NRHS>
struct Rows {
  float a[RMAX], b[RMAX], c[RMAX], d[NRHS][RMAX];
};

// Solve the system of thread (sys, t) of a block of n_s systems x n_t
// threads, r_len unknowns per thread. smem: 2 buffers of (3 + NRHS) values
// x (r_len n_t) rows x n_s systems, laid out [buffer][value][row][system].
template <int NRHS>
__device__ __forceinline__ void solve(Rows<NRHS>& e, float* smem, int t,
                                      int sys, int n_t, int n_s, int r_len) {
  constexpr int NV = 3 + NRHS;
  const int plen = r_len * n_t;
  const int vs = plen * n_s;  // stride between values
  int cur = 0;
  for (int s = 1; s < n_t; s *= 2) {
    float* w = smem + cur * NV * vs;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < r_len) {
        const int i = (t + r * n_t) * n_s + sys;
        w[i] = e.a[r];
        w[vs + i] = e.b[r];
        w[2 * vs + i] = e.c[r];
#pragma unroll
        for (int k = 0; k < NRHS; ++k) w[(3 + k) * vs + i] = e.d[k][r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < r_len) {
        const int p = t + r * n_t;
        float am = 0.f, bm = 1.f, cm = 0.f, dm[NRHS];
        float ap = 0.f, bp = 1.f, cp = 0.f, dp[NRHS];
#pragma unroll
        for (int k = 0; k < NRHS; ++k) dm[k] = dp[k] = 0.f;
        if (p >= s) {
          const int j = (p - s) * n_s + sys;
          am = w[j];
          bm = w[vs + j];
          cm = w[2 * vs + j];
#pragma unroll
          for (int k = 0; k < NRHS; ++k) dm[k] = w[(3 + k) * vs + j];
        }
        if (p + s < plen) {
          const int j = (p + s) * n_s + sys;
          ap = w[j];
          bp = w[vs + j];
          cp = w[2 * vs + j];
#pragma unroll
          for (int k = 0; k < NRHS; ++k) dp[k] = w[(3 + k) * vs + j];
        }
        const float alpha = -e.a[r] * recip(bm);
        const float gamma = -e.c[r] * recip(bp);
        e.a[r] = alpha * am;
        e.b[r] = e.b[r] + alpha * cm + gamma * ap;
        e.c[r] = gamma * cp;
#pragma unroll
        for (int k = 0; k < NRHS; ++k)
          e.d[k][r] = e.d[k][r] + alpha * dm[k] + gamma * dp[k];
      }
    }
    cur ^= 1;
  }

  // Thomas on unknowns r = 0 .. r_len - 1 (they couple to r - 1, r + 1)
  float c_prev = 0.f, d_prev[NRHS];
#pragma unroll
  for (int k = 0; k < NRHS; ++k) d_prev[k] = 0.f;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < r_len) {
      const float inv = recip(e.b[r] - e.a[r] * c_prev);
      c_prev = e.c[r] * inv;
      e.c[r] = c_prev;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        d_prev[k] = (e.d[k][r] - e.a[r] * d_prev[k]) * inv;
        e.d[k][r] = d_prev[k];
      }
    }
  }
  float x_next[NRHS];
#pragma unroll
  for (int k = 0; k < NRHS; ++k) x_next[k] = 0.f;
#pragma unroll
  for (int r = RMAX - 1; r >= 0; --r) {
    if (r < r_len) {
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        x_next[k] = e.d[k][r] - e.c[r] * x_next[k];
        e.d[k][r] = x_next[k];
      }
    }
  }
}

// One pass of the smoother. System `sys` of n_sys, unknown p of len:
// pixel sys * sys_stride + p * pos_stride of image blockIdx.y of src
// [B, H, W, 2] / guide (a row pass: sys_stride W, pos_stride 1; a column
// pass: 1 and W). Image i's guide starts i * guide_bstride floats in
// (H W for per-image guides, 0 for one shared guide).
__global__ void __launch_bounds__(MAX_THREADS)
smooth_pass_kernel(const float2* __restrict__ src,
                   const float* __restrict__ guide, float2* __restrict__ out,
                   int n_sys, int len, int sys_stride, int pos_stride,
                   long long guide_bstride, float lam, float sigma,
                   int r_len) {
  extern __shared__ float smem[];
  const size_t image = (size_t)n_sys * len;
  src += blockIdx.y * image;
  out += blockIdx.y * image;
  guide += blockIdx.y * guide_bstride;
  const int n_s = blockDim.x, n_t = blockDim.y;
  const int sys = threadIdx.x, t = threadIdx.y;
  const int g = blockIdx.x * n_s + sys;
  const bool live = g < n_sys;
  // every load first, unconditionally (a padding unknown reads pixel 0),
  // so that their latencies overlap; then the rows
  float g0[RMAX], gl[RMAX], gr[RMAX];
  float2 v[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int p = t + r * n_t;
    const bool in = r < r_len && live && p < len;
    const size_t px = in ? (size_t)g * sys_stride + (size_t)p * pos_stride : 0;
    g0[r] = guide[px];
    gl[r] = guide[in && p > 0 ? px - pos_stride : px];
    gr[r] = guide[in && p < len - 1 ? px + pos_stride : px];
    v[r] = src[px];
  }
  // the weights of fgs._smooth_axis, exp(-|g_{i+1} - g_i| / sigma), zero
  // past either end, and its coefficients, rounded as its float32 ops are
  // (x / sigma as x * (1 / sigma): exact for sigma = 4)
  const float inv_sigma = 1.f / sigma;
  Rows<2> e;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < r_len) {  // padding past len: the row 0, 1, 0 | 0
      const int p = t + r * n_t;
      const bool in = live && p < len;
      const float wl = in && p > 0
          ? expf(__fmul_rn(-fabsf(g0[r] - gl[r]), inv_sigma)) : 0.f;
      const float wr = in && p < len - 1
          ? expf(__fmul_rn(-fabsf(gr[r] - g0[r]), inv_sigma)) : 0.f;
      e.a[r] = __fmul_rn(-lam, wl);
      e.b[r] = __fadd_rn(1.f, __fmul_rn(lam, __fadd_rn(wl, wr)));
      e.c[r] = __fmul_rn(-lam, wr);
      e.d[0][r] = in ? v[r].x : 0.f;
      e.d[1][r] = in ? v[r].y : 0.f;
    }
  }
  solve<2>(e, smem, t, sys, n_t, n_s, r_len);
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int p = t + r * n_t;
    if (r < r_len && live && p < len)
      out[(size_t)g * sys_stride + (size_t)p * pos_stride] =
          make_float2(e.d[0][r], e.d[1][r]);
  }
}

// The general solve: system g is row g of [n_sys, len] a, b, c, d.
__global__ void __launch_bounds__(MAX_THREADS)
tridiag_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, const float* __restrict__ d,
               float* __restrict__ x, int n_sys, int len, int r_len) {
  extern __shared__ float smem[];
  const int n_s = blockDim.x, n_t = blockDim.y;
  const int sys = threadIdx.x, t = threadIdx.y;
  const int g = blockIdx.x * n_s + sys;
  const bool live = g < n_sys;
  Rows<1> e;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {  // loads unconditional, as above
    const int p = t + r * n_t;
    const bool in = r < r_len && live && p < len;
    const size_t o = in ? (size_t)g * len + p : 0;
    const float av = a[o], bv = b[o], cv = c[o], dv = d[o];
    e.a[r] = in ? av : 0.f;
    e.b[r] = in ? bv : 1.f;
    e.c[r] = in ? cv : 0.f;
    e.d[0][r] = in ? dv : 0.f;
  }
  solve<1>(e, smem, t, sys, n_t, n_s, r_len);
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int p = t + r * n_t;
    if (r < r_len && live && p < len) x[(size_t)g * len + p] = e.d[0][r];
  }
}

// Threads per system, unknowns per thread, systems per block and shared
// memory for systems of length len with nv values per row.
struct Plan {
  int n_t, r_len, n_s;
  size_t smem;
};

Plan plan(int len, int nv) {
  Plan p;
  p.n_t = 1;
  while (p.n_t * RMAX < len) p.n_t *= 2;
  p.r_len = (len + p.n_t - 1) / p.n_t;
  p.n_s = p.n_t >= BLOCK ? 1 : BLOCK / p.n_t;
  p.smem = sizeof(float) * 2 * nv * (size_t)p.r_len * p.n_t * p.n_s;
  return p;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Plan& p) {
  if (p.n_t > MAX_THREADS) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.smem);
}

}  // namespace

// src, out [batch, h, w, 2] and guide [batch, h, w] (guide_bstride h w)
// or [h, w] (guide_bstride 0), fp32, contiguous, 8-byte aligned. axis 1:
// the systems run along w (one per row); axis 0: along h (one per column).
// lam, sigma: the pass's lambda_t and sigma_color. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, with no
// launch, for a system too long for one block or more than 65535 images).
extern "C" int devc_smooth_pass(const void* src, const void* guide, void* out,
                                int batch, int h, int w, int axis,
                                long long guide_bstride, float lam,
                                float sigma, void* stream) {
  const int n_sys = axis == 1 ? h : w;
  const int len = axis == 1 ? w : h;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const Plan p = plan(len, 5);
  cudaError_t err = prepare(smooth_pass_kernel, p);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(p.n_s, p.n_t);
  const dim3 grid((n_sys + p.n_s - 1) / p.n_s, batch);
  smooth_pass_kernel<<<grid, block, p.smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(src), static_cast<const float*>(guide),
      static_cast<float2*>(out), n_sys, len, axis == 1 ? w : 1,
      axis == 1 ? 1 : w, guide_bstride, lam, sigma, p.r_len);
  return (int)cudaGetLastError();
}

// a, b, c, d, x: [n_sys, len] fp32, contiguous (a[:, 0] and c[:, len - 1]
// are ignored). Returns cudaGetLastError() after the launch.
extern "C" int devc_tridiag_pcr(const void* a, const void* b, const void* c,
                                const void* d, void* x, int n_sys, int len,
                                void* stream) {
  const Plan p = plan(len, 4);
  cudaError_t err = prepare(tridiag_kernel, p);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(p.n_s, p.n_t);
  const int grid = (n_sys + p.n_s - 1) / p.n_s;
  tridiag_kernel<<<grid, block, p.smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<float*>(x), n_sys, len, p.r_len);
  return (int)cudaGetLastError();
}
