// Fused correspondence forward: s = theta . phi^T, per-row online max m and
// denominator l, out = sum_k exp((s - m) / T) v_k / l, sim = m.
//
// Replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel (the Pallas TPU
// kernel behind correspondence_warp_pallas). The N x N score matrix never
// reaches device memory: each block keeps a tile of query rows and streams
// key tiles through shared memory.
//
// What bounds it on the H100: arithmetic. The work is 2 N^2 (C + 3) FLOP
// (13.9 GFLOP at N = 5184, C = 256) against O(N C) bytes, so it is
// compute-bound by far. Scores must stay in full fp32 (at T = 1e-10 the
// softmax is an exact argmax-average and a TF32 score flips near-tied
// argmaxes), so the tensor cores are out and the ceiling is the fp32 FMA
// rate. The design spends registers and shared-memory bandwidth on FMAs:
//   * each thread owns an 8 x 8 register tile of scores (four 16-byte
//     shared loads per 64 FMAs), and the online softmax runs on those
//     registers: the row max is a shuffle reduction over the 16 lanes that
//     share the row, and each lane keeps its own share of l and acc, which
//     are summed once at the end;
//   * a query tile is 64 rows, so there are few blocks at N = 5184; the
//     keys are split across `splits` blocks per query tile to fill the
//     SMs, and a second kernel merges the partial (m, l, acc) exactly
//     (the combine of the keys-sharded path, devc_tpu/parallel/
//     sharded_corr.py). P.V has V = 3: three FMAs per score.
//
// Exactness at T -> 0: (s - m) * inv_t is formed in fp32 and fed to expf
// (no fast math, no exp2 pre-scaling); l and acc are rescaled by
// exp((m_prev - m_new) * inv_t) before a tile is added, and partials by
// exp((m_s - m) * inv_t) when merged, so a tie at the row max contributes
// exactly 1 and everything else exactly 0. Key columns past the end are
// masked by bounds checks and never enter the max or the sums; every key
// tile a block visits holds at least one valid key, so m is finite after
// its first tile and no -inf - -inf arises.
//
// Every score is formed by corr_score_step (corr_common.cuh): channels in
// ascending order from 0.f, so the backward kernels recompute the same
// bits and their s == m test finds the row max.

#include <cuda_runtime.h>
#include <math.h>

#include "corr_common.cuh"

namespace {

constexpr int TQ = 64;        // query rows per block
constexpr int TK = 128;       // keys per tile
constexpr int CK = 32;        // channels per staged chunk
constexpr int THREADS = 128;  // 8 (rows) x 16 (keys) lanes, 8 x 8 scores each
constexpr int TQP = TQ + 4;   // padded strides (rows stay 16-byte aligned)
constexpr int TKP = TK + 4;
constexpr int V = 3;
constexpr int PART = 2 + V;  // a partial result: m, l, acc[3]

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + rows) x channels [c0, c0 + CK) of a [n, c] matrix
// channel-major into dst[CK][stride]; rows past n are zero.
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      int r0, int rows, int n, int c, int c0) {
  for (int i = threadIdx.x; i < rows * (CK / 4); i += THREADS) {
    const int r = i / (CK / 4);
    const int c4 = i % (CK / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * c + c0)[c4];
    dst[(4 * c4 + 0) * stride + r] = x.x;
    dst[(4 * c4 + 1) * stride + r] = x.y;
    dst[(4 * c4 + 2) * stride + r] = x.z;
    dst[(4 * c4 + 3) * stride + r] = x.w;
  }
}

// One block: TQ query rows against the key tiles of one split. With
// part == nullptr (one split) it writes out / sim / l_out; otherwise it
// writes its partial (m, l, acc) to part[split][b][q][PART].
__global__ void __launch_bounds__(THREADS)
corr_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ values, float* __restrict__ out,
                float* __restrict__ sim, float* __restrict__ l_out,
                float* __restrict__ part, int nq, int nk, int c,
                int tiles_per_split, float inv_t) {
  __shared__ __align__(16) float th_s[CK * TQP];  // channel-major queries
  __shared__ __align__(16) float ph_s[CK * TKP];  // channel-major keys
  __shared__ float v_s[TK * V];

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int k_begin = blockIdx.y * tiles_per_split * TK;
  const int k_end = min(nk, k_begin + tiles_per_split * TK);
  const float* th_g = theta + (size_t)b * nq * c;
  const float* ph_g = phi + (size_t)b * nk * c;
  const float* v_g = values + (size_t)b * nk * V;

  const int ty = threadIdx.x / 16;  // rows 4ty..4ty+3 and 32+4ty..32+4ty+3
  const int tx = threadIdx.x % 16;  // keys 4tx..4tx+3 and 64+4tx..64+4tx+3

  float m[8], l[8], acc[8][V];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += CK) {
      __syncthreads();  // the previous chunk and v_s are consumed
      stage(th_s, TQP, th_g, q0, TQ, nq, c, c0);
      stage(ph_s, TKP, ph_g, k0, TK, nk, c, c0);
      if (c0 == 0) {
        for (int i = threadIdx.x; i < TK * V; i += THREADS)
          v_s[i] = (k0 + i / V < nk) ? v_g[(size_t)k0 * V + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < CK; ++cc) {
        const float4 a0 = *reinterpret_cast<const float4*>(&th_s[cc * TQP + 4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&th_s[cc * TQP + 32 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ph_s[cc * TKP + 4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ph_s[cc * TKP + 64 + 4 * tx]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = corr_score_step(s[i][j], av[i], bw[j]);
      }
    }

    // online softmax on the register tile; key j of this lane is
    // k0 + kofs(j), valid while below k_end
    bool valid[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      valid[j] = k0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4) < k_end;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (valid[j]) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(m[i], group16_max(tmax));
      // m == -inf only before the first tile, where l and acc are 0
      const float scale = (m[i] == -INFINITY) ? 0.f : expf((m[i] - m_new) * inv_t);
      l[i] *= scale;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] *= scale;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!valid[j]) continue;
        const int kk = j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4;
        const float p = expf((s[i][j] - m_new) * inv_t);
        l[i] += p;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] = fmaf(p, v_s[kk * V + v], acc[i][v]);
      }
      m[i] = m_new;
    }
  }

  // sum the 16 lanes' shares of each row (they share m) and store
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float li = group16_sum(l[i]);
    float ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ai[v] = group16_sum(acc[i][v]);
    const int q = q0 + (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4);
    if (tx != 0 || q >= nq) continue;
    const size_t o = (size_t)b * nq + q;
    if (part == nullptr) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[o * V + v] = ai[v] / li;
      sim[o] = m[i];
      if (l_out != nullptr) l_out[o] = li;
    } else {
      float* p = part + ((size_t)blockIdx.y * gridDim.z * nq + o) * PART;
      p[0] = m[i];
      p[1] = li;
#pragma unroll
      for (int v = 0; v < V; ++v) p[2 + v] = ai[v];
    }
  }
}

// Merge the partials of `splits` key ranges into out / sim / l_out.
__global__ void corr_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ out,
                                    float* __restrict__ sim,
                                    float* __restrict__ l_out, int rows,
                                    int splits, float inv_t) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[((size_t)s * rows + r) * PART]);
  float l = 0.f, acc[V] = {0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * rows + r) * PART;
    const float w = expf((p[0] - m) * inv_t);  // every split's m is finite
    l = fmaf(w, p[1], l);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(w, p[2 + v], acc[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) out[(size_t)r * V + v] = acc[v] / l;
  sim[r] = m;
  if (l_out != nullptr) l_out[r] = l;
}

}  // namespace

// theta [B, nq, c], phi [B, nk, c], values [B, nk, 3], all fp32, contiguous,
// 16-byte aligned, c % 32 == 0. Writes out [B, nq, 3], sim [B, nq] and, when
// l_out is not null, l [B, nq]. With splits > 1 the keys are split into that
// many ranges of whole tiles (splits <= ceil(nk / 128)) and `part` is
// scratch of splits * B * nq * 5 floats. Returns cudaGetLastError().
extern "C" int devc_corr_fwd(const void* theta, const void* phi,
                             const void* values, void* out, void* sim,
                             void* l_out, void* part, int batch, int nq,
                             int nk, int c, int splits, float inv_t,
                             void* stream) {
  const int tiles = (nk + TK - 1) / TK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  splits = (tiles + tiles_per_split - 1) / tiles_per_split;  // none empty
  dim3 grid((nq + TQ - 1) / TQ, splits, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_f = splits > 1 ? static_cast<float*>(part) : nullptr;
  corr_fwd_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const float*>(values), static_cast<float*>(out),
      static_cast<float*>(sim), static_cast<float*>(l_out), part_f, nq, nk, c,
      tiles_per_split, inv_t);
  if (splits > 1) {
    const int rows = batch * nq;
    corr_combine_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
        part_f, static_cast<float*>(out), static_cast<float*>(sim),
        static_cast<float*>(l_out), rows, splits, inv_t);
  }
  return (int)cudaGetLastError();
}
