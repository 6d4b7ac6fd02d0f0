// Backward of the fused correspondence (K1): the two kernels behind its
// gradient.
//
//   dq  (replaces devc_tpu/ops/pallas_corr.py::_corr_dq_kernel):
//       dtheta = df . phi, reduced over the keys
//   dkv (replaces devc_tpu/ops/pallas_corr.py::_corr_dkv_kernel):
//       dphi = df^T . theta, dvalues = attn^T . dout, reduced over queries
//
// with the tile math of pallas_corr.py::_grad_tile on every (query, key):
//   s    = theta_q . phi_k                  (recomputed, as K1 forms it)
//   attn = exp((s - m_q) / T) / l_q         (m, l saved by K1)
//   df   = attn (dout_q . v_k - D_q) / T + dsim_q 1[s == m_q]
// where D_q = dout_q . out_q is computed outside the kernels (the
// flash-attention delta trick, as in JAX). The sim gradient goes to every
// key whose score equals the saved row max, every exact tie included
// (the einsum path's autodiff would split it; see ROADMAP C4).
//
// What bounds them on the H100: arithmetic. Each does 2 N^2 (2C + 3) or
// 2 N^2 (2C + 6) FLOP per sample (0.55 TFLOP at B = 16, N = 5184, C = 256)
// on O(N C) bytes. The scores must be fp32 FMAs in K1's order (s == m is
// an exact test), so the tensor cores are out and the ceiling is the fp32
// FMA rate. The design:
//   * a block holds one 64-row tile of the side it writes (queries for
//     dq, keys for dkv) in shared memory for its whole life and streams
//     64-row tiles of the other side through a second buffer, full width
//     (C + 4 floats a row: float4 reads by 8 lanes hit 32 distinct banks);
//   * 256 threads; each forms a 4 x 4 block of scores, writes its df to a
//     shared tile, and after a barrier adds df times the streamed (or
//     resident) rows into a 4-row x C/16-channel register accumulator:
//     five float4 shared loads per 64 FMAs;
//   * the reduction axis (keys for dq, queries for dkv) can be split over
//     `splits` blocks when there are too few tiles to fill the SMs (one
//     sample of N = 5184 has 81); each writes a partial sum and a second
//     kernel adds the partials in split order, so the result is the same
//     from run to run (no atomics).
// Rows and keys past the end are excluded by bounds checks, as in K1:
// their df and attn are 0 and they are never written.

#include <cuda_runtime.h>
#include <math.h>

#include "corr_common.cuh"

namespace {

constexpr int T = 64;          // rows per tile, both sides
constexpr int THREADS = 256;   // 16 (ty) x 16 (tx)
constexpr int V = 3;
constexpr int DP = T + 4;      // padded row stride of the df tile
constexpr int ROW = 8;         // per-query row constants: m, l, D, dsim, dout[3]
constexpr int MAX_C = 256;     // channels a thread's accumulator can hold: 16 x 16

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int row_stride(int c) { return c + 4; }

// Stage rows [r0, r0 + T) of a row-major [n, c] matrix into dst[T][c + 4];
// rows past n are zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int c) {
  const int c4n = c / 4;
  for (int i = threadIdx.x; i < T * c4n; i += THREADS) {
    const int r = i / c4n;
    const int c4 = i % c4n;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * c)[c4];
    *reinterpret_cast<float4*>(dst + r * row_stride(c) + 4 * c4) = x;
  }
}

// Stage the per-row constants of queries [q0, q0 + T) into row_s[T][ROW].
// Rows past nq get l = 1 and zeros; their df is masked anyway.
__device__ __forceinline__ void stage_row_constants(
    float* row_s, const float* m, const float* l, const float* dd,
    const float* dsim, const float* dout, size_t base, int q0, int nq) {
  for (int r = threadIdx.x; r < T; r += THREADS) {
    float* rs = row_s + r * ROW;
    const int q = q0 + r;
    if (q < nq) {
      const size_t o = base + q;
      rs[0] = m[o];
      rs[1] = l[o];
      rs[2] = dd[o];
      rs[3] = dsim[o];
#pragma unroll
      for (int v = 0; v < V; ++v) rs[4 + v] = dout[o * V + v];
    } else {
      rs[0] = 0.f;
      rs[1] = 1.f;
#pragma unroll
      for (int k = 2; k < ROW; ++k) rs[k] = 0.f;
    }
  }
}

// s[i][j] = score(query row qr[i] of q_s, key row kr[j] of k_s), channels
// in ascending order through corr_score_step, as K1 forms it.
__device__ __forceinline__ void tile_scores(float (&s)[4][4], const float* q_s,
                                            const int (&qr)[4],
                                            const float* k_s,
                                            const int (&kr)[4], int c) {
  const int ld = row_stride(c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int c4 = 0; c4 < c; c4 += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(q_s + qr[i] * ld + c4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(k_s + kr[j] * ld + c4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = corr_score_step(s[i][j], a[i].x, b[j].x);
        s[i][j] = corr_score_step(s[i][j], a[i].y, b[j].y);
        s[i][j] = corr_score_step(s[i][j], a[i].z, b[j].z);
        s[i][j] = corr_score_step(s[i][j], a[i].w, b[j].w);
      }
  }
}

// The df of one (query, key) pair, and its attn through *attn_out.
__device__ __forceinline__ float grad_score(float s, const float* rs,
                                            const float* v, float inv_t,
                                            float* attn_out) {
  const float m = rs[0];
  const float attn = expf((s - m) * inv_t) / rs[1];
  const float dps = rs[4] * v[0] + rs[5] * v[1] + rs[6] * v[2];
  float df = attn * (dps - rs[2]) * inv_t;
  if (s == m) df += rs[3];
  *attn_out = attn;
  return df;
}

// acc[i][4 jj + e] += sum_r d[r][i] * src[r][4 tx + 64 jj + e] over the T
// rows r of a df tile (d_s[r][DP], this thread's 4 columns at 4 ty) and
// a staged matrix src[r][c + 4].
__device__ __forceinline__ void accumulate(float (&acc)[4][16],
                                           const float* d_s, const float* src,
                                           int ty, int tx, int c) {
  const int ld = row_stride(c);
#pragma unroll 2
  for (int r = 0; r < T; ++r) {
    const float4 d = *reinterpret_cast<const float4*>(d_s + r * DP + 4 * ty);
    const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (4 * tx + 64 * jj >= c) break;
      const float4 p =
          *reinterpret_cast<const float4*>(src + r * ld + 4 * tx + 64 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * jj + 0] = fmaf(dv[i], p.x, acc[i][4 * jj + 0]);
        acc[i][4 * jj + 1] = fmaf(dv[i], p.y, acc[i][4 * jj + 1]);
        acc[i][4 * jj + 2] = fmaf(dv[i], p.z, acc[i][4 * jj + 2]);
        acc[i][4 * jj + 3] = fmaf(dv[i], p.w, acc[i][4 * jj + 3]);
      }
    }
  }
}

// Store rows 4 ty + i of a thread's accumulator to out[row][c] (rows below n).
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[4][16],
                                          int r0, int n, int ty, int tx,
                                          int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (4 * tx + 64 * jj >= c) break;
      *reinterpret_cast<float4*>(out + (size_t)r * c + 4 * tx + 64 * jj) =
          make_float4(acc[i][4 * jj + 0], acc[i][4 * jj + 1],
                      acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    }
  }
}

size_t smem_bytes(int c) {
  return sizeof(float) *
         (2 * T * row_stride(c) + T * DP + T * ROW + T * V);
}

// One block: the 64 queries of tile blockIdx.x against the key tiles of
// split blockIdx.y. Writes dtheta rows (or, with splits, its partial sum
// to dtheta + split * B * nq * c).
__global__ void __launch_bounds__(THREADS, 1)
corr_dq_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
               const float* __restrict__ values, const float* __restrict__ m,
               const float* __restrict__ l, const float* __restrict__ dd,
               const float* __restrict__ dsim, const float* __restrict__ dout,
               float* __restrict__ dtheta, int nq, int nk, int c,
               int tiles_per_split, float inv_t) {
  extern __shared__ float4 smem4[];
  float* th_s = reinterpret_cast<float*>(smem4);  // [T][c + 4] queries
  float* ph_s = th_s + T * row_stride(c);         // [T][c + 4] keys
  float* df_s = ph_s + T * row_stride(c);         // [key][DP] by query
  float* row_s = df_s + T * DP;                   // [query][ROW]
  float* v_s = row_s + T * ROW;                   // [key][V]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * T;
  const int k_begin = blockIdx.y * tiles_per_split * T;
  const int k_end = min(nk, k_begin + tiles_per_split * T);
  const int ty = threadIdx.x / 16;  // queries 4 ty .. 4 ty + 3
  const int tx = threadIdx.x % 16;  // keys tx + 16 j; channels 4 tx + 64 jj

  stage_rows(th_s, theta + (size_t)b * nq * c, q0, nq, c);
  stage_row_constants(row_s, m, l, dd, dsim, dout, (size_t)b * nq, q0, nq);

  const int qr[4] = {4 * ty, 4 * ty + 1, 4 * ty + 2, 4 * ty + 3};
  const int kr[4] = {tx, tx + 16, tx + 32, tx + 48};
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[i][k] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += T) {
    __syncthreads();  // the previous key tile and df tile are consumed
    stage_rows(ph_s, phi + (size_t)b * nk * c, k0, nk, c);
    for (int i = threadIdx.x; i < T * V; i += THREADS)
      v_s[i] = (k0 + i / V < nk) ? values[((size_t)b * nk + k0) * V + i] : 0.f;
    __syncthreads();

    float s[4][4];
    tile_scores(s, th_s, qr, ph_s, kr, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + kr[j] < k_end;
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float attn;  // dq needs only df
        d[i] = (key_ok && q0 + qr[i] < nq)
                   ? grad_score(s[i][j], row_s + qr[i] * ROW, v_s + kr[j] * V,
                                inv_t, &attn)
                   : 0.f;
      }
      *reinterpret_cast<float4*>(df_s + kr[j] * DP + 4 * ty) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
    accumulate(acc, df_s, ph_s, ty, tx, c);  // dtheta += df . phi
  }
  store_acc(dtheta + ((size_t)blockIdx.y * gridDim.z + b) * nq * c, acc, q0,
            nq, ty, tx, c);
}

// One block: the 64 keys of tile blockIdx.x against the query tiles of
// split blockIdx.y. Writes dphi and dvalues rows (or partial sums, as dq).
__global__ void __launch_bounds__(THREADS, 1)
corr_dkv_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ values, const float* __restrict__ m,
                const float* __restrict__ l, const float* __restrict__ dd,
                const float* __restrict__ dsim, const float* __restrict__ dout,
                float* __restrict__ dphi, float* __restrict__ dvalues, int nq,
                int nk, int c, int tiles_per_split, float inv_t) {
  extern __shared__ float4 smem4[];
  float* ph_s = reinterpret_cast<float*>(smem4);  // [T][c + 4] keys
  float* th_s = ph_s + T * row_stride(c);         // [T][c + 4] queries
  float* df_s = th_s + T * row_stride(c);         // [query][DP] by key
  float* row_s = df_s + T * DP;                   // [query][ROW]
  float* v_s = row_s + T * ROW;                   // [key][V]

  const int b = blockIdx.z;
  const int k0 = blockIdx.x * T;
  const int q_begin = blockIdx.y * tiles_per_split * T;
  const int q_end = min(nq, q_begin + tiles_per_split * T);
  const int ty = threadIdx.x / 16;  // keys 4 ty .. 4 ty + 3
  const int tx = threadIdx.x % 16;  // queries tx + 16 j; channels 4 tx + 64 jj

  stage_rows(ph_s, phi + (size_t)b * nk * c, k0, nk, c);
  for (int i = threadIdx.x; i < T * V; i += THREADS)
    v_s[i] = (k0 + i / V < nk) ? values[((size_t)b * nk + k0) * V + i] : 0.f;

  const int kr[4] = {4 * ty, 4 * ty + 1, 4 * ty + 2, 4 * ty + 3};
  const int qr[4] = {tx, tx + 16, tx + 32, tx + 48};
  float acc[4][16], dv[4][V];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[i][k] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) dv[i][v] = 0.f;
  }

  for (int q0 = q_begin; q0 < q_end; q0 += T) {
    __syncthreads();  // the previous query tile and df tile are consumed
    stage_rows(th_s, theta + (size_t)b * nq * c, q0, nq, c);
    stage_row_constants(row_s, m, l, dd, dsim, dout, (size_t)b * nq, q0, nq);
    __syncthreads();

    float s[4][4];  // s[j][i]: query qr[j], key kr[i]
    tile_scores(s, th_s, qr, ph_s, kr, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool query_ok = q0 + qr[j] < q_end;
      const float* rs = row_s + qr[j] * ROW;
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i] = 0.f;
        if (query_ok && k0 + kr[i] < nk) {
          float attn;
          d[i] = grad_score(s[j][i], rs, v_s + kr[i] * V, inv_t, &attn);
#pragma unroll
          for (int v = 0; v < V; ++v) dv[i][v] = fmaf(attn, rs[4 + v], dv[i][v]);
        }
      }
      *reinterpret_cast<float4*>(df_s + qr[j] * DP + 4 * ty) =
          make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();
    accumulate(acc, df_s, th_s, ty, tx, c);  // dphi += df^T . theta
  }

  const size_t part = (size_t)blockIdx.y * gridDim.z + b;
  store_acc(dphi + part * nk * c, acc, k0, nk, ty, tx, c);
  // the 16 lanes of a ty saw disjoint queries of the same 4 keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) dv[i][v] = group16_sum(dv[i][v]);
    const int k = k0 + kr[i];
    if (tx == 0 && k < nk) {
#pragma unroll
      for (int v = 0; v < V; ++v) dvalues[(part * nk + k) * V + v] = dv[i][v];
    }
  }
}

// out[i] = sum over s of part[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n,
                                  int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
}

void sum_splits(const float* part, float* out, size_t n, int splits,
                cudaStream_t st) {
  const int threads = 256;
  sum_splits_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      st>>>(part, out, n, splits);
}

// Tiles of the reduction axis per split: splits <= tiles, none empty.
int tiles_per_split(int n, int* splits) {
  const int tiles = (n + T - 1) / T;
  const int per = (tiles + *splits - 1) / *splits;
  *splits = (tiles + per - 1) / per;
  return per;
}

}  // namespace

// Inputs (fp32, contiguous, on one device): theta [B, nq, c] and phi
// [B, nk, c] 16-byte aligned, c % 64 == 0 and c <= 256; values [B, nk, 3];
// m, l, dd, dsim [B, nq]; dout [B, nq, 3]. Writes dtheta [B, nq, c]. With
// splits > 1, `part` is scratch of splits * B * nq * c floats. Returns
// cudaGetLastError().
extern "C" int devc_corr_bwd_dq(const void* theta, const void* phi,
                                const void* values, const void* m,
                                const void* l, const void* dd,
                                const void* dsim, const void* dout,
                                void* dtheta, void* part, int batch, int nq,
                                int nk, int c, int splits, float inv_t,
                                void* stream) {
  if (c % 64 != 0 || c > MAX_C) return (int)cudaErrorInvalidValue;
  const int per = tiles_per_split(nk, &splits);
  const size_t smem = smem_bytes(c);
  const cudaError_t set = cudaFuncSetAttribute(
      corr_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(part)
                          : static_cast<float*>(dtheta);
  dim3 grid((nq + T - 1) / T, splits, batch);
  corr_dq_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const float*>(values), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dd),
      static_cast<const float*>(dsim), static_cast<const float*>(dout), dst,
      nq, nk, c, per, inv_t);
  if (splits > 1)
    sum_splits(dst, static_cast<float*>(dtheta), (size_t)batch * nq * c,
               splits, st);
  return (int)cudaGetLastError();
}

// As devc_corr_bwd_dq; writes dphi [B, nk, c] and dvalues [B, nk, 3]. With
// splits > 1, `part` is scratch of splits * B * nk * (c + 3) floats.
extern "C" int devc_corr_bwd_dkv(const void* theta, const void* phi,
                                 const void* values, const void* m,
                                 const void* l, const void* dd,
                                 const void* dsim, const void* dout,
                                 void* dphi, void* dvalues, void* part,
                                 int batch, int nq, int nk, int c, int splits,
                                 float inv_t, void* stream) {
  if (c % 64 != 0 || c > MAX_C) return (int)cudaErrorInvalidValue;
  const int per = tiles_per_split(nq, &splits);
  const size_t smem = smem_bytes(c);
  const cudaError_t set = cudaFuncSetAttribute(
      corr_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_phi = (size_t)batch * nk * c;
  const size_t n_v = (size_t)batch * nk * V;
  float* dst_phi = splits > 1 ? static_cast<float*>(part)
                              : static_cast<float*>(dphi);
  float* dst_v = splits > 1 ? static_cast<float*>(part) + splits * n_phi
                            : static_cast<float*>(dvalues);
  dim3 grid((nk + T - 1) / T, splits, batch);
  corr_dkv_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const float*>(values), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(dd),
      static_cast<const float*>(dsim), static_cast<const float*>(dout),
      dst_phi, dst_v, nq, nk, c, per, inv_t);
  if (splits > 1) {
    sum_splits(dst_phi, static_cast<float*>(dphi), n_phi, splits, st);
    sum_splits(dst_v, static_cast<float*>(dvalues), n_v, splits, st);
  }
  return (int)cudaGetLastError();
}
