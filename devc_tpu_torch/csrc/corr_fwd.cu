// Fused correspondence forward: s = theta . phi^T, per-row online max m and
// denominator l, out = sum_k exp((s - m) / T) v_k / l, sim = m.
//
// Replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel (the Pallas TPU
// kernel behind correspondence_warp_pallas). The N x N score matrix never
// reaches device memory: each block keeps a tile of query rows and streams
// the keys through shared memory.
//
// What bounds it on the H100: arithmetic. The work is 2 N^2 (C + 3) FLOP
// (13.9 GFLOP at N = 5184, C = 256) against O(N C) bytes, so it is
// compute-bound by far. Scores must stay in full fp32 (at T = 1e-10 the
// softmax is an exact argmax-average and a TF32 score flips near-tied
// argmaxes), so the tensor cores are out and the ceiling is the fp32 FMA
// rate. The design keeps the FMA units fed:
//   * a block owns 128 query rows. Their whole tile (C channels, rows
//     padded to C + 4 floats) is copied into shared memory once and stays
//     there for the block's life; a thread reads its rows as float4 along
//     the channels, as corr_bwd.cu::tile_scores does;
//   * the keys stream through a ring of STAGES shared-memory stages, one
//     128-key x 64-channel chunk each, filled by cp.async (the zero-fill
//     form for key rows past N) while the block computes on the other
//     stage: one barrier per stage, and the copies overlap the FMAs. A
//     key tile's values ride with its last chunk. (Measured against 3 and
//     4 stages of 32 channels: the same or slower; half the barriers is
//     what the wider stage buys);
//   * 256 threads (16 x 16 lanes), each with an 8 x 8 register tile of
//     scores and its channel loop fully unrolled (rows ty + 16 i, keys
//     tx + 16 j: a warp's key reads hit 16 consecutive padded rows, which
//     fall in distinct banks); the online softmax runs on those
//     registers: the row max is a shuffle reduction
//     over the 16 lanes that share the row, and each lane keeps its own
//     share of l and acc, summed once at the end;
//   * the resident tile and the ring take ~206 KB, so one block of 8 warps
//     runs per SM; at N = 5184 there are only 41 query tiles, so the keys
//     are split across `splits` blocks per query tile (the wrapper picks
//     the count that wastes the least of the last wave), and a second
//     kernel merges the partial (m, l, acc) exactly (the combine of the
//     keys-sharded path, devc_tpu/parallel/sharded_corr.py; shared with
//     the bf16 kernel in corr_combine.cuh). P.V has V = 3: three FMAs
//     per score.
// For C > RESIDENT_MAX_C the query tile no longer fits beside the ring;
// then each stage carries the matching 64-channel chunk of the queries as
// well (the same loop, reading the queries from the stage). C % 64 == 32
// leaves a last chunk of 32 channels, computed as one half of a stage.
//
// This kernel takes fp32 embeddings only. bf16 embeddings (the --bf16
// mode) run corr_fwd_bf16.cu, which forms its scores on the bf16 tensor
// cores.
//
// Exactness at T -> 0: (s - m) * inv_t is formed in fp32 and fed to expf
// (no fast math, no exp2 pre-scaling); l and acc are rescaled by
// exp((m_prev - m_new) * inv_t) before a tile is added, and partials by
// exp((m_s - m) * inv_t) when merged, so a tie at the row max contributes
// exactly 1 and everything else exactly 0. A warp skips a row's weights
// for a tile when every exponent is below kUnderflow, where expf is
// exactly 0, so the skip changes no bit (at T = 1e-10 it drops almost all
// of the softmax's exponentials). Key columns past the end are
// masked by bounds checks and never enter the max or the sums; every key
// tile a block visits holds at least one valid key, so m is finite after
// its first tile and no -inf - -inf arises.
//
// Every score is formed by corr_score_step (corr_common.cuh): channels in
// ascending order from 0.f, one fmaf each, never split across chunks that
// are summed afterwards (a chunk adds to the running score), so the
// backward kernels recompute the same bits and their s == m test finds
// the row max.

#include <cuda_runtime.h>
#include <math.h>

#include "corr_combine.cuh"
#include "corr_common.cuh"

namespace {

constexpr int TQ = 128;       // query rows per block
constexpr int TK = 128;       // keys per tile
constexpr int CK = 64;        // channels per ring stage
constexpr int CH = 32;        // channels per compute step (C % CH == 0)
constexpr int STAGES = 2;     // ring depth: one stage in flight
constexpr int THREADS = 256;  // 16 (rows) x 16 (keys) lanes
constexpr int QI = TQ / 16;   // a thread's rows: ty + 16 i, i < QI
constexpr int KJ = TK / 16;   // a thread's keys: tx + 16 j, j < KJ
constexpr int LD = CK + 4;    // padded row stride of a staged chunk
constexpr int V = devc::kCorrV;
constexpr int PART = devc::kCorrPart;  // a partial result: m, l, acc[3]
constexpr int RESIDENT_MAX_C = 288;  // the largest C whose query tile fits
// expf(x) is exactly 0 in fp32 for x below about -103.97; a margin below
constexpr float kUnderflow = -120.f;

__host__ __device__ constexpr int q_floats(bool resident, int c) {
  return resident ? TQ * (c + 4) : STAGES * TQ * LD;
}

size_t smem_bytes(bool resident, int c) {
  return sizeof(float) *
         ((size_t)q_floats(resident, c) + STAGES * TK * LD + STAGES * TK * V);
}

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

// cp.async of 16 (or 4) bytes; src_bytes < size zero-fills the rest (0:
// nothing is read, src only has to be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + rows) x channels [c0, c0 + width) of a row-major
// [n, c] matrix into dst[rows][ld], dst[0][0] holding channel c0; rows
// past n are zero. width is a multiple of CH.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           int r0, int rows, int n, int c,
                                           int c0, int width) {
  constexpr int W4 = CH / 4;  // 16-byte pieces of a row's CH channels
  for (int h = 0; h < width; h += CH) {
    for (int i = threadIdx.x; i < rows * W4; i += THREADS) {
      const int r = i / W4;
      const int c4 = i % W4;
      const bool in = r0 + r < n;
      cp_async16(dst + r * ld + h + 4 * c4,
                 in ? src + (size_t)(r0 + r) * c + c0 + h + 4 * c4 : src,
                 in ? 16 : 0);
    }
  }
}

// One block: TQ query rows against the key tiles of one split. With
// part == nullptr (one split) it writes out / sim / l_out; otherwise it
// writes its partial (m, l, acc) to part[split][b][q][PART].
template <bool kResident>
__global__ void __launch_bounds__(THREADS, 1)
corr_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                const float* __restrict__ values, float* __restrict__ out,
                float* __restrict__ sim, float* __restrict__ l_out,
                float* __restrict__ part, int nq, int nk, int c,
                int tiles_per_split, float inv_t) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // resident [TQ][c + 4], or
                                              // [STAGES][TQ][LD]
  float* k_s = smem + q_floats(kResident, c);  // [STAGES][TK][LD]
  float* v_s = k_s + STAGES * TK * LD;        // [STAGES][TK][V]

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int k_begin = blockIdx.y * tiles_per_split * TK;
  const int k_end = min(nk, k_begin + tiles_per_split * TK);
  const float* th_g = theta + (size_t)b * nq * c;
  const float* ph_g = phi + (size_t)b * nk * c;
  const float* v_g = values + (size_t)b * nk * V;

  const int ty = threadIdx.x / 16;  // rows ty + 16 i
  const int tx = threadIdx.x % 16;  // keys tx + 16 j
  const int cpt = (c + CK - 1) / CK;  // chunks per key tile; the last may
                                     // hold CH channels of CK
  const int n_chunks = (k_end - k_begin + TK - 1) / TK * cpt;

  // Fill ring slot g % STAGES with chunk g (key tile g / cpt, channels
  // (g % cpt) CK ..), and with the tile's values on its last chunk. Always
  // commits a group, empty past the end, so wait_group counts alike.
  auto fill_stage = [&](int g) {
    if (g < n_chunks) {
      const int slot = g % STAGES;
      const int k0 = k_begin + g / cpt * TK;
      const int c0 = g % cpt * CK;
      const int cw = min(CK, c - c0);
      stage_rows(k_s + slot * TK * LD, LD, ph_g, k0, TK, nk, c, c0, cw);
      if (!kResident)
        stage_rows(q_s + slot * TQ * LD, LD, th_g, q0, TQ, nq, c, c0, cw);
      if (g % cpt == cpt - 1) {
        // values rows are 12 bytes: 4-byte copies, zero past nk
        for (int i = threadIdx.x; i < TK * V; i += THREADS) {
          const bool in = (size_t)k0 * V + i < (size_t)nk * V;
          cp_async4(v_s + slot * TK * V + i,
                    in ? v_g + (size_t)k0 * V + i : v_g, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  if (kResident) stage_rows(q_s, c + 4, th_g, q0, TQ, nq, c, 0, c);
  // the query tile's copies join chunk 0's group
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) fill_stage(g);

  float m[QI], l[QI], acc[QI][V], s[QI][KJ];
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  }

  for (int g = 0; g < n_chunks; ++g) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk g landed
    __syncthreads();  // everyone's have, and everyone is done with g - 1
    fill_stage(g + STAGES - 1);  // into the slot chunk g - 1 used
    const int slot = g % STAGES;
    const int ch = g % cpt;
    const int cw = min(CK, c - ch * CK);
    const float* qb = kResident ? q_s + ch * CK : q_s + slot * TQ * LD;
    const int q_ld = kResident ? c + 4 : LD;
    const float* kb = k_s + slot * TK * LD;
#pragma unroll
    for (int h = 0; h < CK; h += CH) {
      if (h >= cw) break;  // a last chunk of CH channels
#pragma unroll
      for (int cc = h; cc < h + CH; cc += 4) {
        float4 kv[KJ];
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kb + (tx + 16 * j) * LD + cc);
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qb + (ty + 16 * i) * q_ld + cc);
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            float x = s[i][j];
            x = corr_score_step(x, qv.x, kv[j].x);
            x = corr_score_step(x, qv.y, kv[j].y);
            x = corr_score_step(x, qv.z, kv[j].z);
            s[i][j] = corr_score_step(x, qv.w, kv[j].w);
          }
        }
      }
    }
    if (ch != cpt - 1) continue;

    // the key tile's scores are complete: online softmax on the register
    // tile; key j of this lane is k0 + tx + 16 j, valid while below k_end
    const int k0 = k_begin + g / cpt * TK;
    const float* vb = v_s + slot * TK * V;
    bool valid[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) valid[j] = k0 + tx + 16 * j < k_end;
#pragma unroll
    for (int i = 0; i < QI; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (valid[j]) tmax = fmaxf(tmax, s[i][j]);
      const float m_new = fmaxf(m[i], group16_max(tmax));
      // m == -inf only before the first tile, where l and acc are 0
      const float scale = (m[i] == -INFINITY) ? 0.f : expf((m[i] - m_new) * inv_t);
      l[i] *= scale;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] *= scale;
      // the weights, unless every one of the warp's underflows to 0
      // (adding 0 changes neither l nor acc): at T = 1e-10 almost every
      // tile of every row is skipped, at T = 0.01 few are
      bool live = false;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        live |= valid[j] && (s[i][j] - m_new) * inv_t >= kUnderflow;
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          if (valid[j]) {
            const float p = expf((s[i][j] - m_new) * inv_t);
            l[i] += p;
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[i][v] = fmaf(p, vb[(tx + 16 * j) * V + v], acc[i][v]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
      m[i] = m_new;
    }
  }
  cp_async_wait<0>();

  // sum the 16 lanes' shares of each row (they share m) and store
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const float li = group16_sum(l[i]);
    float ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ai[v] = group16_sum(acc[i][v]);
    const int q = q0 + ty + 16 * i;
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
  const dim3 grid((nq + TQ - 1) / TQ, splits, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_f = splits > 1 ? static_cast<float*>(part) : nullptr;
  const bool resident = c <= RESIDENT_MAX_C;
  const size_t smem = smem_bytes(resident, c);
  auto kernel = resident ? corr_fwd_kernel<true> : corr_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(phi),
      static_cast<const float*>(values), static_cast<float*>(out),
      static_cast<float*>(sim), static_cast<float*>(l_out), part_f, nq, nk, c,
      tiles_per_split, inv_t);
  if (splits > 1) {
    const int rows = batch * nq;
    devc::corr_combine_kernel<float><<<(rows + 255) / 256, 256, 0, st>>>(
        part_f, static_cast<float*>(out), static_cast<float*>(sim),
        static_cast<float*>(l_out), rows, splits, inv_t);
  }
  return (int)cudaGetLastError();
}
