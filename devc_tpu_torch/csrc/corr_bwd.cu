// Backward of the fused correspondence (K1): one score pass and two
// products on the tensor cores.
//
// Replaces devc_tpu/ops/pallas_corr.py::_corr_dkv_kernel (K3: dphi and
// dvalues, reduced over the queries) and ::_corr_dq_kernel (K2b: dtheta,
// reduced over the keys), with the tile math of pallas_corr.py::_grad_tile
// on every (query, key):
//   s    = theta_q . phi_k                  (recomputed, as K1 forms it)
//   attn = exp((s - m_q) / T) * (1 / l_q)   (m, l saved by K1)
//   df   = attn (dout_q . v_k - D_q) / T + dsim_q 1[s == m_q]
//   dtheta = df phi,  dphi = df^T theta,  dvalues = attn^T dout
// where D_q = dout_q . out_q is formed outside (the flash-attention delta
// trick, as in JAX). The sim gradient goes to every key whose score equals
// the saved row max, every exact tie included (ROADMAP C4). 1 / l_q is
// taken once per row (an IEEE division), so attn may differ from
// exp(..) / l in its last bit.
//
// What bounds it on the H100: arithmetic on the tensor cores. The score
// pass recomputes 2 N^2 C FLOP per sample; the backward finds K1's row max
// by the exact test s == m, so every score is formed by K1's fp32 score
// rule (corr_score.cuh: 3xTF32 wgmma, 32-channel atoms added in fp32, the
// same instruction shape, operand roles and places as in K1). The two
// large products, 2 N^2 C FLOP each, need no fixed order. Each of the
// three is fp32-accurate on the TF32 tensor cores: three passes at 495
// TFLOP/s, 1.33 ms apiece at B = 16, N = 5184, C = 256. Beside them
// the score pass does an expf and ~12 FMAs a score (attn, df, dvalues) and
// writes the df scratch, 4 bytes a score (1.76 GB at that shape, 0.53 ms
// at the memory rate).
//
// The design:
//   * corr_dkv_scores_kernel forms every score once, on K1's skeleton
//     (corr_fwd.cu) with the roles turned: a block owns a tile of 128 keys
//     (the wgmma's B, N side) and streams 128-query tiles (two warpgroups
//     of 64 rows, the A side) through a 3-stage ring of TMA stages, each
//     one 32-channel atom of the queries and one of the block's keys, hi
//     and lo (64 KB: in hi and lo, 128 keys of C = 256 take 256 KB, more
//     than a block has, so the keys come again from L2 for every query
//     tile). The queries' and keys' halves come from the split pre-pass
//     over theta and phi. On a finished tile it forms attn and df on the
//     accumulator registers (the query's m, 1 / l, D, dsim and dout read
//     once per row from a packed [B, Nq', 8] array), writes df to a
//     scratch array [B, Nq', Nk'] (Nq', Nk' rounded up to 128; zero
//     outside the valid rows and keys), and sums attn . dout for dvalues:
//     over a warp's 8 lanes of a key by shuffles, into the warp's row of
//     shared memory, and over the 8 warps in warp order at the end.
//   * corr_dkv_product_kernel (dphi = df^T theta) and
//     corr_dq_product_kernel (dtheta = df phi) read that scratch and run
//     on the tensor cores with mma.sync.m16n8k8 in 3xTF32: each fp32
//     operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
//     lo.hi + hi.lo + hi.hi of each 8-deep step is summed on the tensor
//     cores and added to an fp32 running sum by an ordinary add, which
//     keeps about fp32's accuracy (a single TF32 pass leaves ~1e-4
//     relative, and the routing check needs dtheta within 1e-6 of phi;
//     one accumulator over the whole depth on the tensor cores, which
//     truncate, left 10x cuBLAS's fp32 error at N = 5184). 128 x 128 output
//     tiles, 32-deep steps through a 3-stage cp.async ring, 8 warps of
//     32 x 64 each, two blocks per SM (128 registers a thread).
//   * the wrapper runs the batch in chunks whose scratch fits a budget
//     (ops/cuda_corr.py::plan_batch_chunks), score pass then products per
//     chunk.
//   * deterministic: no atomics. Where a reduction is split over blocks
//     (the queries of the score pass for dvalues, the depth of a product,
//     when too few tiles fill the SMs), each block writes a partial and
//     sum_splits_kernel adds them in split order.
// Any C % 32 == 0 (whole 32-channel atoms); the products zero-fill the
// columns past C.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "corr_score.cuh"

namespace {

using namespace devc;

constexpr int V = 3;
constexpr int THREADS = 256;

// ---------------------------------------------------------------- cp.async

// cp.async of 16 bytes; src_bytes < 16 zero-fills the rest (0: nothing is
// read, src only has to be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- score pass

constexpr int TQ = 128;      // queries per streamed tile: a warpgroup per 64
constexpr int TK = 128;      // keys per block: the wgmma's N
constexpr int CK = 32;       // channels per atom: one 128-byte fp32 row
constexpr int STAGES = 3;    // ring depth: two stages in flight
constexpr int Q_ATOM = TQ * 128;  // bytes of a query atom (hi or lo)
constexpr int K_ATOM = TK * 128;  // bytes of a key atom (hi or lo)
constexpr int STAGE = 2 * Q_ATOM + 2 * K_ATOM;  // q hi, q lo, k hi, k lo
constexpr int ALIGN = 1024;  // an atom's base alignment (the swizzle's repeat)
constexpr int WARPS = THREADS / 32;
constexpr int RC = 8;        // packed row constants: m, 1/l, D, dsim, dout[3], 0
constexpr int PAD = 128;     // Nq', Nk': rounded up to this
constexpr unsigned kFull = 0xffffffffu;

static_assert(TQ == 2 * kScoreRows && TK == kScoreKeys && CK == kScoreAtom &&
                  THREADS == 2 * 128,
              "the score rule's tile, as K1's: two warpgroups of 64 query "
              "rows, 128 keys, 32-channel atoms");
static_assert(TQ == PAD && TK == PAD, "tiles cover the padded scratch");

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Dynamic shared memory of the score pass: slack to align the atoms, the
// ring of stages, the block's values [TK][V], each warp's dvalues sums
// [WARPS][TK][V] and an mbarrier per stage.
constexpr size_t scores_smem_bytes() {
  return (size_t)ALIGN + (size_t)STAGES * STAGE +
         sizeof(float) * (TK * V + WARPS * TK * V) + 8 * STAGES;
}
static_assert(scores_smem_bytes() <= 232448, "one block's shared memory");

// rows[b][q] = (m, 1 / l, D, dsim, dout[0..2], 0) for q < nq, zeros up to
// nq_pad.
__global__ void corr_dkv_rows_kernel(const float* __restrict__ m,
                                     const float* __restrict__ l,
                                     const float* __restrict__ dd,
                                     const float* __restrict__ dsim,
                                     const float* __restrict__ dout,
                                     float* __restrict__ rows, int nq,
                                     int nq_pad, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / nq_pad;
  const int q = i % nq_pad;
  float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 r1 = r0;
  if (q < nq) {
    const size_t o = (size_t)b * nq + q;
    r0 = make_float4(m[o], 1.f / l[o], dd[o], dsim[o]);
    r1 = make_float4(dout[o * V], dout[o * V + 1], dout[o * V + 2], 0.f);
  }
  float4* dst = reinterpret_cast<float4*>(rows + (size_t)i * RC);
  dst[0] = r0;
  dst[1] = r1;
}

// One block: the TK keys of tile blockIdx.x against the query tiles of
// split blockIdx.y. Writes df[b][q][k] for the block's keys and every
// query of its tiles (0 outside q < nq, k < nk), and its dvalues sums to
// dv_out[split][b][k][V]. q_map / k_map: the split [B, N, 2c] theta and
// phi (corr_score.cuh), boxes of 32 channels x 128 rows.
__global__ void __launch_bounds__(THREADS, 1)
corr_dkv_scores_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const float* __restrict__ values,
                       const float* __restrict__ rows,
                       float* __restrict__ df, float* __restrict__ dv_out,
                       int nq, int nk, int c, int tiles_per_split,
                       float inv_t) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  float* v_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                        STAGES * STAGE);  // [TK][V]
  float* dv_s = v_s + TK * V;  // [WARPS][TK][V]
  const uint32_t bars = smem_u32(dv_s + WARPS * TK * V);  // full[STAGES]

  const int nq_pad = round_up(nq, PAD);
  const int nk_pad = round_up(nk, PAD);
  const int cpt = c / CK;  // atoms per query tile
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * TK;
  const int q_begin = blockIdx.y * tiles_per_split * TQ;
  const int q_end = min(nq_pad, q_begin + tiles_per_split * TQ);
  const int n_chunks = (q_end - q_begin) / TQ * cpt;
  const float* r_g = rows + (size_t)b * nq_pad * RC;
  float* df_g = df + (size_t)b * nq_pad * nk_pad;

  // Thread 0 fills ring slot g % STAGES with atom g (query tile g / cpt,
  // channels (g % cpt) CK ..) of the queries and of the block's keys, hi
  // and lo.
  auto fill = [&](int g) {
    if (g >= n_chunks) return;
    const int slot = g % STAGES;
    const uint32_t st = base + slot * STAGE;
    const uint32_t bar = bars + 8 * slot;
    const int q0 = q_begin + g / cpt * TQ;
    const int c0 = g % cpt * CK;
    mbar_arrive_expect_tx(bar, STAGE);
    tma_load(st, &q_map, bar, c0, q0, b);
    tma_load(st + Q_ATOM, &q_map, bar, c + c0, q0, b);
    tma_load(st + 2 * Q_ATOM, &k_map, bar, c0, k0, b);
    tma_load(st + 2 * Q_ATOM + K_ATOM, &k_map, bar, c + c0, k0, b);
  };

  if (threadIdx.x == 0) mbar_init_all(bars, STAGES);
  for (int i = threadIdx.x; i < TK * V; i += THREADS)
    v_s[i] = ((size_t)k0 * V + i < (size_t)nk * V)
                 ? values[((size_t)b * nk + k0) * V + i] : 0.f;
  for (int i = threadIdx.x; i < WARPS * TK * V; i += THREADS) dv_s[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < STAGES - 1; ++g) fill(g);

  const int wg = threadIdx.x / 128;  // query rows 64 wg .. 64 wg + 63
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  float* dv_w = dv_s + threadIdx.x / 32 * TK * V;  // this warp's sums
  // wgmma's accumulator layout, as in K1: s[4 j + 2 h + e] is the score of
  // query row 16 warp + lane / 4 + 8 h of the warpgroup's 64 and key
  // column 8 j + col0 + e of the block's tile
  float s[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = p[i] = 0.f;

  for (int g = 0; g < n_chunks; ++g) {
    const int slot = g % STAGES;
    mbar_wait(bars + 8 * slot, (g / STAGES) & 1);  // atom g landed
    __syncthreads();  // and everyone is done with atom g - 1
    if (threadIdx.x == 0) fill(g + STAGES - 1);  // into atom g - 1's slot
    __syncwarp();
    const uint32_t st = base + slot * STAGE;
    const uint32_t qrows = wg * kScoreRows * 128;  // the warpgroup's rows
    score_atom(s, p, st + qrows, st + Q_ATOM + qrows, st + 2 * Q_ATOM,
               st + 2 * Q_ATOM + K_ATOM);
    if (g % cpt != cpt - 1) continue;

    // the query tile's scores are complete: attn, df and dvalues on the
    // accumulator. A lane holds two rows (h) and 32 keys (j, e).
    const int q0 = q_begin + g / cpt * TQ;
    float rm[2], rinv_l[2], rdd[2], rdsim[2], rdout[2][V];
    bool q_ok[2];
    float* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      const float4 ra = *reinterpret_cast<const float4*>(r_g + q * RC);
      const float4 rd = *reinterpret_cast<const float4*>(r_g + q * RC + 4);
      rm[h] = ra.x;
      rinv_l[h] = ra.y;
      rdd[h] = ra.z;
      rdsim[h] = ra.w;
      rdout[h][0] = rd.x;
      rdout[h][1] = rd.y;
      rdout[h][2] = rd.z;
      q_ok[h] = q < nq;
      dst[h] = df_g + (size_t)q * nk_pad + k0 + col0;
    }
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      float d[2][2], dvx[2][V];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;
        const bool k_ok = k0 + col < nk;
        const float* vk = v_s + col * V;
#pragma unroll
        for (int v = 0; v < V; ++v) dvx[e][v] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = 0.f;
          if (q_ok[h] && k_ok) {
            const float sc = s[4 * j + 2 * h + e];
            const float attn = expf((sc - rm[h]) * inv_t) * rinv_l[h];
            const float dps = rdout[h][0] * vk[0] + rdout[h][1] * vk[1] +
                              rdout[h][2] * vk[2];
            x = attn * (dps - rdd[h]) * inv_t;
            if (sc == rm[h]) x += rdsim[h];
#pragma unroll
            for (int v = 0; v < V; ++v)
              dvx[e][v] = fmaf(attn, rdout[h][v], dvx[e][v]);
          }
          d[h][e] = x;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst[h] + 8 * j) =
            make_float2(d[h][0], d[h][1]);
      // dvalues: sum over the warp's 8 lanes of each key (lanes that share
      // lane % 4), then lane lane % 4 adds it to the warp's sums
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float x = dvx[e][v];
          x += __shfl_xor_sync(kFull, x, 4);
          x += __shfl_xor_sync(kFull, x, 8);
          x += __shfl_xor_sync(kFull, x, 16);
          if (lane < 4) dv_w[(8 * j + col0 + e) * V + v] += x;
        }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;  // the next tile's scores
  }

  // dvalues: the warps saw disjoint queries of the same keys; their sums
  // are added in warp order
  __syncthreads();
  float* dv_g = dv_out + ((size_t)blockIdx.y * gridDim.z + b) * nk * V;
  for (int i = threadIdx.x; i < TK * V; i += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += dv_s[w * TK * V + i];
    if (k0 + i / V < nk) dv_g[(size_t)k0 * V + i] = a;
  }
}

// ------------------------------------------------- products, 3xTF32 mma

constexpr int PM = 128;        // output rows per block
constexpr int PN = 128;        // output channels per block
constexpr int PK = 32;         // reduction depth per ring stage
constexpr int PSTAGES = 3;     // raw ring depth: two stages in flight
constexpr int A_LD = PK + 4;   // A tile [PM][A_LD]: fragment reads on
                               // banks 4 g + t
constexpr int AT_LD = PM + 8;  // transposed A tile [PK][AT_LD]: 8 t + g
constexpr int B_LD = PN + 8;   // B tile [PK][B_LD]: 8 t + g
constexpr int A_FLOATS = PM * A_LD > PK * AT_LD ? PM * A_LD : PK * AT_LD;
constexpr int STAGE_FLOATS = A_FLOATS + PK * B_LD;

size_t product_smem_bytes() {
  return sizeof(float) * (size_t)PSTAGES * STAGE_FLOATS;
}

// (hi, lo) of x as two TF32 values in fp32 registers: hi = tf32(x),
// lo = tf32(x - hi) (x - hi is exact in fp32), as corr_score.cuh splits.
__device__ __forceinline__ float2 tf32_pair(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, tf32_rna(x - hi));
}

// d += a . b on one 16 x 8 x 8 tile (fragments as the PTX ISA lays out
// mma.m16n8k8 for .tf32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0..3 (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// out[m][n] = sum over k of A[m][k] B[k][n] for the PM x PN tile
// (blockIdx.x, blockIdx.y % n_tiles) of sample blockIdx.z, k in the
// range of split blockIdx.y / n_tiles. A is the df scratch: [m_pad][k_pad]
// row-major, or with kTransA its transpose (stored [k_pad][m_pad]); its
// padding is zero. B is [k_valid][c] row-major (phi or theta); rows past
// k_valid and columns past c are zero-filled. out is [split][batch]
// [m_valid][c].
//
// cp.async brings the fp32 tiles through a 3-stage ring; each warp runs
// its 32 x 64 of the tile, splitting its fragments into TF32 (hi, lo) as
// it loads them. 107.5 KB of shared memory and at most 128 registers a
// thread, so two blocks (16 warps) share an SM.
template <bool kTransA>
__device__ __forceinline__ void product_tile(
    const float* __restrict__ a, const float* __restrict__ bmat,
    float* __restrict__ out, int m_valid, int m_pad, int k_pad, int k_valid,
    int c, int k_per_split) {
  extern __shared__ __align__(16) float psm[];
  const int n_tiles = (c + PN - 1) / PN;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * PM;
  const int n0 = (blockIdx.y % n_tiles) * PN;
  const int split = blockIdx.y / n_tiles;
  const int k_begin = split * k_per_split;
  const int k_end = min(k_pad, k_begin + k_per_split);
  const int n_steps = (k_end - k_begin) / PK;
  const float* a_g = a + (size_t)b * m_pad * k_pad;
  const float* b_g = bmat + (size_t)b * k_valid * c;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp % 4) * 32;  // the warp's rows wm .. wm + 31
  const int wn = (warp / 4) * 64;  // and columns wn .. wn + 63
  const int g = lane / 4;
  const int t = lane % 4;

  auto fill = [&](int step) {
    if (step < n_steps) {
      float* as = psm + (step % PSTAGES) * STAGE_FLOATS;
      float* bs = as + A_FLOATS;
      const int k0 = k_begin + step * PK;
      for (int i = threadIdx.x; i < PM * PK / 4; i += THREADS) {
        if (kTransA) {  // PK rows of PM contiguous m
          const int r = i / (PM / 4), c4 = i % (PM / 4);
          cp_async16(as + r * AT_LD + 4 * c4,
                     a_g + (size_t)(k0 + r) * m_pad + m0 + 4 * c4, 16);
        } else {  // PM rows of PK contiguous k
          const int r = i / (PK / 4), c4 = i % (PK / 4);
          cp_async16(as + r * A_LD + 4 * c4,
                     a_g + (size_t)(m0 + r) * k_pad + k0 + 4 * c4, 16);
        }
      }
      for (int i = threadIdx.x; i < PK * PN / 4; i += THREADS) {
        const int r = i / (PN / 4), c4 = i % (PN / 4);
        const int k = k0 + r, n = n0 + 4 * c4;
        const bool in = k < k_valid && n < c;
        cp_async16(bs + r * B_LD + 4 * c4,
                   in ? b_g + (size_t)k * c + n : b_g, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < PSTAGES - 1; ++st) fill(st);

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<PSTAGES - 2>();
    __syncthreads();  // stage `step` landed; everyone is done with step - 1
    fill(step + PSTAGES - 1);  // into the slot step - 1 used
    const float* as = psm + (step % PSTAGES) * STAGE_FLOATS;
    const float* bs = as + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < PK; kk += 8) {
      float ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        float x[4];
        if (kTransA) {
          x[0] = as[(kk + t) * AT_LD + r];
          x[1] = as[(kk + t) * AT_LD + r + 8];
          x[2] = as[(kk + t + 4) * AT_LD + r];
          x[3] = as[(kk + t + 4) * AT_LD + r + 8];
        } else {
          x[0] = as[r * A_LD + kk + t];
          x[1] = as[(r + 8) * A_LD + kk + t];
          x[2] = as[r * A_LD + kk + t + 4];
          x[3] = as[(r + 8) * A_LD + kk + t + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 h = tf32_pair(x[e]);
          ahi[mi][e] = h.x;
          alo[mi][e] = h.y;
        }
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn + 8 * ni + g;
        const float2 y0 = tf32_pair(bs[(kk + t) * B_LD + n]);
        const float2 y1 = tf32_pair(bs[(kk + t + 4) * B_LD + n]);
        const float bhi[2] = {y0.x, y1.x}, blo[2] = {y0.y, y1.y};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // the tensor cores add a tile's products to their accumulator
          // with truncation, an error relative to the accumulator; so each
          // 8-deep step sums into a fresh one (the small terms first) and
          // is added to the running sum by an fp32 add
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, alo[mi], bhi);
          mma_tf32(p, ahi[mi], blo);
          mma_tf32(p, ahi[mi], bhi);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o_g = out + ((size_t)split * gridDim.z + b) * m_valid * c;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = m0 + wm + 16 * mi + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = n0 + wn + 8 * ni + 2 * t;
      if (n >= c) continue;  // c is even: n + 1 < c too
      if (r < m_valid)
        *reinterpret_cast<float2*>(o_g + (size_t)r * c + n) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (r + 8 < m_valid)
        *reinterpret_cast<float2*>(o_g + (size_t)(r + 8) * c + n) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// dtheta = df phi: rows are queries, the depth runs over the keys.
__global__ void __launch_bounds__(THREADS, 2)
corr_dq_product_kernel(const float* __restrict__ df,
                       const float* __restrict__ phi, float* __restrict__ out,
                       int nq, int nk, int c, int k_per_split) {
  product_tile<false>(df, phi, out, nq, round_up(nq, PAD), round_up(nk, PAD),
                      nk, c, k_per_split);
}

// dphi = df^T theta: rows are keys, the depth runs over the queries.
__global__ void __launch_bounds__(THREADS, 2)
corr_dkv_product_kernel(const float* __restrict__ df,
                        const float* __restrict__ theta,
                        float* __restrict__ out, int nq, int nk, int c,
                        int k_per_split) {
  product_tile<true>(df, theta, out, nk, round_up(nk, PAD), round_up(nq, PAD),
                     nq, c, k_per_split);
}

// ------------------------------------------------------------ split merge

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
  sum_splits_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                      st>>>(part, out, n, splits);
}

// Units of `unit` rows per split of `n` rows: splits <= units, none empty.
int per_split(int n, int unit, int* splits) {
  const int units = (n + unit - 1) / unit;
  const int per = (units + *splits - 1) / *splits;
  *splits = (units + per - 1) / per;
  return per;
}

// The product of one kernel over a batch: out = df . bmat or df^T . bmat,
// with the depth split `splits` ways (partials in `part`, merged in order).
cudaError_t launch_product(bool trans, const float* df, const float* bmat,
                           float* out, float* part, int batch, int nq, int nk,
                           int c, int splits, cudaStream_t st) {
  const int m_valid = trans ? nk : nq;
  const int depth = round_up(trans ? nq : nk, PAD);
  const int k_per_split = per_split(depth, PAD, &splits) * PAD;
  const size_t smem = product_smem_bytes();
  auto kernel = trans ? corr_dkv_product_kernel : corr_dq_product_kernel;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  float* dst = splits > 1 ? part : out;
  const dim3 grid(round_up(m_valid, PAD) / PM, (c + PN - 1) / PN * splits,
                  batch);
  kernel<<<grid, THREADS, smem, st>>>(df, bmat, dst, nq, nk, c, k_per_split);
  if (splits > 1) sum_splits(part, out, (size_t)batch * m_valid * c, splits, st);
  return cudaGetLastError();
}

}  // namespace

// K3's score pass: theta [B, nq, c], phi [B, nk, c] (16-byte aligned,
// c % 32 == 0), values [B, nk, 3], m, l, dd, dsim [B, nq], dout [B, nq,
// 3], all fp32 and contiguous. Scratch: split (B * (nq + nk) * 2c floats,
// the TF32 halves of theta and phi, corr_score.cuh), rows [B, nq', 8] and
// df [B, nq', nk'] (nq', nk' = nq, nk rounded up to 128; df is written
// whole and left for devc_corr_bwd_dphi and devc_corr_bwd_dq), and with
// splits > 1 part_v (splits * B * nk * 3 floats). Writes dvalues [B, nk,
// 3]. Returns cudaGetLastError() after the last launch (or the first
// error), cudaErrorInvalidValue when c is not a multiple of 32 or a tensor
// map cannot be built.
extern "C" int devc_corr_bwd_dkv(const void* theta, const void* phi,
                                 const void* values, const void* m,
                                 const void* l, const void* dd,
                                 const void* dsim, const void* dout,
                                 void* split, void* rows, void* df,
                                 void* dvalues, void* part_v, int batch,
                                 int nq, int nk, int c, int splits,
                                 float inv_t, void* stream) {
  if (c % CK != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq_pad = round_up(nq, PAD);
  const int total = batch * nq_pad;
  corr_dkv_rows_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dd), static_cast<const float*>(dsim),
      static_cast<const float*>(dout), static_cast<float*>(rows), nq, nq_pad,
      total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* q_split = static_cast<float*>(split);
  float* k_split = q_split + (size_t)batch * nq * 2 * c;
  err = devc::split_tf32(static_cast<const float*>(theta), q_split,
                         (size_t)batch * nq, c, st);
  if (err != cudaSuccess) return (int)err;
  err = devc::split_tf32(static_cast<const float*>(phi), k_split,
                         (size_t)batch * nk, c, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map, k_map;
  if (!devc::make_map(&q_map, q_split, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      2 * c, nq, batch, CK, TQ, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !devc::make_map(&k_map, k_split, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                      2 * c, nk, batch, CK, TK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  const int per = per_split(nq_pad, TQ, &splits);
  err = cudaFuncSetAttribute(corr_dkv_scores_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scores_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  float* dv_dst = splits > 1 ? static_cast<float*>(part_v)
                             : static_cast<float*>(dvalues);
  const dim3 grid(round_up(nk, PAD) / TK, splits, batch);
  corr_dkv_scores_kernel<<<grid, THREADS, scores_smem_bytes(), st>>>(
      q_map, k_map, static_cast<const float*>(values),
      static_cast<const float*>(rows), static_cast<float*>(df), dv_dst, nq,
      nk, c, per, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1)
    sum_splits(dv_dst, static_cast<float*>(dvalues), (size_t)batch * nk * V,
               splits, st);
  return (int)cudaGetLastError();
}

// K3's product: dphi [B, nk, c] = df^T theta from devc_corr_bwd_dkv's df
// [B, nq', nk'] and theta [B, nq, c]. With splits > 1, `part` is scratch
// of splits * B * nk * c floats. Returns cudaGetLastError().
extern "C" int devc_corr_bwd_dphi(const void* df, const void* theta,
                                  void* dphi, void* part, int batch, int nq,
                                  int nk, int c, int splits, void* stream) {
  if (c % CK != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_product(true, static_cast<const float*>(df),
                             static_cast<const float*>(theta),
                             static_cast<float*>(dphi),
                             static_cast<float*>(part), batch, nq, nk, c,
                             splits, static_cast<cudaStream_t>(stream));
}

// K2b: dtheta [B, nq, c] = df phi from devc_corr_bwd_dkv's df [B, nq',
// nk'] and phi [B, nk, c]. With splits > 1, `part` is scratch of
// splits * B * nq * c floats. Returns cudaGetLastError().
extern "C" int devc_corr_bwd_dq(const void* df, const void* phi,
                                void* dtheta, void* part, int batch, int nq,
                                int nk, int c, int splits, void* stream) {
  if (c % CK != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_product(false, static_cast<const float*>(df),
                             static_cast<const float*>(phi),
                             static_cast<float*>(dtheta),
                             static_cast<float*>(part), batch, nq, nk, c,
                             splits, static_cast<cudaStream_t>(stream));
}
