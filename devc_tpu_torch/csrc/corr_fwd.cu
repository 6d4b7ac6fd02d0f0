// K1 on fp32 embeddings, with its scores on Hopper's tensor cores in
// 3xTF32: s = theta . phi^T, per-row online max m and denominator l,
// out = sum_k exp((s - m) / T) v_k / l, sim = m (and l).
//
// Replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel (the Pallas TPU
// kernel behind correspondence_warp_pallas) on fp32 theta and phi; bf16
// embeddings run corr_fwd_bf16.cu, whose skeleton this kernel shares. The
// N x N score matrix never reaches device memory.
//
// Every score is formed by the fp32 score rule (corr_score.cuh): theta
// and phi split once into TF32 hi / lo by a pre-pass, per 32-channel atom
// lo.hi + hi.lo then hi.hi on the tensor cores in a fresh accumulator,
// added to the score by an fp32 add. K3's score pass (corr_bwd.cu) forms
// its scores with the same routine at the same places of the same
// wgmma.m64n128k8, so its s == m test finds this kernel's m bit for bit.
//
// What bounds it on the H100: the scores, 2 N^2 C FLOP (13.8 GFLOP at N =
// 5184, C = 256) that the tensor cores form as three TF32 passes (495
// TFLOP/s: 0.083 ms), on O(N C) bytes; beside them the online softmax
// (a max and an underflow test a score; an expf and four FMAs a score
// whose weight does not underflow: at T = 0.01 every score, at T = 1e-10
// almost none). The design, corr_fwd_bf16.cu's with fp32 atoms:
//   * a block is two warpgroups (256 threads); each owns 64 query rows
//     (TQ = 128 a block). Its scores against a tile of TK = 128 keys are
//     one m64n128 accumulator (64 fp32 registers a thread) built atom by
//     atom beside a second one for the atom's partial (the rule's p);
//   * shared tiles are atoms of [rows][32 channels] fp32: 128-byte rows
//     in the 128-byte swizzle, the layout wgmma's descriptors read without
//     bank conflicts, written by TMA (3-D maps over the split [B, N, 2C]
//     arrays, hi at channel c0 and lo at C + c0, and over the values
//     padded to 16-byte rows; rows past N come back zero). One thread
//     issues a stage's copies and an mbarrier per stage counts its bytes;
//   * a stage is one atom of the queries and one of the keys, hi and lo
//     each (64 KB), and a key tile's values ride with its last atom; a
//     ring of STAGES stages, one block barrier per stage. The queries
//     stream with the keys: resident in hi and lo, 128 rows of C = 256
//     would take 256 KB, more than a block has (the query atoms come from
//     L2 once per key tile);
//   * the online softmax runs on the accumulator registers: in wgmma's
//     layout a row belongs to one quad of lanes, so the row max is a local
//     fmaxf over the lane's 32 columns and two __shfl_xor_sync steps; each
//     lane keeps its share of l and acc, summed over the quad at the end;
//   * one block an SM (~200 KB of shared memory); where the query tiles
//     do not fill the card (41 at N = 5184), the keys are split into
//     ranges of whole tiles (ops/cuda_corr.py::fp32_plan picks the count
//     from the SM count) and corr_combine.cuh merges the partial (m, l,
//     acc) in split order. Key ranges are whole 128-key tiles, so a key
//     keeps its column of the tile whatever the split.
//
// Exactness at T -> 0: (s - m) * inv_t is formed in fp32 and fed to expf
// (no fast math, no exp2 pre-scaling); l and acc are rescaled by
// expf((m_prev - m_new) * inv_t) before a tile is added, and partials
// when merged, so a tie at the row max contributes exactly 1 and
// everything else exactly 0. A weight is skipped only where its exponent
// is below kUnderflow, where expf is exactly 0, so the skips change no bit
// (at T = 1e-10 they remove almost all the exponentials). Key columns past
// the end never enter the max or the sums; every key tile a block visits
// holds a valid key, so m is finite after its first tile. Two identical
// keys get identical scores (each output of the tensor cores is summed
// over the channels alike), so an exact tie averages exactly. No atomics,
// a fixed merge order: two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "corr_combine.cuh"
#include "corr_score.cuh"

namespace {

using namespace devc;

constexpr int TQ = 128;        // query rows per block: a warpgroup per 64
constexpr int TK = 128;        // keys per tile: the wgmma's N
constexpr int CK = 32;         // channels per atom: one 128-byte fp32 row
constexpr int STAGES = 3;      // ring depth: two stages in flight
constexpr int THREADS = 2 * TQ;  // 128 threads (a warpgroup) per 64 rows
constexpr int Q_ATOM = TQ * 128;  // bytes of a query atom (hi or lo)
constexpr int K_ATOM = TK * 128;  // bytes of a key atom (hi or lo)
constexpr int STAGE = 2 * Q_ATOM + 2 * K_ATOM;  // q hi, q lo, k hi, k lo
constexpr int VW = 4;             // values padded to 16-byte rows
constexpr int V_TILE = TK * VW * 4;  // bytes of a key tile's values
constexpr int ALIGN = 1024;    // an atom's base alignment (the swizzle's repeat)
constexpr int V = kCorrV;
constexpr int PART = kCorrPart;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
// expf(x) is exactly 0 in fp32 for x below about -103.97; a margin below
constexpr float kUnderflow = -120.f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(TQ == 2 * kScoreRows && TK == kScoreKeys && CK == kScoreAtom,
              "the score rule's tile: warpgroups of 64 rows, 128 keys, "
              "32-channel atoms");

// Dynamic shared memory of a block: slack to align the atoms, the ring of
// stages, the values ring and an mbarrier per stage.
constexpr size_t smem_bytes() {
  return (size_t)ALIGN + (size_t)STAGES * (STAGE + V_TILE) + 8 * STAGES;
}
static_assert(smem_bytes() <= kMaxSmem, "one block's shared memory");

// One block: TQ query rows against the key tiles of one split. With
// part == nullptr (one split) it writes out / sim / l_out; otherwise it
// writes its partial (m, l, acc) to part[split][b][q][PART].
__global__ void __launch_bounds__(THREADS, 1)
corr_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                float* __restrict__ out, float* __restrict__ sim,
                float* __restrict__ l_out, float* __restrict__ part, int nq,
                int nk, int c, int tiles_per_split, float inv_t) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t v_s = base + STAGES * STAGE;   // [STAGES][TK][VW] fp32
  const uint32_t bars = v_s + STAGES * V_TILE;  // full[STAGES]
  const float* v_gen = reinterpret_cast<const float*>(smem_raw + (v_s - raw));

  const int cpt = c / CK;  // atoms per key tile
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int k_begin = blockIdx.y * tiles_per_split * TK;
  const int k_end = min(nk, k_begin + tiles_per_split * TK);
  const int n_chunks = (k_end - k_begin + TK - 1) / TK * cpt;

  // Thread 0 fills ring slot g % STAGES with atom g (key tile g / cpt,
  // channels (g % cpt) CK ..) of the queries and the keys, hi and lo, and
  // the tile's values on its last atom.
  auto fill = [&](int g) {
    if (g >= n_chunks) return;
    const int slot = g % STAGES;
    const uint32_t st = base + slot * STAGE;
    const uint32_t bar = bars + 8 * slot;
    const int k0 = k_begin + g / cpt * TK;
    const int c0 = g % cpt * CK;
    const bool last = g % cpt == cpt - 1;
    mbar_arrive_expect_tx(bar, STAGE + (last ? V_TILE : 0));
    tma_load(st, &q_map, bar, c0, q0, b);
    tma_load(st + Q_ATOM, &q_map, bar, c + c0, q0, b);
    tma_load(st + 2 * Q_ATOM, &k_map, bar, c0, k0, b);
    tma_load(st + 2 * Q_ATOM + K_ATOM, &k_map, bar, c + c0, k0, b);
    if (last) tma_load(v_s + slot * V_TILE, &v_map, bar, 0, k0, b);
  };

  if (threadIdx.x == 0) mbar_init_all(bars, STAGES);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < STAGES - 1; ++g) fill(g);

  const int wg = threadIdx.x / 128;  // query rows 64 wg .. 64 wg + 63
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  // wgmma's accumulator layout: s[4 j + 2 h + e] is the score of row
  // 16 warp + lane / 4 + 8 h of the warpgroup's 64 and key column
  // 8 j + col0 + e of the tile
  float s[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = p[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2][V] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};

  for (int g = 0; g < n_chunks; ++g) {
    const int slot = g % STAGES;
    mbar_wait(bars + 8 * slot, (g / STAGES) & 1);  // atom g landed
    __syncthreads();  // and everyone is done with atom g - 1
    if (threadIdx.x == 0) fill(g + STAGES - 1);  // into atom g - 1's slot
    __syncwarp();
    const uint32_t st = base + slot * STAGE;
    const uint32_t rows = wg * kScoreRows * 128;  // the warpgroup's rows
    score_atom(s, p, st + rows, st + Q_ATOM + rows, st + 2 * Q_ATOM,
               st + 2 * Q_ATOM + K_ATOM);
    if (g % cpt != cpt - 1) continue;

    // the key tile's scores are complete: the online softmax on the
    // accumulator; column j of the tile is key k0 + j, valid below kv
    const int k0 = k_begin + g / cpt * TK;
    const int kv = k_end - k0;
    const float* vb = v_gen + slot * TK * VW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the row's max over this lane's valid columns, then over the quad
      float lane_max = -INFINITY;
      if (kv >= TK) {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            lane_max = fmaxf(lane_max, s[4 * j + 2 * h + e]);
      } else {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + col0 + e < kv)
              lane_max = fmaxf(lane_max, s[4 * j + 2 * h + e]);
      }
      float tmax = fmaxf(lane_max, __shfl_xor_sync(kFull, lane_max, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      // m == -inf only before the first tile, where l and acc are 0
      const float scale =
          (m[h] == -INFINITY) ? 0.f : expf((m[h] - m_new) * inv_t);
      l[h] *= scale;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[h][v] *= scale;
      // The weights whose exponent does not underflow: expf is exactly 0
      // below kUnderflow, and adding 0 changes neither l nor acc. The
      // exponent rises with the score (both roundings are monotonic), so
      // a lane whose largest score underflows has no weight to add (at
      // T = 1e-10 most lanes of most tiles), and a live lane steps over
      // the exponents below the bound (at T = 1e-10 all but the max's).
      const bool live = (lane_max - m_new) * inv_t >= kUnderflow;
      if (live) {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + col0 + e;
            const float x = (s[4 * j + 2 * h + e] - m_new) * inv_t;
            if (col < kv && x >= kUnderflow) {
              const float w = expf(x);
              l[h] += w;
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[h][v] = fmaf(w, vb[col * VW + v], acc[h][v]);
            }
          }
        }
      }
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;  // the next tile's scores
  }

  // sum the quad's shares of each row (they share m) and store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float li = l[h];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    float ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ai[v] = acc[h][v];
      ai[v] += __shfl_xor_sync(kFull, ai[v], 1);
      ai[v] += __shfl_xor_sync(kFull, ai[v], 2);
    }
    const int q = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (lane % 4 != 0 || q >= nq) continue;
    const size_t o = (size_t)b * nq + q;
    if (part == nullptr) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[o * V + v] = ai[v] / li;
      sim[o] = m[h];
      if (l_out != nullptr) l_out[o] = li;
    } else {
      float* pp = part + ((size_t)blockIdx.y * gridDim.z * nq + o) * PART;
      pp[0] = m[h];
      pp[1] = li;
#pragma unroll
      for (int v = 0; v < V; ++v) pp[2 + v] = ai[v];
    }
  }
}

}  // namespace

// theta [B, nq, c], phi [B, nk, c] fp32; values [B, nk, 4] fp32 (the
// fourth column unread); all contiguous and 16-byte aligned, c % 32 == 0.
// `split` is scratch of B * (nq + nk) * 2c floats for the TF32 halves of
// theta and phi (corr_score.cuh). Writes out [B, nq, 3], sim [B, nq] and,
// when l_out is not null, l [B, nq]. With splits > 1 the keys are split
// into that many ranges of whole tiles (splits <= ceil(nk / 128);
// ops/cuda_corr.py::fp32_plan) and `part` is scratch of splits * B * nq *
// 5 floats. No host sync, no allocation: capturable. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when c is not a multiple of
// 32 or a tensor map cannot be built.
extern "C" int devc_corr_fwd(const void* theta, const void* phi,
                             const void* values, void* out, void* sim,
                             void* l_out, void* part, void* split, int batch,
                             int nq, int nk, int c, int splits, float inv_t,
                             void* stream) {
  if (c % CK != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* q_split = static_cast<float*>(split);
  float* k_split = q_split + (size_t)batch * nq * 2 * c;
  cudaError_t err = devc::split_tf32(static_cast<const float*>(theta),
                                     q_split, (size_t)batch * nq, c, st);
  if (err != cudaSuccess) return (int)err;
  err = devc::split_tf32(static_cast<const float*>(phi), k_split,
                         (size_t)batch * nk, c, st);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap q_map, k_map, v_map;
  if (!devc::make_map(&q_map, q_split, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * c,
                nq, batch, CK, TQ, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !devc::make_map(&k_map, k_split, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * c,
                nk, batch, CK, TK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !devc::make_map(&v_map, values, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, VW, nk,
                batch, VW, TK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int tiles = (nk + TK - 1) / TK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  splits = (tiles + tiles_per_split - 1) / tiles_per_split;  // none empty
  const dim3 grid((nq + TQ - 1) / TQ, splits, batch);
  float* part_f = splits > 1 ? static_cast<float*>(part) : nullptr;
  err = cudaFuncSetAttribute(corr_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes());
  if (err != cudaSuccess) return (int)err;
  corr_fwd_kernel<<<grid, THREADS, smem_bytes(), st>>>(
      q_map, k_map, v_map, static_cast<float*>(out), static_cast<float*>(sim),
      static_cast<float*>(l_out), part_f, nq, nk, c, tiles_per_split, inv_t);
  if (splits > 1) {
    const int rows = batch * nq;
    devc::corr_combine_kernel<float><<<(rows + 255) / 256, 256, 0, st>>>(
        part_f, static_cast<float*>(out), static_cast<float*>(sim),
        static_cast<float*>(l_out), rows, splits, inv_t);
  }
  return (int)cudaGetLastError();
}

// The kernel's dynamic shared memory in bytes (the same at every width).
// ops/cuda_corr.py::fp32_plan must agree.
extern "C" int devc_corr_fwd_smem() { return (int)smem_bytes(); }

// The score rule's pre-pass alone (corr_score.cuh): dst [rows][2c] = the
// TF32 (hi | lo) of src [rows][c], c % 4 == 0, both 16-byte aligned. For
// timing it apart; devc_corr_fwd and devc_corr_bwd_dkv run it themselves.
extern "C" int devc_split_tf32(const void* src, void* dst, long long rows,
                               int c, void* stream) {
  if (c % 4 != 0 || c <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  return (int)devc::split_tf32(static_cast<const float*>(src),
                               static_cast<float*>(dst), (size_t)rows, c,
                               static_cast<cudaStream_t>(stream));
}
