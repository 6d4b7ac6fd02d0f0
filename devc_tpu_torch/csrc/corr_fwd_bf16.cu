// K1 on bf16 embeddings, with its scores on Hopper's bf16 tensor cores:
// s = theta . phi^T (bf16 x bf16, fp32 accumulation), per-row online max m
// and denominator l, out = sum_k exp((s - m) / T) v_k / l rounded to bf16
// (RNE), sim = m and l in fp32.
//
// Replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel on bf16 theta and
// phi (devc_tpu's --bf16 mode: pallas_corr.py::_scores multiplies bf16 x
// bf16 with fp32 accumulation on the MXU). Reached through
// ops/cuda_corr.py::corr_fwd with bf16 inputs; fp32 inputs run
// corr_fwd.cu.
//
// What bounds it on the H100: the score products, 2 N^2 C FLOP (13.8
// GFLOP at N = 5184, C = 256) on O(N C) bytes, at the bf16 tensor rate
// (989 TFLOP/s); beside them the online softmax does a few ALU
// instructions per score (a max and, per lane, an underflow test) and,
// per score whose weight does not underflow, an expf and four FMAs (P.V
// has a value width of 3 and stays in fp32 on the FMA pipe, as in
// devc_tpu). The design:
//   * a block is four warpgroups (512 threads); each owns 64 query rows
//     (TQ = 256 a block). Its scores against a tile of TK = 128 keys are
//     one wgmma.m64n128k16 accumulator (64 fp32 registers a thread),
//     built by C / 16 dense bf16 wgmma steps with both operands K-major
//     (channels contiguous) in shared memory: no transpose is staged.
//     Every key atom a block loads feeds all 256 query rows: with 128
//     rows a block, the keys' traffic from L2 held the products back;
//   * shared tiles are "atoms" of [rows][64 channels] bf16: 128-byte rows
//     in the 128-byte swizzle (16-byte piece p of row r at piece p ^ (r %
//     8), 1024-byte aligned), the layout wgmma's descriptors read without
//     bank conflicts. TMA writes them (cp.async.bulk.tensor, 3-D maps over
//     [B, N, C] built on the host for each launch and passed as
//     __grid_constant__ parameters; rows past N and channels past C come
//     back zero), one thread issues each copy and an mbarrier per stage
//     counts its bytes (copies issued by every thread with cp.async
//     spent as long issuing as the tensor cores spent multiplying);
//   * the query tile (C / 64 atoms, 128 KB at C = 256) is loaded once and
//     stays resident where it fits beside the ring (C <= 320); above that
//     each stage carries the matching query atom as well;
//   * the keys stream through a ring of STAGES 64-channel atoms, one block
//     barrier per atom (it frees the slot the next copy fills); a key
//     tile's values (fp32, padded to 16-byte rows by the wrapper) ride
//     with its last atom. C % 64 == 32 leaves a last atom half full,
//     multiplied in two steps of 16 channels instead of four;
//   * the online softmax runs on the accumulator registers: in wgmma's
//     layout a row belongs to one quad of lanes, so the row max is a
//     local fmaxf over the lane's 32 columns and two __shfl_xor_sync
//     steps; each lane keeps its share of l and acc, summed over the quad
//     at the end;
//   * one block an SM; where the query tiles do not fill the card (21 at
//     N = 5184), the keys are split into ranges of whole tiles
//     (ops/cuda_corr.py::bf16_plan picks the count from the SM count) and
//     corr_combine.cuh merges the partial (m, l, acc) in split order, as
//     for the fp32 kernel.
//
// Exactness at T -> 0, the rules of the fp32 kernel: (s - m) * inv_t is
// formed in fp32 and fed to expf (no fast math, no exp2 pre-scaling); l
// and acc are rescaled by expf((m_prev - m_new) * inv_t) before a tile is
// added, and partials when merged, so a tie at the row max contributes
// exactly 1 and everything else exactly 0. A weight is skipped only where
// its exponent is below kUnderflow, where expf is exactly 0, so the skips
// change no bit (at T = 1e-10 they remove almost all the exponentials).
// Key columns past the end never enter the max or the sums; every key
// tile a block visits holds a valid key, so m is finite after its first
// tile. Two identical keys get identical scores (the tensor cores sum
// each output over the channels alike), so an exact tie averages exactly.
// No atomics, a fixed merge order: two runs give the same bits.
//
// What it gives up: a product of two bf16 values is exact in fp32, so the
// scores differ from the fp32 kernel's on the upcast inputs only in
// summation order (as devc_tpu's MXU product does), and are not bit-equal
// to them. Nothing needs those bits: the backward's s == m routing binds
// the fp32 score rule (corr_score.cuh) only, and the differentiable path
// refuses bf16, so no kernel reads this kernel's m.
//
// The fp32 kernel (corr_fwd.cu) shares this kernel's skeleton: its
// mbarrier ring, TMA maps and accumulator softmax, with 32-channel fp32
// atoms in 3xTF32 (corr_score.cuh); the Hopper helpers both use are in
// hopper.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "corr_combine.cuh"
#include "hopper.cuh"

namespace {

using namespace devc;

constexpr int TQ = 256;        // query rows per block: a warpgroup per 64
constexpr int TK = 128;        // keys per tile: the wgmma's N
constexpr int CK = 64;         // channels per atom: one 128-byte swizzled row
constexpr int STAGES = 3;      // ring depth: two atoms in flight
constexpr int THREADS = 2 * TQ;  // 128 threads (a warpgroup) per 64 rows
constexpr int Q_ATOM = TQ * 128;  // bytes of a query atom: TQ rows x 128 B
constexpr int K_ATOM = TK * 128;  // bytes of a key atom
constexpr int VW = 4;             // values padded to 16-byte rows
constexpr int V_TILE = TK * VW * 4;  // bytes of a key tile's values
constexpr int ALIGN = 1024;    // an atom's base alignment (the swizzle's repeat)
constexpr int V = devc::kCorrV;
constexpr int PART = devc::kCorrPart;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
// expf(x) is exactly 0 in fp32 for x below about -103.97; a margin below
constexpr float kUnderflow = -120.f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(TQ % 64 == 0 && TQ <= 256 && TK == 128, "warpgroups of 64 rows");

__host__ __device__ constexpr int atoms_of(int c) { return (c + CK - 1) / CK; }

// Dynamic shared memory of a block: slack to align the atoms, the query
// tile (all its atoms when resident, else one per stage), the key ring,
// the values ring and the mbarriers (one per stage, one for the query
// tile).
__host__ __device__ constexpr size_t smem_bytes(bool resident, int c) {
  return (size_t)ALIGN + (size_t)Q_ATOM * (resident ? atoms_of(c) : STAGES) +
         (size_t)STAGES * (K_ATOM + V_TILE) + 8 * (STAGES + 1);
}

// d (+)= A B for a 64 x 16 slice of queries (A) and a 128 x 16 slice of
// keys (B^T), both bf16 K-major in shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One block: TQ query rows against the key tiles of one split. With
// part == nullptr (one split) it writes out / sim / l_out; otherwise it
// writes its partial (m, l, acc) to part[split][b][q][PART].
template <bool kResident>
__global__ void __launch_bounds__(THREADS, 1)
corr_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ sim,
                     float* __restrict__ l_out, float* __restrict__ part,
                     int nq, int nk, int c, int tiles_per_split,
                     float inv_t) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int cpt = atoms_of(c);  // atoms per key tile
  // resident: the query tile's cpt atoms; else one query atom per stage
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Q_ATOM * (kResident ? cpt : STAGES);
  const uint32_t v_s = k_s + STAGES * K_ATOM;  // [STAGES][TK][VW] fp32
  const uint32_t bars = v_s + STAGES * V_TILE;  // full[STAGES], then q
  const uint32_t q_bar = bars + 8 * STAGES;
  const float* v_gen = reinterpret_cast<const float*>(smem_raw + (v_s - raw));

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const int k_begin = blockIdx.y * tiles_per_split * TK;
  const int k_end = min(nk, k_begin + tiles_per_split * TK);
  const int n_chunks = (k_end - k_begin + TK - 1) / TK * cpt;

  // Thread 0 fills ring slot g % STAGES with atom g (key tile g / cpt,
  // channels (g % cpt) CK ..), the matching query atom when the queries
  // stream, and the tile's values on its last atom.
  auto fill = [&](int g) {
    if (g >= n_chunks) return;
    const int slot = g % STAGES;
    const uint32_t bar = bars + 8 * slot;
    const int k0 = k_begin + g / cpt * TK;
    const int c0 = g % cpt * CK;
    const bool last = g % cpt == cpt - 1;
    mbar_arrive_expect_tx(
        bar, K_ATOM + (kResident ? 0 : Q_ATOM) + (last ? V_TILE : 0));
    tma_load(k_s + slot * K_ATOM, &k_map, bar, c0, k0, b);
    if (!kResident) tma_load(q_s + slot * Q_ATOM, &q_map, bar, c0, q0, b);
    if (last) tma_load(v_s + slot * V_TILE, &v_map, bar, 0, k0, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kResident) {
      mbar_arrive_expect_tx(q_bar, Q_ATOM * cpt);
      for (int a = 0; a < cpt; ++a)
        tma_load(q_s + a * Q_ATOM, &q_map, q_bar, a * CK, q0, b);
    }
    for (int g = 0; g < STAGES - 1; ++g) fill(g);
  }
  if (kResident) mbar_wait(q_bar, 0);

  const int wg = threadIdx.x / 128;  // query rows 64 wg .. 64 wg + 63
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  // wgmma's accumulator layout: s[4 j + 2 h + e] is the score of row
  // 16 warp + lane / 4 + 8 h of the warpgroup's 64 and key column
  // 8 j + col0 + e of the tile
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2][V] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};

  for (int g = 0; g < n_chunks; ++g) {
    const int slot = g % STAGES;
    mbar_wait(bars + 8 * slot, (g / STAGES) & 1);  // atom g landed
    __syncthreads();  // and everyone is done with atom g - 1
    if (threadIdx.x == 0) fill(g + STAGES - 1);  // into atom g - 1's slot
    __syncwarp();
    const int ch = g % cpt;
    const int cw = min(CK, c - ch * CK);
    const uint32_t qa =
        (kResident ? q_s + ch * Q_ATOM : q_s + slot * Q_ATOM) + wg * 64 * 128;
    const uint32_t ka = k_s + slot * K_ATOM;
    fence_acc(s);
    wgmma_fence();
    // straight-line steps of 16 channels (32 bytes of the swizzled rows)
    if (cw == CK) {
      wgmma_m64n128k16(s, desc_sw128(qa), desc_sw128(ka), ch > 0);
      wgmma_m64n128k16(s, desc_sw128(qa + 32), desc_sw128(ka + 32), 1);
      wgmma_m64n128k16(s, desc_sw128(qa + 64), desc_sw128(ka + 64), 1);
      wgmma_m64n128k16(s, desc_sw128(qa + 96), desc_sw128(ka + 96), 1);
    } else {  // a last half atom of 32 channels
      wgmma_m64n128k16(s, desc_sw128(qa), desc_sw128(ka), ch > 0);
      wgmma_m64n128k16(s, desc_sw128(qa + 32), desc_sw128(ka + 32), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    if (ch != cpt - 1) continue;

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
      // T = 1e-10 most lanes of most tiles: the warp then skips the row),
      // and a live lane steps over the exponents below the bound (at
      // T = 1e-10 all but the max's).
      const bool live = (lane_max - m_new) * inv_t >= kUnderflow;
      if (live) {
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + col0 + e;
            const float x = (s[4 * j + 2 * h + e] - m_new) * inv_t;
            if (col < kv && x >= kUnderflow) {
              const float p = expf(x);
              l[h] += p;
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[h][v] = fmaf(p, vb[col * VW + v], acc[h][v]);
            }
          }
        }
      }
      m[h] = m_new;
    }
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
      for (int v = 0; v < V; ++v) devc::store_out(out + o * V + v, ai[v] / li);
      sim[o] = m[h];
      if (l_out != nullptr) l_out[o] = li;
    } else {
      float* p = part + ((size_t)blockIdx.y * gridDim.z * nq + o) * PART;
      p[0] = m[h];
      p[1] = li;
#pragma unroll
      for (int v = 0; v < V; ++v) p[2 + v] = ai[v];
    }
  }
}

bool resident_form(int c) { return smem_bytes(true, c) <= kMaxSmem; }

}  // namespace

// theta [B, nq, c], phi [B, nk, c] bf16; values [B, nk, 4] fp32 (the
// fourth column unread); all contiguous and 16-byte aligned, c % 32 == 0.
// Writes out [B, nq, 3] in bf16, sim [B, nq] and, when l_out is not null,
// l [B, nq] in fp32. With splits > 1 the keys are split into that many
// ranges of whole tiles (splits <= ceil(nk / 128); ops/cuda_corr.py::
// bf16_plan) and `part` is scratch of splits * B * nq * 5 floats. No host
// sync, no allocation: capturable. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a tensor map cannot be built.
extern "C" int devc_corr_fwd_bf16(const void* theta, const void* phi,
                                  const void* values, void* out, void* sim,
                                  void* l_out, void* part, int batch, int nq,
                                  int nk, int c, int splits, float inv_t,
                                  void* stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!devc::make_map(&q_map, theta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c,
                      nq, batch, CK, TQ, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !devc::make_map(&k_map, phi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c, nk,
                      batch, CK, TK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !devc::make_map(&v_map, values, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, VW,
                      nk, batch, VW, TK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int tiles = (nk + TK - 1) / TK;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  splits = (tiles + tiles_per_split - 1) / tiles_per_split;  // none empty
  const dim3 grid((nq + TQ - 1) / TQ, splits, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_f = splits > 1 ? static_cast<float*>(part) : nullptr;
  const bool resident = resident_form(c);
  const size_t smem = smem_bytes(resident, c);
  auto kernel =
      resident ? corr_fwd_bf16_kernel<true> : corr_fwd_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(sim), static_cast<float*>(l_out), part_f, nq, nk, c,
      tiles_per_split, inv_t);
  if (splits > 1) {
    const int rows = batch * nq;
    devc::corr_combine_kernel<__nv_bfloat16>
        <<<(rows + 255) / 256, 256, 0, st>>>(
            part_f, static_cast<__nv_bfloat16*>(out),
            static_cast<float*>(sim), static_cast<float*>(l_out), rows,
            splits, inv_t);
  }
  return (int)cudaGetLastError();
}

// The kernel's form for c channels: its dynamic shared memory in bytes,
// and in *resident whether the query tile stays resident (1) or streams
// through the ring (0). ops/cuda_corr.py::bf16_plan must agree.
extern "C" int devc_corr_fwd_bf16_form(int c, int* resident) {
  *resident = resident_form(c) ? 1 : 0;
  return (int)smem_bytes(resident_form(c), c);
}
