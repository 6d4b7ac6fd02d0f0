// The fp32-accurate split convolution (ops/conv_split.py, run by
// ops/layers.py::Conv2d): out = conv2d(x, w) + bias on Hopper's TF32
// tensor cores, every product formed by the fp32 score rule of
// corr_score.cuh (3xTF32: x = x_hi + x_lo, w = w_hi + w_lo, per 32-channel
// atom lo.hi and hi.lo, then hi.hi, on wgmma in a fresh accumulator, added
// to the output by an fp32 add).
//
// Replaces no TPU kernel: devc_tpu's convolutions run in fp32 on the MXU
// through XLA. On the H100 cuDNN runs fp32 convolutions on the CUDA cores
// (67 TFLOP/s, ~20 achieved at 432x768). cuDNN's own TF32 kernels, fed the
// split operands stacked on the channels, are fast but sum all 3 C k^2
// products of an output in one tensor-core accumulator, which truncates:
// 2-6x fp32's distance from float64 a layer, ~15x through VGG19, enough
// to flip the T = 1e-10 warp's argmax on many more pixels than fp32 does
// (chip_conv_probe.py --split, PERF.md). Here the accumulator is fresh
// every 32 channels, as in K1, so the result keeps fp32's accuracy.
//
// The convolution as a product (implicit GEMM): rows are output pixels,
// columns output channels, the depth k^2 C, walked tap by tap and, inside
// a tap, in atoms of 32 input channels. What bounds it on the H100: the
// 2 k^2 C C_out H' W' FLOP, formed as three TF32 passes (495 TFLOP/s: 165
// of fp32-accurate work), on O(C H W + k^2 C C_out) bytes. The design:
//   * a block is two warpgroups (256 threads) and one 128 x 128 tile: 64
//     output pixels a warpgroup (wgmma's M) by 128 output channels (its
//     N), the score rule's tile; the accumulator is 64 fp32 registers a
//     thread, beside the atom's fresh one and the atom's input (hi, lo
//     and the next atom's loads); one block an SM;
//   * the weights, split once into TF32 hi | lo when a module first runs
//     the path ([k^2][C_out][2C], cached by ops/layers.py::Conv2d), come
//     by TMA in the 128-byte swizzle, hi and lo of 128 channels x 32
//     input channels an atom (rows past C_out read as zero), shared by
//     both warpgroups;
//   * the input is gathered by the threads straight into the registers
//     wgmma reads its A operand from: each thread loads, for each 8-channel
//     step of the atom, its two pixels' two channels at the tap's offset
//     (zero outside the image: the padding), and splits them into hi and
//     lo (tf32_rna, the rule's rounding) as it feeds them in
//     (corr_score.cuh::score_atom_ra). So the input never passes through
//     shared memory, and the split costs no pass of its own over memory;
//     every warp load is four 32-byte runs of image rows;
//   * a ring of four weight stages, filled three atoms ahead by thread 0;
//     a full barrier a stage (the TMA's bytes), and an empty one that
//     counts the 8 warps done with it before the refill; each thread's
//     loads of the next atom's input are in flight during the product.
//     The warpgroups share nothing else and run at their own pace;
//   * where the tiles do not fill the card (the layers at 27x48 and below
//     have 3-44 tiles), the atoms are split into ranges over blocks
//     (ops/conv_split.py::plan_splits picks the count from the SM count
//     and the shape of one sample); each writes its partial, and a second
//     launch sums them in split order;
//   * the epilogue adds the bias (one fp32 add, as PyTorch adds it after
//     cuDNN's convolution) and writes NCHW, 8 pixels in a row of a
//     channel per quad of lanes. Grid z is the batch: each sample is
//     computed alike, so a sample's bits do not depend on the batch.
// No atomics, a fixed order: two runs give the same bits.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_score.cuh"

namespace {

using namespace devc;

constexpr int TP = 2 * kScoreRows;  // output pixels a block: 64 a warpgroup
constexpr int TC = kScoreKeys;      // output channels a block (wgmma N)
constexpr int CK = kScoreAtom;      // input channels an atom
constexpr int THREADS = 2 * TP;     // two warpgroups
constexpr int STAGES = 4;           // the weights' ring
constexpr int AHEAD = STAGES - 1;   // atoms the weights' copies run ahead
constexpr int B_ATOM = TC * 128;    // bytes of a weight atom (hi or lo)
constexpr int STAGE = 2 * B_ATOM;   // w hi, w lo
constexpr int ALIGN = 1024;  // an atom's base alignment (the swizzle's repeat)
constexpr int PER_THREAD = 16;  // a thread's input values an atom: 2 pixels x 8

constexpr size_t smem_bytes() {  // the ring and a full and an empty barrier
  return (size_t)ALIGN + (size_t)STAGES * STAGE + 16 * STAGES;
}
static_assert(smem_bytes() <= 232448, "one block's shared memory");

struct Shape {
  int c, h, w, cout, oh, ow, k, stride, pad, dil, cout_tiles,
      atoms_per_split, splits;
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One block: TP output pixels x TC output channels of one sample, over
// the atoms of one split of the depth. With part == nullptr (one split)
// it writes out + bias; otherwise its partial to
// part[sample][split][cout][pixel].
__global__ void __launch_bounds__(THREADS, 1)
conv_split_kernel(const __grid_constant__ CUtensorMap w_map,
                  const float* __restrict__ x, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ part,
                  const Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t full = base + STAGES * STAGE;  // weights landed, a stage
  const uint32_t empty = full + 8 * STAGES;     // all 8 warps done with it

  const int n_pix = sh.oh * sh.ow;
  const int p0 = blockIdx.x * TP;
  const int split = blockIdx.y / sh.cout_tiles;
  const int co0 = (blockIdx.y % sh.cout_tiles) * TC;
  const size_t plane = (size_t)sh.h * sh.w;
  const float* const xs = x + (size_t)blockIdx.z * sh.c * plane;
  const int cpt = sh.c / CK;  // atoms a tap
  const int a_begin = split * sh.atoms_per_split;
  const int n = min(sh.k * sh.k * cpt - a_begin, sh.atoms_per_split);

  // wgmma's layouts: warp `warp` of warpgroup wg holds the tile's pixels
  // r = 64 wg + 16 warp + lane / 4 and r + 8. Of the input atom a thread
  // holds, in step k (channels 8 k ..), channels lane % 4 and lane % 4 + 4
  // of both pixels (register r of the step: pixel + 8 for r = 1, 3,
  // channel + 4 for r = 2, 3); of the output, s[4 j + 2 h + e] is pixel
  // r + 8 h and channel 8 j + 2 (lane % 4) + e.
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32 % 4;
  const int lane = tid % 32;
  const int row = 64 * wg + 16 * warp + lane / 4;
  const int ch = lane % 4;
  int oh[2], ow[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = p0 + row + 8 * h;
    in[h] = px < n_pix;
    oh[h] = in[h] ? px / sh.ow : 0;
    ow[h] = in[h] ? px % sh.ow : 0;
  }
  const bool producer = tid == 0;  // issues the weights' TMA copies

  // the split's atom i (tap g / cpt, channels (g % cpt) CK .., g = a_begin
  // + i) of this thread's two pixels, into v in the register order
  auto load = [&](int i, float (&v)[PER_THREAD]) {
    const int g = a_begin + i;
    const int tap = g / cpt;
    const float* const src = xs + (size_t)((g % cpt) * CK + ch) * plane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ih = oh[h] * sh.stride - sh.pad + (tap / sh.k) * sh.dil;
      const int iw = ow[h] * sh.stride - sh.pad + (tap % sh.k) * sh.dil;
      const bool ok = in[h] && ih >= 0 && ih < sh.h && iw >= 0 && iw < sh.w;
      const float* const at = src + (ok ? ih * sh.w + iw : 0);
#pragma unroll
      for (int k = 0; k < CK / 8; ++k) {
        v[4 * k + h] = ok ? __ldg(at + (8 * k) * plane) : 0.f;
        v[4 * k + h + 2] = ok ? __ldg(at + (8 * k + 4) * plane) : 0.f;
      }
    }
  };
  // the producer: atom i's weights, hi and lo, into its stage by TMA once
  // all warps are done with the stage's last atom, i - STAGES
  auto fill = [&](int i) {
    const int slot = i % STAGES;
    if (i >= STAGES) mbar_wait(empty + 8 * slot, (i / STAGES - 1) & 1);
    const uint32_t st = base + slot * STAGE;
    const uint32_t bar = full + 8 * slot;
    const int g = a_begin + i;
    const int tap = g / cpt;
    const int c0 = (g % cpt) * CK;
    mbar_arrive_expect_tx(bar, 2 * B_ATOM);
    tma_load(st, &w_map, bar, c0, co0, tap);
    tma_load(st + B_ATOM, &w_map, bar, sh.c + c0, co0, tap);
  };

  float s[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = p[i] = 0.f;

  // The warps run apart: a warpgroup's input is its own registers; the
  // weights' stages are shared (a full barrier a stage for the TMA, an
  // empty one, of the 8 warps' arrivals, before the producer refills it).
  // Atom i's input is loaded one atom ahead, into v[i % 2]; its weights
  // come AHEAD atoms ahead.
  float v0[PER_THREAD], v1[PER_THREAD];
  if (tid == 0) {
    mbar_init_all(full, STAGES);
    for (int i = 0; i < STAGES; ++i) mbar_init(empty + 8 * i, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer)
    for (int i = 0; i < AHEAD && i < n; ++i) fill(i);
  load(0, v0);

  auto step = [&](int i, const float (&cur)[PER_THREAD],
                  float (&next)[PER_THREAD]) {
    const int slot = i % STAGES;
    if (producer && i + AHEAD < n) fill(i + AHEAD);  // atom i - 1's stage
    if (i + 1 < n) load(i + 1, next);  // in flight during the product
    uint32_t hi[PER_THREAD], lo[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const float h = tf32_rna(cur[j]);
      hi[j] = __float_as_uint(h);
      lo[j] = __float_as_uint(tf32_rna(cur[j] - h));
    }
    mbar_wait(full + 8 * slot, (i / STAGES) & 1);  // atom i's weights
    __syncwarp();
    const uint32_t st = base + slot * STAGE;
    score_atom_ra(s, p, hi, lo, st, st + B_ATOM);
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  };
  for (int i = 0; i < n; i += 2) {
    step(i, v0, v1);
    if (i + 1 < n) step(i + 1, v1, v0);
  }

  float* const o =
      part == nullptr
          ? out + (size_t)blockIdx.z * sh.cout * n_pix
          : part + ((size_t)blockIdx.z * sh.splits + split) * sh.cout * n_pix;
  const bool add_bias = part == nullptr && bias != nullptr;
#pragma unroll
  for (int j = 0; j < TC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * ch + e;
      if (co >= sh.cout) continue;
      const float b = add_bias ? bias[co] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = p0 + row + 8 * h;
        if (px >= n_pix) continue;
        const float y = s[4 * j + 2 * h + e];
        o[(size_t)co * n_pix + px] = add_bias ? y + b : y;
      }
    }
  }
}

// out[z][co][px] = the splits' partials summed in split order, + bias
__global__ void __launch_bounds__(256)
conv_split_combine_kernel(const float* __restrict__ part,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int batch, int cout,
                          int n_pix, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)cout * n_pix;
  if (i >= (size_t)batch * per) return;
  const size_t z = i / per, r = i % per;
  const float* src = part + z * splits * per + r;
  float y = src[0];
  for (int j = 1; j < splits; ++j) y += src[j * per];
  out[i] = bias != nullptr ? y + bias[r / n_pix] : y;
}

}  // namespace

// out [n][cout][oh][ow] = conv2d(x [n][c][h][w], w) + bias (bias may be
// null), fp32, NCHW, on stream. w_split: the weight [cout][c][k][k] as
// [k * k][cout][2c], each row's TF32 hi in channels 0..c-1 and lo in
// c..2c-1 (ops/conv_split.py::weight_split). c % 32 == 0. The depth's
// k * k * c / 32 atoms go to `splits` blocks a tile (ops/conv_split.py::
// plan_splits), whose partials land in part (splits * n * cout * oh * ow
// floats; unused with one split) and are summed in split order by a
// second launch. No host sync, no allocation: capturable. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take
// or a tensor map it cannot build.
extern "C" int devc_conv_split(const void* x, const void* w_split,
                               const void* bias, void* out, void* part, int n,
                               int c, int h, int w, int cout, int oh, int ow,
                               int k, int stride, int pad, int dil, int splits,
                               void* stream) {
  if (c % CK != 0 || c <= 0 || n <= 0 || n > 65535 || cout <= 0 || oh <= 0 ||
      ow <= 0 || k <= 0 || stride <= 0 || dil <= 0 || pad < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap w_map;
  if (!make_map(&w_map, w_split, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * c,
                cout, k * k, CK, TC, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int atoms = k * k * (c / CK);
  const int per = (atoms + splits - 1) / splits;
  splits = (atoms + per - 1) / per;  // none empty
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  // the kernel's shared memory, set once a device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(conv_split_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes());
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cout_tiles = (cout + TC - 1) / TC;
  const Shape sh{c, h, w, cout, oh, ow, k, stride, pad, dil, cout_tiles, per,
                 splits};
  const int n_pix = oh * ow;
  const dim3 grid((n_pix + TP - 1) / TP, cout_tiles * splits, n);
  float* const part_f = splits > 1 ? static_cast<float*>(part) : nullptr;
  conv_split_kernel<<<grid, THREADS, smem_bytes(), st>>>(
      w_map, static_cast<const float*>(x), static_cast<const float*>(bias),
      static_cast<float*>(out), part_f, sh);
  if (splits > 1) {
    const size_t total = (size_t)n * cout * n_pix;
    conv_split_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                st>>>(part_f, static_cast<const float*>(bias),
                                      static_cast<float*>(out), n, cout, n_pix,
                                      splits);
  }
  return (int)cudaGetLastError();
}
