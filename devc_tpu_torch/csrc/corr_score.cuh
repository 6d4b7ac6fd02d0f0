// The fp32 score rule: how every fp32 correspondence score s = theta_q .
// phi_k is formed on the card, shared by K1 (corr_fwd.cu, replaces
// devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel) and K3's score pass
// (corr_bwd.cu::corr_dkv_scores_kernel, replaces ::_corr_dkv_kernel).
//
// Why one rule: the backward routes the sim gradient to the keys whose
// recomputed score equals K1's saved row max (s == m, as
// pallas_corr.py::_grad_tile does; every exact tie included). That test
// finds the max only if K3 forms each score bit for bit as K1 did.
// devc_tpu gets this by forming both kernels' scores with one MXU
// dot_general (pallas_corr.py::_scores); here both kernels form them on
// Hopper's tensor cores with this header's routines, in the same order.
//
// The rule, fp32-accurate on the TF32 tensor cores ("3xTF32"):
//   * every fp32 operand x is split into hi = cvt.rna.tf32(x) and lo =
//     cvt.rna.tf32(x - hi) (x - hi is exact in fp32; hi + lo keeps ~22
//     bits of x) by split_tf32_kernel, a pre-pass over theta and phi that
//     writes [rows][2C] arrays, hi in channels 0..C-1 and lo in C..2C-1;
//     the kernels' TMA copies then bring both halves as they are (one
//     read of x and two writes per element: at B = 16, N = 5184, C = 256
//     about 0.5 GB, ~0.15 ms of HBM time, against the kernels' ms);
//   * theta's rows are wgmma's M side (A: 64 rows of a warpgroup), phi's
//     rows its N side (B: a tile of 128 keys), both K-major from shared
//     memory in the 128-byte swizzle: wgmma.m64n128k8.f32.tf32.tf32. A
//     key tile is 128-aligned and a warpgroup's 64 rows 64-aligned in both
//     kernels, so a score sits at the same place of the same instruction;
//   * the channels go in ascending atoms of 32 (one 128-byte row of
//     fp32). An atom's partial starts from zero in a fresh accumulator p:
//     first lo.hi and hi.lo of its four 8-channel steps (the small terms,
//     while p is small), then the four hi.hi; lo.lo is dropped. Then
//     s += p, an ordinary fp32 add. The tensor cores add each step into
//     their accumulator with truncation, an error relative to the
//     accumulator: one accumulator over all of C = 256 (96 steps) would
//     carry that error 96 times at |s| (the backward's products, with
//     one accumulator over 5184, gave 10x cuBLAS's fp32 error); a fresh p
//     per atom bounds it by 12 steps at |p| plus C / 32 rounded adds at
//     |s|;
//   * s starts at 0.f, so the first atom's sum is p itself.
// The fp32-accurate convolution (conv_split.cu) forms its products by the
// same rule, with the input's atom in registers (score_atom_ra).
// Nothing else forms an fp32 score: K1's bf16 kernel (corr_fwd_bf16.cu)
// has its own bf16 products (nothing reads its m), and the products
// dtheta and dphi (corr_bwd.cu) need no fixed order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace devc {

constexpr int kScoreRows = 64;   // theta rows a warpgroup scores (wgmma M)
constexpr int kScoreKeys = 128;  // phi rows of a key tile (wgmma N)
constexpr int kScoreAtom = 32;   // channels of an atom: a 128-byte fp32 row

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// dst [rows][2c] = (hi | lo) of src [rows][c], c % 4 == 0, both 16-byte
// aligned: one thread per 4 channels. (static: each file that launches it
// has its own copy.)
static __global__ void __launch_bounds__(256)
split_tf32_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  size_t quads, int c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const int c4 = c / 4;
  const size_t row = i / c4;
  const int j = (int)(i % c4) * 4;
  const float4 x = reinterpret_cast<const float4*>(src)[i];
  const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y),
                                tf32_rna(x.z), tf32_rna(x.w));
  const float4 lo =
      make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                  tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
  float* d = dst + row * 2 * c + j;
  *reinterpret_cast<float4*>(d) = hi;
  *reinterpret_cast<float4*>(d + c) = lo;
}

// The split of rows x c floats at src into dst (rows x 2c) on stream st.
static inline cudaError_t split_tf32(const float* src, float* dst,
                                     size_t rows, int c, cudaStream_t st) {
  const size_t quads = rows * (size_t)(c / 4);
  split_tf32_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      src, dst, quads, c);
  return cudaGetLastError();
}

// d (+)= A B for 64 rows of A and 128 of B over 8 fp32 channels, both
// K-major tf32 in shared memory (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
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

// d (+)= A B as wgmma_tf32_m64n128k8, with A (64 rows x 8 channels, tf32)
// from registers: a[r] of each warp's 16 rows in the m16n8k8 layout, row
// lane / 4 (+ 8 for r = 1, 3), channel lane % 4 (+ 4 for r = 2, 3).
__device__ __forceinline__ void wgmma_tf32_m64n128k8_ra(float (&d)[64],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// One atom of the rule for a warpgroup: s += the partial over 32 channels
// of its 64 theta rows (hi and lo atoms at a_hi, a_lo: [64][32] fp32,
// swizzled) and a tile's 128 phi rows (b_hi, b_lo: [128][32]). p is the
// fresh accumulator (its contents on entry are overwritten). Waits for the
// tensor cores before it returns.
__device__ __forceinline__ void score_atom(float (&s)[64], float (&p)[64],
                                           uint32_t a_hi, uint32_t a_lo,
                                           uint32_t b_hi, uint32_t b_lo) {
  fence_acc(p);
  wgmma_fence();
  // the small terms first, 8 channels (32 bytes of the rows) a step
#pragma unroll
  for (int k = 0; k < kScoreAtom / 8; ++k) {
    wgmma_tf32_m64n128k8(p, desc_sw128(a_lo + 32 * k),
                         desc_sw128(b_hi + 32 * k), k > 0);
    wgmma_tf32_m64n128k8(p, desc_sw128(a_hi + 32 * k),
                         desc_sw128(b_lo + 32 * k), 1);
  }
#pragma unroll
  for (int k = 0; k < kScoreAtom / 8; ++k)
    wgmma_tf32_m64n128k8(p, desc_sw128(a_hi + 32 * k),
                         desc_sw128(b_hi + 32 * k), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(p);
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] += p[i];
}

// score_atom with the 64 rows' atom from registers: a_hi[4 k + r] and
// a_lo[4 k + r] are register r of step k (channels 8 k ..) of each warp's
// rows in wgmma_tf32_m64n128k8_ra's layout; the same products in the same
// order, so the same bits as score_atom on the same values.
__device__ __forceinline__ void score_atom_ra(float (&s)[64], float (&p)[64],
                                              const uint32_t (&a_hi)[16],
                                              const uint32_t (&a_lo)[16],
                                              uint32_t b_hi, uint32_t b_lo) {
  fence_acc(p);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kScoreAtom / 8; ++k) {
    const uint32_t lo[4] = {a_lo[4 * k], a_lo[4 * k + 1], a_lo[4 * k + 2],
                            a_lo[4 * k + 3]};
    const uint32_t hi[4] = {a_hi[4 * k], a_hi[4 * k + 1], a_hi[4 * k + 2],
                            a_hi[4 * k + 3]};
    wgmma_tf32_m64n128k8_ra(p, lo, desc_sw128(b_hi + 32 * k), k > 0);
    wgmma_tf32_m64n128k8_ra(p, hi, desc_sw128(b_lo + 32 * k), 1);
  }
#pragma unroll
  for (int k = 0; k < kScoreAtom / 8; ++k) {
    const uint32_t hi[4] = {a_hi[4 * k], a_hi[4 * k + 1], a_hi[4 * k + 2],
                            a_hi[4 * k + 3]};
    wgmma_tf32_m64n128k8_ra(p, hi, desc_sw128(b_hi + 32 * k), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(p);
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] += p[i];
}

}  // namespace devc
