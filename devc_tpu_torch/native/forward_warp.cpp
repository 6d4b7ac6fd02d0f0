// Forward-flow image warp via per-pixel fixed-point search.
//
// Native (C++) implementation of the data-augmentation kernel the reference
// JIT-compiles with numba (utils/util_distortion.py:402-552): given a
// forward flow (u horizontal, v vertical) defined on the SOURCE grid, find
// for every target pixel (xr, yr) the source location (i, j) satisfying
//   i + u(i, j) = xr,   j + v(i, j) = yr
// by fixed-point iteration with bilinear flow lookups, then bilinearly
// sample the source image there (border-reflected).
//
// Exposed via ctypes (devc_tpu_torch/data/native.py). OpenMP-parallel over rows.
//
// Note: the reference's numba biInterpolation truncates its weights to
// integers (u2(i) casts), degrading to nearest-neighbor sampling of the
// top-left corner; we implement true bilinear sampling.

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float sample_bilinear(const float* f, int H, int W, float x, float y) {
  // clamp-to-edge bilinear lookup on a single-channel float image
  if (x < 0.f) x = 0.f;
  if (y < 0.f) y = 0.f;
  if (x > W - 1.f) x = W - 1.f;
  if (y > H - 1.f) y = H - 1.f;
  int x0 = (int)x, y0 = (int)y;
  int x1 = x0 + 1 < W ? x0 + 1 : x0;
  int y1 = y0 + 1 < H ? y0 + 1 : y0;
  float wx = x - x0, wy = y - y0;
  float v00 = f[y0 * W + x0], v01 = f[y0 * W + x1];
  float v10 = f[y1 * W + x0], v11 = f[y1 * W + x1];
  return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
         v10 * (1 - wx) * wy + v11 * wx * wy;
}

inline float reflect(float p, float n) {
  // reflect out-of-range coordinate into [0, n-1]
  if (p < 0.f) p = -p;
  if (p > n - 1.f) p = 2.f * (n - 1.f) - p;
  if (p < 0.f) p = 0.f;  // extremely large flows
  if (p > n - 1.f) p = n - 1.f;
  return p;
}

}  // namespace

extern "C" {

// src: [H, W, C] uint8; u, v: [H, W] float32 (horizontal, vertical flow on
// the source grid); dst: [H, W, C] uint8 output.
void forward_warp_u8(const uint8_t* src, const float* u, const float* v,
                     uint8_t* dst, int H, int W, int C, int max_iter,
                     float precision) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int yr = 0; yr < H; ++yr) {
    for (int xr = 0; xr < W; ++xr) {
      float u0 = u[yr * W + xr];
      float v0 = v[yr * W + xr];
      float i, j;
      if (std::fabs(u0) < precision && std::fabs(v0) < precision) {
        i = (float)xr;
        j = (float)yr;
      } else {
        // slope-corrected initialization, then fixed-point iterations
        float du = (xr + 1 <= W - 1) ? u[yr * W + xr + 1] - u0
                                     : u0 - u[yr * W + xr - 1];
        float dv = (yr + 1 <= H - 1) ? v[(yr + 1) * W + xr] - v0
                                     : v0 - v[(yr - 1) * W + xr];
        float un = u0 / (1.f + du);
        float vn = v0 / (1.f + dv);
        i = xr - un;
        j = yr - vn;
        for (int it = 0; it < max_iter; ++it) {
          if (i < 0.f || i > W - 1.f || j < 0.f || j > H - 1.f) break;
          float ui = sample_bilinear(u, H, W, i, j);
          float vi = sample_bilinear(v, H, W, i, j);
          float i_next = xr - ui;
          float j_next = yr - vi;
          if (std::fabs(i - i_next) < precision &&
              std::fabs(j - j_next) < precision) {
            i = i_next;
            j = j_next;
            break;
          }
          i = i_next;
          j = j_next;
        }
      }
      i = reflect(i, (float)W);
      j = reflect(j, (float)H);

      // bilinear sample of src at (i, j)
      int x0 = (int)i, y0 = (int)j;
      int x1 = x0 + 1 < W ? x0 + 1 : x0;
      int y1 = y0 + 1 < H ? y0 + 1 : y0;
      float wx = i - x0, wy = j - y0;
      for (int c = 0; c < C; ++c) {
        float v00 = src[(y0 * W + x0) * C + c];
        float v01 = src[(y0 * W + x1) * C + c];
        float v10 = src[(y1 * W + x0) * C + c];
        float v11 = src[(y1 * W + x1) * C + c];
        float val = v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
                    v10 * (1 - wx) * wy + v11 * wx * wy;
        if (val < 0.f) val = 0.f;
        if (val > 255.f) val = 255.f;
        dst[(yr * W + xr) * C + c] = (uint8_t)(val + 0.5f);
      }
    }
  }
}

}  // extern "C"
