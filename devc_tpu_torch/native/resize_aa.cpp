// Anti-aliased image resize with the reference's exact host semantics.
//
// Native (C++) implementation of the resize inside the reference's
// CenterPad (utils/util_distortion.py:240,245,252 — skimage
// transform.resize with anti_aliasing=True, mode='reflect',
// preserve_range=True): a separable gaussian prefilter with
// sigma = (downscale_factor - 1) / 2 per axis, truncated at 4 sigma with
// 'mirror' boundaries (scipy.ndimage semantics), followed by separable
// half-pixel bilinear interpolation (src = (dst + 0.5) * in/out - 0.5).
// All arithmetic in double, bit-compatible with the float64 numpy plain
// version in devc_tpu_torch/data/transforms.py::resize_antialiased_plain.
//
// Exposed via ctypes (devc_tpu_torch/data/native.py). OpenMP-parallel over
// rows where available; on one core it is still ~5x the numpy path,
// because it fuses the blur and avoids the large float64 temporaries.

#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// mirror index (scipy 'mirror': reflect about the edge sample, no
// duplication): -1 -> 1, -2 -> 2, n -> n-2, n+1 -> n-3
inline int mirror(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = i % period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// gaussian kernel exactly as scipy.ndimage._gaussian_kernel1d (order 0):
// phi = exp(-0.5 x^2 / sigma^2) normalized; radius = int(4*sigma + 0.5)
std::vector<double> gauss_kernel(double sigma, int* radius_out) {
  int radius = (int)(4.0 * sigma + 0.5);
  *radius_out = radius;
  std::vector<double> k(2 * radius + 1);
  double s2 = sigma * sigma, sum = 0.0;
  for (int x = -radius; x <= radius; ++x) {
    double v = std::exp(-0.5 * (double)x * (double)x / s2);
    k[x + radius] = v;
    sum += v;
  }
  for (double& v : k) v /= sum;
  return k;
}

// correlate one axis with a symmetric kernel, mirror boundary.
// img: [h, w, c] doubles, axis 0 (rows) or 1 (cols).
// Row-contiguous formulations so the compiler vectorizes the inner loops.
void blur_axis(std::vector<double>& img, int h, int w, int c, double sigma,
               int axis) {
  if (sigma <= 0.0) return;
  int radius;
  std::vector<double> k = gauss_kernel(sigma, &radius);
  if (radius == 0) return;
  std::vector<double> out(img.size());
  const size_t row = (size_t)w * c;

  if (axis == 0) {
    // out_row[y] = sum_d k[d] * img_row[mirror(y+d)] — whole-row axpys
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < h; ++y) {
      double* o = &out[(size_t)y * row];
      {
        const double kv = k[0];
        const double* s = &img[(size_t)mirror(y - radius, h) * row];
        for (size_t i = 0; i < row; ++i) o[i] = kv * s[i];
      }
      for (int d = -radius + 1; d <= radius; ++d) {
        const double kv = k[d + radius];
        const double* s = &img[(size_t)mirror(y + d, h) * row];
        for (size_t i = 0; i < row; ++i) o[i] += kv * s[i];
      }
    }
  } else {
    // horizontal stencil: interior is shift-and-accumulate over the
    // contiguous row buffer; borders handled with mirror() separately
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < h; ++y) {
      const double* s = &img[(size_t)y * row];
      double* o = &out[(size_t)y * row];
      const int x_lo = radius, x_hi = w - radius;  // interior [x_lo, x_hi)
      if (x_hi > x_lo) {
        const size_t i0 = (size_t)x_lo * c, i1 = (size_t)x_hi * c;
        const double kv0 = k[0];
        for (size_t i = i0; i < i1; ++i) o[i] = kv0 * s[i - (size_t)radius * c];
        for (int d = -radius + 1; d <= radius; ++d) {
          const double kv = k[d + radius];
          const double* sh = s + (std::ptrdiff_t)d * (std::ptrdiff_t)c;
          for (size_t i = i0; i < i1; ++i) o[i] += kv * sh[i];
        }
      }
      for (int x = 0; x < w; ++x) {
        if (x >= x_lo && x < x_hi) continue;
        for (int ch = 0; ch < c; ++ch) {
          double acc = 0.0;
          for (int d = -radius; d <= radius; ++d)
            acc += k[d + radius] * s[(size_t)mirror(x + d, w) * c + ch];
          o[(size_t)x * c + ch] = acc;
        }
      }
    }
  }
  img.swap(out);
}

}  // namespace

extern "C" void resize_aa_u8(const uint8_t* src, int h, int w, int c,
                             double* dst, int oh, int ow) {
  const double fh = (double)h / oh, fw = (double)w / ow;
  const double sh = fh > 1.0 ? (fh - 1.0) / 2.0 : 0.0;
  const double sw = fw > 1.0 ? (fw - 1.0) / 2.0 : 0.0;

  std::vector<double> img((size_t)h * w * c);
  for (size_t i = 0; i < img.size(); ++i) img[i] = (double)src[i];
  if (fh > 1.0 || fw > 1.0) {
    blur_axis(img, h, w, c, sh, 0);
    blur_axis(img, h, w, c, sw, 1);
  }

  // axis-0 interpolation: [h, w, c] -> [oh, w, c]
  std::vector<double> rows((size_t)oh * w * c);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int y = 0; y < oh; ++y) {
    double sy = ((double)y + 0.5) * fh - 0.5;
    if (sy < 0.0) sy = 0.0;
    if (sy > h - 1.0) sy = h - 1.0;
    int lo = (int)std::floor(sy);
    int hi = lo + 1 < h ? lo + 1 : h - 1;
    double wt = sy - lo;
    const double* a = &img[(size_t)lo * w * c];
    const double* b = &img[(size_t)hi * w * c];
    double* o = &rows[(size_t)y * w * c];
    for (int i = 0; i < w * c; ++i) o[i] = a[i] * (1.0 - wt) + b[i] * wt;
  }

  // axis-1 interpolation: [oh, w, c] -> [oh, ow, c]
  std::vector<int> lox(ow), hix(ow);
  std::vector<double> wx(ow);
  for (int x = 0; x < ow; ++x) {
    double sx = ((double)x + 0.5) * fw - 0.5;
    if (sx < 0.0) sx = 0.0;
    if (sx > w - 1.0) sx = w - 1.0;
    lox[x] = (int)std::floor(sx);
    hix[x] = lox[x] + 1 < w ? lox[x] + 1 : w - 1;
    wx[x] = sx - lox[x];
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int y = 0; y < oh; ++y) {
    const double* row = &rows[(size_t)y * w * c];
    double* o = &dst[(size_t)y * ow * c];
    for (int x = 0; x < ow; ++x) {
      const double* a = &row[(size_t)lox[x] * c];
      const double* b = &row[(size_t)hix[x] * c];
      for (int ch = 0; ch < c; ++ch)
        o[(size_t)x * c + ch] = a[ch] * (1.0 - wx[x]) + b[ch] * wx[x];
    }
  }
}
