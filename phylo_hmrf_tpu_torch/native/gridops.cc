// Data-loader kernels: sequential median hole-fill.
//
// The reference fills missing Hi-C pixels with the median of their 3x3
// neighborhood *in place, scanning sequentially*, so earlier fills feed later
// ones (reference utility.py:603-660). That sequential dependence cannot be
// vectorized without changing results, so the faithful implementation lives
// here in C++ (with a slow numpy fallback in data/filters.py).

#include <algorithm>
#include <cstdint>

namespace {

// median of up to 8 values
double median8(double* v, int n) {
  std::sort(v, v + n);
  if (n % 2 == 1) return v[n / 2];
  return 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

}  // namespace

extern "C" {

// Symmetric variant (reference near_interpolation1): scans the upper
// triangle i in [2, n1-1), j in [i, n2-1); fills mtx[i,j] and mtx[j,i].
// mtx is (n1, n2) row-major, modified in place.
void phmrf_hole_fill_sym(double* mtx, int64_t n1, int64_t n2,
                         double threshold, int32_t /*window*/) {
  for (int64_t i = 2; i < n1 - 1; ++i) {
    for (int64_t j = i; j < n2 - 1; ++j) {
      if (mtx[i * n2 + j] < threshold) {
        double nb[8];
        int n = 0;
        for (int64_t di = -1; di <= 1; ++di) {
          for (int64_t dj = -1; dj <= 1; ++dj) {
            if (di == 0 && dj == 0) continue;
            nb[n++] = mtx[(i + di) * n2 + (j + dj)];
          }
        }
        double m = median8(nb, n);
        if (m > threshold) {
          mtx[i * n2 + j] = m;
          mtx[j * n2 + i] = m;
        }
      }
    }
  }
}

// Rectangular variant (reference near_interpolation1a): scans i in [2, n1-1),
// j in [2, n2-1); fills mtx[i,j] only.
void phmrf_hole_fill_rect(double* mtx, int64_t n1, int64_t n2,
                          double threshold, int32_t /*window*/) {
  for (int64_t i = 2; i < n1 - 1; ++i) {
    for (int64_t j = 2; j < n2 - 1; ++j) {
      if (mtx[i * n2 + j] < threshold) {
        double nb[8];
        int n = 0;
        for (int64_t di = -1; di <= 1; ++di) {
          for (int64_t dj = -1; dj <= 1; ++dj) {
            if (di == 0 && dj == 0) continue;
            nb[n++] = mtx[(i + di) * n2 + (j + dj)];
          }
        }
        double m = median8(nb, n);
        if (m > threshold) {
          mtx[i * n2 + j] = m;
        }
      }
    }
  }
}

// Center-including symmetric variant (reference near_interpolation2,
// utility.py:663-685): the median is taken over the FULL 3x3 window
// including the (below-threshold) center value.
void phmrf_hole_fill_sym2(double* mtx, int64_t n1, int64_t n2,
                          double threshold, int32_t /*window*/) {
  for (int64_t i = 2; i < n1 - 1; ++i) {
    for (int64_t j = i; j < n2 - 1; ++j) {
      if (mtx[i * n2 + j] < threshold) {
        double nb[9];
        int n = 0;
        for (int64_t di = -1; di <= 1; ++di) {
          for (int64_t dj = -1; dj <= 1; ++dj) {
            nb[n++] = mtx[(i + di) * n2 + (j + dj)];
          }
        }
        double m = median8(nb, n);
        if (m > threshold) {
          mtx[i * n2 + j] = m;
          mtx[j * n2 + i] = m;
        }
      }
    }
  }
}

}  // extern "C"
