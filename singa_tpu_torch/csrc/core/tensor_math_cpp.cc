/* tensor_math_cpp — eager CPU kernels for the CppCPU debug device.
 * Parity target: the reference's per-device math dispatch table
 * (BASELINE.json:5 "tensor_math_cuda" analogue for host).  Blocked GEMM
 * with OpenMP; everything float32 row-major contiguous. */

#include "singa_core.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr int64_t kBlockM = 64;
constexpr int64_t kBlockN = 64;
constexpr int64_t kBlockK = 64;

inline const float* row(const float* p, int64_t i, int64_t stride) {
  return p + i * stride;
}
}  // namespace

extern "C" {

void sg_gemm(const float* a, const float* b, float* c,
             int64_t m, int64_t k, int64_t n,
             int transa, int transb, float alpha, float beta) {
  // C[m,n] = alpha * op(A)[m,k] @ op(B)[k,n] + beta * C
  // Blocked ikj loop; packs nothing (fine for a debug device).
#pragma omp parallel for schedule(static)
  for (int64_t i0 = 0; i0 < m; i0 += kBlockM) {
    int64_t i1 = std::min(i0 + kBlockM, m);
    std::vector<float> acc(kBlockM * n);
    std::fill(acc.begin(), acc.end(), 0.f);
    for (int64_t k0 = 0; k0 < k; k0 += kBlockK) {
      int64_t k1 = std::min(k0 + kBlockK, k);
      for (int64_t i = i0; i < i1; ++i) {
        float* acc_i = acc.data() + (i - i0) * n;
        for (int64_t kk = k0; kk < k1; ++kk) {
          float av = transa ? a[kk * m + i] : a[i * k + kk];
          if (av == 0.f) continue;
          const float* brow = transb ? nullptr : b + kk * n;
          if (!transb) {
            for (int64_t j = 0; j < n; ++j) acc_i[j] += av * brow[j];
          } else {
            for (int64_t j = 0; j < n; ++j) acc_i[j] += av * b[j * k + kk];
          }
        }
      }
    }
    for (int64_t i = i0; i < i1; ++i) {
      float* ci = c + i * n;
      const float* acc_i = acc.data() + (i - i0) * n;
      if (beta == 0.f) {
        for (int64_t j = 0; j < n; ++j) ci[j] = alpha * acc_i[j];
      } else {
        for (int64_t j = 0; j < n; ++j) ci[j] = alpha * acc_i[j] + beta * ci[j];
      }
    }
  }
}

#define SG_EW(name, expr)                                          \
  void name(const float* a, const float* b, float* out, int64_t n) { \
    _Pragma("omp parallel for schedule(static)")                   \
    for (int64_t i = 0; i < n; ++i) out[i] = (expr);               \
  }

SG_EW(sg_add, a[i] + b[i])
SG_EW(sg_sub, a[i] - b[i])
SG_EW(sg_mul, a[i] * b[i])
SG_EW(sg_div, a[i] / b[i])
#undef SG_EW

void sg_axpy(float alpha, const float* x, float* y, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) y[i] += alpha * x[i];
}

void sg_scale(float alpha, float* x, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) x[i] *= alpha;
}

void sg_relu(const float* a, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = a[i] > 0.f ? a[i] : 0.f;
}

void sg_relu_grad(const float* a, const float* dy, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = a[i] > 0.f ? dy[i] : 0.f;
}

void sg_sigmoid(const float* a, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = 1.f / (1.f + std::exp(-a[i]));
}

void sg_tanh(const float* a, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = std::tanh(a[i]);
}

void sg_exp(const float* a, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = std::exp(a[i]);
}

void sg_softmax(const float* a, float* out, int64_t rows, int64_t cols) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    const float* ar = row(a, r, cols);
    float* orow = out + r * cols;
    float mx = ar[0];
    for (int64_t j = 1; j < cols; ++j) mx = std::max(mx, ar[j]);
    float s = 0.f;
    for (int64_t j = 0; j < cols; ++j) {
      orow[j] = std::exp(ar[j] - mx);
      s += orow[j];
    }
    float inv = 1.f / s;
    for (int64_t j = 0; j < cols; ++j) orow[j] *= inv;
  }
}

void sg_sum(const float* a, float* out, int64_t n) {
  double s = 0.0;
#pragma omp parallel for reduction(+ : s) schedule(static)
  for (int64_t i = 0; i < n; ++i) s += a[i];
  out[0] = static_cast<float>(s);
}

void sg_conv2d_nhwc(const float* x, const float* w, float* y,
                    int64_t N, int64_t H, int64_t W, int64_t C,
                    int64_t KH, int64_t KW, int64_t OC,
                    int64_t sh, int64_t sw, int64_t ph, int64_t pw) {
  // im2col-free direct conv: adequate for the debug device's smoke runs.
  int64_t OH = (H + 2 * ph - KH) / sh + 1;
  int64_t OW = (W + 2 * pw - KW) / sw + 1;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t oh = 0; oh < OH; ++oh) {
      for (int64_t ow = 0; ow < OW; ++ow) {
        float* yp = y + ((n * OH + oh) * OW + ow) * OC;
        for (int64_t oc = 0; oc < OC; ++oc) yp[oc] = 0.f;
        for (int64_t kh = 0; kh < KH; ++kh) {
          int64_t ih = oh * sh - ph + kh;
          if (ih < 0 || ih >= H) continue;
          for (int64_t kw = 0; kw < KW; ++kw) {
            int64_t iw = ow * sw - pw + kw;
            if (iw < 0 || iw >= W) continue;
            const float* xp = x + ((n * H + ih) * W + iw) * C;
            const float* wp = w + (kh * KW + kw) * C * OC;
            for (int64_t c = 0; c < C; ++c) {
              float xv = xp[c];
              const float* wrow = wp + c * OC;
              for (int64_t oc = 0; oc < OC; ++oc) yp[oc] += xv * wrow[oc];
            }
          }
        }
      }
    }
  }
}

void sg_sgd_update(float* param, const float* grad, float* mom,
                   float lr, float momentum, float weight_decay, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grad[i] + weight_decay * param[i];
    if (mom != nullptr) {
      mom[i] = momentum * mom[i] + g;
      g = mom[i];
    }
    param[i] -= lr * g;
  }
}

const char* sg_version(void) { return "singa_core 0.1.0"; }

}  // extern "C"
