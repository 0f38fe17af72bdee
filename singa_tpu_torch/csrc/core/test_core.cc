/* test_core — native unit tests for the port's singa_core, built under
 * ASan+UBSan by singa_tpu_torch._build.build_asan (SURVEY.md §5
 * race-detection/sanitizer plan: the C++ core gets a sanitizer build
 * target exercised in CI; tests/test_torch_native.py runs this
 * binary).  No gtest dependency — a tiny CHECK macro keeps the image's
 * toolchain sufficient. */

#include "singa_core.h"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

static int g_failures = 0;

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,      \
                   #cond);                                              \
      ++g_failures;                                                     \
    }                                                                   \
  } while (0)

#define CHECK_NEAR(a, b, tol) CHECK(std::fabs((a) - (b)) <= (tol))

static void test_elementwise() {
  const int64_t n = 1027;  // odd size: exercises any tail handling
  std::vector<float> a(n), b(n), out(n);
  for (int64_t i = 0; i < n; ++i) {
    a[i] = 0.01f * static_cast<float>(i - 500);
    b[i] = 1.0f + 0.001f * static_cast<float>(i);
  }
  sg_add(a.data(), b.data(), out.data(), n);
  CHECK_NEAR(out[17], a[17] + b[17], 1e-6f);
  sg_mul(a.data(), b.data(), out.data(), n);
  CHECK_NEAR(out[999], a[999] * b[999], 1e-6f);
  sg_relu(a.data(), out.data(), n);
  CHECK(out[0] == 0.0f && out[n - 1] > 0.0f);
  sg_sigmoid(a.data(), out.data(), n);
  CHECK_NEAR(out[500], 0.5f, 1e-6f);  // a[500] == 0
  float s = 0;
  std::vector<float> acc(1, 0.0f);
  sg_sum(a.data(), acc.data(), n);
  for (int64_t i = 0; i < n; ++i) s += a[i];
  CHECK_NEAR(acc[0], s, 1e-2f);
}

static void test_gemm() {
  const int64_t m = 7, k = 5, n2 = 3;
  std::vector<float> a(m * k), b(k * n2), c(m * n2, 0.0f);
  for (size_t i = 0; i < a.size(); ++i) a[i] = 0.1f * static_cast<float>(i % 11);
  for (size_t i = 0; i < b.size(); ++i) b[i] = 0.2f * static_cast<float>(i % 7);
  sg_gemm(a.data(), b.data(), c.data(), m, k, n2, 0, 0, 1.0f, 0.0f);
  // reference element
  float ref = 0;
  for (int64_t kk = 0; kk < k; ++kk) ref += a[2 * k + kk] * b[kk * n2 + 1];
  CHECK_NEAR(c[2 * n2 + 1], ref, 1e-5f);
}

static void test_scheduler() {
  int64_t g = sg_graph_new();
  // diamond: 0 -> {1, 2} -> 3 over buffers 0..3
  int64_t b0 = 0, b1 = 1, b2 = 2, b3 = 3;
  int64_t sz[1] = {256};
  int64_t in0[1] = {b0};
  int64_t out1[1] = {b1};
  sg_graph_add_node(g, "a", in0, 1, out1, 1, sz, 10);
  int64_t out2[1] = {b2};
  sg_graph_add_node(g, "b", out1, 1, out2, 1, sz, 10);
  int64_t out3[1] = {b3};
  sg_graph_add_node(g, "c", out1, 1, out3, 1, sz, 10);
  int64_t in3[2] = {b2, b3};
  sg_graph_add_node(g, "d", in3, 2, out1 /*reuse b1 name ok*/, 0, sz, 10);
  int64_t order[8];
  int64_t nn = sg_graph_toposort(g, order, 8);
  CHECK(nn == 4);
  CHECK(order[0] == 0);       // deterministic Kahn order
  CHECK(sg_graph_total_flops(g) == 40);
  int64_t offs[8];
  int64_t arena = sg_graph_plan_memory(g, offs, 8);
  CHECK(arena > 0 && arena <= 4 * 256);
  sg_graph_free(g);
}

static void test_pool() {
  size_t before = sg_pool_bytes_in_use();
  void* p = sg_pool_alloc(1000);
  CHECK(p != nullptr);
  std::memset(p, 0xAB, 1000);  // ASan validates the bounds
  CHECK(sg_pool_bytes_in_use() > before);
  sg_pool_free(p);
  void* q = sg_pool_alloc(1000);  // same size bucket, reused
  CHECK(q == p);
  sg_pool_free(q);
  sg_pool_trim();
}

static void test_loader() {
  const int64_t n = 37, stride = 4, batch = 8;
  std::vector<float> x(n * stride);
  std::vector<int32_t> y(n);
  for (int64_t i = 0; i < n; ++i) {
    y[i] = static_cast<int32_t>(i);
    for (int64_t j = 0; j < stride; ++j)
      x[i * stride + j] = static_cast<float>(i) + 0.1f * static_cast<float>(j);
  }
  int64_t h = sg_loader_new(x.data(), y.data(), n, stride, batch,
                            /*shuffle=*/1, /*seed=*/7, /*drop_last=*/0,
                            /*workers=*/2, /*prefetch=*/3);
  CHECK(h >= 0);
  CHECK(sg_loader_batches_per_epoch(h) == (n + batch - 1) / batch);
  std::vector<float> xb(batch * stride);
  std::vector<int32_t> yb(batch);
  // the loader rewinds+reshuffles at epoch end and never blocks the
  // consumer: read exactly two epochs' worth of batches
  const int64_t bpe = sg_loader_batches_per_epoch(h);
  for (int epoch = 0; epoch < 2; ++epoch) {
    int64_t seen = 0;
    std::vector<int> hit(n, 0);
    for (int64_t bi = 0; bi < bpe; ++bi) {
      int64_t got = sg_loader_next(h, xb.data(), yb.data());
      CHECK(got > 0);
      for (int64_t i = 0; i < got; ++i) {
        CHECK(yb[i] >= 0 && yb[i] < n);
        ++hit[yb[i]];
        CHECK_NEAR(xb[i * stride], static_cast<float>(yb[i]), 1e-6f);
      }
      seen += got;
    }
    CHECK(seen == n);
    for (int64_t i = 0; i < n; ++i) CHECK(hit[i] == 1);
  }
  sg_loader_free(h);
}

int main() {
  std::printf("singa_core native tests (%s)\n", sg_version());
  test_elementwise();
  test_gemm();
  test_scheduler();
  test_pool();
  test_loader();
  if (g_failures) {
    std::fprintf(stderr, "%d failure(s)\n", g_failures);
    return 1;
  }
  std::printf("ALL NATIVE TESTS PASSED\n");
  return 0;
}
