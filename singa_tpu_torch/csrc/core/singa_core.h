/* singa_core — the host runtime of singa_tpu_torch, a copy of the JAX
 * package's csrc/ (its header without the PJRT block: the PJRT plugin
 * probe is TPU-only).  The code is the reference's, so the two libraries
 * compute the same bits under the same compiler flags.
 *   - tensor_math_cpp : eager f32 CPU kernels for the CppCPU device
 *   - scheduler       : graph topo-sort + liveness memory planning
 *   - dataloader      : threaded shuffle/batch/prefetch pipeline
 *   - allocator       : size-bucketed host staging pool
 *
 * The card's compute path is PyTorch and the hand-written Hopper kernels
 * beside this directory; this library is the host-side runtime around
 * it.  Exposed as a plain C API consumed via ctypes
 * (singa_tpu_torch/_core), built by singa_tpu_torch/_build.py.
 */
#ifndef SINGA_CORE_H_
#define SINGA_CORE_H_

#include <cstdint>
#include <cstddef>

extern "C" {

/* ---------------- tensor_math_cpp ---------------- */
/* All kernels: float32, contiguous row-major. */
void sg_gemm(const float* a, const float* b, float* c,
             int64_t m, int64_t k, int64_t n,
             int transa, int transb, float alpha, float beta);
void sg_add(const float* a, const float* b, float* out, int64_t n);
void sg_sub(const float* a, const float* b, float* out, int64_t n);
void sg_mul(const float* a, const float* b, float* out, int64_t n);
void sg_div(const float* a, const float* b, float* out, int64_t n);
void sg_axpy(float alpha, const float* x, float* y, int64_t n); /* y += a*x */
void sg_scale(float alpha, float* x, int64_t n);
void sg_relu(const float* a, float* out, int64_t n);
void sg_relu_grad(const float* a, const float* dy, float* out, int64_t n);
void sg_sigmoid(const float* a, float* out, int64_t n);
void sg_tanh(const float* a, float* out, int64_t n);
void sg_exp(const float* a, float* out, int64_t n);
void sg_softmax(const float* a, float* out, int64_t rows, int64_t cols);
void sg_sum(const float* a, float* out, int64_t n); /* out[0] = sum */
void sg_conv2d_nhwc(const float* x, const float* w, float* y,
                    int64_t N, int64_t H, int64_t W, int64_t C,
                    int64_t KH, int64_t KW, int64_t OC,
                    int64_t sh, int64_t sw, int64_t ph, int64_t pw);
void sg_sgd_update(float* param, const float* grad, float* mom,
                   float lr, float momentum, float weight_decay, int64_t n);

/* ---------------- scheduler ---------------- */
/* Build a graph of ops; topo-sort; plan buffer reuse by liveness.
 * Handles are opaque int64 ids. */
int64_t sg_graph_new(void);
void    sg_graph_free(int64_t g);
/* add node: nin input buffer-ids, nout output buffer-ids (caller-chosen
 * dense ints), returns node id or -1 */
int64_t sg_graph_add_node(int64_t g, const char* name,
                          const int64_t* in_bufs, int64_t nin,
                          const int64_t* out_bufs, int64_t nout,
                          const int64_t* buf_sizes_out, int64_t flops);
/* topo order of node ids into out[n]; returns n or -1 on cycle */
int64_t sg_graph_toposort(int64_t g, int64_t* out, int64_t cap);
/* liveness-based memory plan: assigns each buffer an offset in a shared
 * arena (first-fit over free intervals). Returns arena bytes needed.
 * offsets[i] receives the offset of buffer id i (cap entries). */
int64_t sg_graph_plan_memory(int64_t g, int64_t* offsets, int64_t cap);
int64_t sg_graph_num_nodes(int64_t g);
int64_t sg_graph_total_flops(int64_t g);

/* ---------------- dataloader ---------------- */
/* In-memory dataset of (x, y) float32/int32 arrays; background threads
 * produce shuffled batches into a bounded ring buffer. */
int64_t sg_loader_new(const float* x, const int32_t* y,
                      int64_t n, int64_t x_stride /* floats per sample */,
                      int64_t batch, int shuffle, uint64_t seed,
                      int drop_last, int workers, int prefetch);
/* blocks until a batch is ready; writes batch data and returns the
 * actual batch size, 0 at epoch end (loader rewinds + reshuffles), or
 * -1 on error */
int64_t sg_loader_next(int64_t h, float* x_out, int32_t* y_out);
void    sg_loader_free(int64_t h);
int64_t sg_loader_batches_per_epoch(int64_t h);

/* ---------------- allocator (host staging pool) ---------------- */
void*  sg_pool_alloc(size_t bytes);
void   sg_pool_free(void* p);
size_t sg_pool_bytes_in_use(void);
size_t sg_pool_bytes_reserved(void);
void   sg_pool_trim(void);

const char* sg_version(void);

} /* extern "C" */

#endif /* SINGA_CORE_H_ */
