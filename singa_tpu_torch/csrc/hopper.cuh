// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tensor
// maps and loads, mbarriers, wgmma descriptors and instructions, and
// register reallocation between warpgroups.
//
// Shared-memory layout that ties them together: an operand tile of R rows
// by W bf16 columns is stored as W / 64 slabs of R rows x 128 bytes, each
// slab 1024-byte aligned and written by one TMA load through a tensor map
// with CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8)).  A wgmma descriptor with the 128-byte swizzle layout
// reads the same pattern back:
//   * K-major operand (rows = M or N, the contraction runs along a row):
//     8-row groups 1024 bytes apart (SBO); a 16-deep k step is +32 bytes
//     within a slab, the next slab is the next 64 of k;
//   * MN-major operand (rows = k, the M or N index runs along a row):
//     8-row groups of k 1024 bytes apart (SBO), 64-wide slabs of M or N
//     one slab apart (LBO); a 16-deep k step is +16 rows = +2048 bytes.
//
// Host side: `tensor_map_4d` encodes a map over a (B, T, heads, D) bf16
// tensor through its strides.  cuTensorMapEncodeTiled is a driver-API
// function; it is fetched through the runtime (cudaGetDriverEntryPoint),
// so a library built with nvcc needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HK_DEV __device__ __forceinline__

namespace hopper {

// One count for each launch that runs, eager or replayed from a CUDA
// graph: the first thread of the first block adds one to `count` (a
// device counter of the caller's; null: not counted).
HK_DEV void count_launch(unsigned long long* count) {
  if (count != nullptr && threadIdx.x == 0 && blockIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(count, 1ull);
}

// ---------------------------------------------------------------------------
// shared-memory addresses, mbarriers
// ---------------------------------------------------------------------------

HK_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

HK_DEV void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to TMA
HK_DEV void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

HK_DEV void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// `count` arrivals at once
HK_DEV void mbar_arrive_cnt(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
HK_DEV void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (the loop is
// inside the asm, so the compiler sees no divergent branch here)
HK_DEV void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

HK_DEV void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// one box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at `dst`; completion is reported to `bar` in bytes
HK_DEV void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                        int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one box of `map` at coordinates (c0, c1, c2, c3) from shared memory at
// `src`; the boxes' columns past the tensor's last one are not written
HK_DEV void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global memory at `src` into shared memory at `dst`; completion is
// reported to `bar` in bytes, as for a tensor load
HK_DEV void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                      uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// commit this thread's TMA stores and wait until their shared memory has
// been read
HK_DEV void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's shared-memory writes before later TMA reads of them
HK_DEV void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

HK_DEV void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// two f32 at `addr` (8-byte aligned); volatile, so it stays after the
// mbarrier wait that made them visible
HK_DEV float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// ---------------------------------------------------------------------------
// warpgroups: register reallocation, wgmma
// ---------------------------------------------------------------------------

// named barriers 1..15 (0 is __syncthreads): `count` threads in all, some
// waiting (sync), some only signalling (arrive)
HK_DEV void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

HK_DEV void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
HK_DEV void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
HK_DEV void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

HK_DEV void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

HK_DEV void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
HK_DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator (or A
// operand) registers across the asynchronous wgmma that owns them
template <int N>
HK_DEV void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
HK_DEV void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// descriptor of a shared-memory operand in the 128-byte swizzle layout
// (see the top of the file); offsets in bytes
HK_DEV uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major tile: the k step's start address; LBO is not used by this layout
HK_DEV uint64_t desc_k_major(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major tile: the k step's start address and the stride between
// 64-wide slabs of M or N
HK_DEV uint64_t desc_mn_major(uint32_t addr, uint32_t slab_bytes) {
  return desc_sw128(addr, slab_bytes, 1024);
}

// 2^x on the special-function unit, denormal results flushed to zero
HK_DEV float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

HK_DEV uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments of wgmma m64nNk16 with f32 D: thread t of the
// warpgroup holds d[4 j + e] = D(16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
// 8 j + 2 (t % 4) + e % 2).  An A operand in registers takes the same
// layout, two 8-column blocks per 16-deep k step, rounded to bf16 pairs.
#define HK_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HK_ACC16(d, i) \
  HK_ACC4(d, i), HK_ACC4(d, i + 4), HK_ACC4(d, i + 8), HK_ACC4(d, i + 12)
#define HK_ACC32(d) HK_ACC16(d, 0), HK_ACC16(d, 16)
#define HK_ACC64(d) HK_ACC32(d), HK_ACC16(d, 32), HK_ACC16(d, 48)
#define HK_ACC128(d)                                                   \
  HK_ACC64(d), HK_ACC16(d, 64), HK_ACC16(d, 80), HK_ACC16(d, 96), \
      HK_ACC16(d, 112)

// wgmma with both operands in shared memory (scale_d = 0 overwrites D),
// and with A in registers and B MN-major in shared memory (the transpose
// bit), overloaded on the accumulator's size N / 2.

// D(64x64, f32) (+)= A(64x16, smem, K-major) * B(64x16, smem, K-major)
HK_DEV void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HK_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64x128, f32) (+)= A(64x16, smem, K-major) * B(128x16, smem, K-major)
HK_DEV void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HK_ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64x64, f32) += A(64x16, bf16 registers) * B(16x64, smem, MN-major)
HK_DEV void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HK_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D(64x128, f32) += A(64x16, bf16 registers) * B(16x128, smem, MN-major)
HK_DEV void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HK_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D(64x256, f32) += A(64x16, bf16 registers) * B(16x256, smem, MN-major)
HK_DEV void wgmma_rs_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HK_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A tensor map over a bf16 tensor of shape (B, T, heads, D) with element
// strides (sb, st, sh, 1), moved in boxes of `rows` positions by 64
// columns with the 128-byte swizzle.  Columns D..63 of a box past the
// last one read as zeros (TMA's out-of-bounds fill) and are not stored.
// The strides of extent-1 dims are never used and are replaced by a
// valid one.
inline cudaError_t tensor_map_4d(CUtensorMap* map, const void* ptr, int B,
                                 int T, int heads, int D, long long sb,
                                 long long st, long long sh, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(D) * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(T),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {
      T == 1 ? row_bytes : static_cast<cuuint64_t>(st) * 2,
      heads == 1 ? row_bytes : static_cast<cuuint64_t>(sh) * 2,
      B == 1 ? row_bytes : static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box,
                      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
