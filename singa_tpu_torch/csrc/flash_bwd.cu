// Flash attention backward for NVIDIA Hopper (sm_90a): dQ and dK/dV.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (both launched by `_bwd`) of singa_tpu/ops/flash_attention.py.  Same
// function, with P recomputed from the forward's lse:
//   p  = exp(scale * q k^T - lse), set to 0 where masked (after the exp,
//        as the Pallas backward does),
//   dp = dO V^T,  ds = p * (dp - delta) * scale,
//   dQ = ds K,    dV = sum_q p^T dO,    dK = sum_q ds^T Q,
// where delta = rowsum(dO * O) - dlse comes in precomputed (the Python
// wrapper folds the lse cotangent into it, as `_bwd` does).  Causal
// masking is bottom-right aligned, an optional sliding window applies,
// fully masked tiles are skipped, and GQA query head h reads kv head
// h / (H / K).  dK and dV are summed over each GQA group in f32 registers
// inside one block and written once in (B, Tk, K, D): deterministic, no
// atomics.  (The Pallas kernel writes one (B, H, Tk, D) share per query
// head, rounded to the input dtype, and sums the group afterwards; here
// the sum is rounded once.)
//
// What bounds it: at the training shape (B=8, H=16, K=8, T=1024, D=128,
// bf16, causal) dQ does three products and dK/dV four over 524,800
// causal (q, k) pairs per head: 51.6 and 68.8 GFLOP, 0.0522 and 0.0696 ms
// at the H100's 989 TFLOP/s, against ~135 MB each (0.040 ms at 3.35
// TB/s).  Tensor-core operations bound both; the scores never reach
// device memory.
//
// bf16 design, head dims up to 128 (flash_bwd_dkv_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel).  Both are persistent: one block per SM
// walks its share of the work tiles, heaviest first, in snake order;
// 384 threads, two consumer warpgroups and one producer warp.  Against
// what held the mma.sync kernels (kept below for head dims above 128) to
// 7% of their bounds at the training shape:
//   1. loads: one producer thread issues TMA loads through 4-D tensor
//      maps over the public (B, T, heads, D) layouts (encoded on the host
//      from the strides the entry points receive) into mbarrier rings,
//      each stage with a "full" barrier (transaction bytes) and an
//      "empty" one the consumer warps arrive on.  No __syncthreads in the
//      loops; the rings run on across work tiles.
//        dK/dV: a work tile is (b, kv head, 128 keys), its K and V loaded
//      once and resident; the ring carries, for each of the G query heads
//      and each live 64-row q tile, the Q tile, the dO tile and those
//      rows of lse and delta (two 256-byte cp.async.bulk copies counted
//      in the stage's transaction bytes).  The next work tile's first
//      stages load before its K and V, which wait for this tile's stores.
//        dQ: a work tile is (b, h, 128 q rows), Q and dO resident (loaded
//      again once both warpgroups' last products have read them), K/V
//      tiles of 64 keys through the ring, lse and delta of a thread's two
//      rows in registers.
//   2. products: wgmma (m64nNk16, f32 accumulation).  dK/dV: keys are
//      the M side, 64 a consumer warpgroup: S^T = K Q^T and dP^T = V dO^T
//      read both operands from shared memory, K-major; because keys are
//      the rows of S^T its accumulator layout is the A-fragment layout of
//      dV += P^T dO and dK += dS^T Q, which take P^T and dS^T from
//      registers (bf16) and dO and Q q-rows-major through the transpose
//      bit, so P and dS never touch shared memory.  dQ: S = Q K^T and
//      dP = dO V^T from shared memory, dQ += dS K with dS from registers
//      and K keys-major through the transpose bit, as the forward reads
//      V; each turn issues tile i's S and dP with tile i - 1's dS K.
//      The two warpgroups take turns to issue (named barriers), so one's
//      elementwise work runs under the other's products.
//   3. fragments: the 128-byte swizzle that TMA writes is the layout the
//      wgmma descriptors read: nothing is gathered from shared memory by
//      hand.  The producer warpgroup drops to 24 registers
//      (setmaxnreg.dec), the consumers rise to 240; the roles split in
//      one if / else that never reconverges.  dK/dV read lse and delta
//      along the columns of S^T, 16 values a thread from the stage.
//   4. exponents in the exp2 domain: p = 2^(s c2 - lse log2 e), c2 =
//      scale log2 e, one FFMA and one ex2 each.  dS is formed as the
//      plain version forms it, p (dp - delta) scale, so that its rounding
//      to bf16 falls the same way (scaling dQ and dK in the epilogue
//      instead rounds another value, and on an H100 about doubled the
//      bf16 row error of dq at the training shape).  The mask is applied only on tiles that
//      cross the causal diagonal or the window's lower edge, as two
//      integer bounds a row (dQ) or column (dK/dV).
//   5. tiles: 128-key (dK/dV) and 128-row (dQ) work tiles, so each Q/dO
//      or K/V tile read serves 128 rows; dK/dV's 64-row q stages keep
//      S^T, dP^T, dK and dV (32 + 32 + 64 + 64 f32 a thread at D = 128)
//      in registers.  An item's S^T and dP^T are issued once the last
//      item's dV and dK have ended: their bf16 A operands (32 registers)
//      stay live until then, and with them ptxas ran short of registers
//      at D = 128 and serialised the wgmmas (C7512).  Persistent blocks
//      even out the causal imbalance.
//      Results are rounded to bf16 once, staged in the swizzle and stored
//      by TMA (dK and dV into the warpgroup's own K and V rows, dQ into a
//      staging tile of its own).
// Head dims are padded to a compiled width of 64 or 128 (D = 40 by TMA's
// out-of-bounds fill of zeros).
//
// bf16 at head dims above 128 (up to 256) runs the mma.sync kernels
// (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel), routed by shape
// in the entry points: there dK/dV's two f32 accumulators alone would
// take 256 registers a thread in the wgmma design.  They hold dQ in f32
// registers for a 64-row q tile, and dK/dV for a 64-key tile split over
// two warps by output columns.
//
// f32 runs plain-FMA kernels (TF32 would not meet the f32 limits).
//
// Inputs are read in the public (B, T, H, D) layout through strides
// (elements); the head dim must be contiguous and rows 16-byte aligned
// (the Python wrapper checks).  lse and delta are contiguous, 16-byte
// aligned (B, H, Tq) f32.  dq is written through its own strides, dk and dv through one
// shared set.  Tq and Tk must be multiples of 128 in bf16 and of 64 in
// f32.
//
// C entry points singa_flash_bwd_dq(...) and singa_flash_bwd_dkv(...)
// launch on the given stream and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments they do not take).  Each launch
// that runs adds one to the device counter `count` points at (see
// hopper::count_launch), also when it is replayed from a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, K, Tq, Tk, D;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  long long sdqb, sdqt, sdqh, sdkb, sdkt, sdkh;
  float scale;
  int causal;
  int window;  // <= 0: no window
  int off;     // Tk - Tq
  unsigned long long* count;  // launches that ran (null: not counted)
};

// The Pallas kernels' tile-skip predicates (flash_attention.py:126-131,
// :170-175) for a bm-row q tile at q0 and a bn-key tile at k0.
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int bm,
                                          int k0, int bn) {
  bool live = true;
  if (p.causal) live = (q0 + bm - 1 + p.off) >= k0;
  if (p.window > 0) live = live && (k0 + bn - 1 > q0 + p.off - p.window);
  return live;
}

// the mask: query qi sees key kj
__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  const int qpos = qi + p.off;
  bool ok = true;
  if (p.causal) ok = qpos >= kj;
  if (p.window > 0) ok = ok && (kj > qpos - p.window);
  return ok;
}

// ---------------------------------------------------------------------------
// bf16 at head dims above 128: mma.sync tensor-core kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy `rows` rows of D bf16 (row stride `gstride` elements) into shared
// memory rows of DMAX (+pad) elements, zero-filling columns D..DMAX-1.
template <int DMAX, int NT>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* s, int lds,
                                               const __nv_bfloat16* g,
                                               long long gstride, int rows,
                                               int D) {
  constexpr int kChunks = DMAX / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (col < D)
      val = *reinterpret_cast<const uint4*>(g + r * gstride + col);
    *reinterpret_cast<uint4*>(s + r * lds + col) = val;
  }
}

// Accumulate acc(16 x 8*NT8) += A(16 x 16*KS) . B, where A's fragments are
// the f32 mma outputs x[2 * KS][4] (two 8-wide n tiles per 16-deep k step)
// and B[k][n] is row k of the smem tile `rows` (row stride LDS), column n.
template <int KS, int NT8, int LDS>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[NT8][4],
                                             const float (&x)[2 * KS][4],
                                             const __nv_bfloat16* rows,
                                             int tig, int g, int ncols) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t a0 = pack_f32_bf16(x[2 * ks][0], x[2 * ks][1]);
    const uint32_t a1 = pack_f32_bf16(x[2 * ks][2], x[2 * ks][3]);
    const uint32_t a2 = pack_f32_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    const uint32_t a3 = pack_f32_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
    const __nv_bfloat16* r = rows + (ks * 16 + tig * 2) * LDS + g;
#pragma unroll
    for (int i = 0; i < NT8; ++i) {
      if (i * 8 >= ncols) break;
      const __nv_bfloat16* bp = r + i * 8;
      const uint32_t b0 = pack_bf16(bp[0], bp[LDS]);
      const uint32_t b1 = pack_bf16(bp[8 * LDS], bp[9 * LDS]);
      mma_16816(acc[i], a0, a1, a2, a3, b0, b1);
    }
  }
}

// x(16 x 8*NJ) = A(16 rows of `arows` from row ra) . B^T, B^T's column n
// being row n of `brows` -- the contraction over the (padded) head dim.
template <int NKS, int NJ, int LDS>
__device__ __forceinline__ void mma_rows_rowsT(float (&x)[NJ][4],
                                               const __nv_bfloat16* arows,
                                               const __nv_bfloat16* brows,
                                               int ra, int tig, int g,
                                               int D) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    if (ks * 16 >= D) break;  // zero padding contributes nothing
    const int c = ks * 16 + tig * 2;
    const uint32_t a0 = ld_u32(arows + ra * LDS + c);
    const uint32_t a1 = ld_u32(arows + (ra + 8) * LDS + c);
    const uint32_t a2 = ld_u32(arows + ra * LDS + c + 8);
    const uint32_t a3 = ld_u32(arows + (ra + 8) * LDS + c + 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t b0 = ld_u32(brows + (j * 8 + g) * LDS + c);
      const uint32_t b1 = ld_u32(brows + (j * 8 + g) * LDS + c + 8);
      mma_16816(x[j], a0, a1, a2, a3, b0, b1);
    }
  }
}

// dQ: one block of 4 warps per (b, h, 64-row q tile), 16 q rows a warp.
template <int DMAX, int BN>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const Params p) {
  hopper::count_launch(p.count);
  constexpr int NT = 128, BM = 64;
  constexpr int LDS = DMAX + 8;  // padded smem row (elements)
  constexpr int NDT = DMAX / 8;  // 8-wide dQ column tiles
  constexpr int NKS = DMAX / 16; // 16-deep k steps over the head dim
  constexpr int NST = BN / 8;    // 8-wide score column tiles
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LDS;
  bf16* Ks = dOs + BM * LDS;
  bf16* Vs = Ks + BN * LDS;

  // heaviest (latest, under causal masking) q tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int D = p.D;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh +
                   q0 * p.sqt;
  const bf16* og = static_cast<const bf16*>(p.dout) + b * p.sob +
                   h * p.soh + q0 * p.sot;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kh * p.svh;
  load_rows_bf16<DMAX, NT>(Qs, LDS, qg, p.sqt, BM, D);
  load_rows_bf16<DMAX, NT>(dOs, LDS, og, p.sot, BM, D);

  const int rw = warp * 16 + g;  // smem row of this lane's first row
  const int row0 = q0 + rw;      // absolute rows row0 and row0 + 8
  const long long bh = ((long long)b * p.H + h) * p.Tq;
  const float lse_r[2] = {p.lse[bh + row0], p.lse[bh + row0 + 8]};
  const float dlt[2] = {p.delta[bh + row0], p.delta[bh + row0 + 8]};

  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BN) {
    if (!tile_live(p, q0, BM, k0, BN)) continue;  // uniform across the block
    __syncthreads();  // the previous tile's readers (and Q/dO writers) done
    load_rows_bf16<DMAX, NT>(Ks, LDS, kg + k0 * p.skt, p.skt, BN, D);
    load_rows_bf16<DMAX, NT>(Vs, LDS, vg + k0 * p.svt, p.svt, BN, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[NST][4], dp[NST][4];
    mma_rows_rowsT<NKS, NST, LDS>(s, Qs, Ks, rw, tig, g, D);
    mma_rows_rowsT<NKS, NST, LDS>(dp, dOs, Vs, rw, tig, g, D);

    // fragment element e: row + 8 * (e >= 2), key j * 8 + tig * 2 + (e & 1)
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = row0 + r * 8;
        const int kj = k0 + j * 8 + tig * 2 + (e & 1);
        const float pe =
            visible(p, qi, kj) ? expf(s[j][e] * p.scale - lse_r[r]) : 0.f;
        s[j][e] = pe * (dp[j][e] - dlt[r]) * p.scale;
      }
    }
    // dQ += dS K
    mma_acc_rows<BN / 16, NDT, LDS>(acc, s, Ks, tig, g, D);
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdqb + h * p.sdqh;
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    const int col = i * 8 + tig * 2;
    if (col >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = row0 + r * 8;
      *reinterpret_cast<__nv_bfloat162*>(dqg + row * p.sdqt + col) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
    }
  }
}

// dK/dV: one block per (b, kv head, 64-key tile).  Warp w owns keys
// (w % 4) * 16 .. +15 and output columns (w / 4) * DW .. +DW-1.
template <int DMAX>
__global__ void __launch_bounds__(DMAX > 128 ? 256 : 128)
    flash_bwd_dkv_bf16_kernel(const Params p) {
  hopper::count_launch(p.count);
  constexpr int NSPLIT = DMAX > 128 ? 2 : 1;
  constexpr int NT = 128 * NSPLIT;
  constexpr int BN = 64;           // keys per block
  constexpr int BQ = 32;           // q rows per inner step
  constexpr int DW = DMAX / NSPLIT;
  constexpr int LDS = DMAX + 8;
  constexpr int NKS = DMAX / 16;
  constexpr int NDW = DW / 8;      // 8-wide dK/dV column tiles of a warp
  constexpr int NQT = BQ / 8;      // 8-wide query column tiles
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * LDS;
  bf16* Qs = Vs + BN * LDS;
  bf16* dOs = Qs + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDS);
  float* dlt_s = lse_s + BQ;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BN;
  const int G = p.H / p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kw = (warp & 3) * 16;  // smem key row of this warp
  const int c0 = (warp >> 2) * DW; // first output column of this warp
  const int D = p.D;
  const int krow0 = k0 + kw + g;   // absolute keys krow0 and krow0 + 8

  load_rows_bf16<DMAX, NT>(
      Ks, LDS, static_cast<const bf16*>(p.k) + b * p.skb + kh * p.skh +
      k0 * p.skt, p.skt, BN, D);
  load_rows_bf16<DMAX, NT>(
      Vs, LDS, static_cast<const bf16*>(p.v) + b * p.svb + kh * p.svh +
      k0 * p.svt, p.svt, BN, D);

  float dk[NDW][4], dv[NDW][4];
#pragma unroll
  for (int i = 0; i < NDW; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int hq = kh * G + gi;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + hq * p.sqh;
    const bf16* og = static_cast<const bf16*>(p.dout) + b * p.sob +
                     hq * p.soh;
    const long long bh = ((long long)b * p.H + hq) * p.Tq;
    for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
      if (!tile_live(p, q0, BQ, k0, BN)) continue;  // uniform
      __syncthreads();  // the previous step's readers are done
      load_rows_bf16<DMAX, NT>(Qs, LDS, qg + q0 * p.sqt, p.sqt, BQ, D);
      load_rows_bf16<DMAX, NT>(dOs, LDS, og + q0 * p.sot, p.sot, BQ, D);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        lse_s[i] = p.lse[bh + q0 + i];
        dlt_s[i] = p.delta[bh + q0 + i];
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float st[NQT][4], dpt[NQT][4];
      mma_rows_rowsT<NKS, NQT, LDS>(st, Ks, Qs, kw + g, tig, g, D);
      mma_rows_rowsT<NKS, NQT, LDS>(dpt, Vs, dOs, kw + g, tig, g, D);

      // element e: key + 8 * (e >= 2), query j * 8 + tig * 2 + (e & 1)
#pragma unroll
      for (int j = 0; j < NQT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = krow0 + (e >> 1) * 8;
          const int ql = j * 8 + tig * 2 + (e & 1);
          const float pe = visible(p, q0 + ql, kj)
                                  ? expf(st[j][e] * p.scale - lse_s[ql])
                                  : 0.f;
          st[j][e] = pe;
          dpt[j][e] = pe * (dpt[j][e] - dlt_s[ql]) * p.scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q over the BQ queries
      mma_acc_rows<BQ / 16, NDW, LDS>(dv, st, dOs + c0, tig, g, D - c0);
      mma_acc_rows<BQ / 16, NDW, LDS>(dk, dpt, Qs + c0, tig, g, D - c0);
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdkb + kh * p.sdkh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdkb + kh * p.sdkh;
#pragma unroll
  for (int i = 0; i < NDW; ++i) {
    const int col = c0 + i * 8 + tig * 2;
    if (col >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long off = (long long)(krow0 + r * 8) * p.sdkt + col;
      *reinterpret_cast<__nv_bfloat162*>(dkg + off) =
          __floats2bfloat162_rn(dk[i][2 * r], dk[i][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + off) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 up to head dim 128: TMA-fed, warp-specialised wgmma kernels
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The r-th work tile of this block: rounds of gridDim.x tiles, walked in
// turn forwards and backwards (a snake), so every block gets a similar
// share of the heavy and the light tiles.
__device__ __forceinline__ int work_index(int r) {
  const int c = r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + c;
}

template <int DP>
struct DkvTile {
  static constexpr int kKeys = 128;  // keys per work tile, 64 a warpgroup
  static constexpr int kRows = 64;   // q rows per ring stage
  static constexpr int kStages = DP == 64 ? 6 : 4;
  static constexpr int kSlabs = DP / 64;             // 128-byte column slabs
  static constexpr int kKvBytes = kKeys * DP * 2;    // K or V
  static constexpr int kTileBytes = kRows * DP * 2;  // a Q or dO tile
  static constexpr int kRowBytes = kRows * 4;        // its lse or delta
  static constexpr int kLoadBytes = 2 * kTileBytes + 2 * kRowBytes;
  static constexpr int kStageBytes = (kLoadBytes + 1023) / 1024 * 1024;
  static constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
  // K, V, the ring, 2 + 2 kStages mbarriers, slack to align to 1024 bytes
  static constexpr int kSmem = 2 * kKvBytes + kStages * kStageBytes +
                               8 * (2 + 2 * kStages) + 1024;
};

// A dK/dV work tile: 128 keys from k0 of one (b, kv head), and its n ring
// items: for each of the group's query heads (outer), each of its nq live
// q tiles from tile qa.
struct DkvWork {
  int b, kh, k0, qa, nq, n;
};

// Tiles are numbered heaviest (earliest keys, under causal masking)
// first, kv heads fastest.
template <int DP>
__device__ __forceinline__ DkvWork dkv_work_tile(const Params& p, int w) {
  using T = DkvTile<DP>;
  DkvWork t;
  const int per_kt = p.K * p.B;
  t.k0 = w / per_kt * T::kKeys;
  t.kh = w % per_kt % p.K;
  t.b = w % per_kt / p.K;
  t.qa = t.nq = 0;
  for (int q = 0; q < p.Tq / T::kRows; ++q) {
    if (tile_live(p, q * T::kRows, T::kRows, t.k0, T::kKeys)) {
      if (t.nq == 0) t.qa = q;
      t.nq = q - t.qa + 1;
    }
  }
  t.n = p.H / p.K * t.nq;
  return t;
}

// One persistent block per SM walks its dK/dV work tiles; K and V stay
// resident for a tile while the ring brings its Q / dO stages.
template <int DP>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdk,
    const __grid_constant__ CUtensorMap tdv, const Params p) {
  using T = DkvTile<DP>;
  using namespace hopper;
  count_launch(p.count);
  constexpr int kS = T::kStages;
  constexpr int kTurn = 1;    // named barriers kTurn + wg: turns to issue
  constexpr int kStaged = 3;  // named barriers kStaged + wg: epilogue

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::kKvBytes;
  const uint32_t ring = sV + T::kKvBytes;
  const uint32_t kv_full = ring + kS * T::kStageBytes, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_empty + 8, empty0 = full0 + 8 * kS;
  const int n_work = p.Tk / T::kKeys * p.K * p.B;
  const int G = p.H / p.K;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tdo);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      int it = 0;  // ring items loaded before this work tile
      for (int wi = 0; work_index(wi) < n_work; ++wi) {
        const DkvWork t = dkv_work_tile<DP>(p, work_index(wi));
        // item j of the tile: Q, dO, lse and delta of one head's q tile
        auto load = [&](int j) {
          const int s = (it + j) % kS;
          const uint32_t dst = ring + s * T::kStageBytes, bar = full0 + 8 * s;
          const int hq = t.kh * G + j / t.nq;
          const int q0 = (t.qa + j % t.nq) * T::kRows;
          mbar_wait(empty0 + 8 * s, (((it + j) / kS) & 1) ^ 1);
          mbar_arrive_expect_tx(bar, T::kLoadBytes);
          for (int c = 0; c < T::kSlabs; ++c) {
            tma_load_4d(dst + c * T::kRows * 128, &tq, bar, c * 64, q0, hq,
                        t.b);
            tma_load_4d(dst + T::kTileBytes + c * T::kRows * 128, &tdo, bar,
                        c * 64, q0, hq, t.b);
          }
          const long long r0 = ((long long)t.b * p.H + hq) * p.Tq + q0;
          bulk_load(dst + 2 * T::kTileBytes, p.lse + r0, T::kRowBytes, bar);
          bulk_load(dst + 2 * T::kTileBytes + T::kRowBytes, p.delta + r0,
                    T::kRowBytes, bar);
        };
        // the first kS items wait only on stages of earlier tiles, so they
        // load before K and V, which wait for the last tile's stores
        const int pre = t.n < kS ? t.n : kS;
        for (int j = 0; j < pre; ++j) load(j);
        if (wi > 0) mbar_wait(kv_empty, (wi - 1) & 1);
        mbar_arrive_expect_tx(kv_full, 2 * T::kKvBytes);
        for (int c = 0; c < T::kSlabs; ++c) {
          tma_load_4d(sK + c * T::kKeys * 128, &tk, kv_full, c * 64, t.k0,
                      t.kh, t.b);
          tma_load_4d(sV + c * T::kKeys * 128, &tv, kv_full, c * 64, t.k0,
                      t.kh, t.b);
        }
        for (int j = pre; j < t.n; ++j) load(j);
        it += t.n;
      }
    }
  } else {
    // consumer warpgroups 0 and 1: 64 keys each.  Per ring item two turns
    // to issue (named barriers kTurn + wg): S^T and dP^T, then dV and dK,
    // so one warpgroup's exponents run under the other's products.
    setmaxnreg_inc<240>();
    const int wg = warp / 4;
    const int g = lane / 4, tig = lane % 4;
    const int rw = (warp % 4) * 16 + g;  // this lane's keys rw, rw + 8 of 64
    const float c2 = p.scale * kLog2e;
    const uint32_t ka = sK + wg * 64 * 128;  // this warpgroup's K rows
    const uint32_t va = sV + wg * 64 * 128;  // and V rows

    float dk[DP / 2], dv[DP / 2];
    // P^T and dS^T in bf16: the A operands of dV and dK, 16 q rows a step
    uint32_t pa[T::kRows / 16][4], da[T::kRows / 16][4];

    int it = 0;  // ring items consumed before this work tile
    for (int wi = 0; work_index(wi) < n_work; ++wi) {
      const DkvWork t = dkv_work_tile<DP>(p, work_index(wi));
      const int key0 = t.k0 + wg * 64;  // this warpgroup's first key
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, wi & 1);
      if (wg == 1 && t.n > 0) bar_arrive(kTurn, 256);  // warpgroup 0 first
      for (int j = 0; j < t.n; ++j) {
        const int stage = (it + j) % kS;
        const int q0 = (t.qa + j % t.nq) * T::kRows;
        const uint32_t qst = ring + stage * T::kStageBytes;
        const uint32_t dost = qst + T::kTileBytes;
        mbar_wait(full0 + 8 * stage, ((it + j) / kS) & 1);

        // the last item's dV and dK are done (before this item's S^T and
        // dP^T take their registers: the A operands of those products stay
        // live until they end, and with them ptxas runs short of registers
        // at D = 128 and serialises the wgmmas); free its stage
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it + j - 1) % kS));

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each
        float s[T::kRows / 2], dp[T::kRows / 2];
        bar_sync(kTurn + wg, 256);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t slab = kk / 4, col = (kk % 4) * 32;
          wgmma_ss(s, desc_k_major(ka + slab * T::kKeys * 128 + col),
                   desc_k_major(qst + slab * T::kRows * 128 + col), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t slab = kk / 4, col = (kk % 4) * 32;
          wgmma_ss(dp, desc_k_major(va + slab * T::kKeys * 128 + col),
                   desc_k_major(dost + slab * T::kRows * 128 + col), kk > 0);
        }
        wgmma_commit();
        bar_arrive(kTurn + (wg ^ 1), 256);
        wgmma_wait<1>();  // S^T is done
        fence_regs(s);

        // p^T = 2^(s c2 - lse log2 e), 0 where masked; ds^T = p^T (dp^T -
        // delta) scale, in the plain version's order, so that its bf16
        // rounding falls the same way.  Element i of this lane
        // is key rw + 8 ((i / 2) % 2) by q row q0 + c + 2 tig, c = 8 (i /
        // 4) + i % 2; lse and delta run along the q rows.
        const uint32_t lt = qst + 2 * T::kTileBytes;  // lse, then delta
#pragma unroll
        for (int c = 0; c < T::kRows / 8; ++c) {
          const float2 l = ld_shared_f2(lt + (8 * c + 2 * tig) * 4);
          const float ll[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * c + e] = exp2_approx(fmaf(s[4 * c + e], c2, -ll[e % 2]));
        }
        // the mask only where these 64 keys x 64 q rows cross the causal
        // diagonal or the window's lower edge: q row q0 + 2 tig + c sees
        // key k when lo <= c < hi
        const bool edge =
            (p.causal && key0 + 63 > q0 + p.off) ||
            (p.window > 0 && key0 <= q0 + T::kRows - 1 + p.off - p.window);
        if (edge) {
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rel = key0 + rw + 8 * r - q0 - p.off - 2 * tig;
            lo[r] = p.causal ? rel : INT_MIN;
            hi[r] = p.window > 0 ? rel + p.window : INT_MAX;
          }
#pragma unroll
          for (int i = 0; i < T::kRows / 2; ++i) {
            const int c = (i >> 2) * 8 + (i & 1), r = (i >> 1) & 1;
            if (c < lo[r] || c >= hi[r]) s[i] = 0.f;
          }
        }
        wgmma_wait<0>();  // dP^T, whose product ran under the exponents
        fence_regs(dp);
#pragma unroll
        for (int c = 0; c < T::kRows / 8; ++c) {
          const float2 d = ld_shared_f2(lt + T::kRowBytes + (8 * c + 2 * tig) * 4);
          const float dd[2] = {d.x, d.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * c + e] = s[4 * c + e] * (dp[4 * c + e] - dd[e % 2]) * p.scale;
        }
#pragma unroll
        for (int ks = 0; ks < T::kRows / 16; ++ks) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            pa[ks][h] = pack_bf16x2(s[8 * ks + 2 * h], s[8 * ks + 2 * h + 1]);
            da[ks][h] = pack_bf16x2(dp[8 * ks + 2 * h], dp[8 * ks + 2 * h + 1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO
        // and Q q-rows-major in shared memory (the transpose bit)
        bar_sync(kTurn + wg, 256);
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < T::kRows / 16; ++ks)
          wgmma_rs_tb(dv, pa[ks],
                      desc_mn_major(dost + ks * 16 * 128, T::kRows * 128), 1);
#pragma unroll
        for (int ks = 0; ks < T::kRows / 16; ++ks)
          wgmma_rs_tb(dk, da[ks],
                      desc_mn_major(qst + ks * 16 * 128, T::kRows * 128), 1);
        wgmma_commit();
        // warpgroup 1's last turn of the tile hands none on
        if (wg == 0 || j < t.n - 1) bar_arrive(kTurn + (wg ^ 1), 256);
      }
      // the last item's dV and dK (unconditional: a wait that ptxas cannot
      // prove on every path to the epilogue's reads serialises the wgmmas)
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (t.n > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it + t.n - 1) % kS));

      // epilogue: dK and dV in bf16, in the 128-byte swizzle, into
      // this warpgroup's own K and V rows (no other warpgroup reads them),
      // then one TMA store per 64-column slab; K and V are handed back to
      // the producer once both warpgroups' stores have read them
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = wg * 64 + rw + 8 * r;
          const uint32_t off = (j / 8) * T::kKeys * 128 + rr * 128 +
                               ((j % 8) ^ (rr % 8)) * 16 + tig * 4;
          st_shared_u32(sK + off,
                        pack_bf16x2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]));
          st_shared_u32(sV + off,
                        pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]));
        }
      }
      fence_proxy_async();
      bar_sync(kStaged + wg, 128);
      if (threadIdx.x % 128 == 0) {
        for (int c = 0; c < T::kSlabs; ++c) {
          const uint32_t rows = c * T::kKeys * 128 + wg * 64 * 128;
          tma_store_4d(&tdk, sK + rows, c * 64, key0, t.kh, t.b);
          tma_store_4d(&tdv, sV + rows, c * 64, key0, t.kh, t.b);
        }
        tma_store_wait();
        mbar_arrive(kv_empty);
      }
      it += t.n;
    }
  }
}

template <int DP>
struct DqTile {
  static constexpr int kRows = 128;  // q rows per work tile, 64 a warpgroup
  static constexpr int kKeys = 64;   // keys per K/V tile
  static constexpr int kStages = 4;
  static constexpr int kSlabs = DP / 64;              // 128-byte column slabs
  static constexpr int kQBytes = kRows * DP * 2;      // Q, dO or staged dQ
  static constexpr int kTileBytes = kKeys * DP * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
  // Q, dO, the dQ staging tile, the ring, 2 + 2 kStages mbarriers, slack
  static constexpr int kSmem = 3 * kQBytes + kStages * kStageBytes +
                               8 * (2 + 2 * kStages) + 1024;
};

// A dQ work tile: 128 q rows of one (b, h) and its run [n0, n1) of live
// K/V tiles.  Tiles are numbered heaviest (latest q rows, under causal
// masking) first, heads fastest, so the heads of a GQA group run side by
// side and share K/V tiles through L2.
struct DqWork {
  int b, h, q0, n0, n1;
};

template <int DP>
__device__ __forceinline__ DqWork dq_work_tile(const Params& p, int w) {
  using T = DqTile<DP>;
  DqWork t;
  const int per_qt = p.H * p.B;
  t.q0 = (p.Tq / T::kRows - 1 - w / per_qt) * T::kRows;
  t.h = w % per_qt % p.H;
  t.b = w % per_qt / p.H;
  t.n0 = t.n1 = 0;
  for (int n = p.Tk / T::kKeys - 1; n >= 0; --n) {
    if (tile_live(p, t.q0, T::kRows, n * T::kKeys, T::kKeys)) {
      t.n0 = n;
      if (t.n1 == 0) t.n1 = n + 1;
    }
  }
  return t;
}

// One persistent block per SM walks its dQ work tiles: Q and dO resident,
// K/V tiles through the ring, which runs on across work tiles.
template <int DP>
__global__ void __launch_bounds__(384, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdq, const Params p) {
  using T = DqTile<DP>;
  using namespace hopper;
  count_launch(p.count);
  constexpr int kS = T::kStages;
  constexpr int kTurn = 1;    // named barriers kTurn + wg: turns to issue
  constexpr int kStaged = 3;  // named barriers kStaged + wg: epilogue

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + T::kQBytes, sdQ = sdO + T::kQBytes;
  const uint32_t ring = sdQ + T::kQBytes;
  const uint32_t q_full = ring + kS * T::kStageBytes, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * kS;
  const int n_work = p.Tq / T::kRows * p.H * p.B;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      prefetch_tensor_map(&tq);
      prefetch_tensor_map(&tdo);
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      int it = 0;  // K/V tiles loaded so far
      for (int wi = 0; work_index(wi) < n_work; ++wi) {
        const DqWork t = dq_work_tile<DP>(p, work_index(wi));
        const int kh = t.h / (p.H / p.K);
        if (wi > 0) mbar_wait(q_empty, (wi - 1) & 1);
        mbar_arrive_expect_tx(q_full, 2 * T::kQBytes);
        for (int c = 0; c < T::kSlabs; ++c) {
          tma_load_4d(sQ + c * T::kRows * 128, &tq, q_full, c * 64, t.q0, t.h,
                      t.b);
          tma_load_4d(sdO + c * T::kRows * 128, &tdo, q_full, c * 64, t.q0,
                      t.h, t.b);
        }
        for (int n = t.n0; n < t.n1; ++n, ++it) {
          const int s = it % kS;
          const uint32_t kdst = ring + s * T::kStageBytes;
          const uint32_t vdst = kdst + T::kTileBytes;
          mbar_wait(empty0 + 8 * s, ((it / kS) & 1) ^ 1);
          mbar_arrive_expect_tx(full0 + 8 * s, T::kStageBytes);
          for (int c = 0; c < T::kSlabs; ++c) {
            tma_load_4d(kdst + c * T::kKeys * 128, &tk, full0 + 8 * s,
                        c * 64, n * T::kKeys, kh, t.b);
            tma_load_4d(vdst + c * T::kKeys * 128, &tv, full0 + 8 * s,
                        c * 64, n * T::kKeys, kh, t.b);
          }
        }
      }
    }
  } else {
    // consumer warpgroups 0 and 1: 64 q rows each.  They take turns to
    // issue (named barriers kTurn + wg); each turn issues tile i's S and
    // dP, then tile i - 1's dQ += dS K, so tile i's exponents run under
    // that product and under the other warpgroup's turn.
    setmaxnreg_inc<240>();
    const int wg = warp / 4;
    const int g = lane / 4, tig = lane % 4;
    const int rw = (warp % 4) * 16 + g;  // this lane's rows rw, rw + 8 of 64
    const float c2 = p.scale * kLog2e;
    const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's Q rows
    const uint32_t oa = sdO + wg * 64 * 128;  // and dO rows

    float dq[DP / 2];
    uint32_t pa[T::kKeys / 16][4];  // the last tile's dS in bf16, 16 keys a step

    // dQ += dS K for the tile in ring stage `stage`: dS is the A operand
    // in registers, K keys-major in shared memory (the transpose bit)
    auto issue_dq = [&](int stage) {
      const uint32_t kb = ring + stage * T::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk)
        wgmma_rs_tb(dq, pa[kk], desc_mn_major(kb + kk * 16 * 128,
                                              T::kKeys * 128), 1);
    };

    int it = 0;  // K/V tiles consumed so far
    for (int wi = 0; work_index(wi) < n_work; ++wi) {
      const DqWork t = dq_work_tile<DP>(p, work_index(wi));
      const int q0 = t.q0, nt = t.n1 - t.n0;
      const int row0 = q0 + wg * 64 + rw;  // absolute rows row0, row0 + 8
      const int qpos_lo = q0 + wg * 64 + p.off;  // this warpgroup's first
      const long long bh = ((long long)t.b * p.H + t.h) * p.Tq;
      const float lse2[2] = {p.lse[bh + row0] * kLog2e,
                             p.lse[bh + row0 + 8] * kLog2e};
      const float dl[2] = {p.delta[bh + row0], p.delta[bh + row0 + 8]};
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

      mbar_wait(q_full, wi & 1);
      if (wg == 1 && nt > 0) bar_arrive(kTurn, 256);  // warpgroup 0 first
      for (int i = 0; i < nt; ++i) {
        const int stage = (it + i) % kS;
        const int k0 = (t.n0 + i) * T::kKeys;
        const uint32_t kst = ring + stage * T::kStageBytes;
        const uint32_t vst = kst + T::kTileBytes;
        mbar_wait(full0 + 8 * stage, ((it + i) / kS) & 1);

        // issue S = Q K^T and dP = dO V^T (64 rows x 64 keys), then the
        // last tile's dQ += dS K
        float s[T::kKeys / 2], dp[T::kKeys / 2];
        bar_sync(kTurn + wg, 256);
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dq);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t slab = kk / 4, col = (kk % 4) * 32;
          wgmma_ss(s, desc_k_major(qa + slab * T::kRows * 128 + col),
                   desc_k_major(kst + slab * T::kKeys * 128 + col), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t slab = kk / 4, col = (kk % 4) * 32;
          wgmma_ss(dp, desc_k_major(oa + slab * T::kRows * 128 + col),
                   desc_k_major(vst + slab * T::kKeys * 128 + col), kk > 0);
        }
        wgmma_commit();
        if (i > 0) issue_dq((it + i - 1) % kS);
        wgmma_commit();  // an empty group on the first tile
        bar_arrive(kTurn + (wg ^ 1), 256);
        wgmma_wait<2>();  // S is done; dP and dS K may still run
        fence_regs(s);

        // p = 2^(s c2 - lse log2 e), 0 where masked; ds = p (dp - delta)
        // scale, in the plain version's order (so its bf16 rounding falls
        // the same way)
#pragma unroll
        for (int j = 0; j < T::kKeys / 2; ++j)
          s[j] = exp2_approx(fmaf(s[j], c2, -lse2[(j >> 1) & 1]));
        // the mask only where the tile crosses the causal diagonal or the
        // window's lower edge for these 64 rows: key k0 + 2 tig + c is
        // visible from row qi when lo < c <= hi, c = 8 (j / 4) + j % 2
        const bool edge =
            (p.causal && k0 + T::kKeys - 1 > qpos_lo) ||
            (p.window > 0 && k0 <= qpos_lo + 63 - p.window);
        if (edge) {
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rel = row0 + 8 * r + p.off - k0 - tig * 2;
            hi[r] = p.causal ? rel : INT_MAX;
            lo[r] = p.window > 0 ? rel - p.window : INT_MIN;
          }
#pragma unroll
          for (int j = 0; j < T::kKeys / 2; ++j) {
            const int c = (j >> 2) * 8 + (j & 1), r = (j >> 1) & 1;
            if (c > hi[r] || c <= lo[r]) s[j] = 0.f;
          }
        }
        wgmma_wait<1>();  // dP is done
        fence_regs(dp);
        if (i == nt - 1 && lane == 0) mbar_arrive(q_empty);  // Q, dO read
#pragma unroll
        for (int j = 0; j < T::kKeys / 2; ++j)
          dp[j] = s[j] * (dp[j] - dl[(j >> 1) & 1]) * p.scale;

        // the last tile's dS K is done: free its stage
        wgmma_wait<0>();
        fence_regs(dq);
        if (i > 0 && lane == 0)
          mbar_arrive(empty0 + 8 * ((it + i - 1) % kS));
#pragma unroll
        for (int ks = 0; ks < T::kKeys / 16; ++ks) {
#pragma unroll
          for (int h = 0; h < 4; ++h)
            pa[ks][h] = pack_bf16x2(dp[8 * ks + 2 * h], dp[8 * ks + 2 * h + 1]);
        }
      }
      if (nt > 0) {  // the last tile's dS K
        bar_sync(kTurn + wg, 256);
        fence_regs(dq);
        fence_regs(pa);
        wgmma_fence();
        issue_dq((it + nt - 1) % kS);
        wgmma_commit();
        if (wg == 0) bar_arrive(kTurn + 1, 256);
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it + nt - 1) % kS));
      } else if (lane == 0) {
        mbar_arrive(q_empty);
      }

      // epilogue: dQ in bf16, in the 128-byte swizzle, into this
      // warpgroup's rows of the staging tile (once its last store has read
      // them), then one TMA store per 64-column slab
      bar_sync(kStaged + wg, 128);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = wg * 64 + rw + 8 * r;
          st_shared_u32(sdQ + (j / 8) * T::kRows * 128 + rr * 128 +
                            ((j % 8) ^ (rr % 8)) * 16 + tig * 4,
                        pack_bf16x2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]));
        }
      }
      fence_proxy_async();
      bar_sync(kStaged + wg, 128);
      if (threadIdx.x % 128 == 0) {
        for (int c = 0; c < T::kSlabs; ++c)
          tma_store_4d(&tdq, sdQ + c * T::kRows * 128 + wg * 64 * 128,
                       c * 64, q0 + wg * 64, t.h, t.b);
        tma_store_wait();
      }
      it += nt;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain-FMA kernels (four lanes share each row)
// ---------------------------------------------------------------------------

// dQ: one block of 128 threads per (b, h, 32-row q tile), 64-key tiles.
template <int DMAX>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Params p) {
  hopper::count_launch(p.count);
  constexpr int NT = 128, BM = 32, BN = 64;
  constexpr int CPT = BN / 4;    // keys per lane
  constexpr int DPT = DMAX / 4;  // dQ columns per lane
  constexpr int LDP = BN + 1;

  extern __shared__ float smf[];
  const int D = p.D, LD = D + 1;  // odd row stride: no bank conflicts
  float* Qs = smf;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const int kh = h / (p.H / p.K);
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int row = q0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh +
                    q0 * p.sqt;
  const float* og = static_cast<const float*>(p.dout) + b * p.sob +
                    h * p.soh + q0 * p.sot;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kh * p.svh;
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    Qs[(i / D) * LD + i % D] = qg[(i / D) * p.sqt + i % D];
    dOs[(i / D) * LD + i % D] = og[(i / D) * p.sot + i % D];
  }
  const long long bh = ((long long)b * p.H + h) * p.Tq;
  const float lse_r = p.lse[bh + row], dlt_r = p.delta[bh + row];

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += BN) {
    if (!tile_live(p, q0, BM, k0, BN)) continue;
    __syncthreads();
    for (int i = threadIdx.x; i < BN * D; i += NT) {
      const int kr = i / D, d = i % D;
      Ks[kr * LD + d] = kg[(k0 + kr) * p.skt + d];
      Vs[kr * LD + d] = vg[(k0 + kr) * p.svt + d];
    }
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d], ov = dOs[r * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[j] += qv * Ks[(c4 + 4 * j) * LD + d];
        dp[j] += ov * Vs[(c4 + 4 * j) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pe = visible(p, row, k0 + c4 + 4 * j)
                           ? expf(s[j] * p.scale - lse_r) : 0.f;
      Ps[r * LDP + c4 + 4 * j] = pe * (dp[j] - dlt_r) * p.scale;
    }
    __syncwarp();  // a row's four lanes share one warp
    for (int c = 0; c < BN; ++c) {
      const float ds = Ps[r * LDP + c];
      const float* kr = Ks + c * LD + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        if (c4 + 4 * i < D) acc[i] += ds * kr[4 * i];
    }
    __syncwarp();
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.sdqb + h * p.sdqh +
               row * p.sdqt;
#pragma unroll
  for (int i = 0; i < DPT; ++i)
    if (c4 + 4 * i < D) dqg[c4 + 4 * i] = acc[i];
}

// dK/dV: one block of 256 threads per (b, kv head, 64-key tile), 32-row q
// steps over the group's query heads.
template <int DMAX>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const Params p) {
  hopper::count_launch(p.count);
  constexpr int NT = 256, BN = 64, BQ = 32;
  constexpr int CPT = BQ / 4;    // queries per lane
  constexpr int DPT = DMAX / 4;  // dK/dV columns per lane
  constexpr int LDP = BQ + 1;

  extern __shared__ float smf[];
  const int D = p.D, LD = D + 1;
  float* Ks = smf;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BQ * LD;
  float* Pt = dOs + BQ * LD;
  float* dSt = Pt + BN * LDP;
  float* lse_s = dSt + BN * LDP;
  float* dlt_s = lse_s + BQ;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BN;
  const int G = p.H / p.K;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int key = k0 + r;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kh * p.svh;
  for (int i = threadIdx.x; i < BN * D; i += NT) {
    const int kr = i / D, d = i % D;
    Ks[kr * LD + d] = kg[(k0 + kr) * p.skt + d];
    Vs[kr * LD + d] = vg[(k0 + kr) * p.svt + d];
  }

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk[i] = dv[i] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int hq = kh * G + hg;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb +
                      hq * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sob +
                      hq * p.soh;
    const long long bh = ((long long)b * p.H + hq) * p.Tq;
    for (int q0 = 0; q0 < p.Tq; q0 += BQ) {
      if (!tile_live(p, q0, BQ, k0, BN)) continue;
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * D; i += NT) {
        const int qr = i / D, d = i % D;
        Qs[qr * LD + d] = qg[(q0 + qr) * p.sqt + d];
        dOs[qr * LD + d] = og[(q0 + qr) * p.sot + d];
      }
      for (int i = threadIdx.x; i < BQ; i += NT) {
        lse_s[i] = p.lse[bh + q0 + i];
        dlt_s[i] = p.delta[bh + q0 + i];
      }
      __syncthreads();

      float st[CPT], dpt[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) st[j] = dpt[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[r * LD + d], vv = Vs[r * LD + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          st[j] += kv * Qs[(c4 + 4 * j) * LD + d];
          dpt[j] += vv * dOs[(c4 + 4 * j) * LD + d];
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int ql = c4 + 4 * j;
        const float pe = visible(p, q0 + ql, key)
                                ? expf(st[j] * p.scale - lse_s[ql]) : 0.f;
        Pt[r * LDP + ql] = pe;
        dSt[r * LDP + ql] = pe * (dpt[j] - dlt_s[ql]) * p.scale;
      }
      __syncwarp();
      for (int c = 0; c < BQ; ++c) {
        const float pv = Pt[r * LDP + c], dsv = dSt[r * LDP + c];
        const float* orow = dOs + c * LD + c4;
        const float* qrow = Qs + c * LD + c4;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          if (c4 + 4 * i < D) {
            dv[i] += pv * orow[4 * i];
            dk[i] += dsv * qrow[4 * i];
          }
        }
      }
      __syncwarp();
    }
  }

  const long long off = b * p.sdkb + kh * p.sdkh + (long long)key * p.sdkt;
  float* dkg = static_cast<float*>(p.dk) + off;
  float* dvg = static_cast<float*>(p.dv) + off;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    if (c4 + 4 * i < D) {
      dkg[c4 + 4 * i] = dk[i];
      dvg[c4 + 4 * i] = dv[i];
    }
  }
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `smem_max` once per
// kernel instance and device (`ready` holds one flag per device).
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, size_t smem_max,
                            bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  return cudaSuccess;
}

// Launch `kernel` on `grid` with `smem` bytes of dynamic shared memory.
// The limit is raised to `smem_max` once per kernel instance and device.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   size_t smem_max, bool (&ready)[kMaxDevices],
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = smem_limit_once(kernel, smem_max, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// One persistent block per SM, or one per work tile when there are fewer.
cudaError_t persistent_grid(int n_work, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = n_work < sms ? n_work : sms;
  return err;
}

template <int DP>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  using T = DqTile<DP>;
  static bool ready[kMaxDevices];
  CUtensorMap tq, tdo, tk, tv, tdq;
  cudaError_t err = hopper::tensor_map_4d(&tq, p.q, p.B, p.Tq, p.H, p.D,
                                          p.sqb, p.sqt, p.sqh, T::kRows);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tdo, p.dout, p.B, p.Tq, p.H, p.D, p.sob,
                                p.sot, p.soh, T::kRows);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tk, p.k, p.B, p.Tk, p.K, p.D, p.skb, p.skt,
                                p.skh, T::kKeys);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tv, p.v, p.B, p.Tk, p.K, p.D, p.svb, p.svt,
                                p.svh, T::kKeys);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tdq, p.dq, p.B, p.Tq, p.H, p.D, p.sdqb,
                                p.sdqt, p.sdqh, 64);
  if (err == cudaSuccess)
    err = smem_limit_once(flash_bwd_dq_wgmma_kernel<DP>, T::kSmem, ready);
  int grid = 0;
  if (err == cudaSuccess)
    err = persistent_grid(p.Tq / T::kRows * p.H * p.B, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<DP><<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tdo, tk, tv, tdq, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  using T = DkvTile<DP>;
  static bool ready[kMaxDevices];
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  cudaError_t err = hopper::tensor_map_4d(&tq, p.q, p.B, p.Tq, p.H, p.D,
                                          p.sqb, p.sqt, p.sqh, T::kRows);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tdo, p.dout, p.B, p.Tq, p.H, p.D, p.sob,
                                p.sot, p.soh, T::kRows);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tk, p.k, p.B, p.Tk, p.K, p.D, p.skb, p.skt,
                                p.skh, T::kKeys);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tv, p.v, p.B, p.Tk, p.K, p.D, p.svb, p.svt,
                                p.svh, T::kKeys);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tdk, p.dk, p.B, p.Tk, p.K, p.D, p.sdkb,
                                p.sdkt, p.sdkh, 64);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tdv, p.dv, p.B, p.Tk, p.K, p.D, p.sdkb,
                                p.sdkt, p.sdkh, 64);
  if (err == cudaSuccess)
    err = smem_limit_once(flash_bwd_dkv_wgmma_kernel<DP>, T::kSmem, ready);
  int grid = 0;
  if (err == cudaSuccess)
    err = persistent_grid(p.Tk / T::kKeys * p.K * p.B, &grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<DP><<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, p);
  return cudaGetLastError();
}

// bf16 at head dims 129-256: the mma.sync kernels
cudaError_t launch_dq_mma256(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  const size_t smem = (size_t)(2 * 64 + 2 * 32) * (256 + 8) * 2;
  return launch(flash_bwd_dq_bf16_kernel<256, 32>, dim3(p.Tq / 64, p.H, p.B),
                128, smem, smem, ready, p, stream);
}

cudaError_t launch_dkv_mma256(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  const size_t smem = (size_t)(2 * 64 + 2 * 32) * (256 + 8) * 2 + 2 * 32 * 4;
  return launch(flash_bwd_dkv_bf16_kernel<256>, dim3(p.Tk / 64, p.K, p.B),
                256, smem, smem, ready, p, stream);
}

template <int DMAX>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto bytes = [](int d) {
    return ((size_t)(2 * 32 + 2 * 64) * (d + 1) + 32 * (64 + 1)) * 4;
  };
  return launch(flash_bwd_dq_f32_kernel<DMAX>, dim3(p.Tq / 32, p.H, p.B),
                128, bytes(p.D), bytes(DMAX), ready, p, stream);
}

template <int DMAX>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto bytes = [](int d) {
    return ((size_t)(2 * 64 + 2 * 32) * (d + 1) + 2 * 64 * (32 + 1) +
            2 * 32) * 4;
  };
  return launch(flash_bwd_dkv_f32_kernel<DMAX>, dim3(p.Tk / 64, p.K, p.B),
                256, bytes(p.D), bytes(DMAX), ready, p, stream);
}

// bf16 takes 128-row and 128-key work tiles, f32 64-row ones
bool bad_args(int dtype, int B, int H, int K, int Tq, int Tk, int D) {
  const int tile = dtype == 1 ? 128 : 64;
  return B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Tq <= 0 || Tk <= 0 ||
         Tq % tile != 0 || Tk % tile != 0 || D < 8 || D % 8 != 0 ||
         D > 256 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" int singa_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int dtype, int B, int H, int K, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    long long sdqb, long long sdqt, long long sdqh,
    float scale, int causal, int window, void* count, void* stream) {
  if (bad_args(dtype, B, H, K, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), dq, nullptr, nullptr,
           B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           sdqb, sdqt, sdqh, 0, 0, 0,
           scale, causal, window, Tk - Tq,
           static_cast<unsigned long long*>(count)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return (int)launch_dq_wgmma<64>(p, s);
    if (D <= 128) return (int)launch_dq_wgmma<128>(p, s);
    return (int)launch_dq_mma256(p, s);
  }
  if (D <= 64) return (int)launch_dq_f32<64>(p, s);
  if (D <= 128) return (int)launch_dq_f32<128>(p, s);
  return (int)launch_dq_f32<256>(p, s);
}

extern "C" int singa_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int H, int K, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    long long sdkb, long long sdkt, long long sdkh,
    float scale, int causal, int window, void* count, void* stream) {
  if (bad_args(dtype, B, H, K, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), nullptr, dk, dv,
           B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           0, 0, 0, sdkb, sdkt, sdkh,
           scale, causal, window, Tk - Tq,
           static_cast<unsigned long long*>(count)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return (int)launch_dkv_wgmma<64>(p, s);
    if (D <= 128) return (int)launch_dkv_wgmma<128>(p, s);
    return (int)launch_dkv_mma256(p, s);
  }
  if (D <= 64) return (int)launch_dkv_f32<64>(p, s);
  if (D <= 128) return (int)launch_dkv_f32<128>(p, s);
  return (int)launch_dkv_f32<256>(p, s);
}
