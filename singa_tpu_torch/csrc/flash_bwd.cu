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
// h / (H / K).
//
// What bounds it: at the training shape (B=8, H=16, K=8, T=1024, D=128,
// bf16, causal) dQ does three products and dK/dV four over ~525k causal
// (q, k) pairs per head: ~52 and ~69 GFLOP against ~135 MB each, so
// tensor-core operations, not bytes.  The scores never reach device
// memory.
//
// dQ: one thread block per (b, h, 64-row q tile) walks the key tiles; the
// dQ accumulator stays in f32 registers.  dK/dV: one block per (b, kv
// head, 64-key tile) walks the G query heads of its group and their
// 32-row q tiles; dK and dV stay in f32 registers and are written once,
// already summed over the group, in (B, Tk, K, D) -- deterministic, no
// atomics.  (The Pallas kernel writes one (B, H, Tk, D) share per query
// head, rounded to the input dtype, and sums the group afterwards; here
// the sum is rounded once.)  bf16 runs QK^T, dO V^T and the three
// accumulating products on mma.sync m16n8k16 with f32 accumulation, with
// P and dS rounded to bf16 as their A operand; f32 runs plain-FMA
// kernels.  The head dim is zero-padded in shared memory to a compiled
// width (32, 64, 128 or 256).  At width 256 the dQ key tile is 32 keys
// and each dK/dV key row is shared by two warps that own one half of the
// output columns each (both recompute the scores), so the f32
// accumulators fit the register file.  TMA, wgmma and pipelining are
// later work.
//
// Inputs are read in the public (B, T, H, D) layout through strides
// (elements); the head dim must be contiguous and rows 16-byte aligned
// (the Python wrapper checks).  lse and delta are contiguous (B, H, Tq)
// f32.  dq is written through its own strides, dk and dv through one
// shared set.  Tq and Tk must be multiples of 64.
//
// C entry points singa_flash_bwd_dq(...) and singa_flash_bwd_dkv(...)
// launch on the given stream and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: mma.sync tensor-core kernels
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
// f32: plain-FMA kernels (four lanes share each row)
// ---------------------------------------------------------------------------

// dQ: one block of 128 threads per (b, h, 32-row q tile), 64-key tiles.
template <int DMAX>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Params p) {
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

// Launch `kernel` on `grid` with `smem` bytes of dynamic shared memory.
// The limit is raised to `smem_max` once per kernel instance and device.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   size_t smem_max, bool (&ready)[kMaxDevices],
                   const Params& p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  constexpr int BN = DMAX > 128 ? 32 : 64;
  static bool ready[kMaxDevices];
  const size_t smem = (size_t)(2 * 64 + 2 * BN) * (DMAX + 8) * 2;
  return launch(flash_bwd_dq_bf16_kernel<DMAX, BN>, dim3(p.Tq / 64, p.H, p.B),
                128, smem, smem, ready, p, stream);
}

template <int DMAX>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  const size_t smem = (size_t)(2 * 64 + 2 * 32) * (DMAX + 8) * 2 + 2 * 32 * 4;
  return launch(flash_bwd_dkv_bf16_kernel<DMAX>, dim3(p.Tk / 64, p.K, p.B),
                DMAX > 128 ? 256 : 128, smem, smem, ready, p, stream);
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

bool bad_args(int dtype, int B, int H, int K, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Tq <= 0 || Tk <= 0 ||
         Tq % 64 != 0 || Tk % 64 != 0 || D < 8 || D % 8 != 0 || D > 256 ||
         (dtype != 0 && dtype != 1);
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
    float scale, int causal, int window, void* stream) {
  if (bad_args(dtype, B, H, K, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), dq, nullptr, nullptr,
           B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           sdqb, sdqt, sdqh, 0, 0, 0,
           scale, causal, window, Tk - Tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 32) return (int)launch_dq_bf16<32>(p, s);
    if (D <= 64) return (int)launch_dq_bf16<64>(p, s);
    if (D <= 128) return (int)launch_dq_bf16<128>(p, s);
    return (int)launch_dq_bf16<256>(p, s);
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
    float scale, int causal, int window, void* stream) {
  if (bad_args(dtype, B, H, K, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), nullptr, dk, dv,
           B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           0, 0, 0, sdkb, sdkt, sdkh,
           scale, causal, window, Tk - Tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 32) return (int)launch_dkv_bf16<32>(p, s);
    if (D <= 64) return (int)launch_dkv_bf16<64>(p, s);
    if (D <= 128) return (int)launch_dkv_bf16<128>(p, s);
    return (int)launch_dkv_bf16<256>(p, s);
  }
  if (D <= 64) return (int)launch_dkv_f32<64>(p, s);
  if (D <= 128) return (int)launch_dkv_f32<128>(p, s);
  return (int)launch_dkv_f32<256>(p, s);
}
