// Flash attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (launched by `_fwd`) of
// singa_tpu/ops/flash_attention.py.  Same function: online-softmax
// attention o = softmax(scale * Q K^T + mask) V and lse = m + log l, with
//   * causal masking bottom-right aligned: qpos + (Tk - Tq) >= kpos,
//   * an optional sliding window: kpos > qpos + (Tk - Tq) - W,
//   * fully masked and below-band K/V tiles skipped,
//   * GQA: query head h reads kv head h / (H / K), no replication,
//   * masked scores filled with -1e30, the denominator floored at 1e-30,
//     p cast to v's dtype before P V, everything else in f32.
//
// What bounds it: 4 D FLOP per visible (q, k) pair and head.  At the
// Llama training shape (B=8, H=16, K=8, T=1024, D=128, bf16, causal)
// that is 34.4 GFLOP against 101 MB moved: 0.0348 ms at the H100's
// 989 TFLOP/s against 0.0302 ms at 3.35 TB/s; at the prefill shape
// (B=4) 0.0174 against 0.0151 ms.  Tensor-core operations bound it.
//
// bf16 design (flash_fwd_wgmma_kernel).  The work is cut into tiles of
// (b, h, 128 q rows); one persistent block per SM walks its share of them,
// heaviest (latest, under causal masking) first, in snake order.  Against
// the points that held the PR 1 kernel (mma.sync) to 7% of its bound:
//   1. loads: one producer thread issues TMA loads through 4-D tensor maps
//      over the public (B, T, H, D) layout (encoded on the host from the
//      strides, so no copies): Q once per work tile, K and V tiles into a
//      ring (4 / 3 / 2 stages at D = 64 / 128 / 256), each stage with a
//      "full" mbarrier (TMA transaction bytes) and an "empty" one the
//      consumers arrive on.  No __syncthreads in the loop; tiles i + 1 and
//      on load while tile i is computed, and the ring runs on into the
//      next work tile, whose Q loads once this one's last S has read Q.
//      Widths that are not a multiple of 64 (D = 40) are padded with zeros
//      by TMA's out-of-bounds fill.
//   2. products: two consumer warpgroups of 64 q rows each run wgmma
//      (m64nNk16, f32 accumulation).  S = Q K^T reads both operands from
//      shared memory, both K-major; O += P V reads P from registers (bf16)
//      and V keys-major through the transpose bit.  The warpgroups take
//      turns to issue (named barriers), so one's softmax runs under the
//      other's products, and each issues tile i's S together with tile
//      i - 1's P V, so its own softmax of tile i runs under that P V.
//   3. fragments: the 128-byte swizzle that TMA writes is the layout the
//      wgmma descriptors read; no fragment is gathered from shared memory
//      by hand and no bank conflicts arise.  The producer warpgroup drops
//      to 24 registers (setmaxnreg.dec), the consumers rise to 240; the
//      roles split in one if / else that never reconverges.
//   4. softmax in the exp2 domain: scale * log2 e is folded into the one
//      FFMA that forms each exponent, p = 2^(s c2 - m c2), on the MUFU's
//      ex2 without denormals; lse = (m c2 + log2 l) ln 2; the mask is
//      evaluated only on tiles that cross the causal diagonal or the
//      window's lower edge, as two integer bounds a row.  o is scaled by
//      1 / l, written to shared memory in the swizzle and stored by TMA.
//   5. tiles: 128 q rows by 128 keys (64 keys at D = 256, where the
//      accumulator alone is 128 registers a thread), so each K/V tile read
//      serves 128 rows.  The two heads of a GQA group are not packed into
//      one block: they are neighbouring work tiles, run side by side, and
//      read the same K/V tiles from the 50 MB L2.
// The head dim is padded to a compiled width of 64, 128 or 256.
//
// f32 (flash_fwd_f32_kernel): 64 q rows by 64 keys in plain FMA, four
// lanes per q row, K/V staged through shared memory.
//
// Inputs are read in the public (B, T, H, D) layout through strides
// (elements); the head dim must be contiguous and rows 16-byte aligned
// (the Python wrapper checks).  o is written through its own strides
// (a tensor map for the bf16 kernel), lse as a contiguous (B, H, Tq) f32
// array.  Tq and Tk must be multiples
// of 128.
//
// C entry point: singa_flash_fwd(...) launches on the given stream and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take).  Each launch that runs adds one to the device counter
// `count` points at (see hopper::count_launch), also when it is replayed
// from a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;  // q rows per block of the f32 kernel
constexpr int kBN = 64;  // keys per K/V tile of the f32 kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, K, Tq, Tk, D;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  float scale;
  int causal;
  int window;  // <= 0: no window
  int off;     // Tk - Tq
  unsigned long long* count;  // launches that ran (null: not counted)
};

// The Pallas kernel's tile-skip predicates (flash_attention.py:73-78) for
// `rows` queries from q0 against `keys` keys from k0.
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0,
                                          int rows = kBM, int keys = kBN) {
  bool live = true;
  if (p.causal) live = (q0 + rows - 1 + p.off) >= k0;
  if (p.window > 0) live = live && (k0 + keys - 1 > q0 + p.off - p.window);
  return live;
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  const int qpos = qi + p.off;
  bool ok = true;
  if (p.causal) ok = qpos >= kj;
  if (p.window > 0) ok = ok && (kj > qpos - p.window);
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed, warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

template <int DP>
struct FwdTile {
  static constexpr int kRows = 128;                   // q rows per work tile
  static constexpr int kKeys = DP == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 3 : 2;  // ring
  static constexpr int kSlabs = DP / 64;              // 128-byte column slabs
  static constexpr int kQBytes = kRows * DP * 2;
  static constexpr int kTileBytes = kKeys * DP * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer 2
  // Q, the ring, 2 + 2 kStages mbarriers, slack to align to 1024 bytes
  static constexpr int kSmem = kQBytes + kStages * kStageBytes +
                               8 * (2 + 2 * kStages) + 1024;
  static_assert(kStageBytes >= kQBytes, "o is staged in one ring stage");
};

// A work tile: 128 q rows of one (b, h) and its run [n0, n1) of live K/V
// tiles.  Tiles are numbered heaviest (latest q rows) first, heads
// fastest, so the blocks of one GQA group run side by side.
struct Work {
  int b, h, q0, n0, n1;
};

template <int DP>
__device__ __forceinline__ Work work_tile(const Params& p, int w) {
  using T = FwdTile<DP>;
  Work t;
  const int per_qt = p.H * p.B;
  t.q0 = (p.Tq / T::kRows - 1 - w / per_qt) * T::kRows;
  t.h = w % per_qt % p.H;
  t.b = w % per_qt / p.H;
  t.n0 = t.n1 = 0;
  for (int n = p.Tk / T::kKeys - 1; n >= 0; --n) {
    if (tile_live(p, t.q0, n * T::kKeys, T::kRows, T::kKeys)) {
      t.n0 = n;
      if (t.n1 == 0) t.n1 = n + 1;
    }
  }
  return t;
}

// The r-th work tile of this block: rounds of gridDim.x tiles, walked in
// turn forwards and backwards (a snake), so every block gets a similar
// share of the heavy and the light tiles.
__device__ __forceinline__ int work_index(int r) {
  const int c = r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + c;
}

// One persistent block per SM walks its work tiles; the K/V ring runs on
// across them, so the next tile's Q and first K/V tiles load while this
// one finishes.
template <int DP>
__global__ void __launch_bounds__(384, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, const Params p) {
  using T = FwdTile<DP>;
  using namespace hopper;
  count_launch(p.count);
  constexpr int kS = T::kStages;
  constexpr int kTurn = 1;    // named barriers kTurn + wg: turns to issue
  constexpr int kStaged = 3;  // named barriers kStaged (+ 1 + wg): epilogue

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sQ + T::kQBytes;
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
      prefetch_tensor_map(&tk);
      prefetch_tensor_map(&tv);
      int it = 0;  // K/V tiles loaded so far
      for (int wi = 0; work_index(wi) < n_work; ++wi) {
        const Work t = work_tile<DP>(p, work_index(wi));
        const int kh = t.h / (p.H / p.K);
        if (wi > 0) mbar_wait(q_empty, (wi - 1) & 1);
        mbar_arrive_expect_tx(q_full, T::kQBytes);
        for (int c = 0; c < T::kSlabs; ++c)
          tma_load_4d(sQ + c * T::kRows * 128, &tq, q_full, c * 64, t.q0,
                      t.h, t.b);
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
    // issue their products (named barriers kTurn + wg), so one's softmax
    // runs while the other's products keep the tensor cores busy; within
    // a warpgroup, tile i's softmax runs while tile i - 1's P V is in
    // flight.
    setmaxnreg_inc<240>();
    const int wg = warp / 4;
    const int g = lane / 4, tig = lane % 4;
    const int rw = (warp % 4) * 16 + g;  // this lane's rows rw, rw + 8 of 64
    const float c2 = p.scale * 1.4426950408889634f;  // scale * log2 e
    const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's Q rows

    float o[DP / 2];
    uint32_t pa[T::kKeys / 16][4];  // the last tile's P in bf16, 16 keys a row

    // O += P V for the tile in ring stage `stage`: P is the A operand in
    // registers, V keys-major in shared memory (the transpose bit)
    auto issue_pv = [&](int stage) {
      const uint32_t vt = ring + stage * T::kStageBytes + T::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk) {
        const uint32_t vk = vt + kk * 16 * 128;  // keys 16 kk .. 16 kk + 15
        wgmma_rs_tb(o, pa[kk], desc_mn_major(vk, T::kKeys * 128), 1);
      }
    };

    int it = 0;  // K/V tiles consumed so far
    for (int wi = 0; work_index(wi) < n_work; ++wi) {
      const Work t = work_tile<DP>(p, work_index(wi));
      const int q0 = t.q0, nt = t.n1 - t.n0;
      const int row0 = q0 + wg * 64 + rw;  // absolute rows row0, row0 + 8
      const int qpos_lo = q0 + wg * 64 + p.off;  // this warpgroup's first
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};  // running max of the unscaled scores
      float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

      mbar_wait(q_full, wi & 1);
      if (wg == 1 && nt > 0) bar_arrive(kTurn, 256);  // warpgroup 0 first
      for (int i = 0; i < nt; ++i) {
        const int stage = (it + i) % kS;
        const int k0 = (t.n0 + i) * T::kKeys;
        const uint32_t kt = ring + stage * T::kStageBytes;
        mbar_wait(full0 + 8 * stage, ((it + i) / kS) & 1);

        // issue S = Q K^T (64 rows x kKeys keys), then the last tile's P V
        float s[T::kKeys / 2];
        bar_sync(kTurn + wg, 256);
        fence_regs(s);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t slab = kk / 4, col = (kk % 4) * 32;
          wgmma_ss(s, desc_k_major(qa + slab * T::kRows * 128 + col),
                   desc_k_major(kt + slab * T::kKeys * 128 + col), kk > 0);
        }
        wgmma_commit();
        if (i > 0) issue_pv((it + i - 1) % kS);
        wgmma_commit();  // an empty group on the first tile
        bar_arrive(kTurn + (wg ^ 1), 256);
        wgmma_wait<1>();  // S is done; P V may still run
        fence_regs(s);
        if (i == nt - 1 && lane == 0) mbar_arrive(q_empty);  // Q read

        // the mask only where the tile crosses the causal diagonal or the
        // window's lower edge for these 64 rows; scores stay unscaled
        // until the exponent, p = 2^(s c2 - m c2), one FFMA each
        const bool edge =
            (p.causal && k0 + T::kKeys - 1 > qpos_lo) ||
            (p.window > 0 && k0 <= qpos_lo + 63 - p.window);
        if (edge) {
          // visible(): key k0 + 2 tig + c is visible from row qi when
          // lo < c <= hi, c = 8 (j / 4) + j % 2 known at compile time
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
            if (c > hi[r] || c <= lo[r]) s[j] = kNegInf;
          }
        }
        float mt[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < T::kKeys / 2; ++j)
          mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], s[j]);
        float alpha[2], mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          const float m_new = fmaxf(m[r], mt[r]);
          alpha[r] = exp2_approx((m[r] - m_new) * c2);
          m[r] = m_new;
          // clamped: a row that has seen only masked keys gets p = 0, not
          // 2^(the rounding error of 1e30 c2)
          mc[r] = fmaxf(m_new, 0.5f * kNegInf) * c2;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < T::kKeys / 2; ++j) {
          s[j] = exp2_approx(fmaf(s[j], c2, -mc[(j >> 1) & 1]));
          l[(j >> 1) & 1] += s[j];
        }

        // the last tile's P V is done: free its stage, rescale O
        wgmma_wait<0>();
        fence_regs(o);
        if (i > 0 && lane == 0)
          mbar_arrive(empty0 + 8 * ((it + i - 1) % kS));
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
        for (int ks = 0; ks < T::kKeys / 16; ++ks) {
          pa[ks][0] = pack_bf16x2(s[8 * ks], s[8 * ks + 1]);
          pa[ks][1] = pack_bf16x2(s[8 * ks + 2], s[8 * ks + 3]);
          pa[ks][2] = pack_bf16x2(s[8 * ks + 4], s[8 * ks + 5]);
          pa[ks][3] = pack_bf16x2(s[8 * ks + 6], s[8 * ks + 7]);
        }
      }
      if (nt > 0) {  // the last tile's P V
        bar_sync(kTurn + wg, 256);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
        issue_pv((it + nt - 1) % kS);
        wgmma_commit();
        if (wg == 0) bar_arrive(kTurn + 1, 256);
        wgmma_wait<0>();
        fence_regs(o);
      }

      // epilogue: o = acc / max(l, 1e-30) (by its reciprocal), lse =
      // (m c2 + log2 max(l, 1e-30)) ln 2
      float lf[2], inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        lf[r] = fmaxf(sum, 1e-30f);
        inv[r] = 1.f / lf[r];
      }
      // o in bf16, in the 128-byte swizzle, into the last tile's ring stage
      // (Q when there was no tile), then one TMA store per 64-column slab
      // of this warpgroup's rows; the stage (or Q) is released once the
      // stores have read it.  o overwrites the stage's K once both
      // warpgroups' S are done (Q released), and at D = 256, where it
      // covers V too, once both P V are done.
      const uint32_t staged =
          nt > 0 ? ring + (it + nt - 1) % kS * T::kStageBytes : sQ;
      if constexpr (T::kQBytes > T::kTileBytes)
        bar_sync(kStaged, 256);
      else if (nt > 0)
        mbar_wait(q_empty, wi & 1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = wg * 64 + rw + 8 * r;
          st_shared_u32(staged + (j / 8) * T::kRows * 128 + rr * 128 +
                            ((j % 8) ^ (rr % 8)) * 16 + tig * 4,
                        pack_bf16x2(o[4 * j + 2 * r] * inv[r],
                                    o[4 * j + 2 * r + 1] * inv[r]));
        }
      }
      fence_proxy_async();
      bar_sync(kStaged + 1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        for (int c = 0; c < T::kSlabs; ++c)
          tma_store_4d(&to, staged + c * T::kRows * 128 + wg * 64 * 128,
                       c * 64, q0 + wg * 64, t.h, t.b);
        tma_store_wait();
        mbar_arrive_cnt(nt > 0 ? empty0 + 8 * ((it + nt - 1) % kS) : q_empty,
                        4);  // for the warpgroup's four warps
      }
      if (tig == 0) {
        float* lg = p.lse + ((long long)t.b * p.H + t.h) * p.Tq;
        lg[row0] = fmaf(m[0], c2, log2f(lf[0])) * 0.6931471805599453f;
        lg[row0 + 8] = fmaf(m[1], c2, log2f(lf[1])) * 0.6931471805599453f;
      }
      it += nt;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain-FMA kernel (256 threads; four lanes share each q row)
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const Params p) {
  hopper::count_launch(p.count);
  constexpr int NT = 256;
  constexpr int CPT = kBN / 4;   // score columns per lane
  constexpr int DPT = DMAX / 4;  // output columns per lane
  constexpr int LDP = kBN + 1;   // padded P row

  extern __shared__ float smf[];
  const int D = p.D, LD = D + 1;  // odd row stride: no bank conflicts
  float* Qs = smf;
  float* Ks = Qs + kBM * LD;
  float* Vs = Ks + kBN * LD;
  float* Ps = Vs + kBN * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBM;
  const int kh = h / (p.H / p.K);
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int row = q0 + r;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh +
                    q0 * p.sqt;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kh * p.svh;
  for (int i = threadIdx.x; i < kBM * D; i += NT)
    Qs[(i / D) * LD + i % D] = qg[(i / D) * p.sqt + i % D];

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBN) {
    if (!tile_live(p, q0, k0)) continue;
    __syncthreads();
    for (int i = threadIdx.x; i < kBN * D; i += NT) {
      const int kr = i / D, d = i % D;
      Ks[kr * LD + d] = kg[(k0 + kr) * p.skt + d];
      Vs[kr * LD + d] = vg[(k0 + kr) * p.svt + d];
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] += qv * Ks[(c4 + 4 * j) * LD + d];
    }
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float x = s[j] * p.scale;
      if (!visible(p, row, k0 + c4 + 4 * j)) x = kNegInf;
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    m = m_new;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pe = expf(s[j] - m);
      rsum += pe;
      Ps[r * LDP + c4 + 4 * j] = pe;
    }
    l = l * alpha + rsum;
    __syncwarp();  // a row's four lanes share one warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBN; ++c) {
      const float pv = Ps[r * LDP + c];
      const float* vr = Vs + c * LD + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        if (c4 + 4 * i < D) acc[i] += pv * vr[4 * i];
    }
    __syncwarp();
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float lf = fmaxf(l, 1e-30f);
  float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh + row * p.sot;
#pragma unroll
  for (int i = 0; i < DPT; ++i)
    if (c4 + 4 * i < D) og[c4 + 4 * i] = acc[i] / lf;
  if (c4 == 0) p.lse[((long long)b * p.H + h) * p.Tq + row] = m + logf(lf);
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

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using T = FwdTile<DP>;
  static bool ready[kMaxDevices];
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = hopper::tensor_map_4d(&tq, p.q, p.B, p.Tq, p.H, p.D,
                                          p.sqb, p.sqt, p.sqh, T::kRows);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&to, p.o, p.B, p.Tq, p.H, p.D, p.sob, p.sot,
                                p.soh, 64);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tk, p.k, p.B, p.Tk, p.K, p.D, p.skb, p.skt,
                                p.skh, T::kKeys);
  if (err == cudaSuccess)
    err = hopper::tensor_map_4d(&tv, p.v, p.B, p.Tk, p.K, p.D, p.svb, p.svt,
                                p.svh, T::kKeys);
  if (err == cudaSuccess)
    err = smem_limit_once(flash_fwd_wgmma_kernel<DP>, T::kSmem, ready);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_work = p.Tq / T::kRows * p.H * p.B;
  flash_fwd_wgmma_kernel<DP>
      <<<n_work < sms ? n_work : sms, T::kThreads, T::kSmem, stream>>>(
          tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto bytes = [](int d) {
    return ((size_t)(kBM + 2 * kBN) * (d + 1) + kBM * (kBN + 1)) * 4;
  };
  cudaError_t err =
      smem_limit_once(flash_fwd_f32_kernel<DMAX>, bytes(DMAX), ready);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Tq / kBM, p.H, p.B);
  flash_fwd_f32_kernel<DMAX><<<grid, 256, bytes(p.D), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int singa_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int K, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    float scale, int causal, int window, void* count, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Tq <= 0 || Tk <= 0 ||
      Tq % 128 != 0 || Tk % 128 != 0 || D < 8 || D % 8 != 0 || D > 256 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           scale, causal, window, Tk - Tq,
           static_cast<unsigned long long*>(count)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (D <= 64) err = launch_bf16<64>(p, s);
    else if (D <= 128) err = launch_bf16<128>(p, s);
    else err = launch_bf16<256>(p, s);
  } else {
    if (D <= 64) err = launch_f32<64>(p, s);
    else if (D <= 128) err = launch_f32<128>(p, s);
    else err = launch_f32<256>(p, s);
  }
  return (int)err;
}

