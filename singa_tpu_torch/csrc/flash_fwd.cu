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
// What bounds it: at the Llama prefill shape (B=4, H=16, K=8, T=1024,
// D=128, bf16, causal) ~17 GFLOP against ~51 MB, so tensor-core
// operations, not bytes.  Design: one thread block per (b, h, 64-row q
// tile); the TPU's sequential kv grid axis becomes a loop inside the
// block over 64-key K/V tiles staged in shared memory; the running max,
// denominator and output accumulator stay in registers, so the scores
// never reach device memory.  bf16 runs QK^T and P V on mma.sync
// m16n8k16 tensor-core instructions with f32 accumulation (four warps,
// sixteen q rows each); f32 runs a plain-FMA kernel.  The head dim is
// padded with zeros to a compiled width (32, 64, 128 or 256).  TMA,
// wgmma, warp specialisation and a pipelined K/V ring are later work.
//
// Inputs are read in the public (B, T, H, D) layout through strides
// (elements); the head dim must be contiguous and rows 16-byte aligned
// (the Python wrapper checks).  o is written through its own strides,
// lse as a contiguous (B, H, Tq) f32 array.  Tq and Tk must be multiples
// of 64 (the wrapper routes only multiples of 128 here).
//
// C entry point: singa_flash_fwd(...) launches on the given stream and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;  // q rows per block
constexpr int kBN = 64;  // keys per K/V tile

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
};

// The Pallas kernel's tile-skip predicates (flash_attention.py:73-78).
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0) {
  bool live = true;
  if (p.causal) live = (q0 + kBM - 1 + p.off) >= k0;
  if (p.window > 0) live = live && (k0 + kBN - 1 > q0 + p.off - p.window);
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
// bf16: mma.sync tensor-core kernel
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

template <int DMAX>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int NT = 128;
  constexpr int LDS = DMAX + 8;  // padded smem row (elements)
  constexpr int NDT = DMAX / 8;  // 8-wide output column tiles
  constexpr int NKS = DMAX / 16; // 16-deep k steps of Q K^T
  constexpr int NST = kBN / 8;   // 8-wide score column tiles
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBM * LDS;
  bf16* Vs = Ks + kBN * LDS;

  // heaviest (latest, under causal masking) q tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBM;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int D = p.D;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh +
                   q0 * p.sqt;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kh * p.svh;
  load_rows_bf16<DMAX, NT>(Qs, LDS, qg, p.sqt, kBM, D);

  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's denominator
  const int rw = warp * 16 + g;  // smem row of this lane's first row
  const int row0 = q0 + rw;      // absolute rows row0 and row0 + 8

  for (int k0 = 0; k0 < p.Tk; k0 += kBN) {
    if (!tile_live(p, q0, k0)) continue;  // uniform across the block
    __syncthreads();  // the previous tile's readers are done
    load_rows_bf16<DMAX, NT>(Ks, LDS, kg + k0 * p.skt, p.skt, kBN, D);
    load_rows_bf16<DMAX, NT>(Vs, LDS, vg + k0 * p.svt, p.svt, kBN, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks * 16 >= D) break;  // zero padding contributes nothing
      const int c = ks * 16 + tig * 2;
      const uint32_t a0 = ld_u32(Qs + rw * LDS + c);
      const uint32_t a1 = ld_u32(Qs + (rw + 8) * LDS + c);
      const uint32_t a2 = ld_u32(Qs + rw * LDS + c + 8);
      const uint32_t a3 = ld_u32(Qs + (rw + 8) * LDS + c + 8);
#pragma unroll
      for (int j = 0; j < NST; ++j) {
        const uint32_t b0 = ld_u32(Ks + (j * 8 + g) * LDS + c);
        const uint32_t b1 = ld_u32(Ks + (j * 8 + g) * LDS + c + 8);
        mma_16816(s[j], a0, a1, a2, a3, b0, b1);
      }
    }

    // scale, mask, running max (fragment element e: row + 8 * (e >= 2),
    // column j * 8 + tig * 2 + (e & 1))
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8;
        const int kj = k0 + j * 8 + tig * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (!visible(p, qi, kj)) x = kNegInf;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        rsum[e >> 1] += pe;
      }
    }
    l[0] = l[0] * alpha[0] + rsum[0];
    l[1] = l[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int i = 0; i < NDT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += P V: the score fragments of two adjacent 8-key tiles are the
    // A fragment of one 16-key step; B is read from V[key][d] in smem
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      const uint32_t a0 = pack_f32_bf16(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a1 = pack_f32_bf16(s[2 * ks][2], s[2 * ks][3]);
      const uint32_t a2 = pack_f32_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const uint32_t a3 = pack_f32_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const bf16* vrow = Vs + (ks * 16 + tig * 2) * LDS + g;
#pragma unroll
      for (int i = 0; i < NDT; ++i) {
        if (i * 8 >= D) break;
        const bf16* vp = vrow + i * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LDS]);
        const uint32_t b1 = pack_bf16(vp[8 * LDS], vp[9 * LDS]);
        mma_16816(acc[i], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // epilogue: o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  float lf[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    lf[r] = fmaxf(t, 1e-30f);
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    const int col = i * 8 + tig * 2;
    if (col >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = row0 + r * 8;
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[i][2 * r] / lf[r],
                                                 acc[i][2 * r + 1] / lf[r]);
      *reinterpret_cast<__nv_bfloat162*>(og + row * p.sot + col) = val;
    }
  }
  if (tig == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * p.Tq;
    lg[row0] = m[0] + logf(lf[0]);
    lg[row0 + 8] = m[1] + logf(lf[1]);
  }
}

// ---------------------------------------------------------------------------
// f32: plain-FMA kernel (256 threads; four lanes share each q row)
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const Params p) {
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

// Launch `kernel` with `smem` bytes of dynamic shared memory.  The limit
// is raised to `smem_max` once per kernel instance and device (`ready`
// holds one flag per device for the instance).
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, size_t smem_max,
                   bool (&ready)[kMaxDevices], const Params& p,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  dim3 grid(p.Tq / kBM, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  const size_t smem = (size_t)(kBM + 2 * kBN) * (DMAX + 8) * 2;
  return launch(flash_fwd_bf16_kernel<DMAX>, 128, smem, smem, ready, p,
                stream);
}

template <int DMAX>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto bytes = [](int d) {
    return ((size_t)(kBM + 2 * kBN) * (d + 1) + kBM * (kBN + 1)) * 4;
  };
  return launch(flash_fwd_f32_kernel<DMAX>, 256, bytes(p.D), bytes(DMAX),
                ready, p, stream);
}

}  // namespace

extern "C" int singa_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int K, int Tq, int Tk, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Tq <= 0 || Tk <= 0 ||
      Tq % kBM != 0 || Tk % kBN != 0 || D < 8 || D % 8 != 0 || D > 256 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, K, Tq, Tk, D,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           scale, causal, window, Tk - Tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (D <= 32) err = launch_bf16<32>(p, s);
    else if (D <= 64) err = launch_bf16<64>(p, s);
    else if (D <= 128) err = launch_bf16<128>(p, s);
    else err = launch_bf16<256>(p, s);
  } else {
    if (D <= 64) err = launch_f32<64>(p, s);
    else if (D <= 128) err = launch_f32<128>(p, s);
    else err = launch_f32<256>(p, s);
  }
  return (int)err;
}
