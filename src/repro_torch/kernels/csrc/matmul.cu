// Scheduled matmul with fused epilogue for Hopper (sm_90a), f32 or bf16.
//
// Replaces repro/kernels/matmul/kernel.py::matmul_pallas: out =
// epilogue(A @ B) for A (M,K), B (K,N) row-major, with bias -> activation
// -> bypass on writeback (no bypass_first here: the matmul epilogue has
// none).  The ragged edges of M, N and K are masked in the kernels, so the
// operands are never padded in device memory.  The element type T is
// float or __nv_bfloat16 for A, B, bias, bypass and out alike, as the
// reference writes out_dtype = a.dtype; the sum and the whole epilogue
// are f32, and the result is rounded to T once, on the store.
//
// Three paths; the wrapper (kernels/matmul/kernel.py::matmul_plan) picks
// one by (dtype, M, K, N, 16-byte alignment):
//
// skinny (M <= 64, K and N whole 16-byte vectors): the LM decode
//   projections (M = slots) and the CNN FC layers (M = batch).  A K x N
//   weight of 0.6-151 MB against M <= 64 rows is ~M FLOP per weight byte
//   in bf16, far under the card's ridge (~295): HBM bounds it, and the
//   design goal is that each weight byte crosses HBM once with enough
//   CTAs in flight to pull 3.35 TB/s.  A CTA owns 64 output columns and
//   one K slice: split-K over CTAs (the split count comes from the plan,
//   >= ~2 CTAs per SM on every served shape), B streamed through a
//   4-stage cp.async ring in 16-byte vectors (neighbouring threads on
//   neighbouring columns); only the slice of A sits in shared memory.
//   bf16 multiplies with mma.sync m16n8k16 (M zero-padded to 16,
//   ldmatrix.trans reads the row-major B tile, 128-byte rows XOR-swizzled
//   by 16-byte chunk against bank conflicts); f32 stays on SIMT FMAs (a
//   tensor-core f32 product would be TF32).  With one split the epilogue
//   is applied in the kernel; otherwise each split writes its f32 partial
//   sum to a workspace and splitk_reduce sums the slices in a fixed order
//   (no atomics, so results repeat bit for bit) and applies the epilogue.
//   The dataflow and block do not apply: every weight byte is read once
//   whatever the CTA order.
// wgmma (bf16, M > 64, K % 8 == 0, N % 8 == 0): the LM prefill and chunk
//   projections.  ~M/2 FLOP per byte at M >= 128 and N, K in the
//   thousands: the tensor cores bound it.  128 x 128 CTA tiles, K step 64,
//   a 4-stage ring filled by TMA (128-byte swizzle, out-of-bounds boxes
//   zero-filled) from one producer warp, completion on mbarriers; two
//   consumer warpgroups each issue wgmma m64n128k16 with A K-major and B
//   MN-major (the (K, N) weight as it lies, never transposed).  The
//   epilogue is fused in registers and the ragged edge masked on the
//   store.  The dataflow sets the CTA raster as in simt.
// B read transposed (bf16, the skinny and wgmma paths): B given as the
//   (N, K) row-major tensor whose transpose the product takes -- a tied
//   LM head, the (vocab, d_model) embedding -- read as it lies, never
//   copied.  Its rows are K whole 16-byte vectors, so N may be ragged
//   (whisper-base's 51,865): B rows past N load as zeros.  skinny: the B
//   tile is [64 n rows][64 k] (cp.async along K, the same XOR swizzle),
//   fed to mma.sync by ldmatrix without .trans.  wgmma: a TMA map over
//   the (N, K) tensor (boxes of 128 n rows x 64 k, clipped at N) and a
//   K-major B descriptor, laid out as A is.  With N odd, an output row
//   starts on an odd element, so every store that pairs two columns
//   (bf16x2 out and bypass, the f32x2 split-K partials, the f32x4 merge)
//   falls back to single elements, and the second column is bounded by
//   N.
// simt (everything else: f32 at M > 64, bf16 with K or N not a multiple
//   of 8): 16 rows x 32 columns per CTA over all of K, f32 FMAs from
//   shared memory with a register prefetch of the next 128-deep K slice.
//   The dataflow sets the CTA order, read as L2 locality: MAPS_RESIDENT
//   runs the N tiles of one M tile back to back, WEIGHTS_RESIDENT the M
//   tiles of one N tile, and OUTPUT_STATIONARY walks the schedule's
//   (bm, bn) blocks one at a time (the TPU's k-grid accumulator becomes a
//   loop inside the CTA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 16;
constexpr int BN = 32;
constexpr int BK = 128;
constexpr int AST = BM + 1;    // padded A tile row: conflict-free stores
constexpr int THREADS = 128;   // 32 columns x 4 row groups of 4
static_assert(BK == THREADS, "one A column per thread");

// Launcher errors that are not a cudaError_t.
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE = 10002;

template <typename T>
struct MatmulArgs {
  const T* a;
  const T* b;
  const T* bias;
  const T* bypass;
  T* out;
  int M, K, N;
  int n_mt, n_nt;
  int dataflow;  // 0 maps resident, 1 weights resident, 2 output stationary
  int gm, gn, n_bn;  // output-stationary block in tiles; blocks along N
  int act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:
      return fmaxf(v, 0.f);
    case 2:
      return v / (1.f + expf(-v));
    case 3: {
      float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    case 4:
      return tanhf(v);
    default:
      return v;
  }
}

// bias -> activation -> bypass on one f32 sum at (m, n).
template <typename T>
__device__ __forceinline__ float epilogue(float v, const T* bias,
                                          const T* bypass, int m, int n,
                                          int N, int act) {
  if (bias) v += to_f32(bias[n]);
  v = activate(v, act);
  if (bypass) v += to_f32(bypass[(size_t)m * N + n]);
  return v;
}

// CTA L -> (M tile, N tile) under the dataflow's raster; false for the
// padding CTAs of an output-stationary block past the edge.
__device__ __forceinline__ bool raster(int L, int dataflow, int n_mt,
                                       int n_nt, int gm, int gn, int n_bn,
                                       int& mt, int& nt) {
  if (dataflow == 0) {
    mt = L / n_nt;
    nt = L - mt * n_nt;
  } else if (dataflow == 1) {
    nt = L / n_mt;
    mt = L - nt * n_mt;
  } else {
    const int per = gm * gn;
    const int blk = L / per, in = L - blk * per;
    const int bi = blk / n_bn, bj = blk - bi * n_bn;
    mt = bi * gm + in / gn;
    nt = bj * gn + in % gn;
  }
  return mt < n_mt && nt < n_nt;
}

// --- simt: everything else --------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) matmul_kernel(MatmulArgs<T> p) {
  __shared__ float As[BK * AST];   // [BK][AST], k-major
  __shared__ float Bs[BK * BN];    // [BK][BN]

  int mt, nt;
  if (!raster(blockIdx.x, p.dataflow, p.n_mt, p.n_nt, p.gm, p.gn, p.n_bn, mt,
              nt))
    return;

  const int tid = threadIdx.x;
  const int tx = tid % BN, ty = tid / BN;
  const int m0 = mt * BM, n0 = nt * BN;
  // Loads: A column ak of the tile's BM rows (BK == THREADS), and B
  // elements (bk + 4q, bn).
  const int ak = tid;
  const int bn = tid % BN, bk = tid / BN;

  float ra[BM], rb[BK / 4];
  auto load = [&](int k0) {
    const int k = k0 + ak;
    for (int q = 0; q < BM; ++q) {
      const int m = m0 + q;
      ra[q] = (k < p.K && m < p.M) ? to_f32(p.a[(size_t)m * p.K + k]) : 0.f;
    }
    const int n = n0 + bn;
    for (int q = 0; q < BK / 4; ++q) {
      const int kk = k0 + bk + 4 * q;
      rb[q] = (kk < p.K && n < p.N) ? to_f32(p.b[(size_t)kk * p.N + n]) : 0.f;
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int nk = (p.K + BK - 1) / BK;
  load(0);
  for (int it = 0; it < nk; ++it) {
    for (int q = 0; q < BM; ++q) As[ak * AST + q] = ra[q];
    for (int q = 0; q < BK / 4; ++q) Bs[(bk + 4 * q) * BN + bn] = rb[q];
    __syncthreads();
    if (it + 1 < nk) load((it + 1) * BK);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float bv = Bs[k * BN + tx];
      for (int i = 0; i < 4; ++i) acc[i] += As[k * AST + ty * 4 + i] * bv;
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= p.N) return;
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
    float v = acc[i];
    if (p.bias) v += to_f32(p.bias[n]);
    v = activate(v, p.act);
    const size_t o = (size_t)m * p.N + n;
    if (p.bypass) v += to_f32(p.bypass[o]);
    p.out[o] = from_f32<T>(v);
  }
}

// --- skinny: M <= 64, split-K ------------------------------------------------
constexpr int SK_BN = 64;        // output columns per CTA
constexpr int SK_THREADS = 128;
constexpr int SK_STAGES = 4;
constexpr int SK_BK16 = 64;      // K rows a stage, bf16 (128-byte rows)
constexpr int SK_BK32 = 32;      // K rows a stage, f32

template <typename T>
struct SkinnyArgs {
  const T* a;
  const T* b;
  const T* bias;
  const T* bypass;
  T* out;
  float* ws;  // (splits, M, N) f32 partial sums; unused with one split
  int M, K, N;
  int kchunk;  // K rows a split; split s covers [s kchunk, (s+1) kchunk)
  int splits;
  int act;
};

// One f32 pair (m, n), (m, n + 1) of a CTA's sum: the output through the
// epilogue with one split, else the split's partial into the workspace.
// n < N is even; with N odd the pair may end past N and a row starts on
// an odd element, so the workspace takes single floats.
template <typename T>
__device__ __forceinline__ void skinny_store(const SkinnyArgs<T>& p, int m,
                                             int n, float v0, float v1) {
  const bool second = n + 1 < p.N;
  if (p.splits == 1) {
    const size_t o = (size_t)m * p.N + n;
    p.out[o] = from_f32<T>(epilogue(v0, p.bias, p.bypass, m, n, p.N, p.act));
    if (second)
      p.out[o + 1] =
          from_f32<T>(epilogue(v1, p.bias, p.bypass, m, n + 1, p.N, p.act));
  } else {
    float* w = p.ws + ((size_t)blockIdx.z * p.M + m) * p.N + n;
    if ((p.N & 1) == 0) {
      *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
    } else {
      w[0] = v0;
      if (second) w[1] = v1;
    }
  }
}

// bf16: grid (1, ceil(N / 64), splits); MT = 16 x MTILES >= M rows.  Warp
// w owns columns [16 w, 16 w + 16) of the CTA's 64 as two n8 mma tiles.
// BT: B is the (N, K) tensor, its tile [64 n rows][64 k].
template <int MTILES, bool BT>
__global__ void __launch_bounds__(SK_THREADS)
    skinny_bf16_kernel(SkinnyArgs<bf16> p) {
  constexpr int MT = 16 * MTILES;
  constexpr int A_EL = MT * SK_BK16, B_EL = SK_BK16 * SK_BN;
  extern __shared__ __align__(128) unsigned char smem_b16[];
  bf16* sA = reinterpret_cast<bf16*>(smem_b16);
  bf16* sB = sA + SK_STAGES * A_EL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * SK_BN;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int nk = (kend - kbeg + SK_BK16 - 1) / SK_BK16;

  // 16-byte chunk c of a 128-byte row r lands at chunk c ^ (r % 8).
  auto load = [&](int stage, int k0) {
    bf16* dB = sB + stage * B_EL;
#pragma unroll
    for (int i = 0; i < SK_BK16 * SK_BN / 8 / SK_THREADS; ++i) {
      const int q = tid + i * SK_THREADS;
      const int r = q >> 3, c = q & 7;
      if (BT) {  // row r: column n0 + r of the product, K along the row
        const int k = k0 + c * 8, n = n0 + r;
        const bool ok = k < kend && n < p.N;
        cp_async16(dB + r * SK_BK16 + ((c ^ (r & 7)) << 3),
                   ok ? p.b + (size_t)n * p.K + k : p.b, ok);
      } else {
        const int k = k0 + r, n = n0 + c * 8;
        const bool ok = k < kend && n < p.N;
        cp_async16(dB + r * SK_BN + ((c ^ (r & 7)) << 3),
                   ok ? p.b + (size_t)k * p.N + n : p.b, ok);
      }
    }
    bf16* dA = sA + stage * A_EL;
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {  // MT x 8 chunks, one a thread each
      const int q = tid + i * SK_THREADS;
      const int r = q >> 3, c = q & 7;
      const int k = k0 + c * 8;
      const bool ok = r < p.M && k < kend;
      cp_async16(dA + r * SK_BK16 + ((c ^ (r & 7)) << 3),
                 ok ? p.a + (size_t)r * p.K + k : p.a, ok);
    }
  };

  float acc[MTILES][2][4];
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s, kbeg + s * SK_BK16);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    const int nxt = it + SK_STAGES - 1;
    if (nxt < nk) load(nxt % SK_STAGES, kbeg + nxt * SK_BK16);
    cp_async_commit();
    const bf16* cA = sA + (it % SK_STAGES) * A_EL;
    const bf16* cB = sB + (it % SK_STAGES) * B_EL;
#pragma unroll
    for (int kk = 0; kk < SK_BK16 / 16; ++kk) {
      // B: matrices (k lo, n lo), (k hi, n lo), (k lo, n hi), (k hi, n hi)
      // of the warp's 16 x 16 block, transposed into mma col fragments.
      uint32_t bfr[4];
      if (BT) {
        // The same four matrices from the [n][k] tile: rows are n, so
        // ldmatrix without .trans gives the col fragments.
        const int mi = lane >> 3, r = lane & 7;
        const int nrow = warp * 16 + ((mi >> 1) << 3) + r;
        const int ch = kk * 2 + (mi & 1);
        ldmatrix_x4(bfr, cB + nrow * SK_BK16 + ((ch ^ (nrow & 7)) << 3));
      } else {
        const int mi = lane >> 3, r = lane & 7;
        const int krow = kk * 16 + ((mi & 1) << 3) + r;
        const int ch = warp * 2 + (mi >> 1);
        ldmatrix_x4_trans(bfr, cB + krow * SK_BN + ((ch ^ (krow & 7)) << 3));
      }
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        uint32_t afr[4];
        const int row = mt * 16 + (lane & 15);
        const int ch = kk * 2 + (lane >> 4);
        ldmatrix_x4(afr, cA + row * SK_BK16 + ((ch ^ (row & 7)) << 3));
        mma_bf16_16816(acc[mt][0], afr, bfr[0], bfr[1]);
        mma_bf16_16816(acc[mt][1], afr, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        const int n = n0 + warp * 16 + j * 8 + 2 * t;
        if (m < p.M && n < p.N)
          skinny_store(p, m, n, acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
}

// f32: grid (ceil(M / MT), ceil(N / 64), splits).  Thread (cq, kg) =
// (tid % 16, tid / 16) owns columns [4 cq, 4 cq + 4) and the stage's K
// rows [4 kg, 4 kg + 4) for all MT rows; the 8 K groups are summed in
// shared memory in a fixed order at the end.
template <int MT>
__global__ void __launch_bounds__(SK_THREADS)
    skinny_f32_kernel(SkinnyArgs<float> p) {
  constexpr int A_EL = MT * SK_BK32, B_EL = SK_BK32 * SK_BN;
  constexpr int KG = SK_THREADS / 16;
  static_assert(KG * 4 == SK_BK32, "8 K groups of 4 rows a stage");
  static_assert(KG * MT * SK_BN <= SK_STAGES * (A_EL + B_EL),
                "the K-group sums fit in the ring");
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* sA = reinterpret_cast<float*>(smem_f32);
  float* sB = sA + SK_STAGES * A_EL;
  const int tid = threadIdx.x, cq = tid & 15, kg = tid >> 4;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * SK_BN;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int nk = (kend - kbeg + SK_BK32 - 1) / SK_BK32;

  auto load = [&](int stage, int k0) {
    float* dB = sB + stage * B_EL;
#pragma unroll
    for (int i = 0; i < SK_BK32 * SK_BN / 4 / SK_THREADS; ++i) {
      const int q = tid + i * SK_THREADS;
      const int r = q >> 4, c = q & 15;
      const int k = k0 + r, n = n0 + c * 4;
      const bool ok = k < kend && n < p.N;
      cp_async16(dB + r * SK_BN + c * 4,
                 ok ? p.b + (size_t)k * p.N + n : p.b, ok);
    }
    if (tid < MT * SK_BK32 / 4) {
      const int r = tid >> 3, c = tid & 7;
      const int m = m0 + r, k = k0 + c * 4;
      const bool ok = m < p.M && k < kend;
      cp_async16(sA + stage * A_EL + r * SK_BK32 + c * 4,
                 ok ? p.a + (size_t)m * p.K + k : p.a, ok);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[m][v] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s, kbeg + s * SK_BK32);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    const int nxt = it + SK_STAGES - 1;
    if (nxt < nk) load(nxt % SK_STAGES, kbeg + nxt * SK_BK32);
    cp_async_commit();
    const float* cA = sA + (it % SK_STAGES) * A_EL;
    const float* cB = sB + (it % SK_STAGES) * B_EL;
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(cB + (4 * kg + j) * SK_BN +
                                               4 * cq);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 av =
          *reinterpret_cast<const float4*>(cA + m * SK_BK32 + 4 * kg);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[m][0] += a4[j] * bv[j].x;
        acc[m][1] += a4[j] * bv[j].y;
        acc[m][2] += a4[j] * bv[j].z;
        acc[m][3] += a4[j] * bv[j].w;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: reuse it

  float* red = reinterpret_cast<float*>(smem_f32);  // [KG][MT][SK_BN]
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(red + (kg * MT + m) * SK_BN + 4 * cq) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int e = 2 * tid; e < MT * SK_BN; e += 2 * SK_THREADS) {
    const int r = e / SK_BN, col = e % SK_BN;
    const int m = m0 + r, n = n0 + col;
    if (m >= p.M || n >= p.N) continue;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      v0 += red[(q * MT + r) * SK_BN + col];
      v1 += red[(q * MT + r) * SK_BN + col + 1];
    }
    skinny_store(p, m, n, v0, v1);
  }
}

// The split-K epilogue: out = epilogue(sum over s of ws[s]), the slices
// summed in order s = 0, 1, ...; one thread per 4 consecutive columns.
template <typename T>
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* ws, const T* bias, const T* bypass,
                         T* out, int M, int N, int splits, int act) {
  const size_t quads = (size_t)M * N / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 s = w4[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = w4[(size_t)sp * quads + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const size_t e = 4 * i;
  const int m = (int)(e / N), n = (int)(e % N);
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[e + j] = from_f32<T>(epilogue(v[j], bias, bypass, m, n + j, N, act));
}

// The same merge one element a thread, for N not a multiple of 4 (a
// ragged N read transposed): the slices summed in the same order.
template <typename T>
__global__ void __launch_bounds__(256)
    splitk_reduce_scalar_kernel(const float* ws, const T* bias,
                                const T* bypass, T* out, int M, int N,
                                int splits, int act) {
  const size_t total = (size_t)M * N;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = ws[e];
  for (int sp = 1; sp < splits; ++sp) s += ws[(size_t)sp * total + e];
  const int m = (int)(e / N), n = (int)(e % N);
  out[e] = from_f32<T>(epilogue(s, bias, bypass, m, n, N, act));
}

// --- wgmma: bf16, M > 64 -----------------------------------------------------
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                       // warpgroups, 64 rows each
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // + one producer warp
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;        // [128 rows][64 k]
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;        // 2 x [64 k][64 n]
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;

struct WgmmaArgs {
  const bf16* bias;
  const bf16* bypass;
  bf16* out;
  int M, K, N;
  int n_mt, n_nt, dataflow, gm, gn, n_bn;
  int act;
};

// BT: tma_b maps the (N, K) tensor; a stage's B tile is [128 n rows][64 k]
// and K-major, laid out as A's.
template <bool BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      WgmmaArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  // 128-byte swizzled tiles start on a 1024-byte boundary.
  unsigned char* smem =
      smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + WG_STAGES * WG_A_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;

  int mt, nt;
  if (!raster(blockIdx.x, p.dataflow, p.n_mt, p.n_nt, p.gm, p.gn, p.n_bn, mt,
              nt))
    return;
  const int m0 = mt * WG_BM, n0 = nt * WG_BN;
  const int nk = (p.K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG_CONSUMERS) {
    // Producer: one thread keeps up to WG_STAGES k-blocks in flight.
    if (threadIdx.x == WG_CONSUMERS * 128) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % WG_STAGES;
        if (it >= WG_STAGES) mbar_wait(&empty[s], ((it / WG_STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], WG_STAGE_BYTES);
        bf16* b_dst = sB + s * (WG_BK * WG_BN);
        tma_load_2d(sA + s * (WG_BM * WG_BK), &tma_a, &full[s], it * WG_BK,
                    m0);
        if (BT) {
          tma_load_2d(b_dst, &tma_b, &full[s], it * WG_BK, n0);
        } else {
          tma_load_2d(b_dst, &tma_b, &full[s], n0, it * WG_BK);
          tma_load_2d(b_dst + WG_BK * 64, &tma_b, &full[s], n0 + 64,
                      it * WG_BK);
        }
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % WG_STAGES;
    mbar_wait(&full[s], (it / WG_STAGES) & 1);
    const bf16* a_t = sA + s * (WG_BM * WG_BK) + wg * 64 * WG_BK;
    const bf16* b_t = sB + s * (WG_BK * WG_BN);
    fence_operands<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: K-major, the k step 32 bytes into each swizzled 128-byte row.
      // B: MN-major, the k step 16 rows on; its two 64-column halves lie
      // WG_BK x 128 bytes apart.
      // BT: B K-major as A, its 128 n rows 128 bytes each.
      const uint64_t da = wgmma_desc_sw128(a_t + kk * 16, 16, 1024);
      if (BT) {
        const uint64_t db = wgmma_desc_sw128(b_t + kk * 16, 16, 1024);
        wgmma_m64n128k16_bf16<0>(acc, da, db);
      } else {
        const uint64_t db = wgmma_desc_sw128(b_t + kk * 16 * 64,
                                             WG_BK * 128, 1024);
        wgmma_m64n128k16_bf16_tb(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<64>(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  if (p.N & 1) {
    // A ragged odd N (read transposed): rows start on odd elements, so
    // single-element loads and stores, the second column bounded by N.
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col0 + 8 * j + e;
        if (n >= p.N) continue;
        const float b = p.bias ? __bfloat162float(p.bias[n]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (m >= p.M) continue;
          float v = activate(acc[4 * j + 2 * h + e] + b, p.act);
          const size_t o = (size_t)m * p.N + n;
          if (p.bypass) v += __bfloat162float(p.bypass[o]);
          p.out[o] = __float2bfloat16(v);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j) {
    const int n = col0 + 8 * j;
    if (n >= p.N) continue;  // N is even, so n + 1 < N too
    float b0 = 0.f, b1 = 0.f;
    if (p.bias) {
      b0 = __bfloat162float(p.bias[n]);
      b1 = __bfloat162float(p.bias[n + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= p.M) continue;
      float v0 = activate(acc[4 * j + 2 * h] + b0, p.act);
      float v1 = activate(acc[4 * j + 2 * h + 1] + b1, p.act);
      const size_t o = (size_t)m * p.N + n;
      if (p.bypass) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(p.bypass + o);
        v0 += __low2float(r);
        v1 += __high2float(r);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.out + o) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// --- launchers ---------------------------------------------------------------
// Output-stationary blocks in tiles of (tm, tn); returns the CTA count of
// the raster and fills the tile counts and block shape.
template <typename A>
long long raster_args(A& p, int M, int N, int tm, int tn, int dataflow,
                      int bm, int bn) {
  p.n_mt = (M + tm - 1) / tm;
  p.n_nt = (N + tn - 1) / tn;
  p.dataflow = dataflow;
  p.gm = (bm + tm - 1) / tm;
  p.gn = (bn + tn - 1) / tn;
  if (p.gm < 1) p.gm = 1;
  if (p.gn < 1) p.gn = 1;
  p.n_bn = (p.n_nt + p.gn - 1) / p.gn;
  if (dataflow == 2) {
    const long long n_bm = (p.n_mt + p.gm - 1) / p.gm;
    return n_bm * p.n_bn * p.gm * p.gn;
  }
  return (long long)p.n_mt * p.n_nt;
}

template <typename T>
int launch_simt(const T* a, const T* b, const T* bias, const T* bypass,
                T* out, int M, int K, int N, int dataflow, int bm, int bn,
                int act, void* stream) {
  MatmulArgs<T> p;
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.bypass = bypass;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.act = act;
  const long long n_cta = raster_args(p, M, N, BM, BN, dataflow, bm, bn);
  matmul_kernel<T><<<(unsigned)n_cta, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_reduce(const SkinnyArgs<T>& p, cudaStream_t st) {
  if (p.splits == 1) return 0;
  if (p.N % 4) {
    const long long total = (long long)p.M * p.N;
    splitk_reduce_scalar_kernel<T>
        <<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
            p.ws, p.bias, p.bypass, p.out, p.M, p.N, p.splits, p.act);
    return (int)cudaGetLastError();
  }
  const long long quads = (long long)p.M * p.N / 4;
  splitk_reduce_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      p.ws, p.bias, p.bypass, p.out, p.M, p.N, p.splits, p.act);
  return (int)cudaGetLastError();
}

template <int MTILES, bool BT>
int launch_skinny_bf16(const SkinnyArgs<bf16>& p, cudaStream_t st) {
  constexpr int smem =
      SK_STAGES * (16 * MTILES * SK_BK16 + SK_BK16 * SK_BN) * 2;
  static int attr = set_smem(skinny_bf16_kernel<MTILES, BT>, smem);
  if (attr) return attr;
  const dim3 grid(1, (p.N + SK_BN - 1) / SK_BN, p.splits);
  skinny_bf16_kernel<MTILES, BT><<<grid, SK_THREADS, smem, st>>>(p);
  const int err = (int)cudaGetLastError();
  return err ? err : launch_reduce(p, st);
}

template <int MT>
int launch_skinny_f32(const SkinnyArgs<float>& p, cudaStream_t st) {
  constexpr int smem = SK_STAGES * (MT * SK_BK32 + SK_BK32 * SK_BN) * 4;
  static int attr = set_smem(skinny_f32_kernel<MT>, smem);
  if (attr) return attr;
  const dim3 grid((p.M + MT - 1) / MT, (p.N + SK_BN - 1) / SK_BN, p.splits);
  skinny_f32_kernel<MT><<<grid, SK_THREADS, smem, st>>>(p);
  const int err = (int)cudaGetLastError();
  return err ? err : launch_reduce(p, st);
}

template <typename T>
SkinnyArgs<T> skinny_args(const T* a, const T* b, const T* bias,
                          const T* bypass, T* out, float* ws, int M, int K,
                          int N, int kchunk, int splits, int act) {
  SkinnyArgs<T> p;
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.bypass = bypass;
  p.out = out;
  p.ws = ws;
  p.M = M;
  p.K = K;
  p.N = N;
  p.kchunk = kchunk;
  p.splits = splits;
  p.act = act;
  return p;
}

template <bool BT>
int skinny_bf16(const bf16* a, const bf16* b, const bf16* bias,
                const bf16* bypass, bf16* out, float* ws, int M, int K, int N,
                int kchunk, int splits, int act, void* stream) {
  const SkinnyArgs<bf16> p =
      skinny_args(a, b, bias, bypass, out, ws, M, K, N, kchunk, splits, act);
  cudaStream_t st = (cudaStream_t)stream;
  switch ((M + 15) / 16) {
    case 0:
    case 1:
      return launch_skinny_bf16<1, BT>(p, st);
    case 2:
      return launch_skinny_bf16<2, BT>(p, st);
    case 3:
      return launch_skinny_bf16<3, BT>(p, st);
    default:
      return launch_skinny_bf16<4, BT>(p, st);
  }
}

template <bool BT>
int wgmma_bf16(const bf16* a, const bf16* b, const bf16* bias,
               const bf16* bypass, bf16* out, int M, int K, int N,
               int dataflow, int bm, int bn, int act, void* stream) {
  static int attr = set_smem(wgmma_bf16_kernel<BT>, WG_SMEM);
  if (attr) return attr;
  if (tensor_map_encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap ta, tb;
  const bool mapped =
      encode_bf16_2d(&ta, a, M, K, WG_BM, WG_BK) &&
      (BT ? encode_bf16_2d(&tb, b, N, K, WG_BN, WG_BK)
          : encode_bf16_2d(&tb, b, K, N, WG_BK, 64));
  if (!mapped) return ERR_ENCODE;
  WgmmaArgs p;
  p.bias = bias;
  p.bypass = bypass;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.act = act;
  const long long n_cta =
      raster_args(p, M, N, WG_BM, WG_BN, dataflow, bm, bn);
  wgmma_bf16_kernel<BT><<<(unsigned)n_cta, WG_THREADS, WG_SMEM,
                          (cudaStream_t)stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// simt: the plan's "simt" path (any shape).
int matmul_f32(const float* a, const float* b, const float* bias,
               const float* bypass, float* out, int M, int K, int N,
               int dataflow, int bm, int bn, int act, void* stream) {
  return launch_simt(a, b, bias, bypass, out, M, K, N, dataflow, bm, bn, act,
                     stream);
}

int matmul_bf16(const bf16* a, const bf16* b, const bf16* bias,
                const bf16* bypass, bf16* out, int M, int K, int N,
                int dataflow, int bm, int bn, int act, void* stream) {
  return launch_simt(a, b, bias, bypass, out, M, K, N, dataflow, bm, bn, act,
                     stream);
}

// skinny: M <= 64, K and N multiples of 4 (f32) or 8 (bf16), every
// pointer 16-byte aligned; ws holds splits x M x N floats when splits > 1.
int matmul_skinny_f32(const float* a, const float* b, const float* bias,
                      const float* bypass, float* out, float* ws, int M,
                      int K, int N, int kchunk, int splits, int act,
                      void* stream) {
  const SkinnyArgs<float> p =
      skinny_args(a, b, bias, bypass, out, ws, M, K, N, kchunk, splits, act);
  cudaStream_t st = (cudaStream_t)stream;
  return M <= 8 ? launch_skinny_f32<8>(p, st) : launch_skinny_f32<16>(p, st);
}

int matmul_skinny_bf16(const bf16* a, const bf16* b, const bf16* bias,
                       const bf16* bypass, bf16* out, float* ws, int M, int K,
                       int N, int kchunk, int splits, int act, void* stream) {
  return skinny_bf16<false>(a, b, bias, bypass, out, ws, M, K, N, kchunk,
                            splits, act, stream);
}

// b is the (N, K) tensor whose transpose the product takes: K a multiple
// of 8, any N, every pointer 16-byte aligned.
int matmul_skinny_bt_bf16(const bf16* a, const bf16* b, const bf16* bias,
                          const bf16* bypass, bf16* out, float* ws, int M,
                          int K, int N, int kchunk, int splits, int act,
                          void* stream) {
  return skinny_bf16<true>(a, b, bias, bypass, out, ws, M, K, N, kchunk,
                           splits, act, stream);
}

// wgmma: bf16, K and N multiples of 8, every pointer 16-byte aligned.
int matmul_wgmma_bf16(const bf16* a, const bf16* b, const bf16* bias,
                      const bf16* bypass, bf16* out, int M, int K, int N,
                      int dataflow, int bm, int bn, int act, void* stream) {
  return wgmma_bf16<false>(a, b, bias, bypass, out, M, K, N, dataflow, bm,
                           bn, act, stream);
}

// b is the (N, K) tensor whose transpose the product takes: K a multiple
// of 8, any N, every pointer 16-byte aligned.
int matmul_wgmma_bt_bf16(const bf16* a, const bf16* b, const bf16* bias,
                         const bf16* bypass, bf16* out, int M, int K, int N,
                         int dataflow, int bm, int bn, int act,
                         void* stream) {
  return wgmma_bf16<true>(a, b, bias, bypass, out, M, K, N, dataflow, bm, bn,
                          act, stream);
}

const char* matmul_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused an operand (alignment or "
           "stride)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
