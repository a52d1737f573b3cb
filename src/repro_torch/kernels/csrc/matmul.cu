// Scheduled matmul with fused epilogue for Hopper (sm_90a), f32 or bf16.
//
// Replaces repro/kernels/matmul/kernel.py::matmul_pallas: out =
// epilogue(A @ B) for A (M,K), B (K,N) row-major, with bias -> activation
// -> bypass on writeback (no bypass_first here: the matmul epilogue has
// none).  The ragged edges of M, N and K are masked in the kernel, so the
// operands are never padded to the schedule's block.  The element type T
// is float or __nv_bfloat16 for A, B, bias, bypass and out alike, as the
// reference writes out_dtype = a.dtype; the sum and the whole epilogue
// are f32, and the result is rounded to T once, on the store.
//
// Bound on an H100: the CNN FC layers and the LM decode projections have
// M = batch or slots (a few rows) and a K x N weight of 0.6-151 MB, so
// the product does ~M/2 FLOP per weight byte (M per byte in bf16): HBM
// (3.35 TB/s) bounds it, not arithmetic.  The tile is shaped for that:
// 16 rows x 32 columns per CTA (N/32 CTAs stream disjoint weight
// columns), a deep K slice of 128 so each CTA keeps 16 KB (8 KB in bf16)
// of weight loads in flight, and a register prefetch of the next slice
// while the current one is reduced from shared memory.  The LM prefill
// projections (M = 512) are bounded by the tensor cores instead; this
// SIMT loop runs them far below that bound.  Split-K, wider loads and a
// wgmma path for large M are later work.
//
// Each CTA owns its output tile over all of K (the TPU's OUTPUT_STATIONARY
// k-grid accumulator becomes a loop inside the CTA).  The dataflow sets
// the CTA order, read as L2 locality: MAPS_RESIDENT runs the N tiles of
// one M tile back to back, WEIGHTS_RESIDENT the M tiles of one N tile,
// and OUTPUT_STATIONARY walks the schedule's (bm, bn) blocks one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 32;
constexpr int BK = 128;
constexpr int AST = BM + 1;    // padded A tile row: conflict-free stores
constexpr int THREADS = 128;   // 32 columns x 4 row groups of 4
static_assert(BK == THREADS, "one A column per thread");

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

template <typename T>
__global__ void __launch_bounds__(THREADS) matmul_kernel(MatmulArgs<T> p) {
  __shared__ float As[BK * AST];   // [BK][AST], k-major
  __shared__ float Bs[BK * BN];    // [BK][BN]

  int mt, nt;
  const int L = blockIdx.x;
  if (p.dataflow == 0) {
    mt = L / p.n_nt;
    nt = L - mt * p.n_nt;
  } else if (p.dataflow == 1) {
    nt = L / p.n_mt;
    mt = L - nt * p.n_mt;
  } else {
    const int per = p.gm * p.gn;
    const int blk = L / per, in = L - blk * per;
    const int bi = blk / p.n_bn, bj = blk - bi * p.n_bn;
    mt = bi * p.gm + in / p.gn;
    nt = bj * p.gn + in % p.gn;
    if (mt >= p.n_mt || nt >= p.n_nt) return;
  }

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

template <typename T>
int launch(const T* a, const T* b, const T* bias, const T* bypass, T* out,
           int M, int K, int N, int dataflow, int bm, int bn, int act,
           void* stream) {
  MatmulArgs<T> p;
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.bypass = bypass;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.n_mt = (M + BM - 1) / BM;
  p.n_nt = (N + BN - 1) / BN;
  p.dataflow = dataflow;
  p.act = act;
  p.gm = (bm + BM - 1) / BM;
  p.gn = (bn + BN - 1) / BN;
  if (p.gm < 1) p.gm = 1;
  if (p.gn < 1) p.gn = 1;
  long long n_cta = (long long)p.n_mt * p.n_nt;
  p.n_bn = (p.n_nt + p.gn - 1) / p.gn;
  if (dataflow == 2) {
    const long long n_bm = (p.n_mt + p.gm - 1) / p.gm;
    n_cta = n_bm * p.n_bn * p.gm * p.gn;
  }
  matmul_kernel<T><<<(unsigned)n_cta, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_f32(const float* a, const float* b, const float* bias,
               const float* bypass, float* out, int M, int K, int N,
               int dataflow, int bm, int bn, int act, void* stream) {
  return launch(a, b, bias, bypass, out, M, K, N, dataflow, bm, bn, act,
                stream);
}

int matmul_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                const __nv_bfloat16* bias, const __nv_bfloat16* bypass,
                __nv_bfloat16* out, int M, int K, int N, int dataflow, int bm,
                int bn, int act, void* stream) {
  return launch(a, b, bias, bypass, out, M, K, N, dataflow, bm, bn, act,
                stream);
}

const char* matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
