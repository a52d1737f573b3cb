// Materialized-strip implicit-GEMM conv2d for Hopper (sm_90a), f32.
//
// Replaces repro/kernels/conv2d/kernel.py::conv2d_strips_pallas, the
// paper-faithful baseline: the maps' halo-augmented row strips have already
// been copied into device memory (Snowflake keeps the overlapping rows in
// DRAM so that its DMA engine can issue single-burst loads), and the conv is
// an implicit GEMM over them with the fused epilogue bias -> bypass if
// bypass_first -> activation -> bypass otherwise:
//   strips (NS, in_rows, Wp, Cin), w (kh, kw, Cin, Cout),
//   bypass (NS, out_rows, OW, Cout)  ->  out (NS, out_rows, OW, Cout).
//
// Design.  The TPU grid runs one (strip, kpt channels) block a step.  A
// SNOWFLAKE strip is 1-5 output rows by 13-55 columns and kpt is 1-11
// channels, so a CTA cut per such block would leave most of a 64 x 64 tile
// idle.  The TPU block is therefore not carried over.  Instead
// M = NS * out_rows * OW is one flat pixel index over the contiguous output:
// pixel m = ((s * out_rows) + r) * OW + c reads strip s at rows r * stride
// + dy, so a 64-pixel tile may span strips.  N is 64 contiguous output
// channels whatever kpt is: the kpt tiles are contiguous channel ranges, so
// every output gets the same sum either way.  The strips carry the zero
// halo, so no input row or column needs a bounds check; the rows past OH in
// each image's last strip are computed and trimmed by the caller, as the
// reference does.
//
// The GEMM is K = kh*kw*Cin deep, gathered tap by tap from NHWC strips;
// weights (kh,kw,Cin,Cout) are already a K x Cout matrix.  It is the
// register-tiled SIMT GEMM of conv2d.cu: 4x4 outputs per thread, 256
// threads, double-buffered shared-memory tiles of BK = 16, register prefetch
// of the next K slice.  wgmma and TMA are later work.
//
// Bound on an H100: at batch 8 the SNOWFLAKE paper-faithful alexnet-owt
// convs do 84-392 f32 FLOP per byte they must move (the strip buffer read
// once, the weights, the output) and resnet18's 3x3 convs 93-260, above the
// f32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte, so arithmetic
// bounds them; resnet18's 1x1 stride-2 projections (13-38 FLOP/byte) sit
// near the ridge, and the strip buffer's bytes bound the 56 x 56 one.
//
// dataflow sets only the CTA order (the TPU grid order, read as L2
// locality): MAPS_RESIDENT (Kloop) runs the channel tiles of a pixel tile
// fastest, WEIGHTS_RESIDENT (Mloop) the pixel tiles of a channel tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // output pixels per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 16;        // reduction slice
constexpr int AST = BM + 4;   // padded row of the A tile (bank spread)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct StripArgs {
  const float* strips;
  const float* w;
  const float* bias;
  const float* bypass;
  float* out;
  int NS, in_rows, Wp, Cin, kh, kw, Cout, K;
  int stride, out_rows, OW;
  long long M;  // NS * out_rows * OW output pixels
  int n_mt, n_nt;
  int act, bypass_first, weights_resident;
};

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

__global__ void __launch_bounds__(THREADS)
    conv2d_strips_kernel(StripArgs a) {
  __shared__ __align__(16) float As[2 * BK * AST];
  __shared__ __align__(16) float Bs[2 * BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  int mt, nt;
  if (a.weights_resident) {
    nt = blockIdx.x / a.n_mt;
    mt = blockIdx.x - nt * a.n_mt;
  } else {
    mt = blockIdx.x / a.n_nt;
    nt = blockIdx.x - mt * a.n_nt;
  }
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;

  // This thread's loads: A element (ak, am + 16q), B element (bk + 4q, bn).
  const int ak = tid % BK, am = tid / BK;
  const int bn = tid % BN, bk = tid / BN;
  const int rows_ow = a.out_rows * a.OW;

  // The first input element (tap 0, channel 0) of the four pixels this
  // thread gathers for, fixed over the K loop.
  long long base[4];
  bool pv[4];
  for (int q = 0; q < 4; ++q) {
    const long long m = m0 + am + 16 * q;
    pv[q] = m < a.M;
    const long long s = pv[q] ? m / rows_ow : 0;
    const int rem = pv[q] ? (int)(m - s * rows_ow) : 0;
    const int r = rem / a.OW, c = rem - r * a.OW;
    base[q] = ((s * a.in_rows + (long long)r * a.stride) * a.Wp +
               (long long)c * a.stride) *
              a.Cin;
  }
  const int nk = (a.K + BK - 1) / BK;

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int k = k0 + ak;
    const bool kv = k < a.K;
    long long off = 0;
    if (kv) {
      const int dy = k / (a.kw * a.Cin);
      const int rem = k - dy * a.kw * a.Cin;
      const int dx = rem / a.Cin;
      const int ci = rem - dx * a.Cin;
      off = ((long long)dy * a.Wp + dx) * a.Cin + ci;
    }
    for (int q = 0; q < 4; ++q)
      ra[q] = (kv && pv[q]) ? a.strips[base[q] + off] : 0.f;
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + bk + 4 * q;
      const int n = n0 + bn;
      rb[q] = (kk < a.K && n < a.Cout) ? a.w[(size_t)kk * a.Cout + n] : 0.f;
    }
  };
  auto store = [&](int buf) {
    for (int q = 0; q < 4; ++q) {
      As[(buf * BK + ak) * AST + am + 16 * q] = ra[q];
      Bs[(buf * BK + bk + 4 * q) * BN + bn] = rb[q];
    }
  };

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    if (it + 1 < nk) load((it + 1) * BK);
    const float* Ab = As + buf * BK * AST;
    const float* Bb = Bs + buf * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float4 av = *reinterpret_cast<const float4*>(Ab + k * AST + ty * 4);
      float4 bv = *reinterpret_cast<const float4*>(Bb + k * BN + tx * 4);
      float ar[4] = {av.x, av.y, av.z, av.w};
      float br[4] = {bv.x, bv.y, bv.z, bv.w};
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    if (it + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: bias -> bypass if bypass_first -> activation -> bypass.  The
  // output and the bypass share the flat (pixel, channel) index.
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= a.Cout) continue;
      const size_t o = (size_t)m * a.Cout + c;
      float v = acc[i][j];
      if (a.bias) v += a.bias[c];
      if (a.bypass && a.bypass_first) v += a.bypass[o];
      v = activate(v, a.act);
      if (a.bypass && !a.bypass_first) v += a.bypass[o];
      a.out[o] = v;
    }
  }
}

}  // namespace

extern "C" {

int conv2d_strips_f32(const float* strips, const float* w, const float* bias,
                      const float* bypass, float* out, int NS, int in_rows,
                      int Wp, int Cin, int kh, int kw, int Cout, int stride,
                      int out_rows, int OW, int act, int bypass_first,
                      int weights_resident, void* stream) {
  StripArgs a;
  a.strips = strips;
  a.w = w;
  a.bias = bias;
  a.bypass = bypass;
  a.out = out;
  a.NS = NS;
  a.in_rows = in_rows;
  a.Wp = Wp;
  a.Cin = Cin;
  a.kh = kh;
  a.kw = kw;
  a.Cout = Cout;
  a.K = kh * kw * Cin;
  a.stride = stride;
  a.out_rows = out_rows;
  a.OW = OW;
  a.M = (long long)NS * out_rows * OW;
  a.n_mt = (int)((a.M + BM - 1) / BM);
  a.n_nt = (Cout + BN - 1) / BN;
  a.act = act;
  a.bypass_first = bypass_first;
  a.weights_resident = weights_resident;
  const long long n_cta = (long long)a.n_mt * a.n_nt;
  if (n_cta == 0) return (int)cudaSuccess;
  conv2d_strips_kernel<<<(unsigned)n_cta, THREADS, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* conv2d_strips_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
