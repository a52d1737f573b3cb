// Materialized-strip implicit-GEMM conv2d for Hopper (sm_90a), f32 or
// bf16.
//
// Replaces repro/kernels/conv2d/kernel.py::conv2d_strips_pallas (line 111;
// its pallas_call at 163), the paper-faithful baseline: the maps'
// halo-augmented row strips have already been copied into device memory
// (Snowflake keeps the overlapping rows in DRAM so that its DMA engine can
// issue single-burst loads), and the conv is an implicit GEMM over them
// with the fused epilogue bias -> bypass if bypass_first -> activation ->
// bypass otherwise:
//   strips (NS, in_rows, Wp, Cin), w (kh, kw, Cin, Cout),
//   bypass (NS, out_rows, OW, Cout)  ->  out (NS, out_rows, OW, Cout).
//
// What bounds it: arithmetic, as the zero-copy kernel (84-392 f32 FLOP
// per byte at batch 8 for the SNOWFLAKE alexnet-owt convs, resnet18's 3x3
// convs 93-260), plus reading the strip buffer, 1 + overlap_frac times the
// maps; resnet18's 1x1 stride-2 projections (13-38 FLOP/byte) sit near the
// f32 ridge.  The design is the 3xTF32 tensor-core GEMM with split-K in a
// cluster of csrc/conv_mma.cuh, shared with conv2d.cu; this file supplies
// StripRows, the A operand's address map.
//
// The TPU grid runs one (strip, kpt channels) block a step.  A SNOWFLAKE
// strip is 1-5 output rows by 13-55 columns and kpt is 1-11 channels, so
// that block is not carried over.  M = NS * out_rows * OW is one flat
// pixel index over the contiguous output: pixel m = ((s * out_rows) + r) *
// OW + c reads strip s at rows r * stride + dy, so a tile of BM = 64
// pixels may span strips.  N is 64 contiguous output channels whatever
// kpt is: the kpt tiles are contiguous channel ranges, so every output
// gets the same sum either way.  The strips carry the zero halo, so no tap
// needs a bounds check; the rows past OH in each image's last strip are
// computed and trimmed by the caller, as the reference does.  dataflow
// sets only the CTA order (the TPU grid order, read as L2 locality):
// MAPS_RESIDENT (Kloop) runs the channel tiles of a pixel tile fastest,
// WEIGHTS_RESIDENT (Mloop) the pixel tiles of a channel tile.

#include "conv_mma.cuh"

namespace {

using conv_mma::ConvParams;

struct StripRows {
  // .z: the strip-buffer pixel of tap (0, 0); .w: 1 for a real pixel.
  __device__ static int4 row(const ConvParams& p, int mt, int m, int bm) {
    const long long gm = (long long)mt * bm + m;
    if (gm >= p.M) return make_int4(0, 0, 0, 0);
    const int rows_ow = p.out_rows * p.OW;
    const int s = (int)(gm / rows_ow);
    const int rem = (int)(gm - (long long)s * rows_ow);
    const int r = rem / p.OW, c = rem - r * p.OW;
    return make_int4(0, 0, (s * p.in_rows + r * p.stride) * p.Wp +
                               c * p.stride, 1);
  }
  __device__ static bool pixel(const ConvParams& p, int4 r, int dy, int dx,
                               long long* pix) {
    *pix = (long long)r.z + (long long)dy * p.Wp + dx;
    return true;
  }
};

// a: the n_args ints conv2d/kernel.py::strips_launch_args lists, in its
// order; the operands are all of type T.
template <typename T>
int run(const void* strips, const void* w, const void* bias,
        const void* bypass, void* out, const int* a, int n_args,
        void* stream) {
  if (n_args != 21) return (int)cudaErrorInvalidValue;
  ConvParams p = {};
  p.x = strips;
  p.w = w;
  p.bias = bias;
  p.bypass = bypass;
  p.out = out;
  const int NS = a[0];
  p.in_rows = a[1];
  p.Wp = a[2];
  p.Cin = a[3];
  const int kh = a[4];
  p.kw = a[5];
  p.Cout = a[6];
  p.K = kh * p.kw * p.Cin;
  p.stride = a[7];
  p.out_rows = a[8];
  p.OW = a[9];
  p.act = a[10];
  p.bypass_first = a[11];
  p.weights_resident = a[12];
  const int bm = a[13], va = a[14], vb = a[15], smem = a[16];
  p.n_mt = a[17];
  p.n_nt = a[18];
  p.splits = a[19];
  p.kps = a[20];
  p.M = (long long)NS * p.out_rows * p.OW;
  if ((long long)p.n_mt * bm < p.M) return (int)cudaErrorInvalidValue;
  return conv_mma::launch<T, StripRows>(p, bm, va, vb, smem,
                                        (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int conv2d_strips_f32(const float* strips, const float* w, const float* bias,
                      const float* bypass, float* out, const int* a,
                      int n_args, void* stream) {
  return run<float>(strips, w, bias, bypass, out, a, n_args, stream);
}

int conv2d_strips_bf16(const __nv_bfloat16* strips, const __nv_bfloat16* w,
                       const __nv_bfloat16* bias,
                       const __nv_bfloat16* bypass, __nv_bfloat16* out,
                       const int* a, int n_args, void* stream) {
  return run<__nv_bfloat16>(strips, w, bias, bypass, out, a, n_args, stream);
}

const char* conv2d_strips_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
