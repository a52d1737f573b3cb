// Zero-copy row-strip implicit-GEMM conv2d for Hopper (sm_90a), f32 or
// bf16.
//
// Replaces repro/kernels/conv2d/kernel.py::conv2d_virtual_pallas (line
// 241; its pallas_call at 342/346).  The schedule's strip ownership is
// kept: strip s of image b owns output rows [s*SR, (s+1)*SR) (SR =
// out_rows, or out_rows / pool_stride with a fused pool), and the input is
// read unpadded: a tap outside the maps reads 0, which is what the
// reference's padded maps hold there, so no padded copy is ever made.
//
// What bounds it, and the design: arithmetic (84-953 f32 FLOP per byte at
// batch 8), so the GEMM runs on the tensor cores in 3xTF32 with split-K
// in a cluster; the core is csrc/conv_mma.cuh, shared with
// conv2d_strips.cu.  This file supplies VirtualRows, the A operand's
// address map:
//
// * Without a pool a CTA tile is BM = 64 consecutive pixels of the
//   flat (image, output row, column) index, which may span strips and
//   images.  Pixel (b, r, c) lies in strip s = r / out_rows.
// * With a fused pool a tile is tile_r x tile_c pooled outputs of one
//   strip, and the CTA holds the whole conv region under them (conv_r x
//   conv_c <= BM <= 256 pixels; the overlapping rows and columns are
//   recomputed, as the TPU strip recomputes rows_c - out_rows rows) in
//   registers: K is streamed once, the activated region is staged in
//   shared memory, conv pixels outside [0,OH)x[0,OW) hold the pool's
//   identity (-inf for max, 0 for avg), and the tile pools in place.
// * Every pixel's first input row is r0(s) + (local conv row) * stride -
//   top_pad, r0(s) = row_starts[s] (strip_offsets="prefetch": where the TPU
//   kernel reads a scalar-prefetched table, the CTA reads the device
//   table) or the affine s * out_rows * stride.  The table counts rows of
//   the padded maps (top_pad = pad + pool_pad * stride phantom rows on
//   top), the maps here are unpadded, so top_pad is subtracted.
//
// The channel tile is 64 contiguous output channels whatever kpt is: every
// output gets the same sum.  dataflow sets the CTA order (the TPU grid
// order, read as L2 locality): MAPS_RESIDENT runs channel tiles fastest,
// WEIGHTS_RESIDENT pixel tiles.

#include "conv_mma.cuh"

namespace {

using conv_mma::ConvParams;
using conv_mma::PoolTile;

struct VirtualRows {
  // .x / .y: the unpadded input row / column of tap (0, 0); .z: the
  // image's first pixel; .w: 1 for a conv pixel the tile computes.
  __device__ static int4 row(const ConvParams& p, int mt, int m, int bm) {
    int b, s, gr, gc;
    if (p.pool_op == 0) {
      const long long gm = (long long)mt * bm + m;
      if (gm >= p.M) return make_int4(0, 0, 0, 0);
      const int ohw = p.OH * p.OW;
      b = (int)(gm / ohw);
      const int rem = (int)(gm - (long long)b * ohw);
      gr = rem / p.OW;
      gc = rem - gr * p.OW;
      s = gr / p.out_rows;
    } else {
      if (m >= p.conv_r * p.conv_c) return make_int4(0, 0, 0, 0);
      const PoolTile pt(p, mt);
      const int ur = m / p.conv_c, uc = m - ur * p.conv_c;
      b = pt.b;
      s = pt.s;
      gr = s * p.out_rows - p.pp + pt.tr * p.tile_r * p.ps + ur;
      gc = pt.tc * p.tile_c * p.ps - p.pp + uc;
      if (gr < 0 || gr >= p.OH || gc < 0 || gc >= p.OW)
        return make_int4(0, 0, 0, 0);
    }
    const int lc = gr - (s * p.out_rows - p.pp);  // conv row in the strip
    const int r0 = p.row_starts ? p.row_starts[s] : s * p.out_rows * p.stride;
    return make_int4(r0 + lc * p.stride - p.top_pad, gc * p.stride - p.pad,
                     b * p.H * p.W, 1);
  }
  __device__ static bool pixel(const ConvParams& p, int4 r, int dy, int dx,
                               long long* pix) {
    const int iy = r.x + dy, ix = r.y + dx;
    if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return false;
    *pix = (long long)r.z + (long long)iy * p.W + ix;
    return true;
  }
};

// a: the n_args ints conv2d/kernel.py::launch_args lists, in its order;
// the operands are all of type T.
template <typename T>
int run(const void* x, const void* w, const void* bias, const void* bypass,
        const int* row_starts, void* out, const int* a, int n_args,
        void* stream) {
  if (n_args != 36) return (int)cudaErrorInvalidValue;
  ConvParams p = {};
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.bypass = bypass;
  p.row_starts = row_starts;
  p.out = out;
  const int B = a[0];
  p.H = a[1];
  p.W = a[2];
  p.Cin = a[3];
  const int kh = a[4];
  p.kw = a[5];
  p.Cout = a[6];
  p.K = kh * p.kw * p.Cin;
  p.stride = a[7];
  p.pad = a[8];
  p.out_rows = a[9];
  p.OH = a[10];
  p.OW = a[11];
  p.n_strips = a[12];
  p.top_pad = a[13];
  p.pw = a[14];
  p.ps = a[15];
  p.pp = a[16];
  p.pool_op = a[17];
  p.SR = a[18];
  p.OHo = a[19];
  p.OWo = a[20];
  p.act = a[21];
  p.bypass_first = a[22];
  p.weights_resident = a[23];
  const int bm = a[24], va = a[25], vb = a[26], smem = a[27];
  p.n_mt = a[28];
  p.n_nt = a[29];
  p.splits = a[30];
  p.kps = a[31];
  p.tile_r = a[32];
  p.tile_c = a[33];
  p.conv_r = (p.tile_r - 1) * p.ps + p.pw;
  p.conv_c = (p.tile_c - 1) * p.ps + p.pw;
  p.n_tr = a[34];
  p.n_tc = a[35];
  p.M = (long long)B * p.OH * p.OW;
  if (p.pool_op &&
      (p.conv_r * p.conv_c > bm ||
       p.n_mt != B * p.n_strips * p.n_tr * p.n_tc))
    return (int)cudaErrorInvalidValue;
  if (!p.pool_op && (long long)p.n_mt * bm < p.M)
    return (int)cudaErrorInvalidValue;
  return conv_mma::launch<T, VirtualRows>(p, bm, va, vb, smem,
                                          (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int conv2d_virtual_f32(const float* x, const float* w, const float* bias,
                       const float* bypass, const int* row_starts,
                       float* out, const int* a, int n_args, void* stream) {
  return run<float>(x, w, bias, bypass, row_starts, out, a, n_args, stream);
}

int conv2d_virtual_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        const __nv_bfloat16* bias,
                        const __nv_bfloat16* bypass, const int* row_starts,
                        __nv_bfloat16* out, const int* a, int n_args,
                        void* stream) {
  return run<__nv_bfloat16>(x, w, bias, bypass, row_starts, out, a, n_args,
                            stream);
}

const char* conv2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
