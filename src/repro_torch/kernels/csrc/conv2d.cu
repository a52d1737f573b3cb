// Zero-copy row-strip implicit-GEMM conv2d for Hopper (sm_90a), f32.
//
// Replaces repro/kernels/conv2d/kernel.py::conv2d_virtual_pallas.  The
// schedule's strip ownership stays the outer decomposition: strip s of
// image b owns output rows [s*SR, (s+1)*SR) (SR = out_rows, or
// out_rows / pool_stride with a fused pool).  A TPU strip block (a whole
// strip times kpt channels, up to ~1 MB) does not fit the 227 KB of
// shared memory a Hopper block has, so each (strip, kpt) block is cut
// into CTA tiles: BN = 64 output channels times one tile of the strip.
//
// * Without a pool a tile is BM = 64 consecutive output pixels of the
//   strip (row-major over its SR x OW pixels).
// * With a fused pool a tile is tile_r x tile_c pooled outputs.  The CTA
//   computes the conv region under them (conv_r x conv_c pixels, the few
//   overlapping rows/cols recomputed as the TPU strip recomputes
//   rows_c - out_rows rows), in chunks of BM pixels, stages it in shared
//   memory after the epilogue, masks conv pixels outside [0,OH)x[0,OW)
//   with the pool's identity (-inf for max, 0 for avg), and pools.
//
// The input is read unpadded: a tap outside the image reads 0, which is
// what the reference's padded maps hold there, so no padded copy of the
// maps is ever made.  The GEMM is K = kh*kw*Cin deep, gathered tap by
// tap from NHWC; weights (kh,kw,Cin,Cout) are already a K x Cout matrix.
//
// Bound on an H100: at batch 8 the CNN convs do 93-953 FLOP per byte they
// must move (resnet18's 1x1 projections 11-35), so plain f32 FMA
// (67 TFLOP/s) bounds them, not HBM (20 FLOP/byte is the ridge).  This
// first version uses a register-tiled SIMT GEMM (4x4 outputs per thread,
// double-buffered shared-memory tiles, register prefetch of the next K
// slice); wgmma, TMA and a TF32/bf16 path are later work.
//
// dataflow sets the CTA order (the TPU grid order, read as L2 locality):
// MAPS_RESIDENT runs kernel tiles fastest, WEIGHTS_RESIDENT strips fastest.
//
// row_starts (strip_offsets="prefetch"): where the TPU kernel reads strip
// s's first input row from a scalar-prefetched table, each CTA here loads
// its own entry row_starts[s] instead of the affine s * out_rows * stride.
// The table counts rows of the padded maps (top_pad = pad + pool_pad *
// stride phantom rows on top), and the maps here are unpadded, so the
// kernel subtracts top_pad.  Output strips stay uniform, as on the TPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // conv pixels per GEMM chunk
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 16;        // reduction slice
constexpr int AST = BM + 4;   // padded row of the A tile (bank spread)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_STAGE = 256;  // conv pixels a pooled tile may stage

struct ConvArgs {
  const float* x;
  const float* w;
  const float* bias;
  const float* bypass;
  const int* row_starts;  // (n_strips,) padded-map rows, or null (affine)
  float* out;
  int B, H, W, Cin, kh, kw, Cout, K;
  int stride, pad, out_rows, OH, OW, n_strips, kpt;
  int pw, ps, pp, pool_op;  // pool_op: 0 none, 1 max, 2 avg
  int SR, OHo, OWo;
  int tile_r, tile_c, conv_r, conv_c, n_tc;
  int n_tiles, n_ct;
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

// Global conv coordinates of pixel p of this CTA's tile, and whether the
// pixel is a real conv output the tile must produce.
struct Pixel {
  int gr, gc;
  bool valid;
};

__device__ __forceinline__ Pixel tile_pixel(const ConvArgs& a, int s, int t,
                                            int p) {
  Pixel px;
  if (a.pool_op == 0) {
    int loc = t * BM + p;
    int l = loc / a.OW;
    px.gr = s * a.out_rows + l;
    px.gc = loc % a.OW;
    px.valid = l < a.out_rows && px.gr < a.OH;
  } else {
    int tr = t / a.n_tc, tc = t - tr * a.n_tc;
    int ur = p / a.conv_c, uc = p - ur * a.conv_c;
    px.gr = s * a.out_rows - a.pp + tr * a.tile_r * a.ps + ur;
    px.gc = tc * a.tile_c * a.ps - a.pp + uc;
    px.valid = p < a.conv_r * a.conv_c && px.gr >= 0 && px.gr < a.OH &&
               px.gc >= 0 && px.gc < a.OW;
  }
  return px;
}

__global__ void __launch_bounds__(THREADS)
    conv2d_virtual_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [2][BK][AST]
  float* Bs = As + 2 * BK * AST;     // [2][BK][BN]
  float* stage = Bs + 2 * BK * BN;   // [conv_r*conv_c][BN], pool only

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // CTA -> (image b, strip s, tile t, kernel tile kt, channel tile j).
  const int NK = a.Cout / a.kpt;
  const int n_map = a.B * a.n_strips * a.n_tiles;
  const int n_w = NK * a.n_ct;
  int map_id, w_id;
  if (a.weights_resident) {
    w_id = blockIdx.x / n_map;
    map_id = blockIdx.x - w_id * n_map;
  } else {
    map_id = blockIdx.x / n_w;
    w_id = blockIdx.x - map_id * n_w;
  }
  const int t = map_id % a.n_tiles;
  const int bs = map_id / a.n_tiles;
  const int s = bs % a.n_strips;
  const int b = bs / a.n_strips;
  const int j = w_id % a.n_ct;
  const int kt = w_id / a.n_ct;
  const int c_lo = j * BN;
  const int c0 = kt * a.kpt + c_lo;
  const int n_valid = min(BN, a.kpt - c_lo);

  const int n_pix = a.pool_op ? a.conv_r * a.conv_c : BM;
  const int n_chunks = (n_pix + BM - 1) / BM;
  const float ident = a.pool_op == 1 ? -INFINITY : 0.f;
  const float* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
  const int nk = (a.K + BK - 1) / BK;
  // Strip s's first input row in the padded maps; a pixel's local conv
  // row lc = gr - (s * out_rows - pp) reads rows r0 + lc * stride - top_pad
  // + dy of the unpadded maps.
  const int r0 = a.row_starts ? a.row_starts[s] : s * a.out_rows * a.stride;
  const int top_pad = a.pad + a.pp * a.stride;

  // This thread's loads: A element (ak, am + 16q), B element (bk + 4q, bn).
  const int ak = tid % BK, am = tid / BK;
  const int bn = tid % BN, bk = tid / BN;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // The four pixels this thread gathers for, fixed over the K loop.
    int iy0[4], ix0[4];
    bool pv[4];
    for (int q = 0; q < 4; ++q) {
      Pixel px = tile_pixel(a, s, t, chunk * BM + am + 16 * q);
      const int lc = px.gr - (s * a.out_rows - a.pp);
      iy0[q] = r0 + lc * a.stride - top_pad;
      ix0[q] = px.gc * a.stride - a.pad;
      pv[q] = px.valid;
    }
    float ra[4], rb[4];
    auto load = [&](int k0) {
      int k = k0 + ak;
      int dy = 0, dx = 0, ci = 0;
      bool kv = k < a.K;
      if (kv) {
        dy = k / (a.kw * a.Cin);
        int rem = k - dy * a.kw * a.Cin;
        dx = rem / a.Cin;
        ci = rem - dx * a.Cin;
      }
      for (int q = 0; q < 4; ++q) {
        int iy = iy0[q] + dy, ix = ix0[q] + dx;
        bool in = kv && pv[q] && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
        ra[q] = in ? xb[((size_t)iy * a.W + ix) * a.Cin + ci] : 0.f;
      }
      for (int q = 0; q < 4; ++q) {
        int kk = k0 + bk + 4 * q;
        rb[q] = (kk < a.K && bn < n_valid)
                    ? a.w[(size_t)kk * a.Cout + c0 + bn]
                    : 0.f;
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
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

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
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] += ar[i] * br[jj];
      }
      if (it + 1 < nk) store(buf ^ 1);
      __syncthreads();
    }

    // Epilogue: bias -> bypass if bypass_first -> activation -> bypass.
    for (int i = 0; i < 4; ++i) {
      const int p = chunk * BM + ty * 4 + i;
      Pixel px = tile_pixel(a, s, t, p);
      for (int jj = 0; jj < 4; ++jj) {
        const int n = tx * 4 + jj;
        if (n >= n_valid) continue;
        const int c = c0 + n;
        float v = acc[i][jj];
        if (a.bias) v += a.bias[c];
        if (a.pool_op == 0) {
          if (!px.valid) continue;
          const size_t o =
              (((size_t)b * a.OH + px.gr) * a.OW + px.gc) * a.Cout + c;
          if (a.bypass && a.bypass_first) v += a.bypass[o];
          v = activate(v, a.act);
          if (a.bypass && !a.bypass_first) v += a.bypass[o];
          a.out[o] = v;
        } else if (p < n_pix) {
          stage[p * BN + n] = px.valid ? activate(v, a.act) : ident;
        }
      }
    }
  }
  if (a.pool_op == 0) return;

  // Fused pool over the staged conv region (this tile's pooled outputs).
  __syncthreads();
  const int tr = t / a.n_tc, tc = t - tr * a.n_tc;
  const int n_out = a.tile_r * a.tile_c * BN;
  for (int idx = tid; idx < n_out; idx += THREADS) {
    const int n = idx % BN;
    const int pos = idx / BN;
    const int r = pos / a.tile_c, cc = pos - r * a.tile_c;
    const int pl = tr * a.tile_r + r;          // pooled row within strip
    const int prow = s * a.SR + pl;
    const int q = tc * a.tile_c + cc;
    if (n >= n_valid || pl >= a.SR || prow >= a.OHo || q >= a.OWo) continue;
    float v = ident;
    for (int py = 0; py < a.pw; ++py)
      for (int px = 0; px < a.pw; ++px) {
        float u = stage[((r * a.ps + py) * a.conv_c + cc * a.ps + px) * BN + n];
        v = a.pool_op == 1 ? fmaxf(v, u) : v + u;
      }
    if (a.pool_op == 2) v = v / (float)(a.pw * a.pw);
    a.out[(((size_t)b * a.OHo + prow) * a.OWo + q) * a.Cout + c0 + n] = v;
  }
}

}  // namespace

extern "C" {

int conv2d_virtual_f32(const float* x, const float* w, const float* bias,
                       const float* bypass, const int* row_starts,
                       float* out, int B, int H, int W,
                       int Cin, int kh, int kw, int Cout, int stride, int pad,
                       int out_rows, int OH, int OW, int n_strips, int kpt,
                       int pw, int ps, int pp, int pool_op, int SR, int OHo,
                       int OWo, int tile_r, int tile_c, int act,
                       int bypass_first, int weights_resident, void* stream) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.bypass = bypass;
  a.row_starts = row_starts;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.kh = kh;
  a.kw = kw;
  a.Cout = Cout;
  a.K = kh * kw * Cin;
  a.stride = stride;
  a.pad = pad;
  a.out_rows = out_rows;
  a.OH = OH;
  a.OW = OW;
  a.n_strips = n_strips;
  a.kpt = kpt;
  a.pw = pw;
  a.ps = ps;
  a.pp = pp;
  a.pool_op = pool_op;
  a.SR = SR;
  a.OHo = OHo;
  a.OWo = OWo;
  a.tile_r = tile_r;
  a.tile_c = tile_c;
  a.act = act;
  a.bypass_first = bypass_first;
  a.weights_resident = weights_resident;
  if (pool_op) {
    a.conv_r = (tile_r - 1) * ps + pw;
    a.conv_c = (tile_c - 1) * ps + pw;
    a.n_tc = (OWo + tile_c - 1) / tile_c;
    a.n_tiles = ((SR + tile_r - 1) / tile_r) * a.n_tc;
    if (a.conv_r * a.conv_c > MAX_STAGE) return (int)cudaErrorInvalidValue;
  } else {
    a.conv_r = a.conv_c = 0;
    a.n_tc = 1;
    a.n_tiles = (out_rows * OW + BM - 1) / BM;
  }
  a.n_ct = (kpt + BN - 1) / BN;
  const size_t smem =
      sizeof(float) * (2 * BK * AST + 2 * BK * BN +
                       (pool_op ? (size_t)a.conv_r * a.conv_c * BN : 0));
  cudaFuncSetAttribute(conv2d_virtual_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long n_cta =
      (long long)B * n_strips * a.n_tiles * (Cout / kpt) * a.n_ct;
  conv2d_virtual_kernel<<<(unsigned)n_cta, THREADS, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* conv2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
