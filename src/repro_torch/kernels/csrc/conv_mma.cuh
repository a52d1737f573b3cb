// One implicit-GEMM core for the two conv kernels, zero-copy (conv2d.cu)
// and materialized strips (conv2d_strips.cu), on Hopper (sm_90a), f32 or
// bf16 operands (all of one type), summed in f32 and rounded once on the
// store.
// Each source supplies a Rows type that maps pixel m of a CTA's pixel tile
// to where its im2col row starts in the input, and whether a tap of it
// lies inside the maps; everything else is here.
//
// The conv is a GEMM out[M x Cout] = A[M x K] W[K x Cout]: M output (conv)
// pixels, K = kh*kw*Cin gathered tap by tap from NHWC (k = (dy*kw + dx)
// * Cin + ci), and the (kh, kw, Cin, Cout) weights are already K x Cout.
//
// Bound on an H100: at batch 8 the alexnet-owt and resnet18 convs do 84-953
// f32 FLOP per byte they must move (resnet18's 1x1 projections 11-38),
// above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte),
// so arithmetic bounds them.  So:
//
// * Tensor cores at f32 accuracy: 3xTF32 on mma.sync.m16n8k8.tf32.  Each
//   operand x is split as it leaves shared memory into hi = rna_tf32(x)
//   and lo = rna_tf32(x - hi); three products, small terms first (lo.hi,
//   hi.lo, hi.hi).  The dropped lo.lo term and the remainders are about
//   2^-22 of each product, near f32's own rounding.  The tensor cores'
//   TF32 rate (495 TFLOP/s dense) over three products is still above the
//   67 TFLOP/s of f32 FMA.  The tensor cores' f32 accumulation truncates,
//   which biases a long chain of mma sums (its error grew with the
//   split's K depth, to 8.8e-5 at 1152 deep on an H100); so each k8 step's
//   three products sum in a fresh fragment that an f32 add (round to
//   nearest) folds into the accumulators.
// * A CTA tile is BM = 64 or 256 pixels by BN = 64 channels, BM / 16
//   warps (4 or 16); a warp holds 32 pixels by 32 channels of f32
//   accumulators (32 a thread).  The pixel tile is a flat range of
//   output pixels, or (zero-copy with a fused pool) the whole conv region
//   under tile_r x tile_c pooled outputs, so a pooled tile streams K once.
// * Operands staged by cp.async in a ring of STAGES = 3 slices of BK = 32:
//   A gathered by 16-byte copies when Cin % 4 == 0 (four k of one tap),
//   else 4-byte copies; taps outside the maps zero-filled by the copy.  B
//   (weights) by 16-byte copies when Cout % 4 == 0, else 4-byte.  Rows
//   are padded (A 40, B 68 floats) so the fragment loads of a warp (A in
//   8-byte pairs) hit distinct banks.  A table of the tile's BM row starts
//   (int4 each) is built once per CTA in shared memory.
// * Split-K inside a thread-block cluster.  The splits (1, 2, 4 or 8)
//   CTAs of one output tile are one cluster (grid x = tile * splits +
//   rank); CTA r sums k slices [r * kps, (r + 1) * kps).  Then every CTA
//   stores its partial of channel slice h (BN / splits channels) into CTA
//   h's shared memory, the cluster synchronises, and each CTA sums its
//   slice over the partials in rank (split) order, runs the epilogue and,
//   with a fused pool, pools its channels (channels pool independently,
//   so no pooled window is split).  One launch, no workspace, the same
//   bits run to run, nothing read on the host: a launch is graph-safe.
//   One split is a cluster of one CTA that takes its own partial.
// * Epilogue from shared memory, a thread per (pixel, channel), channels
//   fastest: bias -> bypass if bypass_first -> activation -> bypass; with
//   a pool the activated region (pixels outside the conv output hold the
//   pool's identity, -inf for max and 0 for avg) is pooled in place.
// * bf16 operands: a bf16 value is exact in TF32 (8 of its 11 bits), so
//   the split's low parts are zero and one product a step is exact.  The
//   gather widens each bf16 to f32 on its way into shared memory (a plain
//   load and store, 8 bytes for four k when Cin % 4 == 0, else one
//   element), so the ring, the fragments and the merge are the f32 ones;
//   bias and bypass are read as bf16 and the output rounded to bf16 once
//   after the epilogue (or the pool).
//
// conv_plan in kernels/conv2d/kernel.py picks BM, the pooled tile, the
// splits and kps from shapes alone; the launcher checks the plan's shared
// memory against its own count and launches the plan's grid as given.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace conv_mma {

constexpr int BN = 64;        // output channels per CTA tile
constexpr int BK = 32;        // reduction slice per ring stage
constexpr int STAGES = 3;
constexpr int AST = BK + 8;   // A row stride (floats): 160 B
constexpr int BST = BN + 4;   // B row stride (floats): 272 B
// A warp holds 32 pixels x 32 channels; a BM-pixel tile has BM / 32 x 2
// warps: 4, 8 or 16.
__host__ __device__ constexpr int threads_of(int bm) { return bm * 2; }

// The launch: geometry, operands and conv_plan's fields.
// The operands are all f32 or all bf16 (the kernel's T).
struct ConvParams {
  const void* x;  // maps (B, H, W, Cin) or strips (NS, in_rows, Wp, Cin)
  const void* w;
  const void* bias;
  const void* bypass;
  const int* row_starts;  // zero-copy: (n_strips,) padded-map rows or null
  void* out;
  int Cin, kw, K, Cout;
  int n_mt, n_nt, splits, kps;
  int weights_resident, act, bypass_first;
  long long M;  // output pixels of an unpooled conv
  // zero-copy maps
  int H, W, OH, OW, stride, pad, out_rows, n_strips, top_pad;
  // strips
  int in_rows, Wp;
  // fused pool (zero-copy only): pool_op 0 none, 1 max, 2 avg
  int pool_op, pw, ps, pp, SR, OHo, OWo;
  int tile_r, tile_c, conv_r, conv_c, n_tr, n_tc;
};

// Shared memory of one CTA: the ring (or, after the K loop, the split
// partials), then the row table.
__host__ __device__ constexpr int region_floats(int bm) {
  return STAGES * (bm * AST + BK * BST) > bm * BN
             ? STAGES * (bm * AST + BK * BST)
             : bm * BN;
}
__host__ __device__ constexpr int smem_bytes(int bm) {
  return 4 * region_floats(bm) + 16 * bm;
}
// CTAs of a BM-pixel tile one SM holds: its 228 KB of shared memory, 1 KB
// of it reserved per CTA (3 and 1; conv_plan's ``resident``), which also
// bounds the registers a thread may take.
__host__ __device__ constexpr int resident(int bm) {
  return (228 * 1024) / (smem_bytes(bm) + 1024);
}

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
  return __float2bfloat16(v);
}
// Four bf16 (8 bytes, the first in the low half of .x) as f32, exactly.
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
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

// (b, s, tr, tc) of pooled tile mt: tiles run (image, strip, row, col).
struct PoolTile {
  int b, s, tr, tc;
  __device__ PoolTile(const ConvParams& p, int mt) {
    tc = mt % p.n_tc;
    int rest = mt / p.n_tc;
    tr = rest % p.n_tr;
    rest /= p.n_tr;
    s = rest % p.n_strips;
    b = rest / p.n_strips;
  }
};

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (10 mantissa bits), each
// rounded to nearest with ties away from zero: the bits cvt.rna.tf32.f32
// gives, from integer adds and masks, which issue at four times the rate
// of a conversion.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// One CTA: tile blockIdx.x / splits, split rank blockIdx.x % splits (its
// rank in the cluster); T the operands' type.  Rows::row(p, mt, m, BM)
// gives pixel m's row start as an int4 (.w = 1 for a real conv pixel);
// Rows::pixel(p, r, dy, dx, &pix) the input pixel of tap (dy, dx), false
// outside the maps.
template <typename T, int BM, bool VA, bool VB, typename Rows>
__global__ void __launch_bounds__(threads_of(BM), resident(BM))
    conv_kernel(ConvParams p) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const T* xg = static_cast<const T*>(p.x);
  const T* wg = static_cast<const T*>(p.w);
  const T* bias = static_cast<const T*>(p.bias);
  const T* bypass = static_cast<const T*>(p.bypass);
  T* out = static_cast<T*>(p.out);
  constexpr int THREADS = threads_of(BM);
  constexpr int WARPS_N = 2;
  constexpr int WN = BN / WARPS_N;       // 32 channels a warp
  constexpr int NT = WN / 8;             // n8 tiles a warp
  constexpr int A_STAGE = BM * AST;
  constexpr int STAGE = A_STAGE + BK * BST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int4* rows = reinterpret_cast<int4*>(smem + region_floats(BM));

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / p.splits;
  int mt, nt;
  if (p.weights_resident) {
    nt = tile / p.n_mt;
    mt = tile - nt * p.n_mt;
  } else {
    mt = tile / p.n_nt;
    nt = tile - mt * p.n_nt;
  }
  const int n0 = nt * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;

  for (int m = tid; m < BM; m += THREADS) rows[m] = Rows::row(p, mt, m, BM);
  __syncthreads();

  // This split's k slices [kt0, kt1); k at or past k_end reads zeros.
  const int nk = (p.K + BK - 1) / BK;
  const int kt0 = rank * p.kps;
  const int kt1 = min(nk, kt0 + p.kps);
  const int n_slices = max(0, kt1 - kt0);
  const int k_end = min(p.K, kt1 * BK);

  // The k of this thread's A copies in the next slice (ak), as the tap
  // (dy, dx) and the channel ci, carried from slice to slice (k grows by
  // BK) without a division.
  constexpr int AC = VA ? BK / 4 : BK;  // copies across one A row
  const int kc = tid % AC;
  int ak = kt0 * BK + (VA ? 4 * kc : kc);
  int ci = ak % p.Cin, dx = (ak / p.Cin) % p.kw, dy = ak / p.Cin / p.kw;

  // Copy the next slice of this split (the slices in order, from the
  // first) into ring stage st.
  auto load = [&](int i, int st) {
    const int k0 = (kt0 + i) * BK;
    float* As = smem + st * STAGE;
    float* Bs = As + A_STAGE;
    const bool kv = ak < k_end;
    for (int m = tid / AC; m < BM; m += THREADS / AC) {
      const int4 r = rows[m];
      long long pix = 0;
      const bool ok = kv && r.w && Rows::pixel(p, r, dy, dx, &pix);
      const T* src = ok ? xg + pix * p.Cin + ci : xg;
      float* dst = As + m * AST + (VA ? 4 * kc : kc);
      if constexpr (F32) {
        if (VA)
          hopper::cp_async16(dst, src, ok);
        else
          hopper::cp_async4(dst, src, ok);
      } else if (VA) {
        *reinterpret_cast<float4*>(dst) =
            ok ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(src))
               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = ok ? to_f32(*src) : 0.f;
      }
    }
    ak += BK;
    for (ci += BK; ci >= p.Cin; ci -= p.Cin)
      if (++dx == p.kw) {
        dx = 0;
        ++dy;
      }
    constexpr int BC = VB ? BN / 4 : BN;  // copies across one B row
    for (int i2 = tid; i2 < BK * BC; i2 += THREADS) {
      const int kr = i2 / BC, j = i2 - kr * BC;
      const int kk = k0 + kr, n = n0 + (VB ? 4 * j : j);
      const bool ok = kk < k_end && n < p.Cout;
      const T* src = ok ? wg + (size_t)kk * p.Cout + n : wg;
      float* dst = Bs + kr * BST + (VB ? 4 * j : j);
      if constexpr (F32) {
        if (VB)
          hopper::cp_async16(dst, src, ok);
        else
          hopper::cp_async4(dst, src, ok);
      } else if (VB) {
        *reinterpret_cast<float4*>(dst) =
            ok ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(src))
               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = ok ? to_f32(*src) : 0.f;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][nj][v] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_slices) load(st, st);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < n_slices; ++i) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice i visible; every thread past slice i - 1
    if (i + STAGES - 1 < n_slices)
      load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const float* As = smem + (i % STAGES) * STAGE;
    const float* Bs = As + A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // The mma's k slots t and t + 4 take k = kk + 2t and kk + 2t + 1
      // (the same for A and B, so the sum is unchanged): a lane's two A
      // values of a row are one 8-byte load.  bf16 operands have no low
      // part (al, bl zero), and one product is exact.
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = As + (wm * 32 + mi * 16 + g) * AST + kk + 2 * t;
        const float2 top = *reinterpret_cast<const float2*>(a);
        const float2 bot = *reinterpret_cast<const float2*>(a + 8 * AST);
        split_tf32(top.x, ah[mi][0], al[mi][0]);
        split_tf32(bot.x, ah[mi][1], al[mi][1]);
        split_tf32(top.y, ah[mi][2], al[mi][2]);
        split_tf32(bot.y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const float* b = Bs + (kk + 2 * t) * BST + wn * WN + nj * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(b[0], bh[0], bl[0]);
        split_tf32(b[BST], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (F32) {
            hopper::mma_tf32_1688(d, al[mi], bh[0], bh[1]);
            hopper::mma_tf32_1688(d, ah[mi], bl[0], bl[1]);
          }
          hopper::mma_tf32_1688(d, ah[mi], bh[0], bh[1]);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mi][nj][v] += d[v];
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

  // The merge: CTA h of the cluster owns channels [h * CS, (h + 1) * CS)
  // of the tile; partial (rank) of pixel m, channel n lands in
  // recv[rank][m][n - h * CS] of CTA h.  The first cluster barrier keeps
  // every ring in use until all CTAs have left the K loop.
  const int CS = BN / p.splits;
  float* recv = smem;  // [splits][BM][CS], over the ring
  cluster.sync();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = wm * 32 + mi * 16 + g + (v >= 2 ? 8 : 0);
        const int n = wn * WN + nj * 8 + 2 * t + (v & 1);
        const int h = n / CS;
        cluster.map_shared_rank(recv, h)[(rank * BM + m) * CS + n - h * CS] =
            acc[mi][nj][v];
      }
  cluster.sync();

  const int c_lo = n0 + rank * CS;  // this CTA's first channel
  if (p.pool_op == 0) {
    for (int i = tid; i < BM * CS; i += THREADS) {
      const int m = i / CS, nl = i - m * CS;
      const long long gm = (long long)mt * BM + m;
      const int c = c_lo + nl;
      if (gm >= p.M || c >= p.Cout) continue;
      float v = 0.f;
      for (int r = 0; r < p.splits; ++r) v += recv[(r * BM + m) * CS + nl];
      const size_t o = (size_t)gm * p.Cout + c;
      if (bias) v += to_f32(bias[c]);
      if (bypass && p.bypass_first) v += to_f32(bypass[o]);
      v = activate(v, p.act);
      if (bypass && !p.bypass_first) v += to_f32(bypass[o]);
      out[o] = from_f32<T>(v);
    }
    return;
  }

  // Fused pool: the activated region in place of partial 0, then each
  // pooled output of the tile over its window.
  const float ident = p.pool_op == 1 ? -INFINITY : 0.f;
  for (int i = tid; i < BM * CS; i += THREADS) {
    const int m = i / CS, nl = i - m * CS;
    const int c = c_lo + nl;
    float v = 0.f;
    for (int r = 0; r < p.splits; ++r) v += recv[(r * BM + m) * CS + nl];
    if (c < p.Cout && bias) v += to_f32(bias[c]);
    recv[m * CS + nl] = rows[m].w ? activate(v, p.act) : ident;
  }
  __syncthreads();
  const PoolTile pt(p, mt);
  for (int i = tid; i < p.tile_r * p.tile_c * CS; i += THREADS) {
    const int nl = i % CS, pos = i / CS;
    const int r = pos / p.tile_c, cc = pos - r * p.tile_c;
    const int pl = pt.tr * p.tile_r + r;  // pooled row within the strip
    const int prow = pt.s * p.SR + pl;
    const int q = pt.tc * p.tile_c + cc;
    const int c = c_lo + nl;
    if (pl >= p.SR || prow >= p.OHo || q >= p.OWo || c >= p.Cout) continue;
    float v = ident;
    for (int py = 0; py < p.pw; ++py)
      for (int px = 0; px < p.pw; ++px) {
        const float u =
            recv[((r * p.ps + py) * p.conv_c + cc * p.ps + px) * CS + nl];
        v = p.pool_op == 1 ? fmaxf(v, u) : v + u;
      }
    if (p.pool_op == 2) v = v / (float)(p.pw * p.pw);
    out[(((size_t)pt.b * p.OHo + prow) * p.OWo + q) * p.Cout + c] =
        from_f32<T>(v);
  }
}

template <typename T, int BM, bool VA, bool VB, typename Rows>
int launch_tile(const ConvParams& p, cudaStream_t stream) {
  auto kernel = conv_kernel<T, BM, VA, VB, Rows>;
  const int smem = smem_bytes(BM);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.n_mt * p.n_nt * p.splits));
  cfg.blockDim = dim3(threads_of(BM));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, int BM, typename Rows>
int launch_vec(const ConvParams& p, bool va, bool vb, cudaStream_t s) {
  if (va)
    return vb ? launch_tile<T, BM, true, true, Rows>(p, s)
              : launch_tile<T, BM, true, false, Rows>(p, s);
  return vb ? launch_tile<T, BM, false, true, Rows>(p, s)
            : launch_tile<T, BM, false, false, Rows>(p, s);
}

// Launch conv_plan's grid: BM pixels a tile, splits a cluster; smem is the
// plan's count of shared bytes, held to this file's; T the operands' type.
// Returns a cudaError_t code (cudaErrorInvalidValue for a plan this core
// refuses).
template <typename T, typename Rows>
int launch(const ConvParams& p, int bm, int va, int vb, int smem,
           cudaStream_t s) {
  const int sp = p.splits;
  if ((sp != 1 && sp != 2 && sp != 4 && sp != 8) || p.kps < 1 ||
      p.n_mt < 1 || p.n_nt < 1 || smem != smem_bytes(bm) ||
      (va && p.Cin % 4) || (vb && p.Cout % 4))
    return (int)cudaErrorInvalidValue;
  switch (bm) {
    case 64: return launch_vec<T, 64, Rows>(p, va, vb, s);
    case 256: return launch_vec<T, 256, Rows>(p, va, vb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace conv_mma
