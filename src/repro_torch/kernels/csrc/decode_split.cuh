// Split-KV single-token decode attention for Hopper (sm_90a): the tile
// loop, the partial write and the fixed-order merge shared by the
// contiguous (decode_attention.cu) and paged (paged_decode_attention.cu)
// kernels.  Each source supplies a Rows type that turns a virtual cache
// row into the address of its K and V rows (and, for int8 pools, their
// page's scales); everything else is here.
//
// For each sequence b and q head h = hk * G + g (G = Hq / Hkv <= 8),
//   out[b, h] = softmax(q[b, h] . K_b,hk[:len] * scale) V_b,hk[:len],
// len = min(kv_len[b], cache_len).
//
// Bound on an H100: every live cache row is read once per tick for G
// multiply-adds per element, so HBM (3.35 TB/s) bounds it, and a tick
// reads only a few MB: what costs is latency and an idle card.  So:
//
// * Split-KV.  The grid is (B * Hkv, splits): the CTA for (pair, split)
//   serves the pair's G q heads over rows [split * split_rows, ... +
//   split_rows) of the cache, so a long ring is walked by several CTAs at
//   once and the card is filled at 8 sequences (decode_plan in
//   kernels/decode_attention/kernel.py picks the split from shapes alone:
//   the host never reads kv_len or the page table).  A split that starts
//   at or past len reads nothing and holds an empty partial (m = -1e30,
//   l = 0, acc = 0).
// * A fixed-order merge in distributed shared memory.  The splits of one
//   pair are one thread-block cluster (1, splits <= 8), and CTA h of it
//   merges the h-th slice of the pair's G * D outputs: each CTA stores
//   its unnormalised f32 partial (m and l for its G heads, acc sliced by
//   owner) into the owners' shared memory, the cluster synchronises once,
//   and each CTA merges its slice from its own shared memory in rank
//   (split) order and writes it in q's type.  No workspace, no second
//   launch, and the output is the same bits from run to run.  One split
//   is a cluster of one CTA that normalises its own partial.
// * Row tiles through shared memory.  The CTA stages tiles of T <= 64
//   rows of K and V with 16-byte cp.async, double-buffered: tile t + 1
//   loads while tile t computes; q (and an int8 pool's page scales) load
//   while the first tile flies, a paged span's page ids beside kv_len.
//   Shared rows are padded to an odd number of 16-byte chunks, so the 8
//   lanes of a quarter-warp reading 8 rows hit 8 different bank groups.
//   Per tile, two steps and two barriers:
//     1. scores and softmax: one warp per head, one lane per row, dots
//        the K row (int8 dequantized with the page's scale as it leaves
//        shared memory) with q (f32, shared) -- no shuffle tree per row;
//        then the warp takes the tile's max and sum once (two shuffle
//        trees per tile and head) and writes P (times the row's V scale
//        for an int8 pool), alpha and l;
//     2. P V: one thread per (head, two columns) rescales its f32
//        accumulators once by alpha and adds P[r] * V[r] over the tile.
//   Scores are kept in log2 units (scale * log2 e) so the softmax takes
//   exp2f.  All sums are f32 with one rounding at the end.  Tensor cores
//   are not used: at G <= 8 the work is bound by bytes and latency.
//
// The cache's rows are f32, bf16, int8 (paged pools, with a page scale)
// or float8 e4m3 (the contiguous kernel, under an f32 or bf16 q): each
// 16-byte chunk is widened to f32 as it leaves shared memory, so the
// cache is read in its own bytes and never cast in device memory.
//
// D is any multiple of 16 bytes of the cache element (VEC elements), up
// to 32 * VEC (f32 <= 128, bf16 <= 256, int8 and e4m3 <= 512).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace decode_split {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;      // row tiles in shared memory (double buffer)
constexpr int MAX_TILE = 64;   // rows per tile: 32 or 64 (decode_plan)
constexpr int MAX_SPLITS = 8;  // CTAs of a cluster (portable size)
constexpr float NEG_INF = -1e30f;

// The launch as decode_plan gives it, and the q side of the operands.
struct SplitArgs {
  const void* q;
  void* out;
  const int* kv_len;
  int B, Hq, Hkv, D, cache_len;
  int tile_rows, split_rows, splits;
  long long q_sb, q_sh, o_sb, o_sh;  // element strides: batch, head
  float scale;
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
  return __float2bfloat16(v);
}

// 16 bytes of a cache row as VEC = 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw,
                                                float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw,
                                                        float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// Four int8 values of a word as floats, exactly, without the
// quarter-rate integer conversion: byte x + 128 becomes the low mantissa
// byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void unpack_i8x4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) -
             8388736.f;
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& raw,
                                                 float* out) {
  unpack_i8x4(raw.x, out);
  unpack_i8x4(raw.y, out + 4);
  unpack_i8x4(raw.z, out + 8);
  unpack_i8x4(raw.w, out + 12);
}
// Two float8 e4m3 values (the low byte first) as floats, exactly: the
// hardware's e4m3x2 -> f16x2 conversion, then f16 -> f32.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(v & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}
template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4& raw,
                                                        float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 lo = e4m3x2_to_float2(w[i]);
    const float2 hi = e4m3x2_to_float2(w[i] >> 16);
    out[4 * i] = lo.x;
    out[4 * i + 1] = lo.y;
    out[4 * i + 2] = hi.x;
    out[4 * i + 3] = hi.y;
  }
}

// Two neighbouring columns of a V row (one thread's share in the P V
// step) as floats.
template <typename T>
__device__ __forceinline__ void load_cols(const char* p, float* out);
template <>
__device__ __forceinline__ void load_cols<float>(const char* p, float* out) {
  const float2 v = *(const float2*)p;
  out[0] = v.x;
  out[1] = v.y;
}
template <>
__device__ __forceinline__ void load_cols<__nv_bfloat16>(const char* p,
                                                         float* out) {
  const uint32_t w = *(const uint32_t*)p;
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load_cols<int8_t>(const char* p, float* out) {
  const uint32_t u = *(const uint16_t*)p ^ 0x8080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u)) - 8388736.f;
}
template <>
__device__ __forceinline__ void load_cols<__nv_fp8_e4m3>(const char* p,
                                                         float* out) {
  const float2 v = e4m3x2_to_float2(*(const uint16_t*)p);
  out[0] = v.x;
  out[1] = v.y;
}

// Dynamic shared memory of one CTA, in bytes from its start: STAGES row
// tiles of K and V, q in f32, the tile's P, what the cluster's CTAs send
// this one to merge (each its slice of acc and its m and l), and per head
// m, l and alpha; then the Rows type's own bytes (page ids and scales).
struct Layout {
  int row_bytes;  // one padded shared row: an odd number of 16 B chunks
  int slice;      // outputs of a pair each CTA of the cluster merges
  int tile_bytes, q_off, p_off, recv_off, recv_ml_off, ml_off, extra_off,
      total;
  __host__ __device__ Layout(int D, int elem, int tile_rows, int G,
                             int splits, int extra_bytes) {
    const int chunks = D * elem / 16;
    row_bytes = 16 * (chunks | 1);
    slice = (G * D + splits - 1) / splits;
    tile_bytes = tile_rows * row_bytes;
    q_off = STAGES * 2 * tile_bytes;
    p_off = q_off + G * D * 4;
    recv_off = p_off + G * tile_rows * 4;
    recv_ml_off = recv_off + splits * slice * 4;
    ml_off = recv_ml_off + splits * 2 * G * 4;
    extra_off = (ml_off + 3 * G * 4 + 15) / 16 * 16;
    total = extra_off + extra_bytes;
  }
};

// One CTA: pair blockIdx.x = b * Hkv + hk, split blockIdx.y.  Rows is
// constructed by every thread of the CTA; it must provide k_row(r) /
// v_row(r) (the global address of virtual row r, valid once the CTA has
// synchronised after construction) and k_scale(r) / v_scale(r) (1 except
// for int8 pools, valid after the first tile's barrier).
template <typename TQ, typename TKV, int G, typename Rows>
__global__ void __launch_bounds__(THREADS)
    split_kernel(SplitArgs p, typename Rows::Params rp) {
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr int CPT = 2;  // V columns per thread in the P V step
  // (head, column group) items of the P V step per thread: G * D / CPT
  // items over THREADS threads, D at most 32 * VEC.
  constexpr int ITEMS = (G * 32 * VEC / CPT + THREADS - 1) / THREADS;
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x - b * p.Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D, T = p.tile_rows;
  const Layout lay(D, (int)sizeof(TKV), T, G, p.splits, 0);
  const int row0 = split * p.split_rows;
  // The cluster's first barrier phase: arrive now, wait before the first
  // store into another CTA's shared memory (which must have started).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // q (into registers), the page ids (Rows) and kv_len load together.
  constexpr int QREG = 2;  // q elements a thread holds; the rest reload
  float qr[QREG];
#pragma unroll
  for (int k = 0; k < QREG; ++k) {
    const int i = tid + k * THREADS, g = i / D, d = i - g * D;
    if (i < G * D)
      qr[k] = to_f32(((const TQ*)p.q)[b * p.q_sb + (hk * G + g) * p.q_sh + d]);
  }
  Rows rows(rp, p, b, hk, row0, smem + lay.extra_off);
  const int len = min(p.kv_len[b], p.cache_len);
  const int row_end = min(len, row0 + p.split_rows);
  float* q_s = (float*)(smem + lay.q_off);  // [G][D]
  float* p_s = (float*)(smem + lay.p_off);  // [G][T]: the tile's P
  float* recv = (float*)(smem + lay.recv_off);  // [splits][slice]
  float* recv_ml = (float*)(smem + lay.recv_ml_off);  // [splits][2][G]
  float* m_s = (float*)(smem + lay.ml_off);
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();  // the Rows' shared bytes before the first copy

  const int chunks = D / VEC;
  // An empty split (row0 >= row_end) has no tiles and reads nothing.
  const int n_tiles = max(0, (row_end - row0 + T - 1) / T);
  // Copy tile t's live rows of K and V into stage t % STAGES.
  auto load_tile = [&](int t) {
    const int r0 = row0 + t * T;
    const int nrows = min(T, row_end - r0);
    char* kd = smem + (t % STAGES) * 2 * lay.tile_bytes;
    char* vd = kd + lay.tile_bytes;
    const int per = nrows * chunks;
    for (int i = tid; i < 2 * per; i += THREADS) {
      const int kv = i >= per;
      const int j = i - kv * per;
      const int r = j / chunks, c = j - r * chunks;
      const TKV* src = (kv ? rows.v_row(r0 + r) : rows.k_row(r0 + r)) + c * VEC;
      hopper::cp_async16((kv ? vd : kd) + r * lay.row_bytes + 16 * c, src,
                         true);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    hopper::cp_async_commit();
  }
  // q into shared memory (and an int8 pool's page scales) while the first
  // tiles fly.
#pragma unroll
  for (int k = 0; k < QREG; ++k)
    if (tid + k * THREADS < G * D) q_s[tid + k * THREADS] = qr[k];
  for (int i = tid + QREG * THREADS; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(((const TQ*)p.q)[b * p.q_sb + (hk * G + g) * p.q_sh + d]);
  }
  rows.load_scales(row_end);
  // Scores in log2 units, so the softmax takes exp2f.
  const float scale_log2 = p.scale * 1.4426950408889634f;

  const int ncg = D / CPT;  // column groups of one head
  float acc[ITEMS][CPT];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[k][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t visible; every thread is past tile t - 1
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    hopper::cp_async_commit();

    const int r0 = row0 + t * T;
    const int nrows = min(T, row_end - r0);
    const char* ks = smem + (t % STAGES) * 2 * lay.tile_bytes;
    const char* vs = ks + lay.tile_bytes;

    // 1. Scores and the tile's softmax, one warp per head, one lane per
    //    row: each lane dots its K rows (int8 dequantized with the page's
    //    scale as it leaves shared memory) with q, then the warp takes
    //    the tile's max and sum once and writes P and alpha.
    for (int g = warp; g < G; g += WARPS) {
      const float* qg = q_s + g * D;
      float sv[MAX_TILE / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < MAX_TILE / 32; ++i) {
        const int r = lane + 32 * i;
        sv[i] = NEG_INF;
        if (r < nrows) {
          const char* krow = ks + r * lay.row_bytes;
          const float sc = rows.k_scale(r0 + r);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
          for (int c = 0; c < chunks; ++c) {
            float kf[VEC];
            unpack16<TKV>(*(const uint4*)(krow + 16 * c), kf);
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qv = *(const float4*)(qg + c * VEC + e);
              part[0] += qv.x * (kf[e] * sc);
              part[1] += qv.y * (kf[e + 1] * sc);
              part[2] += qv.z * (kf[e + 2] * sc);
              part[3] += qv.w * (kf[e + 3] * sc);
            }
          }
          sv[i] = ((part[0] + part[1]) + (part[2] + part[3])) * scale_log2;
        }
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TILE / 32; ++i) {
        const int r = lane + 32 * i;
        const float pr = r < nrows ? exp2f(sv[i] - m_new) : 0.f;
        // P V takes P with the row's V scale (int8 pools) folded in.
        if (r < T)
          p_s[g * T + r] = r < nrows ? pr * rows.v_scale(r0 + r) : 0.f;
        sum += pr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 2. P V, one thread per (head, two columns): rescale once by alpha,
    //    then add P[r] * V[r] over the tile's rows, four in flight.
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int item = tid + k * THREADS;
      if (item < G * ncg) {
        const int g = item / ncg, col = (item - g * ncg) * CPT;
        const float a = alpha_s[g];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[k][j] *= a;
        const float* pg = p_s + g * T;
        const char* vcol = vs + col * (int)sizeof(TKV);
        int r = 0;
        for (; r + 4 <= nrows; r += 4) {
          float vf[4][CPT];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            load_cols<TKV>(vcol + (r + u) * lay.row_bytes, vf[u]);
#pragma unroll
            for (int j = 0; j < CPT; ++j) vf[u][j] *= pg[r + u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[k][j] += vf[u][j];
        }
        for (; r < nrows; ++r) {
          float vf[CPT];
          load_cols<TKV>(vcol + r * lay.row_bytes, vf);
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[k][j] += vf[j] * pg[r];
        }
      }
    }
  }

  // The merge (top of this file): CTA h owns outputs [h * slice, (h + 1)
  // * slice) of the pair's G * D and merges them in rank (split) order,
  //   M = max m_r, out = sum_r acc_r 2^(m_r - M) / sum_r l_r 2^(m_r - M).
  // An empty split sends m = -1e30, l = 0 and zeros.  m_s and l_s are
  // final since the last tile's barrier.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = p.splits, rank = (int)cluster.block_rank();
  const int slice = lay.slice;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int item = tid + k * THREADS;
    if (item < G * ncg) {
      const int g = item / ncg, e0 = g * D + (item - g * ncg) * CPT;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int h = (e0 + j) / slice;
        cluster.map_shared_rank(recv, h)[rank * slice + e0 + j - h * slice] =
            acc[k][j];
      }
    }
  }
  for (int i = tid; i < n * G; i += THREADS) {
    const int h = i / G, g = i - h * G;
    float* dst = cluster.map_shared_rank(recv_ml, h) + rank * 2 * G;
    dst[g] = m_s[g];
    dst[G + g] = l_s[g];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int i = tid; i < slice; i += THREADS) {
    const int e = rank * slice + i, g = e / D, d = e - g * D;
    if (e >= G * D) break;
    float M = NEG_INF;
    for (int r = 0; r < n; ++r) M = fmaxf(M, recv_ml[r * 2 * G + g]);
    float L = 0.f, a = 0.f;
    for (int r = 0; r < n; ++r) {
      const float w = exp2f(recv_ml[r * 2 * G + g] - M);
      L += recv_ml[r * 2 * G + G + g] * w;
      a += recv[r * slice + i] * w;
    }
    TQ* out = (TQ*)p.out + b * p.o_sb + (hk * G + g) * p.o_sh;
    out[d] = from_f32<TQ>(a / fmaxf(L, 1e-30f));
  }
}

// Launch the kernel on decode_plan's grid, the splits of each pair one
// cluster.  Returns cudaGetLastError's code.
template <typename TQ, typename TKV, int G, typename Rows>
int launch_group(const SplitArgs& p, const typename Rows::Params& rp,
                 int extra_bytes, cudaStream_t s) {
  const Layout lay(p.D, (int)sizeof(TKV), p.tile_rows, G, p.splits,
                   extra_bytes);
  auto kernel = split_kernel<TQ, TKV, G, Rows>;
  if (lay.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        lay.total);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.Hkv, p.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, rp);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename TQ, typename TKV, typename Rows>
int launch(const SplitArgs& p, const typename Rows::Params& rp,
           int extra_bytes, cudaStream_t s) {
  if (p.tile_rows < 1 || p.tile_rows > MAX_TILE || p.splits < 1 ||
      p.splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  switch (p.Hq / p.Hkv) {
    case 1: return launch_group<TQ, TKV, 1, Rows>(p, rp, extra_bytes, s);
    case 2: return launch_group<TQ, TKV, 2, Rows>(p, rp, extra_bytes, s);
    case 3: return launch_group<TQ, TKV, 3, Rows>(p, rp, extra_bytes, s);
    case 4: return launch_group<TQ, TKV, 4, Rows>(p, rp, extra_bytes, s);
    case 5: return launch_group<TQ, TKV, 5, Rows>(p, rp, extra_bytes, s);
    case 6: return launch_group<TQ, TKV, 6, Rows>(p, rp, extra_bytes, s);
    case 7: return launch_group<TQ, TKV, 7, Rows>(p, rp, extra_bytes, s);
    case 8: return launch_group<TQ, TKV, 8, Rows>(p, rp, extra_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode_split
