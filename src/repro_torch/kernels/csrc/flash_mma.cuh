// Pieces the flash-attention forward and backward share on their bf16
// tensor-core path (mma.sync m16n8k16, f32 accumulators): 64-row bf16
// tiles in shared memory, filled by 16-byte cp.async with zero-fill and
// XOR-swizzled against ldmatrix bank conflicts; fragment loads; the
// split of an f32 accumulator fragment into two (forward) or three
// (backward) bf16 A fragments; the attention mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int ROWS = 64;     // rows of every tile: q, kv
constexpr int THREADS = 128; // 4 warps, 16 tile rows each

// A tile of 64 rows holds DT columns (the head dim rounded up to 16) in
// rows of 64 * ceil(DT / 64) elements, so every row is a whole number of
// 128-byte lines.  16-byte chunk c of row r sits at chunk c ^ (r % 8):
// the 8 rows one ldmatrix phase reads hit 8 different bank groups.
template <int DT>
struct Tile {
  static constexpr int ROW = 64 * ((DT + 63) / 64);  // elements a row
  static constexpr int ELEMS = ROWS * ROW;
  static constexpr int KS = DT / 16;  // k16 steps over the head dim
  static constexpr int NT = DT / 8;   // n8 tiles over the head dim
  static_assert(DT % 16 == 0 && DT <= 128, "DT: a multiple of 16 <= 128");
};

__device__ __forceinline__ int swz(int row, int chunk, int row_elems) {
  return row * row_elems + ((chunk ^ (row & 7)) << 3);
}

// Rows [r0, r0 + 64) of an (n, D) bf16 operand with row stride ``rs``
// (elements) into a tile; rows at >= n and columns at >= D (D % 8 == 0)
// are zero-filled.  Issues the copies; the caller commits and waits.
template <int DT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int r0, int n,
                                          int D) {
  constexpr int CH = DT / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int row = r0 + r;
    const bool ok = row < n && c * 8 < D;
    cp_async16(dst + swz(r, c, Tile<DT>::ROW),
               ok ? src + (long long)row * rs + c * 8 : src, ok);
  }
}

// The A fragment (16 rows x k16) at rows [r0, r0 + 16), columns
// [16 kk, 16 kk + 16) of a tile: matrices (rows lo, k lo), (rows hi,
// k lo), (rows lo, k hi), (rows hi, k hi).
template <int DT>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* tile, int r0,
                                       int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4),
                            Tile<DT>::ROW));
}

// B fragments of two n8 tiles for a product with the tile's rows as the
// n index and its columns as k (S = Q K^T: K as it lies): rows
// [n0, n0 + 16), columns [16 kk, 16 kk + 16).  b[0], b[1] feed n8 tile
// rows [n0, n0 + 8), b[2], b[3] rows [n0 + 8, n0 + 16).
template <int DT>
__device__ __forceinline__ void frag_b_rows(uint32_t* b, const bf16* tile,
                                            int n0, int kk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldmatrix_x4(b, tile + swz(n0 + ((mi >> 1) << 3) + (lane & 7),
                            2 * kk + (mi & 1), Tile<DT>::ROW));
}

// B fragments of two n8 tiles for a product with the tile's rows as k
// and its columns as n (P V: V as it lies, read transposed): rows
// [k0, k0 + 16), columns [16 jp, 16 jp + 16).  b[0], b[1] feed columns
// [16 jp, 16 jp + 8), b[2], b[3] columns [16 jp + 8, 16 jp + 16).
template <int DT>
__device__ __forceinline__ void frag_b_cols(uint32_t* b, const bf16* tile,
                                            int k0, int jp) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldmatrix_x4_trans(b, tile + swz(k0 + ((mi & 1) << 3) + (lane & 7),
                                  2 * jp + (mi >> 1), Tile<DT>::ROW));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values as bf16 hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps about 16 bits of x's mantissa, so a product fed hi and lo in two
// mma into one f32 accumulator sums x, not bf16(x).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// An m16 x k16 A fragment pair (hi, lo) from two m16n8 accumulator tiles
// c0 (k columns 0-7) and c1 (k 8-15): the C layout of m16n8 (row g,
// columns 2t, 2t + 1; row g + 8) is the A layout of m16k16 (a0: row g,
// k 2t; a1: row g + 8; a2, a3: the same at k + 8).
__device__ __forceinline__ void acc_to_a(const float* c0, const float* c1,
                                         uint32_t* hi, uint32_t* lo) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// c += (hi + lo) b: the split A operand in two mma.
__device__ __forceinline__ void mma_split(float* c, const uint32_t* hi,
                                          const uint32_t* lo, uint32_t b0,
                                          uint32_t b1) {
  mma_bf16_16816(c, hi, b0, b1);
  mma_bf16_16816(c, lo, b0, b1);
}

// Two f32 values as three bf16 parts, hi = bf16(x), mi = bf16(x - hi),
// lo = bf16(x - hi - mi): each part takes the next 8 bits of x's 24-bit
// mantissa, so hi + mi + lo == x exactly (every difference is exact in
// f32), and a product fed the three parts sums x's own terms.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = pack(h);
  mi = pack(m);
  lo = pack(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// acc_to_a with the three-part split.
__device__ __forceinline__ void acc_to_a3(const float* c0, const float* c1,
                                          uint32_t* hi, uint32_t* mi,
                                          uint32_t* lo) {
  split3(c0[0], c0[1], hi[0], mi[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mi[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mi[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mi[3], lo[3]);
}

// c += (hi + mi + lo) b in three mma, the smallest part first.
__device__ __forceinline__ void mma_split3(float* c, const uint32_t* hi,
                                           const uint32_t* mi,
                                           const uint32_t* lo, uint32_t b0,
                                           uint32_t b1) {
  mma_bf16_16816(c, lo, b0, b1);
  mma_bf16_16816(c, mi, b0, b1);
  mma_bf16_16816(c, hi, b0, b1);
}

// Reductions over the 4 lanes of a quad, which hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The reference's mask: key ki is visible to query qi.
__device__ __forceinline__ bool visible(int qi, int ki, int kv_len,
                                        int causal, int window) {
  bool ok = ki < kv_len;
  if (causal) ok = ok && ki <= qi;
  if (window > 0) ok = ok && ki > qi - window;
  return ok;
}

// Whether the (q tile at q0, kv tile at k0) pair holds a masked pair at
// all; interior tiles skip the mask arithmetic.
__device__ __forceinline__ bool crosses_edge(int q0, int k0, int kv_len,
                                             int causal, int window) {
  return k0 + ROWS > kv_len || (causal && k0 + ROWS - 1 > q0) ||
         (window > 0 && k0 <= q0 + ROWS - 1 - window);
}

__device__ __forceinline__ void store2(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace flash_mma
