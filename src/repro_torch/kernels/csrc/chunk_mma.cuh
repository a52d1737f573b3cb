// Warp-level products of shared-memory tiles on the tensor cores, shared by
// the recurrent kernels' chunk products (mamba2_scan.cu, wkv6.cu).
//
// mma_tiles runs a warp's blocks of an (M x K) (K x N) product whose
// operands are read through two accessors, in one of two modes:
//   * float accumulators: mma.sync m16n8k8 in TF32.  An operand marked
//     split is cut into hi = rna(x) and lo = rna(x - hi) (3xTF32, as
//     csrc/conv_mma.cuh); an exact one (a bf16 value is exact in TF32) is
//     its own hi.  Each k8 step's products sum in fresh fragments (the
//     small terms in one, hi.hi in another) that f32 adds fold into the
//     accumulators, since the tensor cores' accumulation truncates.
//   * double accumulators: mma.sync m8n8k4 on the FP64 tensor cores, four
//     to a 16 x 8 x 8 step, products and sums exact in f64.  For f32
//     operands whose outputs cancel: 3xTF32's truncation is about 2^-22 of
//     a step's largest product.
// Both modes leave lane l (g = l/4, t = l%4) holding {C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1]} of each 16 x 8 output block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace chunk_mma {

// x = hi + lo + O(2^-22 |x|), both TF32 rounded to nearest (ties away),
// as cvt.rna.tf32.f32 gives them; an exact operand (SPLIT false) is its
// own hi.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (SPLIT) {
    hi = rna_tf32(x);
    lo = rna_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// One warp: acc[mi][nj] += A B over k in [k0, k1) (a multiple of 8), the
// 16-row block rb0 + mi * rbs and the 8-column block nb0 + nj * nbs of the
// output, blocks at or past n_rb / n_nb skipped (warp-uniform).  A(r, k)
// and B(k, c) read shared memory.  Lane l, g = l/4, t = l%4, holds acc =
// {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]} of each block.  Acc
// float: TF32, SA / SB split that operand, each k8 step's products summed
// in fresh fragments added to acc in f32.  Acc double: four f64 mma a step
// (rows g and g + 8, k t and t + 4) straight into acc.
template <int MI, int NJ, bool SA, bool SB, typename Acc, typename FA,
          typename FB>
__device__ __forceinline__ void mma_tiles(Acc (&acc)[MI][NJ][4], FA A, FB B,
                                          int rb0, int rbs, int n_rb,
                                          int nb0, int nbs, int n_nb, int k0,
                                          int k1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (std::is_same<Acc, double>::value) {
    for (int kk = k0; kk < k1; kk += 8) {
      double a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = 16 * (rb0 + mi * rbs) + g;
        if (rb0 + mi * rbs < n_rb) {
          a[mi][0] = A(r, kk + t);
          a[mi][1] = A(r + 8, kk + t);
          a[mi][2] = A(r, kk + t + 4);
          a[mi][3] = A(r + 8, kk + t + 4);
        }
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int nb = nb0 + nj * nbs;
        if (nb >= n_nb) continue;
        const int c = 8 * nb + g;
        const double b0 = B(kk + t, c), b1 = B(kk + t + 4, c);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (rb0 + mi * rbs >= n_rb) continue;
          hopper::mma_f64_884(acc[mi][nj], a[mi][0], b0);
          hopper::mma_f64_884(acc[mi][nj], a[mi][2], b1);
          hopper::mma_f64_884(acc[mi][nj] + 2, a[mi][1], b0);
          hopper::mma_f64_884(acc[mi][nj] + 2, a[mi][3], b1);
        }
      }
    }
    return;
  }
  for (int kk = k0; kk < k1; kk += 8) {
    uint32_t ah[MI][4], al[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r = 16 * (rb0 + mi * rbs) + g;
      if (rb0 + mi * rbs < n_rb) {
        split_tf32<SA>(A(r, kk + t), ah[mi][0], al[mi][0]);
        split_tf32<SA>(A(r + 8, kk + t), ah[mi][1], al[mi][1]);
        split_tf32<SA>(A(r, kk + t + 4), ah[mi][2], al[mi][2]);
        split_tf32<SA>(A(r + 8, kk + t + 4), ah[mi][3], al[mi][3]);
      }
    }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int nb = nb0 + nj * nbs;
      if (nb >= n_nb) continue;
      const int c = 8 * nb + g;
      uint32_t bh[2], bl[2];
      split_tf32<SB>(B(kk + t, c), bh[0], bl[0]);
      split_tf32<SB>(B(kk + t + 4, c), bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (rb0 + mi * rbs >= n_rb) continue;
        // The small terms and the main product in two fresh fragments
        // (independent mma chains), added to acc in f32.
        float dl[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
        if (SA) hopper::mma_tf32_1688(dl, al[mi], bh[0], bh[1]);
        if (SB) hopper::mma_tf32_1688(dl, ah[mi], bl[0], bl[1]);
        hopper::mma_tf32_1688(dh, ah[mi], bh[0], bh[1]);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mi][nj][v] += dh[v] + dl[v];
      }
    }
  }
}

}  // namespace chunk_mma
