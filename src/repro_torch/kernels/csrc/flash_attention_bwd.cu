// Flash-attention backward for Hopper (sm_90a), f32 or bf16 operands.
//
// Replaces repro/kernels/flash_attention/bwd_kernel.py::
// flash_attention_bwd_pallas: (dq, dk, dv) of softmax(q k^T * scale + mask) v
// for q (B,Hq,Sq,D), k, v (B,Hkv,Skv,D), from the forward's out and per-row
// logsumexp lse (B,Hq,Sq) and the output gradient dO.  The probabilities
// are recomputed, p = exp(s * scale - lse), never stored; the masks
// (causal, window ki > qi - window, kv_len) and the -1e30 masked score are
// the forward's; GQA maps q head h to kv head h / (Hq/Hkv).
//
// Two passes, as on the TPU, and neither needs atomics, so the result is
// deterministic:
//  * dQ pass (first): one CTA per (b, q head, 64-row q tile).  Its prologue
//    computes delta = rowsum(dO * O) for its rows (the TPU code computes it
//    in jnp outside the pallas_call) and writes it to a scratch vector; a
//    loop walks the 64-row kv tiles the q tile can attend -- the sequential
//    kv grid axis of the Pallas dq kernel -- and accumulates
//    dQ += dS K with dS = p * (dO V^T - delta) * scale.
//  * dK/dV pass: one CTA per (b, kv head, 64-row kv tile).  A loop walks
//    the G = Hq/Hkv q heads of its group and their 64-row q tiles -- the
//    sequential (group, q block) axis of the Pallas dkv kernel, so the
//    group sum needs no atomics -- and accumulates dV += p^T dO and
//    dK += dS^T Q.  It reads delta from the dQ pass (same stream).
// Tiles wholly outside the causal / window / kv_len span are skipped, as
// the TPU kernels skip whole blocks.  Accumulators are f32 registers, and
// each gradient is rounded once to its operand's type on the store.
//
// Bound on an H100: at the smollm-360m training shape (B = 8, Hq = 15,
// Hkv = 5, S = 512, D = 64, causal) the function needs 5 products of
// 2 D FLOP per unmasked (q, k) pair (S, dP, dV, dK, dQ), about 10 GFLOP,
// over about 42 MB of q, k, v, out, dO, lse, dq, dk and dv in bf16: some
// 240 FLOP per byte, under the bf16 ridge (about 295), so HBM bandwidth
// bounds it.  These two passes do 7 products (the dQ pass recomputes S
// and dP) and move the delta scratch besides, the price of needing no
// atomics.
//
// Two paths; the wrapper (flash_plan) picks one by type and alignment:
//
// mma (bf16, D % 8 == 0, base pointers and strides 16-byte aligned): 4
//   warps of 16 rows each, bf16 tiles through cp.async, mma.sync m16n8k16
//   with f32 accumulators and the forward's fragments, swizzle and masks
//   (flash_mma.cuh).  dQ pass: Q and dO are A fragments in registers, K
//   and V double-buffered; S = Q K^T and dP = dO V^T (K, V as they lie),
//   dS = P (dP - delta) scale in f32 registers, dQ += dS K (K by
//   ldmatrix.trans).  dK/dV pass: Q, dO and the q tile's lse and delta
//   double-buffered; S^T = K Q^T and dP^T = V dO^T, dV += P^T dO and
//   dK += dS^T Q (Q, dO by ldmatrix.trans); K and V stay A fragments in
//   registers up to D = 64 and are re-read from shared memory above it,
//   where the dK and dV accumulators need the registers.  A 64-row tile
//   of the other operand is taken 32 columns at a time, so S, dP and their
//   transposes hold 16 registers each.  P and dS, the f32 operands of the
//   second products, enter them split into three bf16 parts that sum to
//   them exactly (flash_mma.cuh::split3; three mma into one f32
//   accumulator), so the kernel sums the plain version's own terms, in
//   another order: 14 products of tensor work against the function's 5.
//   Two parts (16 bits of P and dS) take 10 products, but their
//   products no longer sum the same terms.
// simt (f32 and unaligned bf16): each warp owns 8 rows of the CTA's tile
//   (8 warps); each lane two columns of the 64-wide score tile and D/32
//   columns of the output rows, f32 FMAs.  Shared memory holds the tiles
//   as f32: 82 KB (dQ) and 99 KB (dK/dV) at D = 64, 148 and 165 KB at
//   D = 128.  A head dim D <= 128 that is not a multiple of 32 takes the
//   tiles of the next multiple, zero-filled past D.
//
// q, k, v, out and dO are addressed through element strides (D
// contiguous), so the transposed head views of the model are read in
// place; lse is contiguous; dq, dk and dv are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

constexpr int BQ = 64;   // q tile rows
constexpr int BKV = 64;  // kv tile rows
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 64 / WARPS;  // tile rows per warp
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BKV == 64, "two score columns per lane");

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // (B, Hq, Sq), contiguous
  float* delta;      // (B, Hq, Sq), contiguous scratch
  void* dq;          // (B, Hq, Sq, D), contiguous
  void* dk;          // (B, Hkv, Skv, D), contiguous
  void* dv;
  int B, Hq, Hkv, Sq, Skv, D;  // D: the head dim, <= the tile width
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long d_sb, d_sh, d_ss;
  float scale;
  int causal;
  int window;  // <= 0: no window
  int kv_len;  // keys at >= kv_len are masked (<= Skv)
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool allowed(const BwdArgs& p, int qi, int ki,
                                        int kv_len) {
  bool ok = ki < kv_len;
  if (p.causal) ok = ok && ki <= qi;
  if (p.window > 0) ok = ok && ki > qi - p.window;
  return ok;
}

// Stage rows [r0, r0 + 64) of a (rows, D) operand as f32 at row pitch
// ``pitch``, DT columns wide; rows at >= n and columns at >= D are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long row_stride, int r0, int n,
                                      int DT, int D) {
  for (int i = threadIdx.x; i < 64 * DT; i += THREADS) {
    const int r = i / DT, d = i - r * DT;
    const int row = r0 + r;
    dst[r * pitch + d] =
        row < n && d < D ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

constexpr size_t dq_smem_bytes(int D) {
  // Qs, dOs [64][D]; Ks, Vs [64][D + 1]; dSs [64][64]
  return sizeof(float) * (2 * 64 * (size_t)D + 2 * 64 * (size_t)(D + 1) +
                          64 * 64);
}

constexpr size_t dkv_smem_bytes(int D) {
  // Ks, Vs [64][D]; Qs, dOs [64][D + 1]; Ps, dSs [64][64]; lse, delta [64]
  return sizeof(float) * (2 * 64 * (size_t)D + 2 * 64 * (size_t)(D + 1) +
                          2 * 64 * 64 + 2 * 64);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) dq_kernel(BwdArgs p) {
  constexpr int D = 32 * DPL;  // tile width; the head dim is p.D <= D
  constexpr int KST = D + 1;  // padded K/V rows: lanes read distinct rows
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][D]
  float* dOs = Qs + BQ * D;      // [BQ][D]
  float* Ks = dOs + BQ * D;      // [BKV][KST]
  float* Vs = Ks + BKV * KST;    // [BKV][KST]
  float* dSs = Vs + BKV * KST;   // [BQ][BKV]

  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* o = (const T*)p.out + b * p.o_sb + h * p.o_sh;
  const T* dO = (const T*)p.dout + b * p.d_sb + h * p.d_sh;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  stage(Qs, D, q, p.q_ss, q0, p.Sq, D, p.D);
  stage(dOs, D, dO, p.d_ss, q0, p.Sq, D, p.D);
  __syncthreads();

  // delta = rowsum(dO * O) for this warp's rows, kept in registers and
  // written out for the dK/dV pass; lse likewise.
  float lse[RPW], delta[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + row0 + i;
    float part = 0.f;
    if (qi < p.Sq) {
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        if (lane + 32 * t < p.D)
          part += dOs[(row0 + i) * D + lane + 32 * t] *
                  to_f32(o[qi * p.o_ss + lane + 32 * t]);
    }
    delta[i] = warp_sum(part);
    lse[i] = qi < p.Sq ? p.lse[(size_t)bh * p.Sq + qi] : INFINITY;
    if (qi < p.Sq && lane == 0) p.delta[(size_t)bh * p.Sq + qi] = delta[i];
  }

  float acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;

  // The kv tiles some row of this q tile can attend (the forward's rule).
  const int kv_len = min(p.kv_len, p.Skv);
  int t_end = (kv_len + BKV - 1) / BKV;
  if (p.causal) t_end = min(t_end, (q0 + BQ - 1) / BKV + 1);
  int t_begin = 0;
  if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / BKV;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage(Ks, KST, k, p.k_ss, k0, p.Skv, D, p.D);
    stage(Vs, KST, v, p.v_ss, k0, p.Skv, D, p.D);
    __syncthreads();

    float s[RPW][2], dp[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * KST + d], kb = Ks[(lane + 32) * KST + d];
      const float va = Vs[lane * KST + d], vb = Vs[(lane + 32) * KST + d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float qv = Qs[(row0 + i) * D + d];
        const float ov = dOs[(row0 + i) * D + d];
        s[i][0] += qv * ka;
        s[i][1] += qv * kb;
        dp[i][0] += ov * va;
        dp[i][1] += ov * vb;
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = lane + 32 * c;
        const float sc =
            allowed(p, qi, k0 + kj, kv_len) ? s[i][c] * p.scale : NEG_INF;
        const float pr = expf(sc - lse[i]);
        dSs[(row0 + i) * BKV + kj] = pr * (dp[i][c] - delta[i]) * p.scale;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float kv[DPL];
#pragma unroll
      for (int tt = 0; tt < DPL; ++tt) kv[tt] = Ks[j * KST + lane + 32 * tt];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float ds = dSs[(row0 + i) * BKV + j];
#pragma unroll
        for (int tt = 0; tt < DPL; ++tt) acc[i][tt] += ds * kv[tt];
      }
    }
    __syncwarp();  // dSs is rewritten by this warp in the next tile
  }

  T* dq = (T*)p.dq + ((size_t)bh * p.Sq) * p.D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int tt = 0; tt < DPL; ++tt)
      if (lane + 32 * tt < p.D)
        dq[(size_t)qi * p.D + lane + 32 * tt] = from_f32<T>(acc[i][tt]);
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) dkv_kernel(BwdArgs p) {
  constexpr int D = 32 * DPL;  // tile width; the head dim is p.D <= D
  constexpr int QST = D + 1;  // padded Q/dO rows: lanes read distinct rows
  extern __shared__ float smem[];
  float* Ks = smem;              // [BKV][D]
  float* Vs = Ks + BKV * D;      // [BKV][D]
  float* Qs = Vs + BKV * D;      // [BQ][QST]
  float* dOs = Qs + BQ * QST;    // [BQ][QST]
  float* Ps = dOs + BQ * QST;    // [BKV][BQ], p transposed
  float* dSs = Ps + BKV * BQ;    // [BKV][BQ], dS transposed
  float* lse_s = dSs + BKV * BQ; // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / p.Hkv, hk = bh - b * p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  stage(Ks, D, k, p.k_ss, k0, p.Skv, D, p.D);
  stage(Vs, D, v, p.v_ss, k0, p.Skv, D, p.D);

  float dk[RPW][DPL], dv[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int t = 0; t < DPL; ++t) dk[i][t] = dv[i][t] = 0.f;

  // The q tiles with a row that attends some key of this kv tile.
  const int kv_len = min(p.kv_len, p.Skv);
  const int nq = (p.Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = k0 < kv_len ? nq : 0;
  if (p.causal) qt_begin = k0 / BQ;
  if (p.window > 0) qt_end = min(qt_end, (k0 + BKV - 2 + p.window) / BQ + 1);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t hrow = ((size_t)b * p.Hq + h) * p.Sq;
    const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
    const T* dO = (const T*)p.dout + b * p.d_sb + h * p.d_sh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      stage(Qs, QST, q, p.q_ss, q0, p.Sq, D, p.D);
      stage(dOs, QST, dO, p.d_ss, q0, p.Sq, D, p.D);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < p.Sq ? p.lse[hrow + qi] : INFINITY;
        delta_s[threadIdx.x] = qi < p.Sq ? p.delta[hrow + qi] : 0.f;
      }
      __syncthreads();

      // Transposed score tile: this warp's kv rows x the lane's q columns.
      float s[RPW][2], dp[RPW][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = Qs[lane * QST + d], qb = Qs[(lane + 32) * QST + d];
        const float oa = dOs[lane * QST + d], ob = dOs[(lane + 32) * QST + d];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float kv = Ks[(row0 + i) * D + d];
          const float vv = Vs[(row0 + i) * D + d];
          s[i][0] += kv * qa;
          s[i][1] += kv * qb;
          dp[i][0] += vv * oa;
          dp[i][1] += vv * ob;
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qj = lane + 32 * c;
        const float l = lse_s[qj], dl = delta_s[qj];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float sc = allowed(p, q0 + qj, k0 + row0 + i, kv_len)
                               ? s[i][c] * p.scale
                               : NEG_INF;
          const float pr = expf(sc - l);
          Ps[(row0 + i) * BQ + qj] = pr;
          dSs[(row0 + i) * BQ + qj] = pr * (dp[i][c] - dl) * p.scale;
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float qv[DPL], ov[DPL];
#pragma unroll
        for (int tt = 0; tt < DPL; ++tt) {
          qv[tt] = Qs[j * QST + lane + 32 * tt];
          ov[tt] = dOs[j * QST + lane + 32 * tt];
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float pr = Ps[(row0 + i) * BQ + j];
          const float ds = dSs[(row0 + i) * BQ + j];
#pragma unroll
          for (int tt = 0; tt < DPL; ++tt) {
            dv[i][tt] += pr * ov[tt];
            dk[i][tt] += ds * qv[tt];
          }
        }
      }
      __syncwarp();  // Ps / dSs are rewritten by this warp next tile
    }
  }

  T* dkp = (T*)p.dk + ((size_t)bh * p.Skv) * p.D;
  T* dvp = (T*)p.dv + ((size_t)bh * p.Skv) * p.D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int kj = k0 + row0 + i;
    if (kj >= p.Skv) continue;
#pragma unroll
    for (int tt = 0; tt < DPL; ++tt) {
      if (lane + 32 * tt >= p.D) continue;
      dkp[(size_t)kj * p.D + lane + 32 * tt] = from_f32<T>(dk[i][tt]);
      dvp[(size_t)kj * p.D + lane + 32 * tt] = from_f32<T>(dv[i][tt]);
    }
  }
}

template <typename T, int DPL>
int launch(const BwdArgs& p, dim3 dq_grid, dim3 dkv_grid,
           cudaStream_t stream) {
  const size_t dq_smem = dq_smem_bytes(32 * DPL);
  const size_t dkv_smem = dkv_smem_bytes(32 * DPL);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel<T, DPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, DPL><<<dq_grid, THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<T, DPL><<<dkv_grid, THREADS, dkv_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// plan: the wrapper's flash_plan, (d_tile, dQ grid x, y, dK/dV grid x, y).
template <typename T>
int dispatch(const BwdArgs& p, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 dq(plan[1], plan[2]), dkv(plan[3], plan[4]);
  if (p.D < 1 || plan[0] < p.D) return (int)cudaErrorInvalidValue;
  switch (plan[0]) {  // the tile: 32 columns a lane group
    case 32:
      return launch<T, 1>(p, dq, dkv, s);
    case 64:
      return launch<T, 2>(p, dq, dkv, s);
    case 96:
      return launch<T, 3>(p, dq, dkv, s);
    case 128:
      return launch<T, 4>(p, dq, dkv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// --- mma path (bf16, 16-byte-aligned operands) ------------------------------
// The same two passes on mma.sync; P and dS enter their products split
// into three exact bf16 parts (flash_mma.cuh::split3).  Each warp owns 16 rows of the CTA's
// 64; a 64-row tile of the other operand is taken 32 columns at a time,
// so S, dP and their transposes take 16 accumulator registers each.

// dQ pass: grid (B * Hq, q tiles), under causal heaviest first.  Q and dO
// as A fragments in registers; K and V double-buffered; S = Q K^T and
// dP = dO V^T with K and V read as they lie, dS = P (dP - delta) scale,
// dQ += dS K with K read transposed.
template <int DT>
__global__ void __launch_bounds__(flash_mma::THREADS)
    dq_mma_kernel(BwdArgs p) {
  using namespace flash_mma;
  using TL = Tile<DT>;
  extern __shared__ __align__(128) unsigned char smem_dq[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_dq);
  bf16* sdO = sQ + TL::ELEMS;
  bf16* sK = sdO + TL::ELEMS;     // [2][tile]
  bf16* sV = sK + 2 * TL::ELEMS;  // [2][tile]

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* q = (const bf16*)p.q + b * p.q_sb + h * p.q_sh;
  const bf16* o = (const bf16*)p.out + b * p.o_sb + h * p.o_sh;
  const bf16* dO = (const bf16*)p.dout + b * p.d_sb + h * p.d_sh;
  const bf16* k = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh;

  const int kv_len = min(p.kv_len, p.Skv);
  int t_end = (kv_len + ROWS - 1) / ROWS;
  if (p.causal) t_end = min(t_end, (q0 + ROWS - 1) / ROWS + 1);
  int t_begin = 0;
  if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / ROWS;

  load_tile<DT>(sQ, q, p.q_ss, q0, p.Sq, p.D);
  load_tile<DT>(sdO, dO, p.d_ss, q0, p.Sq, p.D);
  if (t_begin < t_end) {
    load_tile<DT>(sK, k, p.k_ss, t_begin * ROWS, p.Skv, p.D);
    load_tile<DT>(sV, v, p.v_ss, t_begin * ROWS, p.Skv, p.D);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) for the warp's 16 rows, written out for the
  // dK/dV pass; rows g and g + 8 keep theirs, and their lse.
  float dl[2], ls[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int qi = q0 + r0 + i;
    float part = 0.f;
    if (qi < p.Sq)
      for (int c = lane; c < p.D; c += 32)
        part += to_f32(dO[qi * p.d_ss + c]) * to_f32(o[qi * p.o_ss + c]);
    const float d = warp_sum(part);
    if (qi < p.Sq && lane == 0) p.delta[(size_t)bh * p.Sq + qi] = d;
    if ((i & 7) == g) dl[i >> 3] = d;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    ls[r] = qi < p.Sq ? p.lse[(size_t)bh * p.Sq + qi] : INFINITY;
  }

  uint32_t qf[TL::KS][4], df[TL::KS][4];
  float dq[TL::NT][4];
#pragma unroll
  for (int n = 0; n < TL::NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<DT>(sK + (buf ^ 1) * TL::ELEMS, k, p.k_ss, (t + 1) * ROWS,
                    p.Skv, p.D);
      load_tile<DT>(sV + (buf ^ 1) * TL::ELEMS, v, p.v_ss, (t + 1) * ROWS,
                    p.Skv, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < TL::KS; ++kk) {
        frag_a<DT>(qf[kk], sQ, r0, kk);
        frag_a<DT>(df[kk], sdO, r0, kk);
      }
    }
    const bf16* cK = sK + buf * TL::ELEMS;
    const bf16* cV = sV + buf * TL::ELEMS;
    const int k0 = t * ROWS;
    const bool edge = crosses_edge(q0, k0, kv_len, p.causal, p.window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TL::KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t kb[4], vb[4];
          frag_b_rows<DT>(kb, cK, half * 32 + jp * 16, kk);
          frag_b_rows<DT>(vb, cV, half * 32 + jp * 16, kk);
          mma_bf16_16816(s[2 * jp], qf[kk], kb[0], kb[1]);
          mma_bf16_16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
          mma_bf16_16816(dp[2 * jp], df[kk], vb[0], vb[1]);
          mma_bf16_16816(dp[2 * jp + 1], df[kk], vb[2], vb[3]);
        }
      }
      // dS = P (dP - delta) scale, P = exp(S scale - lse), in place of dp.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = s[j][e] * p.scale;
          if (edge && !visible(q0 + r0 + g + ((e >> 1) << 3),
                               k0 + half * 32 + j * 8 + 2 * t4 + (e & 1),
                               kv_len, p.causal, p.window))
            sc = NEG_INF;
          const float pr = expf(sc - ls[e >> 1]);
          dp[j][e] = pr * (dp[j][e] - dl[e >> 1]) * p.scale;
        }
      // dQ += dS K over the half's 32 keys, 16 a step.
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t hi[4], mi[4], lo[4];
        acc_to_a3(dp[2 * ks], dp[2 * ks + 1], hi, mi, lo);
#pragma unroll
        for (int jp = 0; jp < TL::NT / 2; ++jp) {
          uint32_t kb[4];
          frag_b_cols<DT>(kb, cK, half * 32 + ks * 16, jp);
          mma_split3(dq[2 * jp], hi, mi, lo, kb[0], kb[1]);
          mma_split3(dq[2 * jp + 1], hi, mi, lo, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  bf16* dqp = (bf16*)p.dq + (size_t)bh * p.Sq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < TL::NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.D)
        store2(dqp + (size_t)qi * p.D + col, dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

// dK/dV pass: grid (B * Hkv, kv tiles).  Walks the G q heads of its group
// and their q tiles in order (no atomics); Q, dO and the q tile's lse and
// delta double-buffered.  S^T = K Q^T and dP^T = V dO^T (Q and dO read as
// they lie), P^T, dS^T in place, dV += P^T dO and dK += dS^T Q (dO and Q
// read transposed).  K and V stay A fragments in registers up to 64
// columns; wider tiles re-read them from shared memory for each product,
// keeping the registers for the dK and dV accumulators.
template <int DT>
__global__ void __launch_bounds__(flash_mma::THREADS)
    dkv_mma_kernel(BwdArgs p) {
  using namespace flash_mma;
  using TL = Tile<DT>;
  constexpr bool KV_REGS = DT <= 64;
  constexpr int KF = KV_REGS ? TL::KS : 1;
  extern __shared__ __align__(128) unsigned char smem_dkv[];
  bf16* sK = reinterpret_cast<bf16*>(smem_dkv);
  bf16* sV = sK + TL::ELEMS;
  bf16* sQ = sV + TL::ELEMS;       // [2][tile]
  bf16* sdO = sQ + 2 * TL::ELEMS;  // [2][tile]
  float* sL = reinterpret_cast<float*>(sdO + 2 * TL::ELEMS);  // [2][64] lse
  float* sD = sL + 2 * ROWS;                                  // [2][64] delta

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv, hk = bh - b * p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int k0 = blockIdx.y * ROWS;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* k = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh;

  // The q tiles with a row that attends some key of this kv tile.
  const int kv_len = min(p.kv_len, p.Skv);
  const int nq = (p.Sq + ROWS - 1) / ROWS;
  int qt_begin = 0, qt_end = k0 < kv_len ? nq : 0;
  if (p.causal) qt_begin = k0 / ROWS;
  if (p.window > 0) qt_end = min(qt_end, (k0 + ROWS - 2 + p.window) / ROWS + 1);
  const int span = max(0, qt_end - qt_begin);
  const int items = G * span;  // (q head of the group, q tile) in order

  // Item ``it``'s Q and dO tiles (cp.async) and lse / delta (plain loads)
  // into buffer ``buf``.
  auto stage = [&](int it, int buf) {
    const int h = hk * G + it / span;
    const int q0 = (qt_begin + it % span) * ROWS;
    load_tile<DT>(sQ + buf * TL::ELEMS,
                  (const bf16*)p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                  p.Sq, p.D);
    load_tile<DT>(sdO + buf * TL::ELEMS,
                  (const bf16*)p.dout + b * p.d_sb + h * p.d_sh, p.d_ss, q0,
                  p.Sq, p.D);
    if (threadIdx.x < ROWS) {
      const int qi = q0 + threadIdx.x;
      const size_t hrow = ((size_t)b * p.Hq + h) * p.Sq;
      sL[buf * ROWS + threadIdx.x] = qi < p.Sq ? p.lse[hrow + qi] : INFINITY;
      sD[buf * ROWS + threadIdx.x] = qi < p.Sq ? p.delta[hrow + qi] : 0.f;
    }
  };

  load_tile<DT>(sK, k, p.k_ss, k0, p.Skv, p.D);
  load_tile<DT>(sV, v, p.v_ss, k0, p.Skv, p.D);
  if (items > 0) stage(0, 0);
  cp_async_commit();

  uint32_t kf[KF][4], vf[KF][4];
  float dk[TL::NT][4], dv[TL::NT][4];
#pragma unroll
  for (int n = 0; n < TL::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    if (it + 1 < items) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (KV_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        frag_a<DT>(kf[kk], sK, r0, kk);
        frag_a<DT>(vf[kk], sV, r0, kk);
      }
    }
    const int q0 = (qt_begin + it % span) * ROWS;
    const bf16* cQ = sQ + buf * TL::ELEMS;
    const bf16* cdO = sdO + buf * TL::ELEMS;
    const float* cL = sL + buf * ROWS;
    const float* cD = sD + buf * ROWS;
    const bool edge = crosses_edge(q0, k0, kv_len, p.causal, p.window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TL::KS; ++kk) {
        uint32_t ka[4], va[4];
        const uint32_t* ak = ka;
        const uint32_t* av = va;
        if constexpr (KV_REGS) {
          ak = kf[kk];
          av = vf[kk];
        } else {
          frag_a<DT>(ka, sK, r0, kk);
          frag_a<DT>(va, sV, r0, kk);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t qb[4], ob[4];
          frag_b_rows<DT>(qb, cQ, half * 32 + jp * 16, kk);
          frag_b_rows<DT>(ob, cdO, half * 32 + jp * 16, kk);
          mma_bf16_16816(st[2 * jp], ak, qb[0], qb[1]);
          mma_bf16_16816(st[2 * jp + 1], ak, qb[2], qb[3]);
          mma_bf16_16816(dpt[2 * jp], av, ob[0], ob[1]);
          mma_bf16_16816(dpt[2 * jp + 1], av, ob[2], ob[3]);
        }
      }
      // P^T into st, dS^T into dpt: rows are keys, columns queries.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = half * 32 + j * 8 + 2 * t4 + (e & 1);
          float sc = st[j][e] * p.scale;
          if (edge && !visible(q0 + qc, k0 + r0 + g + ((e >> 1) << 3),
                               kv_len, p.causal, p.window))
            sc = NEG_INF;
          const float pr = expf(sc - cL[qc]);
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - cD[qc]) * p.scale;
        }
      // dV += P^T dO and dK += dS^T Q over the half's 32 queries.
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t phi[4], pmi[4], plo[4], shi[4], smi[4], slo[4];
        acc_to_a3(st[2 * ks], st[2 * ks + 1], phi, pmi, plo);
        acc_to_a3(dpt[2 * ks], dpt[2 * ks + 1], shi, smi, slo);
#pragma unroll
        for (int jp = 0; jp < TL::NT / 2; ++jp) {
          uint32_t ob[4], qb[4];
          frag_b_cols<DT>(ob, cdO, half * 32 + ks * 16, jp);
          frag_b_cols<DT>(qb, cQ, half * 32 + ks * 16, jp);
          mma_split3(dv[2 * jp], phi, pmi, plo, ob[0], ob[1]);
          mma_split3(dv[2 * jp + 1], phi, pmi, plo, ob[2], ob[3]);
          mma_split3(dk[2 * jp], shi, smi, slo, qb[0], qb[1]);
          mma_split3(dk[2 * jp + 1], shi, smi, slo, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  bf16* dkp = (bf16*)p.dk + (size_t)bh * p.Skv * p.D;
  bf16* dvp = (bf16*)p.dv + (size_t)bh * p.Skv * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + g + 8 * r;
    if (kj >= p.Skv) continue;
#pragma unroll
    for (int n = 0; n < TL::NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col >= p.D) continue;
      store2(dkp + (size_t)kj * p.D + col, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dvp + (size_t)kj * p.D + col, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int DT>
int launch_mma(const BwdArgs& p, dim3 dq_grid, dim3 dkv_grid,
               cudaStream_t stream) {
  using TL = flash_mma::Tile<DT>;
  constexpr size_t dq_smem = 6 * TL::ELEMS * sizeof(__nv_bfloat16);
  constexpr size_t dkv_smem =
      6 * TL::ELEMS * sizeof(__nv_bfloat16) + 4 * flash_mma::ROWS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_mma_kernel<DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  dq_mma_kernel<DT><<<dq_grid, flash_mma::THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_mma_kernel<DT><<<dkv_grid, flash_mma::THREADS, dkv_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_mma(const BwdArgs& p, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 dq(plan[1], plan[2]), dkv(plan[3], plan[4]);
  if (p.D < 8 || p.D % 8 || plan[0] < p.D) return (int)cudaErrorInvalidValue;
  switch (plan[0]) {  // the tile: the head dim rounded up to 16
    case 16:
      return launch_mma<16>(p, dq, dkv, s);
    case 32:
      return launch_mma<32>(p, dq, dkv, s);
    case 48:
      return launch_mma<48>(p, dq, dkv, s);
    case 64:
      return launch_mma<64>(p, dq, dkv, s);
    case 80:
      return launch_mma<80>(p, dq, dkv, s);
    case 96:
      return launch_mma<96>(p, dq, dkv, s);
    case 112:
      return launch_mma<112>(p, dq, dkv, s);
    case 128:
      return launch_mma<128>(p, dq, dkv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, const int* dims,
                  const long long* strides, float scale, int causal,
                  int window, int kv_len) {
  BwdArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.Sq = dims[3];
  p.Skv = dims[4];
  p.D = dims[5];
  long long* dst[15] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh,
                        &p.k_ss, &p.v_sb, &p.v_sh, &p.v_ss, &p.o_sb,
                        &p.o_sh, &p.o_ss, &p.d_sb, &p.d_sh, &p.d_ss};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[i];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.kv_len = kv_len;
  return p;
}

}  // namespace

extern "C" {

// dims: B, Hq, Hkv, Sq, Skv, D.  strides: (batch, head, row) element
// strides of q, k, v, out and dout, in that order.  plan: the wrapper's
// flash_plan, (d_tile, dQ grid x, y, dK/dV grid x, y), launched as
// given.  delta is (B, Hq, Sq) f32 scratch the dQ pass fills and the
// dK/dV pass reads.
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* out, const float* dout,
                            const float* lse, float* delta, float* dq,
                            float* dk, float* dv, const int* dims,
                            const long long* strides, const int* plan,
                            float scale, int causal, int window, int kv_len,
                            void* stream) {
  return dispatch<float>(make_args(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, dims, strides, scale, causal, window,
                                   kv_len),
                         plan, stream);
}

int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v,
                             const __nv_bfloat16* out,
                             const __nv_bfloat16* dout, const float* lse,
                             float* delta, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv,
                             const int* dims, const long long* strides,
                             const int* plan, float scale, int causal,
                             int window, int kv_len, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_args(q, k, v, out, dout, lse, delta, dq, dk, dv, dims, strides,
                scale, causal, window, kv_len),
      plan, stream);
}

// The tensor-core path: bf16, D % 8 == 0, every base pointer and
// stride a multiple of 16 bytes (the wrapper's flash_plan checks).
int flash_attention_bwd_mma_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse,
    float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
    const int* dims, const long long* strides, const int* plan, float scale,
    int causal, int window, int kv_len, void* stream) {
  return dispatch_mma(make_args(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                dims, strides, scale, causal, window, kv_len),
                      plan, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
