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
// the TPU kernels skip whole blocks.  Each warp owns 8 rows of the CTA's
// tile (8 warps); each lane two columns of the 64-wide score tile and D/32
// columns of the output rows; accumulators are f32 registers, and each
// gradient is rounded once to its operand's type on the store.  Shared
// memory holds the tiles as f32: 82 KB (dQ) and 99 KB (dK/dV) at D = 64,
// 148 and 165 KB at D = 128, so the launch raises the dynamic limit.  A
// head dim D <= 128 that is not a multiple of 32 (the smoke configs' 16,
// zamba2-7b's 112) takes the tiles of the next multiple, 32 * DPL columns,
// as the forward does: the columns past D are zero-filled on load, so they
// add nothing to a score or to delta, and are never stored.
//
// Bound on an H100: at the smollm-360m training shape (B = 8, Hq = 15,
// Hkv = 5, S = 512, D = 64, causal) the function needs 5 products of
// 2 D FLOP per unmasked (q, k) pair (S, dP, dV, dK, dQ), about 10 GFLOP,
// over about 42 MB of q, k, v, out, dO, lse, dq, dk and dv in bf16: some
// 240 FLOP per byte, under the bf16 ridge (about 295), so HBM bandwidth
// bounds it.  These two passes do 7 products (the dQ pass recomputes S
// and dP) and move the delta scratch besides, the price of needing no
// atomics.  This kernel is a SIMT loop with f32 FMAs, far from either
// bound; wgmma and TMA are later work.
//
// q, k, v, out and dO are addressed through element strides (D
// contiguous), so the transposed head views of the model are read in
// place; lse is contiguous; dq, dk and dv are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
int launch(const BwdArgs& p, cudaStream_t stream) {
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
  dim3 dq_grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  dq_kernel<T, DPL><<<dq_grid, THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 dkv_grid((p.Skv + BKV - 1) / BKV, p.B * p.Hkv);
  dkv_kernel<T, DPL><<<dkv_grid, THREADS, dkv_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p.D < 1) return (int)cudaErrorInvalidValue;
  switch ((p.D + 31) / 32) {  // 32-column lane groups the head dim needs
    case 1:
      return launch<T, 1>(p, s);
    case 2:
      return launch<T, 2>(p, s);
    case 3:
      return launch<T, 3>(p, s);
    case 4:
      return launch<T, 4>(p, s);
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
// strides of q, k, v, out and dout, in that order.  delta is (B, Hq, Sq)
// f32 scratch the dQ pass fills and the dK/dV pass reads.
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* out, const float* dout,
                            const float* lse, float* delta, float* dq,
                            float* dk, float* dv, const int* dims,
                            const long long* strides, float scale,
                            int causal, int window, int kv_len,
                            void* stream) {
  return dispatch<float>(make_args(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, dims, strides, scale, causal, window,
                                   kv_len),
                         stream);
}

int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v,
                             const __nv_bfloat16* out,
                             const __nv_bfloat16* dout, const float* lse,
                             float* delta, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv,
                             const int* dims, const long long* strides,
                             float scale, int causal, int window, int kv_len,
                             void* stream) {
  return dispatch<__nv_bfloat16>(
      make_args(q, k, v, out, dout, lse, delta, dq, dk, dv, dims, strides,
                scale, causal, window, kv_len),
      stream);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
