// Flash-attention forward for Hopper (sm_90a), f32 or bf16 operands.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas:
// softmax(q k^T * scale + mask) v for q (B,Hq,Sq,D), k, v (B,Hkv,Skv,D),
// with the causal, sliding-window (ki > qi - window) and kv_len masks, GQA
// through kv head = h / (Hq/Hkv) (no repeated K/V is materialised), and
// the per-row logsumexp written beside the output for the backward pass.
// The constants are the reference's: masked scores are -1e30 and the
// softmax denominator is clamped at 1e-30.
//
// The TPU kernel walks a (B*Hq, Sq/bq, Skv/bkv) grid whose kv axis runs in
// order and carries the online-softmax state in VMEM scratch; its blocks
// are VMEM-sized (about 512 x 512 at the smollm prefill).  Here one CTA
// owns one (b, q head) pair and a 64-row q tile, and a loop inside the CTA
// walks 64-row kv tiles in order -- the sequential kv grid axis -- with the
// state (m, l, acc) kept in f32 registers.  Q, K and V tiles are staged in
// shared memory as f32 (65 KB at D = 64, 113 KB at D = 128, so the launch
// raises the dynamic shared-memory limit).  Kv tiles wholly outside the
// causal / window / kv_len span of the q tile are skipped, as the TPU
// kernel skips whole blocks.  A head dim D <= 128 that is not a multiple
// of 32 (zamba2-7b's 112) takes the tiles of the next multiple, 32 * DPL
// columns, with the columns past D zero-filled in shared memory, so they
// add nothing to a score, and never stored.
//
// Bound on an H100: the smollm prefill (Sq = Skv = 512, D = 64, 15 q
// heads, causal) does 4 * D FLOP per unmasked (q, k) pair, 0.5 GFLOP, over
// 2.6 MB of q, k, v, out and lse in bf16: about 190 FLOP per byte, under
// the bf16 ridge (989 TFLOP/s over 3.35 TB/s, about 295), so HBM bounds
// it with the tensor cores close behind.  This kernel is a SIMT loop with
// f32 FMAs, far from either bound: each warp owns 16 q rows, each lane
// two kv columns of the score tile and D/32 output columns.
// wgmma, TMA and more CTAs per head (the grid is 8 x 15 = 120 CTAs on 132
// SMs at the smollm prefill) are later work.
//
// Operands are addressed through element strides (D contiguous), so the
// executor's transposed head views are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;  // q rows per warp
constexpr float NEG_INF = -1e30f;
static_assert(BKV == 64, "two kv columns per lane");

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, Hq, Sq), contiguous
  int B, Hq, Hkv, Sq, Skv, D;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)BQ * D + (size_t)BKV * (D + 1) + (size_t)BKV * D + BQ * BKV);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) flash_kernel(FlashArgs p) {
  constexpr int D = 32 * DPL;  // tile width; the head dim is p.D <= D
  constexpr int KST = D + 1;  // padded K row: lanes read distinct rows
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][D]
  float* Ks = Qs + BQ * D;      // [BKV][KST]
  float* Vs = Ks + BKV * KST;   // [BKV][D]
  float* Ps = Vs + BKV * D;     // [BQ][BKV]

  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qs[i] = qi < p.Sq && d < p.D ? to_f32(q[qi * p.q_ss + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  // The kv tiles some row of this q tile can attend.
  const int kv_len = min(p.kv_len, p.Skv);
  int t_end = (kv_len + BKV - 1) / BKV;
  if (p.causal) t_end = min(t_end, (q0 + BQ - 1) / BKV + 1);
  int t_begin = 0;
  if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / BKV;

  const int row0 = warp * RPW;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const int kj = k0 + r;
      const bool in = kj < p.Skv && d < p.D;
      Ks[r * KST + d] = in ? to_f32(k[kj * p.k_ss + d]) : 0.f;
      Vs[i] = in ? to_f32(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * KST + d];
      const float kb = Ks[(lane + 32) * KST + d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float qv = Qs[(row0 + i) * D + d];
        s[i][0] += qv * ka;
        s[i][1] += qv * kb;
      }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ki = k0 + lane + 32 * c;
        bool ok = ki < kv_len;
        if (p.causal) ok = ok && ki <= qi;
        if (p.window > 0) ok = ok && ki > qi - p.window;
        s[i][c] = ok ? s[i][c] * p.scale : NEG_INF;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int tt = 0; tt < DPL; ++tt) acc[i][tt] *= alpha;
      Ps[(row0 + i) * BKV + lane] = p0;
      Ps[(row0 + i) * BKV + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vv[DPL];
#pragma unroll
      for (int tt = 0; tt < DPL; ++tt) vv[tt] = Vs[j * D + lane + 32 * tt];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = Ps[(row0 + i) * BKV + j];
#pragma unroll
        for (int tt = 0; tt < DPL; ++tt) acc[i][tt] += pj * vv[tt];
      }
    }
    __syncwarp();  // Ps is rewritten by this warp in the next tile
  }

  T* out = (T*)p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int tt = 0; tt < DPL; ++tt)
      if (lane + 32 * tt < p.D)
        out[qi * p.o_ss + lane + 32 * tt] = from_f32<T>(acc[i][tt] / lc);
    if (lane == 0) p.lse[(size_t)bh * p.Sq + qi] = m[i] + logf(lc);
  }
}

template <typename T, int DPL>
int launch(const FlashArgs& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * DPL);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  flash_kernel<T, DPL><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashArgs& p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
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

FlashArgs make_args(const void* q, const void* k, const void* v, void* out,
                    float* lse, const int* dims, const long long* strides,
                    float scale, int causal, int window, int kv_len) {
  FlashArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.Sq = dims[3];
  p.Skv = dims[4];
  p.D = dims[5];
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.kv_len = kv_len;
  return p;
}

}  // namespace

extern "C" {

// dims: B, Hq, Hkv, Sq, Skv, D (1 <= D <= 128).  strides: (batch, head, row) element
// strides of q, k, v and out, in that order.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, float* lse, const int* dims,
                        const long long* strides, float scale, int causal,
                        int window, int kv_len, void* stream) {
  return dispatch<float>(make_args(q, k, v, out, lse, dims, strides, scale,
                                   causal, window, kv_len),
                         stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* out,
                         float* lse, const int* dims,
                         const long long* strides, float scale, int causal,
                         int window, int kv_len, void* stream) {
  return dispatch<__nv_bfloat16>(make_args(q, k, v, out, lse, dims, strides,
                                           scale, causal, window, kv_len),
                                 stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
