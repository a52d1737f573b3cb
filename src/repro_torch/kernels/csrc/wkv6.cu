// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), f32 or bf16 r, k, v, w;
// f32 bonus u and state.
//
// Replaces repro/kernels/rwkv6/kernel.py::wkv6_pallas: per batch b and
// head h, with the state S (D_k x D_v) starting at s0 (or zero),
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// for r, k, v, w (B, L, H, D) and u (H, D).  Returns y in r's type and
// the final state (B, H, D, D) in f32.
//
// The TPU kernel keeps the (D, D) state in VMEM for a whole (batch, head)
// stream, walking the sequence in chunks whose r/k/v/w tiles are loaded
// once, so every HBM byte is touched once.  Here one CTA of D threads owns
// one (b, h) pair and thread j holds column j of the state in registers
// (64 floats at D = 64).  The CTA walks t in order: each thread loads
// element j of r_t, k_t, v_t and w_t (one coalesced row each), stages r,
// k and w in shared memory, and after one barrier computes y_t[j] and its
// column's update from the staged row.  The next step's row is loaded
// into registers before the current step's arithmetic, and the staging
// buffers alternate, so each step costs one barrier.  Every input byte is
// read once and every output byte written once.
//
// Bound on an H100: about 5 D^2 f32 FLOP per step and head (the read-out
// and the decayed rank-1 update) against 4 D input and D output values,
// so the f32 rate bounds it (rwkv6-7b's prefill, L = 512 and 64 heads of
// 64: 0.67 GFLOP over 22 MB).  One CTA per (b, h) is 64 CTAs of two warps
// at batch 1, far below the card's width; splitting the value columns of
// a head over several CTAs, and a chunked matrix form for long prompts,
// are later work.
//
// r, k, v, w are addressed through element strides (D contiguous); y and
// the states are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (H, D), contiguous
  const float* s0;  // (B, H, D, D) or null: zero state
  void* y;          // (B, L, H, D), contiguous
  float* s_out;     // (B, H, D, D), contiguous
  int B, L, H;
  long long r_sb, r_sl, r_sh;  // element strides: batch, step, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long w_sb, w_sl, w_sh;
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

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv_kernel(WkvArgs p) {
  __shared__ float rs[2][D], ks[2][D], ws[2][D];
  __shared__ float us[D];
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int j = threadIdx.x;
  const size_t state0 = (size_t)bh * D * D;

  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    S[i] = p.s0 != nullptr ? p.s0[state0 + (size_t)i * D + j] : 0.f;
  us[j] = p.u[h * D + j];

  const T* r = (const T*)p.r + b * p.r_sb + h * p.r_sh + j;
  const T* k = (const T*)p.k + b * p.k_sb + h * p.k_sh + j;
  const T* v = (const T*)p.v + b * p.v_sb + h * p.v_sh + j;
  const T* w = (const T*)p.w + b * p.w_sb + h * p.w_sh + j;
  T* y = (T*)p.y + ((size_t)b * p.L * p.H + h) * D + j;

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (p.L > 0) {
    rn = to_f32(r[0]);
    kn = to_f32(k[0]);
    vn = to_f32(v[0]);
    wn = to_f32(w[0]);
  }
  for (int t = 0; t < p.L; ++t) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < p.L) {  // the next row, in flight during this step
      rn = to_f32(r[(t + 1) * p.r_sl]);
      kn = to_f32(k[(t + 1) * p.k_sl]);
      vn = to_f32(v[(t + 1) * p.v_sl]);
      wn = to_f32(w[(t + 1) * p.w_sl]);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float kv = ks[buf][i] * vj;
      acc += rs[buf][i] * (S[i] + us[i] * kv);
      S[i] = ws[buf][i] * S[i] + kv;
    }
    y[(size_t)t * p.H * D] = from_f32<T>(acc);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) p.s_out[state0 + (size_t)i * D + j] = S[i];
}

template <typename T, int D>
int launch(const WkvArgs& p, cudaStream_t stream) {
  wkv_kernel<T, D><<<p.B * p.H, D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const WkvArgs& p, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<T, 16>(p, s);
    case 32:
      return launch<T, 32>(p, s);
    case 64:
      return launch<T, 64>(p, s);
    case 128:
      return launch<T, 128>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

WkvArgs make_args(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* y, float* s_out,
                  const int* dims, const long long* strides) {
  WkvArgs p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.s0 = s0;
  p.y = y;
  p.s_out = s_out;
  p.B = dims[0];
  p.L = dims[1];
  p.H = dims[2];
  p.r_sb = strides[0];
  p.r_sl = strides[1];
  p.r_sh = strides[2];
  p.k_sb = strides[3];
  p.k_sl = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_sl = strides[7];
  p.v_sh = strides[8];
  p.w_sb = strides[9];
  p.w_sl = strides[10];
  p.w_sh = strides[11];
  return p;
}

}  // namespace

extern "C" {

// dims: B, L, H, D (16, 32, 64 or 128).  strides: (batch, step, head)
// element strides of r, k, v and w, in that order.  s0 may be null.
int wkv6_f32(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* s0, float* y, float* s_out,
             const int* dims, const long long* strides, void* stream) {
  return dispatch<float>(make_args(r, k, v, w, u, s0, y, s_out, dims, strides),
                         dims[3], stream);
}

int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const __nv_bfloat16* w, const float* u,
              const float* s0, __nv_bfloat16* y, float* s_out,
              const int* dims, const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_args(r, k, v, w, u, s0, y, s_out, dims, strides), dims[3], stream);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
