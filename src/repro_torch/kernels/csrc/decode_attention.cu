// Single-token decode attention over a ring KV cache for Hopper (sm_90a),
// f32 or bf16 operands.
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention_pallas:
// for each sequence b, out[b, h] = softmax(q[b, h] . K[b, h/G, :kv_len[b]]
// * scale) V[b, h/G, :kv_len[b]] with q (B,Hq,D), the cache K, V
// (B,Hkv,S,D) and kv_len (B,) int32 -- the ring rule: the first kv_len[b]
// cache rows are the live ones, in whatever (wrapped) order, and softmax
// cannot see the order.  The TPU kernel walks (B*Hq, S/bkv) blocks and
// skips the blocks past kv_len; here nothing past kv_len is read at all.
//
// Bound on an H100: every live cache byte is read once per tick and used
// for G multiply-adds (G = Hq/Hkv, 3 for smollm), so HBM (3.35 TB/s)
// bounds it.  One CTA serves one (b, kv head) pair and its whole group of
// G q heads, so each cache row is read once, not G times.  Its 128 threads
// split into row groups of D/VEC lanes, each lane loading 16 bytes (VEC =
// 8 bf16 or 4 f32 values) of a K row and of a V row; every group walks its
// own rows with its own online-softmax state (f32), four rows in flight
// per group, and the groups' states are merged in shared memory at the
// end.  A row group has a power of two of lanes: D/VEC rounded up (16
// lanes for zamba2-7b's 112 in bf16), the lanes past D loading nothing
// and adding zero to each score.  At 8 slots and 5 kv heads the grid is 40 CTAs on 132 SMs, so the
// card is far from its HBM rate: splitting the rows of one (b, kv head)
// over several CTAs (split-KV, with a second merge pass) is later work.
//
// The cache is addressed through element strides (D contiguous, 16-byte
// aligned rows), so the executor's transposed view of its (slots, rows,
// kv heads, D) regions is read in place.  kv_len[b] must be >= 1 (the
// ring rule gives min(pos + 1, S)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;  // rows in flight per row group
constexpr float NEG_INF = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  int B, Hq, Hkv, S, D;
  long long q_sb, q_sh;  // element strides of q: batch, head
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
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

// 16 bytes as VEC floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecodeArgs p) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sm_m[THREADS * G];
  __shared__ float sm_l[THREADS * G];
  __shared__ float sm_acc[THREADS * G * VEC];

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x - b * p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lpr = 1;                        // lanes per row: D/VEC rounded up
  while (lpr * VEC < p.D) lpr *= 2;   // to a power of two <= 32
  const int rpw = 32 / lpr;           // rows per warp and step
  const int sub = lane % lpr;         // this lane's 16-byte chunk of a row
  const bool in_row = sub * VEC < p.D;  // false on the lanes past D
  const int grp = tid / lpr;          // row group
  const int n_grp = THREADS / lpr;
  const int len = min(p.kv_len[b], p.S);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = (const T*)p.q + b * p.q_sb + (hk * G + g) * p.q_sh;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[g][e] = in_row ? to_f32(qp[sub * VEC + e]) : 0.f;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh + sub * VEC;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh + sub * VEC;
  // Row of (step, u) for this lane's group: the warp's rows of a step are
  // contiguous, so the loop bound is uniform across the warp (the
  // shuffles below need every lane).
  const int step_rows = n_grp * UNROLL;
  for (int base = warp * rpw * UNROLL; base < len; base += step_rows) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * rpw + lane / lpr;
      if (r < len && in_row) {
        kr[u] = *(const uint4*)(kb + r * p.k_ss);
        vr[u] = *(const uint4*)(vb + r * p.v_ss);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * rpw + lane / lpr;
      const bool live = r < len;
      float kf[VEC], vf[VEC];
      if (live && in_row) {
        unpack<T>(kr[u], kf);
        unpack<T>(vr[u], vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += qv[g][e] * kf[e];
        for (int off = lpr / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (!live) continue;
        s *= p.scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * alpha + pr;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * alpha + pr * vf[e];
      }
    }
  }

  // Merge the row groups' states.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      sm_m[grp * G + g] = m[g];
      sm_l[grp * G + g] = l[g];
    }
    if (in_row) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(grp * G + g) * p.D + sub * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  T* out = (T*)p.out + b * p.o_sb;
  for (int t = tid; t < G * p.D; t += THREADS) {
    const int g = t / p.D, d = t - g * p.D;
    float mx = NEG_INF;
    for (int i = 0; i < n_grp; ++i) mx = fmaxf(mx, sm_m[i * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < n_grp; ++i) {
      const float w = expf(sm_m[i * G + g] - mx);
      lsum += sm_l[i * G + g] * w;
      a += sm_acc[(i * G + g) * p.D + d] * w;
    }
    out[(hk * G + g) * p.o_sh + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
int dispatch(const DecodeArgs& p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = p.B * p.Hkv;
  switch (p.Hq / p.Hkv) {
    case 1: decode_kernel<T, 1><<<grid, THREADS, 0, s>>>(p); break;
    case 2: decode_kernel<T, 2><<<grid, THREADS, 0, s>>>(p); break;
    case 3: decode_kernel<T, 3><<<grid, THREADS, 0, s>>>(p); break;
    case 4: decode_kernel<T, 4><<<grid, THREADS, 0, s>>>(p); break;
    case 5: decode_kernel<T, 5><<<grid, THREADS, 0, s>>>(p); break;
    case 6: decode_kernel<T, 6><<<grid, THREADS, 0, s>>>(p); break;
    case 7: decode_kernel<T, 7><<<grid, THREADS, 0, s>>>(p); break;
    case 8: decode_kernel<T, 8><<<grid, THREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

DecodeArgs make_args(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, const int* dims,
                     const long long* strides, float scale) {
  DecodeArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.out = out;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.S = dims[3];
  p.D = dims[4];
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_sh = strides[3];
  p.k_ss = strides[4];
  p.v_sb = strides[5];
  p.v_sh = strides[6];
  p.v_ss = strides[7];
  p.o_sb = strides[8];
  p.o_sh = strides[9];
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dims: B, Hq, Hkv, S, D.  strides: q (batch, head), k (batch, head, row),
// v (batch, head, row), out (batch, head).
int decode_attention_f32(const float* q, const float* k, const float* v,
                         const int* kv_len, float* out, const int* dims,
                         const long long* strides, float scale,
                         void* stream) {
  return dispatch<float>(
      make_args(q, k, v, kv_len, out, dims, strides, scale), stream);
}

int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* kv_len,
                          __nv_bfloat16* out, const int* dims,
                          const long long* strides, float scale,
                          void* stream) {
  return dispatch<__nv_bfloat16>(
      make_args(q, k, v, kv_len, out, dims, strides, scale), stream);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
