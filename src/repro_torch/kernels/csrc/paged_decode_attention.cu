// Single-token decode attention over a paged KV cache for Hopper (sm_90a):
// q in f32 or bf16, page pools in f32, bf16 or int8 (with per-page f32
// scales).
//
// Replaces repro/kernels/decode_attention/kernel.py::
// paged_decode_attention_pallas: for each sequence b and q head h,
// out[b, h] = softmax(q[b, h] . K_b[:kv_len[b]] * scale) V_b[:kv_len[b]],
// where virtual row r of sequence b is pool row (table[b, r / page_size],
// r % page_size) of the (n_pages, page_size, Hkv, D) pools.  int8 pools are
// dequantized as int8 * scale[page] in f32 right after the load.  The TPU
// kernel walks a (B*Hq, pages_per_slot) grid, each step loading one page
// out of the whole pool it keeps resident; here a CTA reads the table
// itself and loads only the live rows of the pages it names, so the null
// page 0 (the sink of masked writes) and the rows past kv_len are never
// read.
//
// Bound on an H100: every live page row is read once per tick for G
// multiply-adds per element (G = Hq/Hkv, 3 for smollm), so HBM (3.35 TB/s)
// bounds it.  The design is the contiguous kernel's
// (csrc/decode_attention.cu) with the address taken through the table:
// one CTA per (b, kv head) serves its G q heads, so each page row is read
// once, not G times; its 128 threads split into row groups of D/VEC lanes,
// each lane loading 16 bytes of a K row and of a V row (VEC = 4 f32, 8 bf16
// or 16 int8 values).  A row group owns whole pages -- pages g, g + n_grp,
// ... of its sequence -- so it resolves each page id once per page, and
// walks the page's rows four at a time with its own online-softmax state
// (f32).  The groups of a warp merge their states with shuffles, the warps
// theirs in shared memory.  At 8 slots and 5 kv heads the grid is 40 CTAs
// on 132 SMs: splitting a sequence's pages over several CTAs (split-KV)
// and TMA page loads are later work.
//
// The pools and the table are contiguous; q and out are addressed through
// element strides (D contiguous).  kv_len[b] must be >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // rows in flight per row group
constexpr float NEG_INF = -1e30f;

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

struct PagedArgs {
  const void* q;
  const void* k;  // (n_pages, page_size, Hkv, D) pools
  const void* v;
  const float* k_scale;  // (n_pages,) for int8 pools, else null
  const float* v_scale;
  const int* table;   // (B, pages_per_slot)
  const int* kv_len;  // (B,)
  void* out;
  int B, Hq, Hkv, D, page_size, pages_per_slot;
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

// 16 bytes of a pool row as VEC floats.
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
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
}

template <typename TQ, typename TKV, int G>
__global__ void __launch_bounds__(THREADS) paged_kernel(PagedArgs p) {
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr bool QUANT = sizeof(TKV) == 1;
  __shared__ float sm_m[WARPS * G];
  __shared__ float sm_l[WARPS * G];
  extern __shared__ float sm_acc[];  // WARPS * G * D

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x - b * p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lpr = p.D / VEC;   // lanes per row, a power of two <= 32
  const int gpw = 32 / lpr;    // row groups per warp
  const int sub = lane % lpr;  // this lane's 16-byte chunk of a row
  const int grp = tid / lpr;   // row group
  const int n_grp = THREADS / lpr;
  const int cache_len = p.pages_per_slot * p.page_size;
  const int len = min(p.kv_len[b], cache_len);
  const int n_pages = (len + p.page_size - 1) / p.page_size;
  const int* table = p.table + (long long)b * p.pages_per_slot;
  const long long row_stride = (long long)p.Hkv * p.D;
  const long long page_stride = row_stride * p.page_size;

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qp = (const TQ*)p.q + b * p.q_sb + (hk * G + g) * p.q_sh;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[g][e] = to_f32(qp[sub * VEC + e]);
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const TKV* kb = (const TKV*)p.k + hk * p.D + sub * VEC;
  const TKV* vb = (const TKV*)p.v + hk * p.D + sub * VEC;
  // Round pr hands page pr * n_grp + grp to this group.  The loop bound is
  // that of the warp's first group, so every lane of a warp runs the same
  // iterations (the shuffles below need all of them); a group past the
  // live pages runs them masked.
  const int warp_grp0 = warp * gpw;
  for (int page0 = warp_grp0; page0 < n_pages; page0 += n_grp) {
    const int pi = page0 - warp_grp0 + grp;
    const bool page_live = pi < n_pages;
    const int page = page_live ? table[pi] : 0;
    const int rows = page_live ? min(p.page_size, len - pi * p.page_size) : 0;
    float ks = 1.f, vs = 1.f;
    if (QUANT && page_live) {
      ks = p.k_scale[page];
      vs = p.v_scale[page];
    }
    const TKV* kpage = kb + page * page_stride;
    const TKV* vpage = vb + page * page_stride;
    for (int r0 = 0; r0 < p.page_size; r0 += UNROLL) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r0 + u < rows) {
          kr[u] = *(const uint4*)(kpage + (r0 + u) * row_stride);
          vr[u] = *(const uint4*)(vpage + (r0 + u) * row_stride);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = r0 + u < rows;
        float kf[VEC], vf[VEC];
        if (live) {
          unpack<TKV>(kr[u], kf);
          unpack<TKV>(vr[u], vf);
          if (QUANT) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              kf[e] *= ks;
              vf[e] *= vs;
            }
          }
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
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = acc[g][e] * alpha + pr * vf[e];
        }
      }
    }
  }

  // Merge the row groups of each warp (lanes lpr apart hold the same
  // chunk of the same head), then the warps in shared memory.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int off = lpr; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), c = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * c;
      }
      m[g] = m_new;
    }
    if (lane < lpr) {
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(warp * G + g) * p.D + sub * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  TQ* out = (TQ*)p.out + b * p.o_sb;
  for (int t = tid; t < G * p.D; t += THREADS) {
    const int g = t / p.D, d = t - g * p.D;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[(w * G + g) * p.D + d] * c;
    }
    out[(hk * G + g) * p.o_sh + d] = from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const PagedArgs& p, cudaStream_t s) {
  const int grid = p.B * p.Hkv;
  const size_t smem = (size_t)WARPS * (p.Hq / p.Hkv) * p.D * sizeof(float);
  switch (p.Hq / p.Hkv) {
    case 1: paged_kernel<TQ, TKV, 1><<<grid, THREADS, smem, s>>>(p); break;
    case 2: paged_kernel<TQ, TKV, 2><<<grid, THREADS, smem, s>>>(p); break;
    case 3: paged_kernel<TQ, TKV, 3><<<grid, THREADS, smem, s>>>(p); break;
    case 4: paged_kernel<TQ, TKV, 4><<<grid, THREADS, smem, s>>>(p); break;
    case 5: paged_kernel<TQ, TKV, 5><<<grid, THREADS, smem, s>>>(p); break;
    case 6: paged_kernel<TQ, TKV, 6><<<grid, THREADS, smem, s>>>(p); break;
    case 7: paged_kernel<TQ, TKV, 7><<<grid, THREADS, smem, s>>>(p); break;
    case 8: paged_kernel<TQ, TKV, 8><<<grid, THREADS, smem, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(int kv_type, const PagedArgs& p, cudaStream_t s) {
  switch (kv_type) {
    case F32: return launch<TQ, float>(p, s);
    case BF16: return launch<TQ, __nv_bfloat16>(p, s);
    case I8: return launch<TQ, int8_t>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_type: 0 f32, 1 bf16; kv_type: 0 f32, 1 bf16, 2 int8 (k_scale and
// v_scale then non-null).  dims: B, Hq, Hkv, D, page_size, pages_per_slot.
// strides: q (batch, head), out (batch, head).
int paged_decode_attention(int q_type, int kv_type, const void* q,
                           const void* k, const void* v, const float* k_scale,
                           const float* v_scale, const int* table,
                           const int* kv_len, void* out, const int* dims,
                           const long long* strides, float scale,
                           void* stream) {
  PagedArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.table = table;
  p.kv_len = kv_len;
  p.out = out;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.D = dims[3];
  p.page_size = dims[4];
  p.pages_per_slot = dims[5];
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.o_sb = strides[2];
  p.o_sh = strides[3];
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (q_type) {
    case F32: return launch_q<float>(kv_type, p, s);
    case BF16: return launch_q<__nv_bfloat16>(kv_type, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
