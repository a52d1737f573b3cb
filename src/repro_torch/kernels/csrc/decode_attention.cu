// Single-token decode attention over a ring KV cache for Hopper (sm_90a):
// f32 or bf16 q and output, the cache in q's type or in float8 e4m3.
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
// bounds it.  The design is decode_split.cuh's: split-KV over (B * Hkv,
// splits) CTAs, each serving a pair's G q heads over its span of rows,
// row tiles of K and V double-buffered in shared memory by 16-byte
// cp.async, the softmax taken once per tile, and a fixed-order merge of
// the splits (one cluster) in distributed shared memory.  A float8 e4m3
// cache is read in its own bytes (one an element, half of bf16's) and
// widened to f32 as each chunk leaves shared memory, as the TPU kernel
// casts each K/V tile to f32 inside the kernel.  This file only says
// where a row lies: row r of pair (b, hk) is at k + b*k_sb + hk*k_sh +
// r*k_ss (element strides, D contiguous,
// 16-byte aligned rows), so the executor's transposed view of its (slots,
// rows, kv heads, D) regions is read in place.  kv_len[b] must be >= 1
// (the ring rule gives min(pos + 1, S)).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

using decode_split::SplitArgs;

template <typename T>
struct RingRows {
  struct Params {
    const T* k;
    const T* v;
    long long k_sb, k_sh, k_ss;  // element strides: batch, head, row
    long long v_sb, v_sh, v_ss;
  };
  const T* kb;
  const T* vb;
  long long k_ss, v_ss;

  __device__ RingRows(const Params& rp, const SplitArgs&, int b, int hk, int,
                      char*)
      : kb(rp.k + b * rp.k_sb + hk * rp.k_sh),
        vb(rp.v + b * rp.v_sb + hk * rp.v_sh),
        k_ss(rp.k_ss),
        v_ss(rp.v_ss) {}
  __device__ const T* k_row(int r) const { return kb + r * k_ss; }
  __device__ const T* v_row(int r) const { return vb + r * v_ss; }
  __device__ void load_scales(int) {}
  __device__ float k_scale(int) const { return 1.f; }
  __device__ float v_scale(int) const { return 1.f; }
};

template <typename TQ, typename TKV>
int run(const TQ* q, const void* k, const void* v, const int* kv_len,
        TQ* out, const int* dims, const long long* strides, float scale,
        void* stream) {
  SplitArgs p;
  p.q = q;
  p.out = out;
  p.kv_len = kv_len;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.cache_len = dims[3];
  p.D = dims[4];
  p.tile_rows = dims[5];
  p.split_rows = dims[6];
  p.splits = dims[7];
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.o_sb = strides[8];
  p.o_sh = strides[9];
  p.scale = scale;
  typename RingRows<TKV>::Params rp;
  rp.k = (const TKV*)k;
  rp.v = (const TKV*)v;
  rp.k_sb = strides[2];
  rp.k_sh = strides[3];
  rp.k_ss = strides[4];
  rp.v_sb = strides[5];
  rp.v_sh = strides[6];
  rp.v_ss = strides[7];
  return decode_split::launch<TQ, TKV, RingRows<TKV>>(p, rp, 0,
                                                     (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// dims: B, Hq, Hkv, S, D, then decode_plan's tile_rows, split_rows,
// splits.  strides: q (batch, head), k (batch, head, row), v (batch,
// head, row), out (batch, head).
int decode_attention_f32(const float* q, const float* k, const float* v,
                         const int* kv_len, float* out, const int* dims,
                         const long long* strides, float scale,
                         void* stream) {
  return run<float, float>(q, k, v, kv_len, out, dims, strides, scale,
                           stream);
}

int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* kv_len,
                          __nv_bfloat16* out, const int* dims,
                          const long long* strides, float scale,
                          void* stream) {
  return run<__nv_bfloat16, __nv_bfloat16>(q, k, v, kv_len, out, dims,
                                           strides, scale, stream);
}

// The same with a float8 e4m3 cache under an f32 or a bf16 q.
int decode_attention_f32_e4m3(const float* q, const __nv_fp8_e4m3* k,
                              const __nv_fp8_e4m3* v, const int* kv_len,
                              float* out, const int* dims,
                              const long long* strides, float scale,
                              void* stream) {
  return run<float, __nv_fp8_e4m3>(q, k, v, kv_len, out, dims, strides,
                                   scale, stream);
}

int decode_attention_bf16_e4m3(const __nv_bfloat16* q,
                               const __nv_fp8_e4m3* k,
                               const __nv_fp8_e4m3* v, const int* kv_len,
                               __nv_bfloat16* out, const int* dims,
                               const long long* strides, float scale,
                               void* stream) {
  return run<__nv_bfloat16, __nv_fp8_e4m3>(q, k, v, kv_len, out, dims,
                                           strides, scale, stream);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
