// Single-token decode attention over a paged KV cache for Hopper (sm_90a):
// q in f32 or bf16, page pools in f32, bf16 or int8 (with per-page f32
// scales).
//
// Replaces repro/kernels/decode_attention/kernel.py::
// paged_decode_attention_pallas: for each sequence b and q head h,
// out[b, h] = softmax(q[b, h] . K_b[:kv_len[b]] * scale) V_b[:kv_len[b]],
// where virtual row r of sequence b is pool row (table[b, r / page_size],
// r % page_size) of the (n_pages, page_size, Hkv, D) pools.  int8 pools are
// dequantized as int8 * scale[page] in f32 as the values leave shared
// memory.  The TPU kernel walks a (B*Hq, pages_per_slot) grid, each step
// loading one page out of the whole pool it keeps resident; here a CTA
// reads its span of the table itself and loads only the live rows of the
// pages it names, so the null page 0 (the sink of masked writes) and the
// rows past kv_len are never read.
//
// Bound on an H100: every live page row is read once per tick for G
// multiply-adds per element (G = Hq/Hkv, 3 for smollm), so HBM (3.35 TB/s)
// bounds it; an int8 pool halves the bytes.  The design is
// decode_split.cuh's, shared with the contiguous kernel: split-KV over
// (B * Hkv, splits) CTAs, row tiles double-buffered in shared memory by
// 16-byte cp.async, the softmax once per tile, a fixed-order merge of a
// pair's splits (one cluster) in distributed shared memory.  A split is a
// whole number of pages (decode_plan), and so is a tile unless a page
// outgrows it.  A CTA reads each page id of its span once, into shared
// memory beside kv_len, before its first copy; an int8 pool's page
// scales follow while the first tile flies.
//
// The pools and the table are contiguous; q and out are addressed through
// element strides (D contiguous).  kv_len[b] must be >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

using decode_split::SplitArgs;

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

template <typename T>
struct PagedRows {
  static constexpr bool QUANT = sizeof(T) == 1;
  struct Params {
    const T* k;  // (n_pages, page_size, Hkv, D) pools
    const T* v;
    const float* k_scale;  // (n_pages,) for int8 pools, else null
    const float* v_scale;
    const int* table;  // (B, pages_per_slot)
    int page_size, pages_per_slot;
  };
  const T* kb;  // the pools at head hk of row 0 of page 0
  const T* vb;
  const float* k_scale_g;  // the pools' scales (int8)
  const float* v_scale_g;
  int* ids;  // the span's page ids, in shared memory
  float* ks;
  float* vs;
  int page_size, row0;
  long long row_stride;  // Hkv * D

  // Shared bytes for a span of split_rows rows: a page id and, for int8
  // pools, two scales per page.
  static int extra_bytes(int split_rows, int page_size) {
    return (split_rows / page_size) * (QUANT ? 12 : 4);
  }

  // Reads the span's page ids (those inside the table) into shared
  // memory, beside the kernel's read of kv_len: the table, not the cache.
  __device__ PagedRows(const Params& rp, const SplitArgs& p, int b, int hk,
                       int row0_, char* extra)
      : k_scale_g(rp.k_scale),
        v_scale_g(rp.v_scale),
        page_size(rp.page_size),
        row0(row0_),
        row_stride((long long)p.Hkv * p.D) {
    kb = rp.k + (long long)hk * p.D;
    vb = rp.v + (long long)hk * p.D;
    const int span = p.split_rows / page_size;
    ids = (int*)extra;
    ks = (float*)(ids + span);
    vs = ks + span;
    const int first = row0 / page_size;
    const int n = min(span, rp.pages_per_slot - first);
    const int* table = rp.table + (long long)b * rp.pages_per_slot + first;
    for (int i = threadIdx.x; i < n; i += blockDim.x) ids[i] = table[i];
  }
  // int8 pools: the scales of the span's live pages (read before the
  // first tile is used).
  __device__ void load_scales(int row_end) {
    if (!QUANT) return;
    const int n = (row_end - row0 + page_size - 1) / page_size;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ks[i] = k_scale_g[ids[i]];
      vs[i] = v_scale_g[ids[i]];
    }
  }
  __device__ long long offset(int r) const {
    const int i = (r - row0) / page_size;
    const int in_page = r - row0 - i * page_size;
    return ((long long)ids[i] * page_size + in_page) * row_stride;
  }
  __device__ const T* k_row(int r) const { return kb + offset(r); }
  __device__ const T* v_row(int r) const { return vb + offset(r); }
  __device__ float k_scale(int r) const {
    return QUANT ? ks[(r - row0) / page_size] : 1.f;
  }
  __device__ float v_scale(int r) const {
    return QUANT ? vs[(r - row0) / page_size] : 1.f;
  }
};

template <typename TQ, typename TKV>
int launch_kv(const SplitArgs& p, const void* k, const void* v,
              const float* k_scale, const float* v_scale, const int* table,
              int page_size, int pages_per_slot, cudaStream_t s) {
  typename PagedRows<TKV>::Params rp;
  rp.k = (const TKV*)k;
  rp.v = (const TKV*)v;
  rp.k_scale = k_scale;
  rp.v_scale = v_scale;
  rp.table = table;
  rp.page_size = page_size;
  rp.pages_per_slot = pages_per_slot;
  if (page_size < 1 || p.split_rows % page_size)
    return (int)cudaErrorInvalidValue;
  return decode_split::launch<TQ, TKV, PagedRows<TKV>>(
      p, rp, PagedRows<TKV>::extra_bytes(p.split_rows, page_size), s);
}

template <typename TQ>
int launch_q(int kv_type, const SplitArgs& p, const void* k, const void* v,
             const float* k_scale, const float* v_scale, const int* table,
             int page_size, int pages_per_slot, cudaStream_t s) {
  switch (kv_type) {
    case F32:
      return launch_kv<TQ, float>(p, k, v, k_scale, v_scale, table,
                                  page_size, pages_per_slot, s);
    case BF16:
      return launch_kv<TQ, __nv_bfloat16>(p, k, v, k_scale, v_scale, table,
                                          page_size, pages_per_slot, s);
    case I8:
      return launch_kv<TQ, int8_t>(p, k, v, k_scale, v_scale, table,
                                   page_size, pages_per_slot, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_type: 0 f32, 1 bf16; kv_type: 0 f32, 1 bf16, 2 int8 (k_scale and
// v_scale then non-null).  dims: B, Hq, Hkv, D, page_size,
// pages_per_slot, then decode_plan's tile_rows, split_rows, splits.
// strides: q (batch, head), out (batch, head).
int paged_decode_attention(int q_type, int kv_type, const void* q,
                           const void* k, const void* v, const float* k_scale,
                           const float* v_scale, const int* table,
                           const int* kv_len, void* out, const int* dims,
                           const long long* strides, float scale,
                           void* stream) {
  SplitArgs p;
  p.q = q;
  p.out = out;
  p.kv_len = kv_len;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.D = dims[3];
  const int page_size = dims[4], pages_per_slot = dims[5];
  p.cache_len = page_size * pages_per_slot;
  p.tile_rows = dims[6];
  p.split_rows = dims[7];
  p.splits = dims[8];
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.o_sb = strides[2];
  p.o_sh = strides[3];
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (q_type) {
    case F32:
      return launch_q<float>(kv_type, p, k, v, k_scale, v_scale, table,
                             page_size, pages_per_slot, s);
    case BF16:
      return launch_q<__nv_bfloat16>(kv_type, p, k, v, k_scale, v_scale,
                                     table, page_size, pages_per_slot, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
