// Staging of strided f32 or bf16 tiles into shared memory as f32, shared by
// the recurrent kernels (mamba2_scan.cu, wkv6.cu): each thread issues U
// loads before it stores any, 16 bytes a load where the tile allows it, so
// a CTA waits for memory about once per U loads a thread, not once per
// element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace stage {

constexpr int U = 4;  // loads a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes as 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// rows x cols of a matrix with row stride row_stride (elements) into dst
// with row stride ld, as f32; rows past n_rows and columns past n_cols are
// zeros.  NT threads (the CTA) take part; no barrier.
template <typename T, int NT>
__device__ __forceinline__ void tile(float* dst, int ld, const T* src,
                                     long long row_stride, int n_rows,
                                     int rows, int n_cols, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const bool vec = cols % V == 0 && n_cols % V == 0 && ld % 4 == 0 &&
                   row_stride % V == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec) {
    const int per_row = cols / V, total = rows * per_row;
    for (int base = tid; base < total; base += NT * U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * NT;
        const int r = e / per_row, c = (e - r * per_row) * V;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && r < n_rows && c < n_cols)
          raw[u] = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * NT;
        if (e >= total) break;
        const int r = e / per_row, c = (e - r * per_row) * V;
        float f[V];
        unpack(raw[u], f, src);
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(dst + r * ld + c + i) =
              make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
      }
    }
    return;
  }
  const int total = rows * cols;
  for (int base = tid; base < total; base += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NT;
      const int r = e / cols, c = e - r * cols;
      v[u] = e < total && r < n_rows && c < n_cols
                 ? to_f32(src[r * row_stride + c])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NT;
      if (e >= total) break;
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] = v[u];
    }
  }
}

// An f32 tile as tile() stages it, by cp.async in 16-byte pieces when the
// columns, strides and both addresses allow it (pieces past n_rows or
// n_cols zero-filled by the copy), else by tile(); NT threads (the CTA)
// take part.  The caller waits (cp_async_wait) and synchronises before it
// reads the tile.
template <int NT>
__device__ __forceinline__ void tile_async(float* dst, int ld,
                                           const float* src,
                                           long long row_stride, int n_rows,
                                           int rows, int n_cols, int cols) {
  if (cols % 4 || n_cols % 4 || ld % 4 || row_stride % 4 ||
      reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16) {
    tile<float, NT>(dst, ld, src, row_stride, n_rows, rows, n_cols, cols);
    return;
  }
  const int per_row = cols / 4, total = rows * per_row;
  for (int e = threadIdx.x; e < total; e += NT) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    const bool ok = r < n_rows && c < n_cols;
    hopper::cp_async16(dst + r * ld + c, ok ? src + r * row_stride + c : src,
                       ok);
  }
  hopper::cp_async_commit();
}

}  // namespace stage
