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
// Bound on an H100: about 5 D^2 f32 FLOP per step and head against 5 D
// values moved (rwkv6-7b's prefill, L = 512 and 64 heads of 64: 0.67
// GFLOP over 22 MB), but the recurrence is a chain in t: the TPU kernel
// walks each (batch, head) stream in order with the state in VMEM, which
// on this card is 64 CTAs at batch 1 with a dependent chain of L * D
// FMAs.  So the sequence is cut into chunks of Q = 64 steps that run in
// parallel, in three launches:
//
//   a. wkv_local_kernel, one CTA per (block of 64 value columns, chunk,
//      batch * head): the chunk's recurrence from a zero state.  A thread
//      holds 4 columns of RPT key rows (rows part, part + 8, ...), so a
//      step's dependent chain is D / 8 FMAs and each staged r, k, w value
//      serves 4 columns; the rows are staged padded with zeros to 8 RPT,
//      so the step has no branch and its shared loads issue together.
//      y_t[j] = sum_i r_i S_ij + v_j sum_i r_i u_i k_i: the 8 parts'
//      partials of the 4 columns are summed by a 4-shuffle reduce-scatter
//      that leaves each column's sum on one lane.  It writes the local y
//      (f32), the local state dS_c and the chunk decay W_c[i] = prod_t
//      w_t[i].
//   b. wkv_pass_kernel, a thread per state element: in chunk order,
//      S_c = diag(W_c) S_{c-1} + dS_c, the state entering chunk c
//      written over dS_c, the last one to s_out.
//   c. wkv_out_kernel, one CTA per (chunk, head, batch): the prefix
//      products a_t[i] = prod_{s<t} w_s[i] (a scan in four 16-step
//      segments), then y_t += (r_t o a_t)^T S_{c-1}, a (Q x D)(D x D)
//      product on the tensor cores (csrc/chunk_mma.cuh: 3xTF32 for bf16
//      inputs, f64 for f32 ones), rounded once.
//
// Every factor is a product of w in (0, 1): nothing is divided and
// nothing overflows (the fully chunked form that divides by cumulative
// decays, k / prod w, overflows where w = exp(-exp(.)) nears 0).  No
// atomics and a fixed order everywhere: the same bits run to run, and a
// launch reads nothing on the host (graph-safe).  D is any of 1..128:
// each thread of (a) holds RPT = D / 8 rounded up to a power of two rows,
// masked past D; wkv_plan in kernels/rwkv6/kernel.py picks RPT, the
// chunk and the grids from shapes alone.
//
// r, k, v, w are addressed through element strides (D contiguous); y and
// the states are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "chunk_mma.cuh"
#include "stage.cuh"

namespace {

constexpr int Q = 64;            // chunk rows
constexpr int CPT = 4;           // value columns a thread of (a) holds
constexpr int KT = 8;            // threads a column's key rows split over
constexpr int CG = 16;           // column groups of a CTA of (a)
constexpr int CB = CG * CPT;     // value columns a CTA of (a)
constexpr int LOCAL_THREADS = CG * KT;
constexpr int THREADS = 256;     // CTAs of (b) and (c)
constexpr int SEGS = 4;          // segments of (c)'s prefix-product scan
constexpr int MAXD = 128;
struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (H, D), contiguous
  const float* s0;  // (B, H, D, D) or null: zero state
  void* y;          // (B, L, H, D), contiguous
  float* s_out;     // (B, H, D, D), contiguous
  float* y_local;   // (B, L, H, D): the chunks' local y
  float* states;    // (B, H, nc, D, D): dS_c, then the state entering c
  float* decays;    // (B, H, nc, D): W_c
  int B, L, H, D, nc;
  long long r_sb, r_sl, r_sh;  // element strides: batch, step, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long w_sb, w_sl, w_sh;
};

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

// D padded to 16: the width of (c)'s tiles.
__host__ __device__ constexpr int pad16(int D) { return (D + 15) / 16 * 16; }
// r, k and w rows padded to KT * RPT (zeros past D), then v's columns.
__host__ __device__ constexpr int local_smem_floats(int rpt) {
  return 3 * Q * KT * rpt + Q * CB;
}
__host__ __device__ constexpr int out_smem_floats(int D) {
  return 2 * Q * (pad16(D) + 4) + pad16(D) * (pad16(D) + 8) +
         SEGS * pad16(D);
}

// a. The chunk's recurrence from a zero state for value columns [64 cb,
// 64 cb + 64): thread (cg, part) holds columns 64 cb + 4 cg + (0..3) of
// rows part + 8 ii (ii < RPT).
template <typename T, int RPT>
__global__ void __launch_bounds__(LOCAL_THREADS)
    wkv_local_kernel(WkvArgs p) {
  static_assert(CPT == 4 && KT == 8, "the reduce-scatter below");
  constexpr int DR = KT * RPT;  // a staged row, zeros past D
  extern __shared__ float smem[];
  const int D = p.D;
  float* rs = smem;          // [Q][DR]
  float* ks = rs + Q * DR;   // [Q][DR]
  float* ws = ks + Q * DR;   // [Q][DR]
  float* vs = ws + Q * DR;   // [Q][CB]
  const int cb = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int c0 = c * Q, q = min(Q, p.L - c0);
  const int tid = threadIdx.x, cg = tid / KT, part = tid % KT;
  const int j0 = cb * CB + cg * CPT;  // this thread's first column
  // the chunk's rows of r, k, w and this block's 64 columns of v
  const long long c0l = c0;
  stage::tile<T, LOCAL_THREADS>(
      rs, DR, (const T*)p.r + b * p.r_sb + c0l * p.r_sl + h * p.r_sh,
      p.r_sl, q, Q, D, DR);
  stage::tile<T, LOCAL_THREADS>(
      ks, DR, (const T*)p.k + b * p.k_sb + c0l * p.k_sl + h * p.k_sh,
      p.k_sl, q, Q, D, DR);
  stage::tile<T, LOCAL_THREADS>(
      ws, DR, (const T*)p.w + b * p.w_sb + c0l * p.w_sl + h * p.w_sh,
      p.w_sl, q, Q, D, DR);
  stage::tile<T, LOCAL_THREADS>(
      vs, CB,
      (const T*)p.v + b * p.v_sb + c0l * p.v_sl + h * p.v_sh + cb * CB,
      p.v_sl, q, Q, D - cb * CB, CB);
  float S[RPT][CPT], W[RPT], u[RPT];
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii) {
    const int i = part + KT * ii;
#pragma unroll
    for (int n = 0; n < CPT; ++n) S[ii][n] = 0.f;
    W[ii] = 1.f;
    u[ii] = i < D ? p.u[h * D + i] : 0.f;
  }
  __syncthreads();
  float* yl = p.y_local + ((size_t)b * p.L * p.H + h) * D + j0;
  for (int t = 0; t < q; ++t) {
    const float4 v4 =
        *reinterpret_cast<const float4*>(vs + t * CB + cg * CPT);
    const float v[CPT] = {v4.x, v4.y, v4.z, v4.w};
    const float* rt = rs + t * DR + part;
    const float* kt = ks + t * DR + part;
    const float* wt = ws + t * DR + part;
    float acc[CPT] = {0.f, 0.f, 0.f, 0.f};
    float ruk = 0.f;  // sum over this thread's rows of r u k
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii) {  // rows past D are zeros
      const float r = rt[KT * ii], k = kt[KT * ii], w = wt[KT * ii];
      ruk += r * (u[ii] * k);
#pragma unroll
      for (int n = 0; n < CPT; ++n) {
        acc[n] += r * S[ii][n];
        S[ii][n] = w * S[ii][n] + k * v[n];
      }
      W[ii] *= w;
    }
#pragma unroll
    for (int n = 0; n < CPT; ++n) acc[n] += v[n] * ruk;
    // Reduce-scatter over the 8 parts (lane bits 0-2): xor 4 halves the
    // columns a lane carries, xor 2 halves them again, xor 1 completes the
    // sum of column 2 b2 + b1 on the lanes with bit 0 clear.
    const bool b2 = part & 4, b1 = part & 2;
    float k0 = b2 ? acc[2] : acc[0], k1 = b2 ? acc[3] : acc[1];
    k0 += __shfl_xor_sync(0xffffffffu, b2 ? acc[0] : acc[2], 4);
    k1 += __shfl_xor_sync(0xffffffffu, b2 ? acc[1] : acc[3], 4);
    float sum = b1 ? k1 : k0;
    sum += __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int col = (b2 ? 2 : 0) + (b1 ? 1 : 0);
    if (!(part & 1) && j0 + col < D)
      yl[(size_t)(c0 + t) * p.H * D + col] = sum;
  }
  const size_t bhc = (size_t)bh * p.nc + c;
  float* ds = p.states + bhc * D * D;
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii) {
    const int i = part + KT * ii;
    if (i >= D) continue;
#pragma unroll
    for (int n = 0; n < CPT; ++n)
      if (j0 + n < D) ds[(size_t)i * D + j0 + n] = S[ii][n];
    if (cb == 0 && cg == 0) p.decays[bhc * D + i] = W[ii];
  }
}

// b. In chunk order, S_c = diag(W_c) S_{c-1} + dS_c; the state entering
// chunk c replaces dS_c, the last state goes to s_out.
__global__ void __launch_bounds__(THREADS) wkv_pass_kernel(WkvArgs p) {
  const size_t DD = (size_t)p.D * p.D;
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= DD) return;
  const int i = (int)(e / p.D);
  float S = p.s0 != nullptr ? p.s0[bh * DD + e] : 0.f;
  float* st = p.states + (size_t)bh * p.nc * DD + e;
  const float* dec = p.decays + (size_t)bh * p.nc * p.D + i;
  constexpr int U = 8;  // chunks whose loads fly together
  for (int c0 = 0; c0 < p.nc; c0 += U) {
    float d[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < p.nc) {
        d[u] = st[(size_t)(c0 + u) * DD];
        w[u] = dec[(size_t)(c0 + u) * p.D];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < p.nc) {
        st[(size_t)(c0 + u) * DD] = S;
        S = w[u] * S + d[u];
      }
  }
  p.s_out[bh * DD + e] = S;
}

// c. y_t = y_local_t + (r_t o a_t)^T S_{c-1} over the chunk's rows.  The
// prefix products run in SEGS segments of Q / SEGS steps (a thread per
// (column, segment), then each segment scaled by the product of the ones
// before it); the product on the tensor cores, warp (wm, wn) holding rows
// 16 wm.. by the column blocks wn, wn + 2, ...
template <typename T>
__global__ void __launch_bounds__(THREADS) wkv_out_kernel(WkvArgs p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  using Acc = typename std::conditional<EXACT, float, double>::type;
  extern __shared__ float smem[];
  constexpr int SEG = Q / SEGS;
  const int D = p.D, Dp = pad16(D), LA = Dp + 4, LB = Dp + 8;
  float* ra = smem;          // [Q][Dp + 4]: r, then r o a
  float* wsm = ra + Q * LA;  // [Q][Dp + 4]
  float* ss = wsm + Q * LA;  // [Dp][Dp + 8]: the state entering the chunk
  float* seg = ss + Dp * LB; // [SEGS][Dp]: each segment's product of w
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, q = min(Q, p.L - c0);
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const size_t bhc = ((size_t)b * p.H + h) * p.nc + c;
  const long long c0l = c0;
  // The state entering the chunk by cp.async (16-byte pieces where D
  // allows): it is read last, so its copy overlaps the scan below.
  stage::tile_async<THREADS>(ss, LB, p.states + bhc * D * D, D, D, Dp, D,
                             Dp);
  stage::tile<T, THREADS>(
      ra, LA, (const T*)p.r + b * p.r_sb + c0l * p.r_sl + h * p.r_sh, p.r_sl,
      q, Q, D, Dp);
  stage::tile<T, THREADS>(
      wsm, LA, (const T*)p.w + b * p.w_sb + c0l * p.w_sl + h * p.w_sh,
      p.w_sl, q, Q, D, Dp);
  __syncthreads();
  for (int e = tid; e < SEGS * D; e += THREADS) {  // within each segment
    const int sg = e / D, i = e - sg * D;
    float a = 1.f;
    for (int t = sg * SEG; t < sg * SEG + SEG; ++t) {
      ra[t * LA + i] *= a;
      a *= wsm[t * LA + i];
    }
    seg[sg * Dp + i] = a;
  }
  __syncthreads();
  for (int e = tid; e < SEGS * D; e += THREADS) {  // the segments before
    const int sg = e / D, i = e - sg * D;
    float before = 1.f;
    for (int k = 0; k < sg; ++k) before *= seg[k * Dp + i];
    if (sg > 0)
      for (int t = sg * SEG; t < sg * SEG + SEG; ++t) ra[t * LA + i] *= before;
  }
  hopper::cp_async_wait<0>();  // this thread's pieces of the state
  __syncthreads();

  const int wm = warp % 4, wn = warp / 4;
  Acc acc[1][8][4] = {};
  chunk_mma::mma_tiles<1, 8, true, true>(
      acc, [&](int r, int k) { return ra[r * LA + k]; },
      [&](int k, int col) { return ss[k * LB + col]; }, wm, 1, 4, wn, 2,
      Dp / 8, 0, Dp);
  const float* yl = p.y_local + ((size_t)b * p.L * p.H + h) * D;
  T* y = (T*)p.y + ((size_t)b * p.L * p.H + h) * D;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = 16 * wm + g + (v >= 2 ? 8 : 0);
      const int j = 8 * (wn + 2 * nj) + 2 * t4 + (v & 1);
      if (r < q && j < D) {
        const size_t o = (size_t)(c0 + r) * p.H * D + j;
        y[o] = from_f32<T>((float)((Acc)yl[o] + acc[0][nj][v]));
      }
    }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int RPT>
int launch_rpt(const WkvArgs& p, const int* smem, cudaStream_t s) {
  const int a_bytes = 4 * local_smem_floats(RPT);
  const int c_bytes = 4 * out_smem_floats(p.D);
  if (smem[0] != a_bytes || smem[1] != c_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = set_smem(wkv_local_kernel<T, RPT>, a_bytes)) != cudaSuccess ||
      (e = set_smem(wkv_out_kernel<T>, c_bytes)) != cudaSuccess)
    return (int)e;
  const int n_cb = (p.D + CB - 1) / CB;
  wkv_local_kernel<T, RPT>
      <<<dim3(n_cb, p.nc, p.B * p.H), LOCAL_THREADS, a_bytes, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int dd_blocks = (p.D * p.D + THREADS - 1) / THREADS;
  wkv_pass_kernel<<<dim3(dd_blocks, p.B * p.H), THREADS, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wkv_out_kernel<T><<<dim3(p.nc, p.H, p.B), THREADS, c_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// rpt: wkv_plan's rows a thread of (a) holds, ceil(D / 8) rounded up to a
// power of two (at least 2).
template <typename T>
int launch(const WkvArgs& p, int rpt, const int* smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p.D < 1 || p.D > MAXD || p.L < 1 || p.nc != (p.L + Q - 1) / Q ||
      rpt * KT < p.D)
    return (int)cudaErrorInvalidValue;
  switch (rpt) {
    case 2: return launch_rpt<T, 2>(p, smem, s);
    case 4: return launch_rpt<T, 4>(p, smem, s);
    case 8: return launch_rpt<T, 8>(p, smem, s);
    case 16: return launch_rpt<T, 16>(p, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

WkvArgs make_args(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* y, float* s_out,
                  float* y_local, float* states, float* decays,
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
  p.y_local = y_local;
  p.states = states;
  p.decays = decays;
  p.B = dims[0];
  p.L = dims[1];
  p.H = dims[2];
  p.D = dims[3];
  p.nc = dims[4];
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

// dims: B, L, H, D (1..128), then wkv_plan's chunks and rows a thread.
// smem: the plan's shared bytes of kernels (a) and (c).  strides: (batch,
// step, head) element strides of r, k, v and w, in that order.  s0 may
// be null.  y_local (B, L, H, D), states (B, H, chunks, D, D) and decays
// (B, H, chunks, D), all f32, are the workspace.
int wkv6_f32(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* s0, float* y, float* s_out,
             float* y_local, float* states, float* decays, const int* dims,
             const int* smem, const long long* strides, void* stream) {
  return launch<float>(make_args(r, k, v, w, u, s0, y, s_out, y_local,
                                 states, decays, dims, strides),
                       dims[5], smem, stream);
}

int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const __nv_bfloat16* w, const float* u,
              const float* s0, __nv_bfloat16* y, float* s_out,
              float* y_local, float* states, float* decays, const int* dims,
              const int* smem, const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(make_args(r, k, v, w, u, s0, y, s_out,
                                         y_local, states, decays, dims,
                                         strides),
                               dims[5], smem, stream);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
