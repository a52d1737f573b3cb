// Mamba2 selective state-space scan (SSD) for Hopper (sm_90a), f32 or bf16
// x, B and C; f32 dt, A and state.
//
// Replaces repro/kernels/mamba2/kernel.py::mamba2_scan_pallas: per batch b
// and head h, with the state h (N, P) starting at h0 (or zero),
//     h_t = exp(A_h dt_t) h_{t-1} + B_t^T (dt_t x_t),   y_t = C_t h_t,
// for x (Bt, L, H, P), dt (Bt, L, H), A (H,), B and C (Bt, L, N) shared
// across heads (one group).  Returns y in x's type and the final state
// (Bt, H, N, P) in f32.  D-skip is added by the caller (mamba2/ops.py), as
// in the reference.
//
// Bound on an H100: in the chunked (SSD) form a chunk of Q steps is four
// products of about 2 Q^2 N (or Q N P) FLOP on the tensor cores and one
// pass over the operands; zamba2-7b's prefill (L = 512, 112 heads, N = P =
// 64) reads and writes about 17 MB, so at batch 1 neither bytes nor the
// tensor cores are the limit: latency and filling 132 SMs are.  The TPU
// kernel walks a (Bt*H, L/Q) grid whose chunk axis runs in order with the
// state in VMEM; here the chunks of a head run in parallel, and only the
// (N, P) state is carried in order, elementwise:
//
//   a. ssd_state_kernel, one CTA per (chunk, head, batch): the chunk's
//      inclusive cumsum of A dt (a warp scan), then its local state
//      dS_c = (B o w)^T x with w_s = exp(total - cum_s) dt_s, on mma;
//      dS_c and total_c go to a workspace.
//   b. ssd_pass_kernel, a thread per state element of a (batch, head):
//      in chunk order, S_c = exp(total_c) S_{c-1} + dS_c, the state
//      entering chunk c written over dS_c, the last one to h_out.
//   c. ssd_out_kernel, one CTA per (chunk, head, batch): the same cumsum,
//      CB^T on mma, the masked decay G = CB^T o exp(cum_t - cum_s) dt_s
//      (s <= t) into shared memory, then y = G x + exp(cum) o (C S_{c-1})
//      on mma, rounded once to y's type.
//
// The products run on the tensor cores (csrc/chunk_mma.cuh).  bf16 x, B
// and C (the served type) take mma.sync m16n8k8 in TF32: a bf16 value is
// exact in TF32, so C B^T is one product, and the f32 side of the others
// (the decay-weighted G, B o w, the state) is split in two TF32 parts.
// f32 x, B and C take the FP64 tensor cores (m8n8k4), products and sums
// exact in f64, y rounded once: y's terms (about 50) cancel to outputs
// near 0, where the f32 plain version allows 1e-4.  For the same reason
// the chunk's cumsum of A dt is carried in f64: exp(cum_t - cum_s) of
// two f32 prefix sums near -300 with unrelated roundings was off by 1e-4
// relative, 1.9e-4 in y at L = 2048 (an H100).  Every exponent is <= 0
// (A < 0, dt >= 0).  The chunk is Q = 64 rows; the last may be short (its
// padding rows are zero, dt = 0).  P and N are padded to 16 in shared
// memory with zeros, up to 128.  No atomics and a fixed order everywhere:
// the same bits run to run, and a launch reads nothing on the host, so it
// can be captured in a CUDA graph.
//
// A decode tick (L <= STEP_MAX) takes ssd_step_kernel instead: one CTA per
// (head, batch), the state copied into shared memory in 16-byte pieces,
// the L steps of the recurrence over it, y reduced over N in a fixed
// order: the state's bytes bound a tick.
//
// ssd_plan in kernels/mamba2/kernel.py picks the path, the chunk and the
// grids from shapes alone; the launcher holds the plan's shared bytes to
// its own count and launches what it is given.  Operands are addressed
// through element strides (the last dim contiguous), so the model's column
// slices of its (B, S, d_inner + 2N) conv output are read in place.  y and
// the states are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "chunk_mma.cuh"
#include "stage.cuh"

namespace {

constexpr int Q = 64;          // chunk rows
constexpr int THREADS = 256;   // 8 warps a CTA
constexpr int MAXW = 128;      // P and N at most
constexpr int STEP_MAX = 16;   // steps the decode path stages

struct ScanArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;     // (Bt, H, N, P) or null: zero state
  void* y;             // (Bt, L, H, P), contiguous
  float* h_out;        // (Bt, H, N, P), contiguous
  float* states;       // (Bt, H, nc, N, P): dS_c, then the state entering c
  float* totals;       // (Bt, H, nc): sum of A dt over chunk c
  int Bt, L, H, P, N;
  int nc, Pp, Np;      // chunks; P and N padded to 16
  int vec;             // h0 and h_out may be copied in 16-byte pieces
  long long x_sb, x_sl, x_sh;  // element strides: batch, step, head
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
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

// Thread tid < Q's dt of the chunk (zero past its q rows), loaded before
// the tiles so that its latency overlaps theirs.
__device__ __forceinline__ float chunk_dt(const ScanArgs& p, int b, int h,
                                          int c0, int q) {
  const int tid = threadIdx.x;
  return tid < q ? p.dt[b * p.dt_sb + (long long)(c0 + tid) * p.dt_sl +
                        h * p.dt_sh]
                 : 0.f;
}

// The chunk's dt (dtv: chunk_dt's value) and the inclusive cumsum of A dt
// (each A dt rounded to f32, as the plain version takes it), in f64: lane
// l of warp 0 adds rows 2l and 2l + 1, then a warp scan of the pair sums.
// Starts and ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(float dtv, float A, float* dts,
                                             double* cum) {
  const int tid = threadIdx.x;
  if (tid < Q) dts[tid] = dtv;
  __syncthreads();
  if (tid < 32) {
    const double s0 = A * dts[2 * tid];
    const double s1 = s0 + A * dts[2 * tid + 1];
    double v = s1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, v, off);
      if (tid >= off) v += n;
    }
    double excl = __shfl_up_sync(0xffffffffu, v, 1);
    if (tid == 0) excl = 0.0;
    cum[2 * tid] = excl + s0;
    cum[2 * tid + 1] = excl + s1;
  }
  __syncthreads();
}

// Shared floats of each kernel (the plan's smem is held to these).
// (dt, the f64 cumsum and one more row vector take 4 Q floats.)
__host__ __device__ constexpr int state_smem_floats(int Pp, int Np) {
  return Q * (Pp + 8) + Q * (Np + 8) + 4 * Q;
}
__host__ __device__ constexpr int bg_stride(int Np) {
  return Np + 4 > Q + 4 ? Np + 4 : Q + 4;
}
__host__ __device__ constexpr int out_smem_floats(int Pp, int Np) {
  return Q * (Np + 4) + Q * bg_stride(Np) + Q * (Pp + 8) + Np * (Pp + 8) +
         4 * Q;
}
__host__ __device__ constexpr int step_smem_floats(int L, int P, int N) {
  return N * P + L * (P + 2 * N + 1) + THREADS;
}

// a. The chunk's local state dS = (B o w)^T x, (Np x Pp) over K = Q.  A
// warp holds MI 16-row blocks by NJ 8-column blocks: (1, 4) up to P = N =
// 64, (2, 8) up to 128.
template <typename T, int MI, int NJ>
__global__ void __launch_bounds__(THREADS) ssd_state_kernel(ScanArgs p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  using Acc = typename std::conditional<EXACT, float, double>::type;
  extern __shared__ float smem[];
  const int XS = p.Pp + 8, WS = p.Np + 8;
  float* xs = smem;             // [Q][Pp + 8]
  float* bw = xs + Q * XS;      // [Q][Np + 8]: B o w
  float* dts = bw + Q * WS;     // [Q]
  double* cum = reinterpret_cast<double*>(dts + Q);  // [Q]
  float* wgt = dts + 3 * Q;     // [Q]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, q = min(Q, p.L - c0);
  const int tid = threadIdx.x, warp = tid / 32;
  const long long c0l = c0;
  const float dtv = chunk_dt(p, b, h, c0, q);
  stage::tile<T, THREADS>(
      xs, XS, (const T*)p.x + b * p.x_sb + c0l * p.x_sl + h * p.x_sh, p.x_sl,
      q, Q, p.P, p.Pp);
  stage::tile<T, THREADS>(bw, WS, (const T*)p.B + b * p.b_sb + c0l * p.b_sl,
                          p.b_sl, q, Q, p.N, p.Np);
  chunk_cumsum(dtv, p.A[h], dts, cum);
  const double total = cum[q - 1];
  if (tid < Q) wgt[tid] = expf((float)(total - cum[tid])) * dts[tid];
  __syncthreads();
  for (int i = tid; i < Q * p.Np; i += THREADS) {
    const int s = i / p.Np, n = i - s * p.Np;
    bw[s * WS + n] *= wgt[s];
  }
  __syncthreads();

  const int wm = warp % 4, wn = warp / 4;
  Acc acc[MI][NJ][4] = {};
  chunk_mma::mma_tiles<MI, NJ, true, !EXACT>(
      acc, [&](int r, int k) { return bw[k * WS + r]; },
      [&](int k, int col) { return xs[k * XS + col]; }, wm, 4, p.Np / 16,
      wn, 2, p.Pp / 8, 0, Q);

  const size_t NP = (size_t)p.N * p.P;
  const size_t bhc = ((size_t)b * p.H + h) * p.nc + c;
  float* ds = p.states + bhc * NP;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = 16 * (wm + 4 * mi) + g + (v >= 2 ? 8 : 0);
        const int col = 8 * (wn + 2 * nj) + 2 * t + (v & 1);
        if (n < p.N && col < p.P)
          ds[(size_t)n * p.P + col] = (float)acc[mi][nj][v];
      }
  if (tid == 0) p.totals[bhc] = (float)total;
}

// b. In chunk order, S_c = exp(total_c) S_{c-1} + dS_c; the state entering
// chunk c replaces dS_c, the last state goes to h_out.
__global__ void __launch_bounds__(THREADS) ssd_pass_kernel(ScanArgs p) {
  const size_t NP = (size_t)p.N * p.P;
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= NP) return;
  float S = p.h0 != nullptr ? p.h0[bh * NP + e] : 0.f;
  float* st = p.states + (size_t)bh * p.nc * NP + e;
  const float* tot = p.totals + (size_t)bh * p.nc;
  constexpr int U = 8;  // chunks whose loads fly together
  for (int c0 = 0; c0 < p.nc; c0 += U) {
    float d[U], et[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < p.nc) {
        d[u] = st[(size_t)(c0 + u) * NP];
        et[u] = tot[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < p.nc) {
        st[(size_t)(c0 + u) * NP] = S;
        S = S * expf(et[u]) + d[u];
      }
  }
  p.h_out[bh * NP + e] = S;
}

// c. y = G x + exp(cum) o (C S_{c-1}) for the chunk's rows, (Q x Pp); a
// warp holds 16 rows by NJ 8-column blocks (4 up to P = 64, 8 up to 128).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) ssd_out_kernel(ScanArgs p) {
  constexpr bool EXACT = !std::is_same<T, float>::value;
  using Acc = typename std::conditional<EXACT, float, double>::type;
  extern __shared__ float smem[];
  const int CS = p.Np + 4, BG = bg_stride(p.Np), XS = p.Pp + 8,
            SS = p.Pp + 8, GS = Q + 4;
  float* cs = smem;             // [Q][Np + 4]
  float* bs = cs + Q * CS;      // [Q][Np + 4], then G [Q][Q + 4]
  float* xs = bs + Q * BG;      // [Q][Pp + 8]
  float* ss = xs + Q * XS;      // [Np][Pp + 8]: the state entering c
  float* dts = ss + p.Np * SS;  // [Q]
  double* cum = reinterpret_cast<double*>(dts + Q);  // [Q]
  float* ecum = dts + 3 * Q;    // [Q]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * Q, q = min(Q, p.L - c0);
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t bhc = ((size_t)b * p.H + h) * p.nc + c;
  const long long c0l = c0;
  // The state entering the chunk (f32) by cp.async where it can go in
  // 16-byte pieces: it is read last, so its copy overlaps the rest.
  stage::tile_async<THREADS>(ss, SS, p.states + bhc * p.N * p.P, p.P, p.N,
                             p.Np, p.P, p.Pp);
  const float dtv = chunk_dt(p, b, h, c0, q);
  stage::tile<T, THREADS>(cs, CS, (const T*)p.C + b * p.c_sb + c0l * p.c_sl,
                          p.c_sl, q, Q, p.N, p.Np);
  stage::tile<T, THREADS>(bs, CS, (const T*)p.B + b * p.b_sb + c0l * p.b_sl,
                          p.b_sl, q, Q, p.N, p.Np);
  stage::tile<T, THREADS>(
      xs, XS, (const T*)p.x + b * p.x_sb + c0l * p.x_sl + h * p.x_sh, p.x_sl,
      q, Q, p.P, p.Pp);
  chunk_cumsum(dtv, p.A[h], dts, cum);
  if (tid < Q) ecum[tid] = expf((float)cum[tid]);

  // C B^T for this warp's 16 rows: column blocks past them are masked.
  const int wm = warp % 4, wn = warp / 4;
  Acc cb[1][4][4] = {};
  chunk_mma::mma_tiles<1, 4, !EXACT, !EXACT>(
      cb, [&](int r, int k) { return cs[r * CS + k]; },
      [&](int k, int col) { return bs[col * CS + k]; }, wm, 1, 4, wn, 2,
      2 * wm + 2, 0, p.Np);
  __syncthreads();  // every warp is done with B: G goes over it
  float* gs = bs;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int nb = wn + 2 * nj;
    if (nb >= 2 * wm + 2) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = 16 * wm + g + (v >= 2 ? 8 : 0);
      const int s = 8 * nb + 2 * t + (v & 1);
      gs[r * GS + s] =
          s <= r ? (float)cb[0][nj][v] * expf((float)(cum[r] - cum[s])) *
                       dts[s]
                 : 0.f;
    }
  }
  hopper::cp_async_wait<0>();  // this thread's pieces of the state
  __syncthreads();

  Acc ya[1][NJ][4] = {}, sa[1][NJ][4] = {};
  chunk_mma::mma_tiles<1, NJ, true, !EXACT>(
      ya, [&](int r, int k) { return gs[r * GS + k]; },
      [&](int k, int col) { return xs[k * XS + col]; }, wm, 1, 4, wn, 2,
      p.Pp / 8, 0, 16 * (wm + 1));
  chunk_mma::mma_tiles<1, NJ, !EXACT, true>(
      sa, [&](int r, int k) { return cs[r * CS + k]; },
      [&](int k, int col) { return ss[k * SS + col]; }, wm, 1, 4, wn, 2,
      p.Pp / 8, 0, p.Np);

  T* y = (T*)p.y;
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = 16 * wm + g + (v >= 2 ? 8 : 0);
      const int col = 8 * (wn + 2 * nj) + 2 * t + (v & 1);
      if (r < q && col < p.P)
        y[(((size_t)b * p.L + c0 + r) * p.H + h) * p.P + col] =
            from_f32<T>(
                (float)(ya[0][nj][v] + (Acc)ecum[r] * sa[0][nj][v]));
    }
}

// The decode path: L <= STEP_MAX steps of the recurrence over the state in
// shared memory, one CTA per (head, batch).  Thread (ng, col) updates rows
// ng, ng + NG, ... of column col (NG = THREADS / P groups); y[col] is the
// groups' partial sums added in group order.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_step_kernel(ScanArgs p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, L = p.L;
  const int NP = N * P;
  float* hs = smem;             // [N][P]
  float* xs = hs + NP;          // [L][P]
  float* bsm = xs + L * P;      // [L][N]
  float* csm = bsm + L * N;     // [L][N]
  float* dts = csm + L * N;     // [L]
  float* red = dts + L;         // [THREADS]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t state0 = ((size_t)b * p.H + h) * NP;
  if (p.h0 == nullptr) {
    for (int i = tid; i < NP; i += THREADS) hs[i] = 0.f;
  } else if (p.vec) {
    const float4* src = (const float4*)(p.h0 + state0);
    for (int i = tid; i < NP / 4; i += THREADS)
      ((float4*)hs)[i] = src[i];
  } else {
    for (int i = tid; i < NP; i += THREADS) hs[i] = p.h0[state0 + i];
  }
  const T* x = (const T*)p.x + b * p.x_sb + h * p.x_sh;
  const T* Bg = (const T*)p.B + b * p.b_sb;
  const T* Cg = (const T*)p.C + b * p.c_sb;
  for (int i = tid; i < L * P; i += THREADS) {
    const int t = i / P, j = i - t * P;
    xs[i] = stage::to_f32(x[t * p.x_sl + j]);
  }
  for (int i = tid; i < L * N; i += THREADS) {
    const int t = i / N, n = i - t * N;
    bsm[i] = stage::to_f32(Bg[t * p.b_sl + n]);
    csm[i] = stage::to_f32(Cg[t * p.c_sl + n]);
  }
  if (tid < L) dts[tid] = p.dt[b * p.dt_sb + tid * p.dt_sl + h * p.dt_sh];
  __syncthreads();

  const float A = p.A[h];
  const int NG = THREADS / P;  // P <= MAXW < THREADS
  const int ng = tid / P, col = tid - ng * P;
  T* y = (T*)p.y + (size_t)b * L * p.H * P + (size_t)h * P;
  for (int t = 0; t < L; ++t) {
    const float dt = dts[t];
    const float decay = expf(A * dt);
    float part = 0.f;
    if (ng < NG) {
      const float xd = xs[t * P + col] * dt;
      for (int n = ng; n < N; n += NG) {
        const float hn = hs[n * P + col] * decay + bsm[t * N + n] * xd;
        hs[n * P + col] = hn;
        part += csm[t * N + n] * hn;
      }
    }
    red[tid] = part;
    __syncthreads();
    if (tid < P) {
      float acc = 0.f;
      for (int k = 0; k < NG; ++k) acc += red[k * P + tid];
      y[(size_t)t * p.H * P + tid] = from_f32<T>(acc);
    }
    __syncthreads();
  }
  if (p.vec) {
    float4* dst = (float4*)(p.h_out + state0);
    for (int i = tid; i < NP / 4; i += THREADS) dst[i] = ((float4*)hs)[i];
  } else {
    for (int i = tid; i < NP; i += THREADS) p.h_out[state0 + i] = hs[i];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The chunked path's three kernels, with MI x NJ blocks a warp.
template <typename T, int MI, int NJ>
int launch_chunked(const ScanArgs& p, int a_bytes, int c_bytes,
                   cudaStream_t s) {
  cudaError_t e;
  if ((e = set_smem(ssd_state_kernel<T, MI, NJ>, a_bytes)) != cudaSuccess ||
      (e = set_smem(ssd_out_kernel<T, NJ>, c_bytes)) != cudaSuccess)
    return (int)e;
  const dim3 chunks(p.nc, p.H, p.Bt);
  ssd_state_kernel<T, MI, NJ><<<chunks, THREADS, a_bytes, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int np_blocks = (p.N * p.P + THREADS - 1) / THREADS;
  ssd_pass_kernel<<<dim3(np_blocks, p.Bt * p.H), THREADS, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_out_kernel<T, NJ><<<chunks, THREADS, c_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// path 0: the decode path (L <= STEP_MAX), one kernel; path 1: the chunked
// path, three kernels.  smem: the plan's shared bytes of each kernel it
// launches (a and c, or the step kernel and 0), held to this file's.
template <typename T>
int launch(const ScanArgs& p, int path, const int* smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p.P < 1 || p.P > MAXW || p.N < 1 || p.N > MAXW || p.L < 1 ||
      p.Pp != (p.P + 15) / 16 * 16 || p.Np != (p.N + 15) / 16 * 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (path == 0) {
    const int bytes = 4 * step_smem_floats(p.L, p.P, p.N);
    if (p.L > STEP_MAX || smem[0] != bytes) return (int)cudaErrorInvalidValue;
    if ((e = set_smem(ssd_step_kernel<T>, bytes)) != cudaSuccess)
      return (int)e;
    ssd_step_kernel<T><<<dim3(p.H, p.Bt), THREADS, bytes, s>>>(p);
    return (int)cudaGetLastError();
  }
  const int a_bytes = 4 * state_smem_floats(p.Pp, p.Np);
  const int c_bytes = 4 * out_smem_floats(p.Pp, p.Np);
  if (path != 1 || p.nc != (p.L + Q - 1) / Q || smem[0] != a_bytes ||
      smem[1] != c_bytes || p.states == nullptr || p.totals == nullptr)
    return (int)cudaErrorInvalidValue;
  return p.Pp > 64 || p.Np > 64
             ? launch_chunked<T, 2, 8>(p, a_bytes, c_bytes, s)
             : launch_chunked<T, 1, 4>(p, a_bytes, c_bytes, s);
}

ScanArgs make_args(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* h0, void* y,
                   float* h_out, float* states, float* totals,
                   const int* dims, const long long* strides) {
  ScanArgs p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.B = B;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.h_out = h_out;
  p.states = states;
  p.totals = totals;
  p.Bt = dims[0];
  p.L = dims[1];
  p.H = dims[2];
  p.P = dims[3];
  p.N = dims[4];
  p.nc = dims[6];
  p.Pp = dims[7];
  p.Np = dims[8];
  p.vec = dims[9];
  p.x_sb = strides[0];
  p.x_sl = strides[1];
  p.x_sh = strides[2];
  p.dt_sb = strides[3];
  p.dt_sl = strides[4];
  p.dt_sh = strides[5];
  p.b_sb = strides[6];
  p.b_sl = strides[7];
  p.c_sb = strides[8];
  p.c_sl = strides[9];
  return p;
}

}  // namespace

extern "C" {

// dims: Bt, L, H, P, N, then ssd_plan's path (0 step, 1 chunked), chunks,
// padded P and N, and 1 if h0 and h_out take 16-byte copies.  smem: the
// plan's shared bytes (step kernel, or kernels a and c).  strides: x
// (batch, step, head), dt (batch, step, head), B (batch, step), C (batch,
// step).  h0 may be null (zero initial state); states (Bt, H, chunks, N,
// P) and totals (Bt, H, chunks) f32 are the chunked path's workspace.
int mamba2_scan_f32(const float* x, const float* dt, const float* A,
                    const float* B, const float* C, const float* h0, float* y,
                    float* h_out, float* states, float* totals,
                    const int* dims, const int* smem,
                    const long long* strides, void* stream) {
  return launch<float>(make_args(x, dt, A, B, C, h0, y, h_out, states,
                                 totals, dims, strides),
                       dims[5], smem, stream);
}

int mamba2_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                     const __nv_bfloat16* B, const __nv_bfloat16* C,
                     const float* h0, __nv_bfloat16* y, float* h_out,
                     float* states, float* totals, const int* dims,
                     const int* smem, const long long* strides,
                     void* stream) {
  return launch<__nv_bfloat16>(make_args(x, dt, A, B, C, h0, y, h_out,
                                         states, totals, dims, strides),
                               dims[5], smem, stream);
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
