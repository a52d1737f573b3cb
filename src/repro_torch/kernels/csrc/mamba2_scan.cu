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
// The TPU kernel walks a (Bt*H, L/Q) grid whose chunk axis runs in order
// and carries the state in VMEM scratch, with Q up to 256 (a VMEM choice).
// Here one CTA owns one (b, h) pair and walks the sequence in chunks of
// Q <= 64 steps inside the CTA -- the sequential chunk axis -- with the
// state in shared memory (N x P f32, 16 KB at N = P = 64).  A Q x Q f32
// decay tile at Q = 256 would be 256 KB, over the 227 KB a block may have;
// at Q = 64 the whole working set (state, the chunk's B, C and x as f32,
// the 64 x 64 tile) is 83 KB.  The last chunk may be short, so any L
// works, and L = 1 (a decode tick) stages one row, not an empty tile.
// Per chunk, all in f32 and rounded once on the store of y:
//   cum   = inclusive cumsum of A dt (one thread, in order: Q adds)
//   G     = (C B^T) * exp(cum_t - cum_s) * dt_s on s <= t, else 0
//   y     = G x + exp(cum) * (C h)
//   h     = exp(cum_last) h + B^T (exp(cum_last - cum) dt x)
// Every exponent is <= 0 (A < 0, dt >= 0), so the form is safe.
//
// Bound on an H100: the recurrence needs about 5 N P f32 FLOP per step
// and head (decay, outer-product update, read-out) against one read of x,
// B, C and dt and one write of y, so the f32 rate bounds it (zamba2-7b's
// prefill, L = 512 and 112 heads of 64 x 64: about 1.2 GFLOP over 17 MB).
// This kernel is a SIMT loop over shared memory (each product's operands
// read from shared memory), far from that bound; mma tiles for the chunk
// products, and more CTAs per head at small batch (112 CTAs at Bt = 1),
// are later work.
//
// Operands are addressed through element strides (the last dim
// contiguous), so the model's column slices of its (B, S, d_inner + 2N)
// conv output are read in place.  y and the states are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

struct ScanArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;  // (Bt, H, N, P) or null: zero state
  void* y;          // (Bt, L, H, P), contiguous
  float* h_out;     // (Bt, H, N, P), contiguous
  int Bt, L, H, P, N, Q;
  long long x_sb, x_sl, x_sh;  // element strides: batch, step, head
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
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

// Floats of shared memory for state N x P and chunk Q.
inline size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P + (size_t)Q * (N + 1) + (size_t)Q * N +
         (size_t)Q * P + (size_t)Q * Q + 4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_kernel(ScanArgs p) {
  extern __shared__ float smem[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H;
  const int BST = N + 1;        // padded B row: lanes read distinct banks
  float* hs = smem;             // [N][P] the carried state
  float* Bs = hs + N * P;       // [Q][N + 1]
  float* Cs = Bs + Q * BST;     // [Q][N]
  float* xs = Cs + Q * N;       // [Q][P]
  float* G = xs + Q * P;        // [q][q] masked decay tile
  float* dts = G + Q * Q;       // [Q]
  float* cum = dts + Q;         // [Q] inclusive cumsum of A dt
  float* ecum = cum + Q;        // [Q] exp(cum)
  float* wgt = ecum + Q;        // [Q] exp(cum_last - cum) dt

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const float A = p.A[h];
  const T* x = (const T*)p.x + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bg = (const T*)p.B + b * p.b_sb;
  const T* Cg = (const T*)p.C + b * p.c_sb;
  T* y = (T*)p.y + ((size_t)b * p.L * H + h) * P;
  const size_t state0 = (size_t)bh * N * P;

  for (int i = tid; i < N * P; i += THREADS)
    hs[i] = p.h0 != nullptr ? p.h0[state0 + i] : 0.f;

  for (int c0 = 0; c0 < p.L; c0 += Q) {
    const int q = min(Q, p.L - c0);
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < q * P; i += THREADS) {
      const int t = i / P, j = i - t * P;
      xs[i] = to_f32(x[(c0 + t) * p.x_sl + j]);
    }
    for (int i = tid; i < q * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      Bs[t * BST + n] = to_f32(Bg[(c0 + t) * p.b_sl + n]);
      Cs[i] = to_f32(Cg[(c0 + t) * p.c_sl + n]);
    }
    if (tid < q) dts[tid] = dt[(c0 + tid) * p.dt_sl];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < q; ++t) {
        s += A * dts[t];
        cum[t] = s;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];
    if (tid < q) {
      ecum[tid] = expf(cum[tid]);
      wgt[tid] = expf(total - cum[tid]) * dts[tid];
    }
    for (int i = tid; i < q * q; i += THREADS) {
      const int t = i / q, s = i - t * q;
      float g = 0.f;
      if (s <= t) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb += Cs[t * N + n] * Bs[s * BST + n];
        g = cb * expf(cum[t] - cum[s]) * dts[s];
      }
      G[i] = g;
    }
    __syncthreads();
    for (int i = tid; i < q * P; i += THREADS) {
      const int t = i / P, j = i - t * P;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += G[t * q + s] * xs[s * P + j];
      float ch = 0.f;
      for (int n = 0; n < N; ++n) ch += Cs[t * N + n] * hs[n * P + j];
      y[(size_t)(c0 + t) * H * P + j] = from_f32<T>(acc + ecum[t] * ch);
    }
    __syncthreads();  // every read of the old state is done
    const float et = expf(total);
    for (int i = tid; i < N * P; i += THREADS) {
      const int n = i / P, j = i - n * P;
      float acc = 0.f;
      for (int s = 0; s < q; ++s) acc += Bs[s * BST + n] * wgt[s] * xs[s * P + j];
      hs[i] = hs[i] * et + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += THREADS) p.h_out[state0 + i] = hs[i];
}

template <typename T>
int launch(const ScanArgs& p, void* stream) {
  const size_t smem = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T><<<p.Bt * p.H, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

ScanArgs make_args(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* h0, void* y,
                   float* h_out, const int* dims, const long long* strides) {
  ScanArgs p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.B = B;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.h_out = h_out;
  p.Bt = dims[0];
  p.L = dims[1];
  p.H = dims[2];
  p.P = dims[3];
  p.N = dims[4];
  p.Q = dims[5];
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

// dims: Bt, L, H, P, N, Q (the chunk, 1 <= Q <= 64).  strides: x (batch,
// step, head), dt (batch, step, head), B (batch, step), C (batch, step).
// h0 may be null (zero initial state).
int mamba2_scan_f32(const float* x, const float* dt, const float* A,
                    const float* B, const float* C, const float* h0, float* y,
                    float* h_out, const int* dims, const long long* strides,
                    void* stream) {
  return launch<float>(
      make_args(x, dt, A, B, C, h0, y, h_out, dims, strides), stream);
}

int mamba2_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                     const __nv_bfloat16* B, const __nv_bfloat16* C,
                     const float* h0, __nv_bfloat16* y, float* h_out,
                     const int* dims, const long long* strides,
                     void* stream) {
  return launch<__nv_bfloat16>(
      make_args(x, dt, A, B, C, h0, y, h_out, dims, strides), stream);
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
