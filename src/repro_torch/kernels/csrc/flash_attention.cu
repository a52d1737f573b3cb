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
// state (m, l, acc) kept in f32 registers.  Kv tiles wholly outside the
// causal / window / kv_len span of the q tile are skipped, as the TPU
// kernel skips whole blocks.
//
// Bound on an H100: the smollm prefill (Sq = Skv = 512, D = 64, 15 q
// heads, causal) does 4 * D FLOP per unmasked (q, k) pair, 0.5 GFLOP, over
// 2.6 MB of q, k, v, out and lse in bf16: about 190 FLOP per byte, under
// the bf16 ridge (989 TFLOP/s over 3.35 TB/s, about 295), so HBM bounds
// it with the tensor cores close behind; a launch is 0.8 us at that bound,
// so at 120 CTAs per launch latency, not either rate, sets its time.
//
// Two paths; the wrapper (kernels/flash_attention/kernel.py::flash_plan)
// picks one by type and alignment:
//
// mma (bf16, D % 8 == 0, base pointers and strides 16-byte aligned): an
//   FA2-style CTA of 4 warps, each owning 16 q rows as one m16 row block.
//   Q is read once into bf16 A fragments in registers; K and V tiles stay
//   bf16 in shared memory, double-buffered through 16-byte cp.async (rows
//   past Skv and columns past D zero-filled), 16-byte chunks XOR-swizzled
//   by row % 8 so ldmatrix reads them without bank conflicts
//   (flash_mma.cuh).  S = Q K^T runs on mma.sync m16n8k16 with f32
//   accumulators, K taken by ldmatrix as it lies; the mask arithmetic runs
//   only on tiles that cross an edge; the online softmax runs on the
//   accumulator fragments (a row's max and sum over its quad of lanes by
//   shuffles).  P goes from the S accumulators straight into A fragments
//   (the m16n8 C layout is the m16k16 A layout), split into bf16 hi + lo,
//   two mma into one f32 accumulator: P V sums P to about 16 bits, as the
//   f32 plain version does to 24, not to bf16's 8.  V is taken by
//   ldmatrix.trans.  The head dim runs on the next multiple of 16 (7 k
//   steps at zamba2-7b's 112).  Under causal the grid runs the heaviest q
//   tiles first.  O / max(l, 1e-30) is rounded once to bf16.
// simt (f32, whose 1e-4 checks tensor cores would miss as TF32, and
//   unaligned bf16): Q, K and V staged in shared memory as f32 (65 KB at
//   D = 64, 113 KB at D = 128); each warp owns 16 q rows, each lane two kv
//   columns of the score tile and D/32 output columns, f32 FMAs; the head
//   dim runs on the next multiple of 32, zero-filled past D.
//
// Operands are addressed through element strides (D contiguous), so the
// executor's transposed head views are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

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
int launch(const FlashArgs& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * DPL);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<T, DPL><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// plan: the wrapper's flash_plan, (d_tile, grid x, grid y).
template <typename T>
int dispatch(const FlashArgs& p, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(plan[1], plan[2]);
  if (plan[0] < p.D) return (int)cudaErrorInvalidValue;
  switch (plan[0]) {  // the tile: 32 columns a lane group
    case 32:
      return launch<T, 1>(p, grid, s);
    case 64:
      return launch<T, 2>(p, grid, s);
    case 96:
      return launch<T, 3>(p, grid, s);
    case 128:
      return launch<T, 4>(p, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// --- mma path (bf16, 16-byte-aligned operands) ------------------------------
// Grid (B * Hq, q tiles); under causal the q tiles run heaviest first.
// Warp w owns q rows [16 w, 16 w + 16) of the CTA's 64 as one m16 row
// block: Q as A fragments in registers, S = Q K^T on mma with K read by
// ldmatrix as it lies, the online softmax on the accumulator fragments
// (a row lives in the 4 lanes of a quad), and P V with P passed from the
// S accumulators to A fragments in registers, split hi + lo, and V read
// by ldmatrix.trans.  K and V tiles are double-buffered.
template <int DT>
__global__ void __launch_bounds__(flash_mma::THREADS)
    flash_mma_kernel(FlashArgs p) {
  using namespace flash_mma;
  using TL = Tile<DT>;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
  bf16* sK = sQ + TL::ELEMS;      // [2][tile]
  bf16* sV = sK + 2 * TL::ELEMS;  // [2][tile]

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* q = (const bf16*)p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = (const bf16*)p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = (const bf16*)p.v + b * p.v_sb + hk * p.v_sh;

  // The kv tiles some row of this q tile can attend.
  const int kv_len = min(p.kv_len, p.Skv);
  int t_end = (kv_len + ROWS - 1) / ROWS;
  if (p.causal) t_end = min(t_end, (q0 + ROWS - 1) / ROWS + 1);
  int t_begin = 0;
  if (p.window > 0) t_begin = max(0, q0 - p.window + 1) / ROWS;

  load_tile<DT>(sQ, q, p.q_ss, q0, p.Sq, p.D);
  if (t_begin < t_end) {
    load_tile<DT>(sK, k, p.k_ss, t_begin * ROWS, p.Skv, p.D);
    load_tile<DT>(sV, v, p.v_ss, t_begin * ROWS, p.Skv, p.D);
  }
  cp_async_commit();

  uint32_t qf[TL::KS][4];
  float o[TL::NT][4];
#pragma unroll
  for (int n = 0; n < TL::NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<DT>(sK + (buf ^ 1) * TL::ELEMS, k, p.k_ss, (t + 1) * ROWS,
                    p.Skv, p.D);
      load_tile<DT>(sV + (buf ^ 1) * TL::ELEMS, v, p.v_ss, (t + 1) * ROWS,
                    p.Skv, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < TL::KS; ++kk) frag_a<DT>(qf[kk], sQ, r0, kk);
    }
    const bf16* cK = sK + buf * TL::ELEMS;
    const bf16* cV = sV + buf * TL::ELEMS;
    const int k0 = t * ROWS;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TL::KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        frag_b_rows<DT>(kb, cK, jp * 16, kk);
        mma_bf16_16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }
    const bool edge = crosses_edge(q0, k0, kv_len, p.causal, p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= p.scale;
        if (edge && !visible(q0 + r0 + g + ((e >> 1) << 3),
                             k0 + j * 8 + 2 * t4 + (e & 1), kv_len,
                             p.causal, p.window))
          s[j][e] = NEG_INF;
      }

    // Online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < TL::NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over the tile's 64 keys, 16 a step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t phi[4], plo[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], phi, plo);
#pragma unroll
      for (int jp = 0; jp < TL::NT / 2; ++jp) {
        uint32_t vb[4];
        frag_b_cols<DT>(vb, cV, kk * 16, jp);
        mma_split(o[2 * jp], phi, plo, vb[0], vb[1]);
        mma_split(o[2 * jp + 1], phi, plo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  bf16* out = (bf16*)p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < TL::NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.D)
        store2(out + qi * p.o_ss + col, o[n][2 * r] / lc,
               o[n][2 * r + 1] / lc);
    }
    if (t4 == 0) p.lse[(size_t)bh * p.Sq + qi] = m[r] + logf(lc);
  }
}

template <int DT>
int launch_mma(const FlashArgs& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = 5 * flash_mma::Tile<DT>::ELEMS * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_mma_kernel<DT><<<grid, flash_mma::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_mma(const FlashArgs& p, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(plan[1], plan[2]);
  if (p.D < 8 || p.D % 8 || plan[0] < p.D) return (int)cudaErrorInvalidValue;
  switch (plan[0]) {  // the tile: the head dim rounded up to 16
    case 16:
      return launch_mma<16>(p, grid, s);
    case 32:
      return launch_mma<32>(p, grid, s);
    case 48:
      return launch_mma<48>(p, grid, s);
    case 64:
      return launch_mma<64>(p, grid, s);
    case 80:
      return launch_mma<80>(p, grid, s);
    case 96:
      return launch_mma<96>(p, grid, s);
    case 112:
      return launch_mma<112>(p, grid, s);
    case 128:
      return launch_mma<128>(p, grid, s);
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

// dims: B, Hq, Hkv, Sq, Skv, D (1 <= D <= 128).  strides: (batch, head,
// row) element strides of q, k, v and out, in that order.  plan: the
// wrapper's flash_plan, (d_tile, grid x, grid y), launched as given.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, float* lse, const int* dims,
                        const long long* strides, const int* plan,
                        float scale, int causal, int window, int kv_len,
                        void* stream) {
  return dispatch<float>(make_args(q, k, v, out, lse, dims, strides, scale,
                                   causal, window, kv_len),
                         plan, stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* out,
                         float* lse, const int* dims,
                         const long long* strides, const int* plan,
                         float scale, int causal, int window, int kv_len,
                         void* stream) {
  return dispatch<__nv_bfloat16>(make_args(q, k, v, out, lse, dims, strides,
                                           scale, causal, window, kv_len),
                                 plan, stream);
}

// The tensor-core path: bf16, D % 8 == 0, every base pointer and
// stride a multiple of 16 bytes (the wrapper's flash_plan checks).
int flash_attention_mma_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* out,
                             float* lse, const int* dims,
                             const long long* strides, const int* plan,
                             float scale, int causal, int window, int kv_len,
                             void* stream) {
  return dispatch_mma(make_args(q, k, v, out, lse, dims, strides, scale,
                                causal, window, kv_len),
                      plan, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
