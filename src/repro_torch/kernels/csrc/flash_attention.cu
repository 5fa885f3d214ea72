// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_attn_kernel`). Same arithmetic: inputs cast to
// fp32 before both products, scores scaled after q.k, masked scores set to
// the finite -1e30 (kv padding, causal top-left `qpos >= kpos`, sliding
// window `kpos > qpos - window`), online softmax with fp32 running max m,
// denominator l and accumulator, output `acc / max(l, 1e-30)` rounded to
// q's dtype. It also writes the per-row log-sum-exp `m + log(max(l, 1e-30))`
// as (B, H, S) fp32 for a hand-written backward.
//
// Design. The TPU grid walks kv blocks in order on one core and carries
// (m, l, acc) in VMEM scratch between grid steps; blocks on Hopper run in
// parallel in no order, so one thread block owns one (batch, q-head, q-tile)
// and loops over the kv tiles itself, keeping m, l and acc in registers.
// A tile of 64 q rows and 64 kv rows is staged in shared memory in the input
// dtype (q and k transposed, d-major, padded by one column against bank
// conflicts); 256 threads form a 16 x 16 grid, each owning 4 q rows x 4 kv
// columns of the score tile and 4 q rows x D/16 columns of the output. Row
// max and row sum are reduced across the 16 threads of a row with warp
// shuffles. Tiles wholly past the causal diagonal or before the window are
// skipped, which leaves every row that sees at least one key unchanged. GQA
// maps q head h to kv head h / (H / KV).
//
// Shared memory: at D = 256 a block needs 115,968 bytes in bf16 and
// 215,296 in fp32, under the 232,448 a block may opt in to, so one block
// runs per SM there; each thread then holds 4 x 16 accumulators.
//
// Bound on this card: at the dense serving shapes (bf16, d = 128, causal,
// 512 positions) the least time is set by the bytes (q, k, v, out and lse
// once each) at 3.35 TB/s, just above the bf16 tensor-core operation time;
// at the hybrid shapes (d = 256, 4096 positions, window 2048) the
// operations inside the window set it. This simple kernel does its
// products with fp32 FMAs from shared memory and is far from either bound;
// wgmma and TMA come in a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 256;       // threads: a 16 x 16 grid
constexpr int RPT = BQ / 16;  // q rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H, int KV,
         float scale, int causal, int window) {
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);        // [D][BQ + 1]
  T* Ks = Qs + D * (BQ + 1);                 // [D][BK + 1]
  T* Vs = Ks + D * (BK + 1);                 // [BK][D]
  float* Ps = reinterpret_cast<float*>(Vs + BK * D);  // [BK][BQ + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t q_stride = static_cast<size_t>(H) * D;   // between positions
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Tk * kv_stride + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Tk * kv_stride + static_cast<size_t>(kvh) * D;
  const T zero = from_f<T>(0.f);

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[d * (BQ + 1) + r] = (q0 + r < S) ? qb[(q0 + r) * q_stride + d] : zero;
  }

  // kv tiles this q tile can see
  const int q_last = min(q0 + BQ, S) - 1;
  int k_end = Tk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      const bool ok = k0 + c < Tk;
      Ks[d * (BK + 1) + c] = ok ? kb[(k0 + c) * kv_stride + d] : zero;
      Vs[c * D + d] = ok ? vb[(k0 + c) * kv_stride + d] : zero;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = to_f(Qs[d * (BQ + 1) + ty * RPT + i]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = to_f(Ks[d * (BK + 1) + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && (qpos >= kpos);
        if (window > 0) ok = ok && (kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(tx + 16 * j) * (BQ + 1) + ty * RPT + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[c * (BQ + 1) + ty * RPT + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = to_f(Vs[c * D + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty * RPT + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + qpos) * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / denom);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * S + qpos] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int S, int Tk, int H, int KV, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(D) * (BQ + 1) +
                                   static_cast<size_t>(D) * (BK + 1) +
                                   static_cast<size_t>(BK) * D) +
                      sizeof(float) * BK * (BQ + 1);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, Tk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int S, int Tk, int H, int KV, int D, float scale,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, Tk, H, KV, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, Tk, H, KV, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, Tk, H, KV, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, Tk, H, KV, scale, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, S, Tk, H, KV, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,D), k and v (B,T,KV,D), o (B,S,H,D) in one dtype (0 fp32, 1 bf16),
// lse (B,H,S) fp32; all contiguous. Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int B, int S, int Tk, int H,
                                         int KV, int D, int dtype, float scale, int causal,
                                         int window, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, B, S, Tk, H, KV, D, scale, causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, Tk, H, KV, D, scale, causal,
                                     window, st);
  return cudaErrorInvalidValue;
}
