// Flash attention backward for Hopper (sm_90a), SIMT, bound to Python with
// ctypes: the route of every call the sm90 backward does not take (fp32
// inputs, or bf16 at head dim 16, 32 or 256).
//
// Replaces the XLA backward that the reference pairs with its Pallas kernel
// (src/repro/kernels/ops.py `_fa_bwd` -> src/repro/models/common.py
// `_flash_vjp_bwd`): from q, k, v, the forward's out and LSE and the
// cotangent dO, with D = rowsum(dO * O),
//   P = exp(q.k^T / sqrt(d) - LSE)   (0 where the forward masked: kv padding,
//                                     causal top-left, window
//                                     kpos > qpos - window),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) / sqrt(d),
//   dQ = dS K,    dK = dS^T Q,
// GQA heads folded onto kv head h / (H / KV). P and dS are rounded to the
// inputs' dtype before their products, as the plain version
// (models/common.py `flash_attention_bwd`) rounds them; every sum is fp32.
// A q row that sees no key at all gets zero gradients.
//
// Design. One block per (kv tile of 32 rows, q head, batch), 256 threads,
// looping over the q tiles of 32 rows that can see the kv tile (from the
// diagonal on when causal, up to the window's end). K, V, Q, dO and the
// P / dS tile sit in shared memory as fp32 (rows padded by one against bank
// conflicts); each thread computes 2 x 2 entries of S and dP, then owns one
// kv row's D/8 columns of dK and dV in registers and one q row's D/8
// columns of the tile's dQ, which it adds into an fp32 (B,S,H,D)
// accumulator with atomics. dK and dV are added into fp32 (B,T,KV,D)
// accumulators at the end (atomics: the q heads of a GQA group share them).
// csrc/attention_bwd.cuh computes D; attn_bwd_post rounds the accumulators
// to the inputs' dtype at the end.
//
// What bounds it: the products, 2.5 times the forward's, here on fp32 FMAs
// from shared memory, far from the tensor cores' rate; the bf16 training
// shapes at head dim 64 and 128 take csrc/flash_attention_bwd_sm90.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_bwd.cuh"

namespace {

constexpr int BQ = 32;   // q rows per tile of the loop
constexpr int BK = 32;   // kv rows per block
constexpr int NT = 256;  // threads

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (D + 1) +
                          2 * BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dq_acc,
         float* __restrict__ dk_acc, float* __restrict__ dv_acc, int S, int S_pad, int Tk,
         int H, int KV, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / 8;  // dK, dV and dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* dOs = Qs + BQ * LD;        // [BQ][LD]
  float* Ks = dOs + BQ * LD;        // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ps = Vs + BK * LD;         // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);  // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);  // [BQ]
  float* Ds = Ls + BQ;              // [BQ]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // S and dP: rows ty, ty + 16; cols tx, tx + 16
  const int own = tid / 8;                 // the kv row (dK, dV) and q row (dQ) it owns
  const int c0 = tid % 8;                  // its columns c0 + 8m
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t rows = (static_cast<size_t>(b) * H + h) * S_pad;

  // q tiles that see a key of this kv tile
  const int q_begin = causal ? k0 : 0;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + BK - 1 + window);
  const int qt_begin = q_begin / BQ;
  const int qt_end = (q_end + BQ - 1) / BQ;
  if (qt_end <= qt_begin) return;  // no q row sees these keys: dK and dV stay 0

  for (int e = tid; e < BK * D; e += NT) {
    const int r = e / D, d = e % D;
    const bool ok = k0 + r < Tk;
    const size_t at = static_cast<size_t>(b) * Tk * kv_stride +
                      static_cast<size_t>(k0 + r) * kv_stride + static_cast<size_t>(kvh) * D + d;
    Ks[r * LD + d] = ok ? to_f(k[at]) : 0.f;
    Vs[r * LD + d] = ok ? to_f(v[at]) : 0.f;
  }

  float dk[CPT], dv[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) dk[m] = dv[m] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e % D;
      const bool ok = q0 + r < S;
      const size_t at = (static_cast<size_t>(b) * S + q0 + r) * q_stride +
                        static_cast<size_t>(h) * D + d;
      Qs[r * LD + d] = ok ? to_f(q[at]) : 0.f;
      dOs[r * LD + d] = ok ? to_f(dout[at]) : 0.f;
    }
    if (tid < BQ) {
      Ls[tid] = lse[rows + q0 + tid];
      Ds[tid] = delta[rows + q0 + tid];
    }
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa = Qs[ty * LD + d], qb = Qs[(ty + 16) * LD + d];
      const float ga = dOs[ty * LD + d], gb = dOs[(ty + 16) * LD + d];
      const float ka = Ks[tx * LD + d], kb = Ks[(tx + 16) * LD + d];
      const float va = Vs[tx * LD + d], vb = Vs[(tx + 16) * LD + d];
      s[0][0] = fmaf(qa, ka, s[0][0]);
      s[0][1] = fmaf(qa, kb, s[0][1]);
      s[1][0] = fmaf(qb, ka, s[1][0]);
      s[1][1] = fmaf(qb, kb, s[1][1]);
      dp[0][0] = fmaf(ga, va, dp[0][0]);
      dp[0][1] = fmaf(ga, vb, dp[0][1]);
      dp[1][0] = fmaf(gb, va, dp[1][0]);
      dp[1][1] = fmaf(gb, vb, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool ok = qpos < S && kpos < Tk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ps[r * (BK + 1) + c] = rounded<T>(p);
        dSs[r * (BK + 1) + c] = rounded<T>(p * (dp[i][j] - Ds[r]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float p = Ps[i * (BK + 1) + own], ds = dSs[i * (BK + 1) + own];
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        dv[m] = fmaf(p, dOs[i * LD + c0 + 8 * m], dv[m]);
        dk[m] = fmaf(ds, Qs[i * LD + c0 + 8 * m], dk[m]);
      }
    }
    float dq[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) dq[m] = 0.f;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float ds = dSs[own * (BK + 1) + j];
#pragma unroll
      for (int m = 0; m < CPT; ++m) dq[m] = fmaf(ds, Ks[j * LD + c0 + 8 * m], dq[m]);
    }
    if (q0 + own < S) {
      float* row = dq_acc + (static_cast<size_t>(b) * S + q0 + own) * q_stride +
                   static_cast<size_t>(h) * D;
#pragma unroll
      for (int m = 0; m < CPT; ++m) atomicAdd(row + c0 + 8 * m, dq[m]);
    }
  }

  if (k0 + own < Tk) {
    const size_t at = (static_cast<size_t>(b) * Tk + k0 + own) * kv_stride +
                      static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      atomicAdd(dk_acc + at + c0 + 8 * m, dk[m]);
      atomicAdd(dv_acc + at + c0 + 8 * m, dv[m]);
    }
  }
}

// blockIdx.y picks the array: 0 dQ, 1 dK, 2 dV.
template <typename T>
__global__ void attn_bwd_post(const float* __restrict__ dq_acc, T* __restrict__ dq, long long nq,
                              const float* __restrict__ dk_acc, T* __restrict__ dk,
                              const float* __restrict__ dv_acc, T* __restrict__ dv,
                              long long nkv) {
  const float* src = blockIdx.y == 0 ? dq_acc : blockIdx.y == 1 ? dk_acc : dv_acc;
  T* dst = blockIdx.y == 0 ? dq : blockIdx.y == 1 ? dk : dv;
  const long long n = blockIdx.y == 0 ? nq : nkv;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

template <typename T>
cudaError_t launch_post(const float* dq_acc, void* dq, long long nq, const float* dk_acc,
                        void* dk, const float* dv_acc, void* dv, long long nkv,
                        cudaStream_t stream) {
  const long long most = nq > nkv ? nq : nkv;
  const unsigned blocks = static_cast<unsigned>(most / 256 + 1 < 4096 ? most / 256 + 1 : 4096);
  attn_bwd_post<T><<<dim3(blocks, 3), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), nq, dk_acc, static_cast<T*>(dk), dv_acc, static_cast<T*>(dv),
      nkv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse_rows, const float* delta, float* dq_acc, float* dk_acc,
                   float* dv_acc, int B, int S, int S_pad, int Tk, int H, int KV, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  attn_bwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse_rows, delta, dq_acc, dk_acc, dv_acc, S, S_pad, Tk, H,
      KV, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* q, const void* k, const void* v, const void* o,
                     const void* lse, const void* dout, void* dq, void* dk, void* dv,
                     float* dq_acc, float* dk_acc, float* dv_acc, float* delta,
                     float* lse_rows, int B, int S, int Tk, int H, int KV, int D, float scale,
                     int causal, int window, cudaStream_t st) {
  const int S_pad = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  cudaError_t err = launch_pre<T>(o, dout, lse, delta, lse_rows, B, S, S_pad, H, D, 1.f, st);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 16: err = launch<T, 16>(q, k, v, dout, lse_rows, delta, dq_acc, dk_acc, dv_acc, B, S,
                                 S_pad, Tk, H, KV, scale, causal, window, st); break;
    case 32: err = launch<T, 32>(q, k, v, dout, lse_rows, delta, dq_acc, dk_acc, dv_acc, B, S,
                                 S_pad, Tk, H, KV, scale, causal, window, st); break;
    case 64: err = launch<T, 64>(q, k, v, dout, lse_rows, delta, dq_acc, dk_acc, dv_acc, B, S,
                                 S_pad, Tk, H, KV, scale, causal, window, st); break;
    case 128: err = launch<T, 128>(q, k, v, dout, lse_rows, delta, dq_acc, dk_acc, dv_acc, B, S,
                                   S_pad, Tk, H, KV, scale, causal, window, st); break;
    case 256: err = launch<T, 256>(q, k, v, dout, lse_rows, delta, dq_acc, dk_acc, dv_acc, B, S,
                                   S_pad, Tk, H, KV, scale, causal, window, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_post<T>(dq_acc, dq, static_cast<long long>(B) * S * H * D, dk_acc, dk, dv_acc,
                        dv, static_cast<long long>(B) * Tk * KV * D, st);
}

}  // namespace

// q, o, dout (B,S,H,D), k and v (B,T,KV,D), dq, dk, dv likewise, all in one
// dtype (0 fp32, 1 bf16) and contiguous; lse (B,H,S) fp32. Scratch from the
// caller: dq_acc (B,S,H,D), dk_acc and dv_acc (B,T,KV,D) fp32 zero-filled;
// delta and lse_rows (B,H,S_pad) fp32, S_pad = S rounded up to 64. Returns
// the cudaError_t of the first launch that failed, or 0.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, float* dq_acc,
                                         float* dk_acc, float* dv_acc, float* delta,
                                         float* lse_rows, int B, int S, int Tk, int H, int KV,
                                         int D, int dtype, float scale, int causal, int window,
                                         void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, dk_acc, dv_acc, delta,
                           lse_rows, B, S, Tk, H, KV, D, scale, causal, window, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, dk_acc, dv_acc,
                                   delta, lse_rows, B, S, Tk, H, KV, D, scale, causal, window,
                                   st);
  return cudaErrorInvalidValue;
}
