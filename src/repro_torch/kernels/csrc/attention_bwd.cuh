// The pass before the flash-attention backward, shared by the SIMT kernel
// (csrc/flash_attention_bwd.cu) and the sm90 kernels
// (csrc/flash_attention_bwd_sm90.cu): one warp per (batch, head, q row)
// computes D = rowsum(dO * O) in fp32 and copies the forward's LSE times a
// factor (log2(e) for the sm90 kernels, which recompute P with exp2; 1 for
// the SIMT kernel), both into (B, H, S_pad) fp32 rows padded with zeros to a
// multiple of ROW_PAD, so that a tile of q rows reads them without bounds
// checks (the sm90 kernel copies them with 16-byte-aligned bulk copies).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROW_PAD = 64;  // lse and D rows padded to a multiple of this

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// o, dout (B,S,H,D) contiguous; lse (B,H,S); delta, lse_out (B,H,S_pad).
template <typename T>
__global__ void attn_bwd_pre(const T* __restrict__ o, const T* __restrict__ dout,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             float* __restrict__ lse_out, int S, int S_pad, int H, int D,
                             float lse_scale, long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int q = static_cast<int>(row % S_pad);
  const long long bh = row / S_pad;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  float acc = 0.f, l = 0.f;
  if (q < S) {
    const size_t base = ((static_cast<size_t>(b) * S + q) * H + h) * D;
    for (int d = lane; d < D; d += 32) acc += to_f(o[base + d]) * to_f(dout[base + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l = lse[bh * S + q] * lse_scale;
  }
  if (lane == 0) {
    delta[row] = acc;
    lse_out[row] = l;
  }
}

template <typename T>
cudaError_t launch_pre(const void* o, const void* dout, const void* lse, float* delta,
                       float* lse_out, int B, int S, int S_pad, int H, int D, float lse_scale,
                       cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S_pad;
  const long long blocks = (rows * 32 + 255) / 256;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_bwd_pre<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      delta, lse_out, S, S_pad, H, D, lse_scale, rows);
  return cudaGetLastError();
}

}  // namespace
