// Shared by the sLSTM recurrence's kernels for Hopper (sm_90a):
// slstm_scan.cu (the forward) and slstm_scan_bwd.cu (its backward). Each
// runs one grid whose blocks of THREADS threads are all resident at once
// and exchange a step's values: in thread-block clusters (the forward, and
// the backward in bf16), within a cluster by st.async into each block's
// shared memory and across clusters as 8-byte words of 4 data bytes and
// the step's tag, stored to L2 and polled (a poll that waits 10 s traps);
// or, in the backward's cooperative route (fp32), as such words alone,
// gathered by every block. The recurrent products run in a fixed order,
// so every call gives the same bits: on tensor cores by mma.sync (bf16) or
// as the SIMT products below (fp32). Here: the block's constants, the
// tagged words, the SIMT products, the m16n8k16 product, and the launches
// of a cooperative grid and of a grid of clusters.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PAIRS = 4;      // (batch row, channel) pairs a thread keeps c for
constexpr int CPW = 4;            // columns a warp's products run at once
constexpr int XW = 8;             // exchange words a thread loads at once

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The word at p once its tag (high 32 bits) is ``tag``; traps after 10 s.
__device__ __forceinline__ unsigned long long poll_word(const unsigned long long* p,
                                                        unsigned int tag) {
  unsigned long long v = load_word(p);
  if (static_cast<unsigned int>(v >> 32) == tag) return v;
  const unsigned long long t0 = globaltimer();
  while (static_cast<unsigned int>((v = load_word(p)) >> 32) != tag)
    if (globaltimer() - t0 > 10000000000ull) __trap();
  return v;
}

// Copy ``rows`` x ``n`` exchange words tagged ``tag`` (row r at src + r *
// stride; WHOLE: stride == n, one run of words) into dst (row r at dst + r *
// n) as their 4 data bytes: XW loads a thread in flight at once, then each
// polled until ready.
template <bool WHOLE>
__device__ __forceinline__ void gather_words(const unsigned long long* src, int stride, int rows,
                                             int n, unsigned int tag, unsigned int* dst) {
  auto at = [&](int i) { return src + (WHOLE ? size_t(i) : size_t(i / n) * stride + i % n); };
  for (int i0 = threadIdx.x; i0 < rows * n; i0 += THREADS * XW) {
    unsigned long long v[XW];
#pragma unroll
    for (int u = 0; u < XW; ++u) {
      const int i = i0 + u * THREADS;
      v[u] = i < rows * n ? load_word(at(i)) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < XW; ++u) {
      const int i = i0 + u * THREADS;
      if (i < rows * n) {
        if (static_cast<unsigned int>(v[u] >> 32) != tag) v[u] = poll_word(at(i), tag);
        dst[i] = static_cast<unsigned int>(v[u]);
      }
    }
  }
}

// Publish ``rows`` x ``n`` 4-byte words of src (row r at src + r * sstride)
// as words tagged ``tag`` at dst (row r at dst + r * dstride).
__device__ __forceinline__ void publish_words(const unsigned int* src, int sstride,
                                              unsigned long long* dst, int dstride, int rows,
                                              int n, unsigned int tag) {
  const unsigned long long hi = static_cast<unsigned long long>(tag) << 32;
  for (int i = threadIdx.x; i < rows * n; i += THREADS)
    store_word(dst + size_t(i / n) * dstride + i % n, hi | src[(i / n) * sstride + i % n]);
}

// The products of a block's ncol columns, each dh terms long: column c's
// values at rs + c * dh, its B rows of the other operand at src(c) + b *
// stride. gr[c * B + b] gets each sum, rounded to T where ROUND (the
// forward's product, as the reference's einsum rounds it). Warp w takes
// columns w + j * WARPS, j < CPW, at once (a column past the block's reads
// column 0 and stores nothing); ROWS batch rows at a time share each load of
// a column. Every load of a step of k is issued before its FMAs, with no
// branch between them; the lanes split the terms in pairs and butterflies of
// shuffles add the 32 partial sums, a fixed order.
template <typename T, int ROWS, bool ROUND, typename Src>
__device__ __forceinline__ void products(const T* rs, Src src, int stride, int ncol, int cpb,
                                         int nch, int dh, int B, float* gr) {
  using N = Num<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int cb = warp; cb < ncol; cb += WARPS * CPW) {
    const T* rc[CPW];
    const T* hh[CPW];
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int c = cb + j * WARPS;
      const int cc = c < ncol && c % cpb < nch ? c : 0;
      rc[j] = rs + size_t(cc) * dh;
      hh[j] = src(cc);
    }
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      float acc[CPW][ROWS];
#pragma unroll
      for (int j = 0; j < CPW; ++j)
#pragma unroll
        for (int bb = 0; bb < ROWS; ++bb) acc[j][bb] = 0.0f;
      for (int k = 2 * lane; k < dh; k += 64) {
        float2 rv[CPW], hv[CPW][ROWS];
#pragma unroll
        for (int j = 0; j < CPW; ++j) {
          rv[j] = N::pair(rc[j] + k);
#pragma unroll
          for (int bb = 0; bb < ROWS; ++bb)
            hv[j][bb] = N::pair(hh[j] + size_t(b0 + bb) * stride + k);
        }
#pragma unroll
        for (int j = 0; j < CPW; ++j)
#pragma unroll
          for (int bb = 0; bb < ROWS; ++bb) {
            acc[j][bb] = fmaf(hv[j][bb].x, rv[j].x, acc[j][bb]);
            acc[j][bb] = fmaf(hv[j][bb].y, rv[j].y, acc[j][bb]);
          }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int j = 0; j < CPW; ++j)
#pragma unroll
          for (int bb = 0; bb < ROWS; ++bb)
            acc[j][bb] = __fadd_rn(acc[j][bb], __shfl_xor_sync(0xffffffffu, acc[j][bb], m));
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < CPW; ++j) {
          const int c = cb + j * WARPS;
          if (c < ncol && c % cpb < nch) {
#pragma unroll
            for (int bb = 0; bb < ROWS; ++bb)
              gr[c * B + b0 + bb] = ROUND ? N::round(acc[j][bb]) : acc[j][bb];
          }
        }
      }
    }
  }
}

// The number of blocks in this block's cluster.
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return int(n);
}

// d += a b on the tensor cores: m16n8k16, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Launch ``kernel`` cooperatively over ceil(D / cpb) blocks after zeroing
// the exchange words (no tag may be found before it is written). Refuses a
// grid that cannot be resident at once, as the exchange needs.
template <typename K>
int launch_coop(K kernel, void** args, size_t smem, int D, int cpb, void* xch, size_t xch_bytes,
                cudaStream_t stream) {
  const int grid = (D + cpb - 1) / cpb;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(xch, 0, xch_bytes, stream)) != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most clusters of `cs` blocks of `kernel` (THREADS threads, `smem`
// bytes of shared memory each) that the card holds at once, or a negative
// cudaError_t.
template <typename K>
int max_clusters(K kernel, size_t smem, int cs) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -int(err);
}

// Launch `kernel` (its shared memory allowed by max_clusters) over
// `blocks` blocks padded to whole clusters of `cs`, after zeroing the first
// `xch_bytes` of the exchange's words (no tag may be found before it is
// written), with the cluster dimension and the cooperative attribute
// together (the driver takes the pair): a grid that cannot be resident at
// once is refused.
template <typename K>
int launch_clusters(K kernel, void** args, size_t smem, int blocks, int cs, void* xch,
                    size_t xch_bytes, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (xch_bytes && (err = cudaMemsetAsync(xch, 0, xch_bytes, stream)) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cs - 1) / cs * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if ((err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

inline bool bad_shape(int B, int S, int D, int nh, int cpb) {
  return B <= 0 || S <= 0 || D <= 0 || nh <= 0 || cpb <= 0 || D % nh || D % 8 ||
         (D / nh) % 2 || cpb % 2 || B * cpb > MAX_PAIRS * THREADS;
}

}  // namespace
