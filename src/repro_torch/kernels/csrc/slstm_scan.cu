// sLSTM recurrence over time for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel: the reference runs the sLSTM cell as one
// jax.lax.scan (src/repro/models/xlstm.py:229 `apply_slstm`, over
// `_slstm_cell` at :198), which XLA compiles into a single loop on the
// device. The port ran it as a Python loop of about a dozen launches a step
// (4.6 s for xlstm-1.3b's 2,048-token prefill at batch 4), so the loop
// itself is this kernel. For t = 0 .. S-1:
//   gr  = h_{t-1} . r_gates per head           (B, nh, 4dh), fp32 sums
//   g   = gx_t + flat(gr)                      (B, 4D)
//   i, f, z, o = the four quarters of g        (B, D) each
//   c_t = sig(f) c_{t-1} + sig(i) tanh(z)      fp32
//   h_t = sig(o) tanh(c_t)                     cast once to the activations' dtype
// from h0 (B, D) and c0 (B, D) fp32, or from zeros; writes every h_t
// (B, S, D) and the final (h, c).
//
// The gates are the reference's flat split, not a split by head: output
// column e of head hd lands at flat index idx = hd*4dh + e, of gate
// idx / D and channel idx % D. With xlstm-1.3b's nh = 4, dh = 512, the gate
// is the head, so each channel's four gates read all of h_{t-1} (2,048
// values): the recurrent product is dense over the whole state, and a step
// cannot start before every channel of the step before is done.
//
// Rounding. In bf16 the kernel rounds where the reference's cell does: the
// product to bf16 after its fp32 sum, g, each sigmoid and tanh of a gate,
// and sig(i) * tanh(z); sig(f) * c, the sum that gives c and
// sig(o) * tanh(c) stay fp32 (c is fp32), and h is rounded once. Products
// and sums of the cell round apart (__fmul_rn, __fadd_rn), as PyTorch's
// separate kernels do, so the kernel and the plain loop differ only in the
// order of each dh-term sum.
//
// Design. One persistent grid, launched cooperatively so that every block
// is resident at once: block j owns CPB channels (16 at D = 2,048 on 132
// SMs, so 128 blocks), holds their four gates' columns of r_gates in shared
// memory for the whole run (4 x 512 x 16 values: 64 KB in bf16, 128 KB in
// fp32) and keeps their c in registers, one (batch row, channel) pair a
// thread. Each step a block
//   1. gathers the whole h_{t-1} (B x D) into shared memory from an exchange
//      buffer in device memory (it stays in L2) where every block published
//      its channels of h_{t-1}: 8-byte words of 4 data bytes and the step's
//      tag, written and read whole (relaxed, at gpu scope), so a word whose
//      tag is t holds h_{t-1}: a thread polls each of its words until the
//      tag matches. Data and signal travel in one L2 round trip, with no
//      grid-wide barrier. Two buffers alternate by step: a block that
//      writes h_{t+1} has read every block's h_t, so every block has done
//      reading h_{t-1}, whose buffer it overwrites;
//   2. runs its 4 x CPB columns' products, a warp taking 4 columns and up
//      to 4 batch rows at once (the kernel is built for 1, 2 and 4 rows, and
//      takes the largest that divides B), the lanes splitting the dh-term
//      sums in pairs and butterflies of shuffles adding the 32 partial sums
//      (a fixed order: the same bits every run);
//   3. runs the cell for its pairs, writes their h_t to the output and, as
//      tagged words, to the exchange buffer.
// A poll that waits 10 s traps (the kernel fails instead of hanging).
//
// Bound on this card. The work is the products, 2 x B x S x 4D x dh FLOPs,
// and the bytes gx read once, h written once and r_gates read once. In
// bf16 at 989 TFLOP/s and 3.35 TB/s: at (4, 2048, 8192) 0.0695 ms of
// operations against 0.0526 of bytes; at (1, 524288, 8192) 4.45 ms of
// operations against 3.21 of bytes. Each of the S steps waits for the one
// before, so the latency of a step sets the time, not the bound: on an
// H100 80GB HBM3 at 700 W about 4.5 µs a step at batch 1 and 7 at batch 4
// (chip_smoke.py's times). The products issue every load of a step of k
// before its FMAs, with no branch between them, so the loads overlap.
// wgmma and thread-block clusters (h kept in distributed shared memory)
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PAIRS = 4;      // (batch row, channel) pairs a thread keeps c for
constexpr int CPW = 4;            // columns a warp's products run at once
constexpr int XW = 8;             // exchange words a thread loads at once

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory of one block: its columns of r_gates, h_{t-1}, the products
// and its new h (kernels/slstm.py `smem_bytes` computes the same).
__host__ __device__ constexpr size_t smem_bytes(int elem, int B, int D, int dh, int cpb) {
  return align16(size_t(elem) * 4 * cpb * dh) + align16(size_t(elem) * B * D) +
         align16(sizeof(float) * 4 * cpb * B) + align16(size_t(elem) * B * cpb);
}

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

// ROWS: batch rows a warp's products share each r_gates load over (B is a
// multiple of it)
template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_scan_kernel(const T* __restrict__ gx, const T* __restrict__ r, const T* h0,
                      const float* __restrict__ c0, T* __restrict__ out, T* __restrict__ h_n,
                      float* __restrict__ c_n, unsigned long long* xch, int B, int S, int D,
                      int nh, int cpb) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = D / nh, e4 = 4 * dh, ncol = 4 * cpb;
  const int j0 = blockIdx.x * cpb;
  const int nch = min(cpb, D - j0);
  // h in 4-byte words: a row of D values is `words` words, a block's
  // channels `bwords` of them
  const int words = D * int(sizeof(T)) / 4, bwords = cpb * int(sizeof(T)) / 4;
  const int nbw = nch * int(sizeof(T)) / 4;
  T* rs = reinterpret_cast<T*>(smem);
  size_t off = align16(sizeof(T) * ncol * dh);
  T* hs = reinterpret_cast<T*>(smem + off);
  off += align16(sizeof(T) * B * D);
  float* gr = reinterpret_cast<float*>(smem + off);
  off += align16(sizeof(float) * ncol * B);
  T* hnew = reinterpret_cast<T*>(smem + off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this block's columns of r_gates, column c = (gate c / cpb, channel
  // j0 + c % cpb), each column's dh values contiguous
  for (int i = threadIdx.x; i < ncol * dh; i += THREADS) {
    const int c = i % ncol, k = i / ncol, jj = c % cpb;
    T v = N::from_f(0.0f);
    if (jj < nch) {
      const int idx = (c / cpb) * D + j0 + jj;
      v = r[(size_t(idx / e4) * dh + k) * e4 + idx % e4];
    }
    rs[size_t(c) * dh + k] = v;
  }
  // c of this thread's (row, channel) pairs p = threadIdx.x + i * THREADS
  const int npairs = B * cpb;
  float creg[MAX_PAIRS], hlast[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    creg[i] = (p < npairs && jj < nch && c0) ? c0[size_t(b) * D + j0 + jj] : 0.0f;
    hlast[i] = 0.0f;
  }

  for (int t = 0; t < S; ++t) {
    // 1. this step's gx (in flight while h arrives), then h_{t-1}
    float gxv[MAX_PAIRS][4];
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
      const bool on = p < npairs && jj < nch;
      const T* g = gx + (size_t(b) * S + t) * 4 * D + j0 + jj;
#pragma unroll
      for (int q = 0; q < 4; ++q) gxv[i][q] = on ? N::to_f(g[size_t(q) * D]) : 0.0f;
    }
    unsigned int* hw = reinterpret_cast<unsigned int*>(hs);
    if (t == 0) {
      const unsigned int* src = reinterpret_cast<const unsigned int*>(h0);
      for (int i = threadIdx.x; i < B * words; i += THREADS) hw[i] = h0 ? src[i] : 0u;
    } else {
      // XW loads a thread in flight at once, then each polled until ready
      const unsigned long long* src = xch + size_t((t - 1) & 1) * B * words;
      const unsigned int tag = static_cast<unsigned int>(t);
      for (int i0 = threadIdx.x; i0 < B * words; i0 += THREADS * XW) {
        unsigned long long v[XW];
#pragma unroll
        for (int u = 0; u < XW; ++u) {
          const int i = i0 + u * THREADS;
          v[u] = i < B * words ? load_word(src + i) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < XW; ++u) {
          const int i = i0 + u * THREADS;
          if (i < B * words) {
            if (static_cast<unsigned int>(v[u] >> 32) != tag) v[u] = poll_word(src + i, tag);
            hw[i] = static_cast<unsigned int>(v[u]);
          }
        }
      }
    }
    __syncthreads();

    // 2. the products: warp w takes columns w + j * WARPS, j < CPW, at once
    // (a column past the block's reads column 0 and stores nothing); ROWS
    // batch rows at a time share each load of a column. Every load of a
    // step of k is issued before its FMAs, with no branch between them.
    for (int cb = warp; cb < ncol; cb += WARPS * CPW) {
      const T* rc[CPW];
      const T* hh[CPW];
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const int c = cb + j * WARPS;
        const int cc = c < ncol && c % cpb < nch ? c : 0;
        rc[j] = rs + size_t(cc) * dh;
        hh[j] = hs + (((cc / cpb) * D + j0 + cc % cpb) / e4) * dh;
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
            for (int bb = 0; bb < ROWS; ++bb) hv[j][bb] = N::pair(hh[j] + size_t(b0 + bb) * D + k);
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
              for (int bb = 0; bb < ROWS; ++bb) gr[c * B + b0 + bb] = N::round(acc[j][bb]);
            }
          }
        }
      }
    }
    __syncthreads();

    // 3. the cell
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
      if (p < npairs && jj < nch) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = N::round(__fadd_rn(gxv[i][q], gr[(q * cpb + jj) * B + b]));
        const float si = N::round(sigmoid(g[0])), sf = N::round(sigmoid(g[1]));
        const float tz = N::round(tanhf(g[2])), so = N::round(sigmoid(g[3]));
        const float c = __fadd_rn(__fmul_rn(sf, creg[i]), N::round(__fmul_rn(si, tz)));
        creg[i] = c;
        const T h = N::from_f(__fmul_rn(so, tanhf(c)));
        hlast[i] = N::to_f(h);
        hnew[p] = h;
        out[(size_t(b) * S + t) * D + j0 + jj] = h;
      }
    }
    // 4. publish h_t as words tagged t + 1 (no one reads the last step's)
    if (t + 1 < S) {
      __syncthreads();
      const unsigned int* hn = reinterpret_cast<const unsigned int*>(hnew);
      unsigned long long* dst = xch + size_t(t & 1) * B * words + j0 * int(sizeof(T)) / 4;
      const unsigned long long tag = static_cast<unsigned long long>(t + 1) << 32;
      for (int i = threadIdx.x; i < B * nbw; i += THREADS) {
        const int b = i / nbw, w = i % nbw;
        store_word(dst + size_t(b) * words + w, tag | hn[b * bwords + w]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    if (p < npairs && jj < nch) {
      c_n[size_t(b) * D + j0 + jj] = creg[i];
      h_n[size_t(b) * D + j0 + jj] = N::from_f(hlast[i]);
    }
  }
}

template <typename T, int ROWS>
int launch(const void* gx, const void* r, const void* h0, const void* c0, void* out, void* h_n,
           void* c_n, void* xch, int B, int S, int D, int nh, int cpb, cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<T, ROWS>;
  const int dh = D / nh;
  const size_t smem = smem_bytes(sizeof(T), B, D, dh, cpb);
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
  // the exchange needs every block resident at once
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  // no tag of a step (1 .. S-1) may be found before it is written
  const size_t xch_bytes = 2 * size_t(B) * D * sizeof(T) / 4 * sizeof(unsigned long long);
  if ((err = cudaMemsetAsync(xch, 0, xch_bytes, stream)) != cudaSuccess) return err;
  const T* gx_ = static_cast<const T*>(gx);
  const T* r_ = static_cast<const T*>(r);
  const T* h0_ = static_cast<const T*>(h0);
  const float* c0_ = static_cast<const float*>(c0);
  T* out_ = static_cast<T*>(out);
  T* hn_ = static_cast<T*>(h_n);
  float* cn_ = static_cast<float*>(c_n);
  unsigned long long* xch_ = static_cast<unsigned long long*>(xch);
  void* args[] = {&gx_, &r_, &h0_, &c0_, &out_, &hn_, &cn_, &xch_, &B, &S, &D, &nh, &cpb};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// gx (B, S, 4D) and r_gates (nh, D/nh, 4D/nh) in bf16 (bf16 != 0) or fp32;
// h0 (B, D) in the same type and c0 (B, D) fp32, each or null (zeros); out
// (B, S, D) and h_n (B, D) in gx's type, c_n (B, D) fp32; xch scratch of
// 2 x B x D x elem / 4 words of 8 bytes. All contiguous and 16-byte aligned;
// D a multiple of 8, D / nh even, cpb even, B x cpb <= 2048. One block per
// cpb channels. Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be resident at
// once).
extern "C" int repro_slstm_scan(const void* gx, const void* r, const void* h0, const void* c0,
                                void* out, void* h_n, void* c_n, void* xch, int B, int S,
                                int D, int nh, int cpb, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || nh <= 0 || cpb <= 0 || D % nh || D % 8 ||
      (D / nh) % 2 || cpb % 2 || B * cpb > MAX_PAIRS * THREADS)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (B % 4 == 0)
      return launch<__nv_bfloat16, 4>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
    if (B % 2 == 0)
      return launch<__nv_bfloat16, 2>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
    return launch<__nv_bfloat16, 1>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
  }
  if (B % 4 == 0) return launch<float, 4>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
  if (B % 2 == 0) return launch<float, 2>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
  return launch<float, 1>(gx, r, h0, c0, out, h_n, c_n, xch, B, S, D, nh, cpb, s);
}
