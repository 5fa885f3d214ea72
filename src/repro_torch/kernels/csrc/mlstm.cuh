// Shared by the mLSTM chunk recurrence's kernels for Hopper (sm_90a):
// mlstm_scan.cu (the forward, and with SAVE the forward that also writes the
// states between chunks) and mlstm_scan_bwd.cu (its backward). Both run
// a block per (batch row, head, E columns of a dh x dh state kept transposed
// in shared memory) over every chunk of up to ROWS rows and update the state
// once a chunk, slice by slice of DT head-dim rows:
//   X[d0 + d, e] = e_end X[d0 + d, e] + sum_l a[l, d0 + d] b[l, e]
//   x[d0 + d]    = e_end x[d0 + d]    + sum_l c[l] a[l, d0 + d]
// with (a, b, c) = (k, w v, w) in the forward (X = C, x = n) and (q, g, u)
// in the backward (X = dC, x = dn). The helpers below are that update, its
// staging, the mma routes' block, fragments and swizzle; the sums run in a
// fixed order and use no atomics, so every call gives the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 256;     // a chunk's rows at most: the reference's CHUNK, one a thread
constexpr int MMA_COLS = 32;  // columns of the state a block holds on the mma route
constexpr int MMA_DT = 32;    // head-dim columns of q and k staged at a time on the mma route
constexpr int KPAD = 8;       // bf16 padding of a staged row (80-byte rows: ldmatrix without
                              // bank conflicts)

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back (the reference's casts to the activations' dtype)
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float lo_f(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_f(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The mma routes' block (mlstm_scan_mma_kernel, mlstm_scan_bwd_mma_kernel):
// the consumers' two warpgroups (warps 0 .. 7) and the producer's (warp
// PRODUCER loads, the other three idle), which keeps 40 registers a thread
// and hands the rest to the consumers (232); a ring stage holds slices of
// SLICE_BYTES, ROWS rows of MMA_DT bf16 in TMA's 64-byte swizzle.
constexpr int PRODUCER = THREADS / 32, BLOCK = THREADS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SLICE_BYTES = ROWS * MMA_DT * 2;    // a slice of q (or k)
constexpr int NPART = 4 * MMA_DT;                 // x's partial sums a slice: 4 a row

// The SIMT routes' staged slice t of q and k (B, S, NH, dh): rows 0 ..
// ROWS-1 of the chunk at `rowbase`, head-dim columns t DT .. t DT + DT - 1,
// rows past lv zero, through registers: fetch() issues the global loads,
// stage() writes them to shared memory (rows of `stride` elements).
template <typename T, int DT>
struct Stager {
  static constexpr int VEC = 16 / sizeof(T);                 // elements a 16-byte load
  static constexpr int VPR = DT / VEC;                       // loads a staged row
  static constexpr int N = 2 * ROWS * VPR / THREADS;         // a thread's loads
  uint4 buf[N];

  __device__ __forceinline__ void fetch(const T* q, const T* k, size_t rowbase, int NH, int dh,
                                        int lv, int t) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int it = threadIdx.x + r * THREADS;
      const int which = it / (ROWS * VPR), rem = it % (ROWS * VPR);
      const int row = rem / VPR, c = rem % VPR;
      const T* src = (which ? k : q) + (rowbase + size_t(row) * NH) * dh + t * DT + c * VEC;
      buf[r] = row < lv ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void stage(T* qs, T* ks, int stride) const {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int it = threadIdx.x + r * THREADS;
      const int which = it / (ROWS * VPR), rem = it % (ROWS * VPR);
      const int row = rem / VPR, c = rem % VPR;
      T* dst = (which ? ks : qs) + row * stride + c * VEC;
      const T* x = reinterpret_cast<const T*>(&buf[r]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = x[e];
    }
  }
};

// Row l's b[l, 0 .. E-1] = w x src[0 .. E-1] (zeros from row lv on), fp32,
// into shared memory at f.
template <typename S, int E>
__device__ __forceinline__ void stage_b(const S* src, float w, bool live, float* f) {
  constexpr int VEC = 16 / sizeof(S);
#pragma unroll
  for (int c = 0; c < E / VEC; ++c) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live) raw = *reinterpret_cast<const uint4*>(src + c * VEC);
    const S* x = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[c * VEC + e] = __fmul_rn(w, to_f(x[e]));
  }
}

// x's partial sum of thread tid: row d0 + tid % DT of the slice over rows
// tid / DT x PER .. + PER - 1 of c x a (rows past the chunk are zero in
// both: a fixed count, unrolled), into red[tid].
template <typename T, int DT>
__device__ __forceinline__ void x_partial(const float* c_s, const T* as, int stride, float* red) {
  constexpr int PER = ROWS / (THREADS / DT);
  const int tid = threadIdx.x, d = tid % DT, l0 = tid / DT * PER;
  float sn = 0.f;
#pragma unroll
  for (int x = 0; x < PER; ++x) sn += c_s[l0 + x] * to_f(as[(l0 + x) * stride + d]);
  red[tid] = sn;
}

// The SIMT route's update sums of one slice: (d, e) pairs tid and tid +
// THREADS of the DT x E slice, each over rows 0 .. lv-1.
template <typename T, int E, int DT>
__device__ __forceinline__ void update_simt(float (&u)[4], const T* as, int astride,
                                            const float* bf, int bstride, int lv) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    if (idx < DT * E) {
      const int d = idx / E, e = idx % E;
      float s = 0.f;
      for (int l2 = 0; l2 < lv; ++l2) s += to_f(as[l2 * astride + d]) * bf[l2 * bstride + e];
      u[r] = s;
    }
  }
}

// X = e_end X + u on the entries of `update_simt`, and x = e_end x + the
// parts' sums in a fixed order (threads tid < DT). After the barrier that
// ends the slice's sums.
template <int E, int DT>
__device__ __forceinline__ void apply_update(float* Xs, int xstride, float* xs, const float* red,
                                             int d0, float e_end, const float (&u)[4]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < DT * E) {
      float* c = Xs + (idx % E) * xstride + d0 + idx / E;
      *c = __fadd_rn(__fmul_rn(e_end, *c), u[r]);
    }
  }
  if (tid < DT) {  // the parts' sums in a fixed order
    float sn = 0.f;
#pragma unroll
    for (int p = 0; p < THREADS / DT; ++p) sn += red[p * DT + tid];
    xs[d0 + tid] = __fadd_rn(__fmul_rn(e_end, xs[d0 + tid]), sn);
  }
}

// The block's E columns of the transposed state Xs (Xs[e * xstride + d] =
// X[d][col0 + e]) into X (dh x dh, row-major), and x (dh) where `whole`:
// coalesced rows of E values.
__device__ __forceinline__ void write_state(float* X, float* x, const float* Xs, int xstride,
                                            const float* xs, int dh, int E, int col0, bool whole) {
  for (int idx = threadIdx.x; idx < dh * E; idx += THREADS) {
    const int d = idx / E, e = idx % E;
    X[size_t(d) * dh + col0 + e] = Xs[e * xstride + d];
  }
  if (whole)
    for (int d = threadIdx.x; d < dh; d += THREADS) x[d] = xs[d];
}

// Element (r, c) of a tile of 32-column bf16 rows in TMA's 64-byte swizzle:
// 16-byte chunk c / 8 of row r lies at chunk (c / 8) ^ (r / 2 % 4) (the
// tile 512-byte aligned). Eight rows in a row at one chunk hit eight
// distinct bank groups, so ldmatrix, plain or transposed, has no conflicts.
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 32 + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// The mma routes' update sums of one slice: warp (um, un) = (warp >> 2,
// warp & 3) takes the 16 x 8 tile of X rows d0 + 16 um + g (+ 8) and
// columns 8 un + 2 qd (+ 1) over all ROWS rows of the chunk, a from the
// swizzled slice `as` (ldmatrix.trans; rows past the chunk are zero, so
// the loop has a fixed count and is unrolled), b's B fragments in
// registers (bf[r]: rows 16 r .. 16 r + 15 of this warp's 8 columns, b0, b1
// of b's bf16 high part, then of its low part, hi = bf16(b), lo = bf16(b -
// hi)). Four independent sums (high and low parts, even and odd steps of 16
// rows), added as (even + odd high) + (even + odd low). From the same a
// fragments, x's: warp (um, un) sums c_l a[l, d] over the rows of steps 4
// un .. 4 un + 3 (rows 16 s + 2 qd, + 1, + 8, + 9 of step s a lane, c of
// them in cn) for d = 16 um + g and + 8, into xn.
__device__ __forceinline__ void update_mma_n(float (&u)[4], float (&xn)[2],
                                             const __nv_bfloat16* as,
                                             const uint32_t (&bf)[ROWS / 16][4],
                                             const float (&cn)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, um = warp >> 2, un = warp & 3;
  float uh[2][4] = {}, ul[2][4] = {};
  xn[0] = xn[1] = 0.f;
  // the loads and the products are asm volatile, issued in the order
  // written: each step's a fragment is loaded AHEAD steps before its
  // products, so they need not wait out the load
  constexpr int AHEAD = 1;
  uint32_t fq[ROWS / 16][4];
  auto load = [&](int st) {
    ldsm_x4_t(fq[st], as + sw64(16 * st + (lane & 7) + (lane >> 4) * 8,
                                um * 16 + ((lane >> 3) & 1) * 8));
  };
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) load(st);
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4) {
      const int st = 4 * qq + p4;
      if (st + AHEAD < ROWS / 16) load(st + AHEAD);
      mma_bf16(uh[st & 1], fq[st], bf[st][0], bf[st][1]);
      mma_bf16(ul[st & 1], fq[st], bf[st][2], bf[st][3]);
    }
    if (qq == un) {
#pragma unroll
      for (int p4 = 0; p4 < 4; ++p4) {
        const uint32_t* f = fq[4 * qq + p4];
        xn[0] += lo_f(f[0]) * cn[p4][0] + hi_f(f[0]) * cn[p4][1] + lo_f(f[2]) * cn[p4][2] +
                 hi_f(f[2]) * cn[p4][3];
        xn[1] += lo_f(f[1]) * cn[p4][0] + hi_f(f[1]) * cn[p4][1] + lo_f(f[3]) * cn[p4][2] +
                 hi_f(f[3]) * cn[p4][3];
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
    u[x] = __fadd_rn(__fadd_rn(uh[0][x], uh[1][x]), __fadd_rn(ul[0][x], ul[1][x]));
}

// x[d0 + d] = e_end x[d0 + d] + its four partial sums in a fixed order, d =
// tid < 32 (part: a slice's NPART, part[32 un + d])
__device__ __forceinline__ void apply_n(float* ns, const float* part, int d0, float e_end) {
  const int d = threadIdx.x;
  ns[d0 + d] = __fadd_rn(__fmul_rn(e_end, ns[d0 + d]),
                         __fadd_rn(__fadd_rn(part[d], part[32 + d]),
                                   __fadd_rn(part[64 + d], part[96 + d])));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

}  // namespace
