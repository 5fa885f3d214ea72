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
// staging and the fragments of the mma route; the sums run in a fixed order
// and use no atomics, so every call gives the same bits.
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

// The staged slice t of NM matrices of (B, S, NH, dh) (q and k in the
// forward, q alone in the backward): rows 0 .. ROWS-1 of the chunk at
// `rowbase`, head-dim columns t DT .. t DT + DT - 1, rows past lv zero,
// through registers: fetch() issues the global loads, stage() writes them
// to shared memory.
template <typename T, bool MMA, int DT, int NM = 2>
struct Stager {
  static constexpr int VEC = 16 / sizeof(T);                 // elements a 16-byte load
  static constexpr int VPR = DT / VEC;                       // loads a staged row
  static constexpr int N = NM * ROWS * VPR / THREADS;        // a thread's loads
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
      if constexpr (MMA) {
        *reinterpret_cast<uint4*>(dst) = buf[r];
      } else {
        const T* x = reinterpret_cast<const T*>(&buf[r]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = x[e];
      }
    }
  }
};

// Row l's b[l, 0 .. E-1] = w x src[0 .. E-1] (zeros from row lv on) into
// shared memory: on the mma route as bf16 high and low parts, hi = bf16(p),
// lo = bf16(p - hi), so the update's bf16 products keep about 16 bits of p;
// else in fp32.
template <typename S, bool MMA, int E>
__device__ __forceinline__ void stage_b(const S* src, float w, bool live, __nv_bfloat16* hi,
                                        __nv_bfloat16* lo, float* f) {
  constexpr int VEC = 16 / sizeof(S);
#pragma unroll
  for (int c = 0; c < E / VEC; ++c) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live) raw = *reinterpret_cast<const uint4*>(src + c * VEC);
    const S* x = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float p = __fmul_rn(w, to_f(x[e]));
      if constexpr (MMA) {
        const __nv_bfloat16 h = __float2bfloat16_rn(p);
        hi[c * VEC + e] = h;
        lo[c * VEC + e] = __float2bfloat16_rn(__fsub_rn(p, __bfloat162float(h)));
      } else {
        f[c * VEC + e] = p;
      }
    }
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

// The mma route's update sums of one slice: warp w takes rows d0 + 16 (w >> 2)
// + g (+ 8) and columns 8 (w & 3) + 2 qd (+ 1) of the state, over all ROWS rows
// of a (staged in `as`, read transposed) and b (its high part in `bhi`, low in
// `blo`). Four independent sums (b's high and low parts, even and odd steps
// of 16 rows) so the mma of a step need not wait for the last; rows past lv
// are zero in a and b, so the loop runs over all ROWS, a fixed count the
// compiler unrolls (the next steps' loads issued before this step's mma).
__device__ __forceinline__ void update_mma(float (&u)[4], const __nv_bfloat16* as, int astride,
                                           const __nv_bfloat16* bhi, const __nv_bfloat16* blo,
                                           int bstride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int um = warp >> 2, un = warp & 3;
  float uh[2][4] = {}, ul[2][4] = {};
#pragma unroll
  for (int lk = 0; lk < ROWS; lk += 32) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int l0 = lk + 16 * p;
      uint32_t fk[4], fw[4];
      ldsm_x4_t(fk, as + (l0 + (lane & 7) + (lane >> 4) * 8) * astride + um * 16 +
                        ((lane >> 3) & 1) * 8);
      // matrices 0, 1: rows l0 .. l0 + 15 of b's high part; 2, 3: of its low part
      ldsm_x4_t(fw, (lane < 16 ? bhi : blo) +
                        (l0 + (lane & 7) + ((lane >> 3) & 1) * 8) * bstride + un * 8);
      mma_bf16(uh[p], fk, fw[0], fw[1]);
      mma_bf16(ul[p], fk, fw[2], fw[3]);
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
    u[x] = __fadd_rn(__fadd_rn(uh[0][x], uh[1][x]), __fadd_rn(ul[0][x], ul[1][x]));
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

// X = e_end X + u on the entries of `update_mma` or `update_simt`, and x =
// e_end x + the parts' sums in a fixed order (threads tid < DT). After the
// barrier that ends the slice's sums.
template <bool MMA, int E, int DT>
__device__ __forceinline__ void apply_update(float* Xs, int xstride, float* xs, const float* red,
                                             int d0, float e_end, const float (&u)[4]) {
  const int tid = threadIdx.x;
  if constexpr (MMA) {
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
    const int um = warp >> 2, un = warp & 3;
    const int d = d0 + um * 16 + g, e = un * 8 + 2 * qd;
    float* c = Xs + e * xstride + d;
    c[0] = __fadd_rn(__fmul_rn(e_end, c[0]), u[0]);
    c[xstride] = __fadd_rn(__fmul_rn(e_end, c[xstride]), u[1]);
    c[8] = __fadd_rn(__fmul_rn(e_end, c[8]), u[2]);
    c[xstride + 8] = __fadd_rn(__fmul_rn(e_end, c[xstride + 8]), u[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < DT * E) {
        float* c = Xs + (idx % E) * xstride + d0 + idx / E;
        *c = __fadd_rn(__fmul_rn(e_end, *c), u[r]);
      }
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

}  // namespace
