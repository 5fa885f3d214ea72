// mLSTM chunk recurrence for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel: the reference runs the mLSTM's chunkwise form
// as one jax.lax.scan over chunks (src/repro/models/xlstm.py:108, body
// `_mlstm_chunk_scan` at :80-106), which XLA compiles into one loop on the
// device. This kernel is that loop's carried part. The carry-free terms of
// every chunk (cl, the within-chunk cumulative log forget gate; h_intra;
// d_intra) come from torch beforehand (kernels/mlstm.py
// `mlstm_intra_terms`). For each chunk j of L = min(256, S) rows, from C0
// and n0 or from zeros:
//   w_l     = exp(cl_end - cl_l) i_l,  e_end = exp(cl_end)          fp32
//   P       = q_j . bf16(C_{j-1})          fp32 sums, rounded to bf16
//   h_inter = bf16(P * bf16(exp(cl)))      (fp32 activations: P exp(cl))
//   d_inter = (q_j . n_{j-1}) exp(cl)                                fp32
//   h_j     = (h_intra + h_inter) / max(|d_intra + d_inter|, 1)      one rounding
//   C_j     = e_end C_{j-1} + k_j^T (w v_j),  n_j = e_end n_{j-1} + k_j^T w
// Rows past S in the ragged last chunk count as the reference's zero pad
// (w = 0; cl_end is the last real row's, as a zero log gate keeps it).
//
// Bound on this card. Per chunk the two dh x dh products (the read of C
// and its update) are 4 L dh^2 FLOPs a head; the bytes are q, k, v and
// h_intra read once and h written once, 10 L dh bytes a head in bf16. At
// xlstm-1.3b's dh 1024 that is 410 FLOPs a byte, above the H100's 295 in
// bf16: the products bound the kernel. At long_500k's (1, 524288, 4, 1024)
// 8.8 TFLOP, 8.9 ms at 989 TFLOP/s, against 6.4 ms of bytes.
//
// Design. C's columns are independent (column e of C_j needs only column e
// of v), so a block owns one (batch row, head, 32 columns of C) and needs
// no exchange with other blocks and no atomics: every call gives the same
// bits. It keeps C^T[cols][dh] in fp32 (128 KB at dh 1024) and its own
// copy of n (dh fp32) in shared memory from the first chunk to the last and
// writes them once at the end. With SAVE (a template argument) it also
// writes the nc - 1 states between chunks (C_{j-1} and n_{j-1} entering
// chunk j > 0; the first chunk's is C0, the caller's) for the backward
// (csrc/mlstm_scan_bwd.cu): 201 MB more at xlstm-1.3b's training shape (4,
// 1024, 4, 1024), 60 us of bytes; without it the code is as before. The
// update and its staging are shared with the backward (mlstm.cuh). Per
// chunk it streams q_j and k_j through
// shared memory in slices of DT head-dim columns (the next slice's global
// loads in registers while the current one is used) and, per slice d0:
//   1. the read: P[l, cols] += q[l, d0:] . bf16(C[d0:, cols]) and the
//      normalizer's q[l, d0:] . n[d0:], for every row l;
//   2. the update of C[d0:, cols] and n[d0:] with the slice of k: the rows
//      the read of this slice used and no other, so read and update share
//      one pass over q and k, and a barrier between them; n's update is
//      split over all threads by rows, the partial sums added in a fixed
//      order after the barrier;
// then combines P with h_intra and d_intra and writes h. The 32 blocks of
// a head read the same q and k, from L2.
//
// Routes. "mma" (bf16 at dh a multiple of 32): 8 warps; the read gives
// warp w rows 32w..32w+31 (2 x 4 m16n8k16 tiles, ldmatrix A from q, B
// converted from C's fp32); the update gives warp w one 16 x 8 tile of
// C[d0:d0+32, cols] over all 256 rows (ldmatrix.trans of k and of w v; rows
// past the chunk are zero, so the loop has a fixed count and is unrolled).
// The reference's dC is fp32 from fp32 w and upcast k and v. A bf16
// product of w v would keep 8 bits of it, so w v is split into bf16 high
// and low parts, hi = bf16(wv), lo = bf16(wv - hi), and k . hi + k . lo
// runs as two products (k is exact in bf16; the tensor cores sum in fp32):
// about 16 bits of w v. The high and low parts and even and odd steps of
// 16 rows sum apart, four independent mma chains. The read's normalizer
// sums run in fp32 from the fragments' own registers. "simt" (fp32 at any
// supported dh, bf16 at dh 8 and 16): a thread a row for the read and the
// combine, each slice's sums blocked (started from zero, then added to the
// running ones), plain FMAs; the C update a thread per (d, column) pair;
// the same rounding points.
//
// What bounds it (tools/mlstm_variants.py, PERF.md): not the products. At
// dh 1024 a chunk takes about 85 us a block; taking out the slices' loads
// saves about a third, the update's mma about a fifth, the read's a
// twentieth. The 32-fold re-read of q and k and the kernel's two barriers
// and shared-memory traffic a slice set the time. wgmma, TMA multicast over
// a cluster of a head's blocks and keeping C in registers are later work.
#include "mlstm.cuh"

namespace {

// Byte offsets in a block's shared memory (kernels/mlstm.py `smem_bytes`
// computes the total).
struct Layout {
  int cs, qs, ws;  // row strides (elements) of C^T, of staged q and k, of w v
  size_t c, n, q, k, wv, vec, red, total;
};

__host__ __device__ inline Layout layout(int dh, int E, int DT, int elem, bool mma) {
  Layout o;
  o.cs = dh + (mma ? 8 : 4);
  o.qs = DT + (mma ? KPAD : (elem == 2 ? 2 : 1));
  o.ws = mma ? E + KPAD : E;
  size_t off = 0;
  o.c = off;
  off += align16(size_t(4) * E * o.cs);
  o.n = off;
  off += align16(size_t(4) * dh);
  o.q = off;
  off += align16(size_t(elem) * ROWS * o.qs);
  o.k = off;
  off += align16(size_t(elem) * ROWS * o.qs);
  o.wv = off;
  off += mma ? 2 * align16(size_t(2) * ROWS * o.ws) : align16(size_t(4) * ROWS * o.ws);
  o.vec = off;
  off += 3 * align16(size_t(4) * ROWS);  // exp(cl), w, d_intra of the chunk's rows
  o.red = off;
  off += align16(size_t(4) * THREADS);   // the n update's partial sums
  o.total = off;
  return o;
}

struct Args {
  const void *q, *k, *v;               // (B, S, NH, dh)
  const float *ig, *cl;                // (B, S, NH)
  const void* hin;                     // h_intra (B, S, NH, dh)
  const float* din;                    // d_intra (B, S, NH)
  const float *C0, *n0;                // (B, NH, dh, dh), (B, NH, dh) or null
  void* h;                             // (B, S, NH, dh)
  float *C, *n;                        // (B, NH, dh, dh), (B, NH, dh)
  float *Csave, *nsave;                // SAVE: (B, nc - 1, NH, dh, dh), (B, nc - 1, NH, dh)
  int S, NH, dh;
};

// One block: batch row blockIdx.z, head blockIdx.y, columns blockIdx.x E ..
// + E - 1 of C. MMA: the tensor-core route (bf16, E = 32, DT = 32). SAVE:
// also write C and n between chunks (the backward's inputs); the rest is
// the same code, so h, C and n keep their bits.
template <typename T, bool MMA, int E, int DT, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1) mlstm_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, NH = a.NH, dh = a.dh;
  const Layout o = layout(dh, E, DT, sizeof(T), MMA);
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // C^T: Cs[e * cs + d] = C[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* qs = reinterpret_cast<T*>(smem + o.q);
  T* ks = reinterpret_cast<T*>(smem + o.k);
  float* ecl_s = reinterpret_cast<float*>(smem + o.vec);
  float* w_s = ecl_s + ROWS;
  float* di_s = w_s + ROWS;
  float* red = reinterpret_cast<float*>(smem + o.red);
  __nv_bfloat16* whi = reinterpret_cast<__nv_bfloat16*>(smem + o.wv);
  __nv_bfloat16* wlo = whi + align16(size_t(2) * ROWS * o.ws) / 2;
  float* wvf = reinterpret_cast<float*>(smem + o.wv);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* hin = static_cast<const T*>(a.hin);
  T* hout = static_cast<T*>(a.h);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  for (int idx = tid; idx < dh * E; idx += THREADS) {
    const int d = idx / E, e = idx % E;
    Cs[e * o.cs + d] = a.C0 ? a.C0[cbase + size_t(d) * dh + col0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += THREADS) ns[d] = a.n0 ? a.n0[nbase + d] : 0.f;

  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT;
  Stager<T, MMA, DT> st;
  for (int j = 0; j < nchunks; ++j) {
    const int s0 = j * L, lv = min(L, S - s0);
    const size_t rowbase = (size_t(b) * S + s0) * NH + hd;  // (b, s0, hd) in (B, S, NH)
    st.fetch(q, k, rowbase, NH, dh, lv, 0);
    __syncthreads();  // the previous chunk is done with w v, the vectors and the staged slice
    if constexpr (SAVE) {  // C_{j-1}, n_{j-1}: between chunks j - 1 and j (C0 is the caller's)
      if (j > 0) {
        const size_t sb = (size_t(b) * (nchunks - 1) + j - 1) * NH + hd;
        write_state(a.Csave + sb * dh * dh, a.nsave + sb * dh, Cs, o.cs, ns, dh, E, col0,
                    blockIdx.x == 0);
      }
    }
    const float cl_end = a.cl[rowbase + size_t(lv - 1) * NH];
    const float e_end = expf(cl_end);
    {  // row tid: exp(cl), w, d_intra and w v over the block's columns
      const int l = tid;
      float w = 0.f;
      if (l < lv) {
        const size_t ri = rowbase + size_t(l) * NH;
        const float c = a.cl[ri];
        ecl_s[l] = expf(c);
        w = __fmul_rn(expf(__fsub_rn(cl_end, c)), a.ig[ri]);
        di_s[l] = a.din[ri];
      }
      w_s[l] = w;
      stage_b<T, MMA, E>(v + (rowbase + size_t(l) * NH) * dh + col0, w, l < lv, whi + l * o.ws,
                         wlo + l * o.ws, wvf + l * o.ws);
    }
    st.stage(qs, ks, o.qs);
    __syncthreads();

    // the read's sums: MMA, rows 32 warp + 16 mt + g (+ 8) and columns 8 nt +
    // 2 qd (+ 1); SIMT, row tid and every column
    float acc[MMA ? 2 : 1][MMA ? 4 : E][MMA ? 4 : 1];
    float dnp[2][2];
#pragma unroll
    for (int x = 0; x < (MMA ? 2 : 1); ++x) {
#pragma unroll
      for (int y = 0; y < (MMA ? 4 : E); ++y)
#pragma unroll
        for (int z = 0; z < (MMA ? 4 : 1); ++z) acc[x][y][z] = 0.f;
      dnp[x][0] = dnp[x][1] = 0.f;
    }
    for (int t = 0; t < nslices; ++t) {
      const int d0 = t * DT;
      if (t + 1 < nslices) st.fetch(q, k, rowbase, NH, dh, lv, t + 1);
      // the update's sums, written after the barrier (update_mma, update_simt)
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      x_partial<T, DT>(w_s, ks, o.qs, red);  // n's
      if constexpr (MMA) {
        if (warp * 32 < lv) {
#pragma unroll
          for (int kk = 0; kk < DT / 16; ++kk) {
            uint32_t fa[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4(fa[mt], qs + (warp * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       o.qs + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float* cp = Cs + (nt * 8 + g) * o.cs + d0 + kk * 16 + 2 * qd;
              const float2 c0 = *reinterpret_cast<const float2*>(cp);
              const float2 c1 = *reinterpret_cast<const float2*>(cp + 8);
              const uint32_t b0 = pack_bf16(c0.x, c0.y), b1 = pack_bf16(c1.x, c1.y);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], fa[mt], b0, b1);
            }
            const float* np = ns + d0 + kk * 16 + 2 * qd;
            const float n0 = np[0], n1 = np[1], n8 = np[8], n9 = np[9];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              dnp[mt][0] += lo_f(fa[mt][0]) * n0 + hi_f(fa[mt][0]) * n1 + lo_f(fa[mt][2]) * n8 +
                            hi_f(fa[mt][2]) * n9;
              dnp[mt][1] += lo_f(fa[mt][1]) * n0 + hi_f(fa[mt][1]) * n1 + lo_f(fa[mt][3]) * n8 +
                            hi_f(fa[mt][3]) * n9;
            }
          }
        }
        update_mma(u, ks, o.qs, whi, wlo, o.ws);
      } else {
        const int l = tid;
        if (l < lv) {
          float qv[DT];
#pragma unroll
          for (int dd = 0; dd < DT; ++dd) qv[dd] = to_f(qs[l * o.qs + dd]);
          // each slice's sums start from zero and are then added to the
          // running ones (blocked: about 2.7 times less rounding than one
          // running sum over dh = 1024 terms)
          float dn = 0.f;
#pragma unroll
          for (int dd = 0; dd < DT; dd += 4) {
            const float4 nv = *reinterpret_cast<const float4*>(ns + d0 + dd);
            dn += qv[dd] * nv.x + qv[dd + 1] * nv.y + qv[dd + 2] * nv.z + qv[dd + 3] * nv.w;
          }
          dnp[0][0] += dn;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float p = 0.f;
#pragma unroll
            for (int dd = 0; dd < DT; dd += 4) {
              const float4 cv = *reinterpret_cast<const float4*>(Cs + e * o.cs + d0 + dd);
              p += qv[dd] * rnd<T>(cv.x) + qv[dd + 1] * rnd<T>(cv.y) + qv[dd + 2] * rnd<T>(cv.z) +
                   qv[dd + 3] * rnd<T>(cv.w);
            }
            acc[0][e][0] += p;
          }
        }
        update_simt<T, E, DT>(u, ks, o.qs, wvf, o.ws, lv);
      }
      __syncthreads();  // every read of C[d0:], n[d0:] and of the staged slice is done
      apply_update<MMA, E, DT>(Cs, o.cs, ns, red, d0, e_end, u);
      if (t + 1 < nslices) st.stage(qs, ks, o.qs);
      __syncthreads();
    }

    // combine: h = (h_intra + h_inter) / max(|d_intra + d_inter|, 1)
    if constexpr (MMA) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dnp[mt][r] += __shfl_xor_sync(0xffffffffu, dnp[mt][r], 1);
          dnp[mt][r] += __shfl_xor_sync(0xffffffffu, dnp[mt][r], 2);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int l = warp * 32 + mt * 16 + g + 8 * r;
          if (l >= lv) continue;
          const float ecl = ecl_s[l], eb = rnd<T>(ecl);
          const float denom = fmaxf(fabsf(__fadd_rn(di_s[l], __fmul_rn(dnp[mt][r], ecl))), 1.f);
          const size_t hb = (rowbase + size_t(l) * NH) * dh + col0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int e = nt * 8 + 2 * qd;
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(hin + hb + e);
            const float x0 = rnd<T>(__fmul_rn(rnd<T>(acc[mt][nt][2 * r]), eb));
            const float x1 = rnd<T>(__fmul_rn(rnd<T>(acc[mt][nt][2 * r + 1]), eb));
            *reinterpret_cast<__nv_bfloat162*>(hout + hb + e) = __floats2bfloat162_rn(
                __fdiv_rn(__fadd_rn(__low2float(hv), x0), denom),
                __fdiv_rn(__fadd_rn(__high2float(hv), x1), denom));
          }
        }
    } else {
      const int l = tid;
      if (l < lv) {
        const float ecl = ecl_s[l];
        const float denom = fmaxf(fabsf(__fadd_rn(di_s[l], __fmul_rn(dnp[0][0], ecl))), 1.f);
        const size_t hb = (rowbase + size_t(l) * NH) * dh + col0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = rnd<T>(__fmul_rn(rnd<T>(acc[0][e][0]), rnd<T>(ecl)));
          hout[hb + e] = from_f<T>(__fdiv_rn(__fadd_rn(to_f(hin[hb + e]), x), denom));
        }
      }
    }
  }
  __syncthreads();
  write_state(a.C + cbase, a.n + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
}

template <typename T, bool MMA, int E, int DT>
int launch(const Args& a, int B, cudaStream_t stream) {
  const Layout o = layout(a.dh, E, DT, sizeof(T), MMA);
  auto kern = a.Csave ? mlstm_scan_kernel<T, MMA, E, DT, true>
                      : mlstm_scan_kernel<T, MMA, E, DT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(o.total));
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.dh / E, a.NH, B), THREADS, o.total, stream>>>(a);
  return cudaGetLastError();
}

// The SIMT route: dh 8 and 16 in both types, multiples of 32 in fp32 (bf16
// takes the mma route there).
template <typename T>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  if (a.dh == 8) return launch<T, false, 8, 8>(a, B, stream);
  if (a.dh == 16) return launch<T, false, 16, 16>(a, B, stream);
  if constexpr (sizeof(T) == 4) return launch<T, false, 32, 16>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, h_intra (B, S, NH, dh) and h in bf16 (bf16 = 1) or fp32; i, cl,
// d_intra (B, S, NH) fp32; C0, n0 (null: zeros) and C, n fp32; Csave, nsave
// (null: not saved) fp32 (B, nc - 1, NH, dh, dh) and (B, nc - 1, NH, dh), nc =
// ceil(S / min(S, 256)): C and n between chunks, as they enter chunks 1 ..
// nc - 1. dh is 8, 16 or a multiple of 32. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v, const void* ig,
                                const void* cl, const void* h_intra, const void* d_intra,
                                const void* C0, const void* n0, void* h, void* C, void* n,
                                void* Csave, void* nsave, int B, int S, int NH, int dh, int bf16,
                                void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || (dh != 8 && dh != 16 && (dh <= 0 || dh % 32)) ||
      (!Csave != !nsave))
    return cudaErrorInvalidValue;
  const Args a{q,
               k,
               v,
               static_cast<const float*>(ig),
               static_cast<const float*>(cl),
               h_intra,
               static_cast<const float*>(d_intra),
               static_cast<const float*>(C0),
               static_cast<const float*>(n0),
               h,
               static_cast<float*>(C),
               static_cast<float*>(n),
               static_cast<float*>(Csave),
               static_cast<float*>(nsave),
               S,
               NH,
               dh};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && dh % 32 == 0) return launch<__nv_bfloat16, true, MMA_COLS, MMA_DT>(a, B, s);
  return bf16 ? launch_simt<__nv_bfloat16>(a, B, s) : launch_simt<float>(a, B, s);
}
