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
// of v), so a block owns one (batch row, head, E columns of C) and needs
// no exchange of state with other blocks and no atomics: every call gives
// the same bits. It keeps C^T[cols][dh] in fp32 (132 KB at dh 1024) and its
// own copy of n (dh fp32) in shared memory from the first chunk to the last
// and writes them once at the end. With SAVE (a template argument) it also
// writes the nc - 1 states between chunks (C_{j-1} and n_{j-1} entering
// chunk j > 0; the first chunk's is C0, the caller's) for the backward
// (csrc/mlstm_scan_bwd.cu): 201 MB more at xlstm-1.3b's training shape (4,
// 1024, 4, 1024), 60 us of bytes; without it the code is the same. Per
// chunk q_j and k_j pass through shared memory in slices of DT head-dim
// columns and, per slice d0:
//   1. the read: P[l, cols] += q[l, d0:] . bf16(C[d0:, cols]) and the
//      normalizer's q[l, d0:] . n[d0:], for every row l;
//   2. the update of C[d0:, cols] and n[d0:] with the slice of k: the rows
//      the read of this slice used and no other, so read and update share
//      one pass over q and k, and a barrier between them; n's update is
//      split over all threads by rows, the partial sums added in a fixed
//      order after the barrier;
// then combines P with h_intra and d_intra and writes h.
//
// Routes. "mma" (bf16 at dh a multiple of 32, mlstm_scan_mma_kernel): two
// warpgroups of consumers and a producer warpgroup, which keeps 40
// registers a thread and hands the rest to the consumers (232 each). One
// producer thread brings each slice of q and k by TMA (a 4-d map over (dh,
// NH, S, B), so the ragged last chunk's rows past S arrive as zeros) into a
// ring of NST stages. A stage is full on its mbarrier's byte count and
// empty once every consumer warp has arrived on its other mbarrier. The
// consumers meet once a slice, at a named barrier over them alone, and
// apply each slice's update while the next slice is read. w v's B fragments, constant over a chunk,
// stay in registers for the whole chunk (64 a thread, built from v's tile,
// which TMA brings once a chunk); each slice of C is converted to bf16
// once, into one of two small tiles, two slices ahead, and read by
// ldmatrix. The read gives warp w rows 32w..32w+31 (2 x 4 m16n8k16 tiles);
// the update gives warp w one 16 x 8 tile of C[d0:d0+32, cols] over all
// 256 rows (ldmatrix.trans of k; rows past the chunk are zero, so the loop
// has a fixed count and is unrolled). The reference's dC is fp32 from fp32
// w and upcast k and v. A bf16 product of w v would keep 8 bits of it, so
// w v is split into bf16 high and low parts, hi = bf16(wv), lo = bf16(wv -
// hi), and k . hi + k . lo runs as two products (k is exact in bf16; the
// tensor cores sum in fp32): about 16 bits of w v. The high and low parts
// and even and odd steps of 16 rows sum apart, four independent mma chains.
// The read's normalizer sums run in fp32 from the fragments' own
// registers, and n's update from the update's k fragments: the four warps
// of a 16-row half of the slice each sum a quarter of the chunk's rows in
// fp32, added in a fixed order. The read's and C's sums take the same
// terms in the same order as the earlier one-block design's (which staged
// q and k through registers, re-read them from L2 in every block and read
// w v from shared memory every slice), so h and C keep its bits where n
// does; n's sums run in another order. The loads and products are asm
// volatile, issued in the order written, so each k fragment is loaded a
// step ahead of its products, and h_intra a slice ahead of the combine.
// "simt" (fp32 at any supported dh, bf16 at dh 8 and 16,
// mlstm_scan_kernel): 256 threads, a thread a row for the read and the
// combine, each slice's sums blocked (started from zero, then added to the
// running ones), plain FMAs; the C update a thread per (d, column) pair; q
// and k staged through registers; the same rounding points.
//
// What bounds it (tools/mlstm_variants.py, PERF.md): not the products nor
// L2. At dh 1024 a slice takes a block about 2,000 clocks against some 600
// of mma.sync issue; taking out the read's or the update's products saves
// a tenth each. The dh / 32 blocks of a (row, head) read the same q and k
// from L2, but sharing them by TMA multicast in thread-block clusters of 2
// saved nothing measurable, so the grid runs without clusters. The ring's
// depth (two stages fit beside C^T) and the slice's shared-memory traffic,
// most of it the four warps of a half that load the same k fragments, set
// the time.
#include "mlstm.cuh"

namespace {

// The SIMT route's byte offsets in a block's shared memory
// (kernels/mlstm.py `smem_bytes` computes the total).
struct Layout {
  int cs, qs;  // row strides (elements) of C^T and of staged q and k
  size_t c, n, q, k, wv, vec, red, total;
};

__host__ __device__ inline Layout layout(int dh, int E, int DT, int elem) {
  Layout o;
  o.cs = dh + 4;
  o.qs = DT + (elem == 2 ? 2 : 1);
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
  off += align16(size_t(4) * ROWS * E);
  o.vec = off;
  off += 3 * align16(size_t(4) * ROWS);  // exp(cl), w, d_intra of the chunk's rows
  o.red = off;
  off += align16(size_t(4) * THREADS);   // the n update's partial sums
  o.total = off;
  return o;
}

// The mma route's: the ring's NST stages (a slice of q, then of k: ROWS rows
// of MMA_DT bf16, 64-byte rows in TMA's 64-byte swizzle), v's tile of the
// chunk (ROWS rows of the block's MMA_COLS columns, the same swizzle), C^T,
// n, two bf16 tiles of C's slices (rows of CBS), exp(cl), w and d_intra of
// the chunk's rows, two buffers of the n update's partial sums (NPART a
// slice) and the mbarriers (full and empty a stage, v's full and empty);
// the base rounded up to 1024 bytes, the swizzle's period.
constexpr int NST = 2;                            // the ring's stages
constexpr int CBS = MMA_DT + KPAD;                // row stride of a bf16 tile of C

struct MmaLayout {
  int cs;  // C^T's row stride (floats)
  size_t stage, v, c, n, cb, vec, red, bar, total;
};

__host__ __device__ inline MmaLayout mma_layout(int dh) {
  MmaLayout o;
  o.cs = dh + 4;
  size_t off = 0;
  o.stage = off;
  off += size_t(NST) * 2 * SLICE_BYTES;
  o.v = off;
  off += size_t(2) * ROWS * MMA_COLS;
  o.c = off;
  off += align16(size_t(4) * MMA_COLS * o.cs);
  o.n = off;
  off += align16(size_t(4) * dh);
  o.cb = off;
  off += 2 * align16(size_t(2) * MMA_COLS * CBS);
  o.vec = off;
  off += 3 * align16(size_t(4) * ROWS);
  o.red = off;
  off += 2 * align16(size_t(4) * NPART);
  o.bar = off;
  off += align16(size_t(8) * (2 * NST + 2));
  o.total = off + 1024;
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

// The SIMT route. One block: batch row blockIdx.z, head blockIdx.y, columns
// blockIdx.x E .. + E - 1 of C. SAVE: also write C and n between chunks
// (the backward's inputs); the rest is the same code, so h, C and n keep
// their bits.
template <typename T, int E, int DT, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1) mlstm_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, NH = a.NH, dh = a.dh;
  const Layout o = layout(dh, E, DT, sizeof(T));
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // C^T: Cs[e * cs + d] = C[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* qs = reinterpret_cast<T*>(smem + o.q);
  T* ks = reinterpret_cast<T*>(smem + o.k);
  float* ecl_s = reinterpret_cast<float*>(smem + o.vec);
  float* w_s = ecl_s + ROWS;
  float* di_s = w_s + ROWS;
  float* red = reinterpret_cast<float*>(smem + o.red);
  float* wvf = reinterpret_cast<float*>(smem + o.wv);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* hin = static_cast<const T*>(a.hin);
  T* hout = static_cast<T*>(a.h);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  for (int idx = tid; idx < dh * E; idx += THREADS) {
    const int d = idx / E, e = idx % E;
    Cs[e * o.cs + d] = a.C0 ? a.C0[cbase + size_t(d) * dh + col0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += THREADS) ns[d] = a.n0 ? a.n0[nbase + d] : 0.f;

  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT;
  Stager<T, DT> st;
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
      stage_b<T, E>(v + (rowbase + size_t(l) * NH) * dh + col0, w, l < lv, wvf + l * E);
    }
    st.stage(qs, ks, o.qs);
    __syncthreads();

    // the read's sums: row tid and every column
    float acc[E];
    float dnp = 0.f;
#pragma unroll
    for (int y = 0; y < E; ++y) acc[y] = 0.f;
    for (int t = 0; t < nslices; ++t) {
      const int d0 = t * DT;
      if (t + 1 < nslices) st.fetch(q, k, rowbase, NH, dh, lv, t + 1);
      // the update's sums, written after the barrier (update_simt)
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      x_partial<T, DT>(w_s, ks, o.qs, red);  // n's
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
        dnp += dn;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float p = 0.f;
#pragma unroll
          for (int dd = 0; dd < DT; dd += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(Cs + e * o.cs + d0 + dd);
            p += qv[dd] * rnd<T>(cv.x) + qv[dd + 1] * rnd<T>(cv.y) + qv[dd + 2] * rnd<T>(cv.z) +
                 qv[dd + 3] * rnd<T>(cv.w);
          }
          acc[e] += p;
        }
      }
      update_simt<T, E, DT>(u, ks, o.qs, wvf, E, lv);
      __syncthreads();  // every read of C[d0:], n[d0:] and of the staged slice is done
      apply_update<E, DT>(Cs, o.cs, ns, red, d0, e_end, u);
      if (t + 1 < nslices) st.stage(qs, ks, o.qs);
      __syncthreads();
    }

    // combine: h = (h_intra + h_inter) / max(|d_intra + d_inter|, 1)
    const int l = tid;
    if (l < lv) {
      const float ecl = ecl_s[l];
      const float denom = fmaxf(fabsf(__fadd_rn(di_s[l], __fmul_rn(dnp, ecl))), 1.f);
      const size_t hb = (rowbase + size_t(l) * NH) * dh + col0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = rnd<T>(__fmul_rn(rnd<T>(acc[e]), rnd<T>(ecl)));
        hout[hb + e] = from_f<T>(__fdiv_rn(__fadd_rn(to_f(hin[hb + e]), x), denom));
      }
    }
  }
  __syncthreads();
  write_state(a.C + cbase, a.n + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
}

// bf16(C[d0 .. d0 + 31][cols]) into a tile cb[e * CBS + dd] (the read's B
// operand), four values a consumer thread
__device__ __forceinline__ void convert_slice(const float* Cs, int cstride, int d0,
                                              __nv_bfloat16* cb) {
  const int e = threadIdx.x >> 3, dd = (threadIdx.x & 7) * 4;
  const float4 c = *reinterpret_cast<const float4*>(Cs + e * cstride + d0 + dd);
  *reinterpret_cast<uint2*>(cb + e * CBS + dd) = make_uint2(pack_bf16(c.x, c.y),
                                                            pack_bf16(c.z, c.w));
}

// The mma route (bf16, E = MMA_COLS, DT = MMA_DT): block (blockIdx.x, head
// blockIdx.y, batch row blockIdx.z) owns columns 32 blockIdx.x .. + 31 of C.
// tq, tk and tv map q, k and v (dh, NH, S, B) in the 64-byte swizzle, box
// (32, 1, ROWS, 1).
template <bool SAVE>
__global__ void __launch_bounds__(BLOCK, 1)
    mlstm_scan_mma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Args a) {
  using T = __nv_bfloat16;
  constexpr int E = MMA_COLS, DT = MMA_DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = a.S, NH = a.NH, dh = a.dh;
  const MmaLayout o = mma_layout(dh);
  T* stages = reinterpret_cast<T*>(smem + o.stage);  // stage s: q at 2 s ROWS DT, then k
  const T* vs = reinterpret_cast<const T*>(smem + o.v);
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // C^T: Cs[e * cs + d] = C[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* cb = reinterpret_cast<T*>(smem + o.cb);
  constexpr int CB = int(align16(size_t(2) * MMA_COLS * CBS) / 2);  // elements a tile of C
  float* ecl_s = reinterpret_cast<float*>(smem + o.vec);
  float* w_s = ecl_s + ROWS;
  float* di_s = w_s + ROWS;
  float* red = reinterpret_cast<float*>(smem + o.red);
  const uint32_t full0 = smem_u32(smem + o.bar), empty0 = full0 + 8 * NST;
  const uint32_t vfull = full0 + 16 * NST, vempty = vfull + 8;
  const T* hin = static_cast<const T*>(a.hin);
  T* hout = static_cast<T*>(a.h);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, THREADS / 32);  // every consumer warp
    }
    mbar_init(vfull, 1);
    mbar_init(vempty, THREADS / 32);
  }
  if (warp < PRODUCER) {
    for (int idx = tid; idx < dh * E; idx += THREADS) {
      const int d = idx / E, e = idx % E;
      Cs[e * o.cs + d] = a.C0 ? a.C0[cbase + size_t(d) * dh + col0 + e] : 0.f;
    }
    for (int d = tid; d < dh; d += THREADS) ns[d] = a.n0 ? a.n0[nbase + d] : 0.f;
  }
  __syncthreads();  // the mbarriers are initialised before any load or arrival

  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT;
  if (warp >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == PRODUCER && lane == 0) {
      int it = 0;
      for (int j = 0; j < nchunks; ++j) {
        const int s0 = j * L;
        if (j) mbar_wait(vempty, (j - 1) & 1);  // the consumers hold chunk j - 1's w v
        mbar_expect_tx(vfull, 2 * ROWS * E);
        tma_load(smem_u32(vs), &tv, vfull, col0, hd, s0, b);
        for (int t = 0; t < nslices; ++t, ++it) {
          const int s = it % NST, use = it / NST;
          // every consumer warp is done with the stage's last use
          if (use) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
          const uint32_t full = full0 + 8 * s, dq = smem_u32(stages + 2 * s * ROWS * DT);
          mbar_expect_tx(full, 2 * SLICE_BYTES);
          tma_load(dq, &tq, full, t * DT, hd, s0, b);
          tma_load(dq + SLICE_BYTES, &tk, full, t * DT, hd, s0, b);
        }
      }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    uint32_t wf[ROWS / 16][4];  // w v's B fragments of the chunk (update_mma_n)
    float wn[4][4];             // w of this lane's rows of n's sums (update_mma_n)
    int it = 0;
    for (int j = 0; j < nchunks; ++j) {
      const int s0 = j * L, lv = min(L, S - s0);
      const size_t rowbase = (size_t(b) * S + s0) * NH + hd;  // (b, s0, hd) in (B, S, NH)
      named_bar_sync(1, THREADS);  // the previous chunk's updates and combine are done
      if constexpr (SAVE) {  // C_{j-1}, n_{j-1}: between chunks j - 1 and j (C0 is the caller's)
        if (j > 0) {
          const size_t sb = (size_t(b) * (nchunks - 1) + j - 1) * NH + hd;
          write_state(a.Csave + sb * dh * dh, a.nsave + sb * dh, Cs, o.cs, ns, dh, E, col0,
                      blockIdx.x == 0);
        }
      }
      const float cl_end = a.cl[rowbase + size_t(lv - 1) * NH];
      const float e_end = expf(cl_end);
      {  // row tid: exp(cl), w, d_intra
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
      }
      convert_slice(Cs, o.cs, 0, cb);
      if (nslices > 1) convert_slice(Cs, o.cs, DT, cb + CB);
      named_bar_sync(1, THREADS);
      {  // w v = w x v of rows 16 r + 8 h + 2 qd (+ 1), column 8 (warp % 4) + g: hi, lo
        mbar_wait(vfull, j & 1);
        const int e = (warp & 3) * 8 + g;
#pragma unroll
        for (int r = 0; r < ROWS / 16; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = 16 * r + 8 * h + 2 * qd;
            const float p0 = __fmul_rn(w_s[l], __bfloat162float(vs[sw64(l, e)]));
            const float p1 = __fmul_rn(w_s[l + 1], __bfloat162float(vs[sw64(l + 1, e)]));
            const T h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
            wf[r][h] = pack2(h0, h1);
            wf[r][2 + h] = pack2(__float2bfloat16_rn(__fsub_rn(p0, __bfloat162float(h0))),
                                 __float2bfloat16_rn(__fsub_rn(p1, __bfloat162float(h1))));
          }
#pragma unroll
        for (int p4 = 0; p4 < 4; ++p4)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            wn[p4][x] = w_s[16 * (4 * (warp & 3) + p4) + 2 * qd + (x & 1) + 8 * (x >> 1)];
        __syncwarp();
        if (lane == 0) mbar_arrive(vempty);
      }

      // the read's sums: rows 32 warp + 16 mt + g (+ 8) and columns 8 nt + 2 qd (+ 1)
      float acc[2][4][4], dnp[2][2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[x][y][z] = 0.f;
        dnp[x][0] = dnp[x][1] = 0.f;
      }
      uint32_t hpre[2][2][4];  // h_intra of the combine's rows, loaded a slice ahead
      for (int t = 0; t < nslices; ++t, ++it) {
        const int s = it % NST, d0 = t * DT;
        if (t == nslices - 1) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int l = warp * 32 + mt * 16 + g + 8 * r;
              const size_t hb = (rowbase + size_t(l) * NH) * dh + col0 + 2 * qd;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                hpre[mt][r][nt] =
                    l < lv ? *reinterpret_cast<const uint32_t*>(hin + hb + nt * 8) : 0u;
            }
        }
        mbar_wait(full0 + 8 * s, (it / NST) & 1);
        const T* qs = stages + 2 * s * ROWS * DT;
        const T* ks = qs + ROWS * DT;
        if (warp * 32 < lv) {
          const T* cbt = cb + (t & 1) * CB;
          uint32_t fb[4][4];  // C's slice: [nt] = b0, b1 of kk 0, then of kk 1
          uint32_t fa[DT / 16][2][4];
          // every fragment first (asm volatile: issued in the order written)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            ldsm_x4(fb[nt], cbt + (nt * 8 + (lane & 7)) * CBS + (lane >> 3) * 8);
#pragma unroll
          for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4(fa[kk][mt],
                      qs + sw64(warp * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                kk * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int kk = 0; kk < DT / 16; ++kk) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma_bf16(acc[mt][nt], fa[kk][mt], fb[nt][2 * kk], fb[nt][2 * kk + 1]);
            const float* np = ns + d0 + kk * 16 + 2 * qd;
            const float n0 = np[0], n1 = np[1], n8 = np[8], n9 = np[9];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const uint32_t* f = fa[kk][mt];
              dnp[mt][0] += lo_f(f[0]) * n0 + hi_f(f[0]) * n1 + lo_f(f[2]) * n8 + hi_f(f[2]) * n9;
              dnp[mt][1] += lo_f(f[1]) * n0 + hi_f(f[1]) * n1 + lo_f(f[3]) * n8 + hi_f(f[3]) * n9;
            }
          }
        }
        float u[4], xn[2];
        update_mma_n(u, xn, ks, wf, wn);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
        float* part = red + (t & 1) * NPART;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          xn[x] += __shfl_xor_sync(0xffffffffu, xn[x], 1);
          xn[x] += __shfl_xor_sync(0xffffffffu, xn[x], 2);
          if (qd == 0) part[(warp & 3) * 32 + (warp >> 2) * 16 + 8 * x + g] = xn[x];
        }
        // every read of C's slice tile and n[d0:] is done, and every
        // partial sum of n written
        named_bar_sync(1, THREADS);
        {  // C[d0 + 16 um + g (+ 8)][8 un + 2 qd (+ 1)] += u
          float* c = Cs + ((warp & 3) * 8 + 2 * qd) * o.cs + d0 + (warp >> 2) * 16 + g;
          c[0] = __fadd_rn(__fmul_rn(e_end, c[0]), u[0]);
          c[o.cs] = __fadd_rn(__fmul_rn(e_end, c[o.cs]), u[1]);
          c[8] = __fadd_rn(__fmul_rn(e_end, c[8]), u[2]);
          c[o.cs + 8] = __fadd_rn(__fmul_rn(e_end, c[o.cs + 8]), u[3]);
        }
        if (warp == 0) apply_n(ns, part, d0, e_end);
        if (t + 2 < nslices) convert_slice(Cs, o.cs, d0 + 2 * DT, cb + (t & 1) * CB);
      }

      // combine: h = (h_intra + h_inter) / max(|d_intra + d_inter|, 1)
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
            const float x0 = rnd<T>(__fmul_rn(rnd<T>(acc[mt][nt][2 * r]), eb));
            const float x1 = rnd<T>(__fmul_rn(rnd<T>(acc[mt][nt][2 * r + 1]), eb));
            *reinterpret_cast<__nv_bfloat162*>(hout + hb + e) = __floats2bfloat162_rn(
                __fdiv_rn(__fadd_rn(lo_f(hpre[mt][r][nt]), x0), denom),
                __fdiv_rn(__fadd_rn(hi_f(hpre[mt][r][nt]), x1), denom));
          }
        }
    }
    named_bar_sync(1, THREADS);
    write_state(a.C + cbase, a.n + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
  }
}

template <typename T, int E, int DT>
int launch_simt_at(const Args& a, int B, cudaStream_t stream) {
  const Layout o = layout(a.dh, E, DT, sizeof(T));
  auto kern = a.Csave ? mlstm_scan_kernel<T, E, DT, true> : mlstm_scan_kernel<T, E, DT, false>;
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
  if (a.dh == 8) return launch_simt_at<T, 8, 8>(a, B, stream);
  if (a.dh == 16) return launch_simt_at<T, 16, 16>(a, B, stream);
  if constexpr (sizeof(T) == 4) return launch_simt_at<T, 32, 16>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <bool SAVE>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  auto kern = mlstm_scan_mma_kernel<SAVE>;
  const size_t smem = mma_layout(a.dh).total;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  const long long sl = (long long)a.NH * a.dh, sb = sl * a.S;
  int err = make_map(&tq, a.q, a.dh, a.NH, a.S, B, sb, sl, a.dh, ROWS, MMA_DT,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = make_map(&tk, a.k, a.dh, a.NH, a.S, B, sb, sl, a.dh, ROWS, MMA_DT,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = make_map(&tv, a.v, a.dh, a.NH, a.S, B, sb, sl, a.dh, ROWS, MMA_COLS,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return cudaErrorInvalidValue;
  kern<<<dim3(a.dh / MMA_COLS, a.NH, B), BLOCK, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, h_intra (B, S, NH, dh) and h in bf16 (bf16 = 1) or fp32; i, cl,
// d_intra (B, S, NH) fp32; C0, n0 (null: zeros) and C, n fp32; Csave, nsave
// (null: not saved) fp32 (B, nc - 1, NH, dh, dh) and (B, nc - 1, NH, dh), nc =
// ceil(S / min(S, 256)): C and n between chunks, as they enter chunks 1 ..
// nc - 1. dh is 8, 16 or a multiple of 32 (in bf16 at most 1024). Launches on
// `stream`; returns the launch's cudaError_t.
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
  if (bf16 && dh % 32 == 0) return Csave ? launch_mma<true>(a, B, s) : launch_mma<false>(a, B, s);
  return bf16 ? launch_simt<__nv_bfloat16>(a, B, s) : launch_simt<float>(a, B, s);
}
