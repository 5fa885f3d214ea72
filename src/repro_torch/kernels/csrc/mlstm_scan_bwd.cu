// mLSTM chunk recurrence's backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces no Pallas kernel: the reference differentiates its jax.lax.scan
// over chunks (src/repro/models/xlstm.py:108, body `_mlstm_chunk_scan` at
// :80-106), which XLA transposes into a loop over the chunks in reverse on
// the device. This kernel is that loop's carried part, the cotangents of C
// and n carried from the last chunk to the first, and the one product of
// dv that reads them. From dC_n and dn_n (the cotangents of the last C and
// n) or from zeros, for chunk j = nc - 1 down to 0, with e_end = exp(cl_end)
// of chunk j and, from torch beforehand (kernels/mlstm.py `mlstm_backward`),
// g_l = exp(cl_l) dh_l / den_l (B, S, NH, dh) and u_l = ds_l exp(cl_l) (B,
// S, NH) fp32, the read's cotangents:
//   T_j      = k_j dC_j                      (L x dh, fp32; dv's carried term
//                                              is w_l T_j[l], in torch)
//   dC_{j-1} = e_end dC_j + q_j^T g_j        (dh x dh, fp32)
//   dn_{j-1} = e_end dn_j + q_j^T u_j
//   written: T_j's rows, and the cotangents of the state between chunks
//   j - 1 and j
// The read (T_j) runs where dC_j is not zero: on every chunk but the last,
// and on the last where dC_n is given. The update runs where its result is
// used: on every chunk but the first, and on the first where dC0, dn0 are
// asked (then written). Training gives neither, so chunk nc - 1 runs its
// update alone, chunks nc - 2 .. 1 both, chunk 0 its read alone, from the
// dC_0 the kernel has just written. Everything else of the backward is
// carry-free once these and the states between chunks are known, and
// stays in torch.
//
// Bound on this card. A chunk's update is 2 L dh^2 + 2 L dh FLOPs a head,
// its read 2 L dh^2; the bytes are q, g and u of the chunks updated and k of
// the chunks read, read once, T written for the rows read, and the dC_{j-1},
// dn_{j-1} written (dh^2 + dh fp32 a state and head). At xlstm-1.3b's
// training shape (4, 1024, 4, 1024) in bf16 (3 of 4 chunks each): 51.6
// GFLOP (52 us at 989 TFLOP/s) against 352 MB (105 us at 3.35 TB/s): the
// bytes bound it.
//
// Design: the forward's (csrc/mlstm_scan.cu) turned round, with k in the
// read's place of q and q, g, u in the update's places of k, w v, w. dC's
// columns are independent (column e of q^T g needs only column e of g, and
// column e of T only column e of dC), so a block owns one (batch row, head,
// 32 columns of dC), keeps dC^T[cols][dh] and its own copy of dn in shared
// memory from the last chunk to the first, writes them out between chunks
// and needs no exchange and no atomics: every call gives the same bits. Per
// chunk q and k pass through shared memory in slices of DT head-dim
// columns and, per slice d0: 1. the read, T[l, cols] += k[l, d0:] .
// dC[d0:, cols] for every row l, before 2. the update of dC[d0:, cols] and
// dn[d0:] with the slice of q.
//
// Routes. "mma" (bf16 at dh a multiple of 32, mlstm_scan_bwd_mma_kernel):
// the forward's mma route's block. A producer warpgroup keeps 40 registers
// a thread and hands the rest to the two consumer warpgroups (232); one
// producer thread brings each slice of q (chunks updated) and of k (chunks
// read) by TMA (4-d maps over (dh, NH, S, B), 64-byte swizzle, so the
// ragged last chunk's rows past S arrive as zeros) into a ring of NST
// mbarrier stages, full on the byte count, empty once every consumer warp
// has arrived. The consumers meet once a slice at a named barrier. g's B
// fragments (bf16 high and low parts of the fp32 g, hi = bf16(g), lo =
// bf16(g - hi): about 16 bits of g) are constant over a chunk and built once
// a chunk into registers (64 a thread) straight from global memory; the
// update (`update_mma_n`, ldmatrix.trans of q) gives warp w one 16 x 8 tile
// of dC[d0:d0+32, cols] over all 256 rows in four independent mma chains
// (high and low parts, even and odd steps of 16 rows) added in a fixed
// order, the association of the earlier design that staged q through
// registers (so dC keeps its bits), and dn's sums from the same q fragments
// in another fixed order. The reference's T is fp32 (the transpose of its
// fp32 update), so each slice of dC is split into bf16 high and low tiles,
// two slices ahead, and the read runs k . hi + k . lo (k is exact in bf16;
// the tensor cores sum in fp32): warp w takes rows 32w..32w+31 (2 x 4
// m16n8k16 tiles), kept in registers over the chunk and written once.
// "simt" (fp32 at any supported dh, bf16 at dh 8 and 16,
// mlstm_scan_bwd_kernel): 256 threads, q and k staged through registers,
// the update a thread per (d, column) pair with dn's partial sums by rows
// (the earlier design's bits), and the read a thread a row, each slice's
// sums blocked (started from zero, then added to the running ones), as the
// forward's SIMT read.
#include "mlstm.cuh"

namespace {

// The SIMT route's byte offsets in a block's shared memory
// (kernels/mlstm.py `smem_bytes_bwd` computes the total).
struct Layout {
  int cs, qs;  // row strides (elements) of dC^T and of staged q and k
  size_t c, n, q, k, g, vec, red, total;
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
  o.g = off;
  off += align16(size_t(4) * ROWS * E);  // g's columns of the chunk's rows, fp32
  o.vec = off;
  off += align16(size_t(4) * ROWS);      // u of the chunk's rows
  o.red = off;
  off += align16(size_t(4) * THREADS);   // the dn update's partial sums
  o.total = off;
  return o;
}

// The mma route's: the ring's NST stages (a slice of q, then of k: ROWS rows
// of MMA_DT bf16 in TMA's 64-byte swizzle), dC^T, dn, four bf16 tiles (the
// high and low parts of two slices of dC, rows of CBS), u of the chunk's
// rows, two buffers of dn's partial sums (NPART a slice) and the mbarriers
// (full and empty a stage); the base rounded up to 1024 bytes, the
// swizzle's period.
constexpr int NST = 2;                            // the ring's stages
constexpr int CBS = MMA_DT + KPAD;                // row stride of a bf16 tile of dC
constexpr int CB = int(align16(size_t(2) * MMA_COLS * CBS) / 2);  // elements a tile

struct MmaLayout {
  int cs;  // dC^T's row stride (floats)
  size_t stage, c, n, cb, vec, red, bar, total;
};

__host__ __device__ inline MmaLayout mma_layout(int dh) {
  MmaLayout o;
  o.cs = dh + 4;
  size_t off = 0;
  o.stage = off;
  off += size_t(NST) * 2 * SLICE_BYTES;
  o.c = off;
  off += align16(size_t(4) * MMA_COLS * o.cs);
  o.n = off;
  off += align16(size_t(4) * dh);
  o.cb = off;
  off += 4 * align16(size_t(2) * MMA_COLS * CBS);
  o.vec = off;
  off += align16(size_t(4) * ROWS);
  o.red = off;
  off += 2 * align16(size_t(4) * NPART);
  o.bar = off;
  off += align16(size_t(8) * 2 * NST);
  o.total = off + 1024;
  return o;
}

struct Args {
  const void *q, *k;                   // (B, S, NH, dh)
  const float *g, *u, *cl;             // (B, S, NH, dh), (B, S, NH), (B, S, NH)
  const float *dCn, *dnn;              // (B, NH, dh, dh), (B, NH, dh) or null
  float *dCs, *dns;                    // (B, nc - 1, NH, dh, dh), (B, nc - 1, NH, dh)
  float *dC0, *dn0;                    // (B, NH, dh, dh), (B, NH, dh) or null
  float* kdc;                          // T = k dC (B, R, NH, dh): the rows of the chunks read
  int S, NH, dh;
};

// Chunk j's read runs where dC_j is not zero, its update where its result
// is used (see the head of the file): dCn and dC0 the caller's, or null.
__device__ __forceinline__ bool reads(int j, int nchunks, const float* dCn) {
  return j < nchunks - 1 || dCn != nullptr;
}
__device__ __forceinline__ bool updates(int j, const float* dC0) { return j > 0 || dC0 != nullptr; }

// R, the rows T holds: those of the chunks read, a prefix of the sequence.
__device__ __forceinline__ int rows_read(int S, int L, int nchunks, const float* dCn) {
  const int n = (nchunks - 1 + (dCn != nullptr)) * L;
  return n < S ? n : S;
}

// The SIMT route. One block: batch row blockIdx.z, head blockIdx.y, columns
// blockIdx.x E .. + E - 1 of dC.
template <typename T, int E, int DT>
__global__ void __launch_bounds__(THREADS, 1) mlstm_scan_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, NH = a.NH, dh = a.dh;
  const Layout o = layout(dh, E, DT, sizeof(T));
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // dC^T: Cs[e * cs + d] = dC[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* qs = reinterpret_cast<T*>(smem + o.q);
  T* ks = reinterpret_cast<T*>(smem + o.k);
  float* gf = reinterpret_cast<float*>(smem + o.g);
  float* u_s = reinterpret_cast<float*>(smem + o.vec);
  float* red = reinterpret_cast<float*>(smem + o.red);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);

  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT, R = rows_read(S, L, nchunks, a.dCn);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  for (int idx = tid; idx < dh * E; idx += THREADS) {
    const int d = idx / E, e = idx % E;
    Cs[e * o.cs + d] = a.dCn ? a.dCn[cbase + size_t(d) * dh + col0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += THREADS) ns[d] = a.dnn ? a.dnn[nbase + d] : 0.f;

  Stager<T, DT> st;
  for (int j = nchunks - 1; j >= 0; --j) {
    const bool rd = reads(j, nchunks, a.dCn), up = updates(j, a.dC0);
    if (!rd && !up) continue;
    const int s0 = j * L, lv = min(L, S - s0);
    const size_t rowbase = (size_t(b) * S + s0) * NH + hd;  // (b, s0, hd) in (B, S, NH)
    st.fetch(q, k, rowbase, NH, dh, lv, 0);
    __syncthreads();  // the later chunk is done with g, u and the staged slices
    const float e_end = expf(a.cl[rowbase + size_t(lv - 1) * NH]);
    {  // row tid: u and g over the block's columns (zeros past the chunk)
      const int l = tid;
      const size_t ri = rowbase + size_t(l) * NH;
      u_s[l] = l < lv ? a.u[ri] : 0.f;
      stage_b<float, E>(a.g + ri * dh + col0, 1.f, l < lv, gf + l * E);
    }
    st.stage(qs, ks, o.qs);
    __syncthreads();
    float acc[E];  // the read's sums: row tid and every column
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int t = 0; t < nslices; ++t) {
      const int d0 = t * DT;
      if (t + 1 < nslices) st.fetch(q, k, rowbase, NH, dh, lv, t + 1);
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      if (up) {
        x_partial<T, DT>(u_s, qs, o.qs, red);  // dn's
        update_simt<T, E, DT>(u, qs, o.qs, gf, E, lv);
      }
      if (rd && tid < lv) {  // this slice's sums from zero, then added to the running ones
        float kv[DT];
#pragma unroll
        for (int dd = 0; dd < DT; ++dd) kv[dd] = to_f(ks[tid * o.qs + dd]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float p = 0.f;
#pragma unroll
          for (int dd = 0; dd < DT; dd += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(Cs + e * o.cs + d0 + dd);
            p += kv[dd] * cv.x + kv[dd + 1] * cv.y + kv[dd + 2] * cv.z + kv[dd + 3] * cv.w;
          }
          acc[e] += p;
        }
      }
      __syncthreads();  // every read of dC[d0:], of the staged slices and of the partial sums' inputs is done
      if (up) apply_update<E, DT>(Cs, o.cs, ns, red, d0, e_end, u);
      if (t + 1 < nslices) st.stage(qs, ks, o.qs);
      __syncthreads();
    }
    if (rd && tid < lv) {
      float* tr = a.kdc + ((size_t(b) * R + s0 + tid) * NH + hd) * dh + col0;
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(tr + e) = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
    if (up) {
      if (j > 0) {  // dC_{j-1}, dn_{j-1}: the state between chunks j - 1 and j
        const size_t sb = (size_t(b) * (nchunks - 1) + j - 1) * NH + hd;
        write_state(a.dCs + sb * dh * dh, a.dns + sb * dh, Cs, o.cs, ns, dh, E, col0,
                    blockIdx.x == 0);
      } else {
        write_state(a.dC0 + cbase, a.dn0 + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
      }
    }
  }
}

// dC[d0 .. d0 + 31][cols] split into bf16 high and low parts, hi = bf16(x),
// lo = bf16(x - hi), into tiles hi[e * CBS + dd] and lo (the read's B
// operands), four values a consumer thread
__device__ __forceinline__ void convert_split(const float* Cs, int cstride, int d0,
                                              __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const int e = threadIdx.x >> 3, dd = (threadIdx.x & 7) * 4;
  const float4 c = *reinterpret_cast<const float4*>(Cs + e * cstride + d0 + dd);
  const float x[4] = {c.x, c.y, c.z, c.w};
  uint32_t hw[2], lw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x[2 * i]), h1 = __float2bfloat16_rn(x[2 * i + 1]);
    hw[i] = pack2(h0, h1);
    lw[i] = pack2(__float2bfloat16_rn(__fsub_rn(x[2 * i], __bfloat162float(h0))),
                  __float2bfloat16_rn(__fsub_rn(x[2 * i + 1], __bfloat162float(h1))));
  }
  *reinterpret_cast<uint2*>(hi + e * CBS + dd) = make_uint2(hw[0], hw[1]);
  *reinterpret_cast<uint2*>(lo + e * CBS + dd) = make_uint2(lw[0], lw[1]);
}

// The mma route (bf16, E = MMA_COLS, DT = MMA_DT): block (blockIdx.x, head
// blockIdx.y, batch row blockIdx.z) owns columns 32 blockIdx.x .. + 31 of
// dC. tq and tk map q and k (dh, NH, S, B) in the 64-byte swizzle, box (32,
// 1, ROWS, 1).
__global__ void __launch_bounds__(BLOCK, 1)
    mlstm_scan_bwd_mma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk, Args a) {
  using T = __nv_bfloat16;
  constexpr int E = MMA_COLS, DT = MMA_DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = a.S, NH = a.NH, dh = a.dh;
  const MmaLayout o = mma_layout(dh);
  T* stages = reinterpret_cast<T*>(smem + o.stage);  // stage s: q at 2 s ROWS DT, then k
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // dC^T: Cs[e * cs + d] = dC[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* cb = reinterpret_cast<T*>(smem + o.cb);  // slice parity p: high part at 2 p CB, low after
  float* u_s = reinterpret_cast<float*>(smem + o.vec);
  float* red = reinterpret_cast<float*>(smem + o.red);
  const uint32_t full0 = smem_u32(smem + o.bar), empty0 = full0 + 8 * NST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT, R = rows_read(S, L, nchunks, a.dCn);
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, THREADS / 32);  // every consumer warp
    }
  }
  if (warp < PRODUCER) {
    for (int idx = tid; idx < dh * E; idx += THREADS) {
      const int d = idx / E, e = idx % E;
      Cs[e * o.cs + d] = a.dCn ? a.dCn[cbase + size_t(d) * dh + col0 + e] : 0.f;
    }
    for (int d = tid; d < dh; d += THREADS) ns[d] = a.dnn ? a.dnn[nbase + d] : 0.f;
  }
  __syncthreads();  // the mbarriers are initialised before any load or arrival

  if (warp >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == PRODUCER && lane == 0) {
      int it = 0;
      for (int j = nchunks - 1; j >= 0; --j) {
        const bool rd = reads(j, nchunks, a.dCn), up = updates(j, a.dC0);
        if (!rd && !up) continue;
        const int s0 = j * L;
        for (int t = 0; t < nslices; ++t, ++it) {
          const int s = it % NST, use = it / NST;
          // every consumer warp is done with the stage's last use
          if (use) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
          const uint32_t full = full0 + 8 * s, dq = smem_u32(stages + 2 * s * ROWS * DT);
          mbar_expect_tx(full, (int(up) + int(rd)) * SLICE_BYTES);
          if (up) tma_load(dq, &tq, full, t * DT, hd, s0, b);
          if (rd) tma_load(dq + SLICE_BYTES, &tk, full, t * DT, hd, s0, b);
        }
      }
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    uint32_t gfr[ROWS / 16][4];  // g's B fragments of the chunk (update_mma_n)
    float ur[4][4];              // u of this lane's rows of dn's sums (update_mma_n)
    int it = 0;
    for (int j = nchunks - 1; j >= 0; --j) {
      const bool rd = reads(j, nchunks, a.dCn), up = updates(j, a.dC0);
      if (!rd && !up) continue;
      const int s0 = j * L, lv = min(L, S - s0);
      const size_t rowbase = (size_t(b) * S + s0) * NH + hd;  // (b, s0, hd) in (B, S, NH)
      named_bar_sync(1, THREADS);  // the later chunk's updates and reads are done
      // g of rows 16 r + 8 h + 2 qd (+ 1), column 8 (warp % 4) + g, loaded
      // before the state is written and split into hi, lo after it
      float graw[ROWS / 16][2][2];
      if (up) {
        const float* gp = a.g + rowbase * dh + col0 + (warp & 3) * 8 + g;
        const size_t rs = size_t(NH) * dh;  // a row's stride in g
#pragma unroll
        for (int r = 0; r < ROWS / 16; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int l = 16 * r + 8 * h + 2 * qd + x;
              graw[r][h][x] = l < lv ? __ldg(gp + l * rs) : 0.f;
            }
      }
      if (j < nchunks - 1) {  // dC_j, dn_j: between chunks j and j + 1, from chunk j + 1's update
        const size_t sb = (size_t(b) * (nchunks - 1) + j) * NH + hd;
        write_state(a.dCs + sb * dh * dh, a.dns + sb * dh, Cs, o.cs, ns, dh, E, col0,
                    blockIdx.x == 0);
      }
      const float e_end = expf(a.cl[rowbase + size_t(lv - 1) * NH]);
      if (up) u_s[tid] = tid < lv ? a.u[rowbase + size_t(tid) * NH] : 0.f;
      if (rd) {
        convert_split(Cs, o.cs, 0, cb, cb + CB);
        if (nslices > 1) convert_split(Cs, o.cs, DT, cb + 2 * CB, cb + 3 * CB);
      }
      if (up) {
#pragma unroll
        for (int r = 0; r < ROWS / 16; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = graw[r][h][0], p1 = graw[r][h][1];
            const T h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
            gfr[r][h] = pack2(h0, h1);
            gfr[r][2 + h] = pack2(__float2bfloat16_rn(__fsub_rn(p0, __bfloat162float(h0))),
                                  __float2bfloat16_rn(__fsub_rn(p1, __bfloat162float(h1))));
          }
      }
      named_bar_sync(1, THREADS);
      if (up) {
#pragma unroll
        for (int p4 = 0; p4 < 4; ++p4)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            ur[p4][x] = u_s[16 * (4 * (warp & 3) + p4) + 2 * qd + (x & 1) + 8 * (x >> 1)];
      }

      // the read's sums: rows 32 warp + 16 mt + g (+ 8) and columns 8 nt + 2 qd (+ 1)
      float acc[2][4][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[x][y][z] = 0.f;
      for (int t = 0; t < nslices; ++t, ++it) {
        const int s = it % NST, d0 = t * DT;
        mbar_wait(full0 + 8 * s, (it / NST) & 1);
        const T* qs = stages + 2 * s * ROWS * DT;
        const T* ks = qs + ROWS * DT;
        if (rd && warp * 32 < lv) {
          const T* hi = cb + 2 * (t & 1) * CB;
          const T* lo = hi + CB;
          uint32_t fh[4][4], fl[4][4];  // dC's slice: [nt] = b0, b1 of kk 0, then of kk 1
          uint32_t fa[DT / 16][2][4];
          // every fragment first (asm volatile: issued in the order written)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            ldsm_x4(fh[nt], hi + (nt * 8 + (lane & 7)) * CBS + (lane >> 3) * 8);
            ldsm_x4(fl[nt], lo + (nt * 8 + (lane & 7)) * CBS + (lane >> 3) * 8);
          }
#pragma unroll
          for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4(fa[kk][mt],
                      ks + sw64(warp * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                kk * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][nt], fa[kk][mt], fh[nt][2 * kk], fh[nt][2 * kk + 1]);
                mma_bf16(acc[mt][nt], fa[kk][mt], fl[nt][2 * kk], fl[nt][2 * kk + 1]);
              }
        }
        float u[4], xn[2];
        if (up) update_mma_n(u, xn, qs, gfr, ur);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
        float* part = red + (t & 1) * NPART;
        if (up) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            xn[x] += __shfl_xor_sync(0xffffffffu, xn[x], 1);
            xn[x] += __shfl_xor_sync(0xffffffffu, xn[x], 2);
            if (qd == 0) part[(warp & 3) * 32 + (warp >> 2) * 16 + 8 * x + g] = xn[x];
          }
        }
        // every read of dC's slice tiles and of dn[d0:] is done, and every
        // partial sum of dn written
        named_bar_sync(1, THREADS);
        if (up) {  // dC[d0 + 16 um + g (+ 8)][8 un + 2 qd (+ 1)] = e_end dC + u
          float* c = Cs + ((warp & 3) * 8 + 2 * qd) * o.cs + d0 + (warp >> 2) * 16 + g;
          c[0] = __fadd_rn(__fmul_rn(e_end, c[0]), u[0]);
          c[o.cs] = __fadd_rn(__fmul_rn(e_end, c[o.cs]), u[1]);
          c[8] = __fadd_rn(__fmul_rn(e_end, c[8]), u[2]);
          c[o.cs + 8] = __fadd_rn(__fmul_rn(e_end, c[o.cs + 8]), u[3]);
          if (warp == 0) apply_n(ns, part, d0, e_end);
        }
        if (rd && t + 2 < nslices)
          convert_split(Cs, o.cs, d0 + 2 * DT, cb + 2 * (t & 1) * CB, cb + (2 * (t & 1) + 1) * CB);
      }
      if (rd) {  // T's rows of this chunk, fp32
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int l = warp * 32 + mt * 16 + g + 8 * r;
            if (l >= lv) continue;
            float* tr = a.kdc + ((size_t(b) * R + s0 + l) * NH + hd) * dh + col0 + 2 * qd;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              *reinterpret_cast<float2*>(tr + nt * 8) =
                  make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
          }
      }
    }
    named_bar_sync(1, THREADS);
    if (a.dC0) write_state(a.dC0 + cbase, a.dn0 + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
  }
}

template <typename T, int E, int DT>
int launch_simt_at(const Args& a, int B, cudaStream_t stream) {
  const Layout o = layout(a.dh, E, DT, sizeof(T));
  auto kern = mlstm_scan_bwd_kernel<T, E, DT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(o.total));
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.dh / E, a.NH, B), THREADS, o.total, stream>>>(a);
  return cudaGetLastError();
}

// The SIMT route, as the forward's: dh 8 and 16 in both types, multiples of
// 32 in fp32 (bf16 takes the mma route there).
template <typename T>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  if (a.dh == 8) return launch_simt_at<T, 8, 8>(a, B, stream);
  if (a.dh == 16) return launch_simt_at<T, 16, 16>(a, B, stream);
  if constexpr (sizeof(T) == 4) return launch_simt_at<T, 32, 16>(a, B, stream);
  return cudaErrorInvalidValue;
}

int launch_mma(const Args& a, int B, cudaStream_t stream) {
  auto kern = mlstm_scan_bwd_mma_kernel;
  const size_t smem = mma_layout(a.dh).total;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk;
  const long long sl = (long long)a.NH * a.dh, sb = sl * a.S;
  int err = make_map(&tq, a.q, a.dh, a.NH, a.S, B, sb, sl, a.dh, ROWS, MMA_DT,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = make_map(&tk, a.k, a.dh, a.NH, a.S, B, sb, sl, a.dh, ROWS, MMA_DT,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return cudaErrorInvalidValue;
  kern<<<dim3(a.dh / MMA_COLS, a.NH, B), BLOCK, smem, stream>>>(tq, tk, a);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, S, NH, dh) in bf16 (bf16 = 1) or fp32; g (B, S, NH, dh), u and cl
// (B, S, NH) fp32; dCn, dnn (null: zeros) fp32; dCs, dns fp32 (B, nc - 1, NH,
// dh, dh) and (B, nc - 1, NH, dh), nc = ceil(S / min(S, 256)): the cotangents
// of C and n between chunks, as they leave chunks 0 .. nc - 2; dC0, dn0
// (null: not asked, chunk 0's update not run) fp32, both or neither; kdc
// fp32 (B, R, NH, dh), R = min((nc - 1 + (dCn given)) min(S, 256), S): T_j =
// k_j dC_j on the rows of the chunks read. dh is 8, 16 or a multiple of 32 (in
// bf16 at most 1024). Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int repro_mlstm_scan_bwd(const void* q, const void* k, const void* g, const void* u,
                                    const void* cl, const void* dCn, const void* dnn, void* dCs,
                                    void* dns, void* dC0, void* dn0, void* kdc, int B, int S,
                                    int NH, int dh, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || (dh != 8 && dh != 16 && (dh <= 0 || dh % 32)) ||
      (!dC0 != !dn0))
    return cudaErrorInvalidValue;
  const Args a{q,
               k,
               static_cast<const float*>(g),
               static_cast<const float*>(u),
               static_cast<const float*>(cl),
               static_cast<const float*>(dCn),
               static_cast<const float*>(dnn),
               static_cast<float*>(dCs),
               static_cast<float*>(dns),
               static_cast<float*>(dC0),
               static_cast<float*>(dn0),
               static_cast<float*>(kdc),
               S,
               NH,
               dh};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && dh % 32 == 0) return launch_mma(a, B, s);
  return bf16 ? launch_simt<__nv_bfloat16>(a, B, s) : launch_simt<float>(a, B, s);
}
