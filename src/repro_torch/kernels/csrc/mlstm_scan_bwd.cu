// mLSTM chunk recurrence's backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces no Pallas kernel: the reference differentiates its jax.lax.scan
// over chunks (src/repro/models/xlstm.py:108, body `_mlstm_chunk_scan` at
// :80-106), which XLA transposes into a loop over the chunks in reverse on
// the device. This kernel is that loop's carried part: the cotangents of
// C and n, carried from the last chunk to the first. From dC_n and dn_n
// (the cotangents of the last C and n) or from zeros, for chunk j = nc - 1
// down to 1, with e_end = exp(cl_end) of chunk j and, from torch beforehand
// (kernels/mlstm.py `mlstm_backward`), g_l = exp(cl_l) dh_l / den_l (B, S,
// NH, dh) and u_l = ds_l exp(cl_l) (B, S, NH) fp32, the read's cotangents:
//   dC_{j-1} = e_end dC_j + q_j^T g_j        (dh x dh, fp32)
//   dn_{j-1} = e_end dn_j + q_j^T u_j
//   written: the cotangents of the state between chunks j - 1 and j
// and chunk 0's update too only where dC0, dn0 are asked (then written).
// The last state's cotangents are the caller's dC_n, dn_n, and chunk 0's
// update yields only dC0: training asks for neither, so it runs nc - 1
// updates and writes nc - 1 states. Everything else of the backward is
// carry-free once these and the states between chunks are known, and
// stays in torch.
//
// Bound on this card. The carried products are 2 L dh^2 + 2 L dh FLOPs a
// chunk run and head; the bytes are q and g of the chunks run read once
// and the dC_{j-1} written (dh^2 fp32 a state and head). At xlstm-1.3b's
// training shape (4, 1024, 4, 1024) in bf16, 3 of 4 chunks run: 25.8 GFLOP
// (26.1 us at 989 TFLOP/s) against 201 MB written and 76 MB read (83 us at
// 3.35 TB/s): the bytes bound it.
//
// Design: the forward's (csrc/mlstm_scan.cu), run backward over the chunks,
// with its update alone (mlstm.cuh) and q in k's place, g in w v's, u in
// w's. dC's columns are independent (column e of q^T g needs only column e
// of g), so a block owns one (batch row, head, 32 columns of dC), keeps
// dC^T[cols][dh] and its own copy of dn in shared memory from the last chunk
// to the first, writes them out after each chunk's update and needs no exchange
// and no atomics: every call gives the same bits. Per chunk it streams q
// through shared memory in slices of DT head-dim columns, g's 32 columns of
// the chunk's rows staged once. Routes as the forward's: "mma" (bf16 q at
// dh a multiple of 32; g split into bf16 high and low parts, about 16 bits
// of the fp32 g) and "simt" (fp32 at any supported dh, bf16 at dh 8 and 16).
#include "mlstm.cuh"

namespace {

// Byte offsets in a block's shared memory (kernels/mlstm.py `smem_bytes_bwd`
// computes the total).
struct Layout {
  int cs, qs, gs;  // row strides (elements) of dC^T, of staged q, of g
  size_t c, n, q, g, vec, red, total;
};

__host__ __device__ inline Layout layout(int dh, int E, int DT, int elem, bool mma) {
  Layout o;
  o.cs = dh + (mma ? 8 : 4);
  o.qs = DT + (mma ? KPAD : (elem == 2 ? 2 : 1));
  o.gs = mma ? E + KPAD : E;
  size_t off = 0;
  o.c = off;
  off += align16(size_t(4) * E * o.cs);
  o.n = off;
  off += align16(size_t(4) * dh);
  o.q = off;
  off += align16(size_t(elem) * ROWS * o.qs);
  o.g = off;
  off += mma ? 2 * align16(size_t(2) * ROWS * o.gs) : align16(size_t(4) * ROWS * o.gs);
  o.vec = off;
  off += align16(size_t(4) * ROWS);      // u of the chunk's rows
  o.red = off;
  off += align16(size_t(4) * THREADS);   // the dn update's partial sums
  o.total = off;
  return o;
}

struct Args {
  const void* q;                       // (B, S, NH, dh)
  const float *g, *u, *cl;             // (B, S, NH, dh), (B, S, NH), (B, S, NH)
  const float *dCn, *dnn;              // (B, NH, dh, dh), (B, NH, dh) or null
  float *dCs, *dns;                    // (B, nc - 1, NH, dh, dh), (B, nc - 1, NH, dh)
  float *dC0, *dn0;                    // (B, NH, dh, dh), (B, NH, dh) or null
  int S, NH, dh;
};

// One block: batch row blockIdx.z, head blockIdx.y, columns blockIdx.x E ..
// + E - 1 of dC. MMA: the tensor-core route (bf16 q, E = 32, DT = 32).
template <typename T, bool MMA, int E, int DT>
__global__ void __launch_bounds__(THREADS, 1) mlstm_scan_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, NH = a.NH, dh = a.dh;
  const Layout o = layout(dh, E, DT, sizeof(T), MMA);
  float* Cs = reinterpret_cast<float*>(smem + o.c);  // dC^T: Cs[e * cs + d] = dC[d][col0 + e]
  float* ns = reinterpret_cast<float*>(smem + o.n);
  T* qs = reinterpret_cast<T*>(smem + o.q);
  float* u_s = reinterpret_cast<float*>(smem + o.vec);
  float* red = reinterpret_cast<float*>(smem + o.red);
  __nv_bfloat16* ghi = reinterpret_cast<__nv_bfloat16*>(smem + o.g);
  __nv_bfloat16* glo = ghi + align16(size_t(2) * ROWS * o.gs) / 2;
  float* gf = reinterpret_cast<float*>(smem + o.g);
  const T* q = static_cast<const T*>(a.q);

  const int L = S < ROWS ? S : ROWS;
  const int nchunks = (S + L - 1) / L, nslices = dh / DT;
  const int first = a.dC0 ? 0 : 1;  // the first chunk whose update is run
  if (nchunks <= first) return;     // one chunk and no dC0: nothing to carry
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * E, hd = blockIdx.y, b = blockIdx.z;
  const size_t cbase = (size_t(b) * NH + hd) * dh * dh, nbase = (size_t(b) * NH + hd) * dh;
  for (int idx = tid; idx < dh * E; idx += THREADS) {
    const int d = idx / E, e = idx % E;
    Cs[e * o.cs + d] = a.dCn ? a.dCn[cbase + size_t(d) * dh + col0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += THREADS) ns[d] = a.dnn ? a.dnn[nbase + d] : 0.f;

  Stager<T, MMA, DT, 1> st;
  for (int j = nchunks - 1; j >= first; --j) {
    const int s0 = j * L, lv = min(L, S - s0);
    const size_t rowbase = (size_t(b) * S + s0) * NH + hd;  // (b, s0, hd) in (B, S, NH)
    st.fetch(q, nullptr, rowbase, NH, dh, lv, 0);
    __syncthreads();  // the later chunk is done with g, u and the staged slice
    const float e_end = expf(a.cl[rowbase + size_t(lv - 1) * NH]);
    {  // row tid: u and g over the block's columns (zeros past the chunk)
      const int l = tid;
      const size_t ri = rowbase + size_t(l) * NH;
      u_s[l] = l < lv ? a.u[ri] : 0.f;
      stage_b<float, MMA, E>(a.g + ri * dh + col0, 1.f, l < lv, ghi + l * o.gs, glo + l * o.gs,
                             gf + l * o.gs);
    }
    st.stage(qs, nullptr, o.qs);
    __syncthreads();
    for (int t = 0; t < nslices; ++t) {
      const int d0 = t * DT;
      if (t + 1 < nslices) st.fetch(q, nullptr, rowbase, NH, dh, lv, t + 1);
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      x_partial<T, DT>(u_s, qs, o.qs, red);  // dn's
      if constexpr (MMA)
        update_mma(u, qs, o.qs, ghi, glo, o.gs);
      else
        update_simt<T, E, DT>(u, qs, o.qs, gf, o.gs, lv);
      __syncthreads();  // every read of the staged slice and of the partial sums' inputs is done
      apply_update<MMA, E, DT>(Cs, o.cs, ns, red, d0, e_end, u);
      if (t + 1 < nslices) st.stage(qs, nullptr, o.qs);
      __syncthreads();
    }
    if (j > 0) {  // dC_{j-1}, dn_{j-1}: the state between chunks j - 1 and j
      const size_t sb = (size_t(b) * (nchunks - 1) + j - 1) * NH + hd;
      write_state(a.dCs + sb * dh * dh, a.dns + sb * dh, Cs, o.cs, ns, dh, E, col0,
                  blockIdx.x == 0);
    } else {
      write_state(a.dC0 + cbase, a.dn0 + nbase, Cs, o.cs, ns, dh, E, col0, blockIdx.x == 0);
    }
  }
}

template <typename T, bool MMA, int E, int DT>
int launch(const Args& a, int B, cudaStream_t stream) {
  const Layout o = layout(a.dh, E, DT, sizeof(T), MMA);
  auto kern = mlstm_scan_bwd_kernel<T, MMA, E, DT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(o.total));
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.dh / E, a.NH, B), THREADS, o.total, stream>>>(a);
  return cudaGetLastError();
}

// The SIMT route, as the forward's: dh 8 and 16 in both types, multiples of
// 32 in fp32.
template <typename T>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  if (a.dh == 8) return launch<T, false, 8, 8>(a, B, stream);
  if (a.dh == 16) return launch<T, false, 16, 16>(a, B, stream);
  if constexpr (sizeof(T) == 4) return launch<T, false, 32, 16>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, NH, dh) in bf16 (bf16 = 1) or fp32; g (B, S, NH, dh), u and cl
// (B, S, NH) fp32; dCn, dnn (null: zeros) fp32; dCs, dns fp32 (B, nc - 1, NH,
// dh, dh) and (B, nc - 1, NH, dh), nc = ceil(S / min(S, 256)): the cotangents
// of C and n between chunks, as they leave chunks 0 .. nc - 2; dC0, dn0
// (null: not asked, chunk 0's update not run) fp32, both or neither. dh is
// 8, 16 or a multiple of 32. Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int repro_mlstm_scan_bwd(const void* q, const void* g, const void* u, const void* cl,
                                    const void* dCn, const void* dnn, void* dCs, void* dns,
                                    void* dC0, void* dn0, int B, int S, int NH, int dh, int bf16,
                                    void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 || (dh != 8 && dh != 16 && (dh <= 0 || dh % 32)) ||
      (!dC0 != !dn0))
    return cudaErrorInvalidValue;
  const Args a{q,
               static_cast<const float*>(g),
               static_cast<const float*>(u),
               static_cast<const float*>(cl),
               static_cast<const float*>(dCn),
               static_cast<const float*>(dnn),
               static_cast<float*>(dCs),
               static_cast<float*>(dns),
               static_cast<float*>(dC0),
               static_cast<float*>(dn0),
               S,
               NH,
               dh};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && dh % 32 == 0) return launch<__nv_bfloat16, true, MMA_COLS, MMA_DT>(a, B, s);
  return bf16 ? launch_simt<__nv_bfloat16>(a, B, s) : launch_simt<float>(a, B, s);
}
