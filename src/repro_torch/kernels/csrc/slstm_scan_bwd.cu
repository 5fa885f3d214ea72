// The sLSTM recurrence's backward for Hopper (sm_90a), bound to Python with
// ctypes; the forward, whose grid and exchange it shares (slstm.cuh), is
// slstm_scan.cu.
//
// Replaces no Pallas kernel: the reference differentiates its scan in
// XLA. From dh_S and dc_S (the cotangents of the last state, or zeros) and
// dy (B, S, D), for t = S-1 .. 0:
//   dh_t  = dy_t + dh_rec_t                          fp32
//   dc_t  = dc_{t+1} sig(f_{t+1}) + dh_t sig(o_t) (1 - tanh^2 c_t)
//   di, df, dz, do = dc_t tanh(z) si(1-si), dc_t c_{t-1} sf(1-sf),
//                    dc_t si (1-tz^2), dh_t tanh(c_t) so(1-so)
//   dg_t  = (di, df, dz, do), rounded to the activations' type = dgx_t
//   dh_rec_{t-1}[b, hd dh + d] = sum_e dg_t[b, hd 4dh + e] r[hd, d, e]
// with the gate activations recomputed from g_t as the forward rounded
// them, and returns dh0 (the last product, rounded once; only when asked)
// and dc0. The product is the forward's turned round: block j owns the
// same channels, keeps r_gates' rows of its channels (4dh values each, as
// 4 columns of dh: 64 KB in bf16 at xlstm-1.3b's shapes) in shared memory
// and dc in registers, and each step
//   1. runs the cell's backward for its pairs (dh_rec_t from the step
//      before, dh_S first), writes dgx_t and publishes its 4 x CPB values of
//      dg_t as tagged words, as the forward publishes h;
//   2. gathers dg_t of the heads its channels lie in: the flat range
//      [hd 4dh, (hd + 1) 4dh), B x 4dh values (with nh = 4 the gate is the
//      head, so B x D, the forward's reads), while the next step's g, c and
//      dy loads are in flight;
//   3. runs the 4 x CPB columns' products with the forward's code (each
//      column a quarter of a channel's 4dh terms), and sums the quarters in
//      a fixed order in fp32, unrounded.
// A block reads words of every block only where a head's range is at least
// D long (nh <= 4): then a block that publishes step k has read every
// block's step k-1, so the two buffers are safe as in the forward. The
// wrapper refuses nh > 4. dr_gates (sum over b, t of h_{t-1} x dg_t per
// head) is one large product outside the kernel (torch.einsum), as the
// reference leaves it to XLA. The bound is the forward's plus dy read, g
// and c read and dgx written; the time is again the step's latency.
#include "slstm.cuh"

namespace {

// The most heads that one block's channels lie in.
__host__ __device__ inline int heads_spanned(int D, int dh, int cpb) {
  int most = 0;
  for (int j0 = 0; j0 < D; j0 += cpb) {
    const int last = (j0 + cpb < D ? j0 + cpb : D) - 1;
    const int n = last / dh - j0 / dh + 1;
    most = n > most ? n : most;
  }
  return most;
}

// Shared memory of one backward block: its rows of r_gates, dg_t of its
// heads, the products and its own dg_t (kernels/slstm.py `smem_bytes_bwd`).
__host__ __device__ inline size_t smem_bytes_bwd(int elem, int B, int D, int dh, int cpb) {
  return align16(size_t(elem) * 4 * cpb * dh) +
         align16(size_t(elem) * B * heads_spanned(D, dh, cpb) * 4 * dh) +
         align16(sizeof(float) * 4 * cpb * B) + align16(size_t(elem) * B * 4 * cpb);
}

// The backward (see the note at the top). Pair p = threadIdx.x + i * THREADS
// is (row p / cpb, channel j0 + p % cpb), as in the forward.
template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_scan_bwd_kernel(const T* __restrict__ gsave, const float* __restrict__ csave,
                          const float* __restrict__ c0, const T* __restrict__ r,
                          const T* __restrict__ dy, const T* dh_n, const float* dc_n,
                          T* __restrict__ dgx, T* dh0, float* __restrict__ dc0,
                          unsigned long long* xch, int B, int S, int D, int nh, int cpb) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = D / nh, e4 = 4 * dh, ncol = 4 * cpb;
  const int j0 = blockIdx.x * cpb;
  const int nch = min(cpb, D - j0);
  // the heads this block's channels lie in, and their flat range of dg
  const int h_lo = j0 / dh, nspan = (j0 + nch - 1) / dh - h_lo + 1;
  const int span = nspan * e4, span_max = heads_spanned(D, dh, cpb) * e4;
  // dg in 4-byte words: a row of 4D values is `words` words; a block's
  // channels of one gate `bwords` of them (`nbw` published)
  const int elem = int(sizeof(T));
  const int words = 4 * D * elem / 4, bwords = cpb * elem / 4, nbw = nch * elem / 4;
  T* rs = reinterpret_cast<T*>(smem);
  size_t off = align16(sizeof(T) * ncol * dh);
  T* dgs = reinterpret_cast<T*>(smem + off);
  off += align16(sizeof(T) * B * span_max);
  float* gr = reinterpret_cast<float*>(smem + off);
  off += align16(sizeof(float) * ncol * B);
  T* dgnew = reinterpret_cast<T*>(smem + off);   // [b][gate][channel]

  // this block's rows of r_gates as 4 columns each: column c = (quarter q =
  // c / cpb, channel j = j0 + c % cpb) holds r[j / dh, j % dh, q dh + k], k <
  // dh (r's row j, 4dh values, is contiguous)
  for (int i = threadIdx.x; i < ncol * dh; i += THREADS) {
    const int c = i / dh, k = i % dh, jj = c % cpb;
    rs[i] = jj < nch ? r[size_t(j0 + jj) * e4 + (c / cpb) * dh + k] : N::from_f(0.0f);
  }
  // column c reads quarter q of its head's dg_t
  auto dg_of = [&](int c) {
    return dgs + ((j0 + c % cpb) / dh - h_lo) * e4 + (c / cpb) * dh;
  };
  const int npairs = B * cpb;
  float dcreg[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    const bool on = p < npairs && jj < nch;
    dcreg[i] = on && dc_n ? dc_n[size_t(b) * D + j0 + jj] : 0.0f;
  }
  // dh_rec of the last step: dh_S in quarter 0 of the products
  for (int i = threadIdx.x; i < ncol * B; i += THREADS) {
    const int c = i / B, b = i % B, jj = c % cpb;
    gr[i] = c < cpb && jj < nch && dh_n ? N::to_f(dh_n[size_t(b) * D + j0 + jj]) : 0.0f;
  }
  // this thread's loads of step t: g_t, c_t, c_{t-1}, dy_t
  float gv[MAX_PAIRS][4], cv[MAX_PAIRS], cpv[MAX_PAIRS], dyv[MAX_PAIRS];
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
      const bool on = p < npairs && jj < nch;
      const size_t bt = size_t(b) * S + t, j = j0 + jj;
      const T* g = gsave + bt * 4 * D + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[i][q] = on ? N::to_f(g[size_t(q) * D]) : 0.0f;
      cv[i] = on ? csave[bt * D + j] : 0.0f;
      cpv[i] = !on ? 0.0f : t > 0 ? csave[(bt - 1) * D + j] : c0 ? c0[size_t(b) * D + j] : 0.0f;
      dyv[i] = on ? N::to_f(dy[bt * D + j]) : 0.0f;
    }
  };
  load_step(S - 1);
  __syncthreads();

  for (int t = S - 1, it = 0; t >= 0; --t, ++it) {
    // 1. the cell's backward at step t
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
      if (p < npairs && jj < nch) {
        const float dhr = __fadd_rn(__fadd_rn(__fadd_rn(gr[jj * B + b], gr[(cpb + jj) * B + b]),
                                              gr[(2 * cpb + jj) * B + b]),
                                    gr[(3 * cpb + jj) * B + b]);
        const float si = N::round(sigmoid(gv[i][0])), sf = N::round(sigmoid(gv[i][1]));
        const float tz = N::round(tanhf(gv[i][2])), so = N::round(sigmoid(gv[i][3]));
        const float tc = tanhf(cv[i]);
        const float dh = __fadd_rn(dyv[i], dhr);
        const float dc = __fadd_rn(dcreg[i], __fmul_rn(__fmul_rn(dh, so),
                                                       __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        float d[4];
        d[0] = __fmul_rn(__fmul_rn(dc, tz), __fmul_rn(si, __fsub_rn(1.0f, si)));
        d[1] = __fmul_rn(__fmul_rn(dc, cpv[i]), __fmul_rn(sf, __fsub_rn(1.0f, sf)));
        d[2] = __fmul_rn(__fmul_rn(dc, si), __fsub_rn(1.0f, __fmul_rn(tz, tz)));
        d[3] = __fmul_rn(__fmul_rn(dh, tc), __fmul_rn(so, __fsub_rn(1.0f, so)));
        dcreg[i] = __fmul_rn(dc, sf);
        T* o = dgx + (size_t(b) * S + t) * 4 * D + j0 + jj;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T v = N::from_f(d[q]);
          o[size_t(q) * D] = v;
          dgnew[(b * 4 + q) * cpb + jj] = v;
        }
      }
    }
    if (t == 0 && !dh0) break;   // dh0 not asked for: no last product
    __syncthreads();
    // 2. publish dg_t as words tagged it + 1, then gather the heads' range
    // of it while the next step's loads are in flight
    publish_words(reinterpret_cast<const unsigned int*>(dgnew), bwords,
                  xch + size_t(it & 1) * B * words + j0 * elem / 4, D * elem / 4, B * 4, nbw,
                  static_cast<unsigned int>(it + 1));
    if (t > 0) load_step(t - 1);
    gather_words<false>(xch + size_t(it & 1) * B * words + size_t(h_lo) * e4 * elem / 4, words,
                        B, span * elem / 4, static_cast<unsigned int>(it + 1),
                        reinterpret_cast<unsigned int*>(dgs));
    __syncthreads();
    // 3. dh_rec_{t-1} in quarters
    products<T, ROWS, false>(rs, dg_of, span, ncol, cpb, nch, dh, B, gr);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    if (p < npairs && jj < nch) {
      dc0[size_t(b) * D + j0 + jj] = dcreg[i];
      if (dh0)
        dh0[size_t(b) * D + j0 + jj] = N::from_f(
            __fadd_rn(__fadd_rn(__fadd_rn(gr[jj * B + b], gr[(cpb + jj) * B + b]),
                                gr[(2 * cpb + jj) * B + b]),
                      gr[(3 * cpb + jj) * B + b]));
    }
  }
}

template <typename T, int ROWS>
int launch_bwd(const void* gsave, const void* csave, const void* c0, const void* r,
               const void* dy, const void* dh_n, const void* dc_n, void* dgx, void* dh0,
               void* dc0, void* xch, int B, int S, int D, int nh, int cpb, cudaStream_t stream) {
  const T* gs_ = static_cast<const T*>(gsave);
  const float* cs_ = static_cast<const float*>(csave);
  const float* c0_ = static_cast<const float*>(c0);
  const T* r_ = static_cast<const T*>(r);
  const T* dy_ = static_cast<const T*>(dy);
  const T* dhn_ = static_cast<const T*>(dh_n);
  const float* dcn_ = static_cast<const float*>(dc_n);
  T* dgx_ = static_cast<T*>(dgx);
  T* dh0_ = static_cast<T*>(dh0);
  float* dc0_ = static_cast<float*>(dc0);
  unsigned long long* xch_ = static_cast<unsigned long long*>(xch);
  void* args[] = {&gs_,  &cs_,  &c0_, &r_, &dy_, &dhn_, &dcn_, &dgx_, &dh0_,
                  &dc0_, &xch_, &B,   &S,  &D,   &nh,   &cpb};
  return launch_coop(slstm_scan_bwd_kernel<T, ROWS>, args,
                     smem_bytes_bwd(sizeof(T), B, D, D / nh, cpb), D, cpb, xch,
                     2 * size_t(B) * 4 * D * sizeof(T) / 4 * sizeof(unsigned long long), stream);
}

}  // namespace

// The backward: gsave (B, S, 4D) and csave (B, S, D) fp32 from the saving
// forward, c0 (B, D) fp32 or null, r_gates, dy (B, S, D), dh_n (B, D) or
// null and dc_n (B, D) fp32 or null (the last state's cotangents) -> dgx
// (B, S, 4D), dh0 (B, D) (null: not computed) and dc0 (B, D) fp32; T is bf16
// (bf16 != 0) or fp32 as in the forward. xch scratch of 2 x B x 4D x elem /
// 4 words of 8 bytes. The forward's conditions, and nh <= 4.
extern "C" int repro_slstm_scan_bwd(const void* gsave, const void* csave, const void* c0,
                                    const void* r, const void* dy, const void* dh_n,
                                    const void* dc_n, void* dgx, void* dh0, void* dc0,
                                    void* xch, int B, int S, int D, int nh, int cpb, int bf16,
                                    void* stream) {
  if (bad_shape(B, S, D, nh, cpb) || nh > 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = B % 4 == 0 ? 4 : B % 2 == 0 ? 2 : 1;
#define SLSTM_BWD(T, R) \
  launch_bwd<T, R>(gsave, csave, c0, r, dy, dh_n, dc_n, dgx, dh0, dc0, xch, B, S, D, nh, cpb, s)
  if (bf16)
    return rows == 4   ? SLSTM_BWD(__nv_bfloat16, 4)
           : rows == 2 ? SLSTM_BWD(__nv_bfloat16, 2)
                       : SLSTM_BWD(__nv_bfloat16, 1);
  return rows == 4 ? SLSTM_BWD(float, 4) : rows == 2 ? SLSTM_BWD(float, 2) : SLSTM_BWD(float, 1);
#undef SLSTM_BWD
}
