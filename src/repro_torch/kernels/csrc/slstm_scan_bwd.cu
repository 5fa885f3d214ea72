// The sLSTM recurrence's backward for Hopper (sm_90a), bound to Python with
// ctypes; the forward is slstm_scan.cu, and both include slstm.cuh.
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
// them and with the forward's functions (in bf16 sigmoid from __expf and
// an approximate division, tanh from tanh.approx; in fp32 expf, a rounded
// division and tanhf), and returns dh0 (the
// last product, rounded once; only when asked) and dc0. Head hd's flat
// range of dg, [hd 4dh, (hd + 1) 4dh), is at least D long when nh <= 4 (the
// wrapper refuses more): every channel's dh_rec needs dg_t of every block.
// With xlstm-1.3b's nh = 4 the range is gate hd over all D channels, the
// volume the forward moves for h. dr_gates (sum over b, t of h_{t-1} x
// dg_t per head) is one large product outside the kernel (torch.einsum),
// as the reference leaves it to XLA.
//
// What bounds it. Bytes: g, dy and r_gates read, c read once, dgx and dc0
// written; operations: the product over S - 1 steps, 2 x B x 4D x dh a
// step. In bf16 at (4, 1024, 8192) 0.0576 ms of bytes at 3.35 TB/s against
// 0.035 of operations at 989 TFLOP/s. Each step waits for the one after
// it, so the latency of a step sets the time. tools/slstm_bwd_variants.py
// splits a step by timing the source with parts cut out, in one call with
// the earlier build (H100 80GB HBM3, 700 W): the clusters' route takes 3.37
// µs a step at (4, 1024, 8192) and 2.35 at (1, 8192, 8192), the
// cooperative grid 8.62 and 5.01; without the exchange 1.99 and 1.37,
// without the products 2.59 and 1.66, without the loads 3.17 and 2.17.
// Each block's thread 0 spends (clock64 cycles a step at batch 4) 1,035
// in the cell, 913 in the barrier and sends after it, 3,584 taking dg
// (relays and the mbarrier) and 860 in the products and their barrier.
//
// Two routes, chosen by kernels/slstm.py `plan_bwd` and named by the
// cluster argument:
//
// Clusters (bf16; PR 32's forward turned round). One grid whose blocks are
// all resident at once, in thread-block clusters, launched with the
// cluster dimension and the cooperative attribute together (a grid the
// card cannot hold fails with cudaErrorCooperativeLaunchTooLarge, 720). At
// xlstm-1.3b's shapes 64 blocks of 32 channels in 4 clusters of 16: a
// cluster is a head. Block j owns cpb channels, keeps their dc and c_t in
// registers (a thread a (row, channel) pair), and its rows of r_gates as
// mma.sync m16n8k16 A fragments in registers for the whole run (M = its
// channels, two m-tiles; K = the head's 4dh terms; N = the B rows padded to
// 8): warp w takes m-tile w / KP and k part w % KP of KP = 8, 16 k-steps
// of 16 terms (64 registers). Each step a block
//   1. runs the cell's backward for its pairs: dh_rec_t is the KP partial
//      sums of the products, added in a fixed tree (dh_S at the first
//      step); g_t, dy_t and c_{t-1} come from a ring of NST = 8
//      shared-memory stages that warp 4 refills NST steps ahead by
//      cp.async.bulk on the stages' mbarriers (c_t is the step before's
//      c_{t-1}, kept in a register); it writes dgx_t and its 4 x cpb x B
//      values of dg_t;
//   2. after a __syncthreads, sends dg_t: each 16-byte chunk (a row, a gate,
//      8 channels) to every block of its cluster whose heads it lies in by
//      st.async (warp k to block k), completing on that block's mbarrier;
//      and, where a block of another cluster needs it, as words tagged
//      it + 1 (it = S - 1 - t) to L2;
//   3. takes dg_t of its heads into its shared memory (rows padded by HPAD
//      bytes, so the B fragments' 8-byte loads are conflict-free): each
//      chunk of another cluster is polled by one half-warp of one block of
//      the cluster (the block of the source's rank), whose lane l sends it
//      to rank l. One warp waits on the mbarrier, which counts B x the
//      heads' 4dh values' bytes; the others at a __syncthreads;
//   4. runs the products: each warp its 16 mma in two chains (no branch
//      where every k-step of the warp runs), and writes its partial sums;
//      __syncthreads.
// A block whose channels span two heads takes both heads' ranges and each
// m-tile reads its own head's. The index arithmetic of the exchange is
// shifts and masks of per-block constants (gate q lies in head q nh / 4),
// no division in the loop. bf16's sums change order from the cooperative
// route's (PR 29's) and are held by chip_smoke.py's gates. Each choice was
// timed against its alternative (tools/slstm_bwd_variants.py; PERF.md
// section 6): 16 k parts of both m-tiles a warp, the precise cell, refilling
// the stages at the top of the step, storing the L2 words from the cell's
// threads and a thread a relayed chunk were each slower or no faster.
//
// Buffers. dg_it goes into buffer it & 1 of the blocks that need it and
// into L2 buffer it & 1, which held dg_{it-2}. A block sends, stores or
// relays dg_it only after its own cell of step it, which followed its wait
// for dg_{it-1} from every block of the grid (every channel needs every
// block's dg, above); each of those blocks had finished its cell of step
// it - 1, so its products of step it - 2 (the last reads of its buffer
// it & 1) and its relays of step it - 2 (the last polls of L2 buffer it &
// 1). So every reader of dg_{it-2}, in shared memory and in L2, is done
// before dg_it is written, and the mbarrier of buffer it & 1 has completed
// dg_{it-2}'s phase before any of dg_it's bytes reach it. A relay adds a
// hop but not an exception: the relaying block too has finished its cell
// of step it. A stage is refilled after the __syncthreads that follows
// the cell that read it; the partial sums are rewritten only after the
// next cell read them, and the new dg after the sends that read it. A
// poll or a barrier that waits 10 s traps (the kernel fails instead of
// hanging).
//
// Cooperative (fp32, and bf16 where the clusters' shared memory does not
// fit: PR 29's design, its bits). One cooperative grid of blocks of 16
// channels; block j keeps r_gates' rows of its channels (4dh values each,
// as 4 columns of dh) in shared memory, and each step
//   1. runs the cell's backward, writes dgx_t and publishes its 4 x cpb
//      values of dg_t as tagged words;
//   2. gathers dg_t of its heads (every block's words of the range) while
//      the next step's g, c and dy loads are in flight;
//   3. runs the 4 x cpb columns' SIMT products (slstm.cuh), each column a
//      quarter of a channel's 4dh terms, and sums the quarters in a fixed
//      order. The buffers are safe by the argument above, without relays.
#include <type_traits>

#include "hopper.cuh"
#include "slstm.cuh"

namespace {

constexpr int NST = 8;            // clusters: stages of g, dy and c: steps fetched ahead
constexpr int HPAD = 32;          // clusters: bytes after each row of dg in shared memory
constexpr int KP = 8;             // clusters: k parts of the products (partial sums an output)
constexpr int MAX_MT = 2;         // clusters: m-tiles of 16 channels a block (cpb <= 32)
constexpr int MPW = MAX_MT * KP / WARPS;   // m-tiles a warp
constexpr int MAX_KPW = 128 / KP;          // k-steps of 16 a warp (4dh <= 2048)
constexpr int GS = MAX_MT * 16 + 4;        // floats a row of partial sums (conflict-free)
constexpr int CPAIRS = 2;         // clusters: (row, channel) pairs a thread keeps dc and c for
// the warp that fetches the stages, after its sends: neither a cell's (the
// first four) nor a relay's (the last eight) at xlstm-1.3b's shapes
constexpr int FETCH_WARP = WARPS / 4;

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

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The cell's backward at one (row, channel) pair: g4 the step's gates, c
// its c_t, cp c_{t-1}, dy and dhr the two parts of dh_t, dc dc_{t+1}
// sig(f_{t+1}) in and dc_t sig(f_t) out; d the four gates' cotangents.
// Products and sums round apart, as PyTorch's separate kernels do. FAST:
// the activations as the bf16 forward takes them (sigmoid from __expf and
// an approximate division, tanh from tanh.approx), else expf, a rounded
// division and tanhf.
template <typename T, bool FAST>
__device__ __forceinline__ void bwd_cell(const float (&g4)[4], float c, float cp, float dy,
                                         float dhr, float& dc, float (&d)[4]) {
  using N = Num<T>;
  auto sig = [](float x) { return FAST ? __fdividef(1.0f, 1.0f + __expf(-x)) : sigmoid(x); };
  auto tnh = [](float x) { return FAST ? tanh_approx(x) : tanhf(x); };
  const float si = N::round(sig(g4[0])), sf = N::round(sig(g4[1]));
  const float tz = N::round(tnh(g4[2])), so = N::round(sig(g4[3]));
  const float tc = tnh(c);
  const float dh = __fadd_rn(dy, dhr);
  const float dct =
      __fadd_rn(dc, __fmul_rn(__fmul_rn(dh, so), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
  d[0] = __fmul_rn(__fmul_rn(dct, tz), __fmul_rn(si, __fsub_rn(1.0f, si)));
  d[1] = __fmul_rn(__fmul_rn(dct, cp), __fmul_rn(sf, __fsub_rn(1.0f, sf)));
  d[2] = __fmul_rn(__fmul_rn(dct, si), __fsub_rn(1.0f, __fmul_rn(tz, tz)));
  d[3] = __fmul_rn(__fmul_rn(dh, tc), __fmul_rn(so, __fsub_rn(1.0f, so)));
  dc = __fmul_rn(dct, sf);
}

// Shared memory of one block of the cooperative route: its rows of
// r_gates, dg_t of its heads, the products and its own dg_t
// (kernels/slstm.py `smem_bytes_bwd_coop`).
__host__ __device__ inline size_t smem_bytes_coop(int elem, int B, int D, int dh, int cpb) {
  return align16(size_t(elem) * 4 * cpb * dh) +
         align16(size_t(elem) * B * heads_spanned(D, dh, cpb) * 4 * dh) +
         align16(sizeof(float) * 4 * cpb * B) + align16(size_t(elem) * B * 4 * cpb);
}

// The cooperative route (see the note at the top). Pair p = threadIdx.x +
// i * THREADS is (row p / cpb, channel j0 + p % cpb), as in the forward.
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
        float d[4];
        bwd_cell<T, false>(gv[i], cv[i], cpv[i], dyv[i], dhr, dcreg[i], d);
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
                     smem_bytes_coop(sizeof(T), B, D, D / nh, cpb), D, cpb, xch,
                     2 * size_t(B) * 4 * D * sizeof(T) / 4 * sizeof(unsigned long long), stream);
}


// Byte offsets in a block of the clusters' route (kernels/slstm.py
// `smem_bytes_bwd` computes the total): the barriers (two for dg, one a
// stage); where each block of the cluster keeps a row of dg (its first
// head's first flat value, a cluster's 16 ints); two buffers of dg, B rows
// of the block's heads' range (`hrow` values with HPAD bytes); the KP
// partial sums of each output (for B rounded up to 8, rows of GS floats);
// its new dg (4 gates x B rows x cpb values); NST stages, each g (4 gates x
// B rows x cpb values), dy (B x cpb) and c_{t-1} (B x cpb fp32) at offsets
// `sdy` and `sc`.
struct BwdLayout {
  uint32_t hb, dgs, gr, dgnew, st, sdy, sc, stage, total;
  int hrow;
  __host__ __device__ BwdLayout(int B, int D, int dh, int cpb) {
    constexpr int elem = 2;
    hrow = heads_spanned(D, dh, cpb) * 4 * dh + HPAD / elem;
    hb = align16(8 * (2 + NST));
    dgs = hb + 4 * 16;
    gr = dgs + 2 * B * hrow * elem;
    dgnew = gr + align16(sizeof(float) * KP * ((B + 7) / 8 * 8) * GS);
    st = dgnew + align16(elem * B * 4 * cpb);
    sdy = align16(elem * 4 * B * cpb);
    sc = sdy + align16(elem * B * cpb);
    stage = sc + align16(sizeof(float) * B * cpb);
    total = st + NST * stage;
  }
};

// The clusters' route (see the note at the top): bf16, nh dividing 4 (gate
// q lies in head q nh / 4), cpb 16 or 32 and cluster sizes powers of two.
// Pair p = threadIdx.x + i * THREADS is (row p / cpb, channel j0 + p % cpb).
__global__ void __launch_bounds__(THREADS, 1)
    slstm_scan_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ gsave,
                                  const float* __restrict__ csave, const float* __restrict__ c0,
                                  const __nv_bfloat16* __restrict__ r,
                                  const __nv_bfloat16* __restrict__ dy,
                                  const __nv_bfloat16* dh_n, const float* dc_n,
                                  __nv_bfloat16* __restrict__ dgx, __nv_bfloat16* dh0,
                                  float* __restrict__ dc0, unsigned long long* xch, int B,
                                  int S, int D, int nh, int cpb) {
  using T = __nv_bfloat16;
  using N = Num<T>;
  constexpr int elem = 2, VW = 8;   // bytes a value, values in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = D / nh, e4 = 4 * dh;
  const BwdLayout L(B, D, dh, cpb);
  const int lcpb = __ffs(cpb) - 1;
  const int j0 = blockIdx.x * cpb;
  const int nch = max(0, min(cpb, D - j0));   // 0 in a block that pads the last cluster
  const int nblk = (D + cpb - 1) >> lcpb;     // blocks with channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hbase = reinterpret_cast<int*>(smem + L.hb);
  T* dgs = reinterpret_cast<T*>(smem + L.dgs);
  float* gr = reinterpret_cast<float*>(smem + L.gr);
  T* dgnew = reinterpret_cast<T*>(smem + L.dgnew);   // [row][gate][channel]
  unsigned char* stages = smem + L.st;
  const uint32_t bars = smem_u32(smem), dgs_at = smem_u32(dgs);
  auto dbar = [&](int p) { return bars + 8u * p; };
  auto gbar = [&](int s) { return bars + 8u * (2 + s); };
  // dg in shared memory: rows of `hrow` values (`rowb` bytes), value 0 of
  // block k's row the flat value hbase[k's rank]; in L2 rows of `words`
  // 4-byte words (4D values); both moved in 16-byte chunks of VW values
  const int rowb = L.hrow * elem, words = 4 * D * elem / 4;
  const int h_lo = j0 / dh, nspan = nch > 0 ? (j0 + nch - 1) / dh - h_lo + 1 : 0;
  const uint32_t dg_bytes = uint32_t(B) * nspan * e4 * elem;   // what the mbarrier counts
  const int cs = cluster_size(), rank = int(cluster_rank()), cl = blockIdx.x / cs;
  const int k_first = cl * cs, k_last = min(k_first + cs, nblk) - 1;   // the cluster's blocks
  const int nclusters = (nblk + cs - 1) / cs;
  const int lb = 32 - __clz(max(B - 1, 1));   // bits of a row index
  // gate q lies in head q nh / 4: the ranks lo .. hi of this cluster's
  // blocks with channels in that head (a byte a gate in `ranges`, lo in its
  // low 4 bits; lo > hi: none), and whether a block of another cluster has
  // (bit q of `outside`)
  uint32_t ranges = 0, outside = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int hc = q * nh / 4;
    const int first = (hc * dh) >> lcpb, last = ((hc + 1) * dh - 1) >> lcpb;
    const bool none = last < k_first || first > k_last;
    const int lo = none ? 15 : max(first, k_first) - k_first;
    const int hi = none ? 0 : min(last, k_last) - k_first;
    ranges |= uint32_t(lo | hi << 4) << (8 * q);
    if (first < k_first || last > k_last) outside |= 1u << q;
  }
  auto lo_of = [&](int q) { return int(ranges >> (8 * q)) & 15; };
  auto hi_of = [&](int q) { return int(ranges >> (8 * q + 4)) & 15; };
  // the gates this cluster needs from the others (bit q of `needq`, nq of
  // them) and the (source cluster, gate) pairs this block relays
  uint32_t needq = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) needq |= uint32_t(lo_of(q) <= hi_of(q)) << q;
  const int nq = __popc(needq), npair = (nclusters - 1) * nq;
  // 16 bytes of dg_it (row b, flat values f .. f + VW - 1) into buffer p of
  // the cluster's block of rank k
  auto send = [&](int p, int b, int f, uint4 d, int k) {
    const uint32_t at = dgs_at + uint32_t((p * B + b) * rowb + (f - hbase[k]) * elem);
    st_async16(mapa(at, k), d, mapa(dbar(p), k));
  };
  // the products: warp w takes k part kp = w % KP of the head's 4dh terms
  // (k-steps [kb, kb + kn) of 16) for the m-tiles mg MPW .. mg MPW + MPW - 1,
  // mg = w / KP; the lane's place in the fragments (g: a row of A and C, a
  // column of B)
  const int kp = warp % KP, mg = warp / KP, g = lane / 4, t4 = lane % 4;
  const int mt = cpb / 16, nks = e4 / 16, kpw = (nks + KP - 1) / KP;
  const int kb = kp * kpw, kn = max(0, min(kpw, nks - kb));

  if (threadIdx.x == 0) {
    mbar_init(dbar(0), 1);
    mbar_init(dbar(1), 1);
    for (int s = 0; s < NST; ++s) mbar_init(gbar(s), 1);
    fence_mbar_init();
  }
  if (threadIdx.x < cs)
    hbase[threadIdx.x] = k_first + int(threadIdx.x) <= k_last
                             ? (k_first + int(threadIdx.x)) * cpb / dh * e4
                             : 0;
  // the A fragments of this warp's products in registers for the whole
  // run: m-tile m holds channels j0 + m 16 + row, k-step x the terms (kb +
  // x) 16 + 0..15 of r's row (contiguous); the lane's two k pairs of a
  // fragment are the terms 4 t4 .. 4 t4 + 3 (B's fragments take the same
  // terms, so one 8-byte load gives each)
  uint32_t af[MPW * MAX_KPW][4];
#pragma unroll
  for (int mm = 0; mm < MPW; ++mm)
#pragma unroll
    for (int x = 0; x < MAX_KPW; ++x)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int m = mg * MPW + mm, jj = m * 16 + g + 8 * hi;
        uint2 v = {0u, 0u};
        if (m < mt && x < kn && jj < nch)
          v = *reinterpret_cast<const uint2*>(r + size_t(j0 + jj) * e4 + (kb + x) * 16 + 4 * t4);
        af[mm * MAX_KPW + x][hi] = v.x;
        af[mm * MAX_KPW + x][2 + hi] = v.y;
      }
  // each m-tile's head: its offset in a row of dg; `full`: every k-step
  // and m-tile of the warp's runs and its m-tiles share a head (one load
  // of B fragments serves both), so its products take no branch
  int hoff[MPW];
#pragma unroll
  for (int mm = 0; mm < MPW; ++mm) {
    const int m = mg * MPW + mm;
    hoff[mm] = m < mt ? ((j0 + m * 16) / dh - h_lo) * e4 : 0;
  }
  const bool full = kn == MAX_KPW && (mg + 1) * MPW <= mt && hoff[0] == hoff[MPW - 1];
  // dh_rec of the last step: dh_S in partial sum 0, zeros in the others
  const int bp = (B + 7) / 8 * 8;
  for (int i = threadIdx.x; i < KP * bp * GS; i += THREADS) {
    const int col = i % GS, b = i / GS % bp, part = i / (GS * bp);
    gr[i] = part == 0 && b < B && col < nch && dh_n ? N::to_f(dh_n[size_t(b) * D + j0 + col])
                                                     : 0.0f;
  }
  // dc and c_t of this thread's pairs, c_t from c_{S-1}
  float dcreg[CPAIRS], cnow[CPAIRS];
#pragma unroll
  for (int i = 0; i < CPAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    const bool on = p < B * cpb && jj < nch;
    dcreg[i] = on && dc_n ? dc_n[size_t(b) * D + j0 + jj] : 0.0f;
    cnow[i] = on ? csave[(size_t(b) * S + S - 1) * D + j0 + jj] : 0.0f;
  }
  // dh_rec of (row b, channel jj): the KP partial sums in a fixed tree
  auto dh_rec = [&](int b, int jj) {
    float v[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) v[k] = gr[(k * bp + b) * GS + jj];
#pragma unroll
    for (int w = 1; w < KP; w *= 2)
#pragma unroll
      for (int k = 0; k + w < KP; k += 2 * w) v[k] = __fadd_rn(v[k], v[k + w]);
    return v[0];
  };
  // every block of the cluster is running and its barriers initialised
  // before any block sends to it
  cluster_sync();

  // FETCH_WARP fetches step t = S - 1 - it's g, dy and c_{t-1} (c0 or
  // nothing at t = 0) into stage it % NST
  auto fetch = [&](int it) {
    const int s = it % NST, t = S - 1 - it;
    unsigned char* st = stages + s * L.stage;
    const bool cp = t > 0 || c0;
    if (lane == 0) mbar_expect_tx(gbar(s), 5 * B * nch * elem + (cp ? B * nch * 4 : 0));
    __syncwarp();
    for (int b = lane; b < B; b += 32) {
      const size_t bt = size_t(b) * S + t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bulk_load(smem_u32(st + (q * B + b) * cpb * elem), gsave + bt * 4 * D + size_t(q) * D + j0,
                  nch * elem, gbar(s));
      bulk_load(smem_u32(st + L.sdy + b * cpb * elem), dy + bt * D + j0, nch * elem, gbar(s));
      if (cp)
        bulk_load(smem_u32(st + L.sc + b * cpb * 4),
                  t > 0 ? csave + (bt - 1) * D + j0 : c0 + size_t(b) * D + j0, nch * 4, gbar(s));
    }
  };
  if (warp == FETCH_WARP && nch > 0)
    for (int it = 0; it < min(S, NST); ++it) fetch(it);

  for (int it = 0; it < S; ++it) {
    const int t = S - 1 - it, p = it & 1, s = it % NST;
    // 1. the cell's backward at step t
    if (threadIdx.x < B * cpb && nch > 0) mbar_wait(gbar(s), (it / NST) & 1);
    const unsigned char* st = stages + s * L.stage;
    const T* gst = reinterpret_cast<const T*>(st);
    const T* dyst = reinterpret_cast<const T*>(st + L.sdy);
    const float* cst = reinterpret_cast<const float*>(st + L.sc);
#pragma unroll
    for (int i = 0; i < CPAIRS; ++i) {
      const int pp = threadIdx.x + i * THREADS, b = pp / cpb, jj = pp % cpb;
      if (pp < B * cpb && jj < nch) {
        float g4[4], d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) g4[q] = N::to_f(gst[(q * B + b) * cpb + jj]);
        const float cp = t > 0 || c0 ? cst[b * cpb + jj] : 0.0f;
        bwd_cell<T, true>(g4, cnow[i], cp, N::to_f(dyst[b * cpb + jj]), dh_rec(b, jj), dcreg[i],
                          d);
        cnow[i] = cp;
        T* o = dgx + (size_t(b) * S + t) * 4 * D + j0 + jj;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T v = N::from_f(d[q]);
          o[size_t(q) * D] = v;
          dgnew[(b * 4 + q) * cpb + jj] = v;
        }
      }
    }
    if (t == 0 && !dh0) break;   // no dh0 asked for: no last exchange or product
    __syncthreads();
    // 2. dg_t: as words tagged it + 1 to L2 where a block of another
    // cluster needs them (thread x the word x & 15 of gate (x >> 4) & 3 of
    // row x >> 6), and each chunk to the blocks of the cluster with
    // channels in its head, warp k to rank k (lane: row lane >> 2, chunk
    // lane & 3)
    if (nch > 0) {
      if (outside) {
        const unsigned long long tag = static_cast<unsigned long long>(it + 1) << 32;
        for (int x = threadIdx.x; x >> 6 < B; x += THREADS) {
          const int w = x & 15, q = x >> 4 & 3, b = x >> 6;
          if (2 * w < nch && (outside >> q & 1))
            store_word(xch + (size_t(p) * B + b) * words + (q * D + j0) / 2 + w,
                       tag | reinterpret_cast<const unsigned int*>(dgnew + (b * 4 + q) * cpb)[w]);
        }
      }
      if (k_first + warp <= k_last) {
        for (int x = lane; x >> 2 < B; x += 32) {
          const int v = x & 3, b = x >> 2;
          if (VW * v < nch) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (lo_of(q) <= warp && warp <= hi_of(q))
                send(p, b, q * D + j0 + VW * v,
                     *reinterpret_cast<const uint4*>(dgnew + (b * 4 + q) * cpb + VW * v), warp);
          }
        }
      }
    }
    // every thread read stage s in this step's cell: refill it NST steps on
    if (warp == FETCH_WARP && nch > 0 && it + NST < S) fetch(it + NST);
    // 3. the chunks of other clusters in this cluster's heads from L2,
    // polled until the tag is it + 1, each by one half-warp of one block of
    // the cluster, whose lane l sends it into the cluster's rank l where
    // that block has channels in its head. This block relays the chunks of
    // source blocks rank + cs m (m any other cluster) in the gates of
    // `needq`: pair P is the (P % nq)-th of those gates of the (P / nq)-th
    // other cluster. Half-warp h (from the last down) takes slots h, h +
    // THREADS / 16, ..., slot x chunk x & 3 of row (x >> 2) & (2^lb - 1) of
    // pair x >> (2 + lb)
    if (npair > 0) {
      const unsigned int tag = static_cast<unsigned int>(it + 1);
      const int dest = lane & 15;
      for (int x = (THREADS - 1 - threadIdx.x) >> 4; x >> (2 + lb) < npair; x += THREADS / 16) {
        const int v = x & 3, b = x >> 2 & ((1 << lb) - 1), pair = x >> (2 + lb);
        const int mi = nq == 1 ? pair : nq == 2 ? pair >> 1 : nq == 4 ? pair >> 2 : pair / 3;
        int q = 0;
        for (int n = pair - mi * nq; q < 4; ++q)
          if ((needq >> q & 1) && n-- == 0) break;
        const int ks = rank + cs * (mi + (mi >= cl));
        if (ks >= nblk || b >= B || VW * v >= cpb || (ks << lcpb) + VW * v >= D) continue;
        const int f = q * D + (ks << lcpb) + VW * v;
        const unsigned long long* src = xch + (size_t(p) * B + b) * words + f / 2;
        unsigned long long w4[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) w4[w] = load_word(src + w);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (static_cast<unsigned int>(w4[w] >> 32) != tag) w4[w] = poll_word(src + w, tag);
        const uint4 d = {static_cast<unsigned int>(w4[0]), static_cast<unsigned int>(w4[1]),
                         static_cast<unsigned int>(w4[2]), static_cast<unsigned int>(w4[3])};
        if (lo_of(q) <= dest && dest <= hi_of(q)) send(p, b, f, d, dest);
      }
    }
    // one warp waits on the barrier, the others in __syncthreads
    // (spinning warps would take issue slots from the polls)
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(dbar(p), dg_bytes);
      mbar_wait(dbar(p), (it >> 1) & 1);
    }
    __syncthreads();

    // 4. the products dh_rec_{t-1}: B rows in n-tiles of 8 (rows past B
    // read row B - 1, their sums are dropped); each warp adds its k-steps
    // of its m-tiles in two chains a tile (even and odd steps), then writes
    // the two added as its partial sums
    if (nch > 0) {
      const T* buf = dgs + p * B * L.hrow;
      auto run = [&](auto all) {
        constexpr bool FULL = decltype(all)::value;
        for (int n0 = 0; n0 < B; n0 += 8) {
          const T* hb = buf + min(n0 + g, B - 1) * L.hrow + kb * 16 + 4 * t4;
          float acc[MPW][2][4] = {};
          if (FULL) {
            uint2 bv[MAX_KPW];
#pragma unroll
            for (int x = 0; x < MAX_KPW; ++x)
              bv[x] = *reinterpret_cast<const uint2*>(hb + hoff[0] + x * 16);
#pragma unroll
            for (int x = 0; x < MAX_KPW; ++x)
#pragma unroll
              for (int mm = 0; mm < MPW; ++mm)
                mma_bf16(acc[mm][x & 1], af[mm * MAX_KPW + x], bv[x].x, bv[x].y);
          } else {
#pragma unroll
            for (int x = 0; x < MAX_KPW; ++x) {
              if (x < kn) {
#pragma unroll
                for (int mm = 0; mm < MPW; ++mm)
                  if (mg * MPW + mm < mt) {
                    const uint2 bv = *reinterpret_cast<const uint2*>(hb + hoff[mm] + x * 16);
                    mma_bf16(acc[mm][x & 1], af[mm * MAX_KPW + x], bv.x, bv.y);
                  }
              }
            }
          }
#pragma unroll
          for (int mm = 0; mm < MPW; ++mm) {
            const int m = mg * MPW + mm;
            if (FULL || m < mt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = g + 8 * (e / 2), col = n0 + 2 * t4 + e % 2;
                if (col < B)
                  gr[(kp * bp + col) * GS + m * 16 + row] = __fadd_rn(acc[mm][0][e], acc[mm][1][e]);
              }
            }
          }
        }
      };
      if (full)
        run(std::true_type());
      else
        run(std::false_type());
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < CPAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    if (p < B * cpb && jj < nch) {
      dc0[size_t(b) * D + j0 + jj] = dcreg[i];
      if (dh0) dh0[size_t(b) * D + j0 + jj] = N::from_f(dh_rec(b, jj));
    }
  }
  // no block leaves while a block of its cluster may still send to it
  cluster_sync();
}

// The clusters' instance at these shapes: `fn(kernel, shared bytes)`.
template <typename F>
int with_cluster_kernel(int B, int D, int nh, int cpb, F fn) {
  return fn(slstm_scan_bwd_cluster_kernel, BwdLayout(B, D, D / nh, cpb).total);
}

// The clusters' route takes bf16 with cpb a multiple of 16 and at most
// 32, dh a multiple of 16 and at most 512 (the A fragments a warp keeps),
// and at most CPAIRS pairs a thread; nh dividing 4.
inline bool bad_cluster_shape(int B, int S, int D, int nh, int cpb) {
  const int dh = D / nh;
  return bad_shape(B, S, D, nh, cpb) || 4 % nh || cpb % 16 || cpb > 16 * MAX_MT || dh % 16 ||
         dh > 512 || B * cpb > CPAIRS * THREADS;
}

int launch_bwd_clusters(const void* gsave, const void* csave, const void* c0, const void* r,
                        const void* dy, const void* dh_n, const void* dc_n, void* dgx, void* dh0,
                        void* dc0, void* xch, int B, int S, int D, int nh, int cpb, int cs,
                        cudaStream_t stream) {
  void* args[] = {&gsave, &csave, &c0, &r, &dy, &dh_n, &dc_n, &dgx, &dh0,
                  &dc0,   &xch,   &B,  &S, &D,  &nh,   &cpb};
  return with_cluster_kernel(B, D, nh, cpb, [&](auto kernel, size_t smem) {
    const int held = max_clusters(kernel, smem, cs);
    if (held < 0) return -held;
    const int blocks = (D + cpb - 1) / cpb;
    // the exchange needs every block resident at once
    if (held < (blocks + cs - 1) / cs) return int(cudaErrorCooperativeLaunchTooLarge);
    return launch_clusters(kernel, args, smem, blocks, cs, xch,
                           blocks > cs ? 2 * size_t(B) * 4 * D * 2 / 4 * 8 : 0, stream);
  });
}

}  // namespace

// The backward: gsave (B, S, 4D) and csave (B, S, D) fp32 from the saving
// forward, c0 (B, D) fp32 or null, r_gates, dy (B, S, D), dh_n (B, D) or
// null and dc_n (B, D) fp32 or null (the last state's cotangents) -> dgx
// (B, S, 4D), dh0 (B, D) (null: not computed) and dc0 (B, D) fp32; T is bf16
// (bf16 != 0) or fp32 as in the forward. xch scratch of 2 x B x 4D x elem /
// 4 words of 8 bytes. cluster > 1: the clusters' route (bf16) over
// ceil(D / cpb) blocks in clusters of that size, padded to whole clusters
// (cudaErrorCooperativeLaunchTooLarge where the card cannot hold them at
// once); else the cooperative route. The forward's conditions, and nh <= 4.
extern "C" int repro_slstm_scan_bwd(const void* gsave, const void* csave, const void* c0,
                                    const void* r, const void* dy, const void* dh_n,
                                    const void* dc_n, void* dgx, void* dh0, void* dc0,
                                    void* xch, int B, int S, int D, int nh, int cpb, int cluster,
                                    int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cluster > 1) {
    if (!bf16 || bad_cluster_shape(B, S, D, nh, cpb) || cluster > 16 || cluster & (cluster - 1))
      return cudaErrorInvalidValue;
    return launch_bwd_clusters(gsave, csave, c0, r, dy, dh_n, dc_n, dgx, dh0, dc0, xch, B, S, D,
                               nh, cpb, cluster, s);
  }
  if (bad_shape(B, S, D, nh, cpb) || nh > 4) return cudaErrorInvalidValue;
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

// The most clusters of `cluster` blocks of the clusters' route (bf16) at
// these shapes that the card holds at once, or a negative cudaError_t: the
// residency kernels/slstm.py `plan_bwd` reads.
extern "C" int repro_slstm_scan_bwd_clusters(int cluster, int B, int D, int nh, int cpb,
                                             int bf16) {
  if (!bf16 || bad_cluster_shape(B, 1, D, nh, cpb) || cluster <= 0)
    return -int(cudaErrorInvalidValue);
  return with_cluster_kernel(B, D, nh, cpb, [&](auto kernel, size_t smem) {
    return max_clusters(kernel, smem, cluster);
  });
}
