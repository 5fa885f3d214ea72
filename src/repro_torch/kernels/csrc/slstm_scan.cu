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
// Rounding. The kernel rounds where the reference's cell does: the product
// to the activations' type after its fp32 sum, g, each sigmoid and tanh of
// a gate, and sig(i) * tanh(z); sig(f) * c, the sum that gives c and
// sig(o) * tanh(c) stay fp32 (c is fp32), and h is rounded once. Products
// and sums of the cell round apart (__fmul_rn, __fadd_rn), as PyTorch's
// separate kernels do. fp32 sums each product in the order of the
// earlier design (one cooperative grid of 128 blocks, h exchanged as
// tagged words in L2, SIMT products) with expf, a rounded division and
// tanhf: the same bits as its build (tools/slstm_same_bits.py). bf16 sums on the tensor cores (four partial
// sums a column added in a fixed order) and takes sigmoid from __expf and
// an approximate division and tanh from tanh.approx, whose errors the bf16
// roundings after them hide (2.1e-3 relative L2 of h from the earlier
// build at (4, 2048)).
//
// What bounds it. The work is the products, 2 x B x S x 4D x dh FLOPs, and
// the bytes gx read once, h written once and r_gates read once: in bf16 at
// 989 TFLOP/s and 3.35 TB/s, at (4, 2048, 8192) 0.0695 ms of operations
// against 0.0526 of bytes, at (1, 524288, 8192) 4.45 ms of operations.
// Each of the S steps waits for the one before, so the latency of a step
// sets the time. tools/slstm_variants.py splits a step by timing the
// source with parts cut out (H100 80GB HBM3, 700 W). The earlier kernel took
// 4.43 µs at (1, 65536, 8192): 3.79 without its exchange, 1.85 without
// its products; 7.09 at (4, 2048): 2.16 without the products. The SIMT
// products, not the exchange, took most of a step. This kernel takes 3.16
// and 4.14 µs: without the exchange 1.94 and 2.51, without the products
// 1.93 and 2.69, without gx 2.95 and 3.59; each block's thread 0 spends
// (in clock64 cycles a step at batch 1) 1,851 waiting for h, 1,731 in the
// products and their barrier, 1,420 in the cell and 1,080 sending h.
//
// Design. One grid whose blocks are all resident at once, in thread-block
// clusters, launched with the cluster dimension and the cooperative
// attribute together (the driver takes the pair and refuses a grid it
// cannot hold). The H100 holds 7 clusters of 16 blocks of 512 threads at
// once (15 of 8): no grid of 128 blocks in clusters of 8 or more, so bf16
// takes 32 channels a block at D 2,048, 64 blocks in 4 clusters of 16
// (cluster_for and kernels/slstm.py `plan` choose cluster and channels
// from the residency the card reports). Block j owns cpb channels, keeps
// their c in registers (a thread a (row, channel) pair) and its r_gates
// columns for the whole run: in bf16 as mma.sync m16n8k16 A fragments in
// registers (warp (gate q, k quarter) holds its two m-tiles' 8 k-steps,
// 64 registers), in fp32 in shared memory (the earlier SIMT products). Each
// step a block
//   1. takes h_{t-1} (B x D) into its shared memory (rows padded by 32
//      bytes, so the B fragments' 8-byte loads are conflict-free): its
//      cluster's blocks send theirs there by st.async, completing on its
//      mbarrier; the other clusters' chunks come from L2 as 8-byte words of
//      4 data bytes and the step's tag, each polled by one block of the
//      cluster (rank + cluster size x i) and sent into every block of it.
//      One warp spins on the mbarrier, which counts the B x D values'
//      bytes, the others wait at a __syncthreads (spinning warps take
//      issue slots from the polls);
//   2. runs the products: each warp its 16 mma, B rows in n-tiles of 8,
//      and writes its partial sums; __syncthreads;
//   3. runs the cell for its pairs, with gx_t from a ring of NST = 8
//      shared-memory stages that one warp fills NST steps ahead by
//      cp.async.bulk on the stages' mbarriers, and writes h_t;
//   4. after a __syncthreads, stores h_t's words tagged t + 1 to L2 (a
//      thread a word) and sends it to every block of its cluster, warp k
//      to block k, so the sends issue from every warp at once.
// Each choice was timed against its alternative (tools/slstm_variants.py's
// variants, text edits of this source; PERF.md section 6). A cluster
// barrier instead of the mbarrier, clusters of 8, the earlier 128 blocks
// (in clusters of 2) and the precise cell were slower at both shapes.
// Every block polling every word itself, h through L2 alone and the
// cell's warps sending alone came within 0.4 µs a step, as close as two
// builds of the same source came apart between calls: not resolved.
//
// Buffers. h_t goes into buffer t & 1 of the cluster's blocks and into L2
// buffer t & 1, which held h_{t-2}. A block sends or stores h_t after its
// products of step t, which waited for every block's h_{t-1}; a block
// sends or stores h_{t-1} only after its products of step t - 1 read
// h_{t-2} from its buffer t & 1, and after its relays of h_{t-2}'s words
// polled them. So every reader of h_{t-2}, in shared memory and in L2, is
// done before h_t is written, and the mbarrier of buffer t & 1 has
// completed h_{t-2}'s phase (its reader waited on it at step t - 1) before
// any of h_t's bytes reach it. A gx stage is refilled at step t after the
// __syncthreads of step t's products, when every thread has read it at
// step t - 1; the partial sums and the new h are rewritten only after the
// block's h_t was sent, which follows every read of them. A poll or a
// barrier that waits 10 s traps (the kernel fails instead of hanging).
//
// Training. Given gsave and csave, the forward also writes each step's
// pre-activation gates g_t (B, S, 4D, rounded where the cell rounds them)
// and c_t (B, S, D) fp32: what the backward (slstm_scan_bwd.cu) reads.
// Without them it is the same code (a template argument), with no extra
// writes: the same bits.
#include "hopper.cuh"
#include "slstm.cuh"

namespace {

constexpr int NST = 8;          // gx stages in shared memory: steps fetched ahead
constexpr int HPAD = 32;        // bytes after each row of h in shared memory
constexpr int KS = WARPS / 4;   // bf16 products: warp w takes gate w / KS, k part w % KS
constexpr int MAX_MT = 2;       // bf16: m-tiles of 16 columns a gate (cpb <= 32)
constexpr int MAX_KPW = 8;      // bf16: k-steps of 16 a warp (dh <= 512)
constexpr int PC = 2;           // chunks a thread polls at once
// the warp that fetches gx: neither a cell's (the first) nor a relay's
// (the last) at xlstm-1.3b's shapes
constexpr int FETCH_WARP = WARPS / 2;

// Byte offsets in a forward block's shared memory (kernels/slstm.py
// `smem_bytes` computes the total): the barriers (two for h, one a gx
// stage); in fp32 its columns of r_gates (bf16 keeps them in registers);
// two buffers of h, B rows of D values and HPAD bytes; the products (fp32:
// B sums a column; bf16: the KS partial sums a column, for B rounded up to
// 8); its new h; the gx stages (4 gates x B rows x cpb values each).
struct Layout {
  size_t rs, hs, gr, hnew, gxs, total;
  __host__ __device__ Layout(int elem, int B, int D, int dh, int cpb) {
    const bool mma = elem == 2;
    rs = align16(8 * (2 + NST));
    hs = rs + (mma ? 0 : align16(size_t(elem) * 4 * cpb * dh));
    gr = hs + 2 * size_t(B) * (size_t(elem) * D + HPAD);
    hnew = gr + align16(sizeof(float) * 4 * cpb * (mma ? KS * ((B + 7) / 8 * 8) : B));
    gxs = hnew + align16(size_t(elem) * B * cpb);
    total = gxs + NST * align16(size_t(elem) * 4 * B * cpb);
  }
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | uint32_t(__bfloat16_as_ushort(hi)) << 16;
}

// ROWS: batch rows a warp's fp32 products share each r_gates load over (B
// is a multiple of it; 1 in bf16); SAVE: also write g_t and c_t for the
// backward
template <typename T, int ROWS, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_scan_kernel(const T* __restrict__ gx, const T* __restrict__ r, const T* h0,
                      const float* __restrict__ c0, T* __restrict__ out, T* __restrict__ h_n,
                      float* __restrict__ c_n, T* __restrict__ gsave,
                      float* __restrict__ csave, unsigned long long* xch, int B, int S, int D,
                      int nh, int cpb) {
  using N = Num<T>;
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int elem = int(sizeof(T)), VW = 16 / elem;   // values in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(elem, B, D, D / nh, cpb);
  const int dh = D / nh, e4 = 4 * dh, ncol = 4 * cpb;
  const int j0 = blockIdx.x * cpb;
  const int nch = max(0, min(cpb, D - j0));   // 0 in a block that pads the last cluster
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* rs = reinterpret_cast<T*>(smem + L.rs);
  T* hs = reinterpret_cast<T*>(smem + L.hs);
  float* gr = reinterpret_cast<float*>(smem + L.gr);
  T* hnew = reinterpret_cast<T*>(smem + L.hnew);
  T* gxs = reinterpret_cast<T*>(smem + L.gxs);
  const uint32_t bars = smem_u32(smem), hs_at = smem_u32(hs);
  auto hbar = [&](int p) { return bars + 8u * p; };
  auto gbar = [&](int s) { return bars + 8u * (2 + s); };
  // h in shared memory: rows of `hrow` values (`rowb` bytes of data, then
  // HPAD); in L2 rows of `words` 4-byte words; both in 16-byte chunks,
  // `nchunk` a row, of which cluster k owns [k cc, (k + 1) cc)
  const int hrow = D + HPAD / elem, rowb = D * elem, words = rowb / 4, nchunk = rowb / 16;
  const int cs = cluster_size(), rank = int(cluster_rank()), cl = blockIdx.x / cs;
  const int cc = cs * cpb * elem / 16;
  const int own_lo = min(nchunk, cl * cc), own_n = min(nchunk, own_lo + cc) - own_lo;
  const int nfr = nchunk - own_n, nfor = B * nfr;   // other clusters' chunks: a row, all
  const int npairs = B * cpb, gbytes = 4 * B * nch * elem;
  // bf16 products: this warp's gate and k-steps, and the lane's place in
  // the m16n8k16 fragments (g: a row of A and C, a column of B)
  const int q = warp / KS, ks = warp % KS, g = lane / 4, t4 = lane % 4;
  const int mt = cpb / 16, nks = dh / 16, kpw = (nks + KS - 1) / KS;
  const int kb = ks * kpw, kn = max(0, min(kpw, nks - kb)), bp = (B + 7) / 8 * 8;

  if (threadIdx.x == 0) {
    mbar_init(hbar(0), 1);
    mbar_init(hbar(1), 1);
    for (int s = 0; s < NST; ++s) mbar_init(gbar(s), 1);
    fence_mbar_init();
  }
  // fp32: this block's columns of r_gates in shared memory, column c =
  // (gate c / cpb, channel j0 + c % cpb), each column's dh values contiguous
  if (!MMA) {
    for (int i = threadIdx.x; i < ncol * dh; i += THREADS) {
      const int c = i % ncol, k = i / ncol, jj = c % cpb;
      T v = N::from_f(0.0f);
      if (jj < nch) {
        const int idx = (c / cpb) * D + j0 + jj;
        v = r[(size_t(idx / e4) * dh + k) * e4 + idx % e4];
      }
      rs[size_t(c) * dh + k] = v;
    }
  }
  // bf16: the A fragments of this warp's products in registers for the
  // whole run: m-tile m of gate q holds the columns (q, m 16 + row), k-step
  // x the terms (kb + x) 16 + 0..15; the lane's two k pairs of a fragment
  // are the contiguous terms 4 t4 .. 4 t4 + 3 (B's fragments take the same
  // terms, so one 8-byte load gives them)
  uint32_t af[MAX_MT * MAX_KPW][4];
#pragma unroll
  for (int m = 0; m < MAX_MT; ++m)
#pragma unroll
    for (int x = 0; x < MAX_KPW; ++x)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int jj = m * 16 + g + 8 * hi;
        const bool on = MMA && m < mt && x < kn && jj < nch;
        uint32_t lo2 = 0, hi2 = 0;
        if (on) {
          const int idx = q * D + j0 + jj, k = (kb + x) * 16 + 4 * t4;
          const T* col = r + size_t(idx / e4) * dh * e4 + idx % e4;
          if constexpr (MMA) {
            lo2 = bits2(col[size_t(k) * e4], col[size_t(k + 1) * e4]);
            hi2 = bits2(col[size_t(k + 2) * e4], col[size_t(k + 3) * e4]);
          }
        }
        af[m * MAX_KPW + x][hi] = lo2;
        af[m * MAX_KPW + x][2 + hi] = hi2;
      }
  // h_{-1} (h0 or zeros) in buffer 1, where step 0 reads it
  for (int i = threadIdx.x; i < B * words; i += THREADS) {
    const int b = i / words, w = i % words;
    reinterpret_cast<unsigned int*>(hs + (size_t(B) + b) * hrow)[w] =
        h0 ? reinterpret_cast<const unsigned int*>(h0)[i] : 0u;
  }
  // c of this thread's (row, channel) pairs p = threadIdx.x + i * THREADS
  float creg[MAX_PAIRS], hlast[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    creg[i] = (p < npairs && jj < nch && c0) ? c0[size_t(b) * D + j0 + jj] : 0.0f;
    hlast[i] = 0.0f;
  }
  // every block of the cluster is running and its barriers initialised
  // before any block stores to it
  cluster_sync();

  // FETCH_WARP fetches step t's gx slices (4 gates x B rows, nch values
  // each) into stage t % NST
  auto fetch = [&](int t) {
    const int s = t % NST;
    if (lane == 0) mbar_expect_tx(gbar(s), gbytes);
    __syncwarp();
    for (int i = lane; i < 4 * B; i += 32) {
      const int gate = i / B, b = i % B;
      bulk_load(smem_u32(gxs + (size_t(s) * 4 * B + i) * cpb),
                gx + (size_t(b) * S + t) * 4 * D + size_t(gate) * D + j0, nch * elem, gbar(s));
    }
  };
  if (warp == FETCH_WARP && nch > 0)
    for (int t = 0; t < min(S, NST); ++t) fetch(t);

  // 16 bytes of h_{tt} (row b, chunk u) into buffer tt & 1 of the
  // cluster's block k
  auto send = [&](int tt, int b, int u, uint4 d, int k) {
    const int p = tt & 1;
    const uint32_t at = hs_at + uint32_t((p * B + b) * (rowb + HPAD) + 16 * u);
    st_async16(mapa(at, k), d, mapa(hbar(p), k));
  };
  // the cell's activations: in bf16 sigmoid from __expf and an approximate
  // division, tanh from the hardware's tanh.approx (the bf16 roundings
  // after them hide their errors); in fp32 expf, a rounded division, tanhf
  auto sig = [](float x) { return MMA ? __fdividef(1.0f, 1.0f + __expf(-x)) : sigmoid(x); };
  auto tnh = [](float x) { return MMA ? tanh_approx(x) : tanhf(x); };
  // fp32 products: column c reads h_{t-1} of the head of its flat index
  const T* hprev = nullptr;
  auto h_of = [&](int c) { return hprev + (((c / cpb) * D + j0 + c % cpb) / e4) * dh; };

  for (int t = 0; t < S; ++t) {
    const int p = (t - 1) & 1;   // h_{t-1}'s buffer and barrier
    hprev = hs + size_t(p) * B * hrow;
    if (t > 0) {
      // 1. h_{t-1}: the other clusters' chunks come from L2 as tagged
      // words, polled until the tag is t (PC chunks a thread in flight at
      // once), each by one block of the cluster, which sends it into every
      // block of it; the blocks of the cluster send theirs (4.); the
      // mbarrier counts the B x D values' bytes
      for (int x0 = THREADS - 1 - threadIdx.x; x0 * cs < nfor; x0 += PC * THREADS) {
        unsigned long long v[PC][4];
        int row[PC], u[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int i = rank + cs * (x0 + c * THREADS);
          row[c] = i < nfor ? i / nfr : -1;
          u[c] = i % nfr < own_lo ? i % nfr : i % nfr + own_n;
          const unsigned long long* src = xch + (size_t(p) * B + row[c]) * words + 4 * u[c];
#pragma unroll
          for (int w = 0; w < 4; ++w) v[c][w] = row[c] >= 0 ? load_word(src + w) : 0ull;
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          if (row[c] < 0) continue;
          const unsigned long long* src = xch + (size_t(p) * B + row[c]) * words + 4 * u[c];
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (static_cast<unsigned int>(v[c][w] >> 32) != static_cast<unsigned int>(t))
              v[c][w] = poll_word(src + w, static_cast<unsigned int>(t));
          const uint4 d = {static_cast<unsigned int>(v[c][0]), static_cast<unsigned int>(v[c][1]),
                           static_cast<unsigned int>(v[c][2]), static_cast<unsigned int>(v[c][3])};
          for (int k = 0; k < cs; ++k) send(t - 1, row[c], u[c], d, k);
        }
      }
      // one warp spins on the barrier, the others wait in __syncthreads
      // (spinning warps would take issue slots from the polls)
      if (warp == 0) {
        if (lane == 0) mbar_expect_tx(hbar(p), uint32_t(B) * rowb);
        mbar_wait(hbar(p), ((t - 1) >> 1) & 1);
      }
      __syncthreads();
    }

    // 2. the products, of the reference's einsum rounded to T
    if (MMA && nch > 0) {
      // B rows in n-tiles of 8 (rows past B read row B - 1, their sums are
      // dropped); warp (q, ks) adds its k-steps of both m-tiles in two
      // chains a tile (even and odd steps), then writes the two added
      const int hq = (q * D + j0) / e4;
      for (int n0 = 0; n0 < B; n0 += 8) {
        const T* hb = hprev + size_t(min(n0 + g, B - 1)) * hrow + hq * dh + kb * 16 + 4 * t4;
        float acc[MAX_MT][2][4] = {};
#pragma unroll
        for (int x = 0; x < MAX_KPW; ++x) {
          if (x < kn) {
            const uint2 bv = *reinterpret_cast<const uint2*>(hb + x * 16);
#pragma unroll
            for (int m = 0; m < MAX_MT; ++m)
              if (m < mt) mma_bf16(acc[m][x & 1], af[m * MAX_KPW + x], bv.x, bv.y);
          }
        }
#pragma unroll
        for (int m = 0; m < MAX_MT; ++m) {
          if (m < mt) {
            float* pp = gr + size_t(((ks * 4 + q) * mt + m) * 16) * bp;
            const int n = n0 + 2 * t4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = g + 8 * (e / 2), col = n + e % 2;
              if (col < B) pp[row * bp + col] = __fadd_rn(acc[m][0][e], acc[m][1][e]);
            }
          }
        }
      }
    } else if (!MMA) {
      products<T, ROWS, true>(rs, h_of, hrow, ncol, cpb, nch, dh, B, gr);
    }
    __syncthreads();

    // 3. the cell
    const int s = t % NST;
    if (threadIdx.x < npairs && nch > 0) mbar_wait(gbar(s), (t / NST) & 1);
    const T* gs_t = gxs + size_t(s) * 4 * B * cpb;
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
      if (p < npairs && jj < nch) {
        float g4[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          float prod;
          if (MMA) {
            // the KS partial sums in a fixed order, rounded once
            const float* pp = gr + size_t(((gate * mt + jj / 16) * 16) + jj % 16) * bp + b;
            prod = pp[0];
            for (int k = 1; k < KS; ++k)
              prod = __fadd_rn(prod, pp[size_t(k) * 4 * mt * 16 * bp]);
            prod = N::round(prod);
          } else {
            prod = gr[(gate * cpb + jj) * B + b];
          }
          g4[gate] = N::round(__fadd_rn(N::to_f(gs_t[(gate * B + b) * cpb + jj]), prod));
        }
        const float si = N::round(sig(g4[0])), sf = N::round(sig(g4[1]));
        const float tz = N::round(tnh(g4[2])), so = N::round(sig(g4[3]));
        const float c = __fadd_rn(__fmul_rn(sf, creg[i]), N::round(__fmul_rn(si, tz)));
        creg[i] = c;
        const T h = N::from_f(__fmul_rn(so, tnh(c)));
        hlast[i] = N::to_f(h);
        hnew[p] = h;
        out[(size_t(b) * S + t) * D + j0 + jj] = h;
        if (SAVE) {
          T* gs = gsave + (size_t(b) * S + t) * 4 * D + j0 + jj;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) gs[size_t(gate) * D] = N::from_f(g4[gate]);
          csave[(size_t(b) * S + t) * D + j0 + jj] = c;
        }
      }
    }
    // 4. h_t in 16-byte chunks of VW pairs, after a __syncthreads (no one
    // reads the last step's): for the other clusters as words tagged
    // t + 1, thread x storing word x, then to every block of the cluster,
    // warp k to block k, a lane a chunk (so the sends issue from every
    // warp at once, the lanes' chunks side by side)
    if (t + 1 < S) {
      __syncthreads();
      const unsigned long long tag = static_cast<unsigned long long>(t + 1) << 32;
      const int rw = nch * elem / 4, rc = nch / VW;   // a row's words and chunks
      if (nfr > 0)
        for (int x = threadIdx.x; x < B * rw; x += THREADS)
          store_word(xch + (size_t(t & 1) * B + x / rw) * words + j0 * elem / 4 + x % rw,
                     tag | reinterpret_cast<const unsigned int*>(hnew + x / rw * cpb)[x % rw]);
      if (warp < cs)
        for (int c = lane; c < B * rc; c += 32)
          send(t, c / rc, j0 / VW + c % rc,
               *reinterpret_cast<const uint4*>(hnew + c / rc * cpb + c % rc * VW), warp);
    }
    // every thread read stage (t - 1) % NST before this step's products'
    // __syncthreads: refill it NST steps on, off the step's critical path
    if (warp == FETCH_WARP && nch > 0 && t > 0 && t - 1 + NST < S) fetch(t - 1 + NST);
  }

#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = threadIdx.x + i * THREADS, b = p / cpb, jj = p % cpb;
    if (p < npairs && jj < nch) {
      c_n[size_t(b) * D + j0 + jj] = creg[i];
      h_n[size_t(b) * D + j0 + jj] = N::from_f(hlast[i]);
    }
  }
  // no block leaves while a block of its cluster may still store to it
  cluster_sync();
}

// The cluster size of a grid of `blocks` blocks (kernels/slstm.py `plan`
// chooses the same): the largest of 16, 8, 4 and 2 blocks, none larger
// than the grid but 2, whose clusters the card holds all at once (the
// exchange needs every block resident); 0 where none fits, or a negative
// cudaError_t.
template <typename K>
int cluster_for(K kernel, size_t smem, int blocks) {
  for (int cs : {16, 8, 4, 2}) {
    if (cs > blocks && cs > 2) continue;
    const int n = max_clusters(kernel, smem, cs);
    if (n < 0) return n;
    if (n >= (blocks + cs - 1) / cs) return cs;
  }
  return 0;
}

// Launch `kernel` (an instance of slstm_scan_kernel for `elem`-byte values)
// over ceil(D / cpb) blocks in clusters of cluster_for's size, after zeroing
// the exchange's words (no tag may be found before it is written).
template <typename K>
int launch(K kernel, int elem, const void* gx, const void* r, const void* h0, const void* c0,
           void* out, void* h_n, void* c_n, void* gsave, void* csave, void* xch, int B, int S,
           int D, int nh, int cpb, cudaStream_t stream) {
  void* args[] = {&gx,    &r,   &h0, &c0, &out, &h_n, &c_n, &gsave,
                  &csave, &xch, &B,  &S,  &D,   &nh,  &cpb};
  const size_t smem = Layout(elem, B, D, D / nh, cpb).total;
  const int blocks = (D + cpb - 1) / cpb;
  const int cs = cluster_for(kernel, smem, blocks);
  if (cs < 0) return -cs;
  // the exchange needs every block resident at once
  if (cs == 0) return cudaErrorCooperativeLaunchTooLarge;
  return launch_clusters(kernel, args, smem, blocks, cs, xch,
                         blocks > cs ? 2 * size_t(B) * D * elem / 4 * 8 : 0, stream);
}

// The forward kernel's instance for B rows in bf16 (bf16 != 0, products on
// every row at once) or fp32 (1, 2 or 4 rows a warp, the largest that
// divides B), with or without saving; `fn(kernel)`'s result.
template <typename F>
int with_kernel(bool save, int B, int bf16, F fn) {
  const int rows = B % 4 == 0 ? 4 : B % 2 == 0 ? 2 : 1;
  if (bf16)
    return save ? fn(slstm_scan_kernel<__nv_bfloat16, 1, true>)
                : fn(slstm_scan_kernel<__nv_bfloat16, 1, false>);
  if (save)
    return rows == 4   ? fn(slstm_scan_kernel<float, 4, true>)
           : rows == 2 ? fn(slstm_scan_kernel<float, 2, true>)
                       : fn(slstm_scan_kernel<float, 1, true>);
  return rows == 4   ? fn(slstm_scan_kernel<float, 4, false>)
         : rows == 2 ? fn(slstm_scan_kernel<float, 2, false>)
                     : fn(slstm_scan_kernel<float, 1, false>);
}

// Beyond the shared conditions: cpb x elem a multiple of 16 bytes; in bf16
// (the products on tensor cores) cpb a multiple of 16 and at most 32, dh a
// multiple of 16 and at most 512, and each gate's columns in one head (nh
// divides 4).
inline bool bad_fwd_shape(int B, int S, int D, int nh, int cpb, int bf16) {
  if (bad_shape(B, S, D, nh, cpb) || cpb * (bf16 ? 2 : 4) % 16) return true;
  const int dh = D / nh;
  return bf16 && (cpb % 16 || cpb > 16 * MAX_MT || dh % 16 || dh > 16 * KS * MAX_KPW || 4 % nh);
}

}  // namespace

// gx (B, S, 4D) and r_gates (nh, D/nh, 4D/nh) in bf16 (bf16 != 0) or fp32;
// h0 (B, D) in the same type and c0 (B, D) fp32, each or null (zeros); out
// (B, S, D) and h_n (B, D) in gx's type, c_n (B, D) fp32; gsave (B, S, 4D)
// in gx's type and csave (B, S, D) fp32 both or neither (null: not saved);
// xch scratch of 2 x B x D x elem / 4 words of 8 bytes. All contiguous and
// 16-byte aligned; D a multiple of 8, D / nh even, cpb x elem a multiple of
// 16 bytes, B x cpb <= 2048. One block per cpb channels, in clusters of
// `cluster_for`'s size. Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be resident at
// once).
extern "C" int repro_slstm_scan(const void* gx, const void* r, const void* h0, const void* c0,
                                void* out, void* h_n, void* c_n, void* gsave, void* csave,
                                void* xch, int B, int S, int D, int nh, int cpb, int bf16,
                                void* stream) {
  if (bad_fwd_shape(B, S, D, nh, cpb, bf16) || !gsave != !csave) return cudaErrorInvalidValue;
  return with_kernel(gsave != nullptr, B, bf16, [&](auto kernel) {
    return launch(kernel, bf16 ? 2 : 4, gx, r, h0, c0, out, h_n, c_n, gsave, csave, xch, B, S, D,
                  nh, cpb, static_cast<cudaStream_t>(stream));
  });
}

// The most clusters of `cluster` blocks of the forward kernel (without
// saving) at these shapes that the card holds at once, or a negative
// cudaError_t: the residency kernels/slstm.py `plan` reads.
extern "C" int repro_slstm_scan_clusters(int cluster, int B, int D, int nh, int cpb, int bf16) {
  if (bad_fwd_shape(B, 1, D, nh, cpb, bf16) || cluster <= 0) return -int(cudaErrorInvalidValue);
  const size_t smem = Layout(bf16 ? 2 : 4, B, D, D / nh, cpb).total;
  return with_kernel(false, B, bf16,
                     [&](auto kernel) { return max_clusters(kernel, smem, cluster); });
}
