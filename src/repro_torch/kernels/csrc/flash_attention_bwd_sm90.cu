// Flash attention backward for Hopper (sm_90a), bf16, d in {64, 128, 256}: TMA
// loads into shared-memory rings, every product on the tensor cores with
// wgmma, and no atomics, so the result is the same from run to run. Bound to
// Python with ctypes.
//
// Replaces the XLA backward that the reference pairs with its Pallas kernel
// (src/repro/kernels/ops.py `_fa_bwd` -> src/repro/models/common.py
// `_flash_vjp_bwd`) for bf16 inputs at head dim 64, 128 and 256; every other
// call takes the SIMT kernel of csrc/flash_attention_bwd.cu. Head dim 256
// has kernels of its own (below, after the d 64/128 templates). Same function: with
// D = rowsum(dO * O) in fp32,
//   P = exp(q.k^T / sqrt(d) - LSE)   (0 where the forward masked: kv padding,
//                                     causal top-left, window
//                                     kpos > qpos - window),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) / sqrt(d),
//   dQ = dS K,    dK = dS^T Q,
// fp32 accumulators, GQA heads folded onto kv head h / (H / KV), outputs in
// bf16. P is recomputed in the forward's units: csrc/attention_bwd.cuh turns
// the natural-log LSE into base 2, and P = exp2(s * scale * log2(e) - LSE2),
// as the forward's exp2 with the scale folded in. P and dS are rounded to
// bf16 before their products, as the forward rounds P before P.V and as the
// plain version (models/common.py `flash_attention_bwd`) rounds both. A q
// row that sees no key at all gets zero gradients.
//
// What bounds it on this card: at the qwen2.5-3b training shape (q
// (4,1024,16,128), k/v (4,1024,2,128), causal) the bf16 tensor-core
// operations inside the causal triangle, 2.5 times the forward's, outweigh
// the bytes of q, k, v, out, dO, dq, dk and dv; so the products must run on
// wgmma with operands fed from shared memory by TMA.
//
// Design (after FlashAttention-2's backward, in its deterministic form).
// dK and dV sum over q rows, dQ over kv rows, so no single tiling owns both
// sums; adding one of them with atomics would change its last bits from
// run to run (and the Themis-vs-GSPMD check on the card compares two runs).
// So two kernels, each owning the rows it sums into:
// - attn_bwd_kv_sm90: one block per (kv tile of BK = 128 rows, q head,
//   batch), 384 threads. Warpgroup 2 produces: after `setmaxnreg` drops it
//   to 24 registers, one thread loads the block's K and V once (TMA), then
//   for each q tile of 64 rows its Q and dO (TMA) and its LSE2 and D rows
//   (bulk copies) into a 2-stage ring ("full" / "empty" mbarriers).
//   Warpgroups 0 and 1 consume, 64 kv rows each, raised to 240 registers:
//   S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 chains with both
//   operands K-major in shared memory; P^T and dS^T in registers, where the
//   accumulator fragments of S^T and dP^T are already the A-operand
//   fragments of dV += P^T dO and dK += dS^T Q (A in registers; dO and Q
//   are the MN-major B operand, transpose-B set, as V is for P.V in the
//   forward). The loop starts at the q tile of the diagonal when causal and
//   stops where the window ends; a warpgroup skips the products of a q tile
//   wholly masked for its 64 kv rows; kv tile 0 (the most q tiles when
//   causal) is launched first. Each block stores its head's fp32 dK and dV
//   rows, (B, T, H, d): one block per kv head would loop over the GQA
//   group's 8 q heads and give the training shape only 64 blocks for 132
//   SMs, where one per q head gives 512. A last pass (attn_bwd_sum_heads)
//   sums each group's heads in a fixed order, 2 x 33.5 MB of fp32 at the
//   training shape written and read once.
// - attn_bwd_dq_sm90: one block per (q tile of 128 rows, q head, batch), the
//   forward's layout: the producer loads Q and dO once and K and V tiles of
//   64 rows into a 2-stage ring; each consumer warpgroup (64 q rows)
//   recomputes S = Q K^T and dP = dO V^T (wgmma m64n64k16, K-major
//   operands), forms dS in registers, and adds dQ += dS K with dS as the
//   register A operand and K as the MN-major B operand (as P.V in the
//   forward), then stores dQ in bf16. Recomputing S and dP costs two of the
//   seven products; an fp32 dQ added over kv tiles would cost atomics or a
//   partial per kv tile (151 MB at the training shape).
//
// Traps this layout has to get right:
// - The forward keeps its running max in base-2 units; P must be recomputed
//   in the same units (above), or it is off by a factor and still finite.
// - The tensor maps read q, k and v through their strides (the Python
//   wrapper raises on a layout TMA cannot read); dO and out are contiguous
//   (the wrapper makes dO so). TMA zero-fills rows past S or T; the mask
//   zeroes their P and dS, and the stores are predicated on the position.
// - Every (kv tile, head) block writes its dK and dV rows, zeros included
//   (a kv tile that no q row sees, a warpgroup whose rows are all masked),
//   so the head sum reads no stale scratch.
//
// Left for later: overlapping one consumer's softmax-gradient math with the
// other's products (ping-pong), a persistent grid, and running the two
// kernels on two streams.
#include <climits>
#include <cstddef>
#include <cstdint>

#include "attention_bwd.cuh"
#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;      // tiles in flight
constexpr int NT = 384;        // warpgroups 0-1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr int BOX = 128;       // bytes of d per TMA box (the 128-byte swizzle)
constexpr float LOG2E = 1.4426950408889634f;

// ---- dK, dV: one block per kv tile ----
constexpr int KV_BK = 128;     // kv rows per block: two consumer warpgroups of 64
constexpr int KV_BQ = 64;      // q rows per tile of the loop

template <int D>
struct KvCfg {
  static constexpr int KV_BYTES = KV_BK * D * 2;    // K or V
  static constexpr int QT_BYTES = KV_BQ * D * 2;    // Q or dO, one stage
  static constexpr int ROW_BYTES = KV_BQ * 4;       // LSE2 or D of one q tile
  static constexpr int OFF_Q = 2 * KV_BYTES;        // stage s: Q, then dO
  static constexpr int OFF_ROWS = OFF_Q + STAGES * 2 * QT_BYTES;  // stage s: LSE2, then D
  static constexpr int SMEM = OFF_ROWS + STAGES * 2 * ROW_BYTES + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_kv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 float* __restrict__ dk_part, float* __restrict__ dv_part, int S, int S_pad,
                 int Tk, int H, int KV, int B, float scale, float scale_log2, int causal,
                 int window) {
  using C = KvCfg<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // kv, full[STAGES], empty[STAGES]

  // the 128-byte swizzle repeats every 1024 bytes: every tile starts on one
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + C::KV_BYTES;
  auto sq = [&](int s) { return sk + C::OFF_Q + s * 2 * C::QT_BYTES; };
  auto sdo = [&](int s) { return sk + C::OFF_Q + s * 2 * C::QT_BYTES + C::QT_BYTES; };
  auto srows = [&](int s) { return sk + C::OFF_ROWS + s * 2 * C::ROW_BYTES; };
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int bh = H * B;
  const int kt = static_cast<int>(blockIdx.x) / bh;  // first kv tile first
  const int h = static_cast<int>(blockIdx.x) % bh % H;
  const int b = static_cast<int>(blockIdx.x) % bh / H;
  const int kvh = h / (H / KV);
  const int k0 = kt * KV_BK;

  // q tiles that see a key of this kv tile
  const int q_begin = causal ? k0 : 0;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + KV_BK - 1 + window);
  const int qt_begin = q_begin / KV_BQ;
  const int n_qt = (q_end + KV_BQ - 1) / KV_BQ - qt_begin;
  if (n_qt <= 0) {  // no q row sees these keys: this head's dK and dV rows are 0
    for (int e = threadIdx.x; e < KV_BK * D; e += NT) {
      const int kpos = k0 + e / D;
      if (kpos < Tk) {
        const size_t at = ((static_cast<size_t>(b) * Tk + kpos) * H + h) * D + e % D;
        dk_part[at] = 0.f;
        dv_part[at] = 0.f;
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      const size_t rows = (static_cast<size_t>(b) * H + h) * S_pad;  // this head's LSE2, D
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c) {
        tma_load(sk + c * KV_BK * BOX, &tk, bar_kv, 64 * c, kvh, k0, b);
        tma_load(sv + c * KV_BK * BOX, &tv, bar_kv, 64 * c, kvh, k0, b);
      }
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const int q0 = (qt_begin + i) * KV_BQ;
        mbar_expect_tx(full(s), 2 * C::QT_BYTES + 2 * C::ROW_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          tma_load(sq(s) + c * KV_BQ * BOX, &tq, full(s), 64 * c, h, q0, b);
          tma_load(sdo(s) + c * KV_BQ * BOX, &tdo, full(s), 64 * c, h, q0, b);
        }
        bulk_load(srows(s), lse2 + rows + q0, C::ROW_BYTES, full(s));
        bulk_load(srows(s) + C::ROW_BYTES, delta + rows + q0, C::ROW_BYTES, full(s));
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: 64 kv rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32;
    const int ka = k0 + 64 * wg;                // this warpgroup's first kv row
    const int frow = 16 * warp + lane / 4;      // fragment rows frow, frow + 8
    const int col0 = 2 * (lane % 4);            // fragment column in each 8
    const uint32_t sk_wg = sk + 64 * wg * BOX;  // 64 rows x 128 bytes per box
    const uint32_t sv_wg = sv + 64 * wg * BOX;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_begin + i) * KV_BQ;
      mbar_wait(full(s), (i / STAGES) & 1);
      const bool skip = ka >= Tk || (causal && q0 + KV_BQ - 1 < ka) ||
                        (window > 0 && q0 - window >= ka + 63);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns each
        float st[32], dpt[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
        reg_fence(st);
        reg_fence(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t slice = (kk % 4) * 32;  // 16 bf16 along the swizzled row
          wgmma_ss<64>(st, desc_sw128(sk_wg + (kk / 4) * KV_BK * BOX + slice, 16, 1024),
                       desc_sw128(sq(s) + (kk / 4) * KV_BQ * BOX + slice, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t slice = (kk % 4) * 32;
          wgmma_ss<64>(dpt, desc_sw128(sv_wg + (kk / 4) * KV_BK * BOX + slice, 16, 1024),
                       desc_sw128(sdo(s) + (kk / 4) * KV_BQ * BOX + slice, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);

        // P^T and dS^T: element j is kv row frow + 8 ((j >> 1) & 1), q column
        // 8 (j / 4) + col0 + (j & 1)
        const float* lse_s = reinterpret_cast<const float*>(smem_raw + (srows(s) - raw));
        const float* d_s = lse_s + KV_BQ;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int qc = 8 * jj + col0;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
          const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = 4 * jj + 2 * r + c;
              const int kpos = ka + frow + 8 * r;
              const int qpos = q0 + qc + c;
              bool ok = kpos < Tk && qpos < S;
              if (causal) ok = ok && qpos >= kpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              const float p = ok ? exp2f(st[j] * scale_log2 - (c ? l2.y : l2.x)) : 0.f;
              st[j] = p;
              dpt[j] = p * (dpt[j] - (c ? dd.y : dd.x)) * scale;
            }
          }
        }
        // the fragment of columns 16kk..16kk+15 is the A fragment of slice kk
        uint32_t pp[4][4], pds[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pp[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            pds[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }

        // dV += P^T dO and dK += dS^T Q, A from registers
        reg_fence(dv);
        reg_fence(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk)
          wgmma_rs<D>(dv, pp[kk], desc_sw128(sdo(s) + kk * 16 * BOX, KV_BQ * BOX, 1024));
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk)
          wgmma_rs<D>(dk, pds[kk], desc_sw128(sq(s) + kk * 16 * BOX, KV_BQ * BOX, 1024));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dv);
        reg_fence(dk);
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogue: this head's dK and dV rows, fp32 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = ka + frow + 8 * r;
      if (kpos < Tk) {
        const size_t at = ((static_cast<size_t>(b) * Tk + kpos) * H + h) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<float2*>(dk_part + at + 8 * jj + col0) =
              make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_part + at + 8 * jj + col0) =
              make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

// ---- dQ: one block per q tile, the forward's layout ----
constexpr int Q_BQ = 128;      // q rows per block: two consumer warpgroups of 64
constexpr int Q_BK = 64;       // kv rows per tile of the loop

template <int D>
struct QCfg {
  static constexpr int Q_BYTES = Q_BQ * D * 2;      // Q or dO
  static constexpr int KV_BYTES = Q_BK * D * 2;     // K or V, one stage
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int S, int S_pad, int Tk, int H, int KV, int B,
                 int n_qt, float scale, float scale_log2, int causal, int window) {
  using C = QCfg<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[STAGES], empty[STAGES]

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + C::Q_BYTES;
  auto stage_k = [&](int s) { return sq + 2 * C::Q_BYTES + s * 2 * C::KV_BYTES; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int bh = H * B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;  // last q tile first
  const int h = static_cast<int>(blockIdx.x) % bh % H;
  const int b = static_cast<int>(blockIdx.x) % bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * Q_BQ;

  // kv tiles this q tile can see
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + Q_BQ, S));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / Q_BK;
  const int n_tiles = max(0, (k_end + Q_BK - 1) / Q_BK - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c) {
        tma_load(sq + c * Q_BQ * BOX, &tq, bar_q, 64 * c, h, q0, b);
        tma_load(sdo + c * Q_BQ * BOX, &tdo, bar_q, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const uint32_t sk = stage_k(s), sv = sk + C::KV_BYTES;
        const int k0 = (kt_begin + i) * Q_BK;
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          tma_load(sk + c * Q_BK * BOX, &tk, full(s), 64 * c, kvh, k0, b);
          tma_load(sv + c * Q_BK * BOX, &tv, full(s), 64 * c, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32;
    const int qa = q0 + 64 * wg;                   // this warpgroup's first row
    const int qb = qa + 63;
    const int row0 = qa + 16 * warp + lane / 4;    // fragment rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);               // fragment column in each 8
    const uint32_t sq_wg = sq + 64 * wg * BOX;     // 64 rows x 128 bytes per box
    const uint32_t sdo_wg = sdo + 64 * wg * BOX;

    // this thread's two rows' LSE2 and D
    const size_t rows = (static_cast<size_t>(b) * H + h) * S_pad;
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      l2[r] = qpos < S ? lse2[rows + qpos] : 0.f;
      dd[r] = qpos < S ? delta[rows + qpos] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_begin + i) * Q_BK;
      mbar_wait(full(s), (i / STAGES) & 1);
      const bool masked_out = (causal && k0 > qb) || (window > 0 && k0 + Q_BK - 1 <= qa - window);
      if (!masked_out) {
        const uint32_t sk = stage_k(s), sv = sk + C::KV_BYTES;
        // S = Q K^T and dP = dO V^T: 64 q rows x 64 kv columns each
        float sc[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
        reg_fence(sc);
        reg_fence(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t slice = (kk % 4) * 32;  // 16 bf16 along the swizzled row
          wgmma_ss<64>(sc, desc_sw128(sq_wg + (kk / 4) * Q_BQ * BOX + slice, 16, 1024),
                       desc_sw128(sk + (kk / 4) * Q_BK * BOX + slice, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t slice = (kk % 4) * 32;
          wgmma_ss<64>(dp, desc_sw128(sdo_wg + (kk / 4) * Q_BQ * BOX + slice, 16, 1024),
                       desc_sw128(sv + (kk / 4) * Q_BK * BOX + slice, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);

        // dS: element j is q row row0 + 8 ((j >> 1) & 1), kv column
        // k0 + 8 (j / 4) + col0 + (j & 1)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = (j >> 1) & 1;
          const int kpos = k0 + 8 * (j / 4) + col0 + (j & 1);
          const int qpos = row0 + 8 * r;
          bool ok = kpos < Tk && qpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          const float p = ok ? exp2f(sc[j] * scale_log2 - l2[r]) : 0.f;
          dp[j] = p * (dp[j] - dd[r]) * scale;
        }
        // the dS fragment of columns 16kk..16kk+15 is the A fragment of slice kk
        uint32_t pds[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pds[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

        // dQ += dS K, K the MN-major B operand
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Q_BK / 16; ++kk)
          wgmma_rs<D>(acc, pds[kk], desc_sw128(sk + kk * 16 * BOX, Q_BK * BOX, 1024));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogue: dQ rows in bf16 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos < S) {
        __nv_bfloat16* orow = dq + ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The last pass: blockIdx.y picks the array, 0 dK, 1 dV. part (B,T,H,D) -> out (B,T,KV,D),
// out[b,t,kvh] = sum over g < H / KV of part[b,t,kvh * (H / KV) + g].
template <typename T>
__global__ void attn_bwd_sum_heads(const float* __restrict__ dk_part, T* __restrict__ dk,
                                   const float* __restrict__ dv_part, T* __restrict__ dv,
                                   long long n, int G, int D) {
  const float* src = blockIdx.y == 0 ? dk_part : dv_part;
  T* dst = blockIdx.y == 0 ? dk : dv;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long c = i % D, row = i / D;  // row = (b * T + t) * KV + kvh
    const float* p = src + (row * G) * D + c;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += p[static_cast<long long>(g) * D];
    dst[i] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch_sum_heads(const float* dk_part, void* dk, const float* dv_part, void* dv,
                             long long n, int G, int D, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  attn_bwd_sum_heads<T><<<dim3(blocks, 2), 256, 0, stream>>>(
      dk_part, static_cast<T*>(dk), dv_part, static_cast<T*>(dv), n, G, D);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
           const float* delta, void* dq, float* dk_part, float* dv_part, int B, int S,
           int S_pad, int Tk, int H, int KV, const long long* qs, const long long* ks,
           const long long* vs, float scale, int causal, int window, cudaStream_t stream) {
  const long long hd = static_cast<long long>(H) * D;
  // the kv kernel's maps: q-side boxes of KV_BQ rows, kv-side of KV_BK
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, D, H, S, B, qs[0], qs[1], qs[2], KV_BQ);
  if (err == 0) err = make_map(&tdo, dout, D, H, S, B, S * hd, hd, D, KV_BQ);
  if (err == 0) err = make_map(&tk, k, D, KV, Tk, B, ks[0], ks[1], ks[2], KV_BK);
  if (err == 0) err = make_map(&tv, v, D, KV, Tk, B, vs[0], vs[1], vs[2], KV_BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_kv_sm90<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       KvCfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  long long blocks = static_cast<long long>((Tk + KV_BK - 1) / KV_BK) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_bwd_kv_sm90<D><<<static_cast<unsigned>(blocks), NT, KvCfg<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, dk_part, dv_part, S, S_pad, Tk, H, KV, B, scale,
      scale * LOG2E, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // the dq kernel's maps: q-side boxes of Q_BQ rows, kv-side of Q_BK
  err = make_map(&tq, q, D, H, S, B, qs[0], qs[1], qs[2], Q_BQ);
  if (err == 0) err = make_map(&tdo, dout, D, H, S, B, S * hd, hd, D, Q_BQ);
  if (err == 0) err = make_map(&tk, k, D, KV, Tk, B, ks[0], ks[1], ks[2], Q_BK);
  if (err == 0) err = make_map(&tv, v, D, KV, Tk, B, vs[0], vs[1], vs[2], Q_BK);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(attn_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           QCfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + Q_BQ - 1) / Q_BQ;
  blocks = static_cast<long long>(n_qt) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_bwd_dq_sm90<D><<<static_cast<unsigned>(blocks), NT, QCfg<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), S, S_pad, Tk, H, KV, B,
      n_qt, scale, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

// ---- head dim 256 (after FlashAttention-3's head-dim-256 backward) ----
// At d 256 the d 64/128 tiles do not fit: a consumer warpgroup's dK and dV
// for 64 kv rows would take 2 x 64 x 256 fp32 / 128 threads = 256 registers a
// thread (the limit is 255, consumers get 240), and K and V at 128 kv rows
// plus two stages of Q and dO take 256 KB of shared memory (227 KB a block).
// So every tile is 64 rows, and the two consumer warpgroups split the work
// along d and along the 64 columns of the products:
// - attn_bwd_kv_sm90_d256: one block per (64 kv rows, q head, batch). For
//   each q tile of 64 rows, warpgroup w computes S^T and dP^T for q columns
//   32w .. 32w+31 (wgmma m64n32k16 chains, K and Q, V and dO K-major), forms
//   P^T and dS^T there and stores them as bf16 into two 64 x 64 tiles in
//   shared memory (8 KB each, in the 128-byte swizzle); after a fence and a
//   barrier of the two warpgroups, each adds dV[:, 128w ..] += P^T dO and
//   dK[:, 128w ..] += dS^T Q over all 64 q columns (m64n128k16, A = the
//   shared P^T or dS^T tile, K-major; B = dO or Q, MN-major), so it holds
//   64 x 128 of dK and of dV: 128 registers. Shared memory: K and V 64 KB,
//   two stages of Q and dO 128 KB, P^T and dS^T 16 KB, the rows 1 KB.
// - attn_bwd_dq_sm90_d256: one block per (64 q rows, q head, batch), the
//   same split: warpgroup w computes S and dP for kv columns 32w .. 32w+31,
//   stores dS (64 x 64 bf16) in shared memory, and adds dQ[:, 128w ..] +=
//   dS K over all 64 kv columns. Shared memory: Q and dO 64 KB, two stages
//   of K and V 128 KB, dS 8 KB.
// The GQA head sum, the pre pass, the masks and the loop bounds are those
// of the d 64/128 kernels; no atomics.
constexpr int R256 = 64;                    // rows of every tile at d 256
constexpr int T256_BYTES = R256 * 256 * 2;  // one 64 x 256 bf16 tile: 32 KB
constexpr int P256_BYTES = R256 * R256 * 2;  // P^T, dS^T or dS: 64 x 64 bf16, 8 KB
constexpr int ROW256_BYTES = R256 * 4;      // LSE2 or D of one q tile
constexpr int KV256_SMEM = 6 * T256_BYTES + 2 * P256_BYTES + STAGES * 2 * ROW256_BYTES + 1024;
constexpr int DQ256_SMEM = 6 * T256_BYTES + P256_BYTES + 1024;
constexpr int CONSUMER_BAR = 1;             // named barrier of the two consumer warpgroups

// Byte offset of element (row, col) of a 64 x 64 bf16 tile stored in the
// 128-byte swizzle (rows of 128 bytes; 16-byte chunk c of row r at c ^ (r % 8)),
// the layout a K-major wgmma operand reads with desc_sw128(base, 16, 1024).
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  const int byte = 2 * col;
  return static_cast<uint32_t>(row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15)));
}

__global__ void __launch_bounds__(NT, 1)
attn_bwd_kv_sm90_d256(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                      const float* __restrict__ delta, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int S, int S_pad, int Tk, int H, int KV,
                      int B, float scale, float scale_log2, int causal, int window) {
  constexpr int D = 256;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // kv, full[STAGES], empty[STAGES]

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + T256_BYTES;
  auto sq = [&](int s) { return sk + (2 + 2 * s) * T256_BYTES; };
  auto sdo = [&](int s) { return sk + (3 + 2 * s) * T256_BYTES; };
  const uint32_t sp = sk + 6 * T256_BYTES;  // P^T: kv rows x q columns
  const uint32_t sds = sp + P256_BYTES;     // dS^T
  auto srows = [&](int s) { return sds + P256_BYTES + s * 2 * ROW256_BYTES; };
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int bh = H * B;
  const int kt = static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % H;
  const int b = static_cast<int>(blockIdx.x) % bh / H;
  const int kvh = h / (H / KV);
  const int k0 = kt * R256;

  // q tiles that see a key of this kv tile; each sees one
  const int q_begin = causal ? k0 : 0;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + R256 - 1 + window);
  const int qt_begin = q_begin / R256;
  const int n_qt = (q_end + R256 - 1) / R256 - qt_begin;
  if (n_qt <= 0) {  // no q row sees these keys: this head's dK and dV rows are 0
    for (int e = threadIdx.x; e < R256 * D; e += NT) {
      const int kpos = k0 + e / D;
      if (kpos < Tk) {
        const size_t at = ((static_cast<size_t>(b) * Tk + kpos) * H + h) * D + e % D;
        dk_part[at] = 0.f;
        dv_part[at] = 0.f;
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      const size_t rows = (static_cast<size_t>(b) * H + h) * S_pad;  // this head's LSE2, D
      mbar_expect_tx(bar_kv, 2 * T256_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sk + c * R256 * BOX, &tk, bar_kv, 64 * c, kvh, k0, b);
        tma_load(sv + c * R256 * BOX, &tv, bar_kv, 64 * c, kvh, k0, b);
      }
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const int q0 = (qt_begin + i) * R256;
        mbar_expect_tx(full(s), 2 * T256_BYTES + 2 * ROW256_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sq(s) + c * R256 * BOX, &tq, full(s), 64 * c, h, q0, b);
          tma_load(sdo(s) + c * R256 * BOX, &tdo, full(s), 64 * c, h, q0, b);
        }
        bulk_load(srows(s), lse2 + rows + q0, ROW256_BYTES, full(s));
        bulk_load(srows(s) + ROW256_BYTES, delta + rows + q0, ROW256_BYTES, full(s));
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: q columns 32w.., then d columns 128w.. ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32;
    const int frow = 16 * warp + lane / 4;  // fragment rows frow, frow + 8 (kv)
    const int col0 = 2 * (lane % 4);        // fragment column in each 8
    unsigned char* sp_ptr = smem_raw + (sp - raw);
    unsigned char* sds_ptr = smem_raw + (sds - raw);

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_begin + i) * R256;
      mbar_wait(full(s), (i / STAGES) & 1);
      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x this warpgroup's 32 q columns
      float st[16], dpt[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) st[j] = dpt[j] = 0.f;
      reg_fence(st);
      reg_fence(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t slice = (kk % 4) * 32;  // 16 bf16 along the swizzled row
        const uint32_t box = (kk / 4) * R256 * BOX;
        wgmma_ss_n32(st, desc_sw128(sk + box + slice, 16, 1024),
                     desc_sw128(sq(s) + box + 32 * wg * BOX + slice, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t slice = (kk % 4) * 32;
        const uint32_t box = (kk / 4) * R256 * BOX;
        wgmma_ss_n32(dpt, desc_sw128(sv + box + slice, 16, 1024),
                     desc_sw128(sdo(s) + box + 32 * wg * BOX + slice, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T: element j is kv row frow + 8 ((j >> 1) & 1), q column
      // 32 wg + 8 (j / 4) + col0 + (j & 1); stored as bf16 pairs
      const float* lse_s = reinterpret_cast<const float*>(smem_raw + (srows(s) - raw));
      const float* d_s = lse_s + R256;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = 32 * wg + 8 * jj + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = 4 * jj + 2 * r + c;
            const int kpos = k0 + frow + 8 * r;
            const int qpos = q0 + qc + c;
            bool ok = kpos < Tk && qpos < S;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            p[c] = ok ? exp2f(st[j] * scale_log2 - (c ? l2.y : l2.x)) : 0.f;
            ds[c] = p[c] * (dpt[j] - (c ? dd.y : dd.x)) * scale;
          }
          const uint32_t off = sw128_offset(frow + 8 * r, qc);
          *reinterpret_cast<uint32_t*>(sp_ptr + off) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(sds_ptr + off) = pack_bf16(ds[0], ds[1]);
        }
      }
      fence_proxy_async();
      named_bar_sync(CONSUMER_BAR, CONSUMERS);

      // dV[:, 128 wg ..] += P^T dO and dK[:, 128 wg ..] += dS^T Q over the 64
      // q columns; dO and Q the MN-major B operand, boxes 2 wg and 2 wg + 1
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R256 / 16; ++kk)
        wgmma_ss_tb_n128(dv, desc_sw128(sp + kk * 32, 16, 1024),
                         desc_sw128(sdo(s) + 2 * wg * R256 * BOX + kk * 16 * BOX, R256 * BOX,
                                    1024));
#pragma unroll
      for (int kk = 0; kk < R256 / 16; ++kk)
        wgmma_ss_tb_n128(dk, desc_sw128(sds + kk * 32, 16, 1024),
                         desc_sw128(sq(s) + 2 * wg * R256 * BOX + kk * 16 * BOX, R256 * BOX,
                                    1024));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dv);
      reg_fence(dk);
      // both warpgroups are done with P^T and dS^T before either writes the next
      named_bar_sync(CONSUMER_BAR, CONSUMERS);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: this head's dK and dV rows, d columns 128 wg .., fp32 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k0 + frow + 8 * r;
      if (kpos < Tk) {
        const size_t at = ((static_cast<size_t>(b) * Tk + kpos) * H + h) * D + 128 * wg;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          *reinterpret_cast<float2*>(dk_part + at + 8 * jj + col0) =
              make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_part + at + 8 * jj + col0) =
              make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_sm90_d256(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
                      int S_pad, int Tk, int H, int KV, int B, int n_qt, float scale,
                      float scale_log2, int causal, int window) {
  constexpr int D = 256;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[STAGES], empty[STAGES]

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sdo = sq + T256_BYTES;
  auto sk = [&](int s) { return sq + (2 + 2 * s) * T256_BYTES; };
  auto sv = [&](int s) { return sq + (3 + 2 * s) * T256_BYTES; };
  const uint32_t sds = sq + 6 * T256_BYTES;  // dS: q rows x kv columns
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int bh = H * B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;  // last q tile first
  const int h = static_cast<int>(blockIdx.x) % bh % H;
  const int b = static_cast<int>(blockIdx.x) % bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * R256;

  // kv tiles this q tile can see
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + R256, S));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / R256;
  const int n_tiles = max(0, (k_end + R256 - 1) / R256 - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * T256_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sq + c * R256 * BOX, &tq, bar_q, 64 * c, h, q0, b);
        tma_load(sdo + c * R256 * BOX, &tdo, bar_q, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const int k0 = (kt_begin + i) * R256;
        mbar_expect_tx(full(s), 2 * T256_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk(s) + c * R256 * BOX, &tk, full(s), 64 * c, kvh, k0, b);
          tma_load(sv(s) + c * R256 * BOX, &tv, full(s), 64 * c, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: kv columns 32w.., then d columns 128w.. ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32;
    const int frow = 16 * warp + lane / 4;  // fragment rows frow, frow + 8 (q)
    const int col0 = 2 * (lane % 4);        // fragment column in each 8
    unsigned char* sds_ptr = smem_raw + (sds - raw);

    // this thread's two rows' LSE2 and D
    const size_t rows = (static_cast<size_t>(b) * H + h) * S_pad;
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + frow + 8 * r;
      l2[r] = qpos < S ? lse2[rows + qpos] : 0.f;
      dd[r] = qpos < S ? delta[rows + qpos] : 0.f;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_begin + i) * R256;
      mbar_wait(full(s), (i / STAGES) & 1);
      // S = Q K^T and dP = dO V^T: 64 q rows x this warpgroup's 32 kv columns
      float sc[16], dp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) sc[j] = dp[j] = 0.f;
      reg_fence(sc);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t slice = (kk % 4) * 32;
        const uint32_t box = (kk / 4) * R256 * BOX;
        wgmma_ss_n32(sc, desc_sw128(sq + box + slice, 16, 1024),
                     desc_sw128(sk(s) + box + 32 * wg * BOX + slice, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t slice = (kk % 4) * 32;
        const uint32_t box = (kk / 4) * R256 * BOX;
        wgmma_ss_n32(dp, desc_sw128(sdo + box + slice, 16, 1024),
                     desc_sw128(sv(s) + box + 32 * wg * BOX + slice, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // dS: element j is q row frow + 8 ((j >> 1) & 1), kv column
      // 32 wg + 8 (j / 4) + col0 + (j & 1); stored as bf16 pairs
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kc = 32 * wg + 8 * jj + col0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = 4 * jj + 2 * r + c;
            const int kpos = k0 + kc + c;
            const int qpos = q0 + frow + 8 * r;
            bool ok = kpos < Tk && qpos < S;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            const float p = ok ? exp2f(sc[j] * scale_log2 - l2[r]) : 0.f;
            ds[c] = p * (dp[j] - dd[r]) * scale;
          }
          *reinterpret_cast<uint32_t*>(sds_ptr + sw128_offset(frow + 8 * r, kc)) =
              pack_bf16(ds[0], ds[1]);
        }
      }
      fence_proxy_async();
      named_bar_sync(CONSUMER_BAR, CONSUMERS);

      // dQ[:, 128 wg ..] += dS K over the 64 kv columns; K the MN-major B operand
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R256 / 16; ++kk)
        wgmma_ss_tb_n128(acc, desc_sw128(sds + kk * 32, 16, 1024),
                         desc_sw128(sk(s) + 2 * wg * R256 * BOX + kk * 16 * BOX, R256 * BOX,
                                    1024));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      named_bar_sync(CONSUMER_BAR, CONSUMERS);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: dQ rows, d columns 128 wg .., in bf16 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + frow + 8 * r;
      if (qpos < S) {
        __nv_bfloat16* orow = dq + ((static_cast<size_t>(b) * S + qpos) * H + h) * D + 128 * wg;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

int launch256(const void* q, const void* k, const void* v, const void* dout, const float* lse2,
              const float* delta, void* dq, float* dk_part, float* dv_part, int B, int S,
              int S_pad, int Tk, int H, int KV, const long long* qs, const long long* ks,
              const long long* vs, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int D = 256;
  const long long hd = static_cast<long long>(H) * D;
  // both kernels' maps: boxes of 64 rows on every side
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, D, H, S, B, qs[0], qs[1], qs[2], R256);
  if (err == 0) err = make_map(&tdo, dout, D, H, S, B, S * hd, hd, D, R256);
  if (err == 0) err = make_map(&tk, k, D, KV, Tk, B, ks[0], ks[1], ks[2], R256);
  if (err == 0) err = make_map(&tv, v, D, KV, Tk, B, vs[0], vs[1], vs[2], R256);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_kv_sm90_d256,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, KV256_SMEM);
  if (e != cudaSuccess) return e;
  long long blocks = static_cast<long long>((Tk + R256 - 1) / R256) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_bwd_kv_sm90_d256<<<static_cast<unsigned>(blocks), NT, KV256_SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, dk_part, dv_part, S, S_pad, Tk, H, KV, B, scale,
      scale * LOG2E, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  e = cudaFuncSetAttribute(attn_bwd_dq_sm90_d256, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DQ256_SMEM);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + R256 - 1) / R256;
  blocks = static_cast<long long>(n_qt) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_bwd_dq_sm90_d256<<<static_cast<unsigned>(blocks), NT, DQ256_SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), S, S_pad, Tk, H, KV, B,
      n_qt, scale, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,D), k and v (B,T,KV,D), all bf16 with the last dim contiguous and
// the other element strides given as {batch, position, head}; o and dout
// (B,S,H,D) bf16 contiguous; lse (B,H,S) fp32; dq, dk, dv bf16 contiguous in
// the shapes of q, k, v. Scratch from the caller: dk_part and dv_part
// (B,T,H,D) fp32 and delta and lse2 (B,H,S_pad) fp32, S_pad = S rounded up to
// 64, all written here before they are read. D in {64, 128, 256}. Returns 0, the
// cudaError_t of the first launch that failed, -1 if the CUDA driver's
// cuTensorMapEncodeTiled is not found, or -(1000 + CUresult) if it refuses a
// tensor map.
extern "C" int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, float* dk_part, float* dv_part,
    float* delta, float* lse2, int B, int S, int Tk, int H, int KV, int D,
    const long long* q_strides, const long long* k_strides, const long long* v_strides,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S_pad = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  cudaError_t e = launch_pre<__nv_bfloat16>(o, dout, lse, delta, lse2, B, S, S_pad, H, D, LOG2E,
                                            st);
  if (e != cudaSuccess) return e;
  const int err =
      D == 64 ? launch<64>(q, k, v, dout, lse2, delta, dq, dk_part, dv_part, B, S, S_pad, Tk,
                           H, KV, q_strides, k_strides, v_strides, scale, causal, window, st)
      : D == 128
          ? launch<128>(q, k, v, dout, lse2, delta, dq, dk_part, dv_part, B, S, S_pad, Tk, H,
                        KV, q_strides, k_strides, v_strides, scale, causal, window, st)
          : launch256(q, k, v, dout, lse2, delta, dq, dk_part, dv_part, B, S, S_pad, Tk, H, KV,
                      q_strides, k_strides, v_strides, scale, causal, window, st);
  if (err != 0) return err;
  return launch_sum_heads<__nv_bfloat16>(dk_part, dk, dv_part, dv,
                                         static_cast<long long>(B) * Tk * KV * D, H / KV, D, st);
}
