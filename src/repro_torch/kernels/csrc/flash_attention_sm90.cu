// Flash attention forward for Hopper (sm_90a), bf16, d in {64, 128, 256}:
// warp-specialised, TMA loads into a shared-memory ring, both products on
// the tensor cores with wgmma. Bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_attn_kernel`) for bf16 inputs; fp32 inputs and
// d in {16, 32} keep the SIMT kernel of csrc/flash_attention.cu. Same
// function: scores scaled by 1/sqrt(d) after q.k, masked scores set to the
// finite -1e30 (kv padding `kpos < T`, causal top-left `qpos >= kpos`,
// window `kpos > qpos - window`), GQA kv head h / (H / KV), online softmax
// with fp32 running max m and denominator l, output `acc / max(l, 1e-30)`
// rounded to bf16, and the per-row log-sum-exp `m + log(max(l, 1e-30))` as
// (B, H, S) fp32. Two differences in rounding, both inside the bf16
// tolerance: exp2 with scale * log2(e) folded into the scores (m is kept in
// base-2 units and the LSE written in natural log), and P rounded to bf16
// before P.V (the Pallas kernel multiplies fp32 p by v). l is summed from
// the fp32 p before that rounding, so the LSE keeps fp32 accuracy.
//
// What bounds it on this card: at the llama3-8b prefill shape (d = 128,
// 512 positions, causal) the bytes of q, k, v, out and lse just outweigh the
// bf16 tensor-core operations; at the recurrentgemma-2b shape (d = 256, 4096
// positions, window 2048) the operations inside the window do. Both need
// the tensor cores fed from shared memory without the threads copying.
//
// Design. One block per (batch, q head, 128-row q tile), 384 threads in
// three warpgroups. Warpgroup 2 is the producer: after `setmaxnreg` drops it
// to 24 registers, one thread issues TMA loads (cp.async.bulk.tensor) of the
// q tile once and of each kv tile's K and V into a 2-stage ring, each
// completing on an mbarrier ("full"); consumers hand a stage back through a
// second mbarrier ("empty", 256 arrivals). Warpgroups 0 and 1 are the
// consumers, 64 q rows each, raised to 240 registers: S = Q.K^T is one
// wgmma m64nBKk16 chain over d (both operands in shared memory), then the
// mask (only on tiles that straddle the diagonal, the window edge or the
// ragged end of T), the online softmax in registers (a row lives on the 4
// threads of a quad, so row max and row sum are two shuffles), and
// O += P.V as wgmma m64nDk16 with P taken from the S fragment as bf16
// registers (the A operand in registers) and V from shared memory. BK = 128
// kv rows per tile at d <= 128 and 64 at d = 256; shared memory is q
// (128 x d) + 2 stages x (K + V) (BK x d each): 160 KB at d = 128, 192 KB at
// d = 256, 80 KB at d = 64, opted in as dynamic shared memory. kv tiles
// wholly past the diagonal or before the window are not loaded; a consumer
// skips the products of a loaded tile that is wholly masked for its 64 rows.
// Blocks walk q tiles from the last one down (heads and batch fastest), so
// the causal blocks with the most kv tiles start first.
//
// Traps this layout has to get right:
// - The 128-byte swizzle limits a TMA box's inner dimension to 128 bytes
//   (64 bf16), so a row of d = 128 comes in 2 boxes and d = 256 in 4, each
//   box a (rows x 64) block of its own in shared memory. The wgmma
//   descriptors follow: K-major operands (Q and K) step 32 bytes along the
//   swizzled row for each k16 slice and jump a whole box every 4 slices,
//   with SBO = 1024 bytes (8 rows of 128 bytes).
// - V is MN-major for P.V: d is contiguous and d is the N dimension. Its
//   descriptor takes LBO = the byte stride between the 64-wide boxes along
//   d (BK x 128) and SBO = 1024 (8 kv rows), steps 16 kv rows (2048 bytes)
//   per k16 slice, and the instruction's transpose-B immediate is set.
//   Getting this wrong still gives finite numbers.
// - The tensor maps read the port's layouts through their strides; nothing
//   is transposed on the host: q (B,S,H,d) is the 4-d map {d, H, S, B} with
//   box {64, 1, 128, 1}, k and v (B,T,KV,d) are {d, KV, T, B} with box
//   {64, 1, BK, 1}. TMA needs 16-byte aligned base pointers and strides
//   that are multiples of 16 bytes; the Python wrapper raises on any tensor
//   that breaks this. TMA zero-fills rows past S or T, the mask handles
//   their scores, and the stores are predicated on qpos < S.
// - `setmaxnreg` is honoured only if the producer and consumer paths never
//   reconverge: the kernel splits them in one top-level if/else.
//
// Left for later: overlapping one consumer's softmax with the other's wgmma
// (ping-pong scheduling) and with its own next S product, which would hide
// the exp2 and shuffle time behind the tensor cores; a persistent grid that
// keeps one block per SM and overlaps a tile's epilogue with the next
// tile's loads, which would remove the wave tail at small shapes; and
// storing O through shared memory with TMA instead of 4-byte stores.
#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int STAGES = 2;      // kv tiles in flight
constexpr int NT = 384;        // warpgroups 0-1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;  // the -1e30 mask in base-2 units

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;      // kv rows per tile
  static constexpr int BOX = 128;                     // bytes of d per TMA box
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;         // one of K or V, one stage
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
attn_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int S, int Tk, int H, int KV, int B, int n_qt,
              float scale_log2, int causal, int window) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[STAGES], empty[STAGES]

  // the 128-byte swizzle repeats every 1024 bytes: every box starts on one
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto stage_k = [&](int s) { return sq + C::Q_BYTES + s * 2 * C::KV_BYTES; };

  const int bh = H * B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;  // last q tile first
  const int h = static_cast<int>(blockIdx.x) % bh % H;
  const int b = static_cast<int>(blockIdx.x) % bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

  // kv tiles this q tile can see
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + BQ, S));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int n_tiles = max(0, (k_end + BK - 1) / BK - kt_begin);

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
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c) tma_load(sq + c * BQ * C::BOX, &tq, bar_q, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const uint32_t sk = stage_k(s), sv = sk + C::KV_BYTES;
        const int k0 = (kt_begin + i) * BK;
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          tma_load(sk + c * BK * C::BOX, &tk, full(s), 64 * c, kvh, k0, b);
          tma_load(sv + c * BK * C::BOX, &tv, full(s), 64 * c, kvh, k0, b);
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
    const uint32_t sq_wg = sq + 64 * wg * C::BOX;  // 64 rows x 128 bytes

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG2, NEG2};   // running max, base-2 units
    float l[2] = {0.f, 0.f};     // this thread's share of the denominator

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_begin + i) * BK;
      mbar_wait(full(s), (i / STAGES) & 1);
      const bool masked_out = (causal && k0 > qb) || (window > 0 && k0 + BK - 1 <= qa - window);
      if (!masked_out) {
        const uint32_t sk = stage_k(s), sv = sk + C::KV_BYTES;
        float sc[BK / 2];
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
        reg_fence(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t slice = (kk % 4) * 32;  // 16 bf16 along the swizzled row
          wgmma_ss<BK>(sc, desc_sw128(sq_wg + (kk / 4) * BQ * C::BOX + slice, 16, 1024),
                       desc_sw128(sk + (kk / 4) * BK * C::BOX + slice, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);

        const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > qa) ||
                          (window > 0 && k0 <= qb - window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) {
            const int kpos = k0 + 8 * (j / 4) + col0 + (j & 1);
            const int qpos = row0 + 8 * ((j >> 1) & 1);
            bool ok = kpos < Tk;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            sc[j] = ok ? sc[j] * scale_log2 : NEG2;
          }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
        }
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          sc[j] = exp2f(sc[j] - m[(j >> 1) & 1]);
          rsum[(j >> 1) & 1] += sc[j];                 // fp32 p, before rounding
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];

        // the S fragment of columns 16kk..16kk+15 is the A fragment of slice kk
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(acc, pa[kk], desc_sw128(sv + kk * 16 * C::BOX, BK * C::BOX, 1024));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogue: the quad's denominators, then out and lse ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const size_t row_stride = static_cast<size_t>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos < S) {
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            o + (static_cast<size_t>(b) * S + qpos) * row_stride + static_cast<size_t>(h) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
        if (lane % 4 == 0)
          lse[(static_cast<size_t>(b) * H + h) * S + qpos] = m[r] * LN2 + logf(denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
           int Tk, int H, int KV, const long long* qs, const long long* ks,
           const long long* vs, float scale, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, H, S, B, qs[0], qs[1], qs[2], BQ);
  if (err == 0) err = make_map(&tk, k, D, KV, Tk, B, ks[0], ks[1], ks[2], C::BK);
  if (err == 0) err = make_map(&tv, v, D, KV, Tk, B, vs[0], vs[1], vs[2], C::BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_sm90<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_qt) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attn_fwd_sm90<D><<<static_cast<unsigned>(blocks), NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, Tk, H, KV, B,
      n_qt, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,D), k and v (B,T,KV,D), all bf16 with the last dim contiguous and
// the other element strides given as {batch, position, head}; o (B,S,H,D)
// bf16 contiguous, lse (B,H,S) fp32. D in {64, 128, 256}. Returns 0, a
// cudaError_t of the launch, -1 if the CUDA driver's cuTensorMapEncodeTiled is
// not found, or -(1000 + CUresult) if it refuses a tensor map.
extern "C" int repro_flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int B, int S, int Tk, int H,
                                              int KV, int D, const long long* q_strides,
                                              const long long* k_strides,
                                              const long long* v_strides, float scale,
                                              int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, Tk, H, KV, q_strides, k_strides, v_strides,
                        scale, causal, window, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, Tk, H, KV, q_strides, k_strides, v_strides,
                         scale, causal, window, st);
    case 256:
      return launch<256>(q, k, v, o, lse, B, S, Tk, H, KV, q_strides, k_strides, v_strides,
                         scale, causal, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}
