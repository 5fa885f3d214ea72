// RG-LRU linear-recurrence scan for Hopper (sm_90a), forward and backward, bound
// to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py (`rglru_scan`,
// body `_rglru_kernel`): h_t = a_t * h_{t-1} + b_t over a, b (B, S, C) fp32,
// starting from h0 (B, C) or from zeros, writing every h_t (B, S, C) fp32.
//
// Design. The TPU grid walks (batch, channel block, time block) with the
// time blocks in order on one core and h carried in VMEM scratch between
// them. Here blocks run in no order, so one block owns a whole time line:
// one batch row and LANES = 32 channels, one warp's lanes, so every load and
// store of a time row is one coalesced 128-byte line. Its W warps split each
// time tile of W * U steps, warp w taking steps w*U .. w*U+U-1 of it, so the
// block runs W steps of the recurrence at once. Per tile:
//   1. each warp runs its U steps in registers, giving its aggregate: A_w,
//      the product of its a, and B_w, its local end value (its steps
//      scanned from its first one, as if h entered at zero);
//   2. it writes (A_w, B_w) to shared memory and waits at the barrier;
//   3. warp w folds the tile's carry through the aggregates 0 .. w-1, in
//      that order, to get its own h_in;
//   4. it runs its U steps again from h_in and stores every h;
//   5. the last warp's last h is the carry into the next tile (through
//      shared memory); the first tile's carry is h0 or zero.
// The aggregates and the carry live in two shared-memory slots used by
// alternate tiles, so one barrier per tile orders every write before its
// reads and every read before the slot's next write. No atomics, no
// waiting between blocks. The loads of tile k+1 are issued at the start of
// tile k, before its barrier, into a second set of registers, so 2U loads
// a thread are in flight while tile k is folded and rescanned. Steps past S
// load as the identity (a = 1, b = 0) and store nothing; lanes past C load
// and store nothing. Grid: ceil(C / 32) x B blocks; at the hybrid's
// training shape (2, 4096, 2560) 160 blocks of W warps.
//
// Rounding. Every product and every sum rounds apart (__fmul_rn,
// __fadd_rn: nvcc contracts nothing into an FMA), in this order: the
// aggregate A = a_i * A, B = a_i * B + b_i from A = a_first, B = b_first;
// the fold h = A_j * h + B_j; the rescan h = a_i * h + b_i (a product,
// then a sum). `rglru_scan_blocked_plain` in kernels/rglru.py repeats the
// same operations in PyTorch, so the kernel equals it to the bit and gives
// the same bits from run to run.
//
// Bound on this card: one multiply-add per 12 bytes moved (a and b read
// once, h written once), so the bytes set the least time, at 3.35 TB/s:
// 0.0751 ms at (2, 4096, 2560). A three-pass chunked scan (aggregates,
// carries, rescan) would read a and b twice (20 bytes an element) and put
// its bound 1.67x higher; the fold inside the block keeps one pass.
//
// Backward (rglru_scan_bwd). The TPU package has no backward kernel: the
// reference differentiates its associative_scan in XLA
// (src/repro/models/recurrent.py `rglru_scan`). Given a, the forward's h and
// the cotangent g of h, the gradient is the same recurrence run backward in
// time: lam_t = g_t + c_t * lam_{t+1} with c_t = a_{t+1} (0 at t = S-1),
// db_t = lam_t, da_t = lam_t * h_{t-1} (h_{-1} = h0 or zeros),
// dh0 = a_0 * lam_0. The same block shape runs it from the last tile down:
// each warp's aggregate runs its steps from its last one down (A = c_i * A,
// B = g_i + c_i * B from A = c_last, B = g_last), warp w folds the carry
// through the aggregates W-1 .. w+1 (lam = B_j + A_j * lam), and the rescan
// (lam = g_i + c_i * lam) writes db and da. Warp 0's last lam is the carry
// into the tile before; the block ends at t = 0 and writes dh0. Step t
// reads g_t, a_{t+1} and h_{t-1} at their own offsets (no flipped or
// shifted copy): 20 bytes an element in one pass, 0.125 ms at the training
// shape. `rglru_scan_backward_blocked_plain` mirrors its order to the bit.
#include <cuda_runtime.h>

#include <cstddef>

// The tile: RGLRU_*_WARPS warps of LANES channels, each warp taking
// RGLRU_*_STEPS consecutive steps. kernels/rglru.py's mirrors default to the
// same numbers (its tests read them from here). Chosen with
// tools/rglru_sweep.py on an H100 80GB HBM3 at 700 W, which times 4-32 warps
// by 4-32 steps: 8 x 16 gives the forward's best time at the training shape
// (2, 4096, 2560), 8 x 8 the backward's (fewer registers: 3 loads a step).
#ifndef RGLRU_FWD_WARPS
#define RGLRU_FWD_WARPS 8
#endif
#ifndef RGLRU_FWD_STEPS
#define RGLRU_FWD_STEPS 16
#endif
#ifndef RGLRU_BWD_WARPS
#define RGLRU_BWD_WARPS 8
#endif
#ifndef RGLRU_BWD_STEPS
#define RGLRU_BWD_STEPS 8
#endif

namespace {

constexpr int LANES = 32;  // channels a block: one warp's lanes

// a and b of steps t0 .. t0+U-1 of one channel; past S (or past C) the
// identity a = 1, b = 0
template <int U>
__device__ __forceinline__ void load_fwd(const float* ap, const float* bp, int t0, int S,
                                         int C, bool live, float (&an)[U], float (&bn)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int t = t0 + i;
    const bool ok = live && t < S;
    an[i] = ok ? ap[static_cast<size_t>(t) * C] : 1.f;
    bn[i] = ok ? bp[static_cast<size_t>(t) * C] : 0.f;
  }
}

template <int W, int U>
__global__ void __launch_bounds__(LANES * W)
rglru_scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ h0, float* __restrict__ out, int S, int C) {
  constexpr int T = W * U;
  __shared__ float agg_a[2][W][LANES], agg_b[2][W][LANES], carry[2][LANES];
  const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
  const int c = blockIdx.x * LANES + lane;
  const bool live = c < C;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  const float h_first = h0 && live ? h0[static_cast<size_t>(blockIdx.y) * C + c] : 0.f;
  const int tiles = (S + T - 1) / T;

  float an[U], bn[U];
  load_fwd<U>(ap, bp, w * U, S, C, live, an, bn);
  for (int k = 0; k < tiles; ++k) {
    float ac[U], bc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    const int t0 = k * T + w * U;
    load_fwd<U>(ap, bp, t0 + T, S, C, live, an, bn);  // tile k+1, in flight

    // 1-2: this warp's aggregate, shared
    float A = ac[0], B = bc[0];
#pragma unroll
    for (int i = 1; i < U; ++i) {
      A = __fmul_rn(ac[i], A);
      B = __fadd_rn(__fmul_rn(ac[i], B), bc[i]);
    }
    const int p = k & 1;
    agg_a[p][w][lane] = A;
    agg_b[p][w][lane] = B;
    __syncthreads();

    // 3: the carry folded through the warps before this one
    float h = k == 0 ? h_first : carry[p][lane];
    for (int j = 0; j < w; ++j)
      h = __fadd_rn(__fmul_rn(agg_a[p][j][lane], h), agg_b[p][j][lane]);

    // 4-5: the rescan; the last warp's last h carries into tile k+1
#pragma unroll
    for (int i = 0; i < U; ++i) {
      h = __fadd_rn(__fmul_rn(ac[i], h), bc[i]);
      if (live && t0 + i < S) op[static_cast<size_t>(t0 + i) * C] = h;
    }
    if (w == W - 1) carry[p ^ 1][lane] = h;
  }
}

// g_t, c_t = a_{t+1} (0 at t = S-1) and h_{t-1} (h_first at t = 0) of steps
// t0 .. t0+U-1 of one channel; past S (or past C) the identity c = 1, g = 0
template <int U>
__device__ __forceinline__ void load_bwd(const float* ap, const float* hp, const float* gp,
                                         float h_first, int t0, int S, int C, bool live,
                                         float (&gn)[U], float (&cn)[U], float (&hn)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int t = t0 + i;
    const bool ok = live && t < S;
    gn[i] = ok ? gp[static_cast<size_t>(t) * C] : 0.f;
    cn[i] = ok ? (t + 1 < S ? ap[static_cast<size_t>(t + 1) * C] : 0.f) : 1.f;
    hn[i] = ok && t >= 1 ? hp[static_cast<size_t>(t - 1) * C] : h_first;
  }
}

template <int W, int U>
__global__ void __launch_bounds__(LANES * W)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ g, const float* __restrict__ h0,
               float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
               int S, int C) {
  constexpr int T = W * U;
  __shared__ float agg_a[2][W][LANES], agg_b[2][W][LANES], carry[2][LANES];
  const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
  const int c = blockIdx.x * LANES + lane;
  const bool live = c < C;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float h_first = h0 && live ? h0[static_cast<size_t>(blockIdx.y) * C + c] : 0.f;
  const int tiles = (S + T - 1) / T;

  float gn[U], cn[U], hn[U];
  load_bwd<U>(ap, hp, gp, h_first, (tiles - 1) * T + w * U, S, C, live, gn, cn, hn);
  float lam = 0.f;
  for (int k = tiles - 1; k >= 0; --k) {
    float gc[U], cc[U], hc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      gc[i] = gn[i];
      cc[i] = cn[i];
      hc[i] = hn[i];
    }
    const int t0 = k * T + w * U;
    if (k > 0) load_bwd<U>(ap, hp, gp, h_first, t0 - T, S, C, live, gn, cn, hn);

    // this warp's aggregate, from its last step down
    float A = cc[U - 1], B = gc[U - 1];
#pragma unroll
    for (int i = U - 2; i >= 0; --i) {
      A = __fmul_rn(cc[i], A);
      B = __fadd_rn(gc[i], __fmul_rn(cc[i], B));
    }
    const int p = (tiles - 1 - k) & 1;
    agg_a[p][w][lane] = A;
    agg_b[p][w][lane] = B;
    __syncthreads();

    // the carry folded through the warps after this one, from the last down
    lam = k == tiles - 1 ? 0.f : carry[p][lane];
    for (int j = W - 1; j > w; --j)
      lam = __fadd_rn(agg_b[p][j][lane], __fmul_rn(agg_a[p][j][lane], lam));

    // the rescan; warp 0's last lam carries into tile k-1
#pragma unroll
    for (int i = U - 1; i >= 0; --i) {
      lam = __fadd_rn(gc[i], __fmul_rn(cc[i], lam));
      const int t = t0 + i;
      if (live && t < S) {
        dbp[static_cast<size_t>(t) * C] = lam;
        dap[static_cast<size_t>(t) * C] = __fmul_rn(lam, hc[i]);
      }
    }
    if (w == 0) carry[p ^ 1][lane] = lam;
  }
  if (dh0 && live && w == 0)
    dh0[static_cast<size_t>(blockIdx.y) * C + c] = __fmul_rn(ap[0], lam);
}

}  // namespace

// a, b, out (B, S, C) fp32, h0 (B, C) fp32 or null (zeros); all contiguous.
// Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b, const void* h0, void* out,
                                    int B, int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((C + LANES - 1) / LANES, B);
  rglru_scan_fwd<RGLRU_FWD_WARPS, RGLRU_FWD_STEPS>
      <<<grid, LANES * RGLRU_FWD_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const float*>(h0), static_cast<float*>(out), S, C);
  return cudaGetLastError();
}

// a, h, g, da, db (B, S, C) fp32, h0 and dh0 (B, C) fp32 or null (dh0 is
// written only when given); all contiguous. Returns the cudaError_t of the
// launch.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h, const void* g,
                                    const void* h0, void* da, void* db, void* dh0, int B,
                                    int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((C + LANES - 1) / LANES, B);
  rglru_scan_bwd<RGLRU_BWD_WARPS, RGLRU_BWD_STEPS>
      <<<grid, LANES * RGLRU_BWD_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(h),
          static_cast<const float*>(g), static_cast<const float*>(h0), static_cast<float*>(da),
          static_cast<float*>(db), static_cast<float*>(dh0), S, C);
  return cudaGetLastError();
}
