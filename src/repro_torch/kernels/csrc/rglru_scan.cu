// RG-LRU linear-recurrence scan for Hopper (sm_90a), forward and backward, bound
// to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py (`rglru_scan`,
// body `_rglru_kernel`): h_t = a_t * h_{t-1} + b_t over a, b (B, S, C) fp32,
// starting from h0 (B, C) or from zeros, writing every h_t (B, S, C) fp32.
//
// Design. The TPU grid walks (batch, channel block, time block) with the
// time blocks in order on one core and h carried in VMEM scratch between
// them. Here one thread owns one (batch, channel) pair and runs the whole
// time loop itself, with h in a register: threads of a warp take
// neighbouring channels, so each step's loads and store are coalesced along
// C. The loop is unrolled by U steps and double-buffered in registers: the
// loads of steps t+U .. t+2U-1 are issued before steps t .. t+U-1 are
// computed, so 2U loads of a and of b are in flight per thread while the
// dependent multiply-adds run.
//
// Rounding. nvcc contracts `a * h + b` into one FMA, which rounds once where
// the reference (and the plain PyTorch version) round the product and the
// sum apart. Over the tests' sequences the two stay within the 1e-5 scan
// tolerance of tests/test_kernels.py, so contraction is left on.
//
// Bound on this card: one multiply-add per 12 bytes moved (a and b read
// once, h written once), so the bytes set the least time, at 3.35 TB/s. At
// the serving shape (4, 4096, 2560) only 10,240 threads exist, a few warps
// per SM, too few loads in flight to reach that rate: the kernel is bound by
// memory latency. A chunked scan over time (a second pass that carries h
// across chunks) is the way to more parallelism.
//
// Backward (rglru_scan_bwd). The TPU package has no backward kernel: the
// reference differentiates its associative_scan in XLA
// (src/repro/models/recurrent.py `rglru_scan`). Given a, the forward's h and
// the cotangent g of h, the gradient is the same recurrence run backward in
// time: lam_{S-1} = g_{S-1}, lam_t = g_t + a_{t+1} * lam_{t+1}, db_t = lam_t,
// da_t = lam_t * h_{t-1} (h_{-1} = h0 or zeros), dh0 = a_0 * lam_0. Same
// layout as the forward: one thread per (batch, channel), lam in a register,
// the time loop run from S-1 down to 0 with the same U-step double-buffered
// register prefetch. Each step reads g_t, a_{t+1} and h_{t-1} at their own
// offsets and writes db_t and da_t: 20 bytes per element in one pass, with
// no flipped or shifted copy of any input. The products and sums round
// apart (__fmul_rn, __fadd_rn: no contraction), in the plain version's
// order, so the kernel gives the plain version's numbers.
// Bound: bytes, 20 per element at 3.35 TB/s (0.125 ms at the hybrid's
// training shape (2, 4096, 2560)). With 5,120 threads there, as in the
// forward, too few loads are in flight to reach that rate: it is bound by
// memory latency, like the forward (1.94x its bound at the serving shape).
// A chunked scan is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 64;  // threads (channels) per block
constexpr int U = 16;   // time steps per unrolled chunk

__global__ void __launch_bounds__(NT)
rglru_scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ h0, float* __restrict__ out, int S, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 ? h0[static_cast<size_t>(blockIdx.y) * C + c] : 0.f;

  float an[U], bn[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const bool ok = i < S;
    an[i] = ok ? ap[static_cast<size_t>(i) * C] : 0.f;
    bn[i] = ok ? bp[static_cast<size_t>(i) * C] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + U + i;
      const bool ok = t < S;
      an[i] = ok ? ap[static_cast<size_t>(t) * C] : 0.f;
      bn[i] = ok ? bp[static_cast<size_t>(t) * C] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (t0 + i < S) {  // the ragged last chunk; indices stay static
        h = ac[i] * h + bc[i];
        op[static_cast<size_t>(t0 + i) * C] = h;
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ g, const float* __restrict__ h0,
               float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
               int S, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * C + c;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float h_init = h0 ? h0[static_cast<size_t>(blockIdx.y) * C + c] : 0.f;

  // step t reads g_t, a_{t+1} (0 at t = S-1) and h_{t-1} (h_init at t = 0);
  // chunk t0 holds steps t0, t0-1, ..., t0-U+1
  float gn[U], an[U], hn[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int t = S - 1 - i;
    gn[i] = t >= 0 ? gp[static_cast<size_t>(t) * C] : 0.f;
    an[i] = t >= 0 && t + 1 < S ? ap[static_cast<size_t>(t + 1) * C] : 0.f;
    hn[i] = t >= 1 ? hp[static_cast<size_t>(t - 1) * C] : h_init;
  }
  float lam = 0.f;
  for (int t0 = S - 1; t0 >= 0; t0 -= U) {
    float gc[U], ac[U], hc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      gc[i] = gn[i];
      ac[i] = an[i];
      hc[i] = hn[i];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 - U - i;
      gn[i] = t >= 0 ? gp[static_cast<size_t>(t) * C] : 0.f;
      an[i] = t >= 0 ? ap[static_cast<size_t>(t + 1) * C] : 0.f;
      hn[i] = t >= 1 ? hp[static_cast<size_t>(t - 1) * C] : h_init;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 - i;
      if (t >= 0) {  // the ragged last chunk; indices stay static
        lam = __fadd_rn(gc[i], __fmul_rn(ac[i], lam));
        dbp[static_cast<size_t>(t) * C] = lam;
        dap[static_cast<size_t>(t) * C] = __fmul_rn(lam, hc[i]);
      }
    }
  }
  if (dh0) dh0[static_cast<size_t>(blockIdx.y) * C + c] = __fmul_rn(ap[0], lam);
}

}  // namespace

// a, b, out (B, S, C) fp32, h0 (B, C) fp32 or null (zeros); all contiguous.
// Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b, const void* h0, void* out,
                                    int B, int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((C + NT - 1) / NT, B);
  rglru_scan_fwd<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
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
  const dim3 grid((C + NT - 1) / NT, B);
  rglru_scan_bwd<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(g), static_cast<const float*>(h0), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, C);
  return cudaGetLastError();
}
