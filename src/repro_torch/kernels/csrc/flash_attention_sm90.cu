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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed. A pipeline that
// has not moved for about 10 s of SM clock is a fault: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous region.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64 fp32) = A (64 x 16, K-major in shared memory) * B (64 x 16,
// K-major in shared memory)^T, or D += when scale_d is set.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128 fp32) = A (64 x 16, K-major in shared memory) * B (128 x 16,
// K-major in shared memory)^T, or D += when scale_d is set.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64 fp32) += A (64 x 16 bf16 in registers) * B (16 x 64, MN-major in
// shared memory: the transpose-B immediate is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128 fp32) += A (64 x 16 bf16 in registers) * B (16 x 128, MN-major in
// shared memory: the transpose-B immediate is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256 fp32) += A (64 x 16 bf16 in registers) * B (16 x 256, MN-major in
// shared memory: the transpose-B immediate is set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      " %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BK == 64) wgmma_ss_n64(s, da, db, acc);
  else wgmma_ss_n128(s, da, db, acc);
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

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
          mma_qk<BK>(sc, desc_sw128(sq_wg + (kk / 4) * BQ * C::BOX + slice, 16, 1024),
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
          mma_pv<D>(acc, pa[kk], desc_sw128(sv + kk * 16 * C::BOX, BK * C::BOX, 1024));
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, through the runtime, so that the
// library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map of a (batch, len, heads, D) bf16 tensor with element strides
// (sb, sl, sh, 1): dims {D, heads, len, batch}, box {64, 1, rows, 1}.
int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int len, int batch,
             long long sb, long long sl, long long sh, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + static_cast<int>(r));
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
