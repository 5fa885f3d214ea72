#!/usr/bin/env python3
"""Split the sLSTM recurrence kernel's step (``csrc/slstm_scan.cu``, the
forward without saving) by timing copies of its source with parts taken out,
on one CUDA card.

    python3 tools/slstm_variants.py [OTHER_CHECKOUT]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Writes each variant (a text edit of the source) into
``build/slstm_variants/`` and builds them all at once with ``nvcc``, the
port's flags and ``csrc/`` on the include path: the kernel as it is
(``kernel``); without the exchange of h between blocks (``noexchange``: each
block reads its own buffer and neither publishes nor waits); without the gx
loads (``nogx``: the gates' inputs are zeros); without the recurrent products
(``noproducts``); without the cell's activations (``nocell``: c and h are
taken from the gates as they are); for the clusters' source also h_{t-1}
complete at a cluster barrier instead of on each block's mbarrier
(``clusterbarrier``), clusters of at most 8 blocks (``cluster8``), every
block polling each other cluster's word itself instead of one block of
the cluster relaying it into all of it (``direct``), the bf16 cell's
activations from ``expf``, a rounded division and ``tanhf``
(``precisecell``), h_t through L2 alone, without distributed
shared memory (``l2only``), the cell's warps sending their chunks to each
block in turn (``cellsend``), the earlier grid of 128 blocks of 16
channels (``cpb16``, clusters of 2), and the kernel with each block's thread 0
summing its clock over the step's parts (``phases``: waiting for h, the
products and their barrier, the cell, the sends; printed in clock64 cycles
a step); with OTHER_CHECKOUT, that checkout's
``slstm_scan.cu`` as it is too (``other``), so that its build and this one
are timed in turns in one call. The cuts know two sources: the cooperative
grid of tagged L2 words (the earlier design) and the cluster exchange that
replaced it.
Variants without a part compute wrong values: they are timed, not checked.
Times each with CUDA events in turns (each variant, then each in reverse
order), three rounds, at (1, 65536, 8192) (long_500k's grid at batch 1) and
(4, 2048, 8192) (xlstm-1.3b's prefill), bf16 from zeros, each build at the
grid its own wrapper plans. Prints the card's name and power limit, one JSON
line a build (ptxas' registers and spills), then one a shape: the most
clusters of 16, 8, 4 and 2 blocks the card holds at once, the grids, the
least and the most ms of each variant and µs a step (its least ms over the
steps).
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 65536, 8192), (4, 2048, 8192)]
NH = 4

# (old text, new text) edits of each source, by variant
COOP = {
    "noexchange": [
        ("""      gather_words<true>(xch + size_t((t - 1) & 1) * B * words, words, B, words,
                         static_cast<unsigned int>(t), hw);""", ""),
        ("""      publish_words(reinterpret_cast<const unsigned int*>(hnew), bwords,
                    xch + size_t(t & 1) * B * words + j0 * int(sizeof(T)) / 4, words, B, nbw,
                    static_cast<unsigned int>(t + 1));""", "")],
    "nogx": [("gxv[i][q] = on ? N::to_f(g[size_t(q) * D]) : 0.0f;", "gxv[i][q] = 0.0f;")],
    "noproducts": [("products<T, ROWS, true>(rs, h_of, D, ncol, cpb, nch, dh, B, gr);", "")],
    "nocell": [("""        const float si = N::round(sigmoid(g[0])), sf = N::round(sigmoid(g[1]));
        const float tz = N::round(tanhf(g[2])), so = N::round(sigmoid(g[3]));
        const float c = __fadd_rn(__fmul_rn(sf, creg[i]), N::round(__fmul_rn(si, tz)));
        creg[i] = c;
        const T h = N::from_f(__fmul_rn(so, tanhf(c)));""",
                """        const float c = g[1];
        creg[i] = c;
        const T h = N::from_f(g[0]);""")],
}
# clock64 of each block's thread 0 at the start of a step, once h_{t-1} is
# in, after the products' barrier, after the cell and, at the next step's
# start, after the sends: summed over the steps into the scratch past the
# exchange's words (four 8-byte sums a block)
PHASES = [
    ("  for (int t = 0; t < S; ++t) {\n    const int p = (t - 1) & 1;",
     "  long long ph_sum[4] = {0, 0, 0, 0}, ph_last = clock64();\n"
     "  for (int t = 0; t < S; ++t) {\n    const int p = (t - 1) & 1;\n"
     "    const long long ph0 = clock64();\n    ph_sum[3] += ph0 - ph_last;"),
    ("    // 2. the products, of the reference's einsum rounded to T",
     "    const long long ph1 = clock64();\n    ph_sum[0] += ph1 - ph0;"),
    ("    // 3. the cell\n",
     "    const long long ph2 = clock64();\n    ph_sum[1] += ph2 - ph1;\n"),
    ("    // 4. h_t in 16-byte chunks",
     "    ph_last = clock64();\n    ph_sum[2] += ph_last - ph2;\n    // 4. h_t in 16-byte chunks"),
    ("  // no block leaves while a block of its cluster may still store to it",
     "  if (threadIdx.x == 0)\n    for (int k = 0; k < 4; ++k)\n"
     "      reinterpret_cast<long long*>(xch + 2 * size_t(B) * words)[blockIdx.x * 4 + k] ="
     " ph_sum[k];"),
]
WAIT = """      if (warp == 0) {
        if (lane == 0) mbar_expect_tx(hbar(p), uint32_t(B) * rowb);
        mbar_wait(hbar(p), ((t - 1) >> 1) & 1);
      }
      __syncthreads();"""
SEND = "    st_async16(mapa(at, k), d, mapa(hbar(p), k));"
RELAY = "          for (int k = 0; k < cs; ++k) send(t - 1, row[c], u[c], d, k);"
PUSH = """    if (t + 1 < S) {
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
    }"""
CELL_SEND = """    if (t + 1 < S) {
      __syncwarp();
      constexpr int CW = 32 / VW;   // chunks of a warp's 32 pairs
      const unsigned long long tag = static_cast<unsigned long long>(t + 1) << 32;
#pragma unroll
      for (int i = 0; i < MAX_PAIRS; ++i) {
        const int p0 = i * THREADS + warp * 32;
        if (nfr > 0 && lane < 4 * CW) {
          const int p = p0 + lane / 4 * VW, b = p / cpb, jj = p % cpb;
          if (p < npairs && jj < nch)
            store_word(xch + (size_t(t & 1) * B + b) * words + 4 * ((j0 + jj) / VW) + lane % 4,
                       tag | reinterpret_cast<const unsigned int*>(hnew + p)[lane % 4]);
        }
        const int p = p0 + lane * VW, b = p / cpb, jj = p % cpb;
        if (lane < CW && p < npairs && jj < nch) {
          const uint4 d = *reinterpret_cast<const uint4*>(hnew + p);
          for (int k = 0; k < cs; ++k) send(t, b, (j0 + jj) / VW, d, k);
        }
      }
    }"""
ST_CLUSTER = """__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float tanh_approx(float x) {"""
CLUSTER = {
    "noexchange": [
        ("x0 * cs < nfor;", "x0 * cs < 0;"),
        (WAIT, "      __syncthreads();"),
        ("      if (nfr > 0)\n        for (int x = threadIdx.x;",
         "      if (false)\n        for (int x = threadIdx.x;"),
        ("      if (warp < cs)\n", "      if (false)\n")],
    "nogx": [
        ("""  if (warp == FETCH_WARP && nch > 0)
    for (int t = 0; t < min(S, NST); ++t) fetch(t);""", ""),
        ("if (warp == FETCH_WARP && nch > 0 && t > 0 && t - 1 + NST < S) fetch(t - 1 + NST);", ""),
        ("if (threadIdx.x < npairs && nch > 0) mbar_wait(gbar(s), (t / NST) & 1);", ""),
        ("N::to_f(gs_t[(gate * B + b) * cpb + jj])", "0.0f")],
    "noproducts": [
        ("if (MMA && nch > 0) {", "if (false) {"),
        ("products<T, ROWS, true>(rs, h_of, hrow, ncol, cpb, nch, dh, B, gr);", "")],
    "nocell": [("""        const float si = N::round(sig(g4[0])), sf = N::round(sig(g4[1]));
        const float tz = N::round(tnh(g4[2])), so = N::round(sig(g4[3]));
        const float c = __fadd_rn(__fmul_rn(sf, creg[i]), N::round(__fmul_rn(si, tz)));
        creg[i] = c;
        const T h = N::from_f(__fmul_rn(so, tnh(c)));""",
                """        const float c = g4[1];
        creg[i] = c;
        const T h = N::from_f(g4[0]);""")],
    # h_{t-1} complete at a cluster barrier, the sends plain stores, instead
    # of st.async counted on each block's mbarrier (the first design)
    "clusterbarrier": [(SEND, "    st_cluster16(mapa(at, k), d);"),
                       ("__device__ __forceinline__ float tanh_approx(float x) {", ST_CLUSTER),
                       (WAIT, "      cluster_sync();")],
    # clusters of at most 8 blocks
    "cluster8": [("for (int cs : {16, 8, 4, 2}) {", "for (int cs : {8, 4, 2}) {")],
    # every block polls each other cluster's chunk itself, into its own
    # shared memory, instead of one block of the cluster relaying it
    "direct": [("x0 * cs < nfor;", "x0 < nfor;"),
               ("const int i = rank + cs * (x0 + c * THREADS);", "const int i = x0 + c * THREADS;"),
               (RELAY, "          *reinterpret_cast<uint4*>(smem + L.hs + (p * B + row[c]) *"
                       " (rowb + HPAD) + 16 * u[c]) = d;"),
               ("mbar_expect_tx(hbar(p), uint32_t(B) * rowb);",
                "mbar_expect_tx(hbar(p), uint32_t(B) * 16 * own_n);")],
    # the bf16 cell's activations from expf, a rounded division and tanhf
    "precisecell": [
        ("return MMA ? __fdividef(1.0f, 1.0f + __expf(-x)) : sigmoid(x);", "return sigmoid(x);"),
        ("return MMA ? tanh_approx(x) : tanhf(x);", "return tanhf(x);")],
    # h_t into the cluster's blocks through L2 too (relayed like the other
    # clusters' chunks), without its owner's sends
    "l2only": [("  const int own_lo = min(nchunk, cl * cc), own_n = min(nchunk, own_lo + cc) - own_lo;",
                "  const int own_lo = 0, own_n = 0;"),
               ("      if (warp < cs)\n", "      if (false)\n")],
    # the cell's warps send their own chunks to each block in turn, without
    # the __syncthreads before the sends
    "cellsend": [(PUSH, CELL_SEND)],
    # the source as it is at 16 channels a block (128 blocks: clusters of 2)
    "cpb16": [],
    # the kernel with thread 0's clock at the step's parts summed a block
    "phases": PHASES,
}
CUTS = {"coop": COOP, "cluster": CLUSTER}


def kind(src: str) -> str:
    """The cut set whose texts ``src`` holds."""
    for name, cuts in CUTS.items():
        if all(old in src for edits in cuts.values() for old, _ in edits):
            return name
    raise SystemExit("slstm_variants: the source matches no known cut set")


def variants(src: str) -> dict[str, str]:
    """The variants of ``src`` under its cut set."""
    out = {"kernel": src}
    for var, edits in CUTS[kind(src)].items():
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        out[var] = text
    return out


def _bind(lib: str, src_text: str):
    """``repro_slstm_scan`` of the library ``lib``, its argument types read
    from the source's C signature."""
    params = re.search(r'extern "C" int repro_slstm_scan\(([^)]*)\)', src_text)
    kinds = [p.strip() for p in params.group(1).split(",")]
    fn = ctypes.CDLL(lib).repro_slstm_scan
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in kinds]
    fn.restype = ctypes.c_int
    return fn


def grid(lib: str, src_kind: str, b: int, d: int, sms: int) -> dict:
    """The grid a build takes at (b, d) in bf16: the cooperative grid's (the fewest
    channels a block, even, one block an SM) or the clusters' (``plan``
    with the residency the build's ``repro_slstm_scan_clusters`` reports)."""
    from repro_torch.kernels import slstm as sl

    if src_kind == "coop":
        cpb = sl.channels_a_block(d, 2, sms, clusters=False)
        return {"cluster": 1, "cpb": cpb, "blocks": -(-d // cpb)}
    fn = ctypes.CDLL(lib).repro_slstm_scan_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
    base = sl.channels_a_block(d, 2, sms)
    cluster, cpb, blocks, _ = sl.plan(b, d, d // NH, 2, sms,
                                      lambda c: max(fn(c, b, d, NH, base, 1), 0))
    return {"cluster": cluster, "cpb": cpb, "blocks": blocks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("slstm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels import slstm as sl

    print(nvidia_smi(), flush=True)
    out_dir = os.path.join(ROOT, "build", "slstm_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC / "slstm_scan.cu").read_text()
    sources = {name: (text, str(_build.CSRC)) for name, text in variants(src).items()}
    kinds = dict.fromkeys(sources, kind(src))
    if len(sys.argv) > 1:
        csrc = os.path.join(os.path.abspath(sys.argv[1]), "src", "repro_torch", "kernels", "csrc")
        sources["other"] = (open(os.path.join(csrc, "slstm_scan.cu")).read(), csrc)
        kinds["other"] = kind(sources["other"][0])
    procs = {}
    for name, (text, inc) in sources.items():
        cu, lib = (os.path.join(out_dir, f"{name}.{x}") for x in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, libs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        used = [ln.split("info    : ")[-1] for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode, "ptxas": used}),
              flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        fns[name], libs[name] = _bind(lib, sources[name][0]), lib

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, s, d4 in SHAPES:
        d = d4 // 4
        dh = d // NH
        gx = torch.randn((b, s, d4), generator=gen, device="cuda").to(torch.bfloat16)
        r = (torch.randn((NH, dh, 4 * dh), generator=gen, device="cuda")
             / dh ** 0.5).to(torch.bfloat16)
        out = torch.empty((b, s, d), dtype=torch.bfloat16, device="cuda")
        h_n = torch.empty((b, d), dtype=torch.bfloat16, device="cuda")
        c_n = torch.empty((b, d), dtype=torch.float32, device="cuda")
        # the exchange's scratch: two buffers of B x D values in tagged
        # words, then the phases' four sums a block
        words = 2 * b * d // 2
        xch = torch.empty(words + 4 * 256, dtype=torch.int64, device="cuda")
        grids = {name: grid(libs[name], kinds[name], b, d, sms) for name in fns}
        resident = ctypes.CDLL(libs["kernel"]).repro_slstm_scan_clusters
        resident.argtypes, resident.restype = [ctypes.c_int] * 6, ctypes.c_int
        base = sl.channels_a_block(d, 2, sms)
        clusters_held = {cs: resident(cs, b, d, NH, base, 1) for cs in (16, 8, 4, 2)}
        if "cpb16" in grids:
            grids["cpb16"] = {"cluster": 2, "cpb": 16, "blocks": -(-d // 16)}
        if "cluster8" in grids:
            grids["cluster8"]["cluster"] = min(8, grids["cluster8"]["cluster"])

        def call(name):
            err = fns[name](gx.data_ptr(), r.data_ptr(), None, None, out.data_ptr(),
                            h_n.data_ptr(), c_n.data_ptr(), None, None, xch.data_ptr(), b, s,
                            d, NH, grids[name]["cpb"], 1,
                            torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"{name}: launch failed: cudaError {err}"

        times = {name: [] for name in fns}
        for _ in range(3):
            for name in list(fns) + list(fns)[::-1]:
                call(name)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                call(name)
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1))
        phases = None
        if "phases" in fns:
            call("phases")
            torch.cuda.synchronize()
            blocks = grids["phases"]["blocks"]
            sums = xch[words:words + 4 * blocks].view(blocks, 4).double() / s
            names = ("wait_for_h", "products_and_barrier", "cell", "send")
            phases = {"clock64_a_step_mean_over_blocks": dict(zip(names, sums.mean(0).tolist())),
                      "clock64_a_step_block0": dict(zip(names, sums[0].tolist())),
                      "clock64_a_step_max_over_blocks": dict(zip(names, sums.max(0).values.tolist()))}
        print(json.dumps({
            "shape": [b, s, d4], "dtype": "bfloat16", "clusters_held": clusters_held,
            "grid": grids, "phases": phases,
            "ms_min": {k: min(v) for k, v in times.items()},
            "ms_max": {k: max(v) for k, v in times.items()},
            "us_a_step": {k: min(v) * 1e3 / s for k, v in times.items()}}), flush=True)
        del gx, r, out, h_n, c_n, xch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
