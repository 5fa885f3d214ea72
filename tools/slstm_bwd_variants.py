#!/usr/bin/env python3
"""Split the sLSTM backward kernel's step (``csrc/slstm_scan_bwd.cu``, bf16)
by timing copies of its source with parts taken out, on one CUDA card, and
time it against another checkout's build in the same call.

    python3 tools/slstm_bwd_variants.py [OTHER_CHECKOUT]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Writes each variant (a text edit of the source) into
``build/slstm_bwd_variants/`` and builds them all at once with ``nvcc``,
the port's flags and the source's ``csrc/`` on the include path. The cuts
know two sources: the cooperative grid of tagged L2 words and SIMT
products (the earlier design, ``coop``) and the thread-block clusters with
``mma.sync`` products that replaced it in bf16 (``cluster``). Of each: the
kernel as it is (``kernel``); without the exchange of dg between blocks
(``noexchange``: each block reads its own buffer, nothing is sent, stored,
polled or waited for); without the recurrent products (``noproducts``);
without the cell's activations (``nocell``: the gates' values taken as
they are); without the loads of g, c and dy (``noloads``); and the kernel
with each block's thread 0 summing its clock over the step's parts
(``phases``, clock64 cycles a step: the cell; publishing dg; taking dg of
the block's heads, in the clusters by the polls, relays and the mbarrier;
the products and their barrier). The clusters' source also: the products
in 16 k parts of both m-tiles a warp instead of 8 of one (``kp16``: 16
partial sums an output instead of 8), and the cell's activations from
``expf``, a rounded division and ``tanhf`` instead of the bf16 forward's
fast forms (``precisecell``); the stages refilled at the top of the step
by warp 15 instead of after the sends by warp 4 (``fetchtop``); the words
to L2 stored by the cell's threads instead of after the barrier that
follows the cell (``cellstore``); each relayed chunk polled and sent to
every rank in turn by one thread instead of by a half-warp, a lane a rank
(``relay1``).
With OTHER_CHECKOUT, that checkout's ``slstm_scan_bwd.cu`` and its cuts
too, named ``other`` and ``other_<cut>``, so that its build and this one
are timed in turns in one call.

Variants without a part compute wrong values: they are timed, not checked.
Times each with CUDA events in turns (each variant, then each in reverse
order), three rounds, at (4, 1024, 8192) (xlstm-1.3b's training step) and
(1, 8192, 8192) (batch 1), bf16, g and dy normal, c normal fp32, no state
and no dh0 (as training calls it), each build at the grid its own source
plans (``plan_bwd`` with the build's residency, or the cooperative grid's
16 channels a block). Prints the card's name and power limit, one JSON line
a build (ptxas' registers and spills of each kernel), then one a shape: the
grids, the phases, the least and the most ms of each variant and µs a step
(its least ms over the steps).
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 1024, 8192), (1, 8192, 8192)]
NH = 4

# the phases' sums, written past the exchange's two buffers of words
STORE_PHASES = ("  if (threadIdx.x == 0)\n    for (int k = 0; k < 4; ++k)\n"
                "      reinterpret_cast<long long*>(xch + 2 * size_t(B) * words)"
                "[blockIdx.x * 4 + k] = ph_sum[k];\n")
# (old text, new text) edits of each source, by variant
COOP = {
    "noexchange": [
        ("""    publish_words(reinterpret_cast<const unsigned int*>(dgnew), bwords,
                  xch + size_t(it & 1) * B * words + j0 * elem / 4, D * elem / 4, B * 4, nbw,
                  static_cast<unsigned int>(it + 1));""", ""),
        ("""    gather_words<false>(xch + size_t(it & 1) * B * words + size_t(h_lo) * e4 * elem / 4, words,
                        B, span * elem / 4, static_cast<unsigned int>(it + 1),
                        reinterpret_cast<unsigned int*>(dgs));""", "")],
    "noproducts": [("    products<T, ROWS, false>(rs, dg_of, span, ncol, cpb, nch, dh, B, gr);", "")],
    "nocell": [("""        const float si = N::round(sigmoid(gv[i][0])), sf = N::round(sigmoid(gv[i][1]));
        const float tz = N::round(tanhf(gv[i][2])), so = N::round(sigmoid(gv[i][3]));
        const float tc = tanhf(cv[i]);""", """        const float si = gv[i][0], sf = gv[i][1];
        const float tz = gv[i][2], so = gv[i][3];
        const float tc = cv[i];""")],
    # values that depend on t, so that nothing folds away
    "noloads": [("""      for (int q = 0; q < 4; ++q) gv[i][q] = on ? N::to_f(g[size_t(q) * D]) : 0.0f;
      cv[i] = on ? csave[bt * D + j] : 0.0f;
      cpv[i] = !on ? 0.0f : t > 0 ? csave[(bt - 1) * D + j] : c0 ? c0[size_t(b) * D + j] : 0.0f;
      dyv[i] = on ? N::to_f(dy[bt * D + j]) : 0.0f;""",
                 """      for (int q = 0; q < 4; ++q) gv[i][q] = 0.25f * (t & 3) + q + (bt & 1) + (j & 1);
      cv[i] = 0.5f * (t & 1);
      cpv[i] = 0.25f * (t & 1);
      dyv[i] = 0.125f * (t & 3);""")],
    # thread 0's clock at the step's parts, summed a block: the cell; the
    # barrier and publishing dg; issuing the loads and gathering dg with
    # its barrier; the products and their barrier
    "phases": [
        ("  for (int t = S - 1, it = 0; t >= 0; --t, ++it) {\n",
         "  long long ph_sum[4] = {0, 0, 0, 0};\n"
         "  for (int t = S - 1, it = 0; t >= 0; --t, ++it) {\n"
         "    const long long ph0 = clock64();\n"),
        ("    if (t == 0 && !dh0) break;   // dh0 not asked for: no last product\n",
         "    const long long ph1 = clock64();\n    ph_sum[0] += ph1 - ph0;\n"
         "    if (t == 0 && !dh0) break;   // dh0 not asked for: no last product\n"),
        ("    if (t > 0) load_step(t - 1);\n",
         "    const long long ph2 = clock64();\n    ph_sum[1] += ph2 - ph1;\n"
         "    if (t > 0) load_step(t - 1);\n"),
        ("    // 3. dh_rec_{t-1} in quarters\n",
         "    const long long ph3 = clock64();\n    ph_sum[2] += ph3 - ph2;\n"
         "    // 3. dh_rec_{t-1} in quarters\n"),
        ("""    products<T, ROWS, false>(rs, dg_of, span, ncol, cpb, nch, dh, B, gr);
    __syncthreads();
  }
""", """    products<T, ROWS, false>(rs, dg_of, span, ncol, cpb, nch, dh, B, gr);
    __syncthreads();
    ph_sum[3] += clock64() - ph3;
  }
"""),
        ("\n}\n\ntemplate <typename T, int ROWS>\nint launch_bwd(",
         "\n" + STORE_PHASES + "}\n\ntemplate <typename T, int ROWS>\nint launch_bwd(")],
}
WAIT = """    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(dbar(p), dg_bytes);
      mbar_wait(dbar(p), (it >> 1) & 1);
    }
    __syncthreads();
"""
ACTIVATIONS = """  const float si = N::round(sig(g4[0])), sf = N::round(sig(g4[1]));
  const float tz = N::round(tnh(g4[2])), so = N::round(sig(g4[3]));
  const float tc = tnh(c);"""
CLUSTER = {
    "noexchange": [
        ("      if (outside) {\n", "      if (false) {\n"),
        ("      if (k_first + warp <= k_last) {\n", "      if (false) {\n"),
        ("    if (npair > 0) {\n", "    if (false) {\n"),
        (WAIT, "    __syncthreads();\n")],
    "noproducts": [("    if (nch > 0) {\n      const T* buf = dgs", "    if (false) {\n      const T* buf = dgs")],
    "nocell": [(ACTIVATIONS, """  const float si = g4[0], sf = g4[1];
  const float tz = g4[2], so = g4[3];
  const float tc = c;""")],
    "noloads": [
        ("""  if (warp == FETCH_WARP && nch > 0)
    for (int it = 0; it < min(S, NST); ++it) fetch(it);""", ""),
        ("    if (warp == FETCH_WARP && nch > 0 && it + NST < S) fetch(it + NST);", ""),
        ("    if (threadIdx.x < B * cpb && nch > 0) mbar_wait(gbar(s), (it / NST) & 1);", "")],
    # thread 0's clock at the step's parts, summed a block: the cell; the
    # barrier and the sends (its L2 words and its chunks to rank 0); the
    # polls, relays and the mbarrier with the barrier after it; the
    # products and their barrier
    "phases": [
        ("  for (int it = 0; it < S; ++it) {\n    const int t = S - 1 - it, p = it & 1, s = it % NST;\n",
         "  long long ph_sum[4] = {0, 0, 0, 0};\n"
         "  for (int it = 0; it < S; ++it) {\n    const int t = S - 1 - it, p = it & 1, s = it % NST;\n"
         "    const long long ph0 = clock64();\n"),
        ("    if (t == 0 && !dh0) break;   // no dh0 asked for: no last exchange or product\n",
         "    const long long ph1 = clock64();\n    ph_sum[0] += ph1 - ph0;\n"
         "    if (t == 0 && !dh0) break;   // no dh0 asked for: no last exchange or product\n"),
        ("    // every thread read stage s in this step's cell: refill it NST steps on\n",
         "    const long long ph2 = clock64();\n    ph_sum[1] += ph2 - ph1;\n"
         "    // every thread read stage s in this step's cell: refill it NST steps on\n"),
        ("    // 4. the products dh_rec_{t-1}",
         "    const long long ph3 = clock64();\n    ph_sum[2] += ph3 - ph2;\n"
         "    // 4. the products dh_rec_{t-1}"),
        ("""        run(std::false_type());
    }
    __syncthreads();
  }
""", """        run(std::false_type());
    }
    __syncthreads();
    ph_sum[3] += clock64() - ph3;
  }
"""),
        ("  // no block leaves while a block of its cluster may still send to it\n",
         STORE_PHASES + "  // no block leaves while a block of its cluster may still send to it\n")],
    # 16 k parts of both m-tiles a warp (16 partial sums an output)
    "kp16": [("constexpr int KP = 8; ", "constexpr int KP = 16;")],
    # the cell's activations from expf, a rounded division and tanhf
    "precisecell": [("bwd_cell<T, true>(g4,", "bwd_cell<T, false>(g4,")],
    # the stages fetched but not waited for (their data races the cell)
    "nowait": [("    if (threadIdx.x < B * cpb && nch > 0) mbar_wait(gbar(s), (it / NST) & 1);", "")],
    # 16 stages
    "nst16": [("constexpr int NST = 8; ", "constexpr int NST = 16;")],
    # the stages refilled at the top of the step by warp 15 instead of
    # after the sends by warp 4
    "fetchtop": [
        ("    // every thread read stage s in this step's cell: refill it NST steps on\n"
         "    if (warp == FETCH_WARP && nch > 0 && it + NST < S) fetch(it + NST);\n", ""),
        ("    const int t = S - 1 - it, p = it & 1, s = it % NST;\n    // 1. the cell's",
         "    const int t = S - 1 - it, p = it & 1, s = it % NST;\n"
         "    if (warp == WARPS - 1 && nch > 0 && it > 0 && it - 1 + NST < S) fetch(it - 1 + NST);\n"
         "    // 1. the cell's"),
        ("  if (warp == FETCH_WARP && nch > 0)\n", "  if (warp == WARPS - 1 && nch > 0)\n")],
    # the words to L2 stored by the cell's threads (an even channel's lane
    # taking its neighbour's value by a shuffle) instead of after the
    # barrier that follows the cell
    "cellstore": [
        ("""      if (outside) {
        const unsigned long long tag = static_cast<unsigned long long>(it + 1) << 32;
        for (int x = threadIdx.x; x >> 6 < B; x += THREADS) {
          const int w = x & 15, q = x >> 4 & 3, b = x >> 6;
          if (2 * w < nch && (outside >> q & 1))
            store_word(xch + (size_t(p) * B + b) * words + (q * D + j0) / 2 + w,
                       tag | reinterpret_cast<const unsigned int*>(dgnew + (b * 4 + q) * cpb)[w]);
        }
      }
""", ""),
        ("""          dgnew[(b * 4 + q) * cpb + jj] = v;
        }
      }
    }
    if (t == 0 && !dh0) break;   // no dh0 asked for: no last exchange or product
""", """          dgnew[(b * 4 + q) * cpb + jj] = v;
          bits[q] = __bfloat16_as_ushort(v);
        }
      }
      if (outside && (t > 0 || dh0)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t next = __shfl_down_sync(0xffffffffu, bits[q], 1);
          if (on && !(jj & 1) && (outside >> q & 1))
            store_word(xch + (size_t(p) * B + b) * words + (q * D + j0 + jj) / 2,
                       tag | bits[q] | next << 16);
        }
      }
    }
    if (t == 0 && !dh0) break;   // no dh0 asked for: no last exchange or product
"""),
        ("""      const int pp = threadIdx.x + i * THREADS, b = pp / cpb, jj = pp % cpb;
      if (pp < B * cpb && jj < nch) {""", """      const int pp = threadIdx.x + i * THREADS, b = pp / cpb, jj = pp % cpb;
      const bool on = pp < B * cpb && jj < nch;
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      const unsigned long long tag = static_cast<unsigned long long>(it + 1) << 32;
      if (on) {""")],
    # a thread a relayed chunk, sending it to each rank in turn
    "relay1": [
        ("""      const int dest = lane & 15;
      for (int x = (THREADS - 1 - threadIdx.x) >> 4; x >> (2 + lb) < npair; x += THREADS / 16) {""",
         """      for (int x = THREADS - 1 - threadIdx.x; x >> (2 + lb) < npair; x += THREADS) {"""),
        ("        if (lo_of(q) <= dest && dest <= hi_of(q)) send(p, b, f, d, dest);",
         "        for (int k = lo_of(q); k <= hi_of(q); ++k) send(p, b, f, d, k);")],
}
CUTS = {"coop": COOP, "cluster": CLUSTER}
NAMES = ("cell", "publish", "take_dg", "products_and_barrier")


def kind(src: str) -> str:
    """The cut set of ``src``: the clusters' where it has their kernel."""
    return "cluster" if "slstm_scan_bwd_cluster_kernel" in src else "coop"


def variants(src: str, prefix: str = "") -> dict[str, str]:
    """The variants of ``src`` under its cut set, each name after
    ``prefix`` (the kernel as it is: ``kernel``, or the prefix alone)."""
    out = {prefix.rstrip("_") or "kernel": src}
    for var, edits in CUTS[kind(src)].items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"slstm_bwd_variants: {prefix}{var}: the source holds "
                                 f"{text.count(old)} of {old!r}, not one")
            text = text.replace(old, new)
        out[prefix + var] = text
    return out


def _params(src: str, symbol: str) -> list[str]:
    """The parameter names of the C function ``symbol`` in ``src``."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    return [p.strip().split()[-1].lstrip("*") for p in params.group(1).split(",")]


def _bind(lib: str, src: str):
    """``repro_slstm_scan_bwd`` of ``lib`` and its parameter names."""
    names = _params(src, "repro_slstm_scan_bwd")
    fn = ctypes.CDLL(lib).repro_slstm_scan_bwd
    kinds = re.search(r'extern "C" int repro_slstm_scan_bwd\(([^)]*)\)', src).group(1).split(",")
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in kinds]
    fn.restype = ctypes.c_int
    return fn, names


def grid(lib: str, src_kind: str, b: int, d: int, sms: int) -> dict:
    """The grid a build takes at (b, d) in bf16: the cooperative grid's (the
    fewest channels a block, even, one block an SM) or the clusters'
    (``plan_bwd`` with the residency the build's
    ``repro_slstm_scan_bwd_clusters`` reports)."""
    from repro_torch.kernels import slstm as sl

    if src_kind == "coop":
        cpb = sl.channels_a_block(d, 2, sms, clusters=False)
        return {"cluster": 1, "cpb": cpb, "blocks": -(-d // cpb)}
    fn = ctypes.CDLL(lib).repro_slstm_scan_bwd_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
    base = sl.channels_a_block(d, 2, sms)
    cluster, cpb, blocks, _ = sl.plan_bwd(b, d, d // NH, 2, sms,
                                          lambda c: max(fn(c, b, d, NH, base, 1), 0))
    return {"cluster": cluster, "cpb": cpb, "blocks": blocks}


def _ptxas(log: str) -> list[str]:
    """The registers and spills of each bf16 kernel from ``-Xptxas -v``
    (the kernel's name cut from its mangled one)."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"\d\d(slstm_scan_bwd(?:_cluster)?_kernel)(I13__nv_bfloat16Li(\d))?",
                              ln)
            name = found and (found.group(1) + (f"<bf16, {found.group(3)}>" if found.group(2)
                                                else "") if "__nv_bfloat16" in ln else None)
        elif name and ("Used" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split('info    : ')[-1].strip()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("slstm_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import _build

    print(nvidia_smi(), flush=True)
    out_dir = os.path.join(ROOT, "build", "slstm_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC / "slstm_scan_bwd.cu").read_text()
    sources = {n: (t, str(_build.CSRC)) for n, t in variants(src).items()}
    kinds = dict.fromkeys(sources, kind(src))
    if len(sys.argv) > 1:
        csrc = os.path.join(os.path.abspath(sys.argv[1]), "src", "repro_torch", "kernels", "csrc")
        other = open(os.path.join(csrc, "slstm_scan_bwd.cu")).read()
        for n, t in variants(other, "other_").items():
            sources[n] = (t, csrc)
            kinds[n] = kind(other)
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
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode, "ptxas": _ptxas(log)}),
              flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        fns[name], libs[name] = _bind(lib, sources[name][0]), lib

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    for b, s, d4 in SHAPES:
        d = d4 // 4
        dh = d // NH
        g = torch.randn((b, s, d4), generator=gen, device="cuda").to(bf)
        c = torch.randn((b, s, d), generator=gen, device="cuda")
        r = (torch.randn((NH, dh, 4 * dh), generator=gen, device="cuda") / dh ** 0.5).to(bf)
        dy = torch.randn((b, s, d), generator=gen, device="cuda").to(bf)
        dgx = torch.empty_like(g)
        dc0 = torch.empty((b, d), device="cuda")
        # the exchange's scratch: two buffers of B x 4D values in tagged
        # words, then the phases' four sums a block
        words = 2 * b * d4 // 2
        xch = torch.empty(words + 4 * 256, dtype=torch.int64, device="cuda")
        grids = {name: grid(libs[name], kinds[name], b, d, sms) for name in fns}

        def call(name):
            fn, params = fns[name]
            values = {"gsave": g.data_ptr(), "csave": c.data_ptr(), "c0": None,
                      "r": r.data_ptr(), "dy": dy.data_ptr(), "dh_n": None, "dc_n": None,
                      "dgx": dgx.data_ptr(), "dh0": None, "dc0": dc0.data_ptr(),
                      "xch": xch.data_ptr(), "B": b, "S": s, "D": d, "nh": NH,
                      "cpb": grids[name]["cpb"], "cluster": grids[name]["cluster"], "bf16": 1,
                      "stream": torch.cuda.current_stream().cuda_stream}
            err = fn(*(values[p] for p in params))
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
        phases = {}
        for name in (n for n in fns if n.endswith("phases")):
            call(name)
            torch.cuda.synchronize()
            blocks = grids[name]["blocks"]
            sums = xch[words:words + 4 * blocks].view(blocks, 4).double() / s
            phases[name] = {"clock64_a_step_mean_over_blocks": dict(zip(NAMES, sums.mean(0).tolist())),
                            "clock64_a_step_block0": dict(zip(NAMES, sums[0].tolist())),
                            "clock64_a_step_max_over_blocks": dict(zip(NAMES, sums.max(0).values.tolist()))}
        print(json.dumps({
            "shape": [b, s, d4], "dtype": "bfloat16", "grid": grids, "phases": phases,
            "ms_min": {k: min(v) for k, v in times.items()},
            "ms_max": {k: max(v) for k, v in times.items()},
            "us_a_step": {k: min(v) * 1e3 / s for k, v in times.items()}}), flush=True)
        del g, c, r, dy, dgx, dc0, xch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
