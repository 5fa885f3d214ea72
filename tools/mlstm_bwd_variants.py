#!/usr/bin/env python3
"""Split the mLSTM backward kernel's time (``csrc/mlstm_scan_bwd.cu``, the
mma route) by timing copies of its source with parts taken out, and time it
against another checkout's backward and whole ``mlstm_backward``, in turns
in one call on one CUDA card.

    python3 tools/mlstm_bwd_variants.py [OTHER_CHECKOUT]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Writes each variant (a text edit of the source, with
``mlstm.cuh`` and ``hopper.cuh`` inlined) into
``build/mlstm_bwd_variants/`` and builds them all at once with ``nvcc`` and
the port's flags: the kernel as it is (``kernel``: the read T = k dC beside
the update); without the read (``without_read``: no chunk is read, so k is
not loaded, T not written and chunk 0 not run, the work of the earlier
kernel); the read's ``mma.sync`` taken out, its fragments still loaded
(``noread``); the update's ``mma.sync`` taken out (``noupdate``); without
the loads of q and k (``no_loads``: the stages are marked full with what
they hold); each state between chunks written a slice of rows at a
time, each before that slice's update (``state_streamed``), instead of
whole at the start of the chunk; and with clock64 marks (``phases``: the clocks warps 0 and 7 of
the first block spend in each phase of a slice and of a chunk). Variants
without a part compute wrong values: they are timed, not checked; ``phases``
and ``state_streamed`` are held to the kernel's bits.

With OTHER_CHECKOUT (for instance ``git archive`` of the parent commit
unpacked into ``build/``): that checkout's ``mlstm_scan_bwd.cu`` built with
its own headers (``other``, bound by its parameters' names: a backward that
takes no k and writes no T is called as it is); beside it ``other`` and
then torch's ``einsum`` of T = k dC on the same rows (``other_plus_torch_T``,
the product this kernel took over from ``kernels/mlstm.py::_grad_terms``);
and the whole backward, ``mlstm_backward`` of this checkout and of
OTHER_CHECKOUT's ``kernels/mlstm.py`` (loaded as a module of its own, its
kernel bound to the other build), on the same saved forward
(``whole_backward``, ``other_whole_backward``).

Times each with CUDA events in turns (each, then each in reverse order),
three rounds, at (4, 1024, 4, 1024) (xlstm-1.3b's training step) and (1,
4096, 4, 1024), bf16, as training calls the kernel: no dC, dn on the last
state, no dC0 (g and u from ``mlstm_backward``'s first pass on a normal dh).
Prints the card's name and power limit, one JSON line a build (ptxas'
registers and spills), then one a shape: the least and the most ms of each,
the phase split, and whether ``phases`` and a second call of ``kernel``
give ``kernel``'s bits. Exits 1 if a build fails or those bits differ.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 1024, 4, 1024), (1, 4096, 4, 1024)]
CSRC = "src/repro_torch/kernels/csrc"
SYMBOL = "repro_mlstm_scan_bwd"

READS = "  return j < nchunks - 1 || dCn != nullptr;"
READ_MMA = """                mma_bf16(acc[mt][nt], fa[kk][mt], fh[nt][2 * kk], fh[nt][2 * kk + 1]);
                mma_bf16(acc[mt][nt], fa[kk][mt], fl[nt][2 * kk], fl[nt][2 * kk + 1]);"""
UPDATE_MMA = """      mma_bf16(uh[st & 1], fq[st], bf[st][0], bf[st][1]);
      mma_bf16(ul[st & 1], fq[st], bf[st][2], bf[st][3]);"""
LOADS = """          mbar_expect_tx(full, (int(up) + int(rd)) * SLICE_BYTES);
          if (up) tma_load(dq, &tq, full, t * DT, hd, s0, b);
          if (rd) tma_load(dq + SLICE_BYTES, &tk, full, t * DT, hd, s0, b);
"""
KERNEL = "__global__ void __launch_bounds__(BLOCK, 1)\n    mlstm_scan_bwd_mma_kernel("
CONVERT = ("        if (rd && t + 2 < nslices)\n          convert_split(Cs, o.cs, d0 + 2 * DT, "
           "cb + 2 * (t & 1) * CB, cb + (2 * (t & 1) + 1) * CB);\n")
BARRIER = ("        // partial sum of dn written\n        named_bar_sync(1, THREADS);\n")
END = "    }\n    named_bar_sync(1, THREADS);\n    if (a.dC0) write_state("
WAIT = "        mbar_wait(full0 + 8 * s, (it / NST) & 1);\n"
STATE = """      if (j < nchunks - 1) {  // dC_j, dn_j: between chunks j and j + 1, from chunk j + 1's update
        const size_t sb = (size_t(b) * (nchunks - 1) + j) * NH + hd;
        write_state(a.dCs + sb * dh * dh, a.dns + sb * dh, Cs, o.cs, ns, dh, E, col0,
                    blockIdx.x == 0);
      }
"""
# state_streamed: the state's pointers at the chunk's start, and before
# each slice's wait the slice's rows of the state (warp w rows 4 w .. 4 w +
# 3, lane a column) and of dn
STREAMED_START = """      const size_t sb = (size_t(b) * (nchunks - 1) + j) * NH + hd;
      float* dCj = j < nchunks - 1 ? a.dCs + sb * dh * dh + col0 + lane : nullptr;
      float* dnj = j < nchunks - 1 && blockIdx.x == 0 && warp == 0 ? a.dns + sb * dh + lane
                                                                   : nullptr;
"""
STREAMED_SLICE = """        if (dCj) {
          const float4 c = *reinterpret_cast<const float4*>(Cs + lane * o.cs + d0 + 4 * warp);
          float* x = dCj + size_t(d0 + 4 * warp) * dh;
          x[0] = c.x;
          x[dh] = c.y;
          x[2 * dh] = c.z;
          x[3 * dh] = c.w;
          if (dnj) dnj[d0] = ns[d0 + lane];
        }
"""
# the phase split: (anchor, text put before it, text put after it); ph[i]
# sums the clocks of PHASES[i] of warps 0 and 7 of the first block
MARKS = [("    uint32_t gfr[ROWS / 16][4];", "    long long ph[9] = {}, c0 = 0, c1 = 0;\n", ""),
         ("      named_bar_sync(1, THREADS);  // the later chunk's", "      c0 = clock64();\n", ""),
         ("      // the read's sums: rows 32 warp", "      ph[7] += clock64() - c0;\n", ""),
         (WAIT, "        c1 = clock64();\n", "        ph[0] += (c0 = clock64()) - c1;\n"),
         ("        float u[4], xn[2];\n", "        ph[1] += (c1 = clock64()) - c0;\n", ""),
         ("        if (up) update_mma_n(u, xn, qs, gfr, ur);\n", "",
          "        ph[2] += (c0 = clock64()) - c1;\n"),
         (BARRIER, "        ph[3] += (c1 = clock64()) - c0;\n", "        ph[4] += (c0 = clock64()) - c1;\n"),
         (CONVERT, "        ph[5] += (c1 = clock64()) - c0;\n", "        ph[6] += (c0 = clock64()) - c1;\n"),
         ("      if (rd) {  // T's rows of this chunk, fp32\n", "      c1 = clock64();\n", ""),
         (END, "      ph[8] += clock64() - c1;\n", "")]
PHASES = ["wait_full", "read", "update", "dn_sums_and_arrive", "slice_barrier", "apply",
          "convert", "chunk_start", "T_write"]
STORE = ("    if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && lane == 0 && warp % 7 == 0)\n"
         "      for (int x = 0; x < 9; ++x) g_phase[warp / 7 * 9 + x] = ph[x];\n")


def _inline(src: str, mlstm_cuh: str, hopper_cuh: str) -> str:
    header = mlstm_cuh.replace('#include "hopper.cuh"', hopper_cuh)
    return src.replace('#include "mlstm.cuh"', header)


def _once(text: str, old: str, new: str, name: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"mlstm_bwd_variants: {name}: the source holds {text.count(old)} of "
                         f"{old!r}, not one")
    return text.replace(old, new)


def phases(src: str) -> str:
    """The kernel with clock64 marks: ``mlstm_bwd_phases`` reads the clocks
    warps 0 and 7 of the first block spent in each of PHASES, summed over
    the chunks."""
    text = _once(src, KERNEL, "__device__ long long g_phase[18];\n\n" + KERNEL, "phases")
    for anchor, before, after in MARKS:
        text = _once(text, anchor, before + anchor + after, "phases")
    text = _once(text, END, END.replace("    if (a.dC0)", STORE + "    if (a.dC0)"), "phases")
    return text + ('\nextern "C" int mlstm_bwd_phases(long long* out) {\n'
                   "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")


def state_streamed(src: str) -> str:
    """The kernel writing each state between chunks a slice of rows at a
    time, each before that slice's update, instead of whole at the start of
    the chunk that updates it."""
    text = _once(src, STATE, STREAMED_START, "state_streamed")
    return _once(text, WAIT, STREAMED_SLICE + WAIT, "state_streamed")


def variants(src: str) -> dict[str, str]:
    return {"kernel": src, "phases": phases(src), "state_streamed": state_streamed(src),
            "without_read": _once(src, READS, "  return false;", "without_read"),
            "noread": _once(src, READ_MMA, "                ;", "noread"),
            "noupdate": _once(src, UPDATE_MMA, "", "noupdate"),
            "no_loads": _once(src, LOADS, "          (void)dq;\n          mbar_expect_tx(full, 0);\n",
                              "no_loads")}


def _ptxas(log: str) -> list[str]:
    return [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]


def _bind(lib: str, src: str):
    """``repro_mlstm_scan_bwd`` of ``lib`` and its parameters' names."""
    params = re.search(rf'extern "C" int {SYMBOL}\(([^)]*)\)', src).group(1).split(",")
    fn = getattr(ctypes.CDLL(lib), SYMBOL)
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    fn.restype = ctypes.c_int
    return fn, [p.strip().split()[-1].lstrip("*") for p in params]


def _other_module(checkout: str, fn):
    """OTHER_CHECKOUT's ``kernels/mlstm.py`` as a module of its own, its
    backward kernel ``fn`` (its forward is not called)."""
    path = os.path.join(checkout, "src", "repro_torch", "kernels", "mlstm.py")
    spec = importlib.util.spec_from_file_location("other_mlstm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._fns[SYMBOL] = fn
    return mod


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlstm_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm as ml

    print(nvidia_smi(), flush=True)
    here = {n: (_build.CSRC / n).read_text() for n in ("mlstm_scan_bwd.cu", "mlstm.cuh",
                                                        "hopper.cuh")}
    src = _inline(here["mlstm_scan_bwd.cu"], here["mlstm.cuh"], here["hopper.cuh"])
    sources = {n: (t, str(_build.CSRC)) for n, t in variants(src).items()}
    other = sys.argv[1] if len(sys.argv) > 1 else None
    if other:
        csrc = os.path.join(os.path.abspath(other), CSRC)
        sources["other"] = (open(os.path.join(csrc, "mlstm_scan_bwd.cu")).read(), csrc)
    out_dir = os.path.join(ROOT, "build", "mlstm_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
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
    other_ml = _other_module(other, fns["other"][0]) if other else None

    gen = torch.Generator(device="cuda").manual_seed(11)
    ok = True
    for shape in SHAPES:
        b, s, nh, dh = shape
        L, nc = ml._chunks(s)
        q, k, v, i, logf, _, _ = cs._mlstm_inputs(gen, shape, torch.bfloat16, False)
        cl, h_intra, d_intra, qk = ml.mlstm_intra_terms(q, k, v, i, logf, keep_qk=True)
        h, _, _, Cs, ns = ml.mlstm_carry(q, k, v, i, cl, h_intra, d_intra, None, None, save=True)
        del h_intra
        dh_ = cs._randn(gen, shape, torch.bfloat16)
        g, u, *_ = ml._read_cotangents(q, logf, d_intra, ml.entering_n(None, ns), h, dh_,
                                       ml.bwd_group(b, nh, dh, s))
        R = (nc - 1) * L
        f32 = torch.float32
        outs = (torch.empty((b, nc - 1, nh, dh, dh), dtype=f32, device="cuda"),
                torch.empty((b, nc - 1, nh, dh), dtype=f32, device="cuda"))
        T = torch.empty((b, R, nh, dh), dtype=f32, device="cuda")
        values = {"q": q.data_ptr(), "k": k.data_ptr(), "g": g.data_ptr(), "u": u.data_ptr(),
                  "cl": cl.data_ptr(), "dCn": None, "dnn": None, "dCs": outs[0].data_ptr(),
                  "dns": outs[1].data_ptr(), "dC0": None, "dn0": None, "kdc": T.data_ptr(),
                  "B": b, "S": s, "NH": nh, "dh": dh, "bf16": 1}
        kf = k[:, :R].float().reshape(b, nc - 1, L, nh, dh)

        def launch(name):
            fn, params = fns[name]
            values["stream"] = torch.cuda.current_stream().cuda_stream
            err = fn(*(values[p] for p in params))
            assert err == 0, f"{name}: launch failed: cudaError {err}"

        def torch_T():
            return torch.einsum("bglhd,bghde->bglhe", kf, outs[0])

        saved = (q, k, v, i, logf, cl, d_intra, qk, None, None, Cs, ns, h, dh_)
        runs = {name: (lambda name=name: launch(name)) for name in fns}
        if other:
            runs["other_plus_torch_T"] = lambda: (launch("other"), torch_T())
            runs["whole_backward"] = lambda: ml.mlstm_backward(*saved)
            runs["other_whole_backward"] = lambda: other_ml.mlstm_backward(*saved)
        launch("kernel")
        want = [x.clone() for x in (*outs, T)]
        same = {}
        for name in ("kernel", "phases", "state_streamed"):
            launch(name)
            same[name] = all(torch.equal(a, w) for a, w in zip((*outs, T), want))
        ok = ok and all(same.values())
        del want
        times = {name: [] for name in runs}
        for _ in range(3):
            for name in list(runs) + list(runs)[::-1]:
                runs[name]()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                runs[name]()
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1))
        clocks = (ctypes.c_longlong * 18)()
        launch("phases")
        torch.cuda.synchronize()
        phase_fn = ctypes.CDLL(libs["phases"]).mlstm_bwd_phases
        phase_fn.argtypes, phase_fn.restype = [ctypes.c_void_p], ctypes.c_int
        assert phase_fn(ctypes.addressof(clocks)) == 0
        slices = nc * dh // ml.MMA_DT             # the chunks a block passes over
        print(json.dumps({
            "shape": list(shape), "dtype": "bfloat16", "dC_n": None, "need_state": False,
            "same_bits_as_kernel": same,
            "phase_clocks_a_slice": {f"warp{w}": {p: clocks[9 * x + j] / slices
                                                  for j, p in enumerate(PHASES)}
                                     for x, w in enumerate((0, 7))},
            "ms_min": {n: min(t) for n, t in times.items()},
            "ms_max": {n: max(t) for n, t in times.items()}}), flush=True)
        del q, k, v, i, logf, cl, d_intra, qk, h, Cs, ns, dh_, g, u, outs, T, kf, saved, runs
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
