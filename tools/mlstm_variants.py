#!/usr/bin/env python3
"""Split the mLSTM chunk kernel's time (``csrc/mlstm_scan.cu``, the mma
route) by timing copies of its source with parts taken out or changed, and
time it against the parent design's build, on one CUDA card.

    python3 tools/mlstm_variants.py [PARENT_CHECKOUT]

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. PARENT_CHECKOUT is another checkout (for instance ``git
archive`` of the parent commit unpacked into ``build/``) whose
``mlstm_scan.cu``, ``mlstm.cuh`` and ``hopper.cuh`` are built as
``parent``; without it they come from ``git show HEAD:...``. Writes each
variant (a text edit of the source, with ``mlstm.cuh`` and ``hopper.cuh``
inlined) into ``build/mlstm_variants/`` and builds them all at once with
``nvcc`` and the port's flags: the kernel as it is; with clock64 marks
(``phases``: the clocks warps 0 and 7 of the first block spend in each
phase of a slice and of a chunk); one ring stage instead of NST
(``one_stage``); k fragments loaded 4 steps ahead of their products
instead of 1 (``ahead4``); 168 registers for every warp instead of the
producer's handed to the consumers (``regs_168``); without the loads of q
and k (``no_loads``: the stages are marked full with what they hold, the
most that sharing q and k among a head's blocks, by TMA multicast in
thread-block clusters, could save); without the read's or the update's
``mma.sync`` (``noread``, ``noupdate``); and the parent design (one block
a (row, head, 32 columns), q and k staged through registers and re-read
from L2 by every block, two barriers a slice, w v read from shared memory
every slice).
Variants without a part compute wrong values: they are timed, not checked;
the others are held to the kernel's bits.

Prints the card's name and power limit, the residency the card reports
for the kernel's blocks launched in thread-block clusters
(``clusters_held``: the most clusters of 1, 2, 4, 8 and 16 it holds at
once, read by a query added to the kernel's copy), then, at (1, 65536, 4,
1024) (256 chunks of
long_500k's grid of 128 blocks), xlstm-1.3b's serving shape (4, 2048, 4,
1024) and long_500k's (1, 524288, 4, 1024), bf16 from a state, and the
training step's saving forward at (4, 1024, 4, 1024) without one, one
JSON line a shape: each variant's least and most ms over three rounds in
turns (CUDA events), µs a chunk (the least ms over the chunks a block
runs times the waves of 132 blocks), and whether its h, C and n equal the
kernel's to the bit; before it the phase split. Exits 1 if a build fails
or a variant that should give the kernel's bits does not.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (q's shape, the SAVE build): 256 chunks of long_500k's grid, the 4 x 2048
# prefill, long_500k itself and the training step's saving forward
SHAPES = [((1, 65536, 4, 1024), False), ((4, 2048, 4, 1024), False),
          ((1, 524288, 4, 1024), False), ((4, 1024, 4, 1024), True)]
CSRC = "src/repro_torch/kernels/csrc"
READ = "mma_bf16(acc[mt][nt], fa[kk][mt], fb[nt][2 * kk], fb[nt][2 * kk + 1]);"
UPDATE = """      mma_bf16(uh[st & 1], fq[st], bf[st][0], bf[st][1]);
      mma_bf16(ul[st & 1], fq[st], bf[st][2], bf[st][3]);"""
LOADS = """          mbar_expect_tx(full, 2 * SLICE_BYTES);
          tma_load(dq, &tq, full, t * DT, hd, s0, b);
          tma_load(dq + SLICE_BYTES, &tk, full, t * DT, hd, s0, b);
"""
STAGES = "constexpr int NST = 2;"
AHEAD = "constexpr int AHEAD = 1;"
REGS = "constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;"
KERNEL = "template <bool SAVE>\n__global__ void __launch_bounds__(BLOCK, 1)"
SAME_BITS = ("one_stage", "ahead4", "regs_168", "phases")
# appended to the kernel's copy: the most clusters of cs blocks of the
# serving build at head dim dh that the card holds at once, or -cudaError_t
HELD = """
extern "C" int mlstm_clusters_held(int cs, int dh) {
  auto kern = mlstm_scan_mma_kernel<false>;
  const size_t smem = mma_layout(dh).total;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -int(err);
}
"""
# the phase split: (anchor, text put before it, text put after it); ph[i]
# sums the clocks of PHASES[i] of warps 0 and 7 of the first block
CONVERT = "        if (t + 2 < nslices) convert_slice(Cs, o.cs, d0 + 2 * DT, cb + (t & 1) * CB);\n"
MARKS = [("    uint32_t wf[ROWS / 16][4];", "    long long ph[9] = {}, c0 = 0, c1 = 0;\n", ""),
         ("      named_bar_sync(1, THREADS);  // the previous chunk's", "      c0 = clock64();\n",
          ""),
         ("      // the read's sums: rows 32 warp", "      ph[7] += clock64() - c0;\n", ""),
         ("        mbar_wait(full0 + 8 * s, (it / NST) & 1);\n", "        c0 = clock64();\n",
          "        ph[0] += (c1 = clock64()) - c0;\n"),
         ("        float u[4], xn[2];\n", "        ph[1] += (c0 = clock64()) - c1;\n", ""),
         ("        update_mma_n(u, xn, ks, wf, wn);\n", "",
          "        ph[2] += (c1 = clock64()) - c0;\n"),
         ("        // partial sum of n written\n        named_bar_sync(1, THREADS);\n",
          "        ph[3] += (c0 = clock64()) - c1;\n", "        ph[4] += (c1 = clock64()) - c0;\n"),
         (CONVERT, "        ph[5] += (c0 = clock64()) - c1;\n",
          "        ph[6] += (c1 = clock64()) - c0;\n"),
         ("      // combine: h = (h_intra + h_inter)", "      c1 = clock64();\n", ""),
         ("    named_bar_sync(1, THREADS);\n    write_state(a.C + cbase",
          "    if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && lane == 0 && warp % 7 == 0)\n"
          "      for (int x = 0; x < 9; ++x) g_phase[warp / 7 * 9 + x] = ph[x];\n", "")]
COMBINE_END = "          }\n        }\n    }\n    if (blockIdx.x + blockIdx.y"
PHASES = ["wait_full", "read", "update", "n_sums", "slice_barrier", "apply", "convert",
          "chunk_start", "combine"]


def _inline(src: str, mlstm_cuh: str, hopper_cuh: str) -> str:
    header = mlstm_cuh.replace('#include "hopper.cuh"', hopper_cuh)
    return src.replace('#include "mlstm.cuh"', header)


def _read(checkout: str | None, name: str) -> str:
    if checkout:
        with open(os.path.join(checkout, CSRC, name)) as f:
            return f.read()
    return subprocess.run(["git", "show", f"HEAD:{CSRC}/{name}"], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout


def variants(src: str) -> dict[str, str]:
    for part in (READ, UPDATE, LOADS, STAGES, AHEAD, REGS):
        assert part in src, f"the source no longer has: {part}"
    return {"kernel": src + HELD, "phases": phases(src),
            "one_stage": src.replace(STAGES, "constexpr int NST = 1;"),
            "ahead4": src.replace(AHEAD, "constexpr int AHEAD = 4;"),
            "regs_168": src.replace(REGS, "constexpr int PRODUCER_REGS = 168, CONSUMER_REGS = 168;"),
            "no_loads": src.replace(LOADS, "          (void)dq;\n          mbar_expect_tx(full, 0);\n"),
            "noread": src.replace(READ, ";"), "noupdate": src.replace(UPDATE, "")}


def phases(src: str) -> str:
    """The kernel with clock64 marks: ``mlstm_phases`` reads the clocks
    warps 0 and 7 of the first block spent in each of PHASES, summed over
    the chunks."""
    text = src.replace(KERNEL, "__device__ long long g_phase[18];\n\n" + KERNEL, 1)
    for anchor, before, after in MARKS:
        assert text.count(anchor) == 1, f"the source does not have once: {anchor}"
        text = text.replace(anchor, before + anchor + after, 1)
    assert text.count(COMBINE_END) == 1, "the combine's end moved"
    text = text.replace(COMBINE_END, COMBINE_END.replace(
        "        }\n    }\n", "        }\n      ph[8] += clock64() - c1;\n    }\n"), 1)
    return text + ('\nextern "C" int mlstm_phases(long long* out) {\n'
                   "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mlstm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm as ml

    print(nvidia_smi(), flush=True)
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    here = {n: (_build.CSRC / n).read_text() for n in ("mlstm_scan.cu", "mlstm.cuh",
                                                        "hopper.cuh")}
    texts = variants(_inline(here["mlstm_scan.cu"], here["mlstm.cuh"], here["hopper.cuh"]))
    texts["parent"] = _inline(*(_read(parent, n) for n in ("mlstm_scan.cu", "mlstm.cuh",
                                                           "hopper.cuh")))
    out_dir = os.path.join(ROOT, "build", "mlstm_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, lib = (os.path.join(out_dir, f"{name}.{x}") for x in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    fns, libs = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        used = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode, "ptxas_used": used}),
              flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(lib)
        fn = getattr(libs[name], ml.KERNEL[0])
        fn.argtypes, fn.restype = ml.KERNEL[1], ctypes.c_int
        fns[name] = fn
    held_fn = libs["kernel"].mlstm_clusters_held
    held_fn.argtypes, held_fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    print(json.dumps({"clusters_held": {c: held_fn(c, 1024) for c in (1, 2, 4, 8, 16)},
                      "dh": 1024, "smem_bytes": ml.smem_bytes(1024, 2, True),
                      "threads": ml.THREADS + 128}), flush=True)

    def call(fn, args, save):
        q, k, v, i, cl, h_intra, d_intra, C0, n0 = args
        b, s, nh, dh = q.shape
        h = torch.empty_like(q)
        C = q.new_empty((b, nh, dh, dh), dtype=torch.float32)
        n = q.new_empty((b, nh, dh), dtype=torch.float32)
        nc = -(-s // ml.CHUNK)
        saved = ((q.new_empty((b, nc - 1, nh, dh, dh), dtype=torch.float32),
                  q.new_empty((b, nc - 1, nh, dh), dtype=torch.float32)) if save
                 else (None, None))
        err = fn(*(None if x is None else x.data_ptr()
                   for x in (q, k, v, i, cl, h_intra, d_intra, C0, n0, h, C, n, *saved)),
                 b, s, nh, dh, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch failed: cudaError {err}"
        return h, C, n

    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for shape, save in SHAPES:
        inputs = cs._mlstm_inputs(gen, shape, torch.bfloat16, not save)
        if save:                       # training passes no first state
            inputs = (*inputs[:5], None, None)
        args = cs._mlstm_carry_args(inputs)
        del inputs
        want = call(fns["kernel"], args, save)
        same = {name: all(torch.equal(a, b) for a, b in zip(call(fns[name], args, save), want))
                for name in SAME_BITS}
        ok = ok and all(same.values())
        times = {name: [] for name in fns}
        for _ in range(3):
            for name in list(fns) + list(fns)[::-1]:
                call(fns[name], args, save)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                call(fns[name], args, save)
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1))
        _, blocks, _ = ml.plan(shape[0], shape[2], shape[3], 2)
        per_sm = -(-shape[1] // ml.CHUNK) * -(-blocks // sms)
        clocks = (ctypes.c_longlong * 18)()
        call(fns["phases"], args, save)
        torch.cuda.synchronize()
        assert libs["phases"].mlstm_phases(clocks) == 0
        slices = -(-shape[1] // ml.CHUNK) * shape[3] // ml.MMA_DT
        print(json.dumps({"shape": list(shape), "save": save, "phase_clocks_a_slice": {
            f"warp{w}": {p: clocks[9 * i + j] / slices for j, p in enumerate(PHASES)}
            for i, w in enumerate((0, 7))}}), flush=True)
        print(json.dumps({
            "shape": list(shape), "save": save, "blocks": blocks,
            "rel_l2_hCn_to_plain": [cs._rel_l2(a, b) for a, b in
                                    zip(want, ml.mlstm_carry_plain(*args))],
            "same_bits_as_kernel": same,
            "ms_min": {k: min(v) for k, v in times.items()},
            "ms_max": {k: max(v) for k, v in times.items()},
            "us_a_chunk": {k: min(v) * 1e3 / per_sm for k, v in times.items()}}),
              flush=True)
        del args, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
