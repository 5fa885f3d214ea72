#!/usr/bin/env python3
"""Split the mLSTM chunk kernel's time (``csrc/mlstm_scan.cu``, the mma
route) by timing copies of its source with parts taken out, on one CUDA
card.

    python3 tools/mlstm_variants.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Writes each variant (a text edit of the source, with the update it shares
with the backward, ``csrc/mlstm.cuh``, inlined) into
``build/mlstm_variants/`` and builds them all at once with ``nvcc`` and the
port's flags: the kernel as it is; without the q and k slices' loads
(``nofetch``: each slice reads the staged data of the chunk's first);
without the read's or the update's ``mma.sync`` (``noread``, ``noupdate``)
or both; both and the loads; the update's four mma chains as one
(``one_chain``); and its loop over the chunk's rows not unrolled
(``rolled``). Variants without a part compute wrong
values: they are timed, not checked; ``one_chain`` and ``rolled`` are held
to ``mlstm_carry_plain``.
Times each with CUDA events in turns, three rounds, at (1, 65536, 4, 1024)
(256 chunks, the 128 blocks of long_500k's grid) and xlstm-1.3b's serving
shape (4, 2048, 4, 1024), bf16 from a state. One JSON line per shape (the
least and the most ms of each variant, and µs a chunk), the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 65536, 4, 1024), (4, 2048, 4, 1024)]
UPDATE = """      mma_bf16(uh[p], fk, fw[0], fw[1]);
      mma_bf16(ul[p], fk, fw[2], fw[3]);"""
READ = "for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], fa[mt], b0, b1);"
FETCH = "if (t + 1 < nslices) st.fetch(q, k, rowbase, NH, dh, lv, t + 1);"
STAGE = "if (t + 1 < nslices) st.stage(qs, ks, o.qs);"
SUM = "u[x] = __fadd_rn(__fadd_rn(uh[0][x], uh[1][x]), __fadd_rn(ul[0][x], ul[1][x]));"
LOOP = "#pragma unroll\n  for (int lk = 0; lk < ROWS; lk += 32) {"


def variants(src: str) -> dict[str, str]:
    for part in (UPDATE, READ, FETCH, STAGE, SUM, LOOP):
        assert part in src, f"the source no longer has: {part}"

    def cut(*parts):
        text = src
        for p in parts:
            text = text.replace(p, "")
        return text

    one_chain = src.replace(UPDATE, """      mma_bf16(uh[0], fk, fw[0], fw[1]);
      mma_bf16(uh[0], fk, fw[2], fw[3]);""").replace(SUM, "u[x] = uh[0][x];")
    return {"kernel": src, "nofetch": cut(FETCH, STAGE), "noread": cut(READ),
            "noupdate": cut(UPDATE), "noread_noupdate": cut(READ, UPDATE),
            "noread_noupdate_nofetch": cut(READ, UPDATE, FETCH, STAGE),
            "one_chain": one_chain,
            "rolled": src.replace(LOOP, LOOP.replace("unroll", "unroll 1"))}


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
    out_dir = os.path.join(ROOT, "build", "mlstm_variants")
    os.makedirs(out_dir, exist_ok=True)
    header = (_build.CSRC / "mlstm.cuh").read_text().replace(
        '#include "hopper.cuh"', f'#include "{_build.CSRC / "hopper.cuh"}"')
    src = (_build.CSRC / "mlstm_scan.cu").read_text().replace('#include "mlstm.cuh"', header)
    procs = {}
    for name, text in variants(src).items():
        cu, lib = (os.path.join(out_dir, f"{name}.{x}") for x in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        used = [ln.split("info    : ")[-1] for ln in log.splitlines() if "Used" in ln]
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode, "ptxas_used": used}),
              flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        fn = getattr(ctypes.CDLL(lib), ml.KERNEL[0])
        fn.argtypes, fn.restype = ml.KERNEL[1], ctypes.c_int
        fns[name] = fn

    def call(fn, args):
        q, k, v, i, cl, h_intra, d_intra, C0, n0 = args
        b, s, nh, dh = q.shape
        h = torch.empty_like(q)
        C = q.new_empty((b, nh, dh, dh), dtype=torch.float32)
        n = q.new_empty((b, nh, dh), dtype=torch.float32)
        err = fn(*(x.data_ptr() for x in (q, k, v, i, cl, h_intra, d_intra, C0, n0, h, C, n)),
                 None, None, b, s, nh, dh, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch failed: cudaError {err}"
        return h, C, n

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in SHAPES:
        args = cs._mlstm_carry_args(cs._mlstm_inputs(gen, shape, torch.bfloat16, True))
        want = ml.mlstm_carry_plain(*args)
        check = {name: [cs._rel_l2(a, b) for a, b in zip(call(fns[name], args), want)]
                 for name in ("kernel", "one_chain", "rolled")}
        times = {name: [] for name in fns}
        for _ in range(3):
            for name in list(fns) + list(fns)[::-1]:
                call(fns[name], args)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                call(fns[name], args)
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1))
        # a block runs every chunk of its row in turn; the grid takes waves
        _, blocks, _ = ml.plan(shape[0], shape[2], shape[3], 2)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = -(-shape[1] // ml.CHUNK) * -(-blocks // sms)
        print(json.dumps({
            "shape": list(shape), "rel_l2_hCn_to_plain": check,
            "ms_min": {k: min(v) for k, v in times.items()},
            "ms_max": {k: max(v) for k, v in times.items()},
            "us_a_chunk": {k: min(v) * 1e3 / per_sm for k, v in times.items()}}),
              flush=True)
        del args, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
