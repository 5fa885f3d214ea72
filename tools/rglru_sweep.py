#!/usr/bin/env python3
"""Time K3's forward and backward kernels (``csrc/rglru_scan.cu``) at several
tile shapes (warps, steps) on one CUDA card.

    python3 tools/rglru_sweep.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Builds the source once per tile shape with ``nvcc``
(``-DRGLRU_FWD_WARPS=...`` and the three other constants), all builds at
once, into ``build/rglru_sweep/``; prints each build's ptxas lines, then,
per tile shape, each kernel's time with CUDA events (inputs cycled past the
L2, the launch queue filled first, as ``chip_smoke.py`` times it) at the
hybrid's training shape (2, 4096, 2560) without h0 and the forward also at
its prefill shape (4, 4096, 2560) with h0, beside the bound, and whether
the output equals the blocked mirror at the same tile to the bit. One JSON
line per tile shape, the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = [(4, 16), (8, 8), (8, 16), (8, 32), (16, 8), (16, 16), (32, 4), (32, 8)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rglru_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru as rg

    print(nvidia_smi(), flush=True)
    out_dir = os.path.join(ROOT, "build", "rglru_sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for w, u in TILES:
        lib = os.path.join(out_dir, f"rglru_w{w}_u{u}.so")
        defs = [f"-DRGLRU_{d}_{k}={v}" for d in ("FWD", "BWD")
                for k, v in (("WARPS", w), ("STEPS", u))]
        procs[w, u] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", lib,
             str(_build.CSRC / "rglru_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, c = cs.HYB_TRAIN_X
    train = [cs._scan_inputs(gen, b, s, c)[:2] for _ in range(cs._n_sets(12 * b * s * c))]
    train_bwd = [(x, rg.rglru_scan_plain(x, y), cs._randn(gen, (b, s, c), torch.float32))
                 for x, y in train]
    pb = cs.BATCH
    prefill = [cs._scan_inputs(gen, pb, s, c) for _ in range(cs._n_sets(12 * pb * s * c))]
    bounds = {"fwd_train": cs._bound(12 * b * s * c, 2 * b * s * c, "float32")[0],
              "fwd_prefill": cs._bound(4 * (3 * pb * s * c + pb * c), 2 * pb * s * c,
                                       "float32")[0],
              "bwd_train": cs._bound(20 * b * s * c, 3 * b * s * c, "float32")[0]}
    rc = 0
    for (w, u), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        ptxas = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                 if "entry function" in ln or "Used" in ln or "spill" in ln]
        if proc.returncode != 0:
            print(json.dumps({"warps": w, "steps": u, "build_failed": log[-2000:]}))
            rc = 1
            continue
        so = ctypes.CDLL(lib)
        fwd, bwd = (getattr(so, rg.KERNELS[k][0]) for k in ("fwd", "bwd"))
        for fn, k in ((fwd, "fwd"), (bwd, "bwd")):
            fn.argtypes, fn.restype = rg.KERNELS[k][1], ctypes.c_int

        def run_fwd(x, y, h0=None, fn=fwd):
            o = torch.empty_like(x)
            err = fn(x.data_ptr(), y.data_ptr(), None if h0 is None else h0.data_ptr(),
                     o.data_ptr(), *x.shape, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return o

        def run_bwd(x, h, g, fn=bwd):
            da, db = torch.empty_like(x), torch.empty_like(x)
            err = fn(x.data_ptr(), h.data_ptr(), g.data_ptr(), None, da.data_ptr(),
                     db.data_ptr(), None, *x.shape, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return da, db

        x, y = train[0]
        equal = {"fwd": torch.equal(run_fwd(x, y), rg.rglru_scan_blocked_plain(
                     x, y, warps=w, steps=u)),
                 "bwd": all(torch.equal(p, q) for p, q in zip(
                     run_bwd(*train_bwd[0]), rg.rglru_scan_backward_blocked_plain(
                         *train_bwd[0], warps=w, steps=u)[:2]))}
        ms = {"fwd_train": cs._time_ms(run_fwd, train, 20),
              "fwd_prefill": cs._time_ms(run_fwd, prefill, 20),
              "bwd_train": cs._time_ms(run_bwd, train_bwd, 20)}
        print(json.dumps({"warps": w, "steps": u, "ptxas": ptxas,
                          "equal_to_blocked_mirror": equal, "ms": ms,
                          "bound_share": {k: bounds[k] / v for k, v in ms.items()}}),
              flush=True)
        rc |= not all(equal.values())
    return rc


if __name__ == "__main__":
    sys.exit(main())
