#!/usr/bin/env python3
"""Hold the mLSTM chunk kernel's forward (``csrc/mlstm_scan.cu``) to another
checkout's build of it, to the bit, on one CUDA card.

    python3 tools/mlstm_same_bits.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Builds this checkout's kernel (``kernels._build``) and
OTHER_CHECKOUT's ``src/repro_torch/kernels/csrc/mlstm_scan.cu`` (``nvcc``
with the port's flags and that directory on the include path, into
``build/mlstm_same_bits/``), reads the other build's C signature from its
source (an older one takes no save pointers), and runs both on the same
inputs at the shapes of ``chip_smoke.py``'s ``_mlstm_checks`` but long_500k
(dh 8, 32 and 1024; bf16 and fp32; from zeros and from a state; one
chunk, a ragged last chunk, S = 1): this checkout's forward, with and
without saving the states between chunks, against the other's forward,
h, C and n equal to the bit. Prints the card's name and power limit, then
one JSON line a shape; exits 1 on any difference.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [((1, 5 * 256 + 37, 2, 8), True), ((1, 5 * 256 + 37, 2, 8), False),
          ((1, 100, 2, 8), True), ((2, 300, 4, 32), True), ((4, 2048, 4, 1024), False),
          ((4, 2048, 4, 1024), True), ((2, 1000, 4, 1024), True), ((4, 1, 4, 1024), True),
          ((4, 1024, 4, 1024), False)]


def _other(checkout: str):
    """The other checkout's kernel, built and bound: (function, number of
    pointer arguments before the sizes)."""
    from repro_torch.kernels import _build

    csrc = os.path.join(os.path.abspath(checkout), "src", "repro_torch", "kernels", "csrc")
    src = os.path.join(csrc, "mlstm_scan.cu")
    params = re.search(r'extern "C" int repro_mlstm_scan\(([^)]*)\)', open(src).read())
    kinds = [p.strip() for p in params.group(1).split(",")]
    n_ptr = next(j for j, p in enumerate(kinds) if "*" not in p)
    out = os.path.join(ROOT, "build", "mlstm_same_bits")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "other.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, src]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(so).repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in kinds]
    fn.restype = ctypes.c_int
    return fn, n_ptr


def _inputs(gen, shape, dt, with_state):
    """q, k, v normal / 2 in ``dt``, sigmoid input gates, log forget gates
    near log(sigmoid(3)), and C0, n0 (normal / 10, or zeros); on the card."""
    import torch
    import torch.nn.functional as F

    b, s, nh, dh = shape

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda")

    q, k, v = ((randn(b, s, nh, dh) * 0.5).to(dt) for _ in range(3))
    i = torch.sigmoid(randn(b, s, nh))
    logf = F.logsigmoid(randn(b, s, nh) + 3.0)
    scale = 0.1 if with_state else 0.0
    return q, k, v, i, logf, randn(b, nh, dh, dh) * scale, randn(b, nh, dh) * scale


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import mlstm as ml

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    other, n_ptr = _other(sys.argv[1])
    gen = torch.Generator(device="cuda").manual_seed(89)
    ok = True
    for shape, with_state in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, i, logf, C0, n0 = _inputs(gen, shape, dt, with_state)
            cl, h_intra, d_intra = ml.mlstm_intra_terms(q, k, v, i, logf)
            args = (q, k, v, i, cl, h_intra, d_intra, C0, n0)
            mine = ml.mlstm_carry(*args)
            saving = ml.mlstm_carry(*args, save=True)[:3]
            theirs = (torch.empty_like(q), torch.empty_like(C0), torch.empty_like(n0))
            ptrs = [x.data_ptr() for x in (*args, *theirs)] + [None] * (n_ptr - 12)
            b, s, nh, dh = shape
            err = other(*ptrs, b, s, nh, dh, int(dt == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            same = err == 0 and all(torch.equal(a, c) for a, c in zip(mine, theirs))
            same_saving = err == 0 and all(torch.equal(a, c) for a, c in zip(saving, theirs))
            ok = ok and same and same_saving
            print(json.dumps({"shape": list(shape), "state": with_state,
                              "dtype": str(dt).removeprefix("torch."),
                              "route": ml.route(dt.itemsize, dh), "other_error": err,
                              "forward_equal": same, "saving_forward_equal": same_saving}),
                  flush=True)
            del q, k, v, i, logf, C0, n0, cl, h_intra, d_intra, args, mine, saving, theirs
            torch.cuda.empty_cache()
    print(json.dumps({"all_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
