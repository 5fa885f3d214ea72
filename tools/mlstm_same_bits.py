#!/usr/bin/env python3
"""Hold the mLSTM chunk kernels (``csrc/mlstm_scan.cu``, ``csrc/mlstm_scan_bwd.cu``)
to themselves and to another checkout's builds, to the bit, on one CUDA card.

    python3 tools/mlstm_same_bits.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Builds this checkout's kernels (``kernels._build``) and
OTHER_CHECKOUT's ``mlstm_scan.cu`` and ``mlstm_scan_bwd.cu`` (``nvcc`` with
the port's flags and that directory on the include path, into
``build/mlstm_same_bits/``), reads the other forward's C signature from its
source (an older one takes no save pointers), and runs them on the same
inputs at the shapes of ``chip_smoke.py``'s ``_mlstm_checks`` but long_500k
(dh 8, 32 and 1024; bf16 and fp32; from zeros and from a state; one
chunk, a ragged last chunk, S = 1). It checks, and exits 1 on any
difference:

- this checkout's saving forward gives its forward's h, C and n, and a
  second call of each the first's;
- the backward kernel's second call gives the first's dC_j, dn_j, dC0, dn0
  and T (on random g, u and cotangents);
- on the SIMT route (fp32, and bf16 at dh 8) the forward gives the other
  checkout's h, C and n, and the backward the other checkout's backward's
  dC_j, dn_j, dC0 and dn0.

On the mma route (bf16 at dh a multiple of 32) it reports, without gating
on it, whether the forward gives the other's bits too (h, C and n apiece)
and whether the backward does (dC_j, dn_j, dC0 and dn0 apiece), with the
relative L2 from the other's where it does not. The other backward is
bound by its parameters' names, so a checkout whose backward takes no k
and writes no T (before the read joined it) is called as it is. Prints
the card's name and power limit, then one JSON line a case.
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
          ((4, 1024, 4, 1024), False),
          # dh 1024 again after dh 32: the kernel's shared bytes set anew
          ((2, 300, 4, 32), False), ((2, 1000, 4, 1024), False)]


def _other(checkout: str, name: str, symbol: str):
    """The other checkout's ``csrc/<name>.cu``, built and bound: (function,
    number of pointer arguments before the sizes, the parameters' names)."""
    from repro_torch.kernels import _build

    csrc = os.path.join(os.path.abspath(checkout), "src", "repro_torch", "kernels", "csrc")
    src = os.path.join(csrc, f"{name}.cu")
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', open(src).read())
    kinds = [p.strip() for p in params.group(1).split(",")]
    n_ptr = next(j for j, p in enumerate(kinds) if "*" not in p)
    out = os.path.join(ROOT, "build", "mlstm_same_bits")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"other_{name}.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, src],
                          capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    fn = getattr(ctypes.CDLL(so), symbol)
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in kinds]
    fn.restype = ctypes.c_int
    return fn, n_ptr, [p.split()[-1].lstrip("*") for p in kinds]


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


def _rel_l2(x, y):
    return ((x.double() - y.double()).norm() / y.double().norm().clamp_min(1e-30)).item()


def _equal(xs, ys):
    """Each pair both None or equal to the bit."""
    import torch

    return all(x is y is None or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(xs, ys))


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import mlstm as ml

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    other, n_ptr, _ = _other(sys.argv[1], "mlstm_scan", "repro_mlstm_scan")
    other_bwd, _, bwd_params = _other(sys.argv[1], "mlstm_scan_bwd", "repro_mlstm_scan_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(89)
    ok = True
    for shape, with_state in SHAPES:
        b, s, nh, dh = shape
        for dt in (torch.bfloat16, torch.float32):
            bf16 = int(dt == torch.bfloat16)
            q, k, v, i, logf, C0, n0 = _inputs(gen, shape, dt, with_state)
            cl, h_intra, d_intra = ml.mlstm_intra_terms(q, k, v, i, logf)
            args = (q, k, v, i, cl, h_intra, d_intra, C0, n0)
            mine = ml.mlstm_carry(*args)
            again = ml.mlstm_carry(*args)
            saving = ml.mlstm_carry(*args, save=True)
            saving2 = ml.mlstm_carry(*args, save=True)
            theirs = (torch.empty_like(q), torch.empty_like(C0), torch.empty_like(n0))
            ptrs = [x.data_ptr() for x in (*args, *theirs)] + [None] * (n_ptr - 12)
            err = other(*ptrs, b, s, nh, dh, bf16, stream)
            # the backward on random g, u and cotangents of the last state
            g = torch.randn(shape, generator=gen, device="cuda")
            u = torch.randn((b, s, nh), generator=gen, device="cuda")
            dCn, dnn = (C0 * 10, n0 * 10) if with_state else (None, None)
            bwd = ml.mlstm_carry_bwd(q, k, g, u, cl, dCn, dnn, need_state=with_state)
            bwd2 = ml.mlstm_carry_bwd(q, k, g, u, cl, dCn, dnn, need_state=with_state)
            their_bwd = [torch.empty_like(x) if x is not None else None for x in bwd]
            values = dict(zip(("q", "k", "g", "u", "cl", "dCn", "dnn", "dCs", "dns", "dC0",
                               "dn0", "kdc"), (q, k, g, u, cl, dCn, dnn, *their_bwd)))
            values = {n: None if x is None else x.data_ptr() for n, x in values.items()}
            values.update(B=b, S=s, NH=nh, dh=dh, bf16=bf16, stream=stream)
            err_bwd = other_bwd(*(values[n] for n in bwd_params))
            torch.cuda.synchronize()
            simt = ml.route(dt.itemsize, dh) == "simt"
            row = {"shape": list(shape), "state": with_state,
                   "dtype": str(dt).removeprefix("torch."), "route": ml.route(dt.itemsize, dh),
                   "other_error": err, "other_bwd_error": err_bwd,
                   "saving_equals_forward": _equal(saving[:3], mine),
                   "second_call_equal": _equal(again, mine) and _equal(saving2, saving),
                   "forward_equals_other": err == 0 and _equal(mine, theirs),
                   "forward_hCn_equal_other": [err == 0 and _equal([a], [c])
                                               for a, c in zip(mine, theirs)],
                   "backward_equals_other": err_bwd == 0 and _equal(bwd[:4], their_bwd[:4]),
                   "backward_dCs_dns_dC0_dn0_equal_other": [
                       err_bwd == 0 and _equal([a], [c]) for a, c in zip(bwd[:4], their_bwd)],
                   "backward_rel_l2_from_other": [
                       None if a is None or err_bwd or a.numel() == 0 else _rel_l2(a, c)
                       for a, c in zip(bwd[:4], their_bwd)],
                   "backward_second_call_equal": _equal(bwd2, bwd)}
            gated = ["saving_equals_forward", "second_call_equal",
                     "backward_second_call_equal"] + (["forward_equals_other",
                                                       "backward_equals_other"] if simt else [])
            row["ok"] = all(row[x] for x in gated)
            ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
            del q, k, v, i, logf, C0, n0, cl, h_intra, d_intra, args, mine, again, saving
            del saving2, theirs, g, u, dCn, dnn, bwd, bwd2, their_bwd
            torch.cuda.empty_cache()
    print(json.dumps({"all_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
