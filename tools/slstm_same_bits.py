#!/usr/bin/env python3
"""Hold the sLSTM recurrence kernels (``csrc/slstm_scan.cu`` and
``csrc/slstm_scan_bwd.cu``) to another checkout's builds of them, to the
bit, on one CUDA card.

    python3 tools/slstm_same_bits.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit. Builds this checkout's kernels (``kernels._build``) and
OTHER_CHECKOUT's two sources (``nvcc`` with the port's flags and that
``csrc/`` on the include path, into ``build/slstm_same_bits/``), binds them
by the C signatures in their sources, and on the same inputs (bf16 and fp32,
from zeros and from a state, at xlstm-1.3b's training shape (4, 1024, 8192)
and a small ragged (3, 37, 256); the forward also at the prefill's (4, 2048,
8192)) checks:

- the backward, ``slstm_scan_bwd`` against the other build: equal to the bit
  (dgx, dh0, dc0) where both take the cooperative route (fp32, PR 29's
  SIMT products and exchange); in bf16, whose products here run on tensor
  cores in thread-block clusters, the distance is reported (relative L2
  and max abs of dgx, dh0 and dc0) and ``chip_smoke.py``'s gates decide;
- this checkout's forward with saving (the ``SAVE`` build) against it without,
  h, h_n and c_n equal to the bit;
- this checkout's forward against the other build's: equal to the bit where
  the products keep their code (fp32, the SIMT products); in bf16, whose
  products run on tensor cores here, the distance is reported (relative L2
  and max abs of h and c_n) and ``chip_smoke.py``'s gates decide.

Each of the other's kernels is called with its own grid: the cooperative
grid's (the fewest channels a block, even) unless its source exports the
clusters' residency; its backward by the parameter names of its C
signature.
Prints the card's name and power limit, then one JSON line a case; exits 1
on any difference that must not be.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NH = 4
SHAPES = [(4, 1024, 8192), (3, 37, 256)]
FWD_ONLY = [(4, 2048, 8192)]


def _bind(lib, src, symbol):
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int
                   for p in (p.strip() for p in params.group(1).split(","))]
    fn.restype = ctypes.c_int
    return fn


def _names(src, symbol):
    """The parameter names of the C function ``symbol`` in ``src``."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    return [p.strip().split()[-1].lstrip("*") for p in params.group(1).split(",")]


def _other(checkout: str):
    """The other checkout's forward, its residency (or None), and its
    backward with its parameter names and its residency (or None), built
    and bound."""
    from repro_torch.kernels import _build

    csrc = os.path.join(os.path.abspath(checkout), "src", "repro_torch", "kernels", "csrc")
    out = os.path.join(ROOT, "build", "slstm_same_bits")
    os.makedirs(out, exist_ok=True)
    procs, fns = {}, {}
    for name in ("slstm_scan", "slstm_scan_bwd"):
        so = os.path.join(out, f"other_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}.cu:\n{log}")
        src = open(os.path.join(csrc, f"{name}.cu")).read()
        fns[name] = (ctypes.CDLL(so), src)
    lib, src = fns["slstm_scan"]
    clusters = "repro_slstm_scan_clusters" in src
    fwd = _bind(lib, src, "repro_slstm_scan")
    res = _bind(lib, src, "repro_slstm_scan_clusters") if clusters else None
    blib, bsrc = fns["slstm_scan_bwd"]
    bwd = (_bind(blib, bsrc, "repro_slstm_scan_bwd"), _names(bsrc, "repro_slstm_scan_bwd"),
           _bind(blib, bsrc, "repro_slstm_scan_bwd_clusters")
           if "repro_slstm_scan_bwd_clusters" in bsrc else None)
    return fwd, res, bwd


def _inputs(gen, shape, dt, with_state):
    """gx normal, r_gates at the init's scale, and h0 in (-1, 1) and c0
    normal (or None); the backward's g = the saving forward's pre-activations
    stand-in (normal), c normal fp32, dy normal, dh_n and dc_n normal (or
    None)."""
    import torch

    b, s, d4 = shape
    d, dh = d4 // 4, d4 // 4 // NH

    def randn(*size, dtype=dt):
        return torch.randn(size, generator=gen, device="cuda").to(dtype)

    gx, r = randn(b, s, d4), (randn(NH, dh, 4 * dh, dtype=torch.float32) / dh ** 0.5).to(dt)
    h0 = torch.tanh(randn(b, d, dtype=torch.float32)).to(dt) if with_state else None
    c0 = randn(b, d, dtype=torch.float32) if with_state else None
    g, c, dy = randn(b, s, d4), randn(b, s, d, dtype=torch.float32), randn(b, s, d)
    dh_n = randn(b, d) if with_state else None
    dc_n = randn(b, d, dtype=torch.float32) if with_state else None
    return (gx, r, h0, c0), (g, c, r, dy, c0, dh_n, dc_n)


def _ptr(x):
    return None if x is None else x.data_ptr()


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import slstm as sl

    print(nvidia_smi(), flush=True)
    fwd, res, bwd = _other(sys.argv[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(97)
    ok = True
    for shape in SHAPES + FWD_ONLY:
        b, s, d4 = shape
        d = d4 // 4
        for dt in (torch.bfloat16, torch.float32):
            bf16, elem = int(dt == torch.bfloat16), dt.itemsize
            for with_state in (False, True):
                (gx, r, h0, c0), bargs = _inputs(gen, shape, dt, with_state)
                row = {"shape": list(shape), "dtype": str(dt).removeprefix("torch."),
                       "state": with_state}
                # the forward: this checkout with and without saving, the other
                mine = sl.slstm_scan(gx, r, h0, c0)
                saving = sl.slstm_scan(gx, r, h0, c0, save=True)[:3]
                if res is None:
                    cpb = sl.channels_a_block(d, elem, sms, clusters=False)
                else:
                    base = sl.channels_a_block(d, elem, sms)
                    cpb = sl.plan(b, d, d // NH, elem, sms,
                                  lambda c: max(res(c, b, d, NH, base, bf16), 0))[1]
                theirs = (torch.empty_like(mine[0]), torch.empty_like(mine[1]),
                          torch.empty_like(mine[2]))
                xch = torch.empty(2 * b * d * elem // 4, dtype=torch.int64, device="cuda")
                err = fwd(gx.data_ptr(), r.data_ptr(), _ptr(h0), _ptr(c0),
                          *(x.data_ptr() for x in theirs), None, None, xch.data_ptr(), b, s, d,
                          NH, cpb, bf16, stream)
                torch.cuda.synchronize()
                same_save = all(torch.equal(a, c) for a, c in zip(mine, saving))
                same_fwd = err == 0 and all(torch.equal(a, c) for a, c in zip(mine, theirs))
                row.update(other_error=err, saving_forward_equal=same_save,
                           forward_equal_to_other=same_fwd)
                if not bf16 or err:
                    ok = ok and same_fwd
                else:
                    row["forward_distance_to_other"] = {
                        "h_rel_l2": ((mine[0].double() - theirs[0].double()).norm()
                                     / theirs[0].double().norm()).item(),
                        "h_max_abs": (mine[0].float() - theirs[0].float()).abs().max().item(),
                        "c_n_rel_l2": ((mine[2].double() - theirs[2].double()).norm()
                                       / theirs[2].double().norm()).item()}
                ok = ok and same_save
                # the backward: this checkout's wrapper against the other build
                if shape not in FWD_ONLY:
                    g, c, r_, dy, c0_, dh_n, dc_n = bargs
                    got = sl.slstm_scan_bwd(g, c, r_, dy, c0_, dh_n, dc_n, need_dh0=with_state)
                    want = (torch.empty_like(g), torch.empty_like(got[1]) if with_state else None,
                            torch.empty_like(got[2]))
                    bfn, bnames, bres = bwd
                    if bres is None:
                        grid = (1, sl.channels_a_block(d, elem, sms, clusters=False))
                    else:
                        base = sl.channels_a_block(d, elem, sms)
                        grid = sl.plan_bwd(b, d, d // NH, elem, sms,
                                           lambda cl: max(bres(cl, b, d, NH, base, bf16), 0))[:2]
                    mine_grid = sl.bwd_plan(b, d, NH, g)[:2]
                    xb = torch.empty(2 * b * d4 * elem // 4, dtype=torch.int64, device="cuda")
                    values = {"gsave": g.data_ptr(), "csave": c.data_ptr(), "c0": _ptr(c0_),
                              "r": r_.data_ptr(), "dy": dy.data_ptr(), "dh_n": _ptr(dh_n),
                              "dc_n": _ptr(dc_n), "dgx": want[0].data_ptr(),
                              "dh0": _ptr(want[1]), "dc0": want[2].data_ptr(),
                              "xch": xb.data_ptr(), "B": b, "S": s, "D": d, "nh": NH,
                              "cpb": grid[1], "cluster": grid[0], "bf16": bf16,
                              "stream": stream}
                    berr = bfn(*(values[n] for n in bnames))
                    torch.cuda.synchronize()
                    same_bwd = berr == 0 and all(
                        torch.equal(a, w) for a, w in zip(got, want) if a is not None)
                    row.update(other_bwd_error=berr, backward_equal=same_bwd,
                               backward_grids={"this": list(mine_grid), "other": list(grid)})
                    if mine_grid[0] == 1 and grid[0] == 1 or berr:
                        ok = ok and same_bwd
                    else:
                        row["backward_distance_to_other"] = {
                            f"{n}_{k}": v for n, a, w in zip(("dgx", "dh0", "dc0"), got, want)
                            if a is not None for k, v in (
                                ("rel_l2", ((a.double() - w.double()).norm()
                                            / w.double().norm()).item()),
                                ("max_abs", (a.float() - w.float()).abs().max().item()))}
                print(json.dumps(row), flush=True)
                del gx, r, h0, c0, bargs, mine, saving, theirs, xch
                torch.cuda.empty_cache()
    print(json.dumps({"all_required_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
