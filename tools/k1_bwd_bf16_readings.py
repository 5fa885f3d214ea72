#!/usr/bin/env python3
"""How far K1's bf16 gradients and their plain backward lie from an fp32
reference, over many random draws, on one CUDA card.

    python3 tools/k1_bwd_bf16_readings.py [draws]

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit and Triton. At ``chip_smoke.py``'s test shapes of K1
(``FA_TEST_SHAPES``, causal, without a window and with a window of 16),
for each of ``draws`` (default 20) seeded draws of bf16 q, k, v and a
cotangent: dq, dk and dv of ``ops.flash_attention`` (K1's backward kernels,
as training runs them), of ``flash_attention_bwd`` (the plain recompute in
bf16, fed with the kernel's out and LSE), and of autograd through
``flash_attention_plain`` on fp32 copies of the same inputs (the
reference). Prints, per shape and gradient, the largest error of the kernel
and of the plain backward against the reference, the largest distance
between the two, and the number of draws in which that distance exceeds
``chip_smoke.py``'s bf16 gate (2e-2 of max(1, the gradient's largest
magnitude)). One JSON line per shape, the card's name and power limit
first.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_bwd_bf16_readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.device import nvidia_smi
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.common import flash_attention_bwd

    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    print(nvidia_smi(), flush=True)
    bf = torch.bfloat16
    shapes = cs.FA_TEST_SHAPES + [(b, s, h, kv, d, t, 16)
                                  for b, s, h, kv, d, t, _ in cs.FA_TEST_SHAPES]
    for b, s, h, kv, d, t, win in shapes:
        stats = {n: {"kernel": 0.0, "flash_attention_bwd": 0.0, "between": 0.0,
                     "gate": 0.0, "draws_past_gate": 0} for n in ("dq", "dk", "dv")}
        for seed in range(draws):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q = cs._randn(gen, (b, s, h, d), bf).requires_grad_(True)
            k = cs._randn(gen, (b, t, kv, d), bf).requires_grad_(True)
            v = cs._randn(gen, (b, t, kv, d), bf).requires_grad_(True)
            dout = cs._randn(gen, (b, s, h, d), bf)
            got = torch.autograd.grad(ops.flash_attention(q, k, v, True, win),
                                      (q, k, v), dout)
            with torch.no_grad():
                out, lse = fa.flash_attention(q, k, v, causal=True, window=win)
                plain = flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                            window=win)
            q32, k32, v32 = (x.detach().float().requires_grad_(True) for x in (q, k, v))
            ref = torch.autograd.grad(fa.flash_attention_plain(
                q32, k32, v32, causal=True, window=win)[0], (q32, k32, v32),
                dout.float())
            for n, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
                st = stats[n]
                gate = cs.GRAD_TOL["bfloat16"] * max(1.0, p.float().abs().max().item())
                between = cs._max_err(a, p)
                st["kernel"] = max(st["kernel"], cs._max_err(a, r))
                st["flash_attention_bwd"] = max(st["flash_attention_bwd"],
                                                cs._max_err(p, r))
                st["between"] = max(st["between"], between)
                st["gate"] = max(st["gate"], gate)
                st["draws_past_gate"] += int(between > gate)
        print(json.dumps({"shape": [b, s, h, kv, d, t], "window": win,
                          "route": fa.bwd_route(bf, d), "draws": draws,
                          "max_abs_err_vs_fp32": stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
