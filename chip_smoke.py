#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (``nvcc``) and Triton. Uses ``repro_torch`` only. Phases:

1. the card's name and power limit; float32 matmuls and convolutions in full
   float32 (TF32 off);
2. build the kernels from the checkout (K1 flash attention's two sources,
   the sm90 kernel for bf16 at head dim 64-256 and the SIMT kernel for the
   rest, and K3 the RG-LRU scan, with ``nvcc`` for sm_90a, one process each,
   started together; K2 RMSNorm with Triton), report each library's
   ptxas lines and its HGMMA / UTMALDG / SYNCS instruction counts from
   ``cuobjdump -sass``, and hold each kernel against its plain version on
   the card: fp32 within 2e-5, bf16 within 2e-2, the LSE within 2e-5, the
   scan within 1e-5 (``tests/test_kernels.py``), at the tests' shapes, at
   non-causal shapes with T != S, on strided views (sm90 route) and at the
   serving shapes of both paths, each check naming its route;
3. serve llama3-8b at its published width (32 layers, d_model 4096, vocab
   128256; random weights from a seed): prefill 4 x 512 tokens, then 16
   greedy decode steps through ``repro_torch.launch.serve``, counting kernel
   launches: K1 32 per prefill (all 32 on the sm90 kernel) and 0 per decode
   step, K2 65 per step; then
   one prefill and two decode steps under ``torch.profiler``: device time by
   kernel and the card's idle share; teacher forcing at full width
   (``forward`` over 513 tokens against prefill(512) + decode(1), relative
   L2 of the last logits <= 3e-2); the reduced config on the card against
   the CPU with the same weights, logits within 3e-2 (head dim 16: K1 takes
   the SIMT kernel, no sm90 launch);
4. the same for recurrentgemma-2b at its published width (26 layers: 18
   RG-LRU and 8 local attention with window 2048, d_model 2560, head dim
   256, vocab 256000): prefill 4 x 4096 tokens (longer than the window, so
   the ring buffer wraps), 16 decode steps, launches K1 8 (all sm90) / K2
   53 / K3 18 per prefill and 0 / 53 / 0 per decode step; the profile; teacher
   forcing at batch 1 over 4097 tokens (rel. L2 <= 1e-1 with bf16
   activations, the reference's own bound, and <= 3e-2 with fp32
   activations); the reduced config (40-token prompt, window 32) on the
   card against the CPU;
5. each kernel's time at the serving shapes with CUDA events, beside its
   bound, its plain version's time and one PyTorch library call's time
   where one computes the same function (``ms`` with the launch queue
   filled first, so the card's time alone; ``host_ms`` as issued one call
   after another from Python); K1's rows also time the SIMT kernel at the
   same shapes (``previous_ms``) and give the achieved TFLOP/s and
   ``bound_ms / ms``.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` last. Exits non-zero, without that last
line, when no CUDA card is present, when run outside a checkout of the
repository, or when any phase fails.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

# H100 SXM published peaks (dense, no sparsity), at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-5
ARCH, BATCH, PROMPT, GEN = "llama3-8b", 4, 512, 16
HYB_ARCH, HYB_PROMPT = "recurrentgemma-2b", 4096
HYB = dict(h=10, kv=1, d=256, window=2048, d_model=2560)
FA_TEST_SHAPES = [(2, 128, 4, 2, 64, 128, 0), (1, 200, 8, 1, 64, 200, 0),
                  (2, 96, 4, 4, 32, 96, 32), (1, 64, 2, 2, 128, 256, 0),
                  (1, 257, 3, 3, 16, 257, 64)]
RN_TEST_SHAPES = [((4, 37, 128), "bfloat16"), ((8, 256), "float32"),
                  ((1, 1, 512), "float32"), ((7, 384), "float32"),
                  ((7, 384), "bfloat16")]
RG_TEST_SHAPES = [(2, 100, 96), (1, 257, 64), (3, 16, 300), (2, 1, 8),
                  (1, 33, 130), (3, 128, 8)]


def emit(**obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: repro_torch not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    from repro_torch.device import nvidia_smi

    card = nvidia_smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(settings={"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
                   "torch": torch.__version__, "cuda": torch.version.cuda})

    state: dict = {"card": card}
    failed = []
    phases = (phase_kernels, phase_serve, phase_profile, phase_teacher_forcing,
              phase_card_vs_cpu, phase_hybrid_serve, phase_hybrid_profile,
              phase_hybrid_teacher_forcing, phase_hybrid_card_vs_cpu, phase_times)
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:  # report the phase, run the rest, then fail
            traceback.print_exc()
            failed.append(phase.__name__)
        torch.cuda.synchronize()
        emit(phase=phase.__name__, seconds=time.perf_counter() - t0,
             ok=phase.__name__ not in failed)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit(kernels=state["kernels"])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _scan_inputs(gen, b, s, c):
    """a in [0, 0.999), b and h0 normal: the distribution of the tests."""
    import torch

    a = torch.rand((b, s, c), generator=gen, device="cuda") * 0.999
    return a, _randn(gen, (b, s, c), torch.float32), _randn(gen, (b, c),
                                                            torch.float32)


def _dtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, tol, errs):
    import torch

    err = _max_err(got, want)
    errs.append(err)
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond {tol}")
    return err


# -- phase 2 ---------------------------------------------------------------------
def phase_kernels(state):
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rmsnorm as rn

    sources = ["flash_attention_sm90", "flash_attention", "rglru_scan"]
    t0 = time.perf_counter()
    libs = _build.build(sources)
    build_s = time.perf_counter() - t0
    emit(build={f"{name}.cu": {
        "nvcc_seconds_all": build_s,
        "ptxas": [ln.split("ptxas info    : ")[-1]
                  for ln in _build.build_log(name).splitlines()
                  if "Used" in ln or "spill" in ln or "C7508" in ln],
        "sass_counts": _sass_counts(libs[name])}
        for name in sources})

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    serving_errs = {k: [] for k in ("flash_attention", "rmsnorm", "rglru_scan",
                                    "flash_attention_hybrid", "rmsnorm_hybrid")}
    hyb = (BATCH, HYB_PROMPT, HYB["h"], HYB["kv"], HYB["d"], HYB_PROMPT,
           HYB["window"])
    seq = FA_TEST_SHAPES + [(BATCH, PROMPT, 32, 8, 128, PROMPT, 0),
                            (BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0),
                            (2, 130, 4, 2, 16, 130, None),
                            (2, 200, 8, 2, 64, 300, None),
                            (1, 300, 4, 1, 128, 130, None),
                            (1, 130, 2, 1, 256, 200, None),
                            (2, 300, 10, 1, 256, 300, 128), hyb]
    for b, s, h, kv, d, t, win in seq:
        causal = win is not None
        for dn in ("float32", "bfloat16"):
            dt = _dtype(dn)
            q = _randn(gen, (b, s, h, d), dt)
            k, v = _randn(gen, (b, t, kv, d), dt), _randn(gen, (b, t, kv, d), dt)
            out, lse = fa.flash_attention(q, k, v, causal=causal, window=win or 0)
            torch.cuda.synchronize()
            p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                    window=win or 0)
            errs = []
            if dn == "bfloat16" and (b, s, h) == (BATCH, PROMPT, 32):
                errs = serving_errs["flash_attention"]
            elif dn == "bfloat16" and (b, s, h, kv, d, t, win) == hyb:
                errs = serving_errs["flash_attention_hybrid"]
            name = f"flash_attention{(b, s, h, kv, d, t, win)} {dn}"
            e = _check(name, out, p_out, TOL[dn], errs)
            el = _check(name + " lse", lse, p_lse, TOL["float32"], [])
            checks.append({"kernel": "flash_attention", "route": fa.route(dt, d),
                           "shape": [b, s, h, kv, d, t],
                           "window": win, "causal": causal, "dtype": dn,
                           "max_abs_err": e, "lse_max_abs_err": el,
                           "tol": TOL[dn]})
            del q, k, v, out, lse, p_out, p_lse
    # the sm90 kernel reads views through their strides: q from a packed QKV
    # projection, k and v from a packed cache longer than T (llama3-8b shape)
    b, s, h, kv, d, t = BATCH, PROMPT, 32, 8, 128, PROMPT + GEN
    qkv = _randn(gen, (b, s, h + 2 * kv, d), torch.bfloat16)
    cache = _randn(gen, (b, t + 64, 2, kv, d), torch.bfloat16)
    q, k, v = qkv[:, :, :h], cache[:, :t, 0], cache[:, :t, 1]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out, lse = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True)
    name = f"flash_attention{(b, s, h, kv, d, t, 0)} bfloat16 strided views"
    checks.append({"kernel": "flash_attention", "route": fa.route(q.dtype, d),
                   "shape": [b, s, h, kv, d, t], "window": 0, "causal": True,
                   "dtype": "bfloat16", "layout": "strided views",
                   "max_abs_err": _check(name, out, p_out, TOL["bfloat16"], []),
                   "lse_max_abs_err": _check(name + " lse", lse, p_lse,
                                             TOL["float32"], []),
                   "tol": TOL["bfloat16"]})
    del qkv, cache, q, k, v, out, lse, p_out, p_lse
    t1 = time.perf_counter()
    first = True
    for shape, dn in RN_TEST_SHAPES + [((BATCH, PROMPT, 4096), "bfloat16"),
                                       ((BATCH, 1, 4096), "bfloat16"),
                                       ((BATCH, PROMPT, 4096), "float32"),
                                       ((BATCH, HYB_PROMPT, 2560), "bfloat16"),
                                       ((BATCH, 1, 2560), "bfloat16")]:
        dt = _dtype(dn)
        serving = shape[-1] in (4096, 2560)
        x = _randn(gen, shape, dt)
        w = _randn(gen, shape[-1:], dt if serving else torch.float32)
        y = rn.rmsnorm(x, w, 1e-6)
        torch.cuda.synchronize()
        if first:
            emit(build={"rmsnorm (triton jit)": {"first_call_seconds":
                                                 time.perf_counter() - t1}})
            first = False
        errs = []
        if serving and dn == "bfloat16":
            errs = serving_errs["rmsnorm" if shape[-1] == 4096 else "rmsnorm_hybrid"]
        e = _check(f"rmsnorm{shape} {dn}", y, rn.rmsnorm_plain(x, w, 1e-6),
                   TOL[dn], errs)
        checks.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": dn,
                       "max_abs_err": e, "tol": TOL[dn]})
    for b, s, c in RG_TEST_SHAPES + [(BATCH, HYB_PROMPT, HYB["d_model"])]:
        a, bb, h0 = _scan_inputs(gen, b, s, c)
        for init in (h0, None):
            out = rg.rglru_scan(a, bb, init)
            torch.cuda.synchronize()
            errs = serving_errs["rglru_scan"] if s == HYB_PROMPT else []
            e = _check(f"rglru_scan{(b, s, c)} h0={init is not None}", out,
                       rg.rglru_scan_plain(a, bb, init), SCAN_TOL, errs)
            checks.append({"kernel": "rglru_scan", "shape": [b, s, c],
                           "h0": init is not None, "dtype": "float32",
                           "max_abs_err": e, "tol": SCAN_TOL})
        del a, bb, h0, out
    emit(kernel_checks=checks)
    state["serving_err"] = {k: max(v) for k, v in serving_errs.items()}
    torch.cuda.empty_cache()


def _sass_counts(so):
    """HGMMA (wgmma), UTMALDG (TMA load) and SYNCS (mbarrier) instructions in
    ``cuobjdump -sass`` of the built library, where the toolkit has it."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "SYNCS")}


# -- phase 3 and 4: the two serving paths ---------------------------------------
def _serve(state, arch, prompt, expect):
    """Serve ``arch`` at full width: BATCH x ``prompt`` tokens, GEN decode
    steps, launch counts per step held to ``expect`` (kind -> counts)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    server = serve.setup(arch, device="cuda", seed=0)
    cfg = server.cfg
    tokens = serve.synthetic_prompts(cfg, BATCH, prompt, device="cuda")
    serve.generate(server, tokens[:, :64], 2)          # warm-up, not counted
    snaps = []
    reset_launch_counts()
    res = serve.generate(server, tokens, GEN,
                         on_step=lambda kind: snaps.append((kind, launch_counts())))
    total = launch_counts()
    per_step, prev = [], {k: 0 for k in total}
    for kind, c in snaps:
        per_step.append((kind, {k: c[k] - prev[k] for k in c}))
        prev = c
    finite = bool(torch.isfinite(res["prefill_logits"].float()).all()
                  and torch.isfinite(res["last_logits"].float()).all())
    emit(serve={"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab_size, "batch": BATCH, "prompt_len": prompt,
                "gen": GEN, "prefill_ms": res["prefill_ms"],
                "decode_ms_per_token": res["decode_ms_per_token"],
                "launches_total": total,
                "launches_prefill": per_step[0][1],
                "launches_per_decode_step": [c for _, c in per_step[1:]],
                "finite": finite, "sample_ids": res["ids"][0].tolist(),
                "card": state["card"]})
    assert finite, "non-finite logits"
    assert len(per_step) == GEN + 1
    for kind, c in per_step:
        assert c == expect[kind], f"{kind}: launches {c}, expected {expect[kind]}"
    return {"server": server, "tokens": tokens, "ids": res["ids"],
            "launches": total, "prompt": prompt}


def phase_serve(state):
    n = 32
    state[ARCH] = _serve(state, ARCH, PROMPT, {
        "prefill": {"flash_attention": n, "flash_attention_sm90": n,
                    "rmsnorm": 2 * n + 1, "rglru_scan": 0},
        "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                   "rmsnorm": 2 * n + 1, "rglru_scan": 0}})


def phase_hybrid_serve(state):
    n, attn, rec = 26, 8, 18
    state[HYB_ARCH] = _serve(state, HYB_ARCH, HYB_PROMPT, {
        "prefill": {"flash_attention": attn, "flash_attention_sm90": attn,
                    "rmsnorm": 2 * n + 1, "rglru_scan": rec},
        "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                   "rmsnorm": 2 * n + 1, "rglru_scan": 0}})


def _kernel_table(prof, wall_ms, steps):
    """Device time by kernel name from a torch.profiler run over ``wall_ms``
    of host time; ms per step, busy share, top kernels."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:90], "ms_per_step": t / steps,
                     "launches_per_step": c / steps} for k, t, c in rows[:14]]}


def _profile(run):
    """One prefill and two decode steps of the served model under
    torch.profiler: device time by kernel and the card's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server, prompt = run["server"], run["prompt"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = server.prefill(server.params, {"tokens": run["tokens"]},
                                        prompt + 2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    emit(profile_prefill={"arch": server.cfg.name,
                          **_kernel_table(prof, wall, 1)})
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            logits, caches = server.decode(server.params, caches, tok, prompt + i)
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    emit(profile_decode={"arch": server.cfg.name, **_kernel_table(prof, wall, 2)})


def phase_profile(state):
    _profile(state[ARCH])


def phase_hybrid_profile(state):
    _profile(state[HYB_ARCH])


def _teacher_forcing(state, arch, batch, limits):
    """``forward`` over prompt + 1 tokens against prefill(prompt) +
    decode(1), for each activation dtype in ``limits`` (dtype -> limit on
    the relative L2 of the last logits), with the served weights. Frees
    the model."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    run = state[arch]
    server, prompt = run["server"], run["prompt"]
    toks = torch.cat([run["tokens"], run["ids"][:, :1]], dim=1)[:batch]
    fails = []
    for dtype, limit in limits.items():
        api = build_model(server.cfg.replace(dtype=dtype))
        prefill, decode = make_serve_fns(api, "cuda")
        with torch.inference_mode():
            full = api.forward(server.params, toks)[:, -1].float()
        _, caches = prefill(server.params, {"tokens": toks[:, :prompt]}, prompt + 1)
        step, _ = decode(server.params, caches, toks[:, prompt], prompt)
        step = step[:, 0].float()
        rel = ((step - full).norm() / full.norm()).item()
        emit(teacher_forcing={"arch": arch, "dtype": dtype, "batch": batch,
                              "tokens": prompt + 1, "rel_l2": rel, "limit": limit,
                              "max_abs_err": _max_err(step, full)})
        if rel > limit:
            fails.append(f"{dtype}: teacher forcing rel L2 {rel} > {limit}")
        del full, caches, step
    del run["server"], server
    torch.cuda.empty_cache()
    assert not fails, fails


def phase_teacher_forcing(state):
    _teacher_forcing(state, ARCH, BATCH, {"bfloat16": 3e-2})


def phase_hybrid_teacher_forcing(state):
    """Batch 1: forward's full logits over 4097 positions are 2.1 GB in bf16.
    In bf16 the reference's own decode arithmetic (the conv step's einsum
    where forward sums tap by tap, bf16 window-attention probabilities)
    rounds differently from forward, and 26 random layers grow that: the
    reference's own bf16 teacher forcing has rel. L2 0.059 on a 26-layer,
    width-256 cut on the CPU (``tests/test_torch_recurrent.py``). So bf16
    is held to the reference's own 1e-1 (``tests/test_models_smoke.py``)
    and the fp32 activations, where only the bf16 conv history rounds, to
    3e-2."""
    _teacher_forcing(state, HYB_ARCH, 1, {"bfloat16": 1e-1, "float32": 3e-2})


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _card_vs_cpu(arch, prompt, steps=4):
    """The reduced config with the same weights, kernels on the card and
    plain PyTorch on the CPU: prefill and ``steps`` decode steps, logits
    within 3e-2. The reduced configs' head dim is 16, so K1 takes the SIMT
    kernel: launches there, none on the sm90 kernel."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.train.serve import make_serve_fns

    cfg = get_arch(arch, reduced=True)
    api = build_model(cfg)
    p_cpu = api.init(0, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    pre_c, dec_c = make_serve_fns(api, "cpu")
    pre_g, dec_g = make_serve_fns(api, "cuda")
    toks = serve.synthetic_prompts(cfg, 2, prompt, seed=1, device="cpu")
    reset_launch_counts()
    lc, cc = pre_c(p_cpu, {"tokens": toks}, prompt + steps)
    lg, cg = pre_g(p_gpu, {"tokens": toks}, prompt + steps)
    pairs = [(lg, lc)]
    for i in range(steps):
        tok = lc[:, -1].argmax(-1)
        lc, cc = dec_c(p_cpu, cc, tok, prompt + i)
        lg, cg = dec_g(p_gpu, cg, tok, prompt + i)
        pairs.append((lg, lc))
    counts = launch_counts()
    errs = [_max_err(g.cpu(), c) for g, c in pairs]
    ok = all(torch.allclose(g.cpu().float(), c.float(), atol=3e-2, rtol=3e-2)
             for g, c in pairs)
    emit(card_vs_cpu={"arch": f"{arch} reduced", "prompt_len": prompt,
                      "steps": ["prefill"] + ["decode"] * steps,
                      "max_abs_err": errs, "tol": 3e-2, "launches": counts})
    assert ok, f"card and CPU logits differ beyond 3e-2: {errs}"
    assert counts["flash_attention"] > 0 and counts["flash_attention_sm90"] == 0, (
        f"reduced {arch}: K1 launches {counts}, expected SIMT only")


def phase_card_vs_cpu(state):
    _card_vs_cpu(ARCH, 24)


def phase_hybrid_card_vs_cpu(state):
    _card_vs_cpu(HYB_ARCH, 40)          # longer than the reduced window of 32


# -- phase 5 ---------------------------------------------------------------------
def _n_sets(set_bytes):
    """Input sets to cycle so that together they hold twice the L2."""
    return max(4, math.ceil(2 * L2_BYTES / set_bytes))


def _time_ms(fn, inputs, iters, *, queued=True):
    """Mean ms per call over ``iters`` calls cycling through ``inputs`` (at
    least ``_n_sets`` of them, twice the L2 in all, so each call reads its
    inputs cold; the warm-up uses the last sets, the timed calls start at
    the first).

    ``queued``: a sleep kernel holds the card while the host enqueues every
    call, so the events time the card alone; without it they also count the
    gaps where the card waits for the host to launch the next call."""
    import torch

    for i in range(1, 4):
        fn(*inputs[-i])
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    t0.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_flash(state, gen, path, b, s, h, kvh, d, t, window, iters):
    """K1's row at q (b,s,h,d), k/v (b,t,kvh,d), bf16, causal, ``window``:
    the sm90 kernel that the serving path runs, and beside it the earlier
    SIMT kernel at the same shape (``previous_ms``, launched directly
    through its route; not on the main path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    bf = torch.bfloat16
    sets = [(_randn(gen, (b, s, h, d), bf), _randn(gen, (b, t, kvh, d), bf),
             _randn(gen, (b, t, kvh, d), bf))
            for _ in range(_n_sets(2 * (b * s * h * d + 2 * b * t * kvh * d)))]

    def kern(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, window=window)

    def simt(q, k, v):
        return fa.run_kernel("simt", q, k, v, causal=True, window=window)

    ms = _time_ms(kern, sets, iters)
    host_ms = _time_ms(kern, sets, iters, queued=False)
    previous_ms = _time_ms(simt, sets, max(5, iters // 4))
    ms_again = _time_ms(kern, sets, iters)
    plain_ms = _time_ms(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, causal=True, window=window), sets, 5)
    # SDPA with the KV heads expanded; is_causal has no window, so a window
    # takes an explicit boolean mask (True = attend)
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    mask = (qpos >= kpos) & (kpos > qpos - window) if window else None
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous(),
                 v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous())
                for q, k, v in sets]

    def lib(q, k, v):
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_ms = _time_ms(lib, lib_sets, iters)
    lib_err = _max_err(lib(*lib_sets[0]).transpose(1, 2), kern(*sets[0])[0])
    prev_err = _max_err(simt(*sets[0])[0], kern(*sets[0])[0])
    w = window or t
    pairs = sum(min(i + 1, t, w) for i in range(s))       # unmasked (q, k) pairs
    ops = 4 * d * pairs * b * h
    nbytes = 2 * (2 * b * s * h * d + 2 * b * t * kvh * d) + 4 * b * h * s
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    run = state[path]
    return {"name": "flash_attention", "route": "cuda", "path": path,
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "launches": run["launches"]["flash_attention_sm90"],
            "max_abs_err": state["serving_err"][
                "flash_attention" if path == ARCH else "flash_attention_hybrid"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, "previous_ms": previous_ms,
            "previous_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "previous_max_abs_diff": prev_err,
            "tflops": ops / (ms * 1e-3) / 1e12,
            "previous_tflops": ops / (previous_ms * 1e-3) / 1e12,
            "bound_fraction": bound_ms / ms,
            "shape": {"q": [b, s, h, d], "kv": [b, t, kvh, d],
                      "dtype": "bfloat16", "causal": True, "window": window},
            "library": "F.scaled_dot_product_attention, KV heads expanded"
                       + (", windowed causal boolean mask" if window else ""),
            "library_max_abs_err": lib_err}


def _time_rmsnorm(state, gen, path, shape):
    """K2's row at x ``shape`` bf16 (w bf16)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    bf = torch.bfloat16
    n = _n_sets(2 * (math.prod(shape) + shape[-1]))
    sets = [(_randn(gen, shape, bf), _randn(gen, shape[-1:], bf))
            for _ in range(n)]
    ms = _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, 200)
    host_ms = _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, 200,
                       queued=False)
    plain_ms = _time_ms(lambda x, w: rn.rmsnorm_plain(x, w, 1e-6), sets, 50)
    lib_ms = _time_ms(lambda x, w: F.rms_norm(x, (shape[-1],), w, 1e-6),
                      sets, 200)
    elems = math.prod(shape)
    bound_ms, bound_by = _bound(2 * (2 * elems + shape[-1]), 4 * elems,
                                "float32")
    return {"name": "rmsnorm", "route": "triton", "path": path,
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:20",
            "launches": state[path]["launches"]["rmsnorm"],
            "max_abs_err": state["serving_err"][
                "rmsnorm" if path == ARCH else "rmsnorm_hybrid"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "shape": {"x": list(shape), "dtype": "bfloat16"},
            "library": "F.rms_norm"}


def _time_rglru(state, gen, b, s, c):
    """K3's row at a, b (b,s,c) fp32 with h0 (b,c), as prefill calls it."""
    from repro_torch.kernels import rglru as rg

    sets = [_scan_inputs(gen, b, s, c)
            for _ in range(_n_sets(4 * (2 * b * s * c + b * c)))]
    ms = _time_ms(rg.rglru_scan, sets, 20)
    host_ms = _time_ms(rg.rglru_scan, sets, 20, queued=False)
    plain_ms = _time_ms(rg.rglru_scan_plain, sets, 2)
    # a and b read once, h0 read once, h written once; a multiply and an add
    # per element
    bound_ms, bound_by = _bound(4 * (3 * b * s * c + b * c), 2 * b * s * c,
                                "float32")
    return {"name": "rglru_scan", "route": "cuda", "path": HYB_ARCH,
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:50",
            "launches": state[HYB_ARCH]["launches"]["rglru_scan"],
            "max_abs_err": state["serving_err"]["rglru_scan"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_ms": host_ms,
            "shape": {"a": [b, s, c], "h0": [b, c], "dtype": "float32"},
            "library": "none: no single PyTorch call computes this recurrence "
                       "(a cumprod/cumsum form divides by a running product "
                       "that underflows)"}


def phase_times(state):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = [
        # K1 at llama3-8b's prefill shape: q (4,512,32,128), k/v (4,528,8,128)
        _time_flash(state, gen, ARCH, BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0,
                    iters=50),
        _time_rmsnorm(state, gen, ARCH, (BATCH, PROMPT, 4096)),
        # K3, K1 and K2 at recurrentgemma-2b's prefill shapes
        _time_rglru(state, gen, BATCH, HYB_PROMPT, HYB["d_model"]),
        _time_flash(state, gen, HYB_ARCH, BATCH, HYB_PROMPT, HYB["h"], HYB["kv"],
                    HYB["d"], HYB_PROMPT, HYB["window"], iters=20),
        _time_rmsnorm(state, gen, HYB_ARCH, (BATCH, HYB_PROMPT, HYB["d_model"])),
    ]
    emit(rmsnorm_decode_shape=_time_rmsnorm(state, gen, ARCH, (BATCH, 1, 4096)))
    emit(times={"card": state["card"], "peak_bytes_per_s": PEAK_BYTES_PER_S,
                "peak_ops_per_s": PEAK_OPS_PER_S})
    state["kernels"] = kernels


if __name__ == "__main__":
    sys.exit(main())
