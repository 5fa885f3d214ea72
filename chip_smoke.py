#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (``nvcc``) and Triton. Uses ``repro_torch`` only. Phases:

1. the card's name and power limit; float32 matmuls and convolutions in full
   float32 (TF32 off);
2. build the kernels from the checkout (K1 flash attention's four sources:
   the forward's sm90 kernel for bf16 at head dim 64-256 and SIMT kernel for
   the rest, the backward's sm90 kernel for bf16 at head dim 64, 128 and 256
   and SIMT kernel for the rest; and K3 the RG-LRU scan, forward and
   backward; with ``nvcc`` for
   sm_90a, one process each, started together; K2 RMSNorm's forward and
   backward with Triton), report each library's ptxas lines and its HGMMA /
   UTMALDG / SYNCS instruction counts from ``cuobjdump -sass``, and hold
   each kernel against its plain version on the card: fp32 within 2e-5,
   bf16 within 2e-2, the LSE within 2e-5, the scan within 1e-5
   (``tests/test_kernels.py``), at the tests' shapes, at non-causal shapes
   with T != S, on strided views (sm90 route) and at the serving and
   training shapes of both paths, each check naming its route; K3's
   backward against ``rglru_scan_backward_plain`` within the scan's 1e-5,
   with and without h0, at the tests' shapes and at the hybrid's training
   shape (2, 4096, 2560); K3 and its backward also equal to the bit to
   their blocked mirrors (``rglru_scan_blocked_plain``,
   ``rglru_scan_backward_blocked_plain``: the kernels' own order) and to a
   second call on the same inputs; then K1's and K2's gradients
   through their autograd functions (the backward kernels) against autograd
   through their plain versions and against the plain backwards
   (``flash_attention_bwd``, ``rmsnorm_backward``) on the same inputs: fp32
   within 1e-5 abs / 1e-4 rel, bf16 within 2e-2 of max(1, the gradient's
   largest magnitude); K1's bf16 gradients also against autograd through
   the plain version on fp32 copies of the inputs, at the same bound, with
   the plain bf16 versions' distances to that reference printed beside; at
   the tests' shapes with and without a window, at
   the training shape, at a windowed shape of training width, at head dim
   256 (windowed, ragged, and the hybrid's training shape q (2,4096,10,256)
   with window 2048; bf16 on the sm90 backward, fp32 on the SIMT one) and
   on views of a packed projection with a strided cotangent, each check
   naming its backward route; the sm90 d-256 backward twice on the same
   inputs, equal to the bit (K2's fp32 gradients also against autograd through
   ``rmsnorm_plain`` and against ``rmsnorm_backward`` on fp64 copies of the
   inputs, since the kernel sums dw in fp64; the fp32 versions' distances
   to those are printed beside);
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
   then qwen2.5-14b at its published width and depth (48 layers, d_model
   5120, 40 q heads on 8 kv heads: a GQA group of 5, QKV bias; 14.77 B
   params, 59.1 GB in fp32) and granite-34b at its published width (48 q
   heads on one kv head, the non-gated GELU-tanh MLP) cut to 40 of its 88
   layers (63.1 GB in fp32; all 88 would take 135.8 GB): the same prefill
   and decode with launch counts (K1 48 and 40 per prefill, all sm90),
   teacher forcing and the reduced config card vs CPU;
5. train qwen2.5-3b at its published width and depth (36 layers, d_model
   2048, vocab 151936, tied embeddings, 3.09 B params in fp32, bf16
   activations, remat "full"; random weights from a seed) through
   ``repro_torch.launch.train`` (``--dp-sync gspmd``, mesh 1x1), batch
   4 x 1024 on one fixed batch for 6 steps: finite losses, the last below
   the first; step ms (median of steps 2-6, host clock after a
   synchronize), tokens/s, peak memory, launches per step held to K1 72
   (36 forward + 36 recomputed, all sm90), K1's backward 36 (all sm90), K2
   145 and K2's backward 73; one more step under
   ``torch.profiler`` (card busy, idle share, time by kernel group and by
   the port's profiler ranges); the same six steps and profile under remat
   "dots" (``--remat-policy dots``: the projections' outputs saved, the
   attention, norms and gate math recomputed): the same launches, the
   first loss equal to "full"'s to the bit; each run's FLOP floor and
   ``model_flops_6nd`` (``launch/roofline.py``) at the bf16 peak as shares
   of its step time, on a line of their own; the Themis step on one card at
   full width cut to 18 layers, 16 chunks (1.70 B params: it keeps an fp32
   master, m, v and a flat gradient buffer beside the params), 2 steps from
   the same weights and batch as the GSPMD step: losses and gnorms within 1e-5
   relative, params per leaf within 1e-4 of the update's L2 and 1e-2 lr per
   element (set from that phase's own readings on an H100, 2.0e-6 and
   4e-4, with room on both sides); the reduced qwen2.5-3b (head dim 16,
   the SIMT routes) on
   the card against the CPU with the same weights and batch, loss and
   per-leaf grads within 1e-4 relative L2 with fp32 activations, and within
   3e-2 with bf16 or the CPU's own bf16-to-fp32 gap for a leaf where that
   is larger; checkpoints through ``launch/train.py --ckpt-dir`` at full
   width cut to 2 layers (``phase_ckpt_resume``: an uninterrupted run, the
   same run writing checkpoints 2 and 4, whose distance is the card's
   run-to-run gap, then a resume from checkpoint 2 after checkpoint 4 is
   deleted, whose steps 3-4 must lie within that gap; bytes and seconds of
   the writes and the restore);
6. train recurrentgemma-2b at its published width and depth (2.89 B params
   in fp32, bf16 activations, remat "full" per (rec, rec, attn) period, the
   2 tail blocks not checkpointed) the same way at 2 x 4096 tokens (twice
   the window) for 6 steps: finite, falling losses, step ms, tokens/s, peak
   memory, the FLOP floor's share, launches per step held to K1 16 (8
   forward + 8 recomputed, all sm90), K1's backward 8 (all sm90, head dim
   256), K2 101, K2's backward 53, K3 34 (18 + 16 recomputed) and K3's
   backward 18; one more step under ``torch.profiler``; the six steps and
   profile again under remat "dots" per period; the reduced
   recurrentgemma-2b (head dim 16, SIMT routes; 64 tokens past its window
   of 32) on the card against the CPU at qwen2.5-3b's bounds;
7. the simulator (``repro_torch.core``, on the host): paper Fig. 8 (the six
   Table-2 topologies x 100-1000 MB all-reduce under baseline/FIFO,
   themis/FIFO and themis/SCF through ``simulate_scheduled``) and Fig. 12
   (four workloads, compute calibrated to the paper's Ideal, then
   baseline/FIFO, themis/SCF and ideal iteration times), printed as
   simulated values (the CPU tests hold them equal to the reference's);
   the scenarios of ``benchmarks/faults_study.py``, ``tenancy_study.py``
   and ``traffic_study.py`` at their full sizes, through the port's
   ``faults``, ``tenancy`` and ``traffic`` packages (host only; simulated
   fabric times beside host seconds): the fault-free identity, 24 seeded
   chaos scenarios equal across the indexed and reference engines with the
   invariant sanitizer armed, and re-planning's speed-up >= 1.15 at a
   degradation to 0.1 (``phase_faults``); the fairness and workloads
   sweeps over four arbiter policies, the preemption cost and the tracker
   ablation on three Table-2 topologies, with weighted-fair beating fifo on
   Jain and the shared tracker winning on each (``phase_tenancy``); the
   traffic equivalence gate (the IR equal to ``simulate_requests`` and the
   batch runner equal to indexed, exactly; indexed within 1e-12 relative
   of reference, the reference's own 1-2 ulp gap), the mixed training and
   serving tenants' decode p50/p95/p99 and prefill p99, the DCN jitter
   sweep, and the long stream up to about 953k stage-ops with the compiled
   engine equal to indexed at each size (``phase_traffic``; its host times
   and their scaling exponent are printed, not gated);
   then the compiled engine's wave kernel (``wave_done_times``, vectorized
   torch) on the card over 20 MB baseline RS requests of 4096 chunks, one
   every 100 us, at 64, 208 and 640 requests (2,621,440 chunks, 3 ranks):
   within 1e-9 relative of ``simulate(engine="compiled", fusion=False)``
   at 64 requests, of its own CPU run and of the sequential plain version
   at 640, a second card call equal to the bit; its ms (median of CUDA
   events), stage-ops per second and bound beside the host's
   ``simulate_compiled`` and CPU times;
8. each kernel's time at the serving and training shapes with CUDA events, beside its
   bound, its plain version's time and one PyTorch library call's time
   where one computes the same function (``ms`` with the launch queue
   filled first, so the card's time alone; ``host_ms`` as issued one call
   after another from Python); K1's rows also time the SIMT kernel at the
   same shapes (``previous_ms``) and give the achieved TFLOP/s and
   ``bound_ms / ms``; at the training shapes also K1's and K2's backward
   kernels beside their plain versions (``previous_ms``, the code the
   training path ran before them: the plain recompute at qwen2.5-3b's
   shape, the SIMT kernel at head dim 256), the library's backward and
   their bounds; K3 and its backward at (2, 4096, 2560); K1 and K2 at the
   prefills of qwen2.5-14b and granite-34b; and each training step's floor
   (its FLOPs at the bf16 peak) and ``model_flops_6nd`` share beside the
   measured step time.

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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
L2_BYTES = 50 * 2**20
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-5
ARCH, BATCH, PROMPT, GEN = "llama3-8b", 4, 512, 16
HYB_ARCH, HYB_PROMPT = "recurrentgemma-2b", 4096
HYB = dict(h=10, kv=1, d=256, window=2048, d_model=2560)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen2.5-3b", 4, 1024, 6
HYB_TRAIN_BATCH, HYB_TRAIN_SEQ = 2, 4096      # twice the window
# K1's (b, s, h, kv, d, t, window) and the (b, s, width) of K2 and K3 in
# recurrentgemma-2b's training step
HYB_TRAIN_ATTN = (HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB["h"], HYB["kv"], HYB["d"],
                  HYB_TRAIN_SEQ, HYB["window"])
HYB_TRAIN_X = (HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB["d_model"])
QWEN = dict(h=16, kv=2, d=128, d_model=2048, layers=36)
THEMIS_LAYERS, THEMIS_STEPS = 18, 2
# the two dense configs served at full width: qwen2.5-14b (a GQA group of 5)
# at its published depth, granite-34b (MQA: 48 q heads on one kv head) cut
# to 40 of its 88 layers, whose fp32 weights then take 63.1 GB of the card
DENSE14B, GRANITE, GRANITE_LAYERS = "qwen2.5-14b", "granite-34b", 40
QWEN14B = dict(h=40, kv=8, d=128, d_model=5120, layers=48)
GRANITE_D = dict(h=48, kv=1, d=128, d_model=6144)
# K1's (b, s, h, kv, d, t, window) at the two prefills (t: the cache of
# PROMPT + GEN positions)
QWEN14B_ATTN = (BATCH, PROMPT, QWEN14B["h"], QWEN14B["kv"], QWEN14B["d"],
                PROMPT + GEN, 0)
GRANITE_ATTN = (BATCH, PROMPT, GRANITE_D["h"], GRANITE_D["kv"], GRANITE_D["d"],
                PROMPT + GEN, 0)
# the checkpoint phase: qwen2.5-3b at full width cut to 2 layers
CKPT_LAYERS, CKPT_BATCH, CKPT_STEPS = 2, 2, 4
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": 2e-2}
# the simulator: paper Fig. 8's all-reduce sizes (MB = 1e6 bytes) and Fig. 12's
# reported speed-ups over the baseline (Sec. 6.2: Themis, and the Ideal that
# calibrate_compute fits each workload's compute time to)
FIG8_SIZES_MB = (100, 250, 500, 750, 1000)
FIG8_PAPER = {"avg_speedup_fifo": 1.58, "avg_speedup_scf": 1.72, "max_speedup_scf": 2.70}
FIG12_PAPER = {"resnet152": (1.49, 1.54), "gnmt": (1.30, 1.32), "dlrm": (1.30, 1.33),
               "transformer_1t": (1.25, 1.26)}
# the wave kernel's stream: baseline RS of 20 MB in 4096 chunks on
# 3D-SW_SW_SW_hetero, one request every 100 us, each chunk a group of its own
# (baseline visits each dim once per chunk, so the kernel's rank barriers are
# exact); 640 requests is the compiled tier's backlog in BENCH_sched_perf.json
WAVE_TOPOLOGY, WAVE_BYTES, WAVE_CHUNKS, WAVE_PERIOD_S = "3D-SW_SW_SW_hetero", 20e6, 4096, 100e-6
WAVE_REQUESTS = (64, 208, 640)
WAVE_RTOL = 1e-9
# faults, tenancy and traffic: the scenarios of
# benchmarks/{faults,tenancy,traffic}_study.py at their full sizes
MB = 1e6
FAULTS_TOPOLOGY, FAULTS_HORIZON_S = "2D-SW_SW", 2e-3
REPLAN_GATE, SWEEP_FACTORS = 1.15, (0.7, 0.5, 0.25, 0.1)
TENANCY_TOPOLOGIES = ("2D-SW_SW", "3D-SW_SW_SW_homo", "3D-SW_SW_SW_hetero")
TENANCY_POLICIES = ("fifo", "strict-priority", "weighted-fair", "slo-aware")
TENANCY_CHUNKS, PREEMPT_PENALTIES_S = 16, (0.0, 50e-6, 200e-6, 1e-3)
TRAFFIC_ARCH, TRAFFIC_COSTS = "llama3-8b", dict(batch=4, prompt_len=512, tp=8)
LONG_STREAM_SIZES = ((10, 150), (30, 450), (80, 1200), (160, 2400))
# indexed vs reference on traffic graphs: the reference's own engines sum
# group_wire_bytes (and, under an arbiter, dim_busy / dim_wire_bytes) in
# another order and differ by 1-2 ulp (ROADMAP §3, R6); the port's copies too
TRAFFIC_ENGINE_RTOL = 1e-12
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
              phase_hybrid_teacher_forcing, phase_hybrid_card_vs_cpu,
              phase_dense14b_serve, phase_granite_serve,
              phase_train, phase_train_profile, phase_train_dots,
              phase_train_dots_profile, phase_themis_train,
              phase_train_card_vs_cpu, phase_ckpt_resume, phase_hybrid_train,
              phase_hybrid_train_profile, phase_hybrid_train_dots,
              phase_hybrid_train_dots_profile, phase_hybrid_train_card_vs_cpu,
              phase_simulator, phase_faults, phase_tenancy, phase_traffic,
              phase_wave, phase_times)
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

    sources = ["flash_attention_sm90", "flash_attention", "flash_attention_bwd_sm90",
               "flash_attention_bwd", "rglru_scan"]
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
    # the shapes added with the qwen2.5-14b and granite-34b prefills draw
    # from a generator of their own, so every earlier check (and
    # _grad_checks) keeps the inputs it had
    new_gen = torch.Generator(device="cuda").manual_seed(19)
    new_shapes = (QWEN14B_ATTN, GRANITE_ATTN, (BATCH, PROMPT, QWEN14B["d_model"]),
                  (BATCH, PROMPT, GRANITE_D["d_model"]))
    checks = []
    serving_errs = {k: [] for k in ("flash_attention", "rmsnorm", "rglru_scan",
                                    "flash_attention_hybrid", "rmsnorm_hybrid",
                                    "flash_attention_train", "rmsnorm_train",
                                    "flash_attention_hybrid_train",
                                    "rmsnorm_hybrid_train", "rglru_scan_hybrid_train",
                                    "rglru_scan_backward", "flash_attention_qwen14b",
                                    "rmsnorm_qwen14b", "flash_attention_granite",
                                    "rmsnorm_granite")}
    hyb = (BATCH, HYB_PROMPT, HYB["h"], HYB["kv"], HYB["d"], HYB_PROMPT,
           HYB["window"])
    train = (TRAIN_BATCH, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ, 0)
    seq = FA_TEST_SHAPES + [(BATCH, PROMPT, 32, 8, 128, PROMPT, 0),
                            (BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0),
                            (2, 130, 4, 2, 16, 130, None),
                            (2, 200, 8, 2, 64, 300, None),
                            (1, 300, 4, 1, 128, 130, None),
                            (1, 130, 2, 1, 256, 200, None),
                            (2, 300, 10, 1, 256, 300, 128), hyb, train, HYB_TRAIN_ATTN,
                            QWEN14B_ATTN, GRANITE_ATTN]
    serving_shapes = {hyb: "flash_attention_hybrid", train: "flash_attention_train",
                      HYB_TRAIN_ATTN: "flash_attention_hybrid_train",
                      QWEN14B_ATTN: "flash_attention_qwen14b",
                      GRANITE_ATTN: "flash_attention_granite"}
    for b, s, h, kv, d, t, win in seq:
        causal = win is not None
        g = new_gen if (b, s, h, kv, d, t, win) in new_shapes else gen
        for dn in ("float32", "bfloat16"):
            dt = _dtype(dn)
            q = _randn(g, (b, s, h, d), dt)
            k, v = _randn(g, (b, t, kv, d), dt), _randn(g, (b, t, kv, d), dt)
            out, lse = fa.flash_attention(q, k, v, causal=causal, window=win or 0)
            torch.cuda.synchronize()
            p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                    window=win or 0)
            errs = []
            if dn == "bfloat16" and (b, s, h) == (BATCH, PROMPT, 32):
                errs = serving_errs["flash_attention"]
            elif dn == "bfloat16" and (b, s, h, kv, d, t, win) in serving_shapes:
                errs = serving_errs[serving_shapes[(b, s, h, kv, d, t, win)]]
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
                                       ((BATCH, 1, 2560), "bfloat16"),
                                       ((TRAIN_BATCH, TRAIN_SEQ, 2048), "bfloat16"),
                                       (HYB_TRAIN_X, "bfloat16"),
                                       ((BATCH, PROMPT, QWEN14B["d_model"]), "bfloat16"),
                                       ((BATCH, PROMPT, GRANITE_D["d_model"]), "bfloat16")]:
        dt = _dtype(dn)
        serving = shape[-1] in (4096, 2560, 2048, 5120, 6144)
        g = new_gen if shape in new_shapes else gen
        x = _randn(g, shape, dt)
        w = _randn(g, shape[-1:], dt if serving else torch.float32)
        y = rn.rmsnorm(x, w, 1e-6)
        torch.cuda.synchronize()
        if first:
            emit(build={"rmsnorm (triton jit)": {"first_call_seconds":
                                                 time.perf_counter() - t1}})
            first = False
        errs = []
        if shape == HYB_TRAIN_X:
            errs = serving_errs["rmsnorm_hybrid_train"]
        elif serving and dn == "bfloat16":
            errs = serving_errs[{4096: "rmsnorm", 2560: "rmsnorm_hybrid",
                                 2048: "rmsnorm_train", 5120: "rmsnorm_qwen14b",
                                 6144: "rmsnorm_granite"}[shape[-1]]]
        e = _check(f"rmsnorm{shape} {dn}", y, rn.rmsnorm_plain(x, w, 1e-6),
                   TOL[dn], errs)
        checks.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": dn,
                       "max_abs_err": e, "tol": TOL[dn]})
    for b, s, c in RG_TEST_SHAPES + [(BATCH, HYB_PROMPT, HYB["d_model"]), HYB_TRAIN_X]:
        a, bb, h0 = _scan_inputs(gen, b, s, c)
        g = _randn(gen, (b, s, c), torch.float32)
        for init in (h0, None):
            out = rg.rglru_scan(a, bb, init)
            torch.cuda.synchronize()
            errs = []
            if (b, s, c) == HYB_TRAIN_X:
                errs = serving_errs["rglru_scan_hybrid_train"]
            elif s == HYB_PROMPT:
                errs = serving_errs["rglru_scan"]
            name = f"rglru_scan{(b, s, c)} h0={init is not None}"
            e = _check(name, out, rg.rglru_scan_plain(a, bb, init), SCAN_TOL, errs)
            # the kernel runs the blocked order: equal to its mirror and to
            # a second call, to the bit
            mirror = torch.equal(out, rg.rglru_scan_blocked_plain(a, bb, init))
            again = torch.equal(out, rg.rglru_scan(a, bb, init))
            checks.append({"kernel": "rglru_scan", "shape": [b, s, c],
                           "h0": init is not None, "dtype": "float32",
                           "max_abs_err": e, "tol": SCAN_TOL,
                           "equal_to_blocked_mirror": mirror,
                           "equal_across_calls": again})
            assert mirror and again, (name, mirror, again)
            # K3's backward on the forward's h, against its plain version
            got = rg.rglru_scan_backward(a, out, g, init)
            torch.cuda.synchronize()
            want = rg.rglru_scan_backward_plain(a, out, g, init)
            errs = serving_errs["rglru_scan_backward"] if (b, s, c) == HYB_TRAIN_X else []
            e = [_check(f"{name} backward {n}", x, y, SCAN_TOL, errs)
                 for n, x, y in zip(("da", "db", "dh0"), got, want) if y is not None]

            def equal(xs, ys):
                return all(torch.equal(x, y) for x, y in zip(xs, ys) if y is not None)

            mirror = equal(got, rg.rglru_scan_backward_blocked_plain(a, out, g, init))
            again = equal(got, rg.rglru_scan_backward(a, out, g, init))
            checks.append({"kernel": "rglru_scan_backward", "shape": [b, s, c],
                           "h0": init is not None, "dtype": "float32",
                           "max_abs_err": max(e), "tol": SCAN_TOL,
                           "equal_to_plain": equal(got, want),
                           "equal_to_blocked_mirror": mirror,
                           "equal_across_calls": again})
            assert mirror and again, (f"{name} backward", mirror, again)
            del got, want
        del a, bb, h0, g, out
    emit(kernel_checks=checks)
    state["serving_err"] = {k: max(v) for k, v in serving_errs.items()}
    torch.cuda.empty_cache()
    state["grad_err"] = _grad_checks(gen)
    torch.cuda.empty_cache()


def _grad_close(name, got, want, dn, errs):
    """fp32: elementwise within 1e-5 abs / 1e-4 rel; bf16: max abs error
    within 2e-2 of max(1, the gradient's largest magnitude)."""
    import torch

    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    errs.append({"grad": name, "max_abs_err": err, "max_abs": scale})
    if dn == "float32":
        atol, rtol = GRAD_TOL[dn]
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        tol = f"{atol} abs / {rtol} rel"
    else:
        tol = GRAD_TOL[dn] * max(1.0, scale)
        ok = err <= tol
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} beyond {tol}")


def _grad_checks(gen):
    """K1's and K2's gradients on the card: each autograd path that the
    training step runs (``ops.flash_attention``, ``ops.rmsnorm``, whose
    backwards launch the backward kernels) against PyTorch's autograd
    through the kernel's plain version, and against the plain backward
    (``flash_attention_bwd`` fed with the kernel's out and LSE;
    ``rmsnorm_backward``) on the same inputs, with one random cotangent.
    Returns the largest bf16 error at the training shapes, by kernel."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.common import flash_attention_bwd

    checks = []
    worst = {"flash_attention_backward": 0.0, "rmsnorm_backward": 0.0,
             "flash_attention_backward_hybrid": 0.0, "rmsnorm_backward_hybrid": 0.0}
    train = (TRAIN_BATCH, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ,
             0)
    train_window = (2, TRAIN_SEQ, QWEN["h"], QWEN["kv"], QWEN["d"], TRAIN_SEQ, 300)
    # head dim 256: windowed, ragged (S not a multiple of 64), the hybrid's
    # training shape with its window of 2048
    d256 = [(2, 256, 4, 1, 256, 256, 64), (2, 300, 10, 1, 256, 300, 128), HYB_TRAIN_ATTN]
    shapes = (FA_TEST_SHAPES + [(b, s, h, kv, d, t, 16)
                                for b, s, h, kv, d, t, _ in FA_TEST_SHAPES]
              + [train, train_window] + d256)
    for b, s, h, kv, d, t, win in shapes:
        for dn in ("float32", "bfloat16"):
            dt = _dtype(dn)
            q = _randn(gen, (b, s, h, d), dt).requires_grad_(True)
            k = _randn(gen, (b, t, kv, d), dt).requires_grad_(True)
            v = _randn(gen, (b, t, kv, d), dt).requires_grad_(True)
            dout = _randn(gen, (b, s, h, d), dt)
            got = torch.autograd.grad(ops.flash_attention(q, k, v, True, win),
                                      (q, k, v), dout)
            p_out, _ = fa.flash_attention_plain(q, k, v, causal=True, window=win)
            want = torch.autograd.grad(p_out, (q, k, v), dout)
            with torch.no_grad():
                out, lse = fa.flash_attention(q, k, v, causal=True, window=win)
                plain = flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                            window=win)
            readings = fp32_errs = None
            if dn == "bfloat16":
                # the gate against fp32: the kernel's gradients against
                # autograd through the plain version on fp32 copies of the
                # same inputs; beside it, how far each bf16 gradient lies
                # from that reference (the plain bf16 backward carries most
                # of the error of the two bf16 gates below)
                q32, k32, v32 = (x.detach().float().requires_grad_(True)
                                 for x in (q, k, v))
                ref = torch.autograd.grad(fa.flash_attention_plain(
                    q32, k32, v32, causal=True, window=win)[0], (q32, k32, v32),
                    dout.float())
                readings = {label: {n: _max_err(a, r) for n, a, r in
                                    zip(("dq", "dk", "dv"), grads, ref)}
                            for label, grads in (("kernel", got), ("autograd_plain", want),
                                                 ("flash_attention_bwd", plain))}
                fp32_errs = []
                for n, a, r in zip(("dq", "dk", "dv"), got, ref):
                    _grad_close(f"flash_attention{(b, s, h, kv, d, t, win)} {dn} {n} "
                                "vs fp32 autograd", a, r, dn, fp32_errs)
                del q32, k32, v32, ref
            torch.cuda.synchronize()
            errs, plain_errs = [], []
            for n, a, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
                name = f"flash_attention{(b, s, h, kv, d, t, win)} {dn} {n}"
                _grad_close(name, a, w, dn, errs)
                _grad_close(name + " vs flash_attention_bwd", a, pl, dn, plain_errs)
            key = {train: "flash_attention_backward",
                   HYB_TRAIN_ATTN: "flash_attention_backward_hybrid"}.get((b, s, h, kv, d, t, win))
            if dn == "bfloat16" and key:
                worst[key] = max(e["max_abs_err"] for e in errs + plain_errs)
            checks.append({"kernel": "flash_attention", "route": fa.route(dt, d),
                           "backward_route": fa.bwd_route(dt, d),
                           "shape": [b, s, h, kv, d, t], "window": win,
                           "dtype": dn, "grads": errs,
                           "vs_plain_backward": plain_errs, "tol": GRAD_TOL[dn],
                           "vs_fp32_autograd": fp32_errs,
                           "bf16_max_abs_err_vs_fp32_autograd": readings})
            del q, k, v, dout, got, p_out, want, out, lse, plain
            torch.cuda.empty_cache()
    # the sm90 backward at d 256 gives the same bits from run to run
    b, s, h, kv, d, t, win = HYB_TRAIN_ATTN
    bf = torch.bfloat16
    q, k, v = (_randn(gen, (b, s, n, d), bf) for n in (h, kv, kv))
    dout = _randn(gen, (b, s, h, d), bf)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=win)
    runs = [fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True, window=win)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(*runs)]
    checks.append({"kernel": "flash_attention", "backward_route": fa.bwd_route(bf, d),
                   "shape": [b, s, h, kv, d, t], "window": win, "dtype": "bfloat16",
                   "two_calls_equal_to_the_bit": dict(zip(("dq", "dk", "dv"), same))})
    assert fa.bwd_route(bf, d) == "sm90" and all(same), (
        f"sm90 d-256 backward differs between two calls: {same}")
    del q, k, v, dout, out, lse, runs
    # the sm90 backward reads q, k and v through their strides: views of one
    # packed projection, with a cotangent that is not contiguous
    b, s, h, kv, d = 2, 256, 8, 2, 128
    qkv = _randn(gen, (b, s, h + 2 * kv, d), torch.bfloat16).requires_grad_(True)
    dout = _randn(gen, (b, h, s, d), torch.bfloat16).transpose(1, 2)

    def split(x):
        return x[:, :, :h], x[:, :, h:h + kv], x[:, :, h + kv:]

    got = torch.autograd.grad(ops.flash_attention(*split(qkv), True, 0), qkv, dout)[0]
    want = torch.autograd.grad(fa.flash_attention_plain(*split(qkv), causal=True)[0],
                               qkv, dout)[0]
    errs = []
    _grad_close(f"flash_attention{(b, s, h, kv, d, s, 0)} bfloat16 views dqkv", got,
                want, "bfloat16", errs)
    checks.append({"kernel": "flash_attention", "route": fa.route(qkv.dtype, d),
                   "backward_route": fa.bwd_route(qkv.dtype, d),
                   "shape": [b, s, h, kv, d, s], "window": 0, "dtype": "bfloat16",
                   "layout": "q, k, v views of one packed tensor; strided cotangent",
                   "grads": errs, "tol": GRAD_TOL["bfloat16"]})
    del qkv, dout, got, want
    for shape, dn in RN_TEST_SHAPES + [((TRAIN_BATCH, TRAIN_SEQ, 2048), "bfloat16"),
                                       ((TRAIN_BATCH, TRAIN_SEQ, 2048), "float32"),
                                       (HYB_TRAIN_X, "bfloat16")]:
        dt = _dtype(dn)
        x = _randn(gen, shape, dt).requires_grad_(True)
        w = _randn(gen, shape[-1:], dt).requires_grad_(True)
        dy = _randn(gen, shape, dt)
        got = torch.autograd.grad(ops.rmsnorm(x, w, 1e-6), (x, w), dy)
        want = torch.autograd.grad(rn.rmsnorm_plain(x, w, 1e-6), (x, w), dy)
        plain = rn.rmsnorm_backward(x.detach(), w.detach(), dy, 1e-6)
        refs = {"": want, " vs rmsnorm_backward": plain}
        fp32_readings = None
        if dn == "float32":
            # the kernel sums dw in fp64 and rounds once, where the fp32
            # versions sum 4,096 rows in fp32: fp32 also holds the kernel to
            # both versions on fp64 copies of the inputs (they then compute
            # in fp64), and reports the fp32 versions' distances to those
            want64, plain64 = _rmsnorm_grads_fp64(x, w, dy)
            refs.update({" vs fp64 autograd": want64,
                         " vs fp64 rmsnorm_backward": plain64})
            fp32_readings = {"autograd32_vs_fp64": _rmsnorm_readings(want, want64),
                             "plain32_vs_fp64": _rmsnorm_readings(plain, plain64)}
        torch.cuda.synchronize()
        errs = {label: [] for label in refs}
        for label, ref in refs.items():
            for n, a, r in zip(("dx", "dw"), got, ref):
                _grad_close(f"rmsnorm{shape} {dn} {n}{label}", a, r, dn, errs[label])
        key = {(TRAIN_BATCH, TRAIN_SEQ, 2048): "rmsnorm_backward",
               HYB_TRAIN_X: "rmsnorm_backward_hybrid"}.get(shape)
        if dn == "bfloat16" and key:
            worst[key] = max(e["max_abs_err"] for v in errs.values() for e in v)
        checks.append({"kernel": "rmsnorm", "route": "triton",
                       "backward_route": "triton", "shape": list(shape), "dtype": dn,
                       "grads": errs[""], "vs_plain_backward": errs[" vs rmsnorm_backward"],
                       "vs_fp64": (errs[" vs fp64 autograd"]
                                   + errs[" vs fp64 rmsnorm_backward"]
                                   if fp32_readings else None),
                       "fp32_readings": fp32_readings, "tol": GRAD_TOL[dn]})
    emit(grad_checks=checks)
    return worst


def _rmsnorm_grads_fp64(x, w, dy):
    """((dx, dw) of autograd through ``rmsnorm_plain``, and the result of
    ``rmsnorm_backward``) on fp64 copies of the inputs, cast to the inputs'
    dtypes."""
    import torch

    from repro_torch.kernels import rmsnorm as rn

    xd, wd, gd = (t.detach().double() for t in (x, w, dy))
    xd.requires_grad_(True)
    wd.requires_grad_(True)
    auto = torch.autograd.grad(rn.rmsnorm_plain(xd, wd, 1e-6), (xd, wd), gd)
    plain = rn.rmsnorm_backward(xd.detach(), wd.detach(), gd, 1e-6)
    return tuple((a.to(x.dtype), b.to(w.dtype)) for a, b in (auto, plain))


def _rmsnorm_readings(got, want):
    """Max abs error of (dx, dw) and the count of elements beyond GRAD_TOL's
    fp32 bound, against ``want``."""
    atol, rtol = GRAD_TOL["float32"]
    return {n: {"max_abs_err": _max_err(a, b),
                "beyond_tol": int(((a.float() - b.float()).abs()
                                   > atol + rtol * b.float().abs()).sum())}
            for n, a, b in zip(("dx", "dw"), got, want)}


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
def _serve(state, arch, prompt, expect, layers=0):
    """Serve ``arch`` at full width (``layers`` > 0: cut to that depth):
    BATCH x ``prompt`` tokens, GEN decode steps, launch counts per step held
    to ``expect`` (kind -> counts)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    server = serve.setup(arch, layers=layers, device="cuda", seed=0)
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
    emit(serve={"arch": arch, "layers": cfg.num_layers,
                "published_layers": get_arch(arch).num_layers,
                "params": sum(p.numel() for p in _leaves(server.params)),
                "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
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


NO_BACKWARD = {"flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0,
               "rmsnorm_bwd": 0, "rglru_scan_bwd": 0}


def _dense_launches(n):
    """A dense model of ``n`` layers: K1 once per layer in the prefill (all
    on the sm90 kernel), none in a decode step; K2 twice per layer and once
    before the head in both."""
    return {"prefill": {"flash_attention": n, "flash_attention_sm90": n,
                        "rmsnorm": 2 * n + 1, "rglru_scan": 0, **NO_BACKWARD},
            "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                       "rmsnorm": 2 * n + 1, "rglru_scan": 0, **NO_BACKWARD}}


def phase_serve(state):
    state[ARCH] = _serve(state, ARCH, PROMPT, _dense_launches(32))


def phase_hybrid_serve(state):
    n, attn, rec = 26, 8, 18
    state[HYB_ARCH] = _serve(state, HYB_ARCH, HYB_PROMPT, {
        "prefill": {"flash_attention": attn, "flash_attention_sm90": attn,
                    "rmsnorm": 2 * n + 1, "rglru_scan": rec, **NO_BACKWARD},
        "decode": {"flash_attention": 0, "flash_attention_sm90": 0,
                   "rmsnorm": 2 * n + 1, "rglru_scan": 0, **NO_BACKWARD}})


def _is_kernel(e, device_type):
    """A kernel's row of ``key_averages``: device time, and not the
    device-side copy of one of the port's profiler ranges (``repro_torch.*``),
    whose time its kernels already count."""
    return (e.device_type == device_type.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("repro_torch."))


def _kernel_table(prof, wall_ms, steps):
    """Device time by kernel name from a torch.profiler run over ``wall_ms``
    of host time; ms per step, busy share, top kernels."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if _is_kernel(e, DeviceType)]
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


def phase_dense14b_serve(state):
    """qwen2.5-14b at its published width and depth (48 layers, d_model 5120,
    40 q heads on 8 kv heads of 128: a GQA group of 5; QKV bias, untied
    head, vocab 152064; 14.77 B params, 59.1 GB in fp32): serve with launch
    counts, teacher forcing at 3e-2, then the reduced config on the card
    against the CPU."""
    state[DENSE14B] = _serve(state, DENSE14B, PROMPT,
                             _dense_launches(QWEN14B["layers"]))
    _teacher_forcing(state, DENSE14B, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(DENSE14B, 24)


def phase_granite_serve(state):
    """granite-34b at its published width (d_model 6144, 48 q heads on one kv
    head of 128: MQA; the non-gated GELU-tanh MLP, d_ff 24576; untied head,
    vocab 49152) cut to GRANITE_LAYERS of its 88 layers: 15.77 B params,
    63.1 GB in fp32, where the whole model's 135.8 GB exceed the card. The
    same checks as qwen2.5-14b."""
    state[GRANITE] = _serve(state, GRANITE, PROMPT, _dense_launches(GRANITE_LAYERS),
                            layers=GRANITE_LAYERS)
    _teacher_forcing(state, GRANITE, BATCH, {"bfloat16": 3e-2})
    _card_vs_cpu(GRANITE, 24)


# -- phase 5: training ----------------------------------------------------------
def _train_argv(*extra, arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    return ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--fixed-batch", "--log-every", "1", "--device", "cuda", *extra]


def _step_floor_flop(cfg, batch, seq):
    """FLOPs of one training step: matmuls forward (2 per weight per token,
    the tied head included), backward (twice that), the recomputed forward
    of the checkpointed blocks, and attention's forward, recompute and
    backward (2.5x the forward) over the (q, k) pairs inside the causal
    window. Dense: every layer is checkpointed. Hybrid: the RG-LRU block's
    five matmuls (linear_y, linear_x, the two gates, linear_out) or the
    attention projections, the gated MLP, and only the periods' blocks
    recomputed (the tail is not checkpointed). Under remat "dots" the
    recompute keeps its attention and loses its matmuls, whose outputs
    were saved."""
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    attn = d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd
    mlp = (3 if cfg.gated_mlp or cfg.family == "hybrid" else 2) * d * f
    window = cfg.local_window if cfg.family == "hybrid" else seq
    pairs = sum(min(i + 1, window) for i in range(seq))
    attn_fwd = 4 * hd * pairs * batch * cfg.num_heads
    if cfg.family == "hybrid":
        r = cfg.d_rnn
        pat = cfg.block_pattern
        kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
        n_remat = cfg.num_layers // len(pat) * len(pat)
        weights = [(3 * d * r + 2 * r * r if k == "rec" else attn) + mlp for k in kinds]
        n_attn = kinds.count("attn")
        n_attn_remat = kinds[:n_remat].count("attn")
    else:
        weights = [attn + mlp] * cfg.num_layers
        n_remat = n_attn = n_attn_remat = cfg.num_layers
    tokens = batch * seq
    dense = 2 * tokens * (sum(weights) + d * cfg.vocab_size)
    recompute = 0 if cfg.remat_policy == "dots" else 2 * tokens * sum(weights[:n_remat])
    return (3 * dense + recompute + attn_fwd * (n_attn * (1 + 2.5) + n_attn_remat))


def _run_training(state, key, arch, batch, seq, want, remat="full"):
    """Full ``arch`` through ``launch/train.py --dp-sync gspmd`` under remat
    policy ``remat``: TRAIN_STEPS steps on one fixed batch, launches per
    step held to ``want``; keeps the trainer in ``state["trainer"]`` for the
    profile."""
    import statistics

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import roofline, train

    snaps = []
    state.pop("trainer", None)         # the previous run's, if a phase failed
    torch.cuda.empty_cache()
    reset_launch_counts()
    res = train.main(_train_argv("--steps", str(TRAIN_STEPS), "--dp-sync", "gspmd",
                                 "--remat-policy", remat, arch=arch, batch=batch,
                                 seq=seq),
                     on_step=lambda step, m: snaps.append(launch_counts()))
    total = launch_counts()
    per_step, prev = [], {k: 0 for k in total}
    for c in snaps:
        per_step.append({k: c[k] - prev[k] for k in c})
        prev = c
    cfg = res["cfg"]
    steady = res["step_ms"][1:]
    step_ms = statistics.median(steady)
    flop = _step_floor_flop(cfg, batch, seq)
    floor_ms = flop / PEAK_OPS_PER_S["bfloat16"] * 1e3
    losses = res["losses"]
    n_params = sum(p.numel() for p in _leaves(res["params"]))
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params, "remat": cfg.remat_policy,
           "batch": batch, "seq": seq, "dp_sync": "gspmd",
           "losses": losses, "gnorms": res["gnorms"], "lrs": res["lrs"],
           "step_ms": res["step_ms"], "step_ms_median_2_6": step_ms,
           "tokens_per_s": res["tokens_per_step"] / (step_ms / 1e3),
           "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
           "launches_per_step": per_step, "launches_total": total,
           "floor_tflop": flop / 1e12, "floor_ms": floor_ms,
           "floor_share": floor_ms / step_ms, "card": state["card"]}
    emit(**{key: out})
    # the roofline's useful work, 6 N D, at the bf16 peak over the step
    model_flop = roofline.model_flops_6nd(
        cfg, ShapeConfig(key, seq, batch, "train"), n_params)
    model_ms = model_flop / roofline.PEAK_FLOPS * 1e3
    emit(model_flops_share={"path": key, "arch": cfg.name, "remat": cfg.remat_policy,
                            "model_flops_6nd_tflop": model_flop / 1e12,
                            "step_ms": step_ms, "share": model_ms / step_ms,
                            "floor_share": floor_ms / step_ms,
                            "peak_flops": roofline.PEAK_FLOPS, "card": state["card"]})
    state[key] = {"launches": total, "step_ms": step_ms, "floor_ms": floor_ms,
                  "model_flops_share": model_ms / step_ms, "losses": losses,
                  "per_step": per_step, "peak_mem_gib": out["peak_mem_gib"]}
    state["trainer"] = res
    assert all(math.isfinite(x) for x in losses), f"non-finite loss {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    for i, c in enumerate(per_step):
        assert c == want, f"step {i + 1}: launches {c}, expected {want}"
    assert len(per_step) == TRAIN_STEPS
    torch.cuda.synchronize()


def _train_launches(n):
    """qwen2.5-3b's launches per step, remat "full" or "dots" alike: K1 and
    K2 run again in the backward (attention and the norms are recomputed;
    "dots" keeps only the projections' outputs)."""
    return {"flash_attention": 2 * n, "flash_attention_sm90": 2 * n,
            "flash_attention_bwd": n, "flash_attention_bwd_sm90": n,
            "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1, "rglru_scan": 0,
            "rglru_scan_bwd": 0}


def _hybrid_train_launches():
    """recurrentgemma-2b's launches per step: each of the 8 periods (rec,
    rec, attn) runs once forward and once again in the backward, the 2 tail
    blocks (rec, rec) once; K2 twice per block and once before the head."""
    periods, tail, attn, rec = 8, 2, 8, 18
    blocks = 3 * periods + tail
    return {"flash_attention": 2 * attn, "flash_attention_sm90": 2 * attn,
            "flash_attention_bwd": attn, "flash_attention_bwd_sm90": attn,
            "rmsnorm": 2 * blocks + 1 + 2 * 3 * periods, "rmsnorm_bwd": 2 * blocks + 1,
            "rglru_scan": rec + 2 * periods, "rglru_scan_bwd": rec}


def phase_train(state):
    """Full qwen2.5-3b through ``launch/train.py --dp-sync gspmd``: six
    steps on one fixed batch, launches counted per step."""
    _run_training(state, "train", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                  _train_launches(QWEN["layers"]))


def _dots_run(state, key, full_key, arch, batch, seq, want):
    """``full_key``'s run again under remat "dots": the same launches per
    step, and the first loss (before any update) equal to "full"'s to the
    bit, since the forward computes the same values."""
    _run_training(state, key, arch, batch, seq, want, remat="dots")
    got, full = state[key]["losses"], state[full_key]["losses"]
    emit(**{f"{key}_vs_full": {"first_loss_equal": got[0] == full[0],
                               "losses_equal": got == full,
                               "max_loss_diff": max(abs(a - b) for a, b in zip(got, full)),
                               "step_ms": [state[full_key]["step_ms"],
                                           state[key]["step_ms"]],
                               "peak_mem_gib": [state[full_key]["peak_mem_gib"],
                                                state[key]["peak_mem_gib"]]}})
    assert got[0] == full[0], f"first loss {got[0]} under dots, {full[0]} under full"


def phase_train_dots(state):
    """Full qwen2.5-3b as ``phase_train``, remat "dots"."""
    _dots_run(state, "train_dots", "train", TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
              _train_launches(QWEN["layers"]))


def phase_hybrid_train_dots(state):
    """Full recurrentgemma-2b as ``phase_hybrid_train``, remat "dots" per
    period."""
    _dots_run(state, "hybrid_train_dots", "hybrid_train", HYB_ARCH, HYB_TRAIN_BATCH,
              HYB_TRAIN_SEQ, _hybrid_train_launches())


def phase_hybrid_train(state):
    """Full recurrentgemma-2b through ``launch/train.py --dp-sync gspmd``:
    2 x 4096 tokens (twice the window, so the window masks keys), six steps
    on one fixed batch, remat "full" per period."""
    _run_training(state, "hybrid_train", HYB_ARCH, HYB_TRAIN_BATCH, HYB_TRAIN_SEQ,
                  _hybrid_train_launches())


def _leaves(tree):
    from repro_torch.models.registry import leaves

    return leaves(tree)


_GROUPS = (("K1 forward (attn_fwd)", ("attn_fwd",)),
           ("K1 backward (attn_bwd)", ("attn_bwd",)),
           ("K2 (_rmsnorm_kernel)", ("_rmsnorm_kernel",)),
           ("K2 backward (_rmsnorm_bwd_kernel, _rmsnorm_dw_kernel)",
            ("_rmsnorm_bwd_kernel", "_rmsnorm_dw_kernel")),
           ("K3 (rglru_scan_fwd)", ("rglru_scan_fwd",)),
           ("K3 backward (rglru_scan_bwd)", ("rglru_scan_bwd",)),
           ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
           ("copies and dtype casts", ("copy",)))


def _train_profile(state, arch):
    """One more training step under torch.profiler: card busy time and idle
    share, device time by kernel group (by name) and by the port's
    profiler ranges (each range's total holds the GEMMs it launched)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = state.pop("trainer")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res["step_fn"](res["params"], res["opt"], res["batch"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other kernels (elementwise, reductions)"] = 0.0
    for e in events:
        if not _is_kernel(e, DeviceType):
            continue
        key = e.key.lower()
        name = next((g for g, pats in _GROUPS if any(p in key for p in pats)),
                    "other kernels (elementwise, reductions)")
        groups[name] += e.self_device_time_total / 1e3
    # a range's kernel time: the device time of the kernels its CPU side
    # launched; its device-side span also holds the gaps between them
    ranges = {e.key: {"kernels_ms": e.device_time_total / 1e3, "calls": e.count}
              for e in events if e.key.startswith("repro_torch.")
              and e.device_type == DeviceType.CPU}
    for e in events:
        if e.key.startswith("repro_torch.") and e.device_type == DeviceType.CUDA:
            ranges.setdefault(e.key, {})["span_ms"] = e.self_device_time_total / 1e3
    emit(profile_train={"arch": arch, "remat": res["cfg"].remat_policy,
                        **_kernel_table(prof, wall, 1),
                        "groups_ms": groups, "ranges": ranges,
                        "card": state["card"]})
    del res
    torch.cuda.empty_cache()


def phase_train_profile(state):
    _train_profile(state, TRAIN_ARCH)


def phase_hybrid_train_profile(state):
    _train_profile(state, HYB_ARCH)


def phase_train_dots_profile(state):
    _train_profile(state, TRAIN_ARCH)


def phase_hybrid_train_dots_profile(state):
    _train_profile(state, HYB_ARCH)


def phase_themis_train(state):
    """qwen2.5-3b at full width cut to 18 layers: two GSPMD steps and two
    Themis steps (one rank, 16 chunks, no collective) from the same seed
    and batch; losses and gnorms within 1e-5 relative, params per leaf
    within 1e-4 of the update's L2 and 1e-2 lr per element. Both sides are
    the port on one card, so these limits come from this phase's own
    readings (2.0e-6 of the update, 4e-4 lr on an H100), with room on
    both sides, not from the CPU comparison against the reference."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import build_model

    argv = _train_argv("--steps", str(THEMIS_STEPS), "--layers",
                       str(THEMIS_LAYERS))
    runs = {}
    final = {}
    for mode in ("gspmd", "themis"):
        torch.cuda.empty_cache()
        res = train.main(argv + ["--dp-sync", mode])
        runs[mode] = {"losses": res["losses"], "gnorms": res["gnorms"],
                      "lrs": res["lrs"], "step_ms": res["step_ms"],
                      "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
                      "orders": sorted({"->".join(o) or "()"
                                        for o in (res["orders"] or [])})}
        final[mode] = [p.detach().cpu() for p in _leaves(res["params"])]
        del res
    torch.cuda.empty_cache()
    cfg = get_arch(TRAIN_ARCH).replace(num_layers=THEMIS_LAYERS)
    init = _leaves(build_model(cfg).init(0, "cuda"))
    lr_max = max(runs["gspmd"]["lrs"])
    diff_over_update, max_abs_over_lr = 0.0, 0.0
    for a, b, c in zip(final["themis"], final["gspmd"], init):
        a, b = a.cuda(), b.cuda()
        diff_over_update = max(diff_over_update,
                               ((a - b).norm() / (b - c).norm()).item())
        max_abs_over_lr = max(max_abs_over_lr, (a - b).abs().max().item() / lr_max)
        del a, b
    del init, final
    torch.cuda.empty_cache()
    rel = {k: max(abs(x - y) / abs(y) for x, y in zip(runs["themis"][k],
                                                       runs["gspmd"][k]))
           for k in ("losses", "gnorms")}
    emit(themis_train={"arch": TRAIN_ARCH, "layers": THEMIS_LAYERS,
                       "d_model": cfg.d_model, "chunks": 16,
                       "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **runs,
                       "rel_diff": rel,
                       "params_diff_over_update": diff_over_update,
                       "params_max_abs_over_lr": max_abs_over_lr,
                       "card": state["card"]})
    assert rel["losses"] <= 1e-5 and rel["gnorms"] <= 1e-5, rel
    assert diff_over_update <= 1e-4 and max_abs_over_lr <= 1e-2, (
        diff_over_update, max_abs_over_lr)


def phase_ckpt_resume(state):
    """Checkpoints through ``launch/train.py --ckpt-dir`` on the card:
    qwen2.5-3b at full width cut to CKPT_LAYERS layers (0.47 B params; its
    params, m and v 5.6 GB), CKPT_BATCH x TRAIN_SEQ tokens, a new batch at
    every step, CKPT_STEPS steps. Run 1 trains without checkpoints; run 2
    trains the same and writes checkpoints 2 and 4 into a temporary
    directory; their distance is the card's own run-to-run gap. Then
    checkpoint 4 is deleted (the manifest is ahead of the data, as after a
    crash mid-write), and run 3, the same command in a fresh trainer,
    restores checkpoint 2 onto the card and trains steps 3-4: its losses and
    final params must lie within the gap of run 1's. Prints the bytes
    written and the seconds of the host copies, the waits, the writes and
    the restore; deletes the directory."""
    import tempfile

    import torch

    from repro_torch.ckpt import latest_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    argv = ["--arch", TRAIN_ARCH, "--layers", str(CKPT_LAYERS), "--batch",
            str(CKPT_BATCH), "--seq", str(TRAIN_SEQ), "--steps", str(CKPT_STEPS),
            "--log-every", "1", "--device", "cuda"]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck = argv + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]

    def run(args):
        torch.cuda.empty_cache()
        res = train.main(args)
        out = {k: res[k] for k in ("losses", "start_step", "restored", "checkpoints",
                                   "checkpoint_final_wait_s", "step_ms")}
        out["params"] = [p.detach().cpu() for p in _leaves(res["params"])]
        return out

    try:
        whole = run(argv)
        saved = run(ck)
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{CKPT_STEPS:08d}"))
        fallback = latest_step(ckpt_dir)
        reset_launch_counts()
        resumed = run(ck)
        counts = launch_counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    def dist(a, b):
        return {"loss": max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                "params": max((x - y).abs().max().item()
                              for x, y in zip(a["params"], b["params"]))}

    gap = dist(saved, whole)
    tail = {"losses": whole["losses"][2:], "params": whole["params"]}
    got = dist(resumed, tail)
    emit(ckpt_resume={
        "arch": TRAIN_ARCH, "layers": CKPT_LAYERS, "batch": [CKPT_BATCH, TRAIN_SEQ],
        "params": sum(p.numel() for p in whole["params"]),
        "losses": {"whole": whole["losses"], "with_checkpoints": saved["losses"],
                   "resumed": resumed["losses"]},
        "checkpoints_written": saved["checkpoints"],
        "final_wait_s": saved["checkpoint_final_wait_s"],
        "fallback_step": fallback, "restored": resumed["restored"],
        "start_step": resumed["start_step"], "run_to_run_gap": gap,
        "resumed_vs_whole": got, "launches_resumed": counts, "card": state["card"]})
    assert fallback == 2 and resumed["restored"]["step"] == 2, (fallback, resumed)
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == CKPT_STEPS - 2
    assert got["loss"] <= gap["loss"] and got["params"] <= gap["params"], (got, gap)
    assert counts["flash_attention_sm90"] > 0 and counts["flash_attention_bwd_sm90"] > 0
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_bwd"] > 0, counts


def _train_card_vs_cpu(arch, seq):
    """The reduced ``arch`` (head dim 16: K1's forward and backward take the
    SIMT kernels) with the same weights and batch on the card and on the
    CPU: the loss and every leaf's gradient, relative L2 within 1e-4 with
    fp32 activations; with bf16 within 3e-2, or the CPU's own distance
    between its bf16 and fp32 gradients where that is larger. Returns the
    launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model

    base = get_arch(arch, reduced=True)
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, base.vocab_size, (2, seq)))
             for k in ("tokens", "labels")}
    p_cpu = build_model(base).init(0, device="cpu")

    def copy(tree, dev):
        if isinstance(tree, dict):
            return {k: copy(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy(v, dev) for v in tree]
        return tree.detach().to(dev, copy=True).requires_grad_(True)

    def grads(cfg, dev):
        params = copy(p_cpu, dev)
        leaves = _leaves(params)
        loss = build_model(cfg).loss_fn(params, {k: v.to(dev)
                                                 for k, v in batch.items()})
        return loss.item(), [g.cpu().float() for g in
                             torch.autograd.grad(loss, leaves)]

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    out, fails = {}, []
    cpu32 = grads(base.replace(dtype="float32"), "cpu")
    reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dtype)
        gl, gg = grads(cfg, "cuda")
        cl, cg = cpu32 if dtype == "float32" else grads(cfg, "cpu")
        rels = [rel(a, b) for a, b in zip(gg, cg)]
        if dtype == "float32":
            tols = [1e-4] * len(rels)
        else:
            tols = [max(3e-2, rel(a, b)) for a, b in zip(cg, cpu32[1])]
        out[dtype] = {"loss_card": gl, "loss_cpu": cl,
                      "loss_rel": abs(gl - cl) / abs(cl),
                      "grad_rel_l2": rels, "tols": tols}
        if out[dtype]["loss_rel"] > min(tols):
            fails.append(f"{dtype} loss {gl} vs {cl}")
        fails += [f"{dtype} leaf {i}: {r} > {t}" for i, (r, t) in
                  enumerate(zip(rels, tols)) if r > t]
    counts = launch_counts()
    emit(train_card_vs_cpu={"arch": f"{arch} reduced", "batch": [2, seq],
                            **out, "launches": counts})
    assert not fails, fails
    assert counts["flash_attention"] > 0 and counts["flash_attention_sm90"] == 0, (
        f"reduced {arch}: K1 launches {counts}, expected SIMT only")
    assert (counts["flash_attention_bwd"] > 0
            and counts["flash_attention_bwd_sm90"] == 0), (
        f"reduced {arch}: K1 backward launches {counts}, expected SIMT only")
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_bwd"] > 0
    return counts


def phase_train_card_vs_cpu(state):
    _train_card_vs_cpu(TRAIN_ARCH, 64)


def phase_hybrid_train_card_vs_cpu(state):
    """Reduced recurrentgemma-2b: 64 tokens cross its window of 32, and K3
    and its backward launch."""
    counts = _train_card_vs_cpu(HYB_ARCH, 64)
    assert counts["rglru_scan"] > 0 and counts["rglru_scan_bwd"] > 0, counts


# -- phase 6 ---------------------------------------------------------------------
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


PATH_NAME = {ARCH: ARCH, HYB_ARCH: HYB_ARCH, "train": f"train {TRAIN_ARCH}",
             "hybrid_train": f"train {HYB_ARCH}", DENSE14B: DENSE14B,
             GRANITE: f"{GRANITE} ({GRANITE_LAYERS} of 88 layers)"}
ERR_SUFFIX = {ARCH: "", HYB_ARCH: "_hybrid", "train": "_train",
              "hybrid_train": "_hybrid_train", DENSE14B: "_qwen14b",
              GRANITE: "_granite"}


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
    return {"name": "flash_attention", "route": "cuda", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "launches": run["launches"]["flash_attention_sm90"],
            "max_abs_err": state["serving_err"]["flash_attention" + ERR_SUFFIX[path]],
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
    return {"name": "rmsnorm", "route": "triton", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:20",
            "launches": state[path]["launches"]["rmsnorm"],
            "max_abs_err": state["serving_err"]["rmsnorm" + ERR_SUFFIX[path]],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "shape": {"x": list(shape), "dtype": "bfloat16"},
            "library": "F.rms_norm"}


_NO_SCAN_LIBRARY = ("none: no single PyTorch call computes this recurrence "
                    "(a cumprod/cumsum form divides by a running product "
                    "that underflows)")


def _time_rglru(state, gen, path, b, s, c, with_h0):
    """K3's row at a, b (b,s,c) fp32, with h0 (b,c) as prefill calls it or
    without, as training does."""
    from repro_torch.kernels import rglru as rg

    sets = [_scan_inputs(gen, b, s, c)[:3 if with_h0 else 2]
            for _ in range(_n_sets(4 * (2 * b * s * c + b * c)))]
    ms = _time_ms(rg.rglru_scan, sets, 20)
    host_ms = _time_ms(rg.rglru_scan, sets, 20, queued=False)
    plain_ms = _time_ms(rg.rglru_scan_plain, sets, 2)
    # a and b read once, h0 read once, h written once; a multiply and an add
    # per element
    nbytes = 4 * (3 * b * s * c + (b * c if with_h0 else 0))
    bound_ms, bound_by = _bound(nbytes, 2 * b * s * c, "float32")
    return {"name": "rglru_scan", "route": "cuda", "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:50",
            "launches": state[path]["launches"]["rglru_scan"],
            "max_abs_err": state["serving_err"][{HYB_ARCH: "rglru_scan",
                                                 "hybrid_train": "rglru_scan_hybrid_train"}[path]],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_ms": host_ms,
            "shape": {"a": [b, s, c], "h0": [b, c] if with_h0 else None,
                      "dtype": "float32"},
            "library": _NO_SCAN_LIBRARY}


def _time_rglru_backward(state, gen, b, s, c):
    """K3's backward kernel at a, h, g (b,s,c) fp32 without h0, as training
    calls it, beside its plain version."""
    from repro_torch.kernels import rglru as rg

    sets = []
    for _ in range(_n_sets(4 * 5 * b * s * c)):
        a, bb = _scan_inputs(gen, b, s, c)[:2]
        sets.append((a, rg.rglru_scan(a, bb), _randn(gen, (b, s, c), _dtype("float32"))))
    ms = _time_ms(rg.rglru_scan_backward, sets, 20)
    host_ms = _time_ms(rg.rglru_scan_backward, sets, 20, queued=False)
    ms_again = _time_ms(rg.rglru_scan_backward, sets, 20)
    plain_ms = _time_ms(rg.rglru_scan_backward_plain, sets, 2)
    # g, a and h read once, da and db written once; a multiply and an add
    # for lam and a multiply for da per element
    bound_ms, bound_by = _bound(4 * 5 * b * s * c, 3 * b * s * c, "float32")
    return {"name": "rglru_scan_backward", "route": "cuda",
            "path": PATH_NAME["hybrid_train"],
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:50 (its gradient: the reference "
                        "differentiates associative_scan in XLA, "
                        "src/repro/models/recurrent.py:67 rglru_scan)",
            "launches": state["hybrid_train"]["launches"]["rglru_scan_bwd"],
            "max_abs_err": state["serving_err"]["rglru_scan_backward"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_ms": host_ms,
            "ms_second_pass": ms_again, "bound_fraction": bound_ms / ms,
            "calls_per_step": 18,
            "shape": {"a": [b, s, c], "h0": None, "dtype": "float32"},
            "library": _NO_SCAN_LIBRARY}


def _time_attention_backward(state, gen, path, b, s, h, kvh, d, window, iters):
    """K1's backward kernel at q (b,s,h,d), k/v (b,s,kvh,d) bf16, causal with
    ``window`` (0: none), as training calls it (``flash_attention_backward``
    from the forward's out and LSE); beside it its plain version, the
    recompute ``flash_attention_bwd`` (``plain_ms``), SDPA's backward under
    the same mask (SDPA forward + backward minus its forward, KV heads
    expanded) and ``previous_ms``, the code the training path ran before:
    at qwen2.5-3b's shape the plain recompute, whose backward of the
    materialising plain version is also timed (``materialised_ms``); at
    head dim 256 the SIMT backward kernel (fp32 atomics)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import flash_attention_bwd

    bf = torch.bfloat16
    per_set = 2 * (3 * b * s * h * d + 2 * b * s * kvh * d) + 4 * b * h * s
    sets = []
    for _ in range(_n_sets(per_set)):
        q, k, v = (_randn(gen, (b, s, n, d), bf) for n in (h, kvh, kvh))
        out, lse = fa.flash_attention(q, k, v, causal=True, window=window)
        sets.append((q, k, v, out, lse, _randn(gen, (b, s, h, d), bf)))

    def kern(q, k, v, out, lse, g):
        return fa.flash_attention_backward(q, k, v, out, lse, g, causal=True,
                                           window=window)

    def simt(q, k, v, out, lse, g):
        return fa.run_backward_kernel("simt", q, k, v, out, lse, g, causal=True,
                                      window=window)

    def recompute(q, k, v, out, lse, g):
        return flash_attention_bwd(q, k, v, out, lse, g, causal=True, window=window)

    ms = _time_ms(kern, sets, iters)
    host_ms = _time_ms(kern, sets, iters, queued=False)
    plain_ms = _time_ms(recompute, sets, max(3, iters // 4))
    simt_ms = _time_ms(simt, sets, 3) if d == 256 else None
    ms_again = _time_ms(kern, sets, iters)

    def grad_sets(expand):
        out = []
        for q, k, v, _, _, g in sets:
            if expand:
                q, k, v, g = (x.repeat_interleave(h // x.shape[2], dim=2)
                              .transpose(1, 2).contiguous() for x in (q, k, v, g))
            out.append(tuple(x.detach().requires_grad_(True) for x in (q, k, v))
                       + (g,))
        return out

    # SDPA's is_causal has no window, so a window takes an explicit boolean
    # mask (True = attend)
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = (qpos >= kpos) & (kpos > qpos - window) if window else None

    def sdpa(q, k, v):
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def plain(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True, window=window)[0]

    def fwd_bwd(f):
        return lambda q, k, v, g: torch.autograd.grad(f(q, k, v), (q, k, v), g)

    lib = grad_sets(True)
    lib_ms = (_time_ms(fwd_bwd(sdpa), lib, iters)
              - _time_ms(lambda q, k, v, g: sdpa(q, k, v), lib, iters))
    del lib
    row = {}
    if d == 256:
        row.update(previous_ms=simt_ms, previous_source=(
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu (SIMT, fp32 "
            "atomics; the route of bf16 at head dim 256 before)"))
    else:
        pl = grad_sets(False)
        row.update(previous_ms=plain_ms, previous_source=(
            "src/repro_torch/models/common.py (flash_attention_bwd, plain recompute)"),
            materialised_ms=(_time_ms(fwd_bwd(plain), pl, 3)
                             - _time_ms(lambda q, k, v, g: plain(q, k, v), pl, 3)),
            materialised="autograd through flash_attention_plain (materialised "
                         "scores), forward+backward minus forward")
        del pl
    pairs = sum(min(i + 1, window or s) for i in range(s))
    ops = 2.5 * 4 * d * pairs * b * h
    nbytes = per_set + 2 * (b * s * h * d + 2 * b * s * kvh * d)
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    err_key = {"train": "flash_attention_backward",
               "hybrid_train": "flash_attention_backward_hybrid"}[path]
    return {"name": "flash_attention_backward", "route": "cuda",
            "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
            "replaces": "src/repro/kernels/ops.py:42 (_fa_bwd: the XLA recompute "
                        "src/repro/models/common.py:265 _flash_vjp_bwd)",
            "launches": state[path]["launches"]["flash_attention_bwd_sm90"],
            "max_abs_err": state["grad_err"][err_key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, **row,
            "tflops": ops / (ms * 1e-3) / 1e12, "bound_fraction": bound_ms / ms,
            "calls_per_step": {"train": QWEN["layers"], "hybrid_train": 8}[path],
            "shape": {"q": [b, s, h, d], "kv": [b, s, kvh, d], "dtype": "bfloat16",
                      "causal": True, "window": window},
            "library": "F.scaled_dot_product_attention forward+backward minus "
                       "forward, KV heads expanded"
                       + (", windowed causal boolean mask" if window else "")}


def _time_rmsnorm_backward(state, gen, path, shape, calls_per_step):
    """K2's backward kernels (``rmsnorm_grad``) at x ``shape`` bf16, w bf16;
    beside its plain version ``rmsnorm_backward`` (``previous_ms``, the code
    the training path ran before; also ``plain_ms``) and ``F.rms_norm``'s
    backward (forward+backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    bf = torch.bfloat16
    elems = math.prod(shape)
    sets = [(_randn(gen, shape, bf), _randn(gen, shape[-1:], bf),
             _randn(gen, shape, bf))
            for _ in range(_n_sets(2 * (3 * elems + shape[-1])))]

    def kern(x, w, g):
        return rn.rmsnorm_grad(x, w, g, 1e-6)

    ms = _time_ms(kern, sets, 200)
    host_ms = _time_ms(kern, sets, 200, queued=False)
    previous_ms = _time_ms(lambda x, w, g: rn.rmsnorm_backward(x, w, g, 1e-6), sets, 50)
    ms_again = _time_ms(kern, sets, 200)
    lib = [(x.requires_grad_(True), w.requires_grad_(True), g)
           for x, w, g in ((x.clone(), w.clone(), g) for x, w, g in sets)]

    def lib_fwd(x, w, g):
        return F.rms_norm(x, (shape[-1],), w, 1e-6)

    lib_ms = (_time_ms(lambda x, w, g: torch.autograd.grad(
        lib_fwd(x, w, g), (x, w), g), lib, 50) - _time_ms(lib_fwd, lib, 50))
    # x and dy read once, w read once; dx and dw written once
    bound_ms, bound_by = _bound(2 * (3 * elems + 2 * shape[-1]), 10 * elems,
                                "float32")
    return {"name": "rmsnorm_backward", "route": "triton",
            "path": PATH_NAME[path],
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:20 (its gradient: the "
                        "reference differentiates src/repro/models/common.py:103 "
                        "rms_norm)",
            "launches": state[path]["launches"]["rmsnorm_bwd"],
            "max_abs_err": state["grad_err"][
                {"train": "rmsnorm_backward",
                 "hybrid_train": "rmsnorm_backward_hybrid"}[path]],
            "ms": ms, "plain_ms": previous_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "host_ms": host_ms,
            "ms_second_pass": ms_again, "previous_ms": previous_ms,
            "previous_source": "src/repro_torch/kernels/rmsnorm.py "
                               "(rmsnorm_backward, plain torch)",
            "bound_fraction": bound_ms / ms,
            "calls_per_step": calls_per_step,
            "shape": {"x": list(shape), "dtype": "bfloat16"},
            "library": "F.rms_norm forward+backward minus forward"}


# -- phase 7: the simulator -------------------------------------------------------
def fig8_grid():
    """Paper Fig. 8 through the port: all-reduce makespans on the six Table-2
    topologies x ``FIG8_SIZES_MB`` under baseline/FIFO, themis/FIFO and
    themis/SCF (``simulate_scheduled``, 64 chunks), and the speed-ups'
    summary. Simulated fabric times, computed on the host."""
    from repro_torch.core import simulate_scheduled
    from repro_torch.topology import make_table2_topologies

    rows = []
    for name, topo in make_table2_topologies().items():
        for mb in FIG8_SIZES_MB:
            rows.append({"topology": name, "size_mb": mb, **{
                label: simulate_scheduled(topo, "AR", mb * 1e6, policy=policy,
                                          intra=intra)[0].makespan
                for label, policy, intra in (("baseline_fifo_s", "baseline", "FIFO"),
                                             ("themis_fifo_s", "themis", "FIFO"),
                                             ("themis_scf_s", "themis", "SCF"))}})
    fifo = [r["baseline_fifo_s"] / r["themis_fifo_s"] for r in rows]
    scf = [r["baseline_fifo_s"] / r["themis_scf_s"] for r in rows]
    return rows, {"avg_speedup_fifo": sum(fifo) / len(fifo),
                  "avg_speedup_scf": sum(scf) / len(scf), "max_speedup_scf": max(scf)}


def fig12_grid():
    """Paper Fig. 12 through the port: each workload's compute time
    calibrated to the paper's Ideal speed-up (``calibrate_compute``), then
    its iteration time under baseline/FIFO, themis/SCF and ideal on the six
    Table-2 topologies, and the speed-ups' summary. Simulated times."""
    import statistics

    from repro_torch.core.workloads import ALL_WORKLOADS, calibrate_compute, iteration_time
    from repro_torch.topology import make_table2_topologies

    topos = list(make_table2_topologies().values())
    rows, summary = [], {}
    for wname, make in ALL_WORKLOADS.items():
        w = make()
        compute_s = calibrate_compute(w, topos, FIG12_PAPER[wname][1])
        themis, ideal = [], []
        for topo in topos:
            b = iteration_time(w, topo, "baseline", intra="FIFO").total_s
            t = iteration_time(w, topo, "themis", intra="SCF").total_s
            i = iteration_time(w, topo, "ideal").total_s
            rows.append({"workload": wname, "topology": topo.name, "baseline_fifo_s": b,
                         "themis_scf_s": t, "ideal_s": i})
            themis.append(b / t)
            ideal.append(b / i)
        summary[wname] = {"compute_s": compute_s, "themis_avg": statistics.mean(themis),
                          "themis_max": max(themis), "ideal_avg": statistics.mean(ideal)}
    return rows, summary


def phase_simulator(state):
    """Fig. 8 and Fig. 12 on the port's simulator (the host, no card). The
    CPU tests hold each value equal to the reference's; this prints them."""
    t0 = time.perf_counter()
    rows8, sum8 = fig8_grid()
    t1 = time.perf_counter()
    rows12, sum12 = fig12_grid()
    t2 = time.perf_counter()
    emit(fig8={"simulated": True, "summary": sum8, "paper": FIG8_PAPER,
               "rows": rows8, "host_seconds": t1 - t0})
    emit(fig12={"simulated": True, "summary": sum12,
                "paper": {k: {"themis_avg": v[0], "ideal_avg": v[1]}
                          for k, v in FIG12_PAPER.items()},
                "rows": rows12, "host_seconds": t2 - t1})


# -- phase 7b: faults, tenancy and traffic ----------------------------------------
# The scenarios of benchmarks/{faults,tenancy,traffic}_study.py at their full
# sizes, through the port. Each is a function here, and a CPU test holds it
# equal to the study's own on every simulated value; the phases print the
# simulated fabric times beside host seconds and gate as the studies do
# (the constants are with the others at the top).


def _gap(a, b):
    """Largest relative gap between two results' float values and the
    number of non-float values (ints, orders, tags, lengths) that differ."""
    if isinstance(a, float) and isinstance(b, float):
        return (0.0 if a == b else abs(a - b) / max(abs(a), abs(b))), 0
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return 0.0, 1
        gaps = [_gap(x, y) for x, y in zip(a, b)]
        return max((g for g, _ in gaps), default=0.0), sum(n for _, n in gaps)
    return 0.0, int(a != b)


def sim_gap(res_a, res_b):
    """``_gap`` over every ``SimResult`` field: (largest relative float gap,
    the fields whose non-float values differ)."""
    import dataclasses

    gaps = {f.name: _gap(getattr(res_a, f.name), getattr(res_b, f.name))
            for f in dataclasses.fields(res_a)}
    return max(g for g, _ in gaps.values()), sorted(k for k, (_, n) in gaps.items() if n)


def faults_identity():
    """``faults_study.identity_part``: with ``faults=None`` both engines give
    the same result, and an empty ``FaultSchedule`` changes nothing but the
    retry counts (all zero)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.faults import FaultSchedule
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    reqs = [CollectiveRequest("AR", 8.0 * MB, issue_time=i * 2e-4) for i in range(8)]

    def run_once(eng, faults):
        return simulate_requests(topo, reqs, chunks_per_collective=8, engine=eng,
                                 check_invariants=True, faults=faults)[0]

    base = {eng: run_once(eng, None) for eng in ("indexed", "reference")}
    empty_same = True
    for eng, res in base.items():
        empty = run_once(eng, FaultSchedule())
        diff = [f for f in res.diff_fields(empty) if f != "group_retries"]
        empty_same &= not diff and not any(empty.group_retries) and not empty.failed_groups
    return {"engines_identical": not base["indexed"].diff_fields(base["reference"]),
            "empty_schedule_identical": empty_same}


def _random_faults(rng, horizon):
    """``faults_study._random_faults``: per dim at most one degradation,
    outage or flap plus an optional straggler burst, and a retry policy."""
    from repro_torch.faults import (BwDegradation, DimOutage, FaultSchedule, LinkFlap,
                                    RetryPolicy, StragglerBurst)

    events = []
    for dim in (0, 1):
        kind = rng.choice(("degrade", "outage", "flap", "none"))
        t0 = rng.uniform(0.1, 0.5) * horizon
        if kind == "degrade":
            events.append(BwDegradation(
                dim=dim, start=t0, end=t0 + rng.uniform(0.2, 0.5) * horizon,
                factor=rng.uniform(0.1, 0.8)))
        elif kind == "outage":
            events.append(DimOutage(
                dim=dim, start=t0, end=t0 + rng.uniform(0.05, 0.2) * horizon))
        elif kind == "flap":
            down = rng.uniform(0.02, 0.06) * horizon
            events.append(LinkFlap(
                dim=dim, start=t0, down_s=down,
                period_s=down + rng.uniform(0.05, 0.15) * horizon,
                count=rng.randint(1, 3)))
        if rng.random() < 0.5:
            s0 = rng.uniform(0.0, 0.4) * horizon
            events.append(StragglerBurst(
                dim=dim, start=s0, end=s0 + rng.uniform(0.2, 0.6) * horizon,
                sigma=rng.uniform(0.05, 0.4)))
    retry = RetryPolicy(timeout_s=rng.uniform(0.02, 0.08) * horizon,
                        backoff_s=rng.uniform(0.01, 0.03) * horizon,
                        max_attempts=rng.choice((3, 8)))
    return FaultSchedule(events=tuple(events), retry=retry)


def faults_chaos():
    """``faults_study.chaos_part``: 24 seeded fault timelines over
    {themis, baseline} x {SCF, FIFO} x {no arbiter, weighted-fair,
    strict-priority}, re-planning on odd seeds under themis, each run on
    both engines with the invariant sanitizer armed."""
    import random

    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.tenancy import FabricArbiter, TenantSpec
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    policies, intras = ("themis", "baseline"), ("SCF", "FIFO")
    arbiters = (None, "weighted-fair", "strict-priority")
    specs = [TenantSpec("a", weight=1.0), TenantSpec("b", weight=3.0, priority=5)]
    results = []
    for i in range(24):
        policy, intra, arb_policy, seed = (policies[i % 2], intras[(i // 2) % 2],
                                           arbiters[(i // 4) % 3], 1000 + i)
        faults = _random_faults(random.Random(seed), FAULTS_HORIZON_S)
        reqs = [CollectiveRequest("AR", 6.0 * MB, issue_time=j * 2e-4,
                                  tenant="a" if j % 3 else "b") for j in range(10)]
        replan = bool(seed % 2) and policy == "themis"

        def run_once(eng):
            arb = (FabricArbiter(arb_policy, specs, quantum_chunks=4, preemption=True)
                   if arb_policy is not None else None)
            return simulate_requests(topo, reqs, policy=policy, chunks_per_collective=8,
                                     intra=intra, arbiter=arb, engine=eng,
                                     check_invariants=True, faults=faults,
                                     replan=replan)[0]

        res_i, res_r = run_once("indexed"), run_once("reference")
        results.append({"policy": policy, "intra": intra, "arbiter": arb_policy,
                        "seed": seed, "replan": replan, "makespan": res_i.makespan,
                        "retries": sum(res_i.group_retries),
                        "failed_groups": len(res_i.failed_groups),
                        "identical": not res_i.diff_fields(res_r)})
    return {"n_scenarios": len(results),
            "all_identical": all(r["identical"] for r in results),
            "total_retries": sum(r["retries"] for r in results),
            "total_failed_groups": sum(r["failed_groups"] for r in results),
            "scenarios": results}


def faults_sweep():
    """``faults_study.sweep_part``: six staggered 64 MiB all-reduces in 16
    chunks, the fat dim degraded to each of ``SWEEP_FACTORS`` from 150 us on,
    with and without Themis re-planning (indexed engine, sanitizer armed)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.faults import BwDegradation, FaultSchedule
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[FAULTS_TOPOLOGY]
    reqs = [CollectiveRequest("AR", float(1 << 26), issue_time=i * 1e-4) for i in range(6)]

    def run_once(faults, replan):
        return simulate_requests(topo, reqs, chunks_per_collective=16, engine="indexed",
                                 check_invariants=True, faults=faults, replan=replan)[0]

    clean = run_once(None, False).makespan
    points = []
    for f in SWEEP_FACTORS:
        faults = FaultSchedule(events=(BwDegradation(dim=1, start=1.5e-4, end=1.0,
                                                     factor=f),))
        plain, replanned = run_once(faults, False), run_once(faults, True)
        points.append({"factor": f, "makespan_clean": clean,
                       "makespan_no_replan": plain.makespan,
                       "makespan_replan": replanned.makespan,
                       "inflation_no_replan": plain.makespan / clean,
                       "inflation_replan": replanned.makespan / clean,
                       "replan_speedup": plain.makespan / replanned.makespan})
    worst = points[-1]["replan_speedup"]  # factors descend: the last is the harshest
    return {"factors": list(SWEEP_FACTORS), "points": points, "gate": REPLAN_GATE,
            "worst_severity_speedup": worst, "gate_passed": worst >= REPLAN_GATE}


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_faults(state):
    """Fault injection and re-planning through the port (host only): the
    fault-free identity, 24 chaos scenarios equal across the port's two
    engines with the sanitizer armed, and re-planning's speed-up of at
    least ``REPLAN_GATE`` at the harshest degradation."""
    identity, s_id = _timed(faults_identity)
    chaos, s_chaos = _timed(faults_chaos)
    sweep, s_sweep = _timed(faults_sweep)
    emit(faults={"simulated": True, "identity": identity, "chaos": chaos, "sweep": sweep,
                 "host_seconds": {"identity": s_id, "chaos": s_chaos, "sweep": s_sweep}})
    assert identity["engines_identical"], "fault-free engines differ"
    assert identity["empty_schedule_identical"], "an empty FaultSchedule changed a result"
    bad = [(r["seed"], r["policy"], r["intra"], r["arbiter"]) for r in chaos["scenarios"]
           if not r["identical"]]
    assert not bad, f"engines differ under faults in {len(bad)}/24 scenarios: {bad}"
    assert sweep["gate_passed"], (
        f"re-planning speed-up {sweep['worst_severity_speedup']} < {REPLAN_GATE} "
        f"at factor {SWEEP_FACTORS[-1]}")


def _tenancy_scenario(name):
    """``tenancy_study._fairness_tenants`` / ``_workload_tenants`` /
    ``_ablation_tenants``: (specs, requests)."""
    from repro_torch.core.workloads import make_gnmt, make_resnet152
    from repro_torch.tenancy import TenantJob, TenantSpec, synthetic_requests

    if name == "fairness":
        specs = [TenantSpec("batch", weight=1.0),
                 TenantSpec("prod", weight=1.0, priority=1, slo_slowdown=1.5)]
        return specs, (synthetic_requests("batch", "AR", 400 * MB, 3)
                       + synthetic_requests("prod", "AR", 10 * MB, 12, gap_s=0.0005,
                                            start_s=0.0002))
    if name == "workloads":
        light = TenantJob(TenantSpec("resnet", weight=1.0, priority=1, slo_slowdown=2.0,
                                     arrival_offset_s=0.005, iterations=2, n_buckets=8),
                          make_resnet152())
        heavy = TenantJob(TenantSpec("gnmt", weight=1.0, iterations=2, n_buckets=2),
                          make_gnmt())
        return [light.spec, heavy.spec], light.requests() + heavy.requests()
    specs = [TenantSpec(n) for n in ("a", "b", "c")]
    reqs = []
    for i, s in enumerate(specs):
        reqs += synthetic_requests(s.name, "AR", 200 * MB, 3, gap_s=3 * 0.001,
                                   start_s=i * 0.001)
    return specs, reqs


def tenancy_sweep(topo, name):
    """``tenancy_study._sweep``: the scenario under each arbiter policy, with
    isolated latencies as the slowdowns' base; (cells, (specs, reqs, iso))."""
    from repro_torch.tenancy import (FabricArbiter, fairness_index, isolated_latencies,
                                     mean_slowdown, simulate_fabric, slo_violations,
                                     tenant_reports)

    specs, reqs = _tenancy_scenario(name)
    iso = isolated_latencies(topo, reqs, chunks_per_collective=TENANCY_CHUNKS)
    spec_map = {s.name: s for s in specs}
    iso_mean = {t: sum(v) / len(v) for t, v in iso.items()}
    cells = {}
    for policy in TENANCY_POLICIES:
        arb = FabricArbiter(policy, specs, isolated_latency=iso_mean)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb,
                                 chunks_per_collective=TENANCY_CHUNKS)
        reps = tenant_reports(res, reqs, iso, spec_map)
        cells[policy] = {
            "jain": fairness_index(reps), "mean_slowdown": mean_slowdown(reps),
            "makespan_ms": res.finish_time() * 1e3, "slo_violations": slo_violations(reps),
            "preemptions": arb.preempt_count,
            "tenants": {t: {"mean_slowdown": r.mean_slowdown, "finish_ms": r.finish_s * 1e3,
                            "bw_share": r.bw_share, "slo_violated": r.slo_violated}
                        for t, r in reps.items()}}
    return cells, (specs, reqs, iso)


def tenancy_ablation(topo):
    """``tenancy_study._ablation``: three staggered tenants under
    weighted-fair, one shared Dim Load Tracker against one per tenant."""
    from repro_torch.tenancy import (FabricArbiter, isolated_latencies, mean_slowdown,
                                     simulate_fabric, tenant_reports)

    specs, reqs = _tenancy_scenario("ablation")
    spec_map = {s.name: s for s in specs}
    iso = isolated_latencies(topo, reqs, chunks_per_collective=32)
    out = {}
    for mode, shared in (("shared", True), ("per_tenant", False)):
        arb = FabricArbiter("weighted-fair", specs)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb, shared_tracker=shared,
                                 chunks_per_collective=32)
        reps = tenant_reports(res, reqs, iso, spec_map)
        out[mode] = {"makespan_ms": res.finish_time() * 1e3,
                     "mean_slowdown": mean_slowdown(reps)}
    out["shared_wins"] = (
        out["shared"]["makespan_ms"] < out["per_tenant"]["makespan_ms"]
        or out["shared"]["mean_slowdown"] < out["per_tenant"]["mean_slowdown"])
    return out


def tenancy_preemption_cost(topo, specs, reqs, iso):
    """``tenancy_study._preemption_cost``: the fairness scenario under
    weighted-fair at each re-arm penalty of ``PREEMPT_PENALTIES_S``."""
    from repro_torch.tenancy import (FabricArbiter, fairness_index, simulate_fabric,
                                     tenant_reports)

    spec_map = {s.name: s for s in specs}
    out = {}
    for penalty in PREEMPT_PENALTIES_S:
        arb = FabricArbiter("weighted-fair", specs, preempt_penalty_s=penalty)
        res, _ = simulate_fabric(topo, reqs, arbiter=arb, chunks_per_collective=TENANCY_CHUNKS)
        reps = tenant_reports(res, reqs, iso, spec_map)
        out[f"{penalty * 1e6:.0f}us"] = {
            "makespan_ms": res.finish_time() * 1e3, "prod_slowdown": reps["prod"].mean_slowdown,
            "jain": fairness_index(reps), "preemptions": arb.preempt_count}
    return out


def tenancy_study():
    """``tenancy_study.run``'s report, without its file: on each of
    ``TENANCY_TOPOLOGIES`` the fairness and workloads sweeps, the
    preemption cost and the tracker ablation, and the study's two checks."""
    from repro_torch.topology import make_table2_topologies

    topos = make_table2_topologies()
    report = {"scenarios": {}, "checks": {}}
    wf_beats_fifo, shared_wins = [], []
    for tname in TENANCY_TOPOLOGIES:
        topo = topos[tname]
        fairness, ctx = tenancy_sweep(topo, "fairness")
        workloads, _ = tenancy_sweep(topo, "workloads")
        abl = tenancy_ablation(topo)
        report["scenarios"][tname] = {
            "fairness": fairness, "workloads": workloads,
            "preemption_cost": tenancy_preemption_cost(topo, *ctx),
            "tracker_ablation": abl}
        if fairness["weighted-fair"]["jain"] > fairness["fifo"]["jain"]:
            wf_beats_fifo.append(tname)
        if abl["shared_wins"]:
            shared_wins.append(tname)
    report["checks"] = {"weighted_fair_beats_fifo_jain_on": wf_beats_fifo,
                        "shared_tracker_wins_on": shared_wins}
    return report


def phase_tenancy(state):
    """Multi-tenant arbitration through the port (host only): the study's
    checks hold on every topology, as in ``BENCH_tenancy.json``."""
    report, secs = _timed(tenancy_study)
    emit(tenancy={"simulated": True, **report, "host_seconds": secs})
    for check, on in report["checks"].items():
        assert list(on) == list(TENANCY_TOPOLOGIES), f"{check} holds only on {on}"


def traffic_costs():
    """The serving costs of the traffic study: llama3-8b, 4 x 512, tp 8, from
    the port's config and roofline."""
    from repro_torch.traffic import serving_costs_from_arch

    return serving_costs_from_arch(TRAFFIC_ARCH, **TRAFFIC_COSTS)


def _serving_job(costs, *, gen_tokens, n_requests, arrival_gap_s):
    from repro_torch.tenancy import TenantJob, TenantSpec
    from repro_torch.traffic import serving_traffic

    return TenantJob(TenantSpec("serve", weight=2.0, slo_slowdown=1.5),
                     traffic_builder=lambda job: serving_traffic(
                         gen_tokens=gen_tokens, n_requests=n_requests,
                         arrival_gap_s=arrival_gap_s, **costs))


def _mixed_graph(costs, *, iterations, gen_tokens, n_requests, arrival_gap_s=2e-3,
                 n_buckets=16):
    """``traffic_study._mixed_graph``: closed-loop ResNet-152 training beside
    a serving tenant, as one graph, and the two tenants' specs."""
    from repro_torch.core.workloads import make_resnet152
    from repro_torch.tenancy import TenantJob, TenantSpec, tenant_traffic

    train = TenantJob(TenantSpec("train", weight=1.0, iterations=iterations,
                                 n_buckets=n_buckets), make_resnet152())
    serve = _serving_job(costs, gen_tokens=gen_tokens, n_requests=n_requests,
                         arrival_gap_s=arrival_gap_s)
    return tenant_traffic([train, serve]), [train.spec, serve.spec]


def traffic_equivalence(costs):
    """``traffic_study.equivalence_gate``'s scenarios: a fixed-time stream
    through the IR against ``simulate_requests``, then the 1F1B pipeline, the
    serving chains and the mixed tenants, each plain, under weighted-fair
    and with DCN stragglers, on the indexed and reference engines and through
    ``simulate_batch``. Returns the pairs of results under the study's
    labels: ``exact`` (the IR against ``simulate_requests``, each batch
    against indexed) and ``engines`` (indexed against reference)."""
    from repro_torch.core import simulate_requests
    from repro_torch.core.batch import Scenario, simulate_batch
    from repro_torch.core.requests import CollectiveRequest
    from repro_torch.tenancy import FabricArbiter
    from repro_torch.topology import make_tpu_pod_topology
    from repro_torch.traffic import (from_requests, pipeline_traffic, serving_traffic,
                                     simulate_traffic)

    topo = make_tpu_pod_topology(2, 8, 8)
    reqs = [CollectiveRequest(["AR", "RS", "AG"][i % 3], (4 + 7 * (i % 5)) * MB,
                              issue_time=i * 1.1e-4, priority=i % 2, stream=f"s{i % 2}")
            for i in range(14)]
    r_plain, _ = simulate_requests(topo, reqs, chunks_per_collective=8)
    r_graph, _ = simulate_traffic(topo, from_requests(reqs), chunks_per_collective=8)
    out = {"exact": {"fixed-time-ir-vs-simulate_requests": (r_graph, r_plain)},
           "engines": {}}
    graphs = {
        "pipeline-1f1b": pipeline_traffic(stages=4, microbatches=6, fwd_s=1e-3, bwd_s=2e-3,
                                          act_bytes=8 * MB, grad_ar_bytes=60 * MB,
                                          n_grad_buckets=4),
        "serving-chains": serving_traffic(gen_tokens=12, n_requests=3,
                                          arrival_gap_s=1.5e-3, **costs)}
    mixed, specs = _mixed_graph(costs, iterations=2, gen_tokens=8, n_requests=2)
    graphs["mixed-tenant"] = mixed
    jit_topo = make_tpu_pod_topology(2, 8, 8, dcn_straggler_sigma=0.4)
    cases = [("plain", topo, None, 0.0, 0),
             ("arbiter:weighted-fair", topo, lambda: FabricArbiter("weighted-fair", specs),
              0.0, 0),
             ("dcn-straggler", jit_topo, None, 0.05, 3)]
    for gname, graph in graphs.items():
        for cname, t, factory, jitter, seed in cases:
            kw = dict(chunks_per_collective=6, jitter=jitter, seed=seed)
            ri, _ = simulate_traffic(t, graph, engine="indexed",
                                     arbiter=factory() if factory else None, **kw)
            rr, _ = simulate_traffic(t, graph, engine="reference",
                                     arbiter=factory() if factory else None, **kw)
            sc = Scenario(t, traffic=graph, chunks_per_collective=6, jitter=jitter,
                          seed=seed, arbiter_factory=factory)
            rb = simulate_batch([sc])[0]
            label = f"{gname}/{cname}"
            out["engines"][label] = (ri, rr)
            out["exact"][label + "/batch"] = (rb, ri)
    return out


def traffic_mixed_tenancy(costs):
    """``traffic_study.mixed_tenancy``: 3 training iterations beside 3
    serving requests of 32 tokens on a 2 x 8 x 8 pod under fifo,
    weighted-fair and slo-aware through ``simulate_batch``: decode
    p50/p95/p99, prefill p99 and the training slowdown."""
    from repro_torch.core.batch import BatchCaches, Scenario, simulate_batch
    from repro_torch.core.workloads import make_resnet152
    from repro_torch.tenancy import FabricArbiter, TenantJob, TenantSpec
    from repro_torch.topology import make_tpu_pod_topology
    from repro_torch.traffic import simulate_traffic

    topo = make_tpu_pod_topology(2, 8, 8)
    iterations, gen_tokens = 3, 32
    graph, specs = _mixed_graph(costs, iterations=iterations, gen_tokens=gen_tokens,
                                n_requests=3)
    train_alone = TenantJob(TenantSpec("train", iterations=iterations, n_buckets=16),
                            make_resnet152())
    res_train, _ = simulate_traffic(topo, train_alone.traffic(), chunks_per_collective=16)
    train_iso = res_train.finish_time()
    serve_alone = _serving_job(costs, gen_tokens=gen_tokens, n_requests=3,
                               arrival_gap_s=2e-3)
    res_serve, _ = simulate_traffic(topo, serve_alone.traffic(), chunks_per_collective=16)
    decode_iso = res_serve.stream_stats()["serve/decode"]
    iso_lat = {"serve": decode_iso.latency_mean, "train": train_iso / max(1, iterations)}
    scenarios = [Scenario(topo, traffic=graph, chunks_per_collective=16,
                          arbiter_factory=(lambda p=pol: FabricArbiter(
                              p, specs, isolated_latency=iso_lat)), label=pol)
                 for pol in ("fifo", "weighted-fair", "slo-aware")]
    results = simulate_batch(scenarios, caches=BatchCaches())
    out = {"topology": topo.name, "iterations": iterations, "gen_tokens": gen_tokens,
           "train_isolated_finish_s": train_iso,
           "decode_isolated_p99_s": decode_iso.latency_p99, "policies": {}}
    for sc, res in zip(scenarios, results):
        dec = res.stream_stats()["serve/decode"]
        train_fin = res.stream_stats(by="tenant")["train"].finish
        out["policies"][sc.label] = {
            "decode_p50_s": dec.latency_p50, "decode_p95_s": dec.latency_p95,
            "decode_p99_s": dec.latency_p99,
            "prefill_p99_s": res.stream_stats()["serve/prefill"].latency_p99,
            "train_finish_s": train_fin, "train_slowdown": train_fin / train_iso}
    return out


def traffic_dcn_jitter(costs):
    """``traffic_study.dcn_jitter``: the mixed scenario (2 iterations, 2
    requests of 24 tokens) under weighted-fair with a lognormal straggler
    sigma of 0, 0.25 and 0.5 on the pod dim, 4 seeds each: decode p99."""
    from repro_torch.core.batch import BatchCaches, Scenario, simulate_batch
    from repro_torch.tenancy import FabricArbiter
    from repro_torch.topology import make_tpu_pod_topology

    sigmas, seeds = (0.0, 0.25, 0.5), range(4)
    out = {"sigmas": {}}
    caches = BatchCaches()
    for sigma in sigmas:
        topo = make_tpu_pod_topology(2, 8, 8, dcn_straggler_sigma=sigma)
        graph, specs = _mixed_graph(costs, iterations=2, gen_tokens=24, n_requests=2)
        scenarios = [Scenario(topo, traffic=graph, chunks_per_collective=8, seed=seed,
                              arbiter_factory=(lambda: FabricArbiter("weighted-fair", specs)))
                     for seed in seeds]
        results = simulate_batch(scenarios, caches=caches)
        p99s = [r.stream_stats()["serve/decode"].latency_p99 for r in results]
        fins = [r.finish_time() for r in results]
        out["sigmas"][str(sigma)] = {"decode_p99_mean_s": sum(p99s) / len(p99s),
                                     "decode_p99_max_s": max(p99s),
                                     "finish_mean_s": sum(fins) / len(fins),
                                     "seeds": len(seeds)}
    base = out["sigmas"]["0.0"]["decode_p99_mean_s"]
    worst = out["sigmas"][str(sigmas[-1])]["decode_p99_mean_s"]
    out["tail_inflation"] = worst / base if base else 0.0
    return out


def _fit_exponent(points):
    xs = [math.log(n) for n, _ in points]
    ys = [math.log(s) for _, s in points]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def traffic_long_stream(costs, sizes=LONG_STREAM_SIZES):
    """``traffic_study.long_stream``: the mixed scenario grown to about 1M
    stage-ops (``sizes`` of (iterations, decode tokens)); at each size the
    indexed and compiled engines on the same task arrays, timed (best of 3
    up to 60k stage-ops, else 1; compiled best of 2 or more). The host
    seconds and their log-log exponent are printed, not gated: a timing fit
    on a shared host is no correctness check. ``compiled_equal`` is."""
    from repro_torch.core import simulate
    from repro_torch.core.batch import BatchCaches, Scenario
    from repro_torch.topology import make_tpu_pod_topology

    def best(repeat, **kw):
        out, secs = None, float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            out = simulate(topo, groups, task_arrays=ta, **kw)
            secs = min(secs, time.perf_counter() - t0)
        return out, secs

    topo = make_tpu_pod_topology(2, 8, 8)
    caches = BatchCaches()
    detail = []
    for iterations, gen_tokens in sizes:
        graph, _ = _mixed_graph(costs, iterations=iterations, gen_tokens=gen_tokens,
                                n_requests=2, arrival_gap_s=1e-3)
        groups, ta = caches.groups_and_arrays(Scenario(topo, traffic=graph,
                                                       chunks_per_collective=32))
        kw = graph.sim_kwargs()
        repeat = 3 if ta.n_tasks <= 60_000 else 1
        res, secs = best(repeat, engine="indexed", **kw)
        equal = not res.diff_fields(simulate(topo, groups, task_arrays=ta,
                                             engine="compiled", **kw))
        _, secs_c = best(max(repeat, 2), engine="compiled", **kw)
        detail.append({"iterations": iterations, "gen_tokens": gen_tokens,
                       "stage_ops": ta.n_tasks,
                       "stage_ops_match_groups": ta.n_tasks == sum(
                           len(c.schedule) for g in groups for c in g),
                       "makespan_s": res.makespan, "compiled_equal": equal,
                       "indexed_s": secs, "compiled_s": secs_c,
                       "compiled_stage_ops_per_sec": ta.n_tasks / secs_c})
    return {"points": detail,
            "exponent": _fit_exponent([(p["stage_ops"], p["indexed_s"]) for p in detail]),
            "compiled_exponent": _fit_exponent([(p["stage_ops"], p["compiled_s"])
                                                for p in detail]),
            "compiled_speedup_largest": detail[-1]["indexed_s"] / detail[-1]["compiled_s"],
            "largest_stage_ops": detail[-1]["stage_ops"]}


def phase_traffic(state):
    """Dependency-gated traffic through the port (host only): the
    equivalence gate (the IR equals ``simulate_requests`` and the batch
    equals indexed, exactly; indexed and reference within
    ``TRAFFIC_ENGINE_RTOL`` on float values and equal on the rest), the mixed
    tenancy, the DCN jitter and the long stream (compiled equals indexed at
    every size)."""
    costs, s_costs = _timed(traffic_costs)
    equiv, s_equiv = _timed(traffic_equivalence, costs)
    mixed, s_mixed = _timed(traffic_mixed_tenancy, costs)
    dcn, s_dcn = _timed(traffic_dcn_jitter, costs)
    long, s_long = _timed(traffic_long_stream, costs)
    gaps = {kind: {label: sim_gap(*pair) for label, pair in pairs.items()}
            for kind, pairs in equiv.items()}
    del equiv
    emit(traffic={"simulated": True, "serving_costs": costs,
                  "equivalence": {kind: {label: {"max_rel_gap": g, "other_fields_differ": f}
                                         for label, (g, f) in by_label.items()}
                                  for kind, by_label in gaps.items()},
                  "indexed_vs_reference_max_rel_gap": max(
                      g for g, _ in gaps["engines"].values()),
                  "mixed_tenancy": mixed, "dcn_jitter": dcn, "long_stream": long,
                  "host_seconds": {"costs": s_costs, "equivalence": s_equiv,
                                   "mixed_tenancy": s_mixed, "dcn_jitter": s_dcn,
                                   "long_stream": s_long}})
    for kind, rtol in (("exact", 0.0), ("engines", TRAFFIC_ENGINE_RTOL)):
        for label, (gap, fields) in gaps[kind].items():
            assert not fields and gap <= rtol, (
                f"traffic equivalence {label}: largest relative gap {gap} "
                f"(limit {rtol}), other values differ in {fields}")
    bad = [p["stage_ops"] for p in long["points"]
           if not (p["compiled_equal"] and p["stage_ops_match_groups"])]
    assert not bad, f"long stream: compiled differs from indexed at {bad} stage-ops"


def _wave_stream(n_requests):
    """The wave stream's chunk groups and issue times: ``n_requests``
    requests of one baseline RS schedule, each chunk a group of its own."""
    from repro_torch.core import schedule_collective
    from repro_torch.topology import make_table2_topologies

    topo = make_table2_topologies()[WAVE_TOPOLOGY]
    one = schedule_collective(topo, "RS", WAVE_BYTES, WAVE_CHUNKS, "baseline")
    groups = [[c] for _ in range(n_requests) for c in one]
    issue = [r * WAVE_PERIOD_S for r in range(n_requests) for _ in one]
    return topo, groups, issue


def _tiled_wave_arrays(one, n_requests):
    """``wave_arrays`` of ``n_requests`` requests from one request's (issued
    at 0): the arrays tiled, each request's issue time added."""
    import numpy as np

    issue, occupy, fixed, dims = one
    offsets = np.arange(n_requests) * WAVE_PERIOD_S
    return ((offsets[:, None] + issue[None, :]).ravel(), np.tile(occupy, (n_requests, 1)),
            np.tile(fixed, (n_requests, 1)), np.tile(dims, (n_requests, 1)))


def _rel_err(got, want):
    import numpy as np

    return float(np.max(np.abs(got - want) / np.abs(want)))


def _cuda_event_ms(fn, warmup=3, reps=10):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warmup`` calls."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def phase_wave(state):
    """The compiled engine's wave kernel (``wave_done_times``, vectorized
    torch) on the card: the stream at 64, 208 and 640 requests of 4096
    chunks, against the port's ``simulate(engine="compiled", fusion=False)``
    at 64 requests, against its own CPU run and the sequential plain version
    at 640, and a second card call at 640 equal to the first."""
    import numpy as np
    import torch

    from repro_torch.core import engine_compiled as ec
    from repro_torch.core import simulate

    topo, groups, issue = _wave_stream(1)
    one = ec.wave_arrays(topo, groups, issue)
    topo, groups, issue = _wave_stream(16)
    want = ec.wave_arrays(topo, groups, issue)
    tiled_equal = all(np.array_equal(a, w) for a, w in zip(_tiled_wave_arrays(one, 16), want))
    assert tiled_equal, "tiled wave arrays differ from wave_arrays at 16 requests"
    arrays = {n: _tiled_wave_arrays(one, n) for n in WAVE_REQUESTS}
    ec.launches = 0
    done = {n: ec.wave_done_times(*arrays[n]) for n in WAVE_REQUESTS}
    again = ec.wave_done_times(*arrays[WAVE_REQUESTS[-1]])
    launches = ec.launches
    assert launches == len(WAVE_REQUESTS) + 1, launches
    n = WAVE_REQUESTS[0]
    topo, groups, issue = _wave_stream(n)
    t0 = time.perf_counter()
    res = simulate(topo, groups, engine="compiled", issue_times=issue, fusion=False)
    host_s = time.perf_counter() - t0
    assert ec.LAST_FALLBACK is None, ec.LAST_FALLBACK
    err_sim = _rel_err(done[n], np.asarray(res.group_finish))
    del groups, issue, res
    big = WAVE_REQUESTS[-1]
    t0 = time.perf_counter()
    cpu = ec.wave_done_times(*arrays[big], device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = ec.wave_done_times_plain(*arrays[big])
    plain_s = time.perf_counter() - t0
    err_cpu, err_plain = _rel_err(done[big], cpu), _rel_err(done[big], plain)
    same = bool(np.array_equal(done[big], again))
    rows = []
    for n in WAVE_REQUESTS:
        issue_t, occupy, fixed, dims = (torch.as_tensor(x, device="cuda") for x in arrays[n])
        C, R = occupy.shape
        ms = _cuda_event_ms(lambda: ec._wave_scan(issue_t, occupy, fixed, dims))
        call_ms = _cuda_event_ms(lambda: ec.wave_done_times(*arrays[n]), reps=5)
        # each input read once (issue C, occupy, fixed and dims C x R, 8 bytes
        # each), the done times written once (C); five float64 operations per
        # chunk and rank in the closed form
        bound_ms, bound_by = _bound(8 * (2 * C + 3 * C * R), 5 * C * R, "float64")
        rows.append({"requests": n, "chunks": C, "ranks": R, "ms": ms, "call_ms": call_ms,
                     "stage_ops_per_s": C * R / (ms * 1e-3), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_fraction": bound_ms / ms})
        del issue_t, occupy, fixed, dims
    checks = {"tiled_arrays_equal_wave_arrays_at_16": tiled_equal,
              "rel_err_vs_simulate_compiled_at_64": err_sim,
              "rel_err_vs_cpu_at_640": err_cpu, "rel_err_vs_plain_at_640": err_plain,
              "second_call_equal": same, "rtol": WAVE_RTOL}
    emit(wave={"card": state["card"], "rows": rows, "checks": checks,
               "host_simulate_compiled_s_at_64": host_s, "cpu_torch_s_at_640": cpu_s,
               "plain_s_at_640": plain_s, "launches": launches})
    assert err_sim <= WAVE_RTOL, f"wave vs simulate_compiled: {err_sim}"
    assert err_cpu <= WAVE_RTOL, f"wave card vs cpu: {err_cpu}"
    assert err_plain <= WAVE_RTOL, f"wave card vs plain: {err_plain}"
    assert same, "wave: a second card call differs"
    top = rows[-1]
    state["wave_kernel"] = {
        "name": "wave_done_times", "route": "torch", "path": "simulator",
        "source": "src/repro_torch/core/engine_compiled.py",
        "replaces": "src/repro/core/engine_compiled.py:962 (jax.jit, not Pallas)",
        "launches": launches, "max_abs_err": float(np.max(np.abs(done[big] - plain))),
        "ms": top["ms"], "plain_ms": plain_s * 1e3, "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": None, "call_ms": top["call_ms"],
        "cpu_torch_ms": cpu_s * 1e3, "stage_ops_per_s": top["stage_ops_per_s"],
        "shape": {"chunks": top["chunks"], "ranks": top["ranks"], "dtype": "float64/int64"},
        "plain": "wave_done_times_plain: the sequential loop, float64 on the host CPU",
        "library": "none: no single PyTorch call computes a segmented max-plus scan"}


def phase_times(state):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    hb, hs, hd = HYB_TRAIN_X
    kernels = [
        # K1 at llama3-8b's prefill shape: q (4,512,32,128), k/v (4,528,8,128)
        _time_flash(state, gen, ARCH, BATCH, PROMPT, 32, 8, 128, PROMPT + GEN, 0,
                    iters=50),
        _time_rmsnorm(state, gen, ARCH, (BATCH, PROMPT, 4096)),
        # K3, K1 and K2 at recurrentgemma-2b's prefill shapes
        _time_rglru(state, gen, HYB_ARCH, BATCH, HYB_PROMPT, hd, True),
        _time_flash(state, gen, HYB_ARCH, BATCH, HYB_PROMPT, HYB["h"], HYB["kv"],
                    HYB["d"], HYB_PROMPT, HYB["window"], iters=20),
        _time_rmsnorm(state, gen, HYB_ARCH, (BATCH, HYB_PROMPT, hd)),
        # K1 and K2 at qwen2.5-3b's training shapes: q (4,1024,16,128),
        # k/v (4,1024,2,128); x (4,1024,2048)
        _time_flash(state, gen, "train", TRAIN_BATCH, TRAIN_SEQ, QWEN["h"],
                    QWEN["kv"], QWEN["d"], TRAIN_SEQ, 0, iters=50),
        _time_rmsnorm(state, gen, "train", (TRAIN_BATCH, TRAIN_SEQ, QWEN["d_model"])),
        # K1's and K2's backward kernels at the same training shapes
        _time_attention_backward(state, gen, "train", TRAIN_BATCH, TRAIN_SEQ,
                                 QWEN["h"], QWEN["kv"], QWEN["d"], 0, 50),
        _time_rmsnorm_backward(state, gen, "train",
                               (TRAIN_BATCH, TRAIN_SEQ, QWEN["d_model"]),
                               2 * QWEN["layers"] + 1),
        # K1, K2 and K3, forward and backward, at recurrentgemma-2b's training
        # shapes: q (2,4096,10,256), k/v (2,4096,1,256), window 2048;
        # x, a, b (2,4096,2560)
        _time_flash(state, gen, "hybrid_train", hb, hs, HYB["h"], HYB["kv"],
                    HYB["d"], hs, HYB["window"], iters=20),
        _time_attention_backward(state, gen, "hybrid_train", hb, hs, HYB["h"],
                                 HYB["kv"], HYB["d"], HYB["window"], 20),
        _time_rmsnorm(state, gen, "hybrid_train", HYB_TRAIN_X),
        _time_rmsnorm_backward(state, gen, "hybrid_train", HYB_TRAIN_X, 53),
        _time_rglru(state, gen, "hybrid_train", hb, hs, hd, False),
        _time_rglru_backward(state, gen, hb, hs, hd),
        # K1 and K2 at the two new prefills: qwen2.5-14b q (4,512,40,128),
        # k/v (4,528,8,128), x (4,512,5120); granite-34b q (4,512,48,128),
        # k/v (4,528,1,128), x (4,512,6144)
        _time_flash(state, gen, DENSE14B, *QWEN14B_ATTN, iters=50),
        _time_rmsnorm(state, gen, DENSE14B, (BATCH, PROMPT, QWEN14B["d_model"])),
        _time_flash(state, gen, GRANITE, *GRANITE_ATTN, iters=50),
        _time_rmsnorm(state, gen, GRANITE, (BATCH, PROMPT, GRANITE_D["d_model"])),
    ]
    emit(rmsnorm_decode_shape=_time_rmsnorm(state, gen, ARCH, (BATCH, 1, 4096)))
    emit(times={"card": state["card"], "peak_bytes_per_s": PEAK_BYTES_PER_S,
                "peak_ops_per_s": PEAK_OPS_PER_S,
                **{f"{k}_{m}": v
                   for k in ("train", "hybrid_train", "train_dots", "hybrid_train_dots")
                   for m, v in (("step_ms", state[k]["step_ms"]),
                                ("step_floor_ms", state[k]["floor_ms"]),
                                ("floor_share", state[k]["floor_ms"]
                                 / state[k]["step_ms"]),
                                ("model_flops_share", state[k]["model_flops_share"]))}})
    state["kernels"] = kernels + [state["wave_kernel"]]


if __name__ == "__main__":
    sys.exit(main())
