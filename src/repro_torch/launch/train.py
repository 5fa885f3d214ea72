"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 6 --batch 4 --seq 1024 --dp-sync gspmd [--mesh 1x1] \
        [--device cuda] [--ckpt-dir runs/ckpt --ckpt-every 50]
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --reduced --device cpu --mesh 2x2x2 --dp-sync themis
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --reduced --device cpu --mesh 2x2 \
        --dp-sync gspmd --ckpt-dir runs/ckpt --ckpt-every 2

Port of ``repro/launch/train.py``: the synthetic data pipeline with host
prefetch, AdamW with a cosine learning rate, gradient clipping, gradient
accumulation, Themis or baseline hierarchical gradient sync (``--dp-sync``)
with optional int8 compression, and periodic atomic checkpoints written in
a background thread (``--ckpt-dir``, ``--ckpt-every``; ``repro_torch.ckpt``,
the reference's format). With ``--ckpt-dir``, a rerun of the same command
resumes from the newest valid checkpoint, with the data cursor where it
stopped. It runs in one process on a 1x1 mesh, or under ``torchrun`` with
one process per rank of ``--mesh DATAxMODEL[xPOD]``; ranks of a CUDA run
take the card of their ``LOCAL_RANK``. ``--dp-sync gspmd`` on a process
group runs the sharded step (DTensors; ``train/step.py``), each rank fed
the rows of ``batch_pspec``. On a mesh, every rank takes part in a
checkpoint and rank 0 writes it: the GSPMD state as global arrays (a
checkpoint restores onto any mesh), the Themis state in the reference's
global layout, which restores onto the same world size and chunk orders
only (``ckpt/checkpoint.py``).

Beyond the reference's flags: ``--device`` (``cuda`` by default),
``--layers`` (cut the depth; 0 keeps the config's), ``--remat-policy``
(``full`` or ``dots``, the config's ``remat_policy``; ``models/common.py``)
and ``--fixed-batch`` (train on step 0's batch at every step, an
overfitting check). The audio family's batches carry the stub frontend's
frames (``--batch`` x ``num_frames`` x d_model bf16 standard normals,
drawn once from the seed; each rank its rows), which its loss needs and
the reference's driver does not draw. Step time is the host clock around
a step that ends in a synchronisation.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import (
    AsyncCheckpointer,
    check_themis,
    latest_step,
    read_extra,
    restore,
    themis_global,
    themis_local,
    themis_record,
)
from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
from repro_torch.data.pipeline import (
    Prefetcher,
    SyntheticLM,
    local_rows,
    rows_to_dtensor,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, parse_mesh
from repro_torch.models import build_model
from repro_torch.train.step import (
    gspmd_init_state,
    make_gspmd_train_step,
    make_themis_train_step,
    sharded,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--remat-policy", choices=["full", "dots"], default=None,
                    help="activation checkpointing inside a block (default: "
                         "the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL[xPOD]")
    ap.add_argument("--dp-sync", default="gspmd",
                    choices=["gspmd", "themis", "hier_baseline"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixed-batch", action="store_true")
    return ap


def _device(name: str) -> torch.device:
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


def main(argv=None, on_step: Callable | None = None) -> dict:
    """Train; returns the per-step losses, gnorms, lrs and times, the peak
    device memory, the chunk orders, the step it started from and the
    checkpoints it wrote and restored, and the final state (``params``,
    ``opt``, ``step_fn``, ``batch``). ``on_step(step, metrics)`` is called
    after each step has finished on the device."""
    args = _parser().parse_args(argv)
    dev = _device(args.device)
    shape, names = parse_mesh(args.mesh)
    sizes = dict(zip(names, shape))
    owns_group = not dist.is_initialized()
    mesh = Mesh(shape, names, dev)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    try:
        return _train(args, dev, mesh, sizes, lead, on_step)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _frames(cfg, args, mesh, dev, seed: int) -> dict:
    """The audio family's stub frames for this rank's rows of the batch
    (``{}`` for the other families)."""
    if cfg.family != "audio":
        return {}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((args.batch, cfg.num_frames, cfg.d_model))
    frames = {"frames": torch.as_tensor(x).to(torch.bfloat16)}
    return {k: v.to(dev) for k, v in
            local_rows(frames, mesh, args.dp_sync).items()}


def _train(args, dev, mesh, sizes, lead: bool, on_step) -> dict:
    log = print if lead else (lambda *a, **k: None)
    cfg = get_arch(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if args.remat_policy:
        cfg = cfg.replace(remat_policy=args.remat_policy)
    api = build_model(cfg)
    parallel = ParallelConfig(data=sizes.get("data", 1),
                              model=sizes.get("model", 1),
                              pods=sizes.get("pod", 1), dp_sync=args.dp_sync,
                              compression=args.compression)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1),
                       microbatch=args.microbatch,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)

    orders = None
    if args.dp_sync == "gspmd":
        step_fn = make_gspmd_train_step(api, mesh, parallel, tcfg)
        params, opt = gspmd_init_state(api, mesh, parallel, tcfg.seed, dev)
    else:
        step_fn, init_state, orders = make_themis_train_step(
            api, mesh, parallel, tcfg)
        params, opt = init_state(tcfg.seed, dev)
        uniq = sorted(set(orders))
        log(f"[train] themis chunk orders ({len(orders)} chunks): "
            + ", ".join("->".join(o) or "(one rank: no collective)"
                        for o in uniq))
    log(f"[train] {cfg.name} layers={cfg.num_layers} reduced={args.reduced} "
        f"device={dev} mesh={args.mesh} dp_sync={args.dp_sync} "
        f"remat={cfg.remat_policy if cfg.remat else 'off'} "
        f"batch={args.batch}x{args.seq}")
    themis = orders is not None

    def ckpt_state():
        return (params, themis_global(opt, mesh) if themis else opt)

    start_step, ckpt, restored = 0, None, None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=tcfg.keep_checkpoints)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            t0 = time.perf_counter()
            if themis:
                check_themis(read_extra(args.ckpt_dir, last), mesh, orders)
            (params, state), extra = restore(args.ckpt_dir, ckpt_state(),
                                             step=last)
            if themis:
                themis_local(state, opt, mesh)
            else:
                opt = state
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restored = {"step": last, "seconds": time.perf_counter() - t0}
            start_step = extra.get("next_step", last)
            log(f"[train] resumed from step {last} (data cursor -> "
                f"{start_step}) in {restored['seconds']:.2f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ds = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=tcfg.seed)
    pf = Prefetcher(ds, mesh, dev, start_step=start_step,
                    fixed_step=0 if args.fixed_batch else None,
                    dp_sync=args.dp_sync)
    on_mesh = args.dp_sync == "gspmd" and sharded(mesh)
    frames = _frames(cfg, args, mesh, dev, tcfg.seed)
    losses, gnorms, lrs, step_ms = [], [], [], []
    batch = None
    try:
        for step, batch in pf:
            if step >= args.steps:
                break
            t0 = time.perf_counter()
            batch = {**batch, **frames}
            if on_mesh:
                batch = rows_to_dtensor(batch, mesh, args.batch)
            params, opt, metrics = step_fn(params, opt, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["gnorm"]))
            lrs.append(float(metrics["lr"]))
            if on_step:
                on_step(step, metrics)
            if (step + 1) % args.log_every == 0:
                log(f"[train] step {step + 1:5d} loss={losses[-1]:.4f} "
                    f"gnorm={gnorms[-1]:.3f} lr={lrs[-1]:.2e} "
                    f"{step_ms[-1]:.1f} ms/step")
            if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
                extra = {"next_step": step + 1, "seed": tcfg.seed}
                if themis:
                    extra["themis"] = themis_record(mesh, orders)
                ckpt.save_async(step + 1, ckpt_state(), extra=extra)
    finally:
        pf.close()
        t0 = time.perf_counter()
        if ckpt:
            ckpt.wait()
        final_wait_s = time.perf_counter() - t0
    for c in ckpt.saves if ckpt else []:
        log(f"[train] checkpoint step {c['step']}: {c['bytes'] / 1e9:.2f} GB, "
            f"host copy {c['snapshot_s']:.2f} s, written in {c['write_s']:.2f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if losses:
        tail = step_ms[1:] or step_ms
        log(f"[train] done: {len(losses)} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, median {statistics.median(tail):.1f} ms/step "
            "after the first"
            + (f", peak memory {peak / 2**30:.2f} GiB" if peak else ""))
    return {"losses": losses, "gnorms": gnorms, "lrs": lrs, "step_ms": step_ms,
            "peak_mem_bytes": peak, "orders": orders, "cfg": cfg,
            "start_step": start_step, "restored": restored,
            "checkpoints": ckpt.saves if ckpt else [],
            "checkpoint_final_wait_s": final_wait_s if ckpt else None,
            "tokens_per_step": args.batch * args.seq, "params": params,
            "opt": opt, "step_fn": step_fn, "batch": batch}


if __name__ == "__main__":
    main()
