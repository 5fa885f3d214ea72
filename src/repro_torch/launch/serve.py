"""Serving driver: batched prefill + autoregressive decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 512 --gen 16 [--reduced] [--kv-quant] \
        [--layers N] [--device cuda|cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
        -m repro_torch.launch.serve --reduced --device cpu --mesh 2x4

Builds the model from a seed on the device (``cuda`` by default), runs a
batch of synthetic prompts (with the stub frontends' frames or patches for
the audio and VLM families) through prefill and ``--gen`` greedy decode
steps, and reports prefill time and per-token decode latency.
``--layers`` cuts the depth (0 keeps the config's), for a model whose fp32
weights exceed the card at full depth (granite-34b: 40 of its 88 layers
fit one H100). On the card
both are timed with CUDA events; the first prefill includes building the
kernels. On the CPU the host clock times the plain PyTorch path.
``--mesh DATAxMODEL`` serves sharded (``train/serve.py``), one process per
rank under ``torchrun`` (ranks of a CUDA run take the card of their
``LOCAL_RANK``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ParallelConfig, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ModelApi, build_model
from repro_torch.train.serve import make_serve_fns, place_params
from repro_torch.train.step import sharded


@dataclass
class Server:
    cfg: ModelConfig
    api: ModelApi
    params: dict
    prefill: Callable
    decode: Callable
    device: torch.device


def setup(arch: str, *, reduced: bool = False, kv_quant: bool = False,
          layers: int = 0, device=None, seed: int = 0, mesh=None,
          params=None) -> Server:
    """The model from ``seed`` (or the given whole ``params``) and its
    serving functions; on a sharded ``mesh`` (a ``launch.mesh.Mesh`` over a
    process group of ("data", "model")) the params are placed as DTensors
    once, here."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    api = build_model(cfg)
    if params is None:
        params = api.init(seed, dev)
    if not sharded(mesh):
        prefill, decode = make_serve_fns(api, dev)
        return Server(cfg, api, params, prefill, decode, dev)
    parallel = ParallelConfig(data=mesh.axis_size("data"),
                              model=mesh.axis_size("model"))
    prefill, decode = make_serve_fns(api, dev, parallel, mesh=mesh)
    return Server(cfg, api, place_params(params, mesh, parallel), prefill,
                  decode, dev)


def synthetic_batch(cfg: ModelConfig, batch: int, prompt_len: int, *,
                    seed: int = 0, device=None) -> dict:
    """Seeded prompts: "tokens" (batch, prompt_len), and for the audio family
    "frames" (batch, num_frames, d_model), for the VLM family "patches"
    (batch, num_patches, d_model), both bf16 standard normals (the stub
    frontends' outputs), drawn after the tokens from one numpy generator as
    the reference's ``launch/serve.py`` draws them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=dev)}
    extra = {"audio": ("frames", cfg.num_frames),
             "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if extra:
        name, n = extra
        x = rng.standard_normal((batch, n, cfg.d_model))
        out[name] = torch.as_tensor(x).to(torch.bfloat16).to(dev)
    return out


class _Timer:
    """CUDA events on the card, the host clock on the CPU; milliseconds."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self._t0.elapsed_time(t1)
        return (time.perf_counter() - self._t0) * 1e3


def generate(server: Server, batch: dict, gen: int, *,
             on_step: Callable[[str], None] | None = None) -> dict:
    """Prefill a prompt into a cache with room for ``gen`` more positions,
    then run ``gen`` greedy decode steps. ``batch``: the tokens (B, S) and
    the family's "patches" or "frames" (``synthetic_batch``). The VLM's P
    patches come first in the sequence: its cache holds P + S + gen
    positions and decoding starts at position P + S. ``on_step("prefill" | "decode")`` is called after each step is
    enqueued. Returns the generated ids (B, gen + 1), the last logits and
    the times."""
    plen = batch["tokens"].shape[1]
    if "patches" in batch:
        plen += batch["patches"].shape[1]
    timer = _Timer(server.device)
    timer.start()
    logits, caches = server.prefill(server.params, batch, plen + gen)
    if on_step:
        on_step("prefill")
    prefill_ms = timer.stop()
    first_logits = logits
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    timer.start()
    for i in range(gen):
        logits, caches = server.decode(server.params, caches, tok, plen + i)
        if on_step:
            on_step("decode")
        tok = logits[:, 0].argmax(-1)
        out.append(tok)
    decode_ms = timer.stop() / max(gen, 1)
    return {"ids": torch.stack(out, 1), "prefill_logits": first_logits,
            "last_logits": logits, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "caches": caches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    data, model = (int(x) for x in args.mesh.split("x"))
    mesh, owns_group = None, False
    if data * model > 1:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        owns_group = not dist.is_initialized()
        mesh = Mesh((data, model), ("data", "model"), dev)
    log = print if not dist.is_initialized() or dist.get_rank() == 0 else (
        lambda *a, **k: None)
    try:
        server = setup(args.arch, reduced=args.reduced,
                       kv_quant=args.kv_quant, layers=args.layers, device=dev,
                       mesh=mesh)
        log(f"[serve] {args.arch} layers={server.cfg.num_layers} "
            f"reduced={args.reduced} device={server.device} "
            f"kv_quant={args.kv_quant} mesh={args.mesh}")
        batch = synthetic_batch(server.cfg, args.batch, args.prompt_len,
                                device=server.device)
        res = generate(server, batch, args.gen)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    dt = res["decode_ms_per_token"]
    log(f"[serve] prefill {args.batch}x{args.prompt_len}: "
        f"{res['prefill_ms']:.1f} ms (incl. kernel build on first use)")
    log(f"[serve] decode: {dt:.2f} ms/token "
        f"({args.batch / (dt / 1e3):.1f} tok/s aggregate)")
    log(f"[serve] sample output ids: {res['ids'][0, :10].tolist()}")
    return res


if __name__ == "__main__":
    main()
