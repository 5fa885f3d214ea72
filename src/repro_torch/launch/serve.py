"""Serving driver: batched prefill + autoregressive decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 512 --gen 16 [--reduced] [--kv-quant] \
        [--layers N] [--device cuda|cpu]

Builds the model from a seed on the device (``cuda`` by default), runs a
batch of synthetic prompts through prefill and ``--gen`` greedy decode
steps, and reports prefill time and per-token decode latency.
``--layers`` cuts the depth (0 keeps the config's), for a model whose fp32
weights exceed the card at full depth (granite-34b: 40 of its 88 layers
fit one H100). On the card
both are timed with CUDA events; the first prefill includes building the
kernels. On the CPU the host clock times the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ModelApi, build_model
from repro_torch.train.serve import make_serve_fns


@dataclass
class Server:
    cfg: ModelConfig
    api: ModelApi
    params: dict
    prefill: Callable
    decode: Callable
    device: torch.device


def setup(arch: str, *, reduced: bool = False, kv_quant: bool = False,
          layers: int = 0, device=None, seed: int = 0) -> Server:
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    api = build_model(cfg)
    prefill, decode = make_serve_fns(api, dev)
    return Server(cfg, api, api.init(seed, dev), prefill, decode, dev)


def synthetic_prompts(cfg: ModelConfig, batch: int, prompt_len: int, *,
                      seed: int = 0, device=None) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return torch.as_tensor(toks, dtype=torch.int64, device=resolve_device(device))


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


def generate(server: Server, tokens: torch.Tensor, gen: int, *,
             on_step: Callable[[str], None] | None = None) -> dict:
    """Prefill ``tokens`` (B, P) into a cache of P + gen positions, then run
    ``gen`` greedy decode steps. ``on_step("prefill" | "decode")`` is called
    after each step is enqueued. Returns the generated ids (B, gen + 1), the
    last logits and the times."""
    b, plen = tokens.shape
    timer = _Timer(server.device)
    timer.start()
    logits, caches = server.prefill(server.params, {"tokens": tokens}, plen + gen)
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
    args = ap.parse_args(argv)

    server = setup(args.arch, reduced=args.reduced, kv_quant=args.kv_quant,
                   layers=args.layers, device=args.device)
    print(f"[serve] {args.arch} layers={server.cfg.num_layers} "
          f"reduced={args.reduced} device={server.device} "
          f"kv_quant={args.kv_quant}")
    tokens = synthetic_prompts(server.cfg, args.batch, args.prompt_len,
                               device=server.device)
    res = generate(server, tokens, args.gen)
    dt = res["decode_ms_per_token"]
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{res['prefill_ms']:.1f} ms (incl. kernel build on first use)")
    print(f"[serve] decode: {dt:.2f} ms/token "
          f"({args.batch / (dt / 1e3):.1f} tok/s aggregate)")
    print(f"[serve] sample output ids: {res['ids'][0, :10].tolist()}")
    return res


if __name__ == "__main__":
    main()
