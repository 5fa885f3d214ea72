"""Uniform model API (port of ``repro/models/registry.py``): every family of
the reference (dense, MoE, VLM, hybrid, SSM, audio).

``build_model(cfg)`` returns a ``ModelApi`` of plain functions:
``init(seed, device=None)``, ``loss_fn(params, batch)``,
``prefill(params, batch, max_len=None)``,
``decode_step(params, caches, token, pos)`` and
``forward(params, tokens, *, patches=None, frames=None)``; ``param_spec()``
gives the params' shapes and dtypes without allocating them (built on the
``meta`` device), and ``batch_spec(shape)`` / ``decode_spec(shape)`` the
same stand-ins of every input of a shape cell (``configs.base.ShapeConfig``)
in the reference's shapes and dtypes, for the dry run
(``launch/dryrun.py``). ``init`` runs on ``cuda`` unless ``device`` says
otherwise. Every family trains through ``loss_fn``.

A batch holds "tokens" (B,S), and "patches" (B,P,D) for the VLM family or
"frames" (B,F,D) for the audio family. ``max_len`` defaults to what the
reference's prefill sizes the cache to: the prompt (with the VLM's P patch
positions in front). A caller that decodes passes room for its steps: for
the VLM, P + S + steps, and it decodes at positions P+S, P+S+1, ... (the
reference's ``launch/serve.py`` decodes at S + i, inside the patch positions'
part of the cache: ROADMAP §3, R8). The hybrid and SSM families' caches
have a fixed size, so their ``prefill`` ignores ``max_len``, as the
reference's does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import recurrent, transformer, whisper, xlstm

# the module that builds each family's params (``init_lm`` / ``init_model``)
_INIT = {"dense": transformer.init_lm, "moe": transformer.init_lm,
         "vlm": transformer.init_lm, "hybrid": recurrent.init_lm,
         "ssm": xlstm.init_lm, "audio": whisper.init_model}


@dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable               # (seed, device=None) -> params
    loss_fn: Callable            # (params, batch) -> scalar
    prefill: Callable            # (params, batch, max_len=None) -> (logits, caches)
    decode_step: Callable        # (params, caches, token, pos) -> (logits, caches)
    forward: Callable            # (params, tokens, *, patches, frames) -> logits (B,S,V)

    def param_spec(self):
        """The params as tensors on the ``meta`` device: shapes and dtypes
        only."""
        gen = torch.Generator(device="cpu")
        return _INIT[self.cfg.family](
            gen, self.cfg, dtype=transformer.torch_dtype(self.cfg.param_dtype),
            device="meta")

    def batch_spec(self, shape: ShapeConfig) -> dict:
        """A training or prefill batch of ``shape`` on ``meta``: int32
        "tokens" and "labels" (B, S), for the VLM family of S - P tokens
        beside bf16 "patches" (B, P, D), for the audio family bf16 "frames"
        (B, F, D)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if cfg.family == "vlm":
            s -= cfg.num_patches
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
        if cfg.family == "vlm":
            batch["patches"] = _meta((b, cfg.num_patches, cfg.d_model),
                                     torch.bfloat16)
        if cfg.family == "audio":
            batch["frames"] = _meta((b, cfg.num_frames, cfg.d_model),
                                    torch.bfloat16)
        return batch

    def decode_spec(self, shape: ShapeConfig):
        """(caches, token, pos) of a decode step of ``shape`` on ``meta``:
        the family's caches for the global batch (a KV cache of ``seq_len``
        positions; int8 codes and bf16 scales under ``kv_quant``), an int32
        token (B,) and an int32 position ()."""
        cfg = self.cfg
        b = shape.global_batch
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            caches = transformer.init_cache(cfg, b, shape.seq_len, device="meta")
        elif fam == "hybrid":
            caches = recurrent.init_caches(cfg, b, device="meta")
        elif fam == "ssm":
            caches = xlstm.init_caches(cfg, b, device="meta")
        else:
            caches = {"kv": whisper.init_caches(cfg, b, shape.seq_len,
                                                device="meta"),
                      "memory": _meta((b, cfg.num_frames, cfg.d_model),
                                      transformer.torch_dtype(cfg.dtype))}
        return caches, _meta((b,), torch.int32), _meta((), torch.int32)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def leaves(tree) -> list:
    """The tensors of nested dicts and lists, dict keys in sorted order: the
    leaf order of ``jax.tree.leaves`` on the reference's params."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def count_params(spec) -> int:
    return sum(math.prod(x.shape) for x in leaves(spec))


def build_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam not in _INIT:
        raise ValueError(f"unknown family {fam}")
    pdt = transformer.torch_dtype(cfg.param_dtype)

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return _INIT[fam](gen, cfg, dtype=pdt, device=dev)

    if fam in ("dense", "moe", "vlm"):
        def loss(params, batch):
            return transformer.loss_fn(params, batch, cfg)

        def pf(params, batch, max_len=None):
            tokens, patches = batch["tokens"], batch.get("patches")
            if max_len is None:
                max_len = tokens.shape[1] + (
                    0 if patches is None else patches.shape[1])
            return transformer.prefill(params, tokens, cfg, max_len,
                                       extra_embeds=patches)

        def dec(params, caches, token, pos):
            return transformer.decode_step(params, caches, token, pos, cfg)

        def fwd(params, tokens, *, patches=None, frames=None):
            return transformer.forward(params, tokens, cfg, extra_embeds=patches)

    elif fam in ("hybrid", "ssm"):
        mod = recurrent if fam == "hybrid" else xlstm

        def loss(params, batch):
            return mod.loss_fn(params, batch, cfg)

        def pf(params, batch, max_len=None):
            return mod.prefill(params, batch["tokens"], cfg)

        def dec(params, caches, token, pos):
            return mod.decode_step(params, caches, token, pos, cfg)

        def fwd(params, tokens, *, patches=None, frames=None):
            return mod.forward(params, tokens, cfg)

    else:  # audio
        def loss(params, batch):
            return whisper.loss_fn(params, batch, cfg)

        def pf(params, batch, max_len=None):
            tokens = batch["tokens"]
            return whisper.prefill(params, batch["frames"], tokens, cfg,
                                   tokens.shape[1] if max_len is None else max_len)

        def dec(params, caches, token, pos):
            return whisper.decode_step(params, caches, token, pos, cfg)

        def fwd(params, tokens, *, patches=None, frames=None):
            return whisper.forward(params, tokens, frames, cfg)

    return ModelApi(cfg=cfg, init=init, loss_fn=loss, prefill=pf,
                    decode_step=dec, forward=fwd)
