"""Uniform model API (port of ``repro/models/registry.py``): the dense and
hybrid families.

``build_model(cfg)`` returns a ``ModelApi`` of plain functions:
``init(seed, device=None)``, ``prefill(params, batch, max_len=None)``,
``decode_step(params, caches, token, pos)`` and ``forward(params, tokens)``.
``init`` runs on ``cuda`` unless ``device`` says otherwise. The hybrid
family's caches have a fixed size (a ring buffer of ``local_window``
positions and the recurrent states), so its ``prefill`` ignores
``max_len``, as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import recurrent, transformer


@dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable               # (seed, device=None) -> params
    prefill: Callable            # (params, batch, max_len=None) -> (logits, caches)
    decode_step: Callable        # (params, caches, token, pos) -> (logits, caches)
    forward: Callable            # (params, tokens) -> logits (B,S,V)


def build_model(cfg: ModelConfig) -> ModelApi:
    transformer.check_family(cfg)
    pdt = transformer.torch_dtype(cfg.param_dtype)
    mod = recurrent if cfg.family == "hybrid" else transformer

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mod.init_lm(gen, cfg, dtype=pdt, device=dev)

    def pf(params, batch, max_len: int | None = None):
        tokens = batch["tokens"]
        if mod is recurrent:
            return recurrent.prefill(params, tokens, cfg)
        return transformer.prefill(params, tokens, cfg,
                                   tokens.shape[1] if max_len is None else max_len)

    def dec(params, caches, token, pos):
        return mod.decode_step(params, caches, token, pos, cfg)

    def fwd(params, tokens):
        return mod.forward(params, tokens, cfg)

    return ModelApi(cfg=cfg, init=init, prefill=pf, decode_step=dec, forward=fwd)
