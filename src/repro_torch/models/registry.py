"""Uniform model API (port of ``repro/models/registry.py``): the dense and
hybrid families.

``build_model(cfg)`` returns a ``ModelApi`` of plain functions:
``init(seed, device=None)``, ``loss_fn(params, batch)``,
``prefill(params, batch, max_len=None)``,
``decode_step(params, caches, token, pos)`` and ``forward(params, tokens)``;
``param_spec()`` gives the params' shapes and dtypes without allocating
them (built on the ``meta`` device). ``init`` runs on ``cuda`` unless
``device`` says otherwise. The hybrid family's caches have a fixed size (a
ring buffer of ``local_window`` positions and the recurrent states), so its
``prefill`` ignores ``max_len``, as the reference's does. Both families
train through ``loss_fn``.
"""
from __future__ import annotations

import math
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
    loss_fn: Callable            # (params, batch) -> scalar
    prefill: Callable            # (params, batch, max_len=None) -> (logits, caches)
    decode_step: Callable        # (params, caches, token, pos) -> (logits, caches)
    forward: Callable            # (params, tokens) -> logits (B,S,V)

    def param_spec(self):
        """The params as tensors on the ``meta`` device: shapes and dtypes
        only."""
        mod = recurrent if self.cfg.family == "hybrid" else transformer
        gen = torch.Generator(device="cpu")
        return mod.init_lm(gen, self.cfg,
                           dtype=transformer.torch_dtype(self.cfg.param_dtype),
                           device="meta")


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
    transformer.check_family(cfg)
    pdt = transformer.torch_dtype(cfg.param_dtype)
    mod = recurrent if cfg.family == "hybrid" else transformer

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mod.init_lm(gen, cfg, dtype=pdt, device=dev)

    def loss(params, batch):
        return mod.loss_fn(params, batch, cfg)

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

    return ModelApi(cfg=cfg, init=init, loss_fn=loss, prefill=pf,
                    decode_step=dec, forward=fwd)
