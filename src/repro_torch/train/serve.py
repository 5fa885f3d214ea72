"""Serving-step builders (port of ``repro/train/serve.py``): prefill + decode
on one device under ``torch.inference_mode``.

The reference shards params and caches over a mesh with GSPMD; the port
serves on one device, replicated. A mesh other than 1x1 raises: sharded
serving is ROADMAP item M12.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelApi


def make_serve_fns(api: ModelApi, device=None,
                   parallel: ParallelConfig = ParallelConfig()):
    """Returns (prefill, decode) on ``device`` (``cuda`` unless given).

    ``prefill(params, batch, max_len=None) -> (last_logits, caches)`` and
    ``decode(params, caches, token, pos) -> (logits, caches)``; decode
    writes ``caches`` in place."""
    if math.prod(parallel.mesh_shape) != 1:
        raise NotImplementedError(
            f"mesh {parallel.mesh_shape}: sharded serving is not ported yet "
            "(ROADMAP M12)")
    dev = resolve_device(device)

    def _check(params):
        pdev = params["embed"].device
        if pdev.type != dev.type:
            raise ValueError(f"params lie on {pdev}, serving on {dev}")

    def prefill(params, batch, max_len: int | None = None):
        _check(params)
        with torch.inference_mode():
            return api.prefill(params, {"tokens": batch["tokens"].to(dev)},
                               max_len)

    def decode(params, caches, token, pos: int):
        _check(params)
        with torch.inference_mode():
            return api.decode_step(params, caches, token.to(dev), pos)

    return prefill, decode
