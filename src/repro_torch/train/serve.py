"""Serving-step builders (port of ``repro/train/serve.py``): prefill + decode
under ``torch.inference_mode`` (``torch.no_grad`` on a mesh: DTensor views of
params made outside inference mode cannot be taken inside it).

With no mesh (or a group-less 1x1 one) the port serves on one device,
replicated. On a mesh with a ``DeviceMesh`` it serves as the reference's
GSPMD program does: params on ``param_pspec``'s placements, the caches on
``cache_pspec``'s (for the prompt's global batch), the tokens on
``batch_pspec``'s, the model's ``constrain`` points inside a
``mesh_context``; the last-token logits come back whole, as a plain
tensor, so a caller's argmax is unchanged. Every family serves sharded.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import mesh_context
from repro_torch.models.registry import ModelApi
from repro_torch.sharding.specs import distribute, param_placements
from repro_torch.train.step import shard_batch, sharded


def place_params(params, mesh, parallel: ParallelConfig):
    """Whole ``params`` (equal on every rank) as DTensors on
    ``param_placements``: each rank keeps its blocks, and on a one-rank
    mesh the DTensors wrap the params' own storage."""
    return distribute(params, mesh, param_placements(params, mesh, parallel))


def make_serve_fns(api: ModelApi, device=None,
                   parallel: ParallelConfig = ParallelConfig(), *, mesh=None,
                   shape: ShapeConfig | None = None):
    """Returns (prefill, decode) on ``device`` (``cuda`` unless given).

    ``prefill(params, batch, max_len=None) -> (last_logits, caches)`` (the
    batch's "tokens", and "patches" or "frames" where the family takes
    them) and
    ``decode(params, caches, token, pos) -> (logits, caches)``; decode
    writes ``caches`` in place.

    With a sharded ``mesh`` the params must be DTensors, placed once by
    ``place_params`` (whole params raise ``ValueError``), the batch and
    token are whole (equal on every rank) and ``shape.global_batch``, when
    given, must be the prompt's batch."""
    dev = resolve_device(device)
    if not sharded(mesh):
        if math.prod(parallel.mesh_shape) != 1 or (mesh is not None
                                                   and mesh.size != 1):
            raise ValueError(f"mesh {parallel.mesh_shape}: sharded serving "
                             "needs a Mesh over a process group")
        mesh = None

    def _check(params):
        pdev = params["embed"].device
        if pdev.type != dev.type:
            raise ValueError(f"params lie on {pdev}, serving on {dev}")
        if mesh is not None and not isinstance(params["embed"], DTensor):
            raise ValueError("sharded serving takes the params as DTensors: "
                             "place them once with place_params")

    def prefill(params, batch, max_len: int | None = None):
        _check(params)
        inputs = {k: batch[k].to(dev) for k in ("tokens", "patches", "frames")
                  if k in batch}
        if mesh is None:
            with torch.inference_mode():
                return api.prefill(params, inputs, max_len)
        b = inputs["tokens"].shape[0]
        if shape is not None and shape.global_batch != b:
            raise ValueError(f"batch {b} is not the shape's global batch "
                             f"{shape.global_batch}")
        with torch.no_grad(), mesh_context(mesh):
            logits, caches = api.prefill(params, shard_batch(inputs, mesh),
                                         max_len)
            return logits.full_tensor(), caches

    def decode(params, caches, token, pos: int):
        _check(params)
        if mesh is None:
            with torch.inference_mode():
                return api.decode_step(params, caches, token.to(dev), pos)
        with torch.no_grad(), mesh_context(mesh):
            logits, caches = api.decode_step(
                params, caches, shard_batch({"t": token.to(dev)}, mesh)["t"],
                pos)
            return logits.full_tensor(), caches

    return prefill, decode
