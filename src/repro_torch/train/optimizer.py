"""AdamW with LR schedule and global-norm clipping (port of
``repro/train/optimizer.py``).

Works on dicts of tensors and on flat ZeRO-sharded buffers (the Themis step
keeps m/v in the reduce-scattered layout). Unlike the reference, which
returns new trees, ``clip_by_global_norm`` and ``adamw_update`` update their
arguments in place: a second copy of the params, m and v does not fit the
card for a 3B model. They compute the same values.

On DTensor leaves (the sharded GSPMD step) the global norm is the full
sum over every element, and the update runs on m/v's placements: under
ZeRO-1 m and v carry a "data" split that the param lacks, so the param and
its gradient are cut to m's blocks, updated there, and the new param is
gathered back to its own placements (what XLA does for the reference
implicitly).

Profiler ranges ``repro_torch.clip`` and ``repro_torch.adamw`` mark the
two updates. The step count lives on the host as a Python int, and the
learning rate and bias corrections are computed there in float32
arithmetic, as the reference computes them in fp32 on the device; the norm
and the clip scale stay on the device, so a step needs no host
synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TrainConfig
from repro_torch.models.registry import leaves

_f32 = np.float32


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """Linear warm-up, then cosine decay to 10% of the peak rate."""
    step = _f32(step)
    warm = min(step / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * prog))
    return float(_f32(cfg.learning_rate) * warm * (_f32(0.1) + _f32(0.9) * cos))


def bias_corrections(cfg: TrainConfig, count: int) -> tuple[float, float]:
    """(1 - beta1^count, 1 - beta2^count) in float32."""
    c = _f32(count)
    return (float(_f32(1.0) - _f32(cfg.beta1) ** c),
            float(_f32(1.0) - _f32(cfg.beta2) ** c))


def adamw_init(params, pls=None) -> dict:
    """Zero fp32 m and v shaped like ``params`` (nested dicts and lists, as
    the hybrid family's tail), and a step count of 0. DTensor params take
    zero DTensors on the placements of the tree ``pls`` (their own where
    None)."""
    def zeros(tree, pl):
        if isinstance(tree, dict):
            return {k: zeros(v, None if pl is None else pl[k])
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [zeros(v, None if pl is None else pl[i])
                    for i, v in enumerate(tree)]
        if isinstance(tree, DTensor):
            import torch.distributed.tensor as dt

            return dt.zeros(tree.shape, dtype=torch.float32,
                            device_mesh=tree.device_mesh,
                            placements=pl or tree.placements)
        return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)

    return {"m": zeros(params, pls), "v": zeros(params, pls), "count": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor; a
    plain one, equal on every rank, for DTensor leaves)."""
    sq = sum(x.float().square().sum() for x in leaves(tree))
    if isinstance(sq, DTensor):
        sq = sq.full_tensor()
    return torch.sqrt(sq)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float) -> torch.Tensor:
    """Scale every leaf of ``tree`` in place so that the global norm is at
    most ``max_norm``; returns the norm before clipping."""
    with torch.profiler.record_function("repro_torch.clip"):
        norm = global_norm(tree)
        scale = clip_scale(norm, max_norm)
        for x in leaves(tree):
            if isinstance(x, DTensor):
                x = x.to_local()
            x.mul_(scale.to(x.dtype))
    return norm


@torch.no_grad()
def adamw_step_(p, g, m, v, *, lr: float, c1: float, c2: float,
                cfg: TrainConfig) -> None:
    """One AdamW update of tensor ``p`` with gradient ``g`` and fp32 moments
    ``m``, ``v``, all in place, with at most two temporaries the size of
    ``p``: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, rounded
    step by step as the reference rounds it (no fused multiply-adds)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.float()
    m.mul_(b1).add_(g32 * (1 - b1))
    v.mul_(b2).add_(g32.square().mul_(1 - b2))
    upd = torch.div(v, c2).sqrt_().add_(cfg.eps)
    upd = torch.div(m, c1).div_(upd)
    p32 = p.float()
    upd.add_(p32 * cfg.weight_decay).mul_(lr)
    if p32 is p:
        p.sub_(upd)
    else:
        p.copy_(p32.sub_(upd))


def adamw_update(grads, state: dict, params, cfg: TrainConfig) -> float:
    """One AdamW step over dicts of tensors: updates ``params``,
    ``state["m"]``, ``state["v"]`` in place and advances
    ``state["count"]``. Returns the learning rate used."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    c1, c2 = bias_corrections(cfg, count)
    with torch.profiler.record_function("repro_torch.adamw"):
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), leaves(params)):
            if isinstance(p, DTensor):
                _adamw_step_sharded(p, g, m, v, lr=lr, c1=c1, c2=c2, cfg=cfg)
            else:
                adamw_step_(p, g, m, v, lr=lr, c1=c1, c2=c2, cfg=cfg)
    state["count"] = count
    return lr


@torch.no_grad()
def _adamw_step_sharded(p, g, m, v, **kw) -> None:
    """``adamw_step_`` of DTensors on m's placements: the param and its
    gradient cut to m's blocks, the new param gathered back to its own."""
    mesh, pls = m.device_mesh, m.placements
    same = tuple(p.placements) == tuple(pls)
    pm = p if same else p.redistribute(mesh, pls)
    gm = g if tuple(g.placements) == tuple(pls) else g.redistribute(mesh, pls)
    pl = p.to_local() if same else pm.to_local().clone()
    adamw_step_(pl, gm.to_local(), m.to_local(), v.to_local(), **kw)
    if not same:
        new = DTensor.from_local(pl, mesh, pls, run_check=False)
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
