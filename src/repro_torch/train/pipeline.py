"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/train/pipeline.py``).

Stage s holds its slice of the layer stack; microbatches stream through
ring transfers between the stages (``_RingPermute``: stage i sends to
i + 1 over ``torch.distributed.batch_isend_irecv``, and its backward sends
the gradient the other way), with the reference's schedule: n_micro +
n_stage - 1 cycles, stage 0 embeds microbatch min(m, n_micro - 1) on every
cycle, every stage runs its L/S blocks on every cycle, and the last
stage's outputs from cycle n_stage - 1 on are the hidden states of the
microbatches in order. Demonstrated on the dense decoder family.

The loss is the last stage's cross entropy, all-reduced over the axis so
every stage returns it. Its backward hands each stage the loss's gradient
unsummed, so the gradients equal ``transformer.loss_fn``'s (as the
reference's ``psum`` under ``shard_map`` does; they are not n_stage times
larger). The replicated leaves (embed, ln_f, lm_head) enter through an
identity whose backward sums their gradients over the axis, the transpose
of their replication, so every stage holds their whole gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.common import cross_entropy, rms_norm
from repro_torch.models.registry import leaves


class _RingPermute(torch.autograd.Function):
    """Stage i's ``x`` goes to stage i + 1 (the last to stage 0); the
    backward sends the gradient from i + 1 back to i."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -ctx.shift), None, None


def _permute(x, group, shift: int):
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllReduceLoss(torch.autograd.Function):
    """The sum over the axis; the backward passes the gradient unsummed."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity on a leaf replicated over the axis; the backward sums its
    gradient over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def pipeline_forward(params, tokens, cfg: ModelConfig, *, n_micro: int, mesh,
                     axis: str = "pipe"):
    """params: this stage's slice (``stage_split_params``): blocks (L/S,
    ...) plus embed, ln_f and lm_head (replicated). tokens: (B, S), the
    same on every stage. Returns the logits of the last stage's hidden
    states (B, S, V) on every stage (only the last stage's are the
    model's)."""
    stage = mesh.local_rank(axis)
    n_stage = mesh.axis_size(axis)
    dt = tr.torch_dtype(cfg.dtype)
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    group = mesh.group(axis)
    blocks = tr._unbind(params["blocks"])

    def run_stage(x_in, mtokens):
        # the reference's where(stage == 0, embed, x_in), with the same ops
        # on every stage, so that every stage runs the same backward
        # collectives in the same order
        emb = tr._embed(params, mtokens, cfg, dt)
        h = emb + x_in * 0 if stage == 0 else x_in + emb * 0
        for p_l in blocks:
            h = tr.apply_block(p_l, h, cfg, pos0=0)
        return h

    micro = tokens.reshape(n_micro, mb, s)
    carry = torch.zeros((mb, s, cfg.d_model), dtype=dt, device=tokens.device)
    outs = []
    for m in range(n_micro + n_stage - 1):
        h = run_stage(carry, micro[min(m, n_micro - 1)])
        carry = _RingPermute.apply(h, group, 1)
        outs.append(h)
    # the last stage's output for microbatch m appears at cycle m + n_stage - 1
    hs = torch.stack(outs[n_stage - 1:]).reshape(b, s, cfg.d_model)
    x = rms_norm(hs, params["ln_f"].to(dt), cfg.norm_eps)
    return x @ params["lm_head"].to(dt)


def make_pipeline_loss(cfg: ModelConfig, mesh, n_micro: int,
                       axis: str = "pipe"):
    """(stage_params, tokens, labels) -> the scalar loss, equal on every
    stage; differentiable in the stage's params."""

    def loss(params, tokens, labels):
        group = mesh.group(axis)
        params = {k: (v if k == "blocks" else _Replicated.apply(v, group))
                  for k, v in params.items()}
        logits = pipeline_forward(params, tokens, cfg, n_micro=n_micro,
                                  mesh=mesh, axis=axis)
        last = mesh.local_rank(axis) == mesh.axis_size(axis) - 1
        l = cross_entropy(logits, labels) * float(last)
        return _AllReduceLoss.apply(l, group)

    return loss


def stage_split_params(params, n_stage: int, stage: int):
    """This stage's params from a full LM param tree: its rows
    [stage*L/S, (stage+1)*L/S) of every stacked block leaf, and embed,
    ln_f and lm_head whole (the tied embedding's transpose when there is no
    lm_head). Views of ``params``' storage, detached, so they can be made
    leaves of their own."""
    blocks = params["blocks"]
    total = leaves(blocks)[0].shape[0]
    if total % n_stage:
        raise ValueError(f"{total} layers do not split over {n_stage} stages")
    per = total // n_stage
    lo = stage * per

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree.detach()[lo:lo + per]

    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return {"embed": params["embed"].detach(), "blocks": cut(blocks),
            "ln_f": params["ln_f"].detach(), "lm_head": head.detach()}

