"""Shared layers: norms, RoPE, attention (naive + blockwise flash), MLP,
inits, the loss and the remat policy.

Port of ``repro/models/common.py``. Functions take tensors in the reference's
layouts (q ``(B,S,H,hd)``, k/v ``(B,T,KV,hd)``) so tests compare like with
like. Sharding constraints and the mesh context have no counterpart here:
the model runs on one device, and data parallelism lives in
``train/step.py``.

Dispatch to the hand-written kernels:

- On a CUDA tensor, ``attention`` sends S > 1 to ``ops.flash_attention``
  (kernel K1 when ``q_offset == 0``, differentiable through K1's backward
  kernels) for both ``impl="xla_flash"`` (the default, which
  ``attention_impl="reference"`` selects) and ``impl="pallas"``, and
  ``rms_norm`` goes to ``ops.rmsnorm`` (kernel K2, which rounds once where
  the reference rounds twice).
- On a CPU tensor, ``"xla_flash"`` and ``rms_norm`` run the line-for-line
  ports of the reference functions below (``flash_attention_xla`` with the
  reference's recompute ``custom_vjp`` as an autograd function), and
  ``"pallas"`` runs K1's plain version.
- Decode (S == 1) and ``impl="naive"`` run ``naive_attention`` on either
  device, as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import ops

Params = Any
NEG_INF = -1e30


# The matmuls that remat "dots" saves: ``x @ W`` of a 3-D activation and a
# 2-D weight dispatches as view + ``aten.mm`` + view. Attention's products
# have batch dims (``bmm`` on the CPU, K1 on the card) and are recomputed,
# as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` recomputes
# them.
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the output of every
    matmul with no batch dims (the projections), recompute everything
    else."""
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(cfg):
    """Activation-checkpoint policy of the per-layer remat wrapper, read from
    ``cfg.remat_policy`` alone, as in the reference: a ``context_fn`` for
    ``torch.utils.checkpoint.checkpoint``, or None for its default.

    ``"dots"`` saves the projections' outputs inside a block (``save_dots``)
    and recomputes the rest in the backward: norms, RoPE, attention (K1),
    the gate math, the conv and the scan (K3). It keeps every matmul
    output, where the reference's XLA drops the ones its backward never
    reads: so the port also holds the last projection of each checkpointed
    unit (the MLP's ``wo``, whose output only enters the residual add).
    Every other name (``"full"``, the default, and also ``"none"`` or any
    other) saves nothing inside a block: each layer keeps only its input
    and recomputes the rest, as ``jax.checkpoint`` with no policy does;
    returns None."""
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 save_dots)
    return None


# -- inits ------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None):
    """Normal with std ``1/sqrt(fan_in)``, as the reference's ``dense_init``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32, device=None):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# -- norms --------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    if x.is_cuda:
        return ops.rmsnorm(x, weight, eps)
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


# -- rotary embeddings --------------------------------------------------------
def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------
def _repeat_kv(k, groups: int):
    # (B, T, KV, hd) -> (B, T, KV*groups, hd)
    if groups == 1:
        return k
    b, t, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, groups, hd).reshape(
        b, t, kv * groups, hd)


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Reference attention.  q: (B,S,H,hd); k,v: (B,T,KV,hd).

    Scores are computed in the input dtype and then cast to fp32, the
    probability-value product in fp32, as in the reference."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def _flash_blocks(q, k, v, block_q, block_k):
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    bq = min(block_q, s)
    bk = min(block_k, t)
    nq = -(-s // bq)
    nk = -(-t // bk)
    pad_q = nq * bq - s
    pad_k = nk * bk - t
    qf = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kf = F.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vf = F.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    qb = qf.reshape(b, nq, bq, h, hd).transpose(0, 1)
    kb = kf.reshape(b, nk, bk, kvh, hd).transpose(0, 1)
    vb = vf.reshape(b, nk, bk, kvh, hd).transpose(0, 1)
    return qb, kb, vb, (bq, bk, nq, nk)


def _block_mask(qpos, kpos, t, causal, window):
    mask = kpos[None, :] < t
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & (kpos[None, :] > (qpos[:, None] - window))
    return mask


def _flash_fwd_impl(q, k, v, q_offset, causal, window, block_q, block_k):
    """Returns (out (B,S,H,hd), lse (B,H,S))."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qb, kb, vb, (bq, bk, nq, nk) = _flash_blocks(q, k, v, block_q, block_k)
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qblk = qb[qi]
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, bq, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kr = _repeat_kv(kb[ki], groups)
            vr = _repeat_kv(vb[ki], groups)
            sc = torch.einsum("bqhd,bkhd->bhqk", qblk, kr).float() * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = _block_mask(qpos, kpos, t, causal, window)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vr.float())
            m = m_new
        denom = l.clamp_min(1e-30)
        outs.append((acc / denom[..., None]).to(q.dtype))
        lses.append(m + torch.log(denom))
    # outs: nq x (B, H, bq, hd) -> (B, S, H, hd)
    out = torch.cat(outs, dim=2).transpose(1, 2)
    lse = torch.cat(lses, dim=2)
    return out[:, :s], lse[:, :, :s]


@torch.profiler.record_function("repro_torch.attention_backward")
def flash_attention_bwd(q, k, v, out, lse, g, *, q_offset: int = 0,
                        causal: bool = True, window: int = 0,
                        block_q: int = 512, block_k: int = 1024):
    """Recompute-based flash backward (the reference's ``_flash_vjp_bwd``):
    O(S) memory, no saved probabilities. For each q block the probabilities
    are recomputed from (q, k, lse); dk/dv accumulate in fp32 and the GQA
    groups fold back onto the KV heads. ``lse`` (B,H,S) fp32 may come from
    the blockwise forward or from kernel K1. Returns (dq, dk, dv) in the
    dtypes of q, k, v. The plain version of K1's backward kernels (their
    route on a CPU tensor). Runs inside the profiler range
    ``repro_torch.attention_backward``."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb, kb, vb, (bq, bk, nq, nk) = _flash_blocks(q, k, v, block_q, block_k)
    pad_q = nq * bq - s
    gp = F.pad(g, (0, 0, 0, 0, 0, pad_q)) if pad_q else g
    op = F.pad(out, (0, 0, 0, 0, 0, pad_q)) if pad_q else out
    gq = gp.reshape(b, nq, bq, h, hd).transpose(0, 1)       # (nq,B,bq,H,hd)
    ob = op.reshape(b, nq, bq, h, hd).transpose(0, 1)
    lseb = F.pad(lse, (0, pad_q)).reshape(b, h, nq, bq).permute(2, 0, 1, 3)
    delta = (gq.float() * ob.float()).sum(-1).transpose(2, 3)  # (nq,B,H,bq)
    dk = torch.zeros((b, nk * bk, kvh, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi in range(nq):
        qblk, gblk, lse_i, d_i = qb[qi], gq[qi], lseb[qi], delta[qi]
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        dq_b = torch.zeros((b, bq, h, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kr = _repeat_kv(kb[ki], groups)                  # (B,bk,H,hd)
            vr = _repeat_kv(vb[ki], groups)
            sc = torch.einsum("bqhd,bkhd->bhqk", qblk, kr).float() * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = _block_mask(qpos, kpos, t, causal, window)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            p = torch.exp(sc - lse_i[..., None])             # (B,H,bq,bk)
            dp = torch.einsum("bqhd,bkhd->bhqk", gblk, vr).float()
            ds = p * (dp - d_i[..., None]) * scale
            dv_h = torch.einsum("bhqk,bqhd->bkhd", p.to(gblk.dtype), gblk)
            dk_h = torch.einsum("bhqk,bqhd->bkhd", ds.to(qblk.dtype), qblk)
            # fold GQA groups back onto kv heads
            ks = slice(ki * bk, (ki + 1) * bk)
            dv[:, ks] += dv_h.reshape(b, bk, kvh, groups, hd).sum(3).float()
            dk[:, ks] += dk_h.reshape(b, bk, kvh, groups, hd).sum(3).float()
            dq_b = dq_b + torch.einsum("bhqk,bkhd->bqhd", ds.to(kr.dtype),
                                       kr).float()
        dqs.append(dq_b)
    dq = torch.cat(dqs, dim=1)[:, :s]
    return dq.to(q.dtype), dk[:, :t].to(k.dtype), dv[:, :t].to(v.dtype)


class _FlashAttentionXla(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, block_q, block_k):
        out, lse = _flash_fwd_impl(q, k, v, q_offset, causal, window,
                                   block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, causal, window, block_q, block_k = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g, q_offset=q_offset, causal=causal,
            window=window, block_q=block_q, block_k=block_k)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_q: int = 512,
                        block_k: int = 1024):
    """Blockwise online-softmax attention with a recompute-based backward
    (``flash_attention_bwd``): O(S) memory in both passes, where autograd
    through the blocks would save the O(S^2) probabilities."""
    return _FlashAttentionXla.apply(q, k, v, int(q_offset), causal, window,
                                    block_q, block_k)


def attention(q, k, v, *, impl: str = "xla_flash", causal=True, window=0,
              q_offset=0):
    if impl == "naive" or q.shape[1] == 1:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "pallas" or q.is_cuda:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return flash_attention_xla(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


# -- MLP ----------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32, device=None, lead: tuple = ()):
    """``lead``: leading (stacked-layer) dims of every weight."""
    n = len(lead)
    p = {
        "wi": dense_init(gen, (*lead, d_model, d_ff), n, dtype, device),
        "wo": dense_init(gen, (*lead, d_ff, d_model), n, dtype, device),
    }
    if gated:
        p["wg"] = dense_init(gen, (*lead, d_model, d_ff), n, dtype, device)
    return p


def apply_mlp(p: Params, x, gated: bool):
    h = x @ p["wi"].to(x.dtype)
    if gated:
        h = F.silu(x @ p["wg"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# -- losses -------------------------------------------------------------------
def _ce_fwd_impl(logits, labels):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - gold, lse


class _CrossEntropy(torch.autograd.Function):
    """Token-weighted cross entropy with the reference's memory-lean
    backward (``_ce_from_logits``): saves only the logits in their dtype and
    the per-token LSE, and recomputes the softmax in the backward. Profiler
    ranges ``repro_torch.cross_entropy`` and ``..._backward``."""

    @staticmethod
    def forward(ctx, logits, labels, weights):
        with torch.profiler.record_function("repro_torch.cross_entropy"):
            nll, lse = _ce_fwd_impl(logits, labels)
            ctx.save_for_backward(logits, labels, weights, lse)
            return (nll * weights).sum()

    @staticmethod
    def backward(ctx, g):
        logits, labels, weights, lse = ctx.saved_tensors
        with torch.profiler.record_function("repro_torch.cross_entropy_backward"):
            p = torch.sub(logits.float(), lse[..., None]).exp_()
            # p - onehot: subtract 1 at each label instead of materialising a
            # (tokens x vocab) one-hot; the same values
            p.scatter_add_(-1, labels[..., None].long(),
                           p.new_full((*labels.shape, 1), -1.0))
            p.mul_((g * weights)[..., None])
            return p.to(logits.dtype), None, None


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V); labels (B,S) int; mean over valid tokens."""
    if mask is None:
        weights = torch.full(labels.shape, 1.0 / labels.numel(),
                             dtype=torch.float32, device=logits.device)
    else:
        m = mask.float()
        weights = m / m.sum().clamp_min(1.0)
    return _CrossEntropy.apply(logits, labels, weights)
