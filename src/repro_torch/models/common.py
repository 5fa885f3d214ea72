"""Shared layers: norms, RoPE, attention (naive + blockwise flash), MLP, inits.

Port of ``repro/models/common.py``. Functions take tensors in the reference's
layouts (q ``(B,S,H,hd)``, k/v ``(B,T,KV,hd)``) so tests compare like with
like. Sharding constraints and the mesh context have no counterpart here:
the port serves on one device.

Dispatch to the hand-written kernels:

- On a CUDA tensor, ``attention`` sends S > 1 to ``ops.flash_attention``
  (kernel K1 when ``q_offset == 0``) for both ``impl="xla_flash"`` (the
  default, which ``attention_impl="reference"`` selects) and
  ``impl="pallas"``, and ``rms_norm`` goes to ``ops.rmsnorm`` (kernel K2,
  which rounds once where the reference rounds twice).
- On a CPU tensor, ``"xla_flash"`` and ``rms_norm`` run the line-for-line
  ports of the reference functions below, and ``"pallas"`` runs K1's plain
  version.
- Decode (S == 1) and ``impl="naive"`` run ``naive_attention`` on either
  device, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Any
NEG_INF = -1e30


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


def flash_attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_q: int = 512,
                        block_k: int = 1024):
    """Blockwise online-softmax attention (forward of the reference's
    ``flash_attention_xla``; the recompute backward comes with training)."""
    out, _ = _flash_fwd_impl(q, k, v, int(q_offset), causal, window,
                             block_q, block_k)
    return out


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
