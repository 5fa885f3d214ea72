"""Shared layers: norms, RoPE, attention (naive + blockwise flash), MLP,
inits, the loss and the remat policy.

Port of ``repro/models/common.py``. Functions take tensors in the reference's
layouts (q ``(B,S,H,hd)``, k/v ``(B,T,KV,hd)``) so tests compare like with
like.

Sharding, as in the reference, goes through ``constrain(x, *axes)`` inside a
``mesh_context``: on a DTensor it redistributes to the placements that the
axes name ("dp": batch over the context's dp axes, "tp": the model axis,
"sp": the model axis when ``sp`` is on), dropping an axis whose size does not
divide the dim; with no mesh context or on a plain tensor it does nothing,
so the single-device path is unchanged. A mesh context with a
``DeviceMesh`` also treats plain tensors met beside DTensors (rope tables,
positions, masks) as replicated (``implicit_replication``).

The kernels' wrappers take pointers, not DTensors, so on a DTensor the
calls below run them on local shards (``to_local`` / ``from_local``) with
stated placements: attention with batch on "dp" and q/k/v heads on "tp"
(k/v sliced to the kv heads of this rank's q heads when the kv heads do not
divide, ``_heads_local``), RMSNorm on local rows with the normalised dim
whole, the cross entropy with the vocab split on "tp" and reduced across
it (``_CrossEntropy`` given its groups). A replicated weight's gradient
comes back partial over the mesh dims that split the rows.

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
- On a meta tensor (the dry run) both go to the kernels' wrappers, which
  return empty outputs and tally the kernels' FLOPs (``kernels``).
- Decode (S == 1) and ``impl="naive"`` run ``naive_attention`` on either
  device, as in the reference.
"""
from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import ops

Params = Any
NEG_INF = -1e30

# -- mesh context -----------------------------------------------------------
_CTX: dict = {"mesh": None, "dp_axes": ("data",), "tp_axis": "model",
              "sp": False}


@contextmanager
def mesh_context(mesh, dp_axes=("data",), tp_axis="model", sp: bool = False):
    """``sp=True`` enables sequence parallelism: the residual stream's seq
    dim ("sp" in constraint vocabulary) shards over the model axis between
    blocks. ``mesh``: the port's ``launch.mesh.Mesh``; with a
    ``DeviceMesh`` the context also turns on DTensor's implicit replication
    of plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    old = dict(_CTX)
    _CTX.update(mesh=mesh, dp_axes=tuple(dp_axes), tp_axis=tp_axis, sp=sp)
    implicit = (mesh is not None and mesh.device_mesh is not None
                and not DTensor._op_dispatcher._allow_implicit_replication)
    try:
        if implicit:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.update(old)


def _resolve(axis: str | None):
    if axis == "dp":
        a = _CTX["dp_axes"]
        return a if len(a) > 1 else a[0]
    if axis == "tp":
        return _CTX["tp_axis"]
    if axis == "sp":
        return _CTX["tp_axis"] if _CTX["sp"] else None
    return None


def _constraint_spec(shape, axes) -> tuple:
    """The reference's ``constrain`` spec: an axis whose mesh size does not
    divide the dim, or that an earlier dim took, is dropped."""
    mesh = _CTX["mesh"]
    names = []
    used: set = set()
    for i, a in enumerate(axes):
        r = _resolve(a)
        if r is not None:
            sizes = [r] if isinstance(r, str) else list(r)
            need = 1
            for s in sizes:
                need *= mesh.shape.get(s, 1)
            if shape[i] % need != 0 or any(s in used for s in sizes):
                r = None
            else:
                used.update(sizes)
        names.append(r)
    return tuple(names) + (None,) * (len(shape) - len(names))


def _placements_for(x, *axes) -> tuple:
    from repro_torch.sharding.specs import placements

    return placements(_constraint_spec(x.shape, axes), _CTX["mesh"])


def constrain(x, *axes: str | None):
    """Redistribute a DTensor to the placements that ``axes`` name (one
    entry per dim); a no-op with no mesh context or on a plain tensor."""
    if _CTX["mesh"] is None or not isinstance(x, DTensor):
        return x
    pls = _placements_for(x, *axes)
    if tuple(x.placements) == pls:
        return x
    return x.redistribute(x.device_mesh, pls)


def _whole(x, *dims):
    """``x`` with ``dims`` unsplit and nothing partial (a DTensor)."""
    nd = x.ndim
    pls = tuple(Replicate() if p.is_partial()
                or (p.is_shard() and p.dim % nd in [d % nd for d in dims])
                else p for p in x.placements)
    return x if pls == tuple(x.placements) else x.redistribute(
        x.device_mesh, pls)


def rows_whole(x):
    """An activation (B, ..., D) with every dim but the batch and the last
    whole, for a projection: a DTensor's sequence split (between blocks
    under ``sp``) is gathered, as sequence parallelism gathers before a
    column-parallel matmul (DTensor of torch 2.11 cannot flatten a split
    sequence into the matmul's rows). Anything else passes."""
    if not isinstance(x, DTensor):
        return x
    return _whole(x, *range(1, x.ndim - 1))


def _replicated_local(w, row_pls):
    """The local tensor of a replicated operand ``w`` (a weight), whose
    gradient comes back partial over the mesh dims that split the rows
    (``row_pls``, the placements of the other operand)."""
    if not isinstance(w, DTensor):
        return w
    n = len(row_pls)
    w = w.redistribute(w.device_mesh, (Replicate(),) * n)
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in row_pls)
    return w.to_local(grad_placements=grad)


def _block(mesh, dims) -> int:
    """This rank's block of a dim split over the mesh dims ``dims`` (the
    first major)."""
    idx = 0
    for j in dims:
        idx = idx * mesh.size(j) + mesh.get_local_rank(j)
    return idx


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
    """Normal with std ``1/sqrt(fan_in)``, as the reference's ``dense_init``:
    drawn in fp32, scaled, then cast. A stacked weight of another dtype is
    drawn one leading slice at a time, so the fp32 draw never holds more
    than one slice (qwen3-moe-235b-a22b's bf16 experts: 3.2 GB a layer
    where the whole stack would take 38.6 GB in fp32)."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    if dtype == torch.float32 or len(shape) < 3:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                             device=device).mul_(scale)
    return out


def embed_init(gen: torch.Generator, shape, dtype=torch.float32, device=None):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# -- norms --------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    if isinstance(x, DTensor):
        # local rows, the normalised dim whole (K2 on a CUDA shard)
        x = _whole(x, -1)
        y = rms_norm(x.to_local(), _replicated_local(weight, x.placements), eps)
        return DTensor.from_local(y, x.device_mesh, x.placements,
                                  run_check=False)
    if x.is_cuda or x.is_meta:
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


def sinusoidal_positions(seq: int, dim: int, offset: int = 0, device=None):
    """(seq, dim) fp32 encodings of positions offset .. offset+seq-1: sin in
    the even columns, cos in the odd, of the same fp32 ``pos * div``
    products as the reference."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


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


def _heads_local(fn, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` on local shards: q, k, v with batch on "dp"
    and heads on "tp" where they divide (``extra``: (B, ...) tensors, batch
    as q's); the output takes q's placements. When q's heads split over
    "tp" and k/v's do not, k and v stay whole over "tp" and each rank slices
    the kv heads its q heads read (q head h reads kv head h // (H/KV)), so
    their gradients come back partial over "tp". A cache split over
    head_dim (``cache_pspec`` when KV does not divide tp) is thus gathered
    whole over "tp" on every call (ROADMAP §3)."""
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    q = q.redistribute(mesh, _placements_for(q, "dp", None, "tp", None))
    q_split = [j for j, p in enumerate(q.placements) if p.is_shard() and p.dim == 2]
    kv_pls = _placements_for(k, "dp", None, "tp" if q_split else None, None)
    k = k.redistribute(mesh, kv_pls)
    v = v.redistribute(mesh, kv_pls)
    ql = q.to_local()
    if q_split and not any(p.is_shard() and p.dim == 2 for p in kv_pls):
        grad = tuple(Partial() if j in q_split else p
                     for j, p in enumerate(kv_pls))
        kl = k.to_local(grad_placements=grad)
        vl = v.to_local(grad_placements=grad)
        hq = ql.shape[2]
        r = _block(mesh, q_split)
        want = [(r * hq + i) // (h // kvh) for i in range(hq)]
        lo, n_kv = want[0], want[-1] - want[0] + 1
        if hq % n_kv == 0 and want == [lo + i // (hq // n_kv) for i in range(hq)]:
            kl, vl = kl[:, :, lo:lo + n_kv], vl[:, :, lo:lo + n_kv]
        else:
            idx = torch.tensor(want, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    else:
        kl, vl = k.to_local(), v.to_local()
    batch_pls = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                      for p in q.placements)
    xs = [e.redistribute(mesh, batch_pls).to_local()
          if isinstance(e, DTensor) else e for e in extra]
    out = fn(ql, kl, vl, *xs)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def attention(q, k, v, *, impl: str = "xla_flash", causal=True, window=0,
              q_offset=0):
    if isinstance(q, DTensor):
        return _heads_local(functools.partial(
            attention, impl=impl, causal=causal, window=window,
            q_offset=q_offset), q, k, v)
    if impl == "naive" or q.shape[1] == 1:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "pallas" or q.is_cuda or q.is_meta:
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
    x = rows_whole(x)
    h = x @ p["wi"].to(x.dtype)
    h = constrain(h, "dp", None, "tp")
    if gated:
        h = F.silu(x @ p["wg"].to(x.dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ p["wo"].to(x.dtype)
    return constrain(out, "dp", "sp", None)


# -- losses -------------------------------------------------------------------
class _CrossEntropy(torch.autograd.Function):
    """Token-weighted cross entropy with the reference's memory-lean
    backward (``_ce_from_logits``): saves only the logits in their dtype and
    the per-token LSE, and recomputes the softmax in the backward. Profiler
    ranges ``repro_torch.cross_entropy`` and ``..._backward``.

    The logits may be one rank's block of a vocab split over
    ``vocab_groups`` (the block from ``v0``) and of rows split over
    ``row_groups``: the max, the sum of exponentials and the gold logit are
    reduced across the vocab groups, the weighted sum across the row
    groups, so every rank returns the global loss, and the backward is
    local (this rank's block of ``weights * (softmax - onehot)``). With
    ``v0`` 0 and no groups the logits are whole."""

    @staticmethod
    def forward(ctx, logits, labels, weights, v0, vocab_groups, row_groups):
        with torch.profiler.record_function("repro_torch.cross_entropy"):
            lf = logits.float()
            vl = lf.shape[-1]
            m = lf.amax(-1)
            for g in vocab_groups:
                dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
            se = torch.sub(lf, m[..., None]).exp_().sum(-1)
            for g in vocab_groups:
                dist.all_reduce(se, group=g)
            lse = m + torch.log(se)
            lab = labels.long() - v0
            inside = (lab >= 0) & (lab < vl)
            lab = lab.clamp(0, vl - 1)
            gold = torch.where(inside, torch.gather(lf, -1, lab[..., None])[..., 0],
                               0.0)
            for g in vocab_groups:
                dist.all_reduce(gold, group=g)
            loss = ((lse - gold) * weights).sum()
            for g in row_groups:
                dist.all_reduce(loss, group=g)
            ctx.save_for_backward(logits, lab, inside, weights, lse)
            return loss

    @staticmethod
    def backward(ctx, g):
        logits, lab, inside, weights, lse = ctx.saved_tensors
        with torch.profiler.record_function("repro_torch.cross_entropy_backward"):
            p = torch.sub(logits.float(), lse[..., None]).exp_()
            # p - onehot: subtract 1 at each label inside this block instead
            # of materialising a (tokens x vocab) one-hot; the same values
            p.scatter_add_(-1, lab[..., None], -inside.float()[..., None])
            p.mul_((g * weights)[..., None])
            return p.to(logits.dtype), None, None, None, None, None


def _sharded_cross_entropy(logits, labels, mask):
    """``cross_entropy`` of DTensor logits: the vocab stays split where it
    is (on "tp" after the head's constraint), the rows stay where they are,
    and the loss comes back as a plain tensor equal on every rank."""
    mesh = logits.device_mesh
    logits = _whole(logits)             # nothing partial
    pls = tuple(logits.placements)
    row_pls = tuple(p if p.is_shard() and p.dim % 3 < 2 else Replicate()
                    for p in pls)
    n = labels.numel()
    if mask is None:
        weights = torch.full(labels.shape, 1.0 / n, dtype=torch.float32,
                             device=logits.device)
    else:
        m = mask.float()
        weights = m / m.sum().clamp_min(1.0)

    def rows(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * len(pls),
                                   run_check=False)
        return t.redistribute(mesh, row_pls).to_local()

    vdims = [j for j, p in enumerate(pls) if p.is_shard() and p.dim % 3 == 2]
    rdims = [j for j, p in enumerate(pls) if p.is_shard() and p.dim % 3 < 2]
    lg = logits.to_local()
    return _CrossEntropy.apply(
        lg, rows(labels), rows(weights), _block(mesh, vdims) * lg.shape[-1],
        [mesh.get_group(j) for j in vdims], [mesh.get_group(j) for j in rdims])


def cross_entropy(logits, labels, mask=None):
    """logits (B,S,V); labels (B,S) int; mean over valid tokens."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels, mask)
    if mask is None:
        weights = torch.full(labels.shape, 1.0 / labels.numel(),
                             dtype=torch.float32, device=logits.device)
    else:
        m = mask.float()
        weights = m / m.sum().clamp_min(1.0)
    return _CrossEntropy.apply(logits, labels, weights, 0, (), ())
