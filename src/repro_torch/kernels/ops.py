"""Public wrappers for the kernels, as in ``repro/kernels/ops.py``.

K1, K2 and K3 run inside autograd functions, so that training
differentiates through them: on a CUDA tensor their forwards and backwards
launch the hand-written kernels, on a CPU tensor the kernels' plain
versions.

- ``flash_attention``: K1's forward, with K1's backward kernels
  (``flash_attention.flash_attention_backward``, fed with the forward's out
  and LSE) where the reference's ``custom_vjp`` pairs its Pallas forward
  with an XLA backward; on the CPU that backward is the port of the XLA
  recompute (``models/common.py::flash_attention_bwd``). A non-zero
  ``q_offset`` goes to the blockwise ``flash_attention_xla`` port, since
  the kernel assumes offset 0 (the same split as the reference).
- ``rmsnorm``: K2's forward, with ``rmsnorm.rmsnorm_grad`` (K2's backward
  kernels; ``rmsnorm_backward`` on the CPU) as its gradient.
- ``rglru_scan``: K3's forward, with ``rglru.rglru_scan_backward`` (K3's
  backward kernel, fed with the forward's h; ``rglru_scan_backward_plain``
  on the CPU) as its gradient, where the reference differentiates its
  ``associative_scan`` in XLA.
- ``slstm_scan``: the sLSTM recurrence (no Pallas kernel: the reference's
  ``jax.lax.scan``), with ``slstm.slstm_scan_bwd`` (fed with the saving
  forward's g and c; ``slstm_scan_bwd_plain`` on the CPU) and
  ``slstm.slstm_dr_gates`` as its gradient, where XLA transposes the
  reference's scan. Where no gradient flows it calls the forward alone,
  which saves nothing.
- ``mlstm_chunk_scan``: the mLSTM's chunk recurrence (no Pallas kernel:
  the reference's ``jax.lax.scan`` over chunks). Its forward is
  ``mlstm.mlstm_intra_terms`` then one launch of ``mlstm.mlstm_carry``
  (saving the states between chunks where autograd records), its
  backward ``mlstm.mlstm_backward`` (one launch of ``mlstm.mlstm_carry_bwd``
  for the carried cotangents and dv's carried term k dC, batched torch for
  the rest), where XLA
  transposes the reference's scan; on the CPU the kernels' plain versions.

The backwards run inside the profiler ranges
``repro_torch.attention_backward``, ``repro_torch.rmsnorm_backward``,
``repro_torch.rglru_backward``, ``repro_torch.slstm_backward`` and
``repro_torch.mlstm_backward``.

A recompute under activation checkpointing runs the forward again, so it
launches (and counts) the kernel again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _ml
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import slstm as _sl


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _fa.flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_backward(q, k, v, out, lse, g,
                                                  causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rn.rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with torch.profiler.record_function("repro_torch.rmsnorm_backward"):
            dx, dw = _rn.rmsnorm_grad(x, w, dy, ctx.eps)
        return dx, dw, None


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = _rg.rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        with torch.profiler.record_function("repro_torch.rglru_backward"):
            da, db, dh0 = _rg.rglru_scan_backward(a, h, g.contiguous(), h0)
        return da, db, dh0


class _SLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, r_gates, h0, c0):
        hseq, h, c, g, cs = _sl.slstm_scan(gx, r_gates, h0, c0, save=True)
        ctx.save_for_backward(r_gates, h0, c0, hseq, g, cs)
        ctx.set_materialize_grads(False)
        return hseq, h, c

    @staticmethod
    def backward(ctx, dy, dh_n, dc_n):
        r_gates, h0, c0, hseq, g, cs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.profiler.record_function("repro_torch.slstm_backward"):
            dy = torch.zeros_like(hseq) if dy is None else dy.contiguous()
            dgx, dh0, dc0 = _sl.slstm_scan_bwd(
                g, cs, r_gates, dy, c0, *(None if x is None else x.contiguous()
                                          for x in (dh_n, dc_n)), need_dh0=need[2])
            dr = _sl.slstm_dr_gates(hseq, h0, dgx, r_gates.shape[0]) if need[1] else None
        return dgx, dr, dh0, dc0 if need[3] else None


class _MLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, i, logf, C0, n0):
        cl, h_intra, d_intra, qk = _ml.mlstm_intra_terms(q, k, v, i, logf, keep_qk=True)
        h, C, n, Cs, ns = _ml.mlstm_carry(q, k, v, i, cl, h_intra, d_intra, C0, n0,
                                          save=True)
        ctx.save_for_backward(q, k, v, i, logf, cl, d_intra, qk, C0, n0, Cs, ns, h)
        ctx.set_materialize_grads(False)
        return h, C, n

    @staticmethod
    def backward(ctx, dh, dC, dn):
        need = ctx.needs_input_grad
        with torch.profiler.record_function("repro_torch.mlstm_backward"):
            *grads, dC0, dn0 = _ml.mlstm_backward(
                *ctx.saved_tensors, None if dh is None else dh.contiguous(),
                *(None if x is None else x.contiguous() for x in (dC, dn)),
                need_state=need[5] or need[6])
        return *grads, dC0 if need[5] else None, dn0 if need[6] else None


def flash_attention(q, k, v, causal=True, window=0, q_offset=0):
    if q_offset:
        from repro_torch.models.common import flash_attention_xla

        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, causal, window)


def rglru_scan(a, b, h0=None):
    return _RGLRUScan.apply(a, b, h0)


def rmsnorm(x, w, eps=1e-6):
    return _RMSNorm.apply(x, w, eps)


def slstm_scan(gx, r_gates, h0=None, c0=None):
    """gx (B, S, 4D), r_gates (nh, dh, 4dh), h0 (B, D) and c0 (B, D) fp32 or
    None -> (h (B, S, D), the last h, the last c): ``slstm.slstm_scan``, under
    autograd with its backward."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (gx, r_gates, h0, c0)):
        return _SLSTMScan.apply(gx, r_gates, h0, c0)
    return _sl.slstm_scan(gx, r_gates, h0, c0)


def mlstm_chunk_scan(q, k, v, i, logf, C0, n0):
    """q, k, v (B, S, NH, dh), i and logf (B, S, NH) fp32, C0 (B, NH, dh, dh)
    and n0 (B, NH, dh) fp32 -> (h (B, S, NH, dh), C, n): the reference's
    ``_mlstm_chunk_scan``.

    The carry-free terms in torch (``mlstm_intra_terms``) and the loop over
    chunks in one call of ``mlstm_carry``: on a CUDA tensor one launch of the
    kernel, which raises where it cannot run (no fallback), on a CPU tensor
    its plain version, on meta tensors (the dry run) its meta branch
    counting the carried products' FLOPs. Where autograd records, the same
    through ``_MLSTMScan``, whose forward saves the states between chunks
    and whose backward is ``mlstm_backward`` (the backward kernel's
    wrapper on the same routes)."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (q, k, v, i, logf, C0, n0)):
        return _MLSTMScan.apply(q, k, v, i, logf, C0, n0)
    cl, h_intra, d_intra = _ml.mlstm_intra_terms(q, k, v, i, logf)
    return _ml.mlstm_carry(q, k, v, i, cl, h_intra, d_intra, C0, n0)
