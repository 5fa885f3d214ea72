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

The backwards run inside the profiler ranges
``repro_torch.attention_backward``, ``repro_torch.rmsnorm_backward`` and
``repro_torch.rglru_backward``.

A recompute under activation checkpointing runs the forward again, so it
launches (and counts) the kernel again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rmsnorm as _rn


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
