"""Plain-PyTorch oracles for the kernels (allclose targets), as in
``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import naive_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Materialized-scores attention — the kernel oracle."""
    return naive_attention(q, k, v, causal=causal, window=window)


def rmsnorm_ref(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
