"""Plain-PyTorch oracles for the kernels (allclose targets), as in
``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import naive_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Materialized-scores attention — the kernel oracle."""
    return naive_attention(q, k, v, causal=causal, window=window)


def rglru_scan_ref(a, b, h0=None):
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t."""
    h = a.new_zeros((a.shape[0], a.shape[2])) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rmsnorm_ref(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
