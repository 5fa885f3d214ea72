"""Public wrappers for the kernels, as in ``repro/kernels/ops.py``.

On a CUDA tensor they launch the hand-written kernels; on a CPU tensor they
run the kernels' plain versions. ``flash_attention`` sends a non-zero
``q_offset`` to the blockwise ``flash_attention_xla`` port, since the kernel
assumes offset 0 (the same split as the reference). Forward only: the
backward comes with the training path.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q, k, v, causal=True, window=0, q_offset=0):
    if q_offset:
        from repro_torch.models.common import flash_attention_xla

        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    out, _ = _fa.flash_attention(q, k, v, causal=causal, window=window)
    return out


def rglru_scan(a, b, h0=None):
    return _rg.rglru_scan(a, b, h0)


def rmsnorm(x, w, eps=1e-6):
    return _rn.rmsnorm(x, w, eps)
