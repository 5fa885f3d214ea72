"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_attn_kernel``). The kernel is
``csrc/flash_attention.cu`` (see its note for the design and what bounds
it), built with ``nvcc`` at first use and called through ``ctypes``.

``flash_attention`` launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor; it never falls back from one to the other. Each
launch adds one to the module's ``launches`` count.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build

        fn = _build.load("flash_attention").repro_flash_attention_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, ctypes.c_float,
                       i, i, vp]
        fn.restype = i
        _fn = fn
    return _fn


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The Pallas kernel's arithmetic in plain PyTorch, materializing scores:
    fp32 upcast, fp32 scores, ``-1e30`` masks, ``max(l, 1e-30)``.

    q: (B,S,H,d); k, v: (B,T,KV,d) -> (out (B,S,H,d) in q's dtype,
    lse (B,H,S) fp32)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.float()[:, :, :, None].expand(b, t, kvh, g, d).reshape(b, t, h, d)
    vf = v.float()[:, :, :, None].expand(b, t, kvh, g, d).reshape(b, t, h, d)
    sc = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (1.0 / math.sqrt(d))
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    denom = p.sum(-1).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, vf) / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(denom)


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must all be float32 or all "
                         f"bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,d); k, v: (B,T,KV,d) -> (out (B,S,H,d), lse (B,H,S) fp32).

    CUDA tensors go to the kernel, CPU tensors to ``flash_attention_plain``;
    tensors elsewhere raise."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out, lse
    if t == 0:
        raise ValueError("flash_attention: empty key sequence")
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, t, h, kvh, d, _DTYPE_CODE[q.dtype],
                 1.0 / math.sqrt(d), int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out, lse
