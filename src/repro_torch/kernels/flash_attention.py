"""Flash attention forward: the CUDA kernels' wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_attn_kernel``) with two hand-written kernels,
each built with ``nvcc`` at first use and called through ``ctypes``
(see each source's note for its design and what bounds it):

- ``csrc/flash_attention_sm90.cu``: bf16 with head dim 64, 128 or 256, a
  warp-specialised kernel with TMA loads and wgmma products (route "sm90");
- ``csrc/flash_attention.cu``: every other call, fp32 or head dim 16 or 32,
  a SIMT kernel with fp32 FMAs (route "simt").

``flash_attention`` launches a kernel on a CUDA tensor and runs the plain
version on a CPU tensor; it never falls back from one to the other. Each
launch adds one to the module's ``launches`` count, and a launch of the
sm90 kernel also to ``launches_sm90``.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

SM90_HEAD_DIMS = (64, 128, 256)
TMA_ALIGN = 16        # bytes: TMA's base-pointer and stride granule

launches = 0          # kernel launches since the last reset, both routes
launches_sm90 = 0     # of which the sm90 kernel
_fns: dict = {}


def _kernel(route_name: str):
    if route_name not in _fns:
        from repro_torch.kernels import _build

        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if route_name == "sm90":
            fn = _build.load("flash_attention_sm90").repro_flash_attention_sm90_fwd
            fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp, vp, vp, f,
                           i, i, vp]
        else:
            fn = _build.load("flash_attention").repro_flash_attention_fwd
            fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, f, i, i, vp]
        fn.restype = i
        _fns[route_name] = fn
    return _fns[route_name]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: "sm90" for bf16 at head dim 64, 128 or
    256, "simt" for everything else (fp32, head dim 16 or 32)."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "simt"


def check_tma_layout(t: torch.Tensor, name: str = "tensor") -> None:
    """Raise ``ValueError`` unless TMA can read ``t`` as it lies: its base
    pointer 16-byte aligned, its last dim contiguous, and every other stride
    a multiple of 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s base pointer is not "
                         f"{TMA_ALIGN}-byte aligned (offset {t.data_ptr() % TMA_ALIGN})")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last dim is not contiguous")
    bad = [st * size for st in t.stride()[:-1] if (st * size) % TMA_ALIGN]
    if bad:
        raise ValueError(f"flash_attention: {name}'s strides {bad} bytes are not "
                         f"multiples of {TMA_ALIGN}")


def check_layout(route_name: str, q, k, v) -> None:
    """Raise ``ValueError`` unless the kernel of ``route_name`` can read q, k
    and v as they lie. The sm90 kernel reads them through TMA tensor maps
    built from their strides, so views such as slices of a packed QKV
    projection or of a longer cache need no copy (``check_tma_layout``);
    the SIMT kernel indexes them as contiguous tensors."""
    if route_name == "sm90":
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(x, name)
    elif not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the SIMT kernel (fp32, or head dim "
                         "16 or 32) takes contiguous q, k, v")


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


def run_kernel(route_name, q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel of ``route_name`` ("sm90" or "simt") on CUDA tensors
    that ``_check`` accepts, count the launch, and return (out, lse), both
    contiguous."""
    global launches, launches_sm90
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out, lse
    if t == 0:
        raise ValueError("flash_attention: empty key sequence")
    if route_name == "sm90" and route(q.dtype, d) != "sm90":
        raise ValueError(f"flash_attention: the sm90 kernel takes bf16 at head "
                         f"dim {SM90_HEAD_DIMS} (got {q.dtype}, {d})")
    check_layout(route_name, q, k, v)
    fn = _kernel(route_name)
    scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route_name == "sm90":
            strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v)]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, s, t, h, kvh, d, *strides, scale,
                     int(causal), int(window), stream)
        else:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, s, t, h, kvh, d, _DTYPE_CODE[q.dtype],
                     scale, int(causal), int(window), stream)
    if err != 0:
        what = ("cuTensorMapEncodeTiled not found" if err == -1 else
                f"tensor map refused, CUresult {-err - 1000}" if err < -1 else
                f"cudaError {err}")
        raise RuntimeError(f"flash_attention {route_name} kernel launch failed: {what}")
    launches += 1
    if route_name == "sm90":
        launches_sm90 += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,d); k, v: (B,T,KV,d) -> (out (B,S,H,d), lse (B,H,S) fp32).

    CUDA tensors go to the kernel that ``route`` picks, CPU tensors to
    ``flash_attention_plain``; tensors elsewhere raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    return run_kernel(route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                      window=window)
