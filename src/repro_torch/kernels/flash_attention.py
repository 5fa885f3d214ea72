"""Flash attention: the CUDA kernels' wrappers, forward and backward, and
the forward's plain version.

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

The backward, ``flash_attention_backward`` (dq, dk, dv from q, k, v, the
forward's out and LSE, and dO), has two hand-written kernels of its own, in
place of the XLA recompute that the reference pairs with its Pallas kernel:

- ``csrc/flash_attention_bwd_sm90.cu``: bf16 at head dim 64, 128 or 256,
  TMA loads and wgmma products, with tiles of their own at head dim 256
  (route "sm90" of ``bwd_route``);
- ``csrc/flash_attention_bwd.cu``: every other call, fp32 or head dim 16
  or 32, a SIMT kernel with fp32 FMAs (route "simt").

On a CPU tensor it runs the plain recompute ``models/common.py::
flash_attention_bwd``. Its launches count in ``launches_bwd``, and those of
the sm90 kernel also in ``launches_bwd_sm90``.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

SM90_HEAD_DIMS = (64, 128, 256)
BWD_SM90_HEAD_DIMS = (64, 128, 256)
TMA_ALIGN = 16        # bytes: TMA's base-pointer and stride granule
ROW_PAD = 64          # the backward's LSE and D rows, padded (csrc/attention_bwd.cuh)

launches = 0          # forward kernel launches since the last reset, both routes
launches_sm90 = 0     # of which the sm90 kernel
launches_bwd = 0      # backward kernel launches, both routes
launches_bwd_sm90 = 0  # of which the sm90 kernel
meta_flops = 0        # FLOPs of the calls on meta tensors (the dry run), both passes
_fns: dict = {}


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (source, C symbol, argument types) of each kernel, by (pass, route)
KERNELS = {
    ("fwd", "sm90"): ("flash_attention_sm90", "repro_flash_attention_sm90_fwd",
                      [_VP] * 5 + [_I] * 6 + [_VP] * 3 + [_F, _I, _I, _VP]),
    ("fwd", "simt"): ("flash_attention", "repro_flash_attention_fwd",
                      [_VP] * 5 + [_I] * 7 + [_F, _I, _I, _VP]),
    ("bwd", "sm90"): ("flash_attention_bwd_sm90", "repro_flash_attention_bwd_sm90",
                      [_VP] * 13 + [_I] * 6 + [_VP] * 3 + [_F, _I, _I, _VP]),
    ("bwd", "simt"): ("flash_attention_bwd", "repro_flash_attention_bwd",
                      [_VP] * 14 + [_I] * 7 + [_F, _I, _I, _VP]),
}


def _kernel(route_name: str, which: str = "fwd"):
    key = (which, route_name)
    if key not in _fns:
        from repro_torch.kernels import _build

        source, symbol, argtypes = KERNELS[key]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[key] = fn
    return _fns[key]


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: "sm90" for bf16 at head dim 64, 128 or
    256, "simt" for everything else (fp32, head dim 16 or 32)."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "simt"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernel a CUDA call takes: "sm90" for bf16 at head dim 64,
    128 or 256, "simt" for everything else (fp32, head dim 16 or 32)."""
    return "sm90" if dtype == torch.bfloat16 and d in BWD_SM90_HEAD_DIMS else "simt"


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


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        why = ("cuTensorMapEncodeTiled not found" if err == -1 else
               f"tensor map refused, CUresult {-err - 1000}" if err < -1 else
               f"cudaError {err}")
        raise RuntimeError(f"{what} kernel launch failed: {why}")


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
    _raise_on(err, f"flash_attention {route_name}")
    launches += 1
    if route_name == "sm90":
        launches_sm90 += 1
    return out, lse


def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """The (q, k) pairs inside the mask of one (batch, head): causal aligned
    top-left, ``window`` > 0 keeping the last ``window`` keys, ``t`` keys."""
    if not causal:
        return s * t
    cap = min(t, window) if window > 0 else t
    if cap >= s:
        return s * (s + 1) // 2
    return cap * (cap + 1) // 2 + (s - cap) * cap


def attention_flops(q, k, causal: bool, window: int) -> int:
    """K1's forward FLOPs: the two products over the pairs in the mask."""
    b, s, h, d = q.shape
    return 4 * d * b * h * attention_pairs(s, k.shape[1], causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,d); k, v: (B,T,KV,d) -> (out (B,S,H,d), lse (B,H,S) fp32).

    CUDA tensors go to the kernel that ``route`` picks, CPU tensors to
    ``flash_attention_plain``; meta tensors (the dry run; all of them on
    meta) get empty outputs of the kernel's shapes and dtypes, and their
    FLOPs go to ``meta_flops``; tensors elsewhere raise."""
    global meta_flops
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if all(x.is_meta for x in (q, k, v)):
        meta_flops += attention_flops(q, k, causal, window)
        return (torch.empty_like(q),
                torch.empty(q.shape[0], q.shape[2], q.shape[1],
                            dtype=torch.float32, device="meta"))
    _check(q, k, v)
    return run_kernel(route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                      window=window)


def _check_bwd(q, k, v, out, lse, g):
    _check(q, k, v)
    b, s, h, _ = q.shape
    for name, x, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", g, q.shape, q.dtype),
                                  ("lse", lse, (b, h, s), torch.float32)):
        if x.device != q.device or tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"flash_attention_backward: {name} must be {dtype} "
                             f"{tuple(shape)} on {q.device} (got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device})")


def run_backward_kernel(route_name, q, k, v, out, lse, g, *, causal: bool = True,
                        window: int = 0):
    """Launch the backward kernels of ``route_name`` ("sm90" or "simt") on
    CUDA tensors that ``_check_bwd`` accepts, count the launch, and return
    (dq, dk, dv) in the inputs' dtype. The sm90 kernels read q, k and v
    through TMA maps built from their strides (``check_tma_layout``); out,
    dO and LSE, and for the SIMT kernel q, k and v too, are made contiguous
    here (autograd may hand over a strided dO).

    Scratch: the sm90 route writes each q head's fp32 dK and dV, (B,T,H,d),
    and sums each GQA group's heads in a fixed order, so its result is the
    same from run to run; the SIMT route adds fp32 dq, dk and dv with
    atomics into zero-filled accumulators, so their last bits are not."""
    global launches_bwd, launches_bwd_sm90
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dev = q.device
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    if b == 0 or s == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if route_name == "sm90":
        if bwd_route(q.dtype, d) != "sm90":
            raise ValueError(f"flash_attention_backward: the sm90 kernel takes bf16 at "
                             f"head dim {BWD_SM90_HEAD_DIMS} (got {q.dtype}, {d})")
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_tma_layout(x, name)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse, g = out.contiguous(), lse.contiguous(), g.contiguous()
    f32 = torch.float32
    if route_name == "sm90":
        scratch = (torch.empty((b, t, h, d), dtype=f32, device=dev),
                   torch.empty((b, t, h, d), dtype=f32, device=dev))
    else:
        scratch = (torch.zeros((b, s, h, d), dtype=f32, device=dev),
                   torch.zeros((b, t, kvh, d), dtype=f32, device=dev),
                   torch.zeros((b, t, kvh, d), dtype=f32, device=dev))
    rows = torch.empty((2, b, h, -(-s // ROW_PAD) * ROW_PAD), dtype=f32, device=dev)
    ptrs = [x.data_ptr() for x in (q, k, v, out, lse, g, dq, dk, dv, *scratch,
                                   rows[0], rows[1])]
    fn = _kernel(route_name, "bwd")
    scale = 1.0 / math.sqrt(d)
    with torch.profiler.record_function("repro_torch.attention_backward"), \
            torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route_name == "sm90":
            strides = [(ctypes.c_longlong * 3)(*x.stride()[:3]) for x in (q, k, v)]
            err = fn(*ptrs, b, s, t, h, kvh, d, *strides, scale, int(causal),
                     int(window), stream)
        else:
            err = fn(*ptrs, b, s, t, h, kvh, d, _DTYPE_CODE[q.dtype], scale,
                     int(causal), int(window), stream)
    _raise_on(err, f"flash_attention_backward {route_name}")
    launches_bwd += 1
    if route_name == "sm90":
        launches_bwd_sm90 += 1
    return dq, dk, dv


def flash_attention_backward(q, k, v, out, lse, g, *, causal: bool = True,
                             window: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention``'s out, given its inputs,
    its (out, lse) and the cotangent g of out, in the dtypes of q, k, v.

    CUDA tensors go to the kernel that ``bwd_route`` picks; CPU tensors to
    the plain recompute ``models/common.py::flash_attention_bwd`` (the
    reference's ``_flash_vjp_bwd``); meta tensors get empty gradients and
    2.5x the forward's FLOPs in ``meta_flops``; tensors elsewhere raise."""
    global meta_flops
    if all(x.is_meta for x in (q, k, v, out, lse, g)):
        meta_flops += int(2.5 * attention_flops(q, k, causal, window))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        from repro_torch.models.common import flash_attention_bwd

        return flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
    _check_bwd(q, k, v, out, lse, g)
    return run_backward_kernel(bwd_route(q.dtype, q.shape[-1]), q, k, v, out, lse, g,
                               causal=causal, window=window)
