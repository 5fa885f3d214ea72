"""Fused RMSNorm: a Triton kernel for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_rmsnorm_kernel``): ``y = x32 * rsqrt(mean(x32^2) + eps) * w32``,
rounded once to x's dtype.

Bound on this card: one row reduction and one elementwise pass, so the
bytes set the least time (x read once, y written once, w once) at 3.35 TB/s.
The kernel runs one program per row over a masked block of
``next_pow2(D)`` columns: each byte of x is read once and each byte of y
written once, and ``D = 384`` works as well as ``D = 4096``.

``rmsnorm`` launches the kernel on a CUDA tensor and runs the plain version
on a CPU tensor; it never falls back from one to the other. Each launch adds
one to the module's ``launches`` count. ``triton`` is imported, and the
kernel defined, at the first launch: importing this module needs no Triton.
``rmsnorm_backward`` is the gradient of the function the kernel computes,
in plain PyTorch (the Pallas kernel has no backward either; the reference
differentiates its jnp ``rms_norm``). ``ops.rmsnorm`` pairs the two in an
autograd function on CUDA tensors.

(No ``from __future__ import annotations`` here: Triton reads the
``tl.constexpr`` annotation of the kernel as an object.)
"""
import torch

launches = 0          # kernel launches since the last reset
_kern = None
tl = None             # triton.language, bound at the first launch


def _kernel():
    global _kern, tl
    if _kern is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rmsnorm_kernel(x_ptr, w_ptr, y_ptr, row_stride, D, eps,
                            BLOCK_D: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x = tl.load(x_ptr + row * row_stride + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / D
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = x * tl.rsqrt(var + eps) * w
            tl.store(y_ptr + row * D + cols, y.to(y_ptr.dtype.element_ty),
                     mask=mask)

        _kern = (_rmsnorm_kernel, triton.next_power_of_2)
    return _kern


def rmsnorm_plain(x, w, eps: float = 1e-6):
    """The Pallas kernel's arithmetic in plain PyTorch."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_backward(x, w, dy, eps: float = 1e-6):
    """Gradient of ``y = (x32 * rsqrt(mean(x32^2) + eps) * w32)`` rounded
    once to x's dtype: returns (dx in x's dtype, dw in w's dtype), with dw
    summed over every row in fp32 before its one rounding.

    With ``n = x32 * r`` and ``r = rsqrt(mean(x32^2) + eps)``:
    ``dw = sum_rows(dy * n)``, ``dx = r * (dy*w - n * mean(dy*w * n))``."""
    d = x.shape[-1]
    xf = x.float()
    g = dy.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    n = xf * r
    dw = (g * n).reshape(-1, d).sum(0)
    dn = g * w.float()
    dx = r * (dn - n * (dn * n).mean(-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D); w: (D,) -> (..., D) in x's dtype.

    CUDA tensors go to the kernel, CPU tensors to ``rmsnorm_plain``; tensors
    elsewhere raise."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    d = x.shape[-1]
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm: x and w must lie on one CUDA device "
                         f"(got {x.device}, {w.device})")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm: x {x.dtype} / w {w.dtype} must be float32 "
                         "or bfloat16")
    if w.shape != (d,) or not w.is_contiguous() or x.stride(-1) != 1:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} must be ({d},) and "
                         "contiguous, x contiguous along its last dim")
    x2 = x.reshape(-1, d)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x2.shape[0]
    if rows == 0 or d == 0:
        return y
    kern, next_pow2 = _kernel()
    block = next_pow2(d)
    with torch.cuda.device(x.device):
        kern[(rows,)](x2, w, y, x2.stride(0), d, eps, BLOCK_D=block,
                      num_warps=8 if block >= 4096 else 4)
    launches += 1
    return y
