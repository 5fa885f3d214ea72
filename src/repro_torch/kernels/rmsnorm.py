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

The backward, ``rmsnorm_grad``, is the gradient of the function the kernel
computes (the Pallas kernel has no backward; the reference differentiates
its jnp ``rms_norm``): on a CUDA tensor two Triton kernels, on a CPU tensor
its plain version ``rmsnorm_backward``. The first kernel recomputes each
row's ``r = rsqrt(mean(x32^2) + eps)`` and ``n = x32 * r`` and writes
``dx = r * (dy*w - n * mean(dy*w * n))`` rounded once to x's dtype, one
program over a run of rows, each also summing ``dy * n`` over its rows into a
partial of dw; the second sums the partials and rounds dw once to w's dtype.
dw sums thousands of rows, and any two fp32 orders of that sum, or two ``r``
a few ulps apart (Triton's ``rsqrt`` is approximate), differ by more than
1e-5 on elements near zero; so ``r`` for dw, the partials and their sum are
fp64, and dw is the sum of the exact terms rounded once. Bound by bytes like
the forward (x and dy read once, dx written once): three programs per SM,
each loading four rows ahead (``tl.range(..., num_stages=4)``), keep enough
bytes in flight, and their partials (6.5 MB at 2048 columns, in L2) are
summed by one load per column block. Its launches count in ``launches_bwd``.
``ops.rmsnorm`` pairs forward and backward in an autograd function.

(No ``from __future__ import annotations`` here: Triton reads the
``tl.constexpr`` annotation of the kernel as an object.)
"""
import torch

launches = 0          # forward kernel launches since the last reset
launches_bwd = 0      # backward launches (one per call: both of its kernels)
meta_flops = 0       # FLOPs of the calls on meta tensors (the dry run)
_kern = None
_bwd_kern = None
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


def _bwd_kernels():
    global _bwd_kern, tl
    if _bwd_kern is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rmsnorm_bwd_kernel(x_ptr, w_ptr, dy_ptr, dx_ptr, part_ptr, x_stride,
                                dy_stride, rows, rows_per_prog, D, eps,
                                BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            dw = tl.zeros([BLOCK_D], dtype=tl.float64)
            start = pid * rows_per_prog
            end = tl.minimum(start + rows_per_prog, rows)
            for row in tl.range(start, end, num_stages=4):
                r64 = row.to(tl.int64)
                x = tl.load(x_ptr + r64 * x_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                g = tl.load(dy_ptr + r64 * dy_stride + cols, mask=mask,
                            other=0.0).to(tl.float32)
                xd = x.to(tl.float64)
                rd = 1.0 / tl.sqrt(tl.sum(xd * xd, axis=0) / D + eps)
                r = rd.to(tl.float32)
                n = x * r
                dn = g * w
                dx = r * (dn - n * (tl.sum(dn * n, axis=0) / D))
                tl.store(dx_ptr + r64 * D + cols, dx.to(dx_ptr.dtype.element_ty),
                         mask=mask)
                dw += g.to(tl.float64) * (xd * rd)
            tl.store(part_ptr + pid * D + cols, dw, mask=mask)

        @triton.jit
        def _rmsnorm_dw_kernel(part_ptr, dw_ptr, n_parts, D, BLOCK_P: tl.constexpr,
                               BLOCK_C: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < D
            acc = tl.zeros([BLOCK_C], dtype=tl.float64)
            for p0 in range(0, n_parts, BLOCK_P):
                parts = p0 + tl.arange(0, BLOCK_P)
                acc += tl.sum(tl.load(part_ptr + parts[:, None] * D + cols[None, :],
                                      mask=(parts[:, None] < n_parts) & cmask[None, :],
                                      other=0.0), axis=0)
            tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=cmask)

        _bwd_kern = (_rmsnorm_bwd_kernel, _rmsnorm_dw_kernel, triton.next_power_of_2)
    return _bwd_kern


def _compute_dtype(x):
    """fp32 for the kernels' dtypes; fp64 inputs stay fp64, so that a check
    can evaluate the plain versions' arithmetic exactly."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_plain(x, w, eps: float = 1e-6):
    """The Pallas kernel's arithmetic in plain PyTorch (in fp64 for fp64
    inputs)."""
    xf = x.to(_compute_dtype(x))
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(xf.dtype)).to(x.dtype)


def rmsnorm_backward(x, w, dy, eps: float = 1e-6):
    """Gradient of ``y = (x32 * rsqrt(mean(x32^2) + eps) * w32)`` rounded
    once to x's dtype: returns (dx in x's dtype, dw in w's dtype), with dw
    summed over every row in fp32 (fp64 for fp64 inputs) before its one
    rounding.

    With ``n = x32 * r`` and ``r = rsqrt(mean(x32^2) + eps)``:
    ``dw = sum_rows(dy * n)``, ``dx = r * (dy*w - n * mean(dy*w * n))``."""
    d = x.shape[-1]
    xf = x.to(_compute_dtype(x))
    g = dy.to(xf.dtype)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    n = xf * r
    dw = (g * n).reshape(-1, d).sum(0)
    dn = g * w.to(xf.dtype)
    dx = r * (dn - n * (dn * n).mean(-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x, w):
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


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D); w: (D,) -> (..., D) in x's dtype.

    CUDA tensors go to the kernel, CPU tensors to ``rmsnorm_plain``; meta
    tensors (the dry run) get an empty output and 4 FLOPs an element in
    ``meta_flops``; tensors elsewhere raise."""
    global launches, meta_flops
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.is_meta and w.is_meta:
        meta_flops += 4 * x.numel()
        return torch.empty_like(x)
    d = x.shape[-1]
    _check(x, w)
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


def rmsnorm_grad(x, w, dy, eps: float = 1e-6):
    """Gradient of ``rmsnorm``: (dx in x's dtype, dw in w's dtype) for the
    cotangent dy of its output.

    CUDA tensors go to the Triton kernels, CPU tensors to
    ``rmsnorm_backward``; meta tensors get empty gradients and 8 FLOPs an
    element in ``meta_flops``; tensors elsewhere raise."""
    global launches_bwd, meta_flops
    if x.device.type == "cpu":
        return rmsnorm_backward(x, w, dy, eps)
    if x.is_meta and w.is_meta and dy.is_meta:
        meta_flops += 8 * x.numel()
        return torch.empty_like(x), torch.empty_like(w)
    _check(x, w)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"rmsnorm_grad: dy {tuple(dy.shape)} on {dy.device} must "
                         f"match x {tuple(x.shape)} on {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    dy2 = (dy if dy.stride(-1) == 1 else dy.contiguous()).reshape(-1, d)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty((d,), dtype=w.dtype, device=w.device)
    rows = x2.shape[0]
    if rows == 0 or d == 0:
        return dx, dw.zero_()
    n_prog = min(rows, 3 * torch.cuda.get_device_properties(x.device).multi_processor_count)
    per = -(-rows // n_prog)
    n_prog = -(-rows // per)
    part = torch.empty((n_prog, d), dtype=torch.float64, device=x.device)
    kern, dw_kern, next_pow2 = _bwd_kernels()
    block = next_pow2(d)
    block_c = 16
    with torch.cuda.device(x.device):
        kern[(n_prog,)](x2, w, dy2, dx, part, x2.stride(0), dy2.stride(0), rows, per,
                        d, eps, BLOCK_D=block, num_warps=8 if block >= 4096 else 4)
        dw_kern[(-(-d // block_c),)](part, dw, n_prog, d,
                                     BLOCK_P=min(512, next_pow2(n_prog)),
                                     BLOCK_C=block_c, num_warps=8)
    launches_bwd += 1
    return dx, dw
