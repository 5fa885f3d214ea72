"""RG-LRU linear-recurrence scan: the CUDA kernels' wrappers and their plain
versions, forward and backward.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py`` (``rglru_scan``,
body ``_rglru_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over (B, S, C) fp32,
from ``h0`` or from zeros, returning every h. The kernels are
``csrc/rglru_scan.cu`` (see its note for the design and what bounds it),
built with ``nvcc`` at first use and called through ``ctypes``.

The backward has no TPU kernel: the reference differentiates its
``associative_scan`` in XLA. ``rglru_scan_backward`` is the same linear
recurrence run backward in time over the cotangent g of h:
``lam_t = g_t + a_{t+1} * lam_{t+1}``, ``db_t = lam_t``,
``da_t = lam_t * h_{t-1}`` and ``dh0 = a_0 * lam_0``.

``rglru_scan`` and ``rglru_scan_backward`` launch their kernel on a CUDA
tensor and run the plain version on a CPU tensor; they never fall back
from one to the other. Each launch adds one to the module's ``launches``
(forward) or ``launches_bwd`` (backward) count.
"""
from __future__ import annotations

import ctypes

import torch

launches = 0          # forward kernel launches since the last reset
launches_bwd = 0      # backward kernel launches since the last reset
_fns: dict = {}

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbol and argument types of each pass
KERNELS = {"fwd": ("repro_rglru_scan_fwd", [_VP] * 4 + [_I] * 3 + [_VP]),
           "bwd": ("repro_rglru_scan_bwd", [_VP] * 7 + [_I] * 3 + [_VP])}


def _kernel(which: str = "fwd"):
    if which not in _fns:
        from repro_torch.kernels import _build

        symbol, argtypes = KERNELS[which]
        fn = getattr(_build.load("rglru_scan"), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[which] = fn
    return _fns[which]


def rglru_scan_plain(a, b, h0=None):
    """The recurrence as a loop over time in plain PyTorch (fp32), in the
    order of ``repro.kernels.ref.rglru_scan_ref``: a product, then a sum."""
    h = a.new_zeros((a.shape[0], a.shape[2])) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_backward_plain(a, h, g, h0=None):
    """The scan's gradient as a reverse loop over time in plain PyTorch
    (fp32): a, h (the forward's output) and g (B, S, C); h0 (B, C) or None.
    Returns (da, db, dh0), dh0 None when h0 is None. Each step rounds a
    product, then a sum, as the forward's plain version does."""
    bsz, s, c = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    lam = a.new_zeros((bsz, c))
    for t in range(s - 1, -1, -1):
        lam = g[:, t] + a[:, t + 1] * lam if t < s - 1 else g[:, t]
        db[:, t] = lam
        if t > 0:
            da[:, t] = lam * h[:, t - 1]
        else:
            da[:, t] = lam * (a.new_zeros((bsz, c)) if h0 is None else h0)
    if h0 is None:
        return da, db, None
    return da, db, a[:, 0] * lam if s else torch.zeros_like(h0)


def _check(what: str, tensors: dict, h0):
    """Raise unless ``tensors`` (name -> (B, S, C)) and h0 ((B, C) or None)
    are fp32, contiguous and on one CUDA device, as the kernels take them."""
    named = dict(tensors) if h0 is None else {**tensors, "h0": h0}
    first = next(iter(tensors.values()))
    names = ", ".join(named)
    if not (first.is_cuda and all(x.device == first.device for x in named.values())):
        raise ValueError(f"{what}: {names} must lie on one CUDA device "
                         f"(got {[str(x.device) for x in named.values()]})")
    if any(x.dtype != torch.float32 for x in named.values()):
        raise ValueError(f"{what}: {names} must be float32 (got "
                         f"{[x.dtype for x in named.values()]})")
    if first.dim() != 3 or any(x.shape != first.shape for x in tensors.values()) or (
            h0 is not None and h0.shape != (first.shape[0], first.shape[2])):
        raise ValueError(f"{what}: bad shapes " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in named.items()))
    if not all(x.is_contiguous() for x in named.values()):
        raise ValueError(f"{what}: {names} must be contiguous")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, C) fp32; h0: (B, C) fp32 or None -> h (B, S, C) fp32.

    CUDA tensors go to the kernel, CPU tensors to ``rglru_scan_plain``;
    tensors elsewhere raise."""
    global launches
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    _check("rglru_scan", {"a": a, "b": b}, h0)
    bsz, s, c = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn = _kernel("fwd")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), out.data_ptr(),
                 bsz, s, c, _stream(a))
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out


def rglru_scan_backward(a, h, g, h0=None):
    """Gradients (da, db, dh0) of ``rglru_scan``'s h, given a, the forward's
    output h, the cotangent g of h (all (B, S, C) fp32) and h0 ((B, C) fp32
    or None; dh0 is None then).

    CUDA tensors go to the kernel, CPU tensors to
    ``rglru_scan_backward_plain``; tensors elsewhere raise."""
    global launches_bwd
    if a.device.type == "cpu":
        return rglru_scan_backward_plain(a, h, g, h0)
    _check("rglru_scan_backward", {"a": a, "h": h, "g": g}, h0)
    bsz, s, c = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, db, None if h0 is None else dh0.zero_()
    fn = _kernel("bwd")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), h.data_ptr(), g.data_ptr(),
                 None if h0 is None else h0.data_ptr(), da.data_ptr(),
                 db.data_ptr(), None if h0 is None else dh0.data_ptr(),
                 bsz, s, c, _stream(a))
    if err != 0:
        raise RuntimeError(f"rglru_scan_backward kernel launch failed: cudaError {err}")
    launches_bwd += 1
    return da, db, dh0
