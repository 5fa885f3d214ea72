"""RG-LRU linear-recurrence scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py`` (``rglru_scan``,
body ``_rglru_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over (B, S, C) fp32,
from ``h0`` or from zeros, returning every h. The kernel is
``csrc/rglru_scan.cu`` (see its note for the design and what bounds it),
built with ``nvcc`` at first use and called through ``ctypes``.

``rglru_scan`` launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor; it never falls back from one to the other. Each
launch adds one to the module's ``launches`` count.
"""
from __future__ import annotations

import ctypes

import torch

launches = 0          # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build

        fn = _build.load("rglru_scan").repro_rglru_scan_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        fn.restype = i
        _fn = fn
    return _fn


def rglru_scan_plain(a, b, h0=None):
    """The recurrence as a loop over time in plain PyTorch (fp32), in the
    order of ``repro.kernels.ref.rglru_scan_ref``: a product, then a sum."""
    h = a.new_zeros((a.shape[0], a.shape[2])) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def _check(a, b, h0):
    tensors = (a, b) if h0 is None else (a, b, h0)
    if not (a.is_cuda and all(x.device == a.device for x in tensors)):
        raise ValueError("rglru_scan: a, b, h0 must lie on one CUDA device "
                         f"(got {[str(x.device) for x in tensors]})")
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("rglru_scan: a, b, h0 must be float32 (got "
                         f"{[x.dtype for x in tensors]})")
    if a.dim() != 3 or b.shape != a.shape or (
            h0 is not None and h0.shape != (a.shape[0], a.shape[2])):
        raise ValueError(f"rglru_scan: bad shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rglru_scan: a, b, h0 must be contiguous")


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, C) fp32; h0: (B, C) fp32 or None -> h (B, S, C) fp32.

    CUDA tensors go to the kernel, CPU tensors to ``rglru_scan_plain``;
    tensors elsewhere raise."""
    global launches
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    _check(a, b, h0)
    bsz, s, c = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), out.data_ptr(),
                 bsz, s, c, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out
