"""RG-LRU linear-recurrence scan: the CUDA kernels' wrappers and their plain
versions, forward and backward.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py`` (``rglru_scan``,
body ``_rglru_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over (B, S, C) fp32,
from ``h0`` or from zeros, returning every h. The kernels are
``csrc/rglru_scan.cu`` (see its note for the design and what bounds it),
built with ``nvcc`` at first use and called through ``ctypes``.

The kernels split time inside a block: each of W warps scans U steps of a
tile of W * U steps, the warps' aggregates are folded into each warp's
carry in a fixed order, and every step is scanned again from it. So they
associate the products and sums otherwise than the sequential loop.
``rglru_scan_plain`` and ``rglru_scan_backward_plain`` are the sequential
loops: the CPU wrappers run them. ``rglru_scan_blocked_plain`` and
``rglru_scan_backward_blocked_plain`` repeat the kernels' own order, each
product and sum rounded apart, so on the card a kernel equals its blocked
version to the bit; the tests and ``chip_smoke.py`` hold them to that.

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
import torch.nn.functional as F

launches = 0          # forward kernel launches since the last reset
launches_bwd = 0      # backward kernel launches since the last reset
meta_flops = 0       # FLOPs of the calls on meta tensors (the dry run)
_fns: dict = {}

# The kernels' tile (csrc/rglru_scan.cu): LANES channels a block, WARPS
# warps each taking STEPS consecutive steps of a tile.
LANES = 32
FWD_WARPS, FWD_STEPS = 8, 16
BWD_WARPS, BWD_STEPS = 8, 8

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


def _tiles(x, warps, steps, fill):
    """x (B, S, C) padded along S with ``fill`` to whole tiles of
    ``warps * steps`` steps, as (B, tiles, warps, steps, C)."""
    bsz, s, c = x.shape
    x = F.pad(x, (0, 0, 0, -s % (warps * steps)), value=fill)
    return x.view(bsz, -1, warps, steps, c)


def rglru_scan_blocked_plain(a, b, h0=None, *, warps=FWD_WARPS, steps=FWD_STEPS):
    """``rglru_scan`` in the forward kernel's order, in plain PyTorch (fp32):
    per tile of ``warps * steps`` steps, each warp's aggregate (the product
    of its a, and its scan from its first step), the tile's carry folded
    through the aggregates of the warps before each warp, then each warp's
    steps again from its carry. Steps past S are the identity (a = 1,
    b = 0). Every product and sum rounds apart, as in the kernel."""
    bsz, s, c = a.shape
    at, bt = _tiles(a, warps, steps, 1.0), _tiles(b, warps, steps, 0.0)
    out = torch.empty_like(bt)
    carry = a.new_zeros((bsz, c)) if h0 is None else h0
    for k in range(at.shape[1]):
        ak, bk = at[:, k], bt[:, k]                         # (B, W, U, C)
        agg_a, agg_b = ak[:, :, 0], bk[:, :, 0]
        for i in range(1, steps):
            agg_a = ak[:, :, i] * agg_a
            agg_b = ak[:, :, i] * agg_b + bk[:, :, i]
        h_in = [carry]
        for j in range(warps - 1):
            h_in.append(agg_a[:, j] * h_in[-1] + agg_b[:, j])
        h = torch.stack(h_in, 1)                            # (B, W, C)
        for i in range(steps):
            h = ak[:, :, i] * h + bk[:, :, i]
            out[:, k, :, i] = h
        carry = h[:, -1]
    return out.flatten(1, 3)[:, :s]


def rglru_scan_backward_blocked_plain(a, h, g, h0=None, *, warps=BWD_WARPS,
                                      steps=BWD_STEPS):
    """``rglru_scan_backward`` in the backward kernel's order, in plain
    PyTorch (fp32): the reverse recurrence ``lam_t = g_t + c_t * lam_{t+1}``
    (c_t = a_{t+1}, 0 at t = S-1) run tile by tile from the last, each
    warp's aggregate from its last step down, the carry folded through the
    warps after each warp from the last down, then each warp's steps again,
    giving db_t = lam_t and da_t = lam_t * h_{t-1}. Returns (da, db, dh0),
    dh0 = a_0 * lam_0, None when h0 is None."""
    bsz, s, c = a.shape
    zero = a.new_zeros((bsz, 1, c))
    ct = _tiles(torch.cat([a[:, 1:], zero], 1), warps, steps, 1.0)
    gt = _tiles(g, warps, steps, 0.0)
    ht = _tiles(torch.cat([zero if h0 is None else h0[:, None], h[:, :-1]], 1),
                warps, steps, 0.0)
    da, db = torch.empty_like(gt), torch.empty_like(gt)
    lam = a.new_zeros((bsz, c))
    for k in range(gt.shape[1] - 1, -1, -1):
        ck, gk, hk = ct[:, k], gt[:, k], ht[:, k]           # (B, W, U, C)
        agg_a, agg_b = ck[:, :, -1], gk[:, :, -1]
        for i in range(steps - 2, -1, -1):
            agg_a = ck[:, :, i] * agg_a
            agg_b = gk[:, :, i] + ck[:, :, i] * agg_b
        lam_in = [lam]
        for j in range(warps - 1, 0, -1):
            lam_in.append(agg_b[:, j] + agg_a[:, j] * lam_in[-1])
        lam = torch.stack(lam_in[::-1], 1)                  # (B, W, C)
        for i in range(steps - 1, -1, -1):
            lam = gk[:, :, i] + ck[:, :, i] * lam
            db[:, k, :, i] = lam
            da[:, k, :, i] = lam * hk[:, :, i]
        lam = lam[:, 0]
    da, db = da.flatten(1, 3)[:, :s], db.flatten(1, 3)[:, :s]
    return da, db, None if h0 is None else a[:, 0] * lam


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
    meta tensors (the dry run) get an empty output and 2 FLOPs an element
    in ``meta_flops``; tensors elsewhere raise."""
    global launches, meta_flops
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.is_meta and b.is_meta and (h0 is None or h0.is_meta):
        meta_flops += 2 * a.numel()
        return torch.empty_like(a)
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
    ``rglru_scan_backward_plain``; meta tensors get empty gradients and 3
    FLOPs an element in ``meta_flops``; tensors elsewhere raise."""
    global launches_bwd, meta_flops
    if a.device.type == "cpu":
        return rglru_scan_backward_plain(a, h, g, h0)
    if a.is_meta and h.is_meta and g.is_meta and (h0 is None or h0.is_meta):
        meta_flops += 3 * a.numel()
        return (torch.empty_like(a), torch.empty_like(a),
                None if h0 is None else torch.empty_like(h0))
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
