"""sLSTM recurrence over time: the CUDA kernel's wrapper and its plain version.

Replaces no Pallas kernel: the reference runs the sLSTM cell as one
``jax.lax.scan`` (``repro/models/xlstm.py`` ``apply_slstm``, over
``_slstm_cell``), which XLA compiles into one loop on the device. The port's
loop over time is the kernel ``csrc/slstm_scan.cu`` (see its note for the
design and what bounds it), built with ``nvcc`` at first use and called
through ``ctypes``. For t = 0 .. S-1, from h0 and c0 or from zeros:

    gr  = einsum("bhd,hde->bhe", h_{t-1}, r_gates)     (B, nh, 4dh)
    i, f, z, o = split4(gx_t + gr.reshape(B, 4D))
    c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(z)      fp32
    h_t = sigmoid(o) tanh(c_t)                         cast to gx's dtype

The gates are the reference's flat split of the per-head product: output
column e of head h is flat index ``h * 4dh + e``, of gate ``idx // D`` and
channel ``idx % D`` (with xlstm-1.3b's 4 heads the gate is the head).

``slstm_scan`` launches the kernel on a CUDA tensor and runs
``slstm_scan_plain`` on a CPU tensor; it never falls back from one to the
other. Each launch adds one to ``launches``. The kernel has no backward
yet: on CUDA the wrapper refuses inputs that require grad while autograd
records.
"""
from __future__ import annotations

import ctypes

import torch

launches = 0          # kernel launches since the last reset
meta_flops = 0        # FLOPs of the calls on meta tensors (the dry run)
_fn = None

# The kernel's block (csrc/slstm_scan.cu): THREADS threads, each keeping c
# for up to MAX_PAIRS (batch row, channel) pairs.
THREADS, MAX_PAIRS = 512, 4
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbol and argument types
KERNEL = ("repro_slstm_scan", [_VP] * 8 + [_I] * 6 + [_VP])


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build

        symbol, argtypes = KERNEL
        fn = getattr(_build.load("slstm_scan"), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fn = fn
    return _fn


def slstm_cell(gx, h_prev, c_prev, r_gates, nh, dh):
    """One step, the reference's ``_slstm_cell``: gx (B, 4D) the input
    gates; h_prev (B, D) and r_gates in the activations' dtype, c_prev (B, D)
    fp32. Returns (h, c), h before its cast."""
    b = gx.shape[0]
    gr = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, nh, dh), r_gates)
    g = gx + gr.reshape(b, -1)
    i, f, z, o = torch.chunk(g, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(z)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def slstm_scan_plain(gx, r_gates, h0=None, c0=None):
    """The cell over the S steps of gx (B, S, 4D) as a loop in plain
    PyTorch, from h0 (B, D) in gx's dtype and c0 (B, D) fp32 or zeros.
    Returns (h (B, S, D) in gx's dtype, the last h, the last c fp32)."""
    dt = gx.dtype
    b, s, d4 = gx.shape
    nh, dh = r_gates.shape[:2]
    h = gx.new_zeros((b, d4 // 4)) if h0 is None else h0
    c = gx.new_zeros((b, d4 // 4), dtype=torch.float32) if c0 is None else c0
    hs = []
    for t in range(s):
        h2, c = slstm_cell(gx[:, t], h, c.float(), r_gates, nh, dh)
        h = h2.to(dt)
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else gx.new_empty((b, 0, d4 // 4))
    return out, h, c


def flops(b, s, nh, dh) -> int:
    """The products' FLOPs, ``2 B S nh dh 4dh``: what the dry run's counter
    (``torch.utils.flop_counter``) counts for the plain loop, whose
    elementwise cell it does not count."""
    return 2 * b * s * nh * dh * 4 * dh


def smem_bytes(elem: int, b: int, d: int, dh: int, cpb: int) -> int:
    """Shared-memory bytes of one block (``smem_bytes`` in the source): its
    4 x cpb columns of r_gates, h_{t-1}, the products and its new h."""
    def a16(n):
        return (n + 15) // 16 * 16
    return (a16(elem * 4 * cpb * dh) + a16(elem * b * d) + a16(4 * 4 * cpb * b)
            + a16(elem * b * cpb))


def plan(b: int, d: int, dh: int, elem: int, sms: int) -> tuple[int, int, int]:
    """(channels a block, blocks, shared bytes a block) on a card of ``sms``
    SMs: the fewest channels a block, rounded up to even (a block publishes
    its h in 4-byte words), that keep the grid within one block an SM, as
    the exchange between blocks needs. Raises where the kernel cannot take
    the shapes."""
    cpb = -(-d // sms)
    cpb += cpb % 2
    grid = -(-d // cpb)
    smem = smem_bytes(elem, b, d, dh, cpb)
    if b * cpb > MAX_PAIRS * THREADS:
        raise ValueError(f"slstm_scan: batch {b} x {cpb} channels a block exceeds "
                         f"{MAX_PAIRS * THREADS} (row, channel) pairs")
    if smem > SMEM_LIMIT:
        raise ValueError(f"slstm_scan: {smem} bytes of shared memory a block at batch "
                         f"{b}, width {d}, head dim {dh} exceed {SMEM_LIMIT}")
    return cpb, grid, smem


def _check(gx, r_gates, h0, c0):
    """Raise unless the inputs are as the kernel takes them."""
    named = {"gx": gx, "r_gates": r_gates, "h0": h0, "c0": c0}
    named = {k: v for k, v in named.items() if v is not None}
    if not (gx.is_cuda and all(x.device == gx.device for x in named.values())):
        raise ValueError("slstm_scan: gx, r_gates, h0, c0 must lie on one CUDA device "
                         f"(got {[str(x.device) for x in named.values()]})")
    if torch.is_grad_enabled() and any(x.requires_grad for x in named.values()):
        raise ValueError("slstm_scan: the kernel has no backward; run slstm_scan_plain "
                         "where a gradient flows")
    dt = gx.dtype
    if dt not in (torch.bfloat16, torch.float32) or r_gates.dtype != dt or (
            h0 is not None and h0.dtype != dt) or (
            c0 is not None and c0.dtype != torch.float32):
        raise ValueError("slstm_scan: gx, r_gates and h0 must share bf16 or fp32 and "
                         f"c0 be fp32 (got {[x.dtype for x in named.values()]})")
    b, _, d4 = gx.shape if gx.dim() == 3 else (0, 0, 0)
    d = d4 // 4
    if gx.dim() != 3 or d4 % 4 or r_gates.dim() != 3 or (
            r_gates.shape[0] * r_gates.shape[1] != d) or (
            r_gates.shape[2] != 4 * r_gates.shape[1]) or any(
            x is not None and x.shape != (b, d) for x in (h0, c0)):
        raise ValueError("slstm_scan: bad shapes " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in named.items()))
    if d % 8 or r_gates.shape[1] % 2:
        raise ValueError(f"slstm_scan: width {d} must be a multiple of 8 and head dim "
                         f"{r_gates.shape[1]} even")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in named.values()):
        raise ValueError("slstm_scan: gx, r_gates, h0, c0 must be contiguous and "
                         "16-byte aligned")


def slstm_scan(gx, r_gates, h0=None, c0=None):
    """gx (B, S, 4D) and r_gates (nh, dh, 4dh) in bf16 or fp32, h0 (B, D) in
    their dtype and c0 (B, D) fp32, each or None (zeros) -> (h (B, S, D),
    the last h (B, D), the last c (B, D) fp32).

    CUDA tensors go to the kernel, CPU tensors to ``slstm_scan_plain``;
    meta tensors (the dry run) get empty outputs and the products' FLOPs in
    ``meta_flops``; tensors elsewhere raise."""
    global launches, meta_flops
    if gx.device.type == "cpu":
        return slstm_scan_plain(gx, r_gates, h0, c0)
    if all(x is None or x.is_meta for x in (gx, r_gates, h0, c0)):
        b, s, d4 = gx.shape
        meta_flops += flops(b, s, *r_gates.shape[:2])
        return (gx.new_empty((b, s, d4 // 4)), gx.new_empty((b, d4 // 4)),
                gx.new_empty((b, d4 // 4), dtype=torch.float32))
    _check(gx, r_gates, h0, c0)
    b, s, d4 = gx.shape
    d = d4 // 4
    out = gx.new_empty((b, s, d))
    h_n = gx.new_empty((b, d))
    c_n = gx.new_empty((b, d), dtype=torch.float32)
    if s == 0 or b == 0:
        return (out, h_n.copy_(h0) if h0 is not None else h_n.zero_(),
                c_n.copy_(c0) if c0 is not None else c_n.zero_())
    nh, dh = r_gates.shape[:2]
    sms = torch.cuda.get_device_properties(gx.device).multi_processor_count
    cpb, _, _ = plan(b, d, dh, gx.element_size(), sms)
    # the blocks' exchange of h: two buffers of B x D values in 8-byte words
    # of 4 data bytes and a tag
    xch = torch.empty(2 * b * d * gx.element_size() // 4, dtype=torch.int64,
                      device=gx.device)
    fn = _kernel()
    with torch.cuda.device(gx.device):
        err = fn(gx.data_ptr(), r_gates.data_ptr(),
                 None if h0 is None else h0.data_ptr(),
                 None if c0 is None else c0.data_ptr(), out.data_ptr(), h_n.data_ptr(),
                 c_n.data_ptr(), xch.data_ptr(), b, s, d, nh, cpb,
                 int(gx.dtype == torch.bfloat16),
                 torch.cuda.current_stream(gx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: cudaError {err} (720: "
                           "the grid cannot be resident at once)")
    launches += 1
    return out, h_n, c_n
