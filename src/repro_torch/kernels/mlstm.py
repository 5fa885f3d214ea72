"""The mLSTM's chunk recurrence: the CUDA kernel's wrapper and its plain versions.

Replaces no Pallas kernel: the reference runs the mLSTM's chunkwise form as
one ``jax.lax.scan`` over chunks of CHUNK positions
(``repro/models/xlstm.py:108``, body ``_mlstm_chunk_scan`` at :80-106), which
XLA compiles into one loop on the device. Per chunk j, with cl the
within-chunk cumulative log forget gate:

    h_intra, d_intra   the chunk's own causal attention-like terms
    h_inter = bf16(q_j . bf16(C_{j-1})) * bf16(exp(cl))      (fp32: no rounding)
    d_inter = (q_j . n_{j-1}) exp(cl)
    h_j     = (h_intra + h_inter) / max(|d_intra + d_inter|, 1)
    C_j     = exp(cl_end) C_{j-1} + sum_l (w_l k_l) v_l^T,   w_l = exp(cl_end - cl_l) i_l
    n_j     = exp(cl_end) n_{j-1} + sum_l w_l k_l

Only C and n are carried. ``mlstm_intra_terms`` computes the carry-free
terms (cl, h_intra, d_intra) of every chunk in plain torch, many chunks a
batch (products the reference leaves to XLA); ``mlstm_carry`` then runs the
whole loop over chunks in one launch of ``csrc/mlstm_scan.cu``
(``repro_mlstm_scan``): each block keeps its columns of C and a copy of n
on chip from the first chunk to the last and writes them once. The kernel
reads q, k, v, h_intra and writes h once each, and does the two dh x dh
products of every chunk: at xlstm-1.3b's dh 1024 in bf16 the products bound
it (4 B S nh dh^2 FLOPs against 2 B S nh dh x 5 bytes), so its bf16 route
runs them on the tensor cores (``mma.sync``); w v is split into a bf16 high
and low part, so C's update keeps about 16 bits of w v where one bf16
product would keep 8 (see the source's note).

``mlstm_chunk_scan_plain`` is the grouped loop the port ran before the
kernel (CHUNK_GROUP chunks a batch, the carry chunk by chunk): the path on
the CPU and under autograd. ``mlstm_carry_plain`` does what the kernel does,
chunk by chunk, in plain torch. ``mlstm_carry`` launches the kernel on a CUDA
tensor and runs ``mlstm_carry_plain`` on a CPU tensor; it never falls back
from one to the other. Each launch adds one to ``launches``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm import _check, _on_meta, _ptr

CHUNK = 256           # the reference's chunk length (and the kernel's tile rows)
CHUNK_GROUP = 32      # chunks a batch in mlstm_chunk_scan_plain
# bytes of temporaries one batch of mlstm_intra_terms may hold: its fp32
# (L x L) products per chunk and head (q k^T, the decay, A and their
# intermediates, about 20 bytes a pair) and its h_intra
INTRA_GROUP_BYTES = 1 << 30

launches = 0          # kernel launches since the last reset
meta_flops = 0        # FLOPs of the calls on meta tensors (the dry run)
_fns: dict = {}

# The kernel's block (csrc/mlstm_scan.cu): THREADS threads, ROWS rows of a
# chunk (one a thread), MMA_COLS columns of C and MMA_DT head-dim columns of
# q and k staged at a time on the mma route
THREADS, ROWS, MMA_COLS, MMA_DT = 256, 256, 32, 32
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbol and argument types (csrc/mlstm_scan.cu)
KERNEL = ("repro_mlstm_scan", [_VP] * 12 + [_I] * 5 + [_VP])


def _kernel():
    if KERNEL[0] not in _fns:
        from repro_torch.kernels import _build

        symbol, argtypes = KERNEL
        fn = getattr(_build.load("mlstm_scan"), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[symbol] = fn
    return _fns[KERNEL[0]]


def _chunks(s: int) -> tuple[int, int]:
    """(chunk length, number of chunks): the reference's L = min(CHUNK, S)."""
    n = min(CHUNK, s)
    return n, -(-s // n)


def _rows(x, r0, r1, pad):
    """x[:, r0:r1] with ``pad`` zero rows after it (the reference's zero pad)."""
    x = x[:, r0:r1]
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _chunk_terms(qc, kc, vc, ic, lfc, mask):
    """The reference's carry-free terms of a batch of chunks (B, G, L, ...):
    (cl, the within-chunk cumulative log forget gate (B,G,L,NH); A, the
    decayed and gated q k^T (B,G,NH,L,L) fp32; h_intra (B,G,L,NH,dh) in q's
    dtype)."""
    cl = torch.cumsum(lfc, dim=2)                  # (B,G,L,NH) log cumulative decay
    qk = torch.einsum("bglhd,bgmhd->bghlm", qc, kc).float()
    clt = cl.transpose(2, 3)                       # (B,G,NH,L)
    # above the diagonal the decay may overflow to inf; the mask picks
    # zero there (a multiply by the mask would make inf * 0 = nan)
    decay = torch.exp(clt[..., :, None] - clt[..., None, :])
    A = qk * decay * ic.transpose(2, 3)[..., None, :].float()
    A = torch.where(mask, A, 0.0)
    return cl, A, torch.einsum("bghlm,bgmhd->bglhd", A.to(qc.dtype), vc)


def mlstm_chunk_scan_plain(q, k, v, i, logf, C0, n0):
    """Chunkwise mLSTM. q,k,v: (B,S,NH,dh); i,logf: (B,S,NH) fp32.
    C0: (B,NH,dh,dh), n0: (B,NH,dh) fp32. Returns (h (B,S,NH,dh), C, n).
    The last chunk is zero-padded to CHUNK positions, as in the reference.

    The reference's loop over chunks computes, per chunk, the intra-chunk
    attention, the inter-chunk read of the carried (C, n) and the chunk's
    contribution to (C, n). Only the carry is sequential, so the chunks run
    CHUNK_GROUP at a time: each group's intra-chunk terms and contributions
    as batched ops, then the carry through the group chunk by chunk (a
    multiply and an add for each of C and n), then the group's inter-chunk
    reads against the carries entering its chunks, batched. Every value is
    the reference's formula for its chunk."""
    b, s, nh, dh = q.shape
    dt = q.dtype
    L, nc = _chunks(s)
    pad = nc * L - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        i, logf = (F.pad(x, (0, 0, 0, pad)) for x in (i, logf))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n = C0, n0
    hs = []
    for g0 in range(0, nc, CHUNK_GROUP):
        g = min(CHUNK_GROUP, nc - g0)
        sl = slice(g0 * L, (g0 + g) * L)
        qc, kc, vc = (x[:, sl].reshape(b, g, L, nh, dh) for x in (q, k, v))
        ic, lfc = (x[:, sl].reshape(b, g, L, nh) for x in (i, logf))
        cl, A, h_intra = _chunk_terms(qc, kc, vc, ic, lfc, mask)
        d_intra = A.sum(-1).transpose(2, 3)                        # (B,G,L,NH)
        ecl = torch.exp(cl)                                        # (B,G,L,NH)
        e_end = torch.exp(cl[:, :, -1])                            # (B,G,NH)
        w_end = torch.exp(cl[:, :, -1:] - cl) * ic.float()
        dC = torch.einsum("bglh,bglhd,bglhe->bghde", w_end, kc.float(), vc.float())
        dn = torch.einsum("bglh,bglhd->bghd", w_end, kc.float())
        Cs, ns = [], []                                # the carry entering each chunk
        for j in range(g):
            Cs.append(C)
            ns.append(n)
            C = e_end[:, j, :, None, None] * C + dC[:, j]
            n = e_end[:, j, :, None] * n + dn[:, j]
        h_inter = torch.einsum("bglhd,bghde->bglhe", qc, torch.stack(Cs, 1).to(dt)) * \
            ecl[..., None].to(dt)
        d_inter = torch.einsum("bglhd,bghd->bglh", qc.float(), torch.stack(ns, 1)) * ecl
        denom = torch.clamp_min(torch.abs(d_intra + d_inter), 1.0)
        h = (h_intra.float() + h_inter.float()) / denom[..., None]
        hs.append(h.to(dt).reshape(b, g * L, nh, dh))
    h = torch.cat(hs, dim=1)
    return h[:, :s], C, n


def intra_group(b: int, nh: int, dh: int, s: int) -> int:
    """Chunks a batch of ``mlstm_intra_terms``: as many as INTRA_GROUP_BYTES
    of temporaries allow (at least one)."""
    L, _ = _chunks(s)
    return max(1, INTRA_GROUP_BYTES // (b * nh * L * (20 * L + 4 * dh)))


def mlstm_intra_terms(q, k, v, i, logf, group=None):
    """The carry-free terms of every chunk, as the reference's ``body``
    computes them (``xlstm.py:82-91``): (cl (B,S,NH) fp32, the within-chunk
    cumulative log forget gate; h_intra (B,S,NH,dh) in q's dtype; d_intra
    (B,S,NH) fp32), over ``group`` chunks a batch (None: ``intra_group``).
    Each batch slices its rows and zero-pads only the ragged last chunk, so
    no padded copy of q, k, v is made."""
    b, s, nh, dh = q.shape
    dt = q.dtype
    L, nc = _chunks(s)
    group = group or intra_group(b, nh, dh, s)
    cl = q.new_empty((b, s, nh), dtype=torch.float32)
    h_intra = torch.empty_like(q)
    d_intra = q.new_empty((b, s, nh), dtype=torch.float32)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    for g0 in range(0, nc, group):
        g = min(group, nc - g0)
        r0, r1 = g0 * L, min((g0 + g) * L, s)
        pad = g * L - (r1 - r0)
        qc, kc, vc = (_rows(x, r0, r1, pad).reshape(b, g, L, nh, dh) for x in (q, k, v))
        ic, lfc = (_rows(x, r0, r1, pad).reshape(b, g, L, nh) for x in (i, logf))
        clg, A, hi = _chunk_terms(qc, kc, vc, ic, lfc, mask)
        n = r1 - r0
        cl[:, r0:r1] = clg.reshape(b, g * L, nh)[:, :n]
        h_intra[:, r0:r1] = hi.reshape(b, g * L, nh, dh)[:, :n]
        d_intra[:, r0:r1] = A.sum(-1).transpose(2, 3).reshape(b, g * L, nh)[:, :n]
    return cl, h_intra, d_intra


def mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0):
    """What the kernel does, chunk by chunk in plain torch: the inter-chunk
    read of (C, n), the combine with the intra terms, and the update of C
    and n (``dC = k^T (w v)``, the kernel's association). Rows past S count
    as the reference's zero pad. Returns (h (B,S,NH,dh) in q's dtype, C, n
    fp32; fp64 for fp64 inputs, the card's reference for the fp32 route)."""
    b, s, nh, dh = q.shape
    dt, acc = q.dtype, torch.promote_types(q.dtype, torch.float32)
    L, nc = _chunks(s)
    h = torch.empty_like(q)
    C = q.new_zeros((b, nh, dh, dh), dtype=acc) if C0 is None else C0
    n = q.new_zeros((b, nh, dh), dtype=acc) if n0 is None else n0
    for j in range(nc):
        r = slice(j * L, min((j + 1) * L, s))
        qj, kj, vj = q[:, r], k[:, r], v[:, r]
        clj = cl[:, r]
        ecl = torch.exp(clj)                                       # (B,l,NH)
        e_end = torch.exp(clj[:, -1])                              # (B,NH)
        w = torch.exp(clj[:, -1:] - clj) * i[:, r]
        h_inter = torch.einsum("blhd,bhde->blhe", qj, C.to(dt)) * ecl[..., None].to(dt)
        d_inter = torch.einsum("blhd,bhd->blh", qj.to(acc), n) * ecl
        denom = torch.clamp_min(torch.abs(d_intra[:, r] + d_inter), 1.0)
        h[:, r] = ((h_intra[:, r].to(acc) + h_inter.to(acc)) / denom[..., None]).to(dt)
        kf = kj.to(acc)
        C = e_end[..., None, None] * C + torch.einsum("blhd,blhe->bhde", kf,
                                                      w[..., None] * vj.to(acc))
        n = e_end[..., None] * n + torch.einsum("blh,blhd->bhd", w, kf)
    return h, C, n


def carry_flops(b: int, s: int, nh: int, dh: int) -> int:
    """The carried products' FLOPs, what ``torch.utils.flop_counter`` counts
    for them in ``mlstm_chunk_scan_plain`` over the padded chunks (Sp rows):
    h_inter and dC, 2 B Sp nh dh^2 each; d_inter and dn, 2 B Sp nh dh each."""
    L, nc = _chunks(s)
    return 4 * b * nc * L * nh * dh * (dh + 1) if s else 0


def route(elem: int, dh: int) -> str:
    """"mma" (tensor cores) for bf16 (``elem`` 2 bytes) at a head dim that
    is a multiple of 32, "simt" otherwise."""
    return "mma" if elem == 2 and dh % 32 == 0 else "simt"


def _a16(n):
    return (n + 15) // 16 * 16


def smem_bytes(dh: int, elem: int, mma: bool) -> int:
    """Shared-memory bytes of one block (``layout`` in the source): C^T's
    columns of the block (fp32, rows padded), n, a staged slice of q and of
    k, w v (bf16 high and low parts, or fp32), exp(cl), w and d_intra of
    the chunk's rows, and the n update's partial sums."""
    e = cols(dh)
    dt = MMA_DT if mma else min(e, 16)
    cs = dh + (8 if mma else 4)
    qs = dt + (8 if mma else (2 if elem == 2 else 1))
    wv = 2 * _a16(2 * ROWS * (e + 8)) if mma else _a16(4 * ROWS * e)
    return (_a16(4 * e * cs) + _a16(4 * dh) + 2 * _a16(elem * ROWS * qs) + wv
            + 3 * _a16(4 * ROWS) + _a16(4 * THREADS))


def cols(dh: int) -> int:
    """Columns of C a block holds: 32, or the whole head dim of 8 or 16."""
    return min(dh, 32)


def plan(b: int, nh: int, dh: int, elem: int) -> tuple[int, int, int]:
    """(columns of C a block, blocks, shared bytes a block). The blocks own
    disjoint columns and need not be resident together, so the grid may
    take several waves. Raises where the kernel cannot take the shape."""
    if dh not in (8, 16) and dh % 32:
        raise ValueError(f"mlstm_carry: head dim {dh} must be 8, 16 or a multiple of 32")
    smem = smem_bytes(dh, elem, route(elem, dh) == "mma")
    if smem > SMEM_LIMIT:
        raise ValueError(f"mlstm_carry: {smem} bytes of shared memory a block at head dim "
                         f"{dh} exceed {SMEM_LIMIT}")
    e = cols(dh)
    return e, b * nh * (dh // e), smem


def mlstm_carry(q, k, v, i, cl, h_intra, d_intra, C0, n0):
    """q, k, v, h_intra (B,S,NH,dh) in bf16 or fp32; i, cl, d_intra (B,S,NH),
    C0 (B,NH,dh,dh) and n0 (B,NH,dh) fp32, C0 and n0 each or None (zeros) ->
    (h (B,S,NH,dh), C, n fp32): the loop over all chunks in one launch.

    CUDA tensors go to the kernel, CPU tensors to ``mlstm_carry_plain``;
    meta tensors (the dry run) get empty outputs and the carried products'
    FLOPs in ``meta_flops`` (``carry_flops``); tensors elsewhere raise."""
    global launches, meta_flops
    if q.device.type == "cpu":
        return mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0)
    b, s, nh, dh = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    h = torch.empty_like(q)
    C = q.new_empty((b, nh, dh, dh), dtype=torch.float32)
    n = q.new_empty((b, nh, dh), dtype=torch.float32)
    named = {"q": q, "k": k, "v": v, "h_intra": h_intra, "i": i, "cl": cl,
             "d_intra": d_intra, "C0": C0, "n0": n0}
    if _on_meta(*named.values()):
        meta_flops += carry_flops(b, s, nh, dh)
        return h, C, n
    _check(named, q.dtype, ("i", "cl", "d_intra", "C0", "n0"), "mlstm_carry")
    want = {"k": (b, s, nh, dh), "v": (b, s, nh, dh), "h_intra": (b, s, nh, dh),
            "i": (b, s, nh), "cl": (b, s, nh), "d_intra": (b, s, nh),
            "C0": (b, nh, dh, dh), "n0": (b, nh, dh)}
    if q.dim() != 4 or any(named[x] is not None and tuple(named[x].shape) != shape
                           for x, shape in want.items()):
        raise ValueError("mlstm_carry: bad shapes " + ", ".join(
            f"{x} {tuple(t.shape)}" for x, t in named.items() if t is not None))
    if s == 0 or b == 0:
        return (h, C.copy_(C0) if C0 is not None else C.zero_(),
                n.copy_(n0) if n0 is not None else n.zero_())
    plan(b, nh, dh, q.element_size())
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(), cl.data_ptr(),
                 h_intra.data_ptr(), d_intra.data_ptr(), _ptr(C0), _ptr(n0), h.data_ptr(),
                 C.data_ptr(), n.data_ptr(), b, s, nh, dh, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_carry kernel launch failed: cudaError {err}")
    launches += 1
    return h, C, n
