"""The mLSTM's chunk recurrence: the CUDA kernels' wrappers and their plain versions.

Replaces no Pallas kernel: the reference runs the mLSTM's chunkwise form as
one ``jax.lax.scan`` over chunks of CHUNK positions
(``repro/models/xlstm.py:108``, body ``_mlstm_chunk_scan`` at :80-106), which
XLA compiles into one loop on the device, and differentiates it by XLA's
transpose of that loop. Per chunk j, with cl the within-chunk cumulative log
forget gate:

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
product would keep 8 (see the source's note); there a producer warp brings
q and k by TMA through a ring of mbarrier stages. With ``save`` it also writes
the nc - 1 states (C, n) between chunks, what the backward reads.

The backward (``mlstm_backward``), given dh and the cotangents dC, dn of the
last state, with g_l = exp(cl_l) dh_l / den_l, den_l = max(|s_l|, 1), s_l =
d_intra_l + d_inter_l, and u_l = ds_l exp(cl_l), ds_l = -(dh_l . h_l) /
den_l sign(s_l) [|s_l| > 1]:

    T_j      = k_j dC_j                           carried: one launch of
    dC_{j-1} = exp(cl_end) dC_j + q_j^T g_j       csrc/mlstm_scan_bwd.cu
    dn_{j-1} = exp(cl_end) dn_j + q_j^T u_j

(``mlstm_carry_bwd``: the forward's design turned round, backward over the
chunks, each slice of dC read by k into T, dv's carried term, before q and
g update it; the update for j = nc - 1 down to 1, and 0 only where dC0 and
dn0 are asked; the read where dC_j is not zero: j = nc - 2 down to 0, and
nc - 1 where dC is given). Its bf16 route runs both products on the tensor
cores with g and each slice of dC split into bf16 high and low parts, about
16 bits of the fp32 operand. Then, carry-free once the states between
chunks, their cotangents and T are known, batched torch over groups of
chunks: dq, dk, the rest of dv, the gates' gradients, and the intra terms'
backward by hand from the forward's q k^T (``_grad_terms``). The edges are
the caller's: C0, n0 before the first chunk and dC, dn after the last, each
None where it is zeros (training passes no state), and then the products
with it are not run.

``mlstm_carry_plain`` and ``mlstm_carry_bwd_plain`` do what the kernels do,
chunk by chunk in plain torch (a ragged last chunk zero-padded, as the
kernels run it). The wrappers launch the kernels on a CUDA tensor and run
the plain versions on a CPU tensor; they never fall back from one to the
other. Each launch adds one to ``launches`` (the forward) or
``launches_bwd``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._ffi import _check, _on_meta, _ptr

CHUNK = 256           # the reference's chunk length (and the kernels' tile rows)
# bytes of temporaries one batch of mlstm_intra_terms may hold: its fp32
# (L x L) products per chunk and head (q k^T, the decay, A and their
# intermediates, about 20 bytes a pair) and its h_intra; the backward's
# batch holds about twice as many (L x L) terms and eight (L x dh) ones
INTRA_GROUP_BYTES = 1 << 30

launches = 0          # forward kernel launches since the last reset
launches_bwd = 0      # backward kernel launches since the last reset
meta_flops = 0        # FLOPs of the calls on meta tensors (the dry run)
_fns: dict = {}

# The kernels' block (csrc/mlstm.cuh): THREADS threads, ROWS rows of a
# chunk (one a thread), MMA_COLS columns of the state and MMA_DT head-dim
# columns of q and k staged at a time on the mma route
THREADS, ROWS, MMA_COLS, MMA_DT = 256, 256, 32, 32
# The mma routes (csrc/mlstm_scan.cu, csrc/mlstm_scan_bwd.cu): the ring's
# stages of q and k and the row stride (bf16) of the tiles of C's (dC's)
# slices
NST, CBS = 2, MMA_DT + 8
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbols and argument types: the forward (csrc/mlstm_scan.cu) and the
# backward (csrc/mlstm_scan_bwd.cu), each named after its source
KERNEL = ("repro_mlstm_scan", [_VP] * 14 + [_I] * 5 + [_VP])
KERNEL_BWD = ("repro_mlstm_scan_bwd", [_VP] * 12 + [_I] * 5 + [_VP])


def _kernel(which=KERNEL):
    if which[0] not in _fns:
        from repro_torch.kernels import _build

        symbol, argtypes = which
        fn = getattr(_build.load(symbol.removeprefix("repro_")), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[symbol] = fn
    return _fns[which[0]]


def _chunks(s: int) -> tuple[int, int]:
    """(chunk length, number of chunks): the reference's L = min(CHUNK, S)."""
    n = min(CHUNK, s)
    return n, -(-s // n)


def _acc(dt):
    """The sums' dtype: fp32, or fp64 for fp64 activations (the gradient
    checks)."""
    return torch.promote_types(dt, torch.float32)


def _rows(x, r0, r1, pad):
    """x[:, r0:r1] with ``pad`` zero rows after it (the reference's zero pad)."""
    x = x[:, r0:r1]
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _group_rows(g0, g, L, s):
    """(first row, end row, zero rows after them) of chunks g0 .. g0+g-1."""
    r0, r1 = g0 * L, min((g0 + g) * L, s)
    return r0, r1, g * L - (r1 - r0)


def _chunk_terms(qc, kc, vc, ic, lfc, mask):
    """The reference's carry-free terms of a batch of chunks (B, G, L, ...):
    (cl, the within-chunk cumulative log forget gate (B,G,L,NH); qk, q k^T
    (B,G,NH,L,L) in q's dtype; A, the decayed and gated q k^T (B,G,NH,L,L)
    fp32 (fp64 for fp64 inputs); h_intra (B,G,L,NH,dh) in q's dtype)."""
    acc = _acc(qc.dtype)
    cl = torch.cumsum(lfc, dim=2)                  # (B,G,L,NH) log cumulative decay
    qk = torch.einsum("bglhd,bgmhd->bghlm", qc, kc)
    clt = cl.transpose(2, 3)                       # (B,G,NH,L)
    # above the diagonal the decay may overflow to inf; the mask picks
    # zero there (a multiply by the mask would make inf * 0 = nan)
    decay = torch.exp(clt[..., :, None] - clt[..., None, :])
    A = qk.to(acc) * decay * ic.transpose(2, 3)[..., None, :].to(acc)
    A = torch.where(mask, A, 0.0)
    return cl, qk, A, torch.einsum("bghlm,bgmhd->bglhd", A.to(qc.dtype), vc)


def intra_group(b: int, nh: int, dh: int, s: int) -> int:
    """Chunks a batch of ``mlstm_intra_terms``: as many as INTRA_GROUP_BYTES
    of temporaries allow (at least one)."""
    L, _ = _chunks(s)
    return max(1, INTRA_GROUP_BYTES // (b * nh * L * (20 * L + 4 * dh)))


def bwd_group(b: int, nh: int, dh: int, s: int) -> int:
    """Chunks a batch of the backward's torch terms (at least one)."""
    L, _ = _chunks(s)
    return max(1, INTRA_GROUP_BYTES // (b * nh * L * (40 * L + 40 * dh)))


def mlstm_intra_terms(q, k, v, i, logf, group=None, keep_qk=False):
    """The carry-free terms of every chunk, as the reference's ``body``
    computes them (``xlstm.py:82-91``): (cl (B,S,NH) fp32, the within-chunk
    cumulative log forget gate; h_intra (B,S,NH,dh) in q's dtype; d_intra
    (B,S,NH) fp32), and with ``keep_qk`` q k^T of every chunk (B,nc,NH,L,L)
    in q's dtype, for the backward; over ``group`` chunks a batch (None:
    ``intra_group``). Each batch slices its rows and zero-pads only the
    ragged last chunk, so no padded copy of q, k, v is made."""
    b, s, nh, dh = q.shape
    L, nc = _chunks(s)
    group = group or intra_group(b, nh, dh, s)
    cl = logf.new_empty((b, s, nh))
    h_intra = torch.empty_like(q)
    d_intra = q.new_empty((b, s, nh), dtype=_acc(q.dtype))
    qk = q.new_empty((b, nc, nh, L, L)) if keep_qk else None
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    for g0 in range(0, nc, group):
        g = min(group, nc - g0)
        r0, r1, pad = _group_rows(g0, g, L, s)
        qc, kc, vc = (_rows(x, r0, r1, pad).reshape(b, g, L, nh, dh) for x in (q, k, v))
        ic, lfc = (_rows(x, r0, r1, pad).reshape(b, g, L, nh) for x in (i, logf))
        clg, qkg, A, hi = _chunk_terms(qc, kc, vc, ic, lfc, mask)
        n = r1 - r0
        cl[:, r0:r1] = clg.reshape(b, g * L, nh)[:, :n]
        h_intra[:, r0:r1] = hi.reshape(b, g * L, nh, dh)[:, :n]
        d_intra[:, r0:r1] = A.sum(-1).transpose(2, 3).reshape(b, g * L, nh)[:, :n]
        if keep_qk:
            qk[:, g0:g0 + g] = qkg
    return (cl, h_intra, d_intra, qk) if keep_qk else (cl, h_intra, d_intra)


def _padded_chunk(L, lv, *xs):
    """The rows of a chunk zero-padded to L (as the kernels run a ragged
    last chunk)."""
    return [_rows(x, 0, lv, L - lv) for x in xs]


def mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0, save=False):
    """What the kernel does, chunk by chunk in plain torch: the inter-chunk
    read of (C, n), the combine with the intra terms, and the update of C
    and n (``dC = k^T (w v)``, the kernel's association). A ragged last
    chunk is zero-padded to L rows (the reference's pad). Returns (h
    (B,S,NH,dh) in q's dtype, C, n fp32; fp64 for fp64 inputs, the card's
    reference for the fp32 route), and with ``save`` also C and n between
    chunks, as they enter chunks 1 .. nc - 1: (B,nc-1,NH,dh,dh) and
    (B,nc-1,NH,dh)."""
    b, s, nh, dh = q.shape
    dt, acc = q.dtype, _acc(q.dtype)
    L, nc = _chunks(s)
    h = torch.empty_like(q)
    C = q.new_zeros((b, nh, dh, dh), dtype=acc) if C0 is None else C0
    n = q.new_zeros((b, nh, dh), dtype=acc) if n0 is None else n0
    Cs, ns = [], []
    for j in range(nc):
        r = slice(j * L, min((j + 1) * L, s))
        lv = r.stop - r.start
        clj = cl[:, r]
        e_end = torch.exp(clj[:, -1])                              # (B,NH)
        w = torch.exp(clj[:, -1:] - clj) * i[:, r]
        qj, kj, vj, w, clj, hij, dij = _padded_chunk(L, lv, q[:, r], k[:, r], v[:, r], w, clj,
                                                     h_intra[:, r], d_intra[:, r])
        if save and j:
            Cs.append(C)
            ns.append(n)
        ecl = torch.exp(clj)                                       # (B,L,NH)
        h_inter = torch.einsum("blhd,bhde->blhe", qj, C.to(dt)) * ecl[..., None].to(dt)
        d_inter = torch.einsum("blhd,bhd->blh", qj.to(acc), n) * ecl
        denom = torch.clamp_min(torch.abs(dij + d_inter), 1.0)
        h[:, r] = ((hij.to(acc) + h_inter.to(acc)) / denom[..., None]).to(dt)[:, :lv]
        kf = kj.to(acc)
        C = e_end[..., None, None] * C + torch.einsum("blhd,blhe->bhde", kf,
                                                      w[..., None] * vj.to(acc))
        n = e_end[..., None] * n + torch.einsum("blh,blhd->bhd", w, kf)
    if not save:
        return h, C, n
    empty = (q.new_empty((b, 0, nh, dh, dh), dtype=acc), q.new_empty((b, 0, nh, dh), dtype=acc))
    saved = (torch.stack(Cs, 1), torch.stack(ns, 1)) if Cs else empty
    return h, C, n, *saved


def carry_flops(b: int, s: int, nh: int, dh: int) -> int:
    """The carried products' FLOPs, what ``torch.utils.flop_counter`` counts
    for them in ``mlstm_carry_plain`` over the padded chunks (Sp rows): h_inter
    and dC, 2 B Sp nh dh^2 each; d_inter and dn, 2 B Sp nh dh each."""
    L, nc = _chunks(s)
    return 4 * b * nc * L * nh * dh * (dh + 1) if s else 0


def carry_bwd_flops(b: int, s: int, nh: int, dh: int, need_state: bool,
                    read_last: bool = False) -> int:
    """The carried products of the backward, what ``flop_counter`` counts in
    ``mlstm_carry_bwd_plain`` over the padded chunks (L rows each): q^T g, 2
    B L nh dh^2, and q^T u, 2 B L nh dh, for each chunk whose update runs
    (all but the first, and the first too where ``need_state``), and k dC, 2
    B L nh dh^2, for each chunk read (all but the last, and the last too
    where ``read_last``: a dC on the last state is given)."""
    L, nc = _chunks(s) if s else (0, 0)
    return 2 * b * L * nh * dh * (max(nc - 1 + need_state, 0) * (dh + 1)
                                  + max(nc - 1 + read_last, 0) * dh)


def route(elem: int, dh: int) -> str:
    """"mma" (tensor cores) for bf16 (``elem`` 2 bytes) at a head dim that
    is a multiple of 32, "simt" otherwise."""
    return "mma" if elem == 2 and dh % 32 == 0 else "simt"


def _a16(n):
    return (n + 15) // 16 * 16


def smem_bytes(dh: int, elem: int, mma: bool) -> int:
    """Shared-memory bytes of one forward block (``layout`` and
    ``mma_layout`` in the source). The mma route: the ring's NST stages of a
    slice of q and of k, v's tile of the chunk, C^T's columns of the block
    (fp32, rows padded), n, two bf16 tiles of C's slices, exp(cl), w and
    d_intra of the chunk's rows, two buffers of the n update's partial sums
    (4 a row of the slice), the mbarriers, and 1024 bytes to align the
    base. The SIMT route: C^T, n, a staged slice of q and of k, w v (fp32),
    the three vectors and the partial sums."""
    e = cols(dh)
    vec = 3 * _a16(4 * ROWS)
    if mma:
        return (NST * 2 * 2 * ROWS * MMA_DT + 2 * ROWS * e + _a16(4 * e * (dh + 4))
                + _a16(4 * dh) + 2 * _a16(2 * e * CBS) + vec + 2 * _a16(4 * 4 * MMA_DT)
                + _a16(8 * (2 * NST + 2)) + 1024)
    dt = min(e, 16)
    qs = dt + (2 if elem == 2 else 1)
    return (_a16(4 * e * (dh + 4)) + _a16(4 * dh) + 2 * _a16(elem * ROWS * qs)
            + _a16(4 * ROWS * e) + vec + _a16(4 * THREADS))


def smem_bytes_bwd(dh: int, elem: int, mma: bool) -> int:
    """Shared-memory bytes of one backward block (``mma_layout`` and
    ``layout`` in ``csrc/mlstm_scan_bwd.cu``). The mma route: the ring's NST
    stages of a slice of q and of k, dC^T's columns (fp32, rows padded), dn,
    four bf16 tiles (the high and low parts of two slices of dC), u of the
    chunk's rows, two buffers of dn's partial sums, the mbarriers, and 1024
    bytes to align the base; g's fragments stay in registers, no tile of g.
    The SIMT route: dC^T, dn, a staged slice of q and of k, g's columns of
    the chunk's rows (fp32), u and the partial sums."""
    e = cols(dh)
    if mma:
        return (NST * 2 * 2 * ROWS * MMA_DT + _a16(4 * e * (dh + 4)) + _a16(4 * dh)
                + 4 * _a16(2 * e * CBS) + _a16(4 * ROWS) + 2 * _a16(4 * 4 * MMA_DT)
                + _a16(8 * 2 * NST) + 1024)
    dt = min(e, 16)
    qs = dt + (2 if elem == 2 else 1)
    return (_a16(4 * e * (dh + 4)) + _a16(4 * dh) + 2 * _a16(elem * ROWS * qs)
            + _a16(4 * ROWS * e) + _a16(4 * ROWS) + _a16(4 * THREADS))


def cols(dh: int) -> int:
    """Columns of the state a block holds: 32, or the whole head dim of 8 or 16."""
    return min(dh, 32)


def plan(b: int, nh: int, dh: int, elem: int, *, smem_fn=smem_bytes,
         what="mlstm_carry") -> tuple[int, int, int]:
    """(columns of the state a block, blocks, shared bytes a block);
    ``smem_fn`` is the forward's ``smem_bytes`` or the backward's
    ``smem_bytes_bwd``. The blocks own disjoint columns and need not be
    resident together, so the grid may take several waves (at xlstm-1.3b's
    dh 1024 a block an SM: one wave of 128 blocks at batch 1 on an H100's
    132 SMs, four at batch 4). Raises where the kernel cannot take the
    shape."""
    if dh not in (8, 16) and dh % 32:
        raise ValueError(f"{what}: head dim {dh} must be 8, 16 or a multiple of 32")
    smem = smem_fn(dh, elem, route(elem, dh) == "mma")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block at head dim "
                         f"{dh} exceed {SMEM_LIMIT}")
    e = cols(dh)
    return e, b * nh * (dh // e), smem


def plan_bwd(b: int, nh: int, dh: int, elem: int) -> tuple[int, int, int]:
    """``plan`` of the backward kernel: the forward's grid, its own shared
    memory."""
    return plan(b, nh, dh, elem, smem_fn=smem_bytes_bwd, what="mlstm_carry_bwd")


def _bad_shapes(what, named, want):
    if any(named[x] is not None and tuple(named[x].shape) != shape
           for x, shape in want.items()):
        raise ValueError(f"{what}: bad shapes " + ", ".join(
            f"{x} {tuple(t.shape)}" for x, t in named.items() if t is not None))


def mlstm_carry(q, k, v, i, cl, h_intra, d_intra, C0, n0, save=False):
    """q, k, v, h_intra (B,S,NH,dh) in bf16 or fp32; i, cl, d_intra (B,S,NH),
    C0 (B,NH,dh,dh) and n0 (B,NH,dh) fp32, C0 and n0 each or None (zeros) ->
    (h (B,S,NH,dh), C, n fp32): the loop over all chunks in one launch; with
    ``save`` also C and n between chunks, as they enter chunks 1 .. nc - 1,
    (B,nc-1,NH,dh,dh) and (B,nc-1,NH,dh) fp32 (the kernel's SAVE build: h, C
    and n keep their bits).

    CUDA tensors go to the kernel, CPU tensors to ``mlstm_carry_plain``;
    meta tensors (the dry run) get empty outputs and the carried products'
    FLOPs in ``meta_flops`` (``carry_flops``); tensors elsewhere raise."""
    global launches, meta_flops
    if q.device.type == "cpu":
        return mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0, save=save)
    b, s, nh, dh = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    nc = _chunks(s)[1] if s else 0
    h = torch.empty_like(q)
    C = q.new_empty((b, nh, dh, dh), dtype=torch.float32)
    n = q.new_empty((b, nh, dh), dtype=torch.float32)
    saved = ((q.new_empty((b, max(nc - 1, 0), nh, dh, dh), dtype=torch.float32),
              q.new_empty((b, max(nc - 1, 0), nh, dh), dtype=torch.float32)) if save else ())
    named = {"q": q, "k": k, "v": v, "h_intra": h_intra, "i": i, "cl": cl,
             "d_intra": d_intra, "C0": C0, "n0": n0}
    if _on_meta(*named.values()):
        meta_flops += carry_flops(b, s, nh, dh)
        return h, C, n, *saved
    _check(named, q.dtype, ("i", "cl", "d_intra", "C0", "n0"), "mlstm_carry")
    if q.dim() != 4:
        raise ValueError(f"mlstm_carry: bad shapes q {tuple(q.shape)}")
    _bad_shapes("mlstm_carry", named, {
        "k": (b, s, nh, dh), "v": (b, s, nh, dh), "h_intra": (b, s, nh, dh),
        "i": (b, s, nh), "cl": (b, s, nh), "d_intra": (b, s, nh), "C0": (b, nh, dh, dh),
        "n0": (b, nh, dh)})
    if s == 0 or b == 0:
        return (h, C.copy_(C0) if C0 is not None else C.zero_(),
                n.copy_(n0) if n0 is not None else n.zero_(), *saved)
    plan(b, nh, dh, q.element_size())
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(), cl.data_ptr(),
                 h_intra.data_ptr(), d_intra.data_ptr(), _ptr(C0), _ptr(n0), h.data_ptr(),
                 C.data_ptr(), n.data_ptr(), *(_ptr(x) for x in saved or (None, None)),
                 b, s, nh, dh, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_carry kernel launch failed: cudaError {err}")
    launches += 1
    return h, C, n, *saved


def _rows_read(s: int, dC_n) -> int:
    """R, the rows of the chunks whose read runs (``mlstm_carry_bwd``): all
    but the last, and the last too where ``dC_n`` is given: a prefix of the
    sequence."""
    if not s:
        return 0
    L, nc = _chunks(s)
    return min((nc - 1 + (dC_n is not None)) * L, s)


def mlstm_carry_bwd_plain(q, k, g, u, cl, dC_n=None, dn_n=None, need_state=False):
    """What the backward kernel does, chunk by chunk from the last in plain
    torch: q, k (B,S,NH,dh), g (B,S,NH,dh), u and cl (B,S,NH), dC_n
    (B,NH,dh,dh) and dn_n (B,NH,dh) or None (zeros) -> (dCs (B,nc-1,NH,dh,dh),
    dns (B,nc-1,NH,dh): the cotangents of C and n between chunks, as they
    leave chunks 0 .. nc - 2; dC0, dn0, or None where not ``need_state``:
    then chunk 0's update is not run; T (B,R,NH,dh): T_j = k_j dC_j on the
    chunks whose leaving dC_j is not zero, R their rows (``_rows_read``: all
    chunks but the last, and the last where ``dC_n`` is given), each read
    before its chunk's update), fp32 (fp64 for fp64 inputs). A ragged last
    chunk is zero-padded to L rows, as the kernel runs it."""
    b, s, nh, dh = q.shape
    acc = _acc(q.dtype)
    L, nc = _chunks(s) if s else (0, 0)
    dC = q.new_zeros((b, nh, dh, dh), dtype=acc) if dC_n is None else dC_n.to(acc)
    dn = q.new_zeros((b, nh, dh), dtype=acc) if dn_n is None else dn_n.to(acc)
    dCs = q.new_empty((b, max(nc - 1, 0), nh, dh, dh), dtype=acc)
    dns = q.new_empty((b, max(nc - 1, 0), nh, dh), dtype=acc)
    R = _rows_read(s, dC_n)
    T = q.new_empty((b, R, nh, dh), dtype=acc)
    for j in range(nc - 1, -1, -1):
        r = slice(j * L, min((j + 1) * L, s))
        lv = r.stop - r.start
        if r.start < R:                                            # the read, before the update
            kj, = _padded_chunk(L, lv, k[:, r].to(acc))
            T[:, r] = torch.einsum("blhd,bhde->blhe", kj, dC)[:, :lv]
        if j or need_state:
            e_end = torch.exp(cl[:, r.stop - 1])                   # (B,NH)
            qj, gj, uj = _padded_chunk(L, lv, q[:, r].to(acc), g[:, r], u[:, r])
            dC = e_end[..., None, None] * dC + torch.einsum("blhd,blhe->bhde", qj, gj)
            dn = e_end[..., None] * dn + torch.einsum("blh,blhd->bhd", uj, qj)
            if j:
                dCs[:, j - 1], dns[:, j - 1] = dC, dn
    return (dCs, dns, dC, dn, T) if need_state else (dCs, dns, None, None, T)


def mlstm_carry_bwd(q, k, g, u, cl, dC_n=None, dn_n=None, need_state=False):
    """The backward kernel's wrapper: q, k (B,S,NH,dh) in bf16 or fp32; g
    (B,S,NH,dh), u, cl (B,S,NH), dC_n (B,NH,dh,dh), dn_n (B,NH,dh) fp32, the
    last two each or None (zeros) -> (dCs, dns, dC0, dn0, T) as
    ``mlstm_carry_bwd_plain``: every chunk in one launch (with one chunk, no
    ``dC_n`` and no ``need_state`` the launch has nothing to run).

    CUDA tensors go to the kernel, CPU tensors to ``mlstm_carry_bwd_plain``;
    meta tensors get empty outputs and ``carry_bwd_flops`` in
    ``meta_flops``; tensors elsewhere raise."""
    global launches_bwd, meta_flops
    if q.device.type == "cpu":
        return mlstm_carry_bwd_plain(q, k, g, u, cl, dC_n, dn_n, need_state)
    b, s, nh, dh = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    nc = _chunks(s)[1] if s else 0
    f32 = torch.float32
    dCs = q.new_empty((b, max(nc - 1, 0), nh, dh, dh), dtype=f32)
    dns = q.new_empty((b, max(nc - 1, 0), nh, dh), dtype=f32)
    dC0, dn0 = ((q.new_empty((b, nh, dh, dh), dtype=f32), q.new_empty((b, nh, dh), dtype=f32))
                if need_state else (None, None))
    T = q.new_empty((b, _rows_read(s, dC_n), nh, dh), dtype=f32)
    named = {"q": q, "k": k, "g": g, "u": u, "cl": cl, "dC_n": dC_n, "dn_n": dn_n}
    if _on_meta(*named.values()):
        meta_flops += carry_bwd_flops(b, s, nh, dh, need_state, dC_n is not None)
        return dCs, dns, dC0, dn0, T
    _check(named, q.dtype, ("g", "u", "cl", "dC_n", "dn_n"), "mlstm_carry_bwd")
    if q.dim() != 4:
        raise ValueError(f"mlstm_carry_bwd: bad shapes q {tuple(q.shape)}")
    _bad_shapes("mlstm_carry_bwd", named, {
        "k": (b, s, nh, dh), "g": (b, s, nh, dh), "u": (b, s, nh), "cl": (b, s, nh),
        "dC_n": (b, nh, dh, dh), "dn_n": (b, nh, dh)})
    if b == 0 or s == 0:                                # no chunk: dC0, dn0 are dC_n, dn_n
        for out, x in ((dC0, dC_n), (dn0, dn_n)):
            if out is not None:
                out.zero_() if x is None else out.copy_(x)
        return dCs, dns, dC0, dn0, T
    plan_bwd(b, nh, dh, q.element_size())
    fn = _kernel(KERNEL_BWD)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), g.data_ptr(), u.data_ptr(), cl.data_ptr(),
                 _ptr(dC_n), _ptr(dn_n), dCs.data_ptr(), dns.data_ptr(), _ptr(dC0), _ptr(dn0),
                 T.data_ptr(), b, s, nh, dh, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_carry_bwd kernel launch failed: cudaError {err}")
    launches_bwd += 1
    return dCs, dns, dC0, dn0, T


def entering_n(n0, ns):
    """n as it enters every chunk (B,nc,NH,dh): n0 (zeros where None), then
    the saving forward's nc - 1 states between chunks ``ns``."""
    b, _, nh, dh = ns.shape
    first = ns.new_zeros((b, 1, nh, dh)) if n0 is None else n0[:, None].to(ns.dtype)
    return torch.cat([first, ns], 1)


def _read_cotangents(q, logf, d_intra, ns, h, dh, group):
    """The backward's first pass, per group of chunks, with ``ns`` n as it
    enters every chunk (``entering_n``): with s = d_intra + (q . n_{j-1})
    exp(cl) and den = max(|s|, 1), g = exp(cl) dh / den and u = ds exp(cl)
    (the carry's inputs, fp32), and for the second pass r = dh / den in q's
    dtype (h_intra's and h_inter's cotangent), ds = -(dh . h) / den sign(s)
    [|s| > 1] and q . n_{j-1} (B,S,NH)."""
    b, s, nh, dh_ = q.shape
    acc = _acc(q.dtype)
    L, nc = _chunks(s)
    g = q.new_empty((b, s, nh, dh_), dtype=acc)
    r = torch.empty_like(q)
    u, ds, qn = (q.new_empty((b, s, nh), dtype=acc) for _ in range(3))
    for g0 in range(0, nc, group):
        gs = min(group, nc - g0)
        r0, r1, pad = _group_rows(g0, gs, L, s)
        qc, hc, dhc = (_rows(x, r0, r1, pad).reshape(b, gs, L, nh, dh_) for x in (q, h, dh))
        lfc, dic = (_rows(x, r0, r1, pad).reshape(b, gs, L, nh) for x in (logf, d_intra))
        ecl = torch.exp(torch.cumsum(lfc, dim=2))
        qnc = torch.einsum("bglhd,bghd->bglh", qc.to(acc), ns[:, g0:g0 + gs])
        sc = dic + qnc * ecl
        den = torch.clamp_min(torch.abs(sc), 1.0)
        dhf = dhc.to(acc)
        rc = dhf / den[..., None]
        dsc = -(dhf * hc.to(acc)).sum(-1) / den * torch.sign(sc) * (torch.abs(sc) > 1)
        n = r1 - r0
        for out, x in ((g, rc * ecl[..., None]), (r, rc), (u, dsc * ecl), (ds, dsc), (qn, qnc)):
            out[:, r0:r1] = x.reshape(b, gs * L, *x.shape[3:])[:, :n]
    return g, u, r, ds, qn


def _grad_terms(q, k, v, i, logf, qk, r, ds, qn, Cs, ns, dCs, dns, T, group):
    """The backward's carry-free terms, per group of chunks, from the states
    entering the chunks and the cotangents of those leaving them: ``ns``
    for every chunk, ``Cs`` for the last ``Cs.shape[1]`` chunks, ``dCs``
    and ``dns`` for the first ``dCs.shape[1]``, the products with the
    chunks' C or (dC, dn) left out elsewhere (zeros: no C0, no cotangent on
    the last state); ``T`` (k dC, from ``mlstm_carry_bwd``) on the rows of
    the first chunks, its product left out on the rest (a zero dC). Returns
    (dq, dk, dv in q's dtype, di, dlogf fp32). The intra terms' backward by
    hand from the forward's q k^T (``qk``: A = qk exp(cl_l - cl_m) i_m below
    the diagonal, h_intra = bf16(A) v, d_intra = A's row sums), the read's
    (h_inter = (q bf16(C)) exp(cl): dq = exp(cl) bf16(C) r; d_inter = (q .
    n) exp(cl)) and the update's (C_j = e_end C_{j-1} + k^T (w v), n_j =
    e_end n_{j-1} + k^T w: dv = w T), then dlogf as the
    reverse cumulative sum of dcl in each chunk."""
    b, s, nh, dh = q.shape
    dt, acc = q.dtype, _acc(q.dtype)
    L, nc = _chunks(s)
    c0, c1 = nc - Cs.shape[1], dCs.shape[1]      # chunks c0.. have a C entering, ..c1 a dC leaving
    cT = -(-T.shape[1] // L)                     # chunks ..cT have T
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, dlogf = (q.new_empty((b, s, nh), dtype=acc) for _ in range(2))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    for g0 in range(0, nc, group):
        gs = min(group, nc - g0)
        r0, r1, pad = _group_rows(g0, gs, L, s)
        sl = slice(g0, g0 + gs)
        a, e = min(max(c0 - g0, 0), gs), max(min(c1 - g0, gs), 0)   # the group's chunks a.., ..e
        eT = max(min(cT - g0, gs), 0)
        qc, kc, vc, rc = (_rows(x, r0, r1, pad).reshape(b, gs, L, nh, dh)
                          for x in (q, k, v, r))
        ic, lfc, dsc, qnc = (_rows(x, r0, r1, pad).reshape(b, gs, L, nh)
                             for x in (i, logf, ds, qn))
        Cj, nj = Cs[:, g0 + a - c0:g0 + gs - c0], ns[:, sl]
        dCj, dnj = dCs[:, g0:g0 + e], dns[:, g0:g0 + e]
        cl = torch.cumsum(lfc, dim=2)                              # (B,G,L,NH)
        clt, it = cl.transpose(2, 3), ic.transpose(2, 3).to(acc)   # (B,G,NH,L)
        decay = torch.where(mask, torch.exp(clt[..., :, None] - clt[..., None, :]), 0.0)
        qkf = qk[:, sl].to(acc)
        A = torch.where(mask, qkf * decay * it[..., None, :], 0.0)
        # the intra terms: h_intra = bf16(A) v, d_intra_l = sum_m A_lm
        dAb = torch.einsum("bglhe,bgmhe->bghlm", rc, vc)
        dvc = torch.einsum("bghlm,bglhe->bgmhe", A.to(dt), rc).to(acc)
        dA = torch.where(mask, dAb.to(acc) + dsc.transpose(2, 3)[..., :, None], 0.0)
        dqk = (dA * decay * it[..., None, :]).to(dt)
        dqc = torch.einsum("bghlm,bgmhd->bglhd", dqk, kc).to(acc)
        dkc = torch.einsum("bghlm,bglhd->bgmhd", dqk, qc).to(acc)
        GA = dA * A
        dcl = (GA.sum(-1) - GA.sum(-2)).transpose(2, 3)
        dic = (dA * qkf * decay).sum(-2).transpose(2, 3)
        # the read: h_inter = (q bf16(C)) exp(cl), d_inter = (q . n) exp(cl)
        ecl = torch.exp(cl)
        dqc = dqc + (dsc * ecl)[..., None] * nj[:, :, None]
        decl = dsc * qnc
        if a < gs:
            Y = torch.einsum("bglhe,bghde->bglhd", rc[:, a:], Cj.to(dt)).to(acc)
            dqc[:, a:] += ecl[:, a:, ..., None] * Y
            decl[:, a:] += (qc[:, a:].to(acc) * Y).sum(-1)
        dcl = dcl + decl * ecl
        # the update: C_j = e_end C_{j-1} + k^T (w v), n_j = e_end n_{j-1} + k^T w
        cl_end = cl[:, :, -1]                                      # (B,G,NH)
        wdec = torch.exp(cl_end[:, :, None] - cl)
        w = wdec * ic
        kf = kc.to(acc)
        dw, de_end = torch.zeros_like(w), torch.zeros_like(cl_end)
        if eT:
            rT = min(r0 + eT * L, T.shape[1])
            Tc = _rows(T, r0, rT, eT * L - (rT - r0)).reshape(b, eT, L, nh, dh)
            dvc[:, :eT] += w[:, :eT, ..., None] * Tc
        if e:
            U = torch.einsum("bglhe,bghde->bglhd", vc[:, :e].to(acc), dCj)
            dkc[:, :e] += w[:, :e, ..., None] * (U + dnj[:, :, None])
            dw[:, :e] = (torch.einsum("bglhd,bglhd->bglh", kf[:, :e], U)
                         + torch.einsum("bglhd,bghd->bglh", kf[:, :e], dnj))
            de_end[:, :e] = (dnj * nj[:, :e]).sum(-1)
            if a < e:
                de_end[:, a:e] += (dCj[:, a:] * Cj[:, :e - a]).sum((-1, -2))
        dic = dic + dw * wdec
        dcl = dcl - dw * w
        dcl[:, :, -1] += (dw * w).sum(2) + de_end * torch.exp(cl_end)
        dlf = torch.flip(torch.cumsum(torch.flip(dcl, [2]), 2), [2])
        n = r1 - r0
        for out, x in ((dq, dqc), (dk, dkc), (dv, dvc), (di, dic), (dlogf, dlf)):
            out[:, r0:r1] = x.reshape(b, gs * L, *x.shape[3:])[:, :n]
    return dq, dk, dv, di, dlogf


def mlstm_backward(q, k, v, i, logf, cl, d_intra, qk, C0, n0, Cs, ns, h, dh, dC=None, dn=None,
                   need_state=False):
    """The chunk scan's backward from what the saving forward keeps (q, k, v,
    i, logf; cl, d_intra and q k^T of every chunk from ``mlstm_intra_terms(
    ..., keep_qk=True)``; the first state C0, n0, each or None: zeros; the
    states between chunks and h from ``mlstm_carry(..., save=True)``), the
    cotangent dh of h and dC, dn of the last C and n (each or None: zeros)
    -> (dq, dk, dv, di, dlogf, dC0, dn0; the last two None where not
    ``need_state``): ``_read_cotangents``, the carry in one launch of
    ``mlstm_carry_bwd`` (which also gives T = k dC, dv's carried term), then
    ``_grad_terms``, ``bwd_group`` chunks a batch. A C0, or a dC or dn,
    given is joined to the states between chunks (a copy of them); left
    None, its products are left out."""
    b, s, nh, d = q.shape
    if dh is None:
        dh = torch.zeros_like(h)
    group = bwd_group(b, nh, d, s)
    ns = entering_n(n0, ns)
    g, u, r, ds, qn = _read_cotangents(q, logf, d_intra, ns, h, dh, group)
    dCs, dns, dC0, dn0, T = mlstm_carry_bwd(q, k, g, u, cl, dC, dn, need_state)
    del g, u
    if C0 is not None:
        Cs = torch.cat([C0[:, None].to(Cs.dtype), Cs], 1)
    if dC is not None or dn is not None:
        dCs = torch.cat([dCs, dCs.new_zeros((b, 1, nh, d, d)) if dC is None
                         else dC[:, None].to(dCs.dtype)], 1)
        dns = torch.cat([dns, dns.new_zeros((b, 1, nh, d)) if dn is None
                         else dn[:, None].to(dns.dtype)], 1)
    return (*_grad_terms(q, k, v, i, logf, qk, r, ds, qn, Cs, ns, dCs, dns, T, group), dC0,
            dn0)
