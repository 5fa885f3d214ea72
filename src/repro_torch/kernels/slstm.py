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
other. Each launch adds one to ``launches``. With ``save=True`` both also
return each step's gates g_t = gx_t + flat(gr_t) and c_t, what the
backward reads. The kernel's grid runs in thread-block clusters whose
blocks are all resident at once: ``plan`` picks the cluster size and the
channels a block from the residency the card reports for the kernel
(``repro_slstm_scan_clusters``), and a shape no such grid takes raises.

The backward has no TPU kernel either (the reference differentiates its
scan in XLA). ``slstm_scan_bwd`` runs it in reverse time in
``csrc/slstm_scan_bwd.cu`` (``repro_slstm_scan_bwd``) on a CUDA tensor and
``slstm_scan_bwd_plain``, a reverse step loop written out by hand, on a CPU
tensor; each launch adds one to ``launches_bwd``. ``plan_bwd`` picks its
route by shape and dtype: in bf16 the forward's design turned round
(thread-block clusters, dg exchanged by ``st.async`` within a cluster and
relayed across clusters from L2, the products on ``mma.sync``; the
residency from ``repro_slstm_scan_bwd_clusters``), in fp32 (and in bf16
where the clusters' shared memory does not fit) one cooperative grid of
tagged words and SIMT products. Per step, with the gate activations
recomputed from g_t as the forward rounded them:

    dh_t = dy_t + dh_rec_t
    dc_t = dc_{t+1} sigmoid(f_{t+1}) + dh_t so (1 - tanh^2 c_t)
    dg_t = (dc_t tz si(1-si), dc_t c_{t-1} sf(1-sf), dc_t si (1-tz^2),
            dh_t tanh(c_t) so(1-so))                  rounded to gx's dtype
    dh_rec_{t-1} = einsum("bhe,hde->bhd", dg_t, r_gates)     fp32 sums

``slstm_dr_gates`` is r_gates' gradient, one large product over all steps
(``torch.einsum``, as the reference leaves it to XLA). ``ops.slstm_scan``
joins the two directions in an autograd function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._ffi import _check, _on_meta, _ptr

launches = 0          # forward kernel launches since the last reset
launches_bwd = 0      # backward kernel launches since the last reset
meta_flops = 0        # FLOPs of the calls on meta tensors (the dry run)
_fns: dict = {}
_plans: dict = {}     # the plans by direction, shapes, dtype and card

# The kernels' block (csrc/slstm.cuh): THREADS threads, each keeping c
# for up to MAX_PAIRS (batch row, channel) pairs (CPAIRS in the backward's
# clusters).
THREADS, MAX_PAIRS, CPAIRS = 512, 4, 2
# The forward's (csrc/slstm_scan.cu): gx stages, bytes after each row of h,
# and the bf16 products' k-splits
NST, HPAD, KS = 8, 32, 4
# The backward's clusters (csrc/slstm_scan_bwd.cu): stages of g, dy and c,
# bytes after each row of dg, the products' k parts (partial sums an
# output), and floats a row of partial sums
NST_BWD, HPAD_BWD, KP, GS = 8, 32, 8, 36
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbols and argument types: the forward (csrc/slstm_scan.cu) and the
# backward (csrc/slstm_scan_bwd.cu), each named after its source, and the
# residency of each (in its source)
KERNEL = ("repro_slstm_scan", [_VP] * 10 + [_I] * 6 + [_VP])
CLUSTERS = ("repro_slstm_scan_clusters", [_I] * 6)    # the forward's residency
KERNEL_BWD = ("repro_slstm_scan_bwd", [_VP] * 11 + [_I] * 7 + [_VP])
CLUSTERS_BWD = ("repro_slstm_scan_bwd_clusters", [_I] * 6)   # the backward's


def _kernel(which=KERNEL):
    if which[0] not in _fns:
        from repro_torch.kernels import _build

        symbol, argtypes = which
        source = symbol.removeprefix("repro_").removesuffix("_clusters")
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[symbol] = fn
    return _fns[which[0]]


def _acc(dt):
    """c's dtype and the backward's: fp32, or fp64 for fp64 activations
    (the gradient checks)."""
    return torch.promote_types(dt, torch.float32)


def _gates(gx, h_prev, r_gates, nh, dh):
    """The first half of the reference's ``_slstm_cell``: g = gx + flat(gr)
    (B, 4D), gr the per-head product of h_prev (B, D) and r_gates, both in
    the activations' dtype."""
    b = gx.shape[0]
    gr = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, nh, dh), r_gates)
    return gx + gr.reshape(b, -1)


def _cell(g, c_prev):
    """Its second half, from g and c_prev (B, D) fp32: (h before its cast,
    c)."""
    i, f, z, o = torch.chunk(g, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(z)
    return torch.sigmoid(o) * torch.tanh(c), c


def slstm_scan_plain(gx, r_gates, h0=None, c0=None, save=False):
    """The cell over the S steps of gx (B, S, 4D) as a loop in plain
    PyTorch, from h0 (B, D) in gx's dtype and c0 (B, D) fp32 or zeros.
    Returns (h (B, S, D) in gx's dtype, the last h, the last c fp32), and
    with ``save`` also g (B, S, 4D) in gx's dtype and c (B, S, D) fp32."""
    dt, acc = gx.dtype, _acc(gx.dtype)
    b, s, d4 = gx.shape
    nh, dh = r_gates.shape[:2]
    h = gx.new_zeros((b, d4 // 4)) if h0 is None else h0
    c = gx.new_zeros((b, d4 // 4), dtype=acc) if c0 is None else c0
    hs, gs, cs = [], [], []
    for t in range(s):
        g = _gates(gx[:, t], h, r_gates, nh, dh)
        h2, c = _cell(g, c.to(acc))
        h = h2.to(dt)
        hs.append(h)
        if save:
            gs.append(g)
            cs.append(c)
    out = torch.stack(hs, dim=1) if hs else gx.new_empty((b, 0, d4 // 4))
    if not save:
        return out, h, c
    return (out, h, c, torch.stack(gs, dim=1) if gs else gx.new_empty((b, 0, d4)),
            torch.stack(cs, dim=1) if cs else gx.new_empty((b, 0, d4 // 4), dtype=acc))


def slstm_scan_bwd_plain(g, c, r_gates, dy, c0=None, dh_n=None, dc_n=None, need_dh0=True):
    """The backward as a reverse step loop in plain PyTorch (the arithmetic
    of ``repro_slstm_scan_bwd``, not autograd): g (B, S, 4D) and c (B, S, D)
    from the saving forward, c0 the forward's (or None: zeros), dy (B, S, D)
    the cotangent of h, dh_n and dc_n those of the last state (or None).
    Returns (dgx (B, S, 4D) in g's dtype, dh0 (B, D) in g's dtype or None
    where not ``need_dh0``, dc0 (B, D) fp32)."""
    dt, acc = g.dtype, _acc(g.dtype)
    b, s, d4 = g.shape
    d = d4 // 4
    nh, dh = r_gates.shape[:2]
    r = r_gates.to(acc)
    dgx = torch.empty_like(g)
    dhr = g.new_zeros((b, d), dtype=acc) if dh_n is None else dh_n.to(acc)
    dc = g.new_zeros((b, d), dtype=acc) if dc_n is None else dc_n.to(acc)
    for t in reversed(range(s)):
        gi, gf, gz, go = torch.chunk(g[:, t], 4, dim=-1)
        si, sf, so = (torch.sigmoid(x).to(acc) for x in (gi, gf, go))
        tz = torch.tanh(gz).to(acc)
        tc = torch.tanh(c[:, t])
        cp = c[:, t - 1] if t else (g.new_zeros((b, d), dtype=acc) if c0 is None else c0)
        dh_t = dy[:, t].to(acc) + dhr
        dc = dc + dh_t * so * (1 - tc * tc)
        dg = torch.cat([dc * tz * (si * (1 - si)), dc * cp * (sf * (1 - sf)),
                        dc * si * (1 - tz * tz), dh_t * tc * (so * (1 - so))], dim=-1).to(dt)
        dc = dc * sf
        dgx[:, t] = dg
        if t or need_dh0:
            dhr = torch.einsum("bhe,hde->bhd", dg.to(acc).reshape(b, nh, 4 * dh),
                               r).reshape(b, d)
    return dgx, dhr.to(dt) if need_dh0 else None, dc


def slstm_dr_gates(hseq, h0, dgx, nh):
    """r_gates' gradient: per head, the sum over b and t of h_{t-1} x dg_t,
    h_{-1} = h0 (or zeros), one product over all steps."""
    b, s, d = hseq.shape
    h_prev = torch.cat([hseq.new_zeros((b, 1, d)) if h0 is None else h0[:, None],
                        hseq[:, :-1]], dim=1)
    return torch.einsum("bshd,bshe->hde", h_prev.reshape(b, s, nh, d // nh),
                        dgx.reshape(b, s, nh, 4 * d // nh))


def flops(b, s, nh, dh) -> int:
    """The products' FLOPs, ``2 B S nh dh 4dh``: what the dry run's counter
    (``torch.utils.flop_counter``) counts for the plain loop, whose
    elementwise cell it does not count. The backward's recurrent product
    over s steps counts the same."""
    return 2 * b * s * nh * dh * 4 * dh


def _a16(n):
    return (n + 15) // 16 * 16


def smem_bytes(elem: int, b: int, d: int, dh: int, cpb: int) -> int:
    """Shared-memory bytes of one forward block (``Layout`` in the source):
    its barriers (two for h, one a gx stage); in fp32 its 4 x cpb columns of
    r_gates (bf16 keeps them in registers); two buffers of h (B rows of D
    values and HPAD bytes); the products (fp32: B sums a column; bf16: KS
    partial sums a column for B rounded up to 8); its new h; NST gx stages
    of 4 x B x cpb values."""
    mma = elem == 2
    return (_a16(8 * (2 + NST)) + (0 if mma else _a16(elem * 4 * cpb * dh))
            + 2 * b * (elem * d + HPAD) + _a16(4 * 4 * cpb * (KS * -(-b // 8) * 8 if mma else b))
            + _a16(elem * b * cpb) + NST * _a16(elem * 4 * b * cpb))


def heads_spanned(d: int, dh: int, cpb: int) -> int:
    """The most heads that one block's channels lie in."""
    return max((min(j0 + cpb, d) - 1) // dh - j0 // dh + 1 for j0 in range(0, d, cpb))


def smem_bytes_bwd(elem: int, b: int, d: int, dh: int, cpb: int) -> int:
    """Shared-memory bytes of one block of the backward's clusters
    (``BwdLayout`` in the source): its barriers (two for dg, one a stage);
    where each block of a cluster of up to 16 keeps its row of dg (an int
    each); two buffers of dg, B rows of its heads' range and HPAD_BWD
    bytes; the KP partial sums of each output (B rounded up to 8, rows of
    GS floats); its new dg; NST_BWD stages of g (4 x B x cpb), dy (B x cpb)
    and c (B x cpb fp32)."""
    row = elem * heads_spanned(d, dh, cpb) * 4 * dh + HPAD_BWD
    stage = _a16(elem * 4 * b * cpb) + _a16(elem * b * cpb) + _a16(4 * b * cpb)
    return (_a16(8 * (2 + NST_BWD)) + 4 * 16 + 2 * b * row
            + _a16(4 * KP * -(-b // 8) * 8 * GS) + _a16(elem * b * 4 * cpb) + NST_BWD * stage)


def smem_bytes_bwd_coop(elem: int, b: int, d: int, dh: int, cpb: int) -> int:
    """Shared-memory bytes of one block of the backward's cooperative grid
    (``smem_bytes_coop`` in the source): its rows of r_gates, dg_t of its
    heads, the products and its own dg_t."""
    return (_a16(elem * 4 * cpb * dh) + _a16(elem * b * heads_spanned(d, dh, cpb) * 4 * dh)
            + _a16(4 * 4 * cpb * b) + _a16(elem * b * 4 * cpb))


def _step(elem: int, clusters: bool) -> int:
    """cpb's granularity: even in the cooperative grid (``clusters`` False:
    a block publishes 4-byte words); in clusters 16 bytes of fp32 values (the
    forward's gx slices and h chunks move 16 bytes at a time) or 16 bf16
    channels (an m-tile of the products)."""
    return (4 if elem == 4 else 16) if clusters else 2


def channels_a_block(d: int, elem: int, sms: int, clusters: bool = True) -> int:
    """The fewest channels a block that keep the grid within one block an
    SM, rounded up to ``_step``."""
    step = _step(elem, clusters)
    return -(-d // (sms * step)) * step


def plan(b: int, d: int, dh: int, elem: int, sms: int, resident=None, *,
         smem_fn=smem_bytes):
    """The grid on a card of ``sms`` SMs. Raises where the kernel cannot
    take the shapes.

    The forward (``resident`` given: a function of a cluster size giving
    the most clusters of it the card holds at once, which the wrapper reads
    from the card) returns (cluster size, cpb, blocks, shared bytes a
    block): the largest cluster of 16, 8, 4 and 2 blocks (none larger than
    the grid but 2) for which the fewest channels a block whose grid the
    card holds at once fit the block's shared memory (and, in bf16, its
    products' registers: at most 32 channels and dh 512); the grid padded
    to whole clusters (the source's ``cluster_for`` picks the same size for
    that cpb); the backward's clusters take the same with ``smem_fn``
    ``smem_bytes_bwd``. ``resident`` None: the backward's cooperative grid
    (``smem_fn`` ``smem_bytes_bwd_coop``), (1, cpb, blocks, shared bytes a
    block), ``channels_a_block`` channels a block."""
    clusters = resident is not None
    cpb = channels_a_block(d, elem, sms, clusters)
    if b * cpb > MAX_PAIRS * THREADS:
        raise ValueError(f"slstm_scan: batch {b} x {cpb} channels a block exceeds "
                         f"{MAX_PAIRS * THREADS} (row, channel) pairs")
    if not clusters:
        smem = smem_fn(elem, b, d, dh, cpb)
        if smem > SMEM_LIMIT:
            raise ValueError(f"slstm_scan: {smem} bytes of shared memory a block at batch "
                             f"{b}, width {d}, head dim {dh} exceed {SMEM_LIMIT}")
        return 1, cpb, -(-d // cpb), smem
    step, why = _step(elem, True), set()
    for cluster in (16, 8, 4, 2):
        hold = resident(cluster) * cluster       # blocks the card holds in such clusters
        if hold <= 0:
            why.add("residency")
            continue
        c = max(cpb, -(-d // (hold * step)) * step)
        blocks = -(-d // c)
        if cluster > blocks and cluster > 2:
            continue
        smem = smem_fn(elem, b, d, dh, c)
        if b * c > MAX_PAIRS * THREADS:
            why.add("(row, channel) pairs")
        elif smem > SMEM_LIMIT:
            why.add("shared memory")
        elif elem == 2 and not (c <= 32 and dh % 16 == 0 and dh <= 512 and 4 % (d // dh) == 0):
            why.add("the bf16 products' tiles (cpb <= 32, dh <= 512, nh dividing 4)")
        else:
            return cluster, c, -(-blocks // cluster) * cluster, smem
    raise ValueError(f"slstm_scan: no grid of clusters the card holds at once takes batch {b}, "
                     f"width {d}, head dim {dh} in {elem}-byte values: " + ", ".join(sorted(why)))


def plan_bwd(b: int, d: int, dh: int, elem: int, sms: int, resident):
    """The backward's route and grid, (cluster size, cpb, blocks, shared
    bytes a block), by shape and dtype: in bf16 the clusters' (``plan`` with
    the backward's ``resident`` and ``smem_bytes_bwd``) where the forward's
    bf16 tiles take the shape and a block of 32 channels fits its shared
    memory and CPAIRS pairs a thread, raising where the card cannot hold the
    grid; otherwise the cooperative grid (cluster size 1,
    ``smem_bytes_bwd_coop``)."""
    if (elem == 2 and dh % 16 == 0 and dh <= 512 and 4 % (d // dh) == 0
            and b * 32 <= CPAIRS * THREADS and smem_bytes_bwd(elem, b, d, dh, 32) <= SMEM_LIMIT):
        return plan(b, d, dh, elem, sms, resident, smem_fn=smem_bytes_bwd)
    return plan(b, d, dh, elem, sms, smem_fn=smem_bytes_bwd_coop)


def _check_shapes(what, named, b, s, d, r_gates, **extra):
    """Raise unless r_gates is (nh, D/nh, 4D/nh) and each tensor of
    ``named`` has the shape given for it: ``bd`` (B, D), ``bsd`` (B, S, D)
    or ``bs4d`` (B, S, 4D)."""
    shapes = {"bd": (b, d), "bsd": (b, s, d), "bs4d": (b, s, 4 * d)}
    if r_gates.dim() != 3 or r_gates.shape[0] * r_gates.shape[1] != d or (
            r_gates.shape[2] != 4 * r_gates.shape[1]) or any(
            x is not None and tuple(x.shape) != shapes[named[k]] for k, x in extra.items()):
        raise ValueError(f"{what}: bad shapes " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in {"r_gates": r_gates, **extra}.items()
            if x is not None))
    if d % 8 or r_gates.shape[1] % 2:
        raise ValueError(f"{what}: width {d} must be a multiple of 8 and head dim "
                         f"{r_gates.shape[1]} even")


def _sms(x):
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _card_plan(fwd, b, d, nh, x):
    """The plan of the forward (``plan``) or the backward (``plan_bwd``) at
    B rows of width d in x's dtype on x's card, with the residency the card
    reports for the kernel's instance (``repro_slstm_scan_clusters``,
    ``repro_slstm_scan_bwd_clusters``); kept for the next call."""
    key = (fwd, b, d, nh, x.dtype, x.device)
    if key not in _plans:
        elem, bf16 = x.element_size(), int(x.dtype == torch.bfloat16)
        sms = _sms(x)
        cpb = channels_a_block(d, elem, sms)
        fn = _kernel(CLUSTERS if fwd else CLUSTERS_BWD)

        def resident(cluster):
            with torch.cuda.device(x.device):
                n = fn(cluster, b, d, nh, cpb, bf16)
            if n < 0:
                raise RuntimeError(f"slstm_scan: the residency query failed: cudaError {-n}")
            return n

        _plans[key] = (plan if fwd else plan_bwd)(b, d, d // nh, elem, sms, resident)
    return _plans[key]


def fwd_plan(b, d, nh, x):
    """``plan`` of the forward on x's card (``_card_plan``)."""
    return _card_plan(True, b, d, nh, x)


def bwd_plan(b, d, nh, x):
    """``plan_bwd`` of the backward on x's card (``_card_plan``)."""
    return _card_plan(False, b, d, nh, x)


def slstm_scan(gx, r_gates, h0=None, c0=None, save=False):
    """gx (B, S, 4D) and r_gates (nh, dh, 4dh) in bf16 or fp32, h0 (B, D) in
    their dtype and c0 (B, D) fp32, each or None (zeros) -> (h (B, S, D),
    the last h (B, D), the last c (B, D) fp32), and with ``save`` also g (B,
    S, 4D) in gx's dtype and c (B, S, D) fp32 for the backward.

    CUDA tensors go to the kernel, CPU tensors to ``slstm_scan_plain``;
    meta tensors (the dry run) get empty outputs and the products' FLOPs in
    ``meta_flops``; tensors elsewhere raise."""
    global launches, meta_flops
    if gx.device.type == "cpu":
        return slstm_scan_plain(gx, r_gates, h0, c0, save=save)
    b, s, d4 = gx.shape if gx.dim() == 3 else (0, 0, 0)
    d = d4 // 4
    saved = ((gx.new_empty((b, s, d4)), gx.new_empty((b, s, d), dtype=torch.float32))
             if save else ())
    if _on_meta(gx, r_gates, h0, c0):
        meta_flops += flops(b, s, *r_gates.shape[:2])
        return (gx.new_empty((b, s, d)), gx.new_empty((b, d)),
                gx.new_empty((b, d), dtype=torch.float32), *saved)
    _check({"gx": gx, "r_gates": r_gates, "h0": h0, "c0": c0}, gx.dtype, ("c0",),
           "slstm_scan")
    if gx.dim() != 3 or d4 % 4:
        raise ValueError(f"slstm_scan: bad shapes gx {tuple(gx.shape)}")
    _check_shapes("slstm_scan", {"h0": "bd", "c0": "bd"}, b, s, d, r_gates, h0=h0, c0=c0)
    out = gx.new_empty((b, s, d))
    h_n = gx.new_empty((b, d))
    c_n = gx.new_empty((b, d), dtype=torch.float32)
    if s == 0 or b == 0:
        return (out, h_n.copy_(h0) if h0 is not None else h_n.zero_(),
                c_n.copy_(c0) if c0 is not None else c_n.zero_(), *saved)
    nh, dh = r_gates.shape[:2]
    _, cpb, _, _ = fwd_plan(b, d, nh, gx)
    # the clusters' exchange of h in L2: two buffers of B x D values in
    # 8-byte words of 4 data bytes and a tag
    xch = torch.empty(2 * b * d * gx.element_size() // 4, dtype=torch.int64,
                      device=gx.device)
    g_ptr, c_ptr = (saved[0].data_ptr(), saved[1].data_ptr()) if save else (None, None)
    fn = _kernel()
    with torch.cuda.device(gx.device):
        err = fn(gx.data_ptr(), r_gates.data_ptr(), _ptr(h0), _ptr(c0), out.data_ptr(),
                 h_n.data_ptr(), c_n.data_ptr(), g_ptr, c_ptr, xch.data_ptr(), b, s, d, nh,
                 cpb, int(gx.dtype == torch.bfloat16),
                 torch.cuda.current_stream(gx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: cudaError {err} (720: "
                           "the grid's clusters cannot be resident at once)")
    launches += 1
    return out, h_n, c_n, *saved


def slstm_scan_bwd(g, c, r_gates, dy, c0=None, dh_n=None, dc_n=None, need_dh0=True):
    """The backward of ``slstm_scan``: g (B, S, 4D) and c (B, S, D) fp32 from
    the saving forward, r_gates, c0 (B, D) fp32 or None, dy (B, S, D) in g's
    dtype, dh_n (B, D) in g's dtype and dc_n (B, D) fp32 or None -> (dgx (B,
    S, 4D), dh0 (B, D) or None where not ``need_dh0``, dc0 (B, D) fp32).

    CUDA tensors go to the kernel, CPU tensors to ``slstm_scan_bwd_plain``;
    meta tensors get empty outputs and, in ``meta_flops``, the recurrent
    product's FLOPs, which ``flop_counter`` counts for the plain loop's
    backward (dh_{t-1} at steps 1 .. S-1, and at step 0 where dh0 is asked
    for); tensors elsewhere raise."""
    global launches_bwd, meta_flops
    if g.device.type == "cpu":
        return slstm_scan_bwd_plain(g, c, r_gates, dy, c0, dh_n, dc_n, need_dh0)
    b, s, d4 = g.shape if g.dim() == 3 else (0, 0, 0)
    d = d4 // 4
    dgx = torch.empty_like(g)
    dh0 = g.new_empty((b, d)) if need_dh0 else None
    dc0 = g.new_empty((b, d), dtype=torch.float32)
    if _on_meta(g, c, r_gates, dy, c0, dh_n, dc_n):
        meta_flops += flops(b, max(s - 1 + int(need_dh0), 0), *r_gates.shape[:2])
        return dgx, dh0, dc0
    named = {"g": g, "c": c, "r_gates": r_gates, "dy": dy, "c0": c0, "dh_n": dh_n,
             "dc_n": dc_n}
    _check(named, g.dtype, ("c", "c0", "dc_n"), "slstm_scan_bwd")
    if g.dim() != 3 or d4 % 4:
        raise ValueError(f"slstm_scan_bwd: bad shapes g {tuple(g.shape)}")
    _check_shapes("slstm_scan_bwd", {"c": "bsd", "dy": "bsd", "c0": "bd", "dh_n": "bd",
                                     "dc_n": "bd"}, b, s, d, r_gates, c=c, dy=dy, c0=c0,
                  dh_n=dh_n, dc_n=dc_n)
    nh, dh = r_gates.shape[:2]
    if nh > 4:
        raise ValueError(f"slstm_scan_bwd: {nh} heads; the kernel's exchange takes at "
                         "most 4 (a head's gates must span the width)")
    if s == 0 or b == 0:
        if dh0 is not None:
            dh0.copy_(dh_n) if dh_n is not None else dh0.zero_()
        return dgx, dh0, dc0.copy_(dc_n) if dc_n is not None else dc0.zero_()
    cluster, cpb, _, _ = bwd_plan(b, d, nh, g)
    # the exchange of dg: two buffers of B x 4D values in tagged words
    xch = torch.empty(2 * b * d4 * g.element_size() // 4, dtype=torch.int64,
                      device=g.device)
    fn = _kernel(KERNEL_BWD)
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), c.data_ptr(), _ptr(c0), r_gates.data_ptr(), dy.data_ptr(),
                 _ptr(dh_n), _ptr(dc_n), dgx.data_ptr(), _ptr(dh0), dc0.data_ptr(),
                 xch.data_ptr(), b, s, d, nh, cpb, cluster, int(g.dtype == torch.bfloat16),
                 torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd kernel launch failed: cudaError {err} (720: "
                           "the grid cannot be resident at once)")
    launches_bwd += 1
    return dgx, dh0, dc0
