"""The sLSTM recurrence's backward (``repro_torch.kernels.slstm``
``slstm_scan_bwd_plain``, ``slstm_dr_gates`` and ``ops.slstm_scan``) against
the reference on the CPU.

The reference has no backward of its own: XLA transposes its
``jax.lax.scan`` over ``_slstm_cell`` (``repro/models/xlstm.py``
``apply_slstm``). The same seeded numpy inputs and cotangents go through
``jax.vjp`` of that scan and through the port's hand-written reverse loop:
nh 4 and dh 16 (the reduced xlstm-1.3b's sLSTM), B 2, S 24, from zeros and
from (h0, c0). Tolerances: fp32 1e-5 abs / 1e-4 rel; bf16 relative L2
within max(3e-2, 2 g), g the reference's own gap between its bf16 and its
fp32 gradient on the same inputs (two independent bf16 roundings).
``torch.autograd.gradcheck`` holds the autograd function in fp64, a numpy
mirror of ``csrc/slstm_scan_bwd.cu`` replays its columns, head
ranges and tagged exchange with the blocks run in random orders, and the
meta branches count the FLOPs ``flop_counter`` counts for the plain loop's
backward, in a reduced dry-run train cell too.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import test_torch_slstm as fwd
from _family_twins import both, np_, rel_l2
from repro_torch import kernels
from repro_torch.kernels import _build, ops
from repro_torch.kernels import slstm

B, NH, DH, S = 2, 4, 16, 24
D = NH * DH
GRADS = ("gx", "r_gates", "h0", "c0")


def _cotangents(seed, b, s, d):
    """dy (B, S, D), dh_n and dc_n (B, D), normal; numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)), rng.standard_normal((b, d)),
            rng.standard_normal((b, d)))


def _reference_grads(j, cot, dtype):
    """``jax.vjp`` of the reference's scan at the JAX inputs ``j``, the
    cotangents in ``dtype`` (c's in fp32): grads of gx, r_gates, h0, c0."""
    _, vjp = jax.vjp(fwd._reference_scan, *j)
    dy, dhn, dcn = cot
    return vjp((jnp.asarray(dy, j[0].dtype), jnp.asarray(dhn, j[0].dtype),
                jnp.asarray(dcn, jnp.float32)))


def _port_grads(t, cot, dtype):
    """The saving forward, ``slstm_scan_bwd_plain`` and ``slstm_dr_gates``
    on the CPU tensors ``t``: grads of gx, r_gates, h0 (None without h0) and
    c0."""
    gx, r, h0, c0 = t
    dy, dhn, dcn = both(cot[0], dtype)[1], both(cot[1], dtype)[1], both(cot[2])[1]
    hseq, _, _, g, c = slstm.slstm_scan_plain(gx, r, h0, c0, save=True)
    dgx, dh0, dc0 = slstm.slstm_scan_bwd_plain(g, c, r, dy, c0, dhn, dcn,
                                               need_dh0=h0 is not None)
    return dgx, slstm.slstm_dr_gates(hseq, h0, dgx, NH), dh0, dc0


def _fp32_check(got, want):
    for name, g, w in zip(GRADS, got, want):
        if g is not None:
            np.testing.assert_allclose(np_(g), np_(w), atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_the_reference_vjp(dtype, with_state):
    """dgx, dr_gates, dh0 and dc0 of the hand-written reverse loop against
    ``jax.vjp`` of the reference's scan, with cotangents on h and on the
    last (h, c). bf16: each gradient's relative L2 from the reference's
    bf16 one within max(3e-2, 2 g), g its gap from the reference's fp32
    gradient on the same (bf16-valued) inputs."""
    inputs, cot = fwd._inputs(11, S, with_state), _cotangents(12, B, S, D)
    j, t = fwd._both(*inputs, dtype)
    got, want = _port_grads(t, cot, dtype), _reference_grads(j, cot, dtype)
    assert got[0].dtype == got[1].dtype == t[0].dtype and got[3].dtype == torch.float32
    if dtype == "float32":
        _fp32_check(got, want)
        return
    j32 = [None if x is None else jnp.asarray(x, jnp.float32) for x in j]
    want32 = _reference_grads(j32, cot, "float32")
    readings = {}
    for name, g, w, w32 in zip(GRADS, got, want, want32):
        if g is None:
            continue
        gap = rel_l2(w, w32)
        readings[name] = (rel_l2(g, w), gap)
        assert rel_l2(g, w) <= max(3e-2, 2 * gap), (name, readings[name])
    print("bf16 rel L2 (port-ref, ref's own gap):", readings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_gradients_match_the_reference_and_autograd(dtype):
    """``ops.slstm_scan`` under autograd on the CPU (the saving forward, then
    ``slstm_scan_bwd``, which runs the plain loop for a CPU tensor): its
    gradients against the reference's ``jax.vjp`` (fp32: 1e-5 / 1e-4; bf16:
    the rule above) and against torch autograd through ``slstm_scan_plain``
    (fp32: 1e-5 / 1e-4; bf16: the same rule against the reference's fp32
    gradient), with no launch."""
    inputs, cot = fwd._inputs(13, S, True), _cotangents(14, B, S, D)
    j, t = fwd._both(*inputs, dtype)
    leaves = [x.clone().requires_grad_(True) for x in t]
    dy, dhn, dcn = both(cot[0], dtype)[1], both(cot[1], dtype)[1], both(cot[2])[1]
    before = kernels.launch_counts()
    out = ops.slstm_scan(*leaves)
    got = torch.autograd.grad(out, leaves, (dy, dhn, dcn))
    assert kernels.launch_counts() == before
    auto = torch.autograd.grad(slstm.slstm_scan_plain(*leaves), leaves, (dy, dhn, dcn))
    want = _reference_grads(j, cot, dtype)
    if dtype == "float32":
        _fp32_check(got, want)
        _fp32_check(got, auto)
        return
    want32 = _reference_grads([jnp.asarray(x, jnp.float32) for x in j], cot, "float32")
    for name, g, w, a, w32 in zip(GRADS, got, want, auto, want32):
        gap = rel_l2(w, w32)
        assert rel_l2(g, w) <= max(3e-2, 2 * gap), (name, rel_l2(g, w), gap)
        assert rel_l2(a, w) <= max(3e-2, 2 * gap), (name, "autograd", rel_l2(a, w), gap)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_gradcheck_fp64(with_state):
    """``torch.autograd.gradcheck`` of ``ops.slstm_scan`` in fp64 at B 2, S 5,
    nh 2, dh 4 (c kept in fp64 too): every output's cotangent reaches gx,
    r_gates, h0 and c0."""
    rng = np.random.default_rng(15)
    nh, dh, s = 2, 4, 5
    d = nh * dh

    def leaf(a):
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    gx = leaf(rng.standard_normal((2, s, 4 * d)))
    r = leaf(rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh))
    state = ((leaf(np.tanh(rng.standard_normal((2, d)))), leaf(rng.standard_normal((2, d))))
             if with_state else (None, None))
    assert torch.autograd.gradcheck(ops.slstm_scan, (gx, r, *state))


# -- the kernel's layout and exchange, mirrored in numpy ----------------------------
def _mirror_bwd(g, c, r, dy, c0, dh_n, dc_n, cpb, need_dh0, rng):
    """``slstm_scan_bwd_kernel`` in fp64 numpy, the blocks run as
    generators in a random order: block k owns channels j0 = k cpb .. and
    their pairs; column q cpb + jj of its products holds r's row j0 + jj at
    quarter q; each step it publishes its 4 x nch values of dg at flat q D +
    j0 in buffer it % 2, tagged it + 1, and waits for every value of its
    heads' range [h_lo 4dh, (h_lo + nspan) 4dh) to carry that tag. A block
    that finds a newer tag there, or a schedule where every block waits,
    fails. Returns (dgx, dh0, dc0)."""
    b, s, d4 = g.shape
    d = d4 // 4
    nh, dh = r.shape[:2]
    e4 = 4 * dh
    rows = r.reshape(d, e4)
    xch, tags = np.zeros((2, b, d4)), np.zeros((2, b, d4), dtype=int)
    dgx, dh0, dc0 = np.full(g.shape, np.nan), np.full((b, d), np.nan), np.full((b, d), np.nan)

    def sig(x):
        return 1 / (1 + np.exp(-x))

    def block(j0):
        nch = min(cpb, d - j0)
        ch = np.arange(j0, j0 + nch)
        h_lo = j0 // dh
        span = ((j0 + nch - 1) // dh - h_lo + 1) * e4
        rs = np.zeros((4 * cpb, dh))
        for col in range(4 * cpb):
            q, jj = divmod(col, cpb)
            if jj < nch:
                rs[col] = rows[j0 + jj, q * dh:(q + 1) * dh]
        gr = np.zeros((4 * cpb, b))
        gr[:nch] = 0 if dh_n is None else dh_n[:, ch].T
        dc = np.zeros((b, nch)) if dc_n is None else dc_n[:, ch]
        for it, t in enumerate(reversed(range(s))):
            dhr = (((gr[:nch] + gr[cpb:cpb + nch]) + gr[2 * cpb:2 * cpb + nch])
                   + gr[3 * cpb:3 * cpb + nch]).T
            gi, gf, gz, go = (g[:, t, q * d + ch] for q in range(4))
            si, sf, tz, so = sig(gi), sig(gf), np.tanh(gz), sig(go)
            tc = np.tanh(c[:, t, ch])
            cp = c[:, t - 1, ch] if t else (np.zeros((b, nch)) if c0 is None else c0[:, ch])
            dh_t = dy[:, t, ch] + dhr
            dc = dc + dh_t * so * (1 - tc * tc)
            dg = [dc * tz * si * (1 - si), dc * cp * sf * (1 - sf), dc * si * (1 - tz * tz),
                  dh_t * tc * so * (1 - so)]
            dc = dc * sf
            for q in range(4):
                dgx[:, t, q * d + ch] = dg[q]
            if t == 0 and not need_dh0:
                break
            buf = it % 2
            for q in range(4):
                xch[buf][:, q * d + ch], tags[buf][:, q * d + ch] = dg[q], it + 1
            yield
            lo = h_lo * e4
            while not (tags[buf, :, lo:lo + span] == it + 1).all():
                assert (tags[buf, :, lo:lo + span] <= it + 1).all(), "overwritten"
                yield "wait"
            dgs = xch[buf, :, lo:lo + span].copy()
            for col in range(4 * cpb):
                q, jj = divmod(col, cpb)
                if jj < nch:
                    off = ((j0 + jj) // dh - h_lo) * e4 + q * dh
                    gr[col] = dgs[:, off:off + dh] @ rs[col]
            yield
        dc0[:, ch] = dc
        if need_dh0:
            dh0[:, ch] = (((gr[:nch] + gr[cpb:cpb + nch]) + gr[2 * cpb:2 * cpb + nch])
                          + gr[3 * cpb:3 * cpb + nch]).T

    live = [block(j0) for j0 in range(0, d, cpb)]
    stalled = 0
    while live:
        k = int(rng.integers(len(live)))
        try:
            stalled = stalled + 1 if next(live[k]) == "wait" else 0
        except StopIteration:
            live.pop(k)
            stalled = 0
        assert stalled < 100 * (len(live) + 1), "every block waits"
    return dgx, dh0 if need_dh0 else None, dc0


@pytest.mark.parametrize("cpb", [2, 6])
@pytest.mark.parametrize("nh", [4, 2, 1])
def test_kernel_mirror_equals_the_plain_backward(nh, cpb):
    """The mirror above against ``slstm_scan_bwd_plain`` in fp64, D 16 (4
    blocks of 2 channels over 8 blocks, or 6, 6 and 4 channels, whose
    first block spans two heads at nh 4), with and without a state and
    dh0, each under two random orders of the blocks."""
    d, s = 16, 5
    dh = d // nh
    rng = np.random.default_rng(16 + nh + cpb)
    for with_state in (False, True):
        g = rng.standard_normal((B, s, 4 * d))
        c = rng.standard_normal((B, s, d))
        r = rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh)
        dy = rng.standard_normal((B, s, d))
        state = [rng.standard_normal((B, d)) if with_state else None for _ in range(3)]
        c0, dh_n, dc_n = state
        t = [None if x is None else torch.tensor(x) for x in (g, c, r, dy, c0, dh_n, dc_n)]
        want = slstm.slstm_scan_bwd_plain(*t, need_dh0=with_state)
        for order in range(2):
            got = _mirror_bwd(g, c, r, dy, c0, dh_n, dc_n, cpb, with_state,
                              np.random.default_rng(order))
            for x, w in zip(got, want):
                if w is None:
                    assert x is None
                else:
                    np.testing.assert_allclose(x, w.numpy(), atol=1e-12, rtol=1e-12)


# -- the wrappers: CPU route, meta branches, FLOPs --------------------------------
def test_cpu_wrappers_are_the_plain_loops_and_launch_nothing():
    """On CPU tensors ``slstm_scan(save=True)`` is ``slstm_scan_plain(save=
    True)`` and ``slstm_scan_bwd`` is ``slstm_scan_bwd_plain``, to the bit,
    with no launch; the saved g is the cell's gx + flat(gr) in gx's dtype
    and c its fp32 c, the last of them the returned last c."""
    j, t = fwd._both(*fwd._inputs(17, 9, True), "bfloat16")
    dy = both(_cotangents(18, B, 9, D)[0], "bfloat16")[1]
    before = kernels.launch_counts()
    got, want = slstm.slstm_scan(*t, save=True), slstm.slstm_scan_plain(*t, save=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].dtype == torch.bfloat16 and got[4].dtype == torch.float32
    assert torch.equal(got[4][:, -1], got[2])
    gx, r, h0, c0 = t
    g1 = gx[:, 0] + torch.einsum("bhd,hde->bhe", h0.reshape(B, NH, DH), r).reshape(B, -1)
    assert torch.equal(got[3][:, 0], g1)
    bwd = slstm.slstm_scan_bwd(got[3], got[4], r, dy, c0)
    assert all(torch.equal(a, b) for a, b in zip(
        bwd, slstm.slstm_scan_bwd_plain(got[3], got[4], r, dy, c0)))
    assert kernels.launch_counts() == before


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_meta_branches_count_the_plain_loops_backward_flops(with_state):
    """On meta tensors a forward and backward through ``ops.slstm_scan``
    (the meta branches, and ``slstm_dr_gates``' einsum, which the counter
    sees) count, in ``kernels.meta_flops()`` plus ``flop_counter``, what
    ``flop_counter`` counts for autograd through the plain loop: the
    forward's products, r_gates' gradient at every step and h's at steps
    1 .. S-1 (at step 0 too where h0 takes a gradient). No launch; the
    outputs and gradients have the kernels' shapes and dtypes."""
    s = 7

    def leaves():
        state = ((_meta(B, D, grad=True), _meta(B, D, dtype=torch.float32, grad=True))
                 if with_state else (None, None))
        return [_meta(B, s, 4 * D, grad=True), _meta(NH, DH, 4 * DH, grad=True), *state]

    def run(fn, xs):
        out = fn(*xs)
        live = [x for x in xs if x is not None]
        return torch.autograd.grad(out[:3], live, [torch.ones_like(o) for o in out[:3]])

    kernels.reset_meta_flops()
    before = kernels.launch_counts()
    xs = leaves()
    with FlopCounterMode(display=False) as counter:
        grads = run(ops.slstm_scan, xs)
    ported = kernels.meta_flops() + counter.get_total_flops()
    assert kernels.launch_counts() == before
    assert [(tuple(g.shape), g.dtype) for g in grads] == [
        (tuple(x.shape), x.dtype) for x in xs if x is not None]
    kernels.reset_meta_flops()
    with FlopCounterMode(display=False) as counter:
        run(slstm.slstm_scan_plain, leaves())
    fl = slstm.flops(B, 1, NH, DH)
    want = fl * (s + s + s - 1 + int(with_state))
    assert kernels.meta_flops() == 0 and ported == counter.get_total_flops() == want


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_process_group

    yield fake_process_group
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dryrun_train_cell_counts_the_same_flops_on_both_routes(fake_group, monkeypatch):
    """The reduced xlstm-1.3b's small train cell of the dry run on a (2, 2)
    mesh (a mesh shape of its own), once as it runs (the sLSTM's forward
    and backward through their meta branches) and once with
    ``ops.slstm_scan`` routed to autograd through ``slstm_scan_plain``: the
    same FLOPs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    cfg = get_arch("xlstm-1.3b", reduced=True)
    shape = ShapeConfig("small", kind="train", seq_len=32, global_batch=8)
    mesh = ((2, 2), ("data", "model"))
    fake_group(4)
    kernel = run_cell(cfg, shape, *mesh)
    tallied = slstm.meta_flops           # the cell's run resets the tally first
    monkeypatch.setattr(ops, "slstm_scan", slstm.slstm_scan_plain)
    loop = run_cell(cfg, shape, *mesh)
    assert tallied > 0 and slstm.meta_flops == 0
    assert kernel["cost"]["flops"] == loop["cost"]["flops"] > 0


def test_plan_bwd_at_the_paths_shapes_and_the_exported_symbol():
    """The backward's cooperative grid (fp32's route, and bf16's where its
    clusters' shared memory does not fit) is the earlier forward's (16
    channels a block, 128 blocks at xlstm-1.3b's D 2048 on 132 SMs, cluster
    size 1); its shared memory holds r_gates' rows, dg of one head (B x
    4dh), the products and its own dg: 83,456 bytes at (4, bf16), 165,888 at
    (4, fp32); 6 channels over dh 4 span two heads. The source exports the
    symbol with the wrapper's argument types."""
    coop = slstm.smem_bytes_bwd_coop
    assert slstm.plan(4, 2048, 512, 2, 132, smem_fn=coop) == (1, 16, 128, 83456)
    assert slstm.plan(4, 2048, 512, 4, 132, smem_fn=coop) == (1, 16, 128, 165888)
    assert slstm.plan_bwd(4, 2048, 512, 4, 132, None) == (1, 16, 128, 165888)
    assert slstm.heads_spanned(2048, 512, 16) == 1 and slstm.heads_spanned(16, 4, 6) == 2
    text = (_build.CSRC / "slstm_scan_bwd.cu").read_text()
    symbol, argtypes = slstm.KERNEL_BWD
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"slstm_scan_bwd.cu does not export {symbol}"
    declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (p.strip() for p in found.group(1).split(","))]
    assert declared == argtypes
