"""The mLSTM chunk recurrence's backward (``repro_torch.kernels.mlstm``
``mlstm_backward``, ``mlstm_carry_bwd_plain`` and ``ops.mlstm_chunk_scan``
under autograd) against the reference on the CPU.

The reference has no backward of its own: XLA transposes its
``jax.lax.scan`` over chunks (``repro/models/xlstm.py:108``,
``_mlstm_chunk_scan``). The same seeded numpy inputs and cotangents (on h
and on the last C and n) go through ``jax.vjp`` of that scan and through
the port's saving forward, the carried cotangents' plain loop (what
``csrc/mlstm_scan_bwd.cu`` does on the card) and the carry-free terms:
batch 1, 2 heads of 8, S = 5 x 256 + 37 (a ragged last chunk) and S = 100
(one chunk), with no first state (None, as training passes it), from
zeros and from (C0, n0). Tolerances: fp32 1e-5 abs / 1e-4 rel; bf16
relative L2 within 2e-2. ``torch.autograd.gradcheck`` holds the autograd
function in fp64 over two chunks (the chunk length cut to 8), the last
ragged, and the meta branches count the FLOPs ``flop_counter`` counts for
the plain routes, in a reduced dry-run train cell too.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _family_twins import both, np_, rel_l2
from repro.models import xlstm as jxl
from repro_torch import kernels
from repro_torch.kernels import _build, mlstm, ops

S_LONG = 5 * mlstm.CHUNK + 37
B, NH, DH = 1, 2, 8
NAMES = ("q", "k", "v", "i", "logf", "C0", "n0")


def _inputs(s, with_state, seed=41):
    """q, k, v normal / 2, sigmoid input gates, log forget gates near
    log(sigmoid(3)), and C0, n0 (or zeros); numpy, batch 1, 2 heads of 8
    (as ``tests/test_torch_mlstm_kernel.py``)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, s, NH, DH)) * 0.5 for _ in range(3)]
    i = 1 / (1 + np.exp(-rng.standard_normal((B, s, NH))))
    logf = -np.log1p(np.exp(-(rng.standard_normal((B, s, NH)) + 3.0)))
    scale = 0.1 if with_state else 0.0
    C0 = rng.standard_normal((B, NH, DH, DH)) * scale
    n0 = rng.standard_normal((B, NH, DH)) * scale
    return (*arrays, i, logf, C0, n0)


def _cotangents(s, seed=42):
    """dh (B, S, NH, dh), dC (B, NH, dh, dh), dn (B, NH, dh), normal; numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, NH, DH)), rng.standard_normal((B, NH, DH, DH)),
            rng.standard_normal((B, NH, DH)))


def _both(arrays, dtype):
    """q, k, v in the activations' dtype; the gates and the state in fp32."""
    return zip(*(both(a, dtype if n < 3 else "float32") for n, a in enumerate(arrays)))


def _torch_cot(cot, dtype):
    return both(cot[0], dtype)[1], both(cot[1])[1], both(cot[2])[1]


def _reference_grads(js, cot, dtype):
    """``jax.vjp`` of the reference's scan: grads of q, k, v, i, logf, C0, n0."""
    _, vjp = jax.vjp(jxl._mlstm_chunk_scan, *js)
    return vjp((jnp.asarray(cot[0], js[0].dtype), jnp.asarray(cot[1], jnp.float32),
                jnp.asarray(cot[2], jnp.float32)))


def _plain_grads(ts, cot):
    """The saving forward's plain parts, then ``mlstm_backward`` on CPU
    tensors (the carried cotangents by ``mlstm_carry_bwd_plain``); C0 and n0
    each a tensor or None."""
    q, k, v, i, logf, C0, n0 = ts
    cl, h_intra, d_intra, qk = mlstm.mlstm_intra_terms(q, k, v, i, logf, keep_qk=True)
    h, _, _, Cs, ns = mlstm.mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0,
                                              save=True)
    return mlstm.mlstm_backward(q, k, v, i, logf, cl, d_intra, qk, C0, n0, Cs, ns, h, *cot,
                                need_state=True)


def _hold(got, want, dtype):
    readings = {}
    for name, g, w in zip(NAMES, got, want):
        if dtype == "float32":
            np.testing.assert_allclose(np_(g), np_(w), atol=1e-5, rtol=1e-4, err_msg=name)
        else:
            readings[name] = rel_l2(g, w)
            assert readings[name] <= 2e-2, (name, readings)
    return readings


@pytest.mark.parametrize("s", [S_LONG, 100], ids=["ragged", "short"])
@pytest.mark.parametrize("state", ["none", "zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_the_reference_vjp(dtype, state, s):
    """dq, dk, dv, di, dlogf, dC0 and dn0 of the plain backward against
    ``jax.vjp`` of the reference's scan, with cotangents on h and on the
    last C and n; the gradients keep the inputs' dtypes. With no first
    state the port is given None where the reference starts from zeros
    (dC0 and dn0 are still asked for)."""
    js, ts = _both(_inputs(s, state == "state"), dtype)
    cot = _cotangents(s)
    if state == "none":
        ts = (*ts[:5], None, None)
    got = _plain_grads(ts, _torch_cot(cot, dtype))
    assert [g.dtype for g in got] == [t.dtype for t in ts if t is not None] + [torch.float32] * (
        2 * (state == "none"))
    print("bf16 rel L2:", _hold(got, _reference_grads(js, cot, dtype), dtype))


@pytest.mark.parametrize("cot_on", ["h_C_n", "h"])
@pytest.mark.parametrize("state", ["none", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_gradients_match_the_reference_and_autograd(dtype, state, cot_on):
    """``ops.mlstm_chunk_scan`` under autograd on the CPU (``_MLSTMScan``: the
    saving forward, then ``mlstm_backward``): its gradients against the
    reference's ``jax.vjp`` and against torch autograd through the two plain
    parts (``mlstm_intra_terms`` and ``mlstm_carry_plain``), at the bounds
    above, with no launch. With no first state (None, as training passes
    it: the reference starts from zeros) and with one taking gradients;
    with cotangents on h, C and n, or on h alone (the reference's on C and
    n zeros), as training gives them."""
    js, ts = _both(_inputs(S_LONG, state == "state", seed=43), dtype)
    cot = _cotangents(S_LONG, seed=44)
    if cot_on == "h":
        cot = (cot[0], np.zeros_like(cot[1]), np.zeros_like(cot[2]))
    tcot = _torch_cot(cot, dtype)
    n_live = 7 if state == "state" else 5
    leaves = [t.clone().requires_grad_(True) for t in ts[:n_live]]
    args = (*leaves, *([None, None] if n_live == 5 else []))
    outs = 3 if cot_on == "h_C_n" else 1
    before = kernels.launch_counts()
    got = torch.autograd.grad(ops.mlstm_chunk_scan(*args)[:outs], leaves, tcot[:outs])
    assert kernels.launch_counts() == before
    q, k, v, i, logf, C0, n0 = args
    plain = mlstm.mlstm_carry_plain(q, k, v, i, *mlstm.mlstm_intra_terms(q, k, v, i, logf),
                                    C0, n0)
    auto = torch.autograd.grad(plain[:outs], leaves, tcot[:outs])
    _hold(got, _reference_grads(js, cot, dtype), dtype)
    _hold(got, auto, dtype)


@pytest.mark.parametrize("state", ["none", "zeros", "state"])
def test_gradcheck_fp64(state, monkeypatch):
    """``torch.autograd.gradcheck`` of ``ops.mlstm_chunk_scan`` in fp64 with
    the chunk length cut to 8 at S 13 (two chunks, the last of 5 rows), B 2,
    2 heads of 4: every output's cotangent reaches q, k, v, i, logf and,
    with a state, C0 and n0; with no first state (None) and from one that
    takes no gradient too."""
    monkeypatch.setattr(mlstm, "CHUNK", 8)
    rng = np.random.default_rng(45)
    b, s, nh, dh = 2, 13, 2, 4

    def leaf(a, grad=True):
        return torch.tensor(a, dtype=torch.float64, requires_grad=grad)

    q, k, v = (leaf(rng.standard_normal((b, s, nh, dh)) * 0.5) for _ in range(3))
    i = leaf(1 / (1 + np.exp(-rng.standard_normal((b, s, nh)))))
    logf = leaf(-np.log1p(np.exp(-(rng.standard_normal((b, s, nh)) + 1.0))))
    C0 = leaf(rng.standard_normal((b, nh, dh, dh)) * 0.3, state == "state")
    n0 = leaf(rng.standard_normal((b, nh, dh)) * 0.3, state == "state")
    if state == "none":
        C0 = n0 = None
    assert torch.autograd.gradcheck(ops.mlstm_chunk_scan, (q, k, v, i, logf, C0, n0))


def test_cpu_route_is_the_plain_loops_and_launches_nothing():
    """On CPU tensors ``mlstm_carry(save=True)`` is ``mlstm_carry_plain(save=
    True)`` and ``mlstm_carry_bwd`` is ``mlstm_carry_bwd_plain``, to the bit,
    with no launch; both keep the nc - 1 states between chunks (none with
    one chunk), chunk 0's update of the carry runs only for dC0, dn0, and T
    covers the rows of every chunk (a dC on the last state is given)."""
    _, ts = _both(_inputs(S_LONG, True), "bfloat16")
    q, k, v, i, logf, C0, n0 = ts
    nc = mlstm._chunks(S_LONG)[1]
    before = kernels.launch_counts()
    terms = mlstm.mlstm_intra_terms(q, k, v, i, logf)
    got = mlstm.mlstm_carry(q, k, v, i, *terms, C0, n0, save=True)
    want = mlstm.mlstm_carry_plain(q, k, v, i, *terms, C0, n0, save=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[3].shape == (B, nc - 1, NH, DH, DH) and got[4].shape == (B, nc - 1, NH, DH)
    rng = np.random.default_rng(46)
    g = torch.tensor(rng.standard_normal(q.shape), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal(i.shape), dtype=torch.float32)
    dC, dn = (torch.tensor(rng.standard_normal(x.shape), dtype=torch.float32)
              for x in (C0, n0))
    cl = terms[0]
    for need in (False, True):
        bwd = mlstm.mlstm_carry_bwd(q, k, g, u, cl, dC, dn, need)
        ref = mlstm.mlstm_carry_bwd_plain(q, k, g, u, cl, dC, dn, need)
        assert len(bwd) == 5
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(bwd, ref))
        assert bwd[0].shape == (B, nc - 1, NH, DH, DH) and bwd[1].shape == (B, nc - 1, NH, DH)
        assert (bwd[2] is None) == (not need) and bwd[4].shape == (B, S_LONG, NH, DH)
    one = mlstm.mlstm_carry_bwd(q[:, :100], k[:, :100], g[:, :100], u[:, :100], cl[:, :100],
                                dC, dn)
    assert one[0].shape[1] == one[1].shape[1] == 0 and one[2] is None and one[3] is None
    assert kernels.launch_counts() == before


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _fwd_bwd_flops(fn, b, s, nh, dh, with_state, cot_all):
    """``fn`` and its backward (a cotangent on every output, or on h alone)
    on meta leaves, C0 and n0 leaves too ``with_state`` (else None): (the
    forward's FLOPs, the backward's, the gradients), each count
    ``flop_counter``'s plus ``kernels.meta_flops()``."""
    xs = [_meta(b, s, nh, dh, dtype=torch.bfloat16, grad=True) for _ in range(3)]
    xs += [_meta(b, s, nh, grad=True), _meta(b, s, nh, grad=True)]
    xs += ([_meta(b, nh, dh, dh, grad=True), _meta(b, nh, dh, grad=True)] if with_state
           else [None, None])
    counts = []
    kernels.reset_meta_flops()
    with FlopCounterMode(display=False) as counter:
        out = fn(*xs)
    counts.append(counter.get_total_flops() + kernels.meta_flops())
    kernels.reset_meta_flops()
    live = [x for x in xs if x is not None]
    out = out if cot_all else out[:1]
    with FlopCounterMode(display=False) as counter:
        grads = torch.autograd.grad(out, live, [torch.ones_like(o) for o in out])
    counts.append(counter.get_total_flops() + kernels.meta_flops())
    return *counts, list(zip(live, grads))


def _plain_parts(q, k, v, i, logf, C0, n0):
    """The forward as two plain parts, for torch autograd to differentiate."""
    return mlstm.mlstm_carry_plain(q, k, v, i, *mlstm.mlstm_intra_terms(q, k, v, i, logf),
                                   C0, n0)


@pytest.mark.parametrize("cot_all", [True, False], ids=["h_C_n", "h"])
@pytest.mark.parametrize("s", [S_LONG, 100, 512])
@pytest.mark.parametrize("with_state", [False, True], ids=["none", "state"])
def test_meta_branches_count_the_plain_routes_flops(with_state, s, cot_all, monkeypatch):
    """On meta tensors a forward and backward through ``ops.mlstm_chunk_scan``
    (the kernels' meta branches, the torch terms counted by the counter)
    count what ``flop_counter`` counts with the wrappers swapped for their
    plain versions, with no launch and the gradients in the inputs' shapes
    and dtypes. The backward counts twice the forward (every product's two
    gradients) but the work no gradient needs: with no first state (None)
    chunk 0's update of the carry (it yields only dC0) and the read's dq on
    chunk 0 (a product with zeros); with no cotangent on the last state the
    last chunk's update's two gradients. Torch autograd through the two
    plain parts counts the same, and that one product with zeros more. The
    backward kernel's count holds its updates and its reads (k dC, dv's
    carried term), one a chunk whose leaving dC is not zero."""
    b, nh, dh = 2, 4, 32
    L, nc = mlstm._chunks(s)
    before = kernels.launch_counts()
    fwd, bwd, grads = _fwd_bwd_flops(ops.mlstm_chunk_scan, b, s, nh, dh, with_state, cot_all)
    assert kernels.launch_counts() == before
    assert all(g.is_meta and g.shape == x.shape and g.dtype == x.dtype for x, g in grads)
    product = 2 * b * L * nh * dh * dh                 # one (L, dh) x (dh, dh) a chunk
    update = product + 2 * b * L * nh * dh             # and its (L, dh) x (dh,) beside
    assert mlstm.carry_bwd_flops(b, s, nh, dh, with_state, cot_all) == (
        (nc - 1 + with_state) * update + (nc - 1 + cot_all) * product)
    skipped = (0 if with_state else update + product) + (0 if cot_all else 2 * update)
    assert bwd == 2 * fwd - skipped
    auto = _fwd_bwd_flops(_plain_parts, b, s, nh, dh, with_state, cot_all)[:2]
    assert auto == (fwd, bwd + (0 if with_state else product))
    monkeypatch.setattr(mlstm, "mlstm_carry", mlstm.mlstm_carry_plain)
    monkeypatch.setattr(mlstm, "mlstm_carry_bwd", mlstm.mlstm_carry_bwd_plain)
    assert _fwd_bwd_flops(ops.mlstm_chunk_scan, b, s, nh, dh, with_state,
                          cot_all)[:2] == (fwd, bwd)
    assert kernels.meta_flops() == 0


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_process_group

    yield fake_process_group
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dryrun_train_cell_counts_the_same_flops_on_both_routes(fake_group, monkeypatch):
    """The reduced xlstm-1.3b's small train cell of the dry run on a (1, 2)
    mesh (a mesh shape of its own), once as it runs (the mLSTM's forward and
    backward through the kernels' meta branches), once with the wrappers
    swapped for their plain versions: the same FLOPs. With
    ``ops.mlstm_chunk_scan`` routed to torch autograd through the two plain
    parts the count is larger by one product with zeros a backward call
    (the model passes no first state: autograd still multiplies chunk 0's
    cotangent by C0 = 0 for dq), and by nothing else."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    cfg = get_arch("xlstm-1.3b", reduced=True)
    shape = ShapeConfig("small", kind="train", seq_len=32, global_batch=8)
    mesh = ((1, 2), ("data", "model"))
    fake_group(2)
    zeros_products, backward = [], mlstm.mlstm_backward

    def counted(q, *args, **kwargs):
        b, s, nh, dh = q.shape
        assert args[7] is None and args[8] is None      # C0 and n0: the model passes none
        zeros_products.append(2 * b * mlstm._chunks(s)[0] * nh * dh * dh)
        return backward(q, *args, **kwargs)

    monkeypatch.setattr(mlstm, "mlstm_backward", counted)
    kernel = run_cell(cfg, shape, *mesh)
    tallied = mlstm.meta_flops           # the cell's run resets the tally first
    gap, zeros_products[:] = sum(zeros_products), []
    monkeypatch.setattr(mlstm, "mlstm_carry", mlstm.mlstm_carry_plain)
    monkeypatch.setattr(mlstm, "mlstm_carry_bwd", mlstm.mlstm_carry_bwd_plain)
    plain = run_cell(cfg, shape, *mesh)
    assert tallied > 0 and mlstm.meta_flops == 0 and gap > 0 and sum(zeros_products) == gap
    assert kernel["cost"]["flops"] == plain["cost"]["flops"] > 0
    monkeypatch.setattr(ops, "mlstm_chunk_scan", _plain_parts)
    loop = run_cell(cfg, shape, *mesh)
    assert loop["cost"]["flops"] == kernel["cost"]["flops"] + gap


def test_plan_bwd_at_the_paths_shapes_and_the_exported_symbol():
    """The backward's grid is the forward's (32 columns of dC a block, B x 4
    x 32 blocks at xlstm-1.3b's 4 heads of 1024); its shared memory holds,
    on the mma route (bf16), the ring's two stages of q and k slices, dC^T's
    columns, dn, four bf16 tiles of dC's slices, u, the partial sums and the
    mbarriers: 214,560 bytes, 83,616 at the reduced config's dh 32; on the
    SIMT route (fp32) dC^T, dn, a staged slice of q and of k, g's columns,
    u and the partial sums: 205,312; the tests' dh 8 the whole head. The
    source exports the symbol with the wrapper's argument types."""
    assert mlstm.plan_bwd(4, 4, 1024, 2) == (32, 512, 214560)
    assert mlstm.plan_bwd(4, 4, 1024, 4) == (32, 512, 205312)
    assert mlstm.plan_bwd(2, 4, 32, 2) == (32, 8, 83616)
    assert mlstm.plan_bwd(1, 2, 8, 4)[:2] == (8, 2)
    with pytest.raises(ValueError, match="mlstm_carry_bwd: head dim"):
        mlstm.plan_bwd(1, 4, 48, 2)
    with pytest.raises(ValueError, match="shared memory"):
        mlstm.plan_bwd(1, 4, 2048, 2)
    text = (_build.CSRC / "mlstm_scan_bwd.cu").read_text()
    symbol, argtypes = mlstm.KERNEL_BWD
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"mlstm_scan_bwd.cu does not export {symbol}"
    declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (p.strip() for p in found.group(1).split(","))]
    assert declared == argtypes
    assert '#include "mlstm.cuh"' in text
