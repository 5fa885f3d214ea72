"""The port's hybrid (recurrentgemma) training path against the reference on
the CPU.

The same seeded numpy inputs (and the reference's own initial params,
carried over as numpy) go through the JAX function and its port:

- K3's backward, ``ops.rglru_scan`` differentiated by autograd (on the CPU
  its forward and backward are the plain versions), against ``jax.vjp`` of
  ``repro.kernels.ref.rglru_scan_ref`` and against autograd through
  ``rglru_scan_plain``: da, db and dh0 within 1e-5 abs and rel (the scan's
  tolerance, ``tests/test_kernels.py``);
- the reduced recurrentgemma-2b's loss and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` at batch 2 x 40,
  past the reduced window of 32, remat off, "full" and "dots": fp32 within
  1e-5 relative L2 per leaf; bf16 within the bound ``_bf16_bounds`` states;
- remat against no remat, to the bit in fp32, and "dots" against "full" to
  the bit; the tensors "dots" keeps against the reference's residuals;
- three GSPMD steps against the reference's, the one-rank Themis step
  against the GSPMD step, and ``launch.train`` end to end.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _remat_residuals import saved_by_port, saved_by_reference
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.kernels.ref import rglru_scan_ref
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.models import common as jc
from repro.models import recurrent as jrec
from repro.train.step import gspmd_init_state as jax_gspmd_init
from repro.train.step import make_gspmd_train_step as jax_gspmd_step
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
from repro_torch.kernels import _build, launch_counts, ops, reset_launch_counts
from repro_torch.kernels import rglru as trg
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.registry import leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (
    make_gspmd_train_step,
    make_themis_train_step,
    trainable,
)

ARCH = "recurrentgemma-2b"
SCAN_TOL = 1e-5
SCAN_SHAPES = [(2, 100, 96), (1, 257, 64), (3, 16, 300), (2, 1, 8)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _params_close(got, want, init, lr):
    """As ``tests/test_torch_train.py``: per leaf, the L2 of the difference
    within 1e-2 of the L2 of the update, every element within 0.1 lr."""
    for a, b, c in zip(leaves(got), leaves(want), leaves(init)):
        a, b, c = _np(a), _np(b), _np(c)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - c)
        assert np.abs(a - b).max() <= 0.1 * lr


# -- K3's backward ------------------------------------------------------------------
def _scan_inputs(shape, with_h0, seed=31):
    """a in [0, 0.999), b, h0 and the cotangent g normal, as numpy fp32."""
    rng = np.random.default_rng(seed)
    b, s, c = shape
    a = (rng.random(shape) * 0.999).astype(np.float32)
    bb, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, c)).astype(np.float32) if with_h0 else None
    return a, bb, h0, g


def _torch_grads(fn, a, bb, h0, g):
    ins = [torch.tensor(x, requires_grad=True) for x in (a, bb) + (
        () if h0 is None else (h0,))]
    out = fn(*ins)
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_rglru_scan_backward_matches_reference_vjp(shape, with_h0):
    reset_launch_counts()
    a, bb, h0, g = _scan_inputs(shape, with_h0)
    jins = [jnp.asarray(x) for x in (a, bb) + (() if h0 is None else (h0,))]
    _, vjp = jax.vjp(rglru_scan_ref, *jins)
    want = vjp(jnp.asarray(g))
    got = _torch_grads(ops.rglru_scan, a, bb, h0, g)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(_np(x), _np(y), atol=SCAN_TOL, rtol=SCAN_TOL)
    assert set(launch_counts().values()) == {0}, launch_counts()


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_rglru_scan_backward_matches_autograd_through_plain(shape, with_h0):
    """The reverse loop (``rglru_scan_backward_plain``, each step a product
    then a sum) against PyTorch's autograd through the forward loop."""
    a, bb, h0, g = _scan_inputs(shape, with_h0, seed=32)
    got = _torch_grads(ops.rglru_scan, a, bb, h0, g)
    want = _torch_grads(trg.rglru_scan_plain, a, bb, h0, g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), _np(y), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_rglru_scan_backward_wrappers_on_cpu_and_elsewhere():
    """On a CPU tensor the wrapper is the plain version, to the bit; on a
    tensor that is neither on the CPU nor on a card it raises."""
    a, bb, h0, g = (torch.from_numpy(x) for x in _scan_inputs((2, 9, 5), True))
    h = trg.rglru_scan(a, bb, h0)
    got = trg.rglru_scan_backward(a, h, g, h0)
    want = trg.rglru_scan_backward_plain(a, h, g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    da, db, dh0 = trg.rglru_scan_backward(a, h, g)
    assert dh0 is None and torch.equal(db, want[1])
    m = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        trg.rglru_scan_backward(m, m, m)


@pytest.mark.parametrize("which", sorted(trg.KERNELS))
def test_rglru_source_exports_the_symbols_the_wrapper_binds(which):
    import ctypes
    import re

    symbol, argtypes = trg.KERNELS[which]
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"rglru_scan.cu does not export {symbol}"
    params = [p.strip() for p in found.group(1).split(",")]
    declared = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert declared == argtypes


# -- model: loss and grads ------------------------------------------------------
def _model_pair(dtype, remat, seed=0):
    """``remat``: False, True (policy "full") or "dots"."""
    kw = dict(dtype=dtype, remat=bool(remat))
    if remat == "dots":
        kw["remat_policy"] = "dots"
    jcfg = jax_get_arch(ARCH, reduced=True).replace(**kw)
    tcfg = get_arch(ARCH, reduced=True).replace(**kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(seed))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(b, s, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _port_loss_and_grads(tcfg, tparams, batch):
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    loss = build_model(tcfg).loss_fn(
        tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, ps), ps


def _bf16_bounds(gap):
    """Per-leaf bounds of the port's bf16 gradient, from the reference's own
    bf16-to-fp32 gap g of the leaf (3.4-6.8% on this config at 2 x 40
    tokens).

    Both sides round their bf16 gradient about g away from the fp32
    gradient, and independently (the frameworks round bf16 matmuls and
    fused elementwise chains at different places): two such gradients lie
    within 2 g of each other, and here 5 of the 59 leaves lie between g and
    1.47 g apart. So the port's bf16 gradient is held within
    max(3e-2, 2 g) of the reference's bf16 gradient and, tighter, within
    max(3e-2, 1.5 g) of the reference's fp32 gradient: as close to it as
    the reference's own bf16 gradient (the ratio reads 0.74-1.24), with
    room."""
    return max(3e-2, 2 * gap), max(3e-2, 1.5 * gap)


@pytest.mark.parametrize("remat", [False, True, "dots"],
                         ids=["no-remat", "remat", "remat-dots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_loss_and_grads_match_reference(dtype, remat):
    """Remat off, "full" and "dots" (the reference under its own "dots"
    policy)."""
    reset_launch_counts()
    jcfg, tcfg, jparams, tparams = _model_pair(dtype, remat)
    batch = _batch(2, 40)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn))(
        jparams, jbatch)
    jleaves = jax.tree.leaves(jgrads)
    loss, grads, ps = _port_loss_and_grads(tcfg, tparams, batch)
    assert len(grads) == len(jleaves)
    for g, jg, p in zip(grads, jleaves, ps):
        assert g.shape == tuple(jg.shape) and g.dtype == p.dtype
    if dtype == "float32":
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
        for g, jg in zip(grads, jleaves):
            assert _rel_l2(g, jg) <= 1e-5
    else:
        j32 = jax.tree.leaves(jax.jit(jax.grad(jax_build_model(
            jcfg.replace(dtype="float32")).loss_fn))(jparams, jbatch))
        gaps = [_rel_l2(a, b) for a, b in zip(jleaves, j32)]
        assert abs(loss.item() - float(jloss)) <= 3e-2 * abs(float(jloss))
        for g, jg, g32, gap in zip(grads, jleaves, j32, gaps):
            to_bf16, to_fp32 = _bf16_bounds(gap)
            assert _rel_l2(g, jg) <= to_bf16
            assert _rel_l2(g, g32) <= to_fp32
    assert set(launch_counts().values()) == {0}, launch_counts()


def test_hybrid_remat_recomputes_the_same_grads():
    _, tcfg, _, tparams = _model_pair("float32", False)
    batch = _batch(2, 40, seed=1)
    out = [_port_loss_and_grads(tcfg.replace(remat=r), tparams, batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_remat_dots_grads_equal_full_to_the_bit(dtype):
    """Remat "dots" per period hands the backward the matmul outputs that
    "full" recomputes (the gate math, the conv and the scan run again in
    both): loss and every gradient equal to the bit."""
    _, tcfg, _, tparams = _model_pair(dtype, True)
    batch = _batch(2, 40, seed=2)
    full, dots = (_port_loss_and_grads(tcfg.replace(remat_policy=p), tparams, batch)
                  for p in ("full", "dots"))
    assert torch.equal(full[0], dots[0])
    assert all(torch.equal(a, b) for a, b in zip(full[1], dots[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_remat_dots_saves_the_reference_residuals(dtype, monkeypatch):
    """What each checkpointed period (rec, rec, attn) keeps under "dots", as
    a multiset of shapes: the reference's residuals for one
    ``jax.checkpoint``-ed period (``linear_y``, ``linear_x``, both gates and
    ``linear_out`` of each RG-LRU block, q, k, v and the output projection
    of the attention block, every MLP's input projections and the ``wo`` of
    the first two, which the next block's norm reads), and beside them the
    last block's MLP ``wo``, which the reference's XLA drops and the port
    keeps (see ``test_torch_train.py``). Nothing of the two tail blocks,
    which are not checkpointed."""
    jcfg, tcfg, jparams, tparams = _model_pair(dtype, True)
    jcfg, tcfg = (c.replace(remat_policy="dots") for c in (jcfg, tcfg))
    b, s = 2, 40
    x = jnp.ones((b, s, jcfg.d_model), jnp.dtype(dtype))
    period = jax.checkpoint(
        functools.partial(jrec._apply_period, cfg=jcfg, positions=jnp.arange(s)),
        policy=jc.remat_policy(jcfg))
    p0 = jax.tree.map(lambda a: a[0], jparams["periods"])
    want = saved_by_reference(lambda p, x: period(p, x)[0], p0, x)
    n_periods = jcfg.num_layers // len(jcfg.block_pattern)
    want = (want + [(b * s, jcfg.d_model, dtype)]) * n_periods
    saved = saved_by_port(monkeypatch)
    _port_loss_and_grads(tcfg, tparams, _batch(b, s))
    assert sorted(saved) == sorted(want)


# -- steps ------------------------------------------------------------------------
@pytest.mark.slow
def test_hybrid_gspmd_step_matches_reference():
    """Three single-device steps of reduced recurrentgemma-2b with fp32
    activations over 40-token batches: losses and gnorms within 1e-5
    relative, params as ``_params_close`` states."""
    jcfg, tcfg, _, _ = _model_pair("float32", False)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jstep, *_ = jax_gspmd_step(jmodel, mesh, JParallelConfig(), JTrainConfig(**train))
    jparams, jopt_state = jax_gspmd_init(jmodel, mesh, JParallelConfig())
    init = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    tparams = trainable(bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    tstep = make_gspmd_train_step(tmodel, None, ParallelConfig(), TrainConfig(**train))
    topt_state = topt.adamw_init(tparams)
    for i in range(3):
        batch = _batch(2, 40, seed=10 + i)
        jparams, jopt_state, jm = jstep(jparams, jopt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, topt_state, tm = tstep(
            tparams, topt_state, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _params_close(tparams, jax.tree.leaves(jparams), init, 1e-3)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def test_hybrid_themis_step_on_one_rank_matches_gspmd_step():
    """The port's one-rank Themis step (no collective) computes what its
    GSPMD step computes for the hybrid family, whose params hold a list
    (the tail) beside the stacked periods."""
    cfg = get_arch(ARCH, reduced=True).replace(dtype="float32", remat=False)
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = Mesh((1, 1), ("data", "model"), "cpu")
    step_t, init_t, orders = make_themis_train_step(
        api, mesh, ParallelConfig(dp_sync="themis", chunks_per_collective=5), tcfg)
    assert orders == [()] * 5
    pt, ot = init_t(0, "cpu")
    pg, init = _clone(pt), _clone(pt)
    step_g = make_gspmd_train_step(api, mesh, ParallelConfig(), tcfg)
    og = topt.adamw_init(pg)
    for i in range(2):
        batch = {k: torch.as_tensor(v) for k, v in _batch(2, 40, seed=20 + i).items()}
        pt, ot, mt = step_t(pt, ot, batch)
        pg, og, mg = step_g(pg, og, batch)
        assert float(mt["loss"]) == pytest.approx(float(mg["loss"]), rel=1e-6)
        assert float(mt["gnorm"]) == pytest.approx(float(mg["gnorm"]), rel=1e-5)
    _params_close(pt, pg, init, 1e-3)


@pytest.mark.parametrize("dp_sync", ["gspmd", "themis"])
def test_launch_train_hybrid_end_to_end_on_cpu(dp_sync, capsys):
    res = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "40",
                       "--log-every", "1", "--dp-sync", dp_sync,
                       "--fixed-batch", "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert f"[train] {ARCH} layers=5 reduced=True" in out
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert res["cfg"].family == "hybrid" and isinstance(res["params"]["tail"], list)
