"""The port's training path against the reference on the CPU.

The same seeded numpy inputs (and the reference's own initial params,
carried over as numpy) go through the JAX function and its port:

- the flash backward (the recompute VJP of ``flash_attention_xla``, and
  K1's autograd function, which on the CPU runs K1's plain forward) against
  ``jax.grad`` of ``flash_attention_xla``: fp32 within 1e-5 abs / 1e-4 rel
  (``tests/test_kernels.py::test_xla_flash_fwd_bwd_vs_naive``), bf16 within
  2e-2;
- K2's backward function against ``jax.vjp`` of the reference's
  ``rms_norm``: 2e-2 in bf16 (the kernel rounds once, the reference twice),
  1e-5 in fp32;
- the cross entropy and its ``dlogits`` (dtype kept);
- ``loss_fn`` and per-leaf grads of the reduced configs: relative L2 <= 1e-5
  with fp32 activations, <= 3e-2 with bf16, remat on and off;
- ``lr_schedule`` and 10 AdamW + clip steps within 1e-6 relative in fp32;
- the single-device GSPMD step (with and without microbatches) over three
  steps;
- ``SyntheticLM`` batches, byte for byte; the driver end to end.
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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.models import common as jc
from repro.models import transformer as jtr
from repro.models.registry import count_params as jax_count_params
from repro.train import optimizer as jopt
from repro.train.step import gspmd_init_state as jax_gspmd_init
from repro.train.step import make_gspmd_train_step as jax_gspmd_step
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, local_rows
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import common as tc
from repro_torch.models.registry import count_params, leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.step import (
    gspmd_init_state,
    make_gspmd_train_step,
    make_themis_train_step,
    trainable,
)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARCHS = ["qwen2.5-3b", "llama3-8b"]
# qwen2.5-14b: GQA 40/8 with QKV bias; granite-34b: MQA (kv 1) and the
# non-gated GELU-tanh MLP
DENSE_ARCHS = ARCHS + ["qwen2.5-14b", "granite-34b"]


def _arr(rng, shape, dtype="float32", scale=1.0):
    j = jnp.asarray(rng.standard_normal(shape) * scale, DTYPES[dtype])
    return j, bridge.params_from_jax(np.asarray(j), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _params_close(got, want, init, lr):
    """Params after AdamW steps of two implementations: per leaf, the L2 of
    their difference within 1e-2 of the L2 of the update, and every element
    within 0.1 lr. AdamW divides each gradient element by its own RMS, so an
    element whose gradient is near eps = 1e-8 (qwen2.5-3b's k bias and k/gate
    weights have some) carries the fp32 rounding of its sum (about 1e-9
    there) into its update at full scale: up to 0.035 lr over three steps
    on the CPU, 0.3% of the k bias's update."""
    for a, b, c in zip(leaves(got), leaves(want), leaves(init)):
        a, b, c = _np(a), _np(b), _np(c)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - c)
        assert np.abs(a - b).max() <= 0.1 * lr


def _close(got, want, dtype, fp32=(1e-5, 1e-4)):
    atol, rtol = fp32 if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def test_train_and_parallel_configs_match_reference():
    for t, j in ((TrainConfig(), JTrainConfig()),
                 (ParallelConfig(), JParallelConfig())):
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}


# -- flash backward -----------------------------------------------------------
FLASH_CASES = [(4, 2, 0), (4, 2, 16), (4, 1, 0), (4, 1, 16)]   # h, kv, window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,window", FLASH_CASES,
                         ids=["gqa", "gqa-w16", "mqa", "mqa-w16"])
@pytest.mark.parametrize("path", ["xla_flash", "k1_autograd"])
def test_flash_backward_matches_reference(path, h, kv, window, dtype):
    """The tests/test_kernels.py shape (2,100,·,32), blocks of 32, and a
    random cotangent. ``k1_autograd`` is ``ops.flash_attention``, the
    autograd function around K1, whose forward and backward on a CPU tensor
    are K1's plain versions: no kernel is launched."""
    reset_launch_counts()
    rng = np.random.default_rng(3)
    (jq, q), (jk, k), (jv, v) = (_arr(rng, (2, 100, n, 32), dtype)
                                 for n in (h, kv, kv))
    jg, g = _arr(rng, (2, 100, h, 32), dtype)

    def jf(a, b, c):
        return jc.flash_attention_xla(a, b, c, causal=True, window=window,
                                      block_q=32, block_k=32)

    want_out, vjp = jax.vjp(jf, jq, jk, jv)
    want = vjp(jg)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    if path == "xla_flash":
        out = tc.flash_attention_xla(q, k, v, causal=True, window=window,
                                     block_q=32, block_k=32)
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    _close(out, want_out, dtype, (5e-6, 5e-5))
    for x, y, ref in zip(got, want, (q, k, v)):
        assert x.dtype == ref.dtype
        _close(x, y, dtype)
    assert set(launch_counts().values()) == {0}, launch_counts()


def test_flash_backward_pads_ragged_blocks_and_offsets():
    """S and T not multiples of the blocks, and a q offset (the decode-style
    chunk that ``ops.flash_attention`` sends to the blockwise path)."""
    rng = np.random.default_rng(4)
    (jq, q), (jk, k), (jv, v) = (_arr(rng, s) for s in
                                 ((1, 37, 4, 16), (1, 61, 2, 16), (1, 61, 2, 16)))
    jg, g = _arr(rng, (1, 37, 4, 16))
    want = jax.vjp(lambda a, b, c: jc.flash_attention_xla(
        a, b, c, causal=True, window=8, q_offset=24, block_q=16, block_k=32),
        jq, jk, jv)[1](jg)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=True, window=8, q_offset=24)
    got = torch.autograd.grad(out, (q, k, v), g)
    for x, y in zip(got, want):
        _close(x, y, "float32")


# -- K2 backward ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 128), (7, 384), (2, 16, 2048)])
def test_rmsnorm_backward_matches_reference_vjp(shape, dtype):
    rng = np.random.default_rng(5)
    jx, x = _arr(rng, shape, dtype)
    jw, w = _arr(rng, shape[-1:], dtype)
    jdy, dy = _arr(rng, shape, dtype)
    _, vjp = jax.vjp(lambda a, b: jc.rms_norm(a, b, 1e-6), jx, jw)
    want_dx, want_dw = vjp(jdy)
    dx, dw = trn.rmsnorm_backward(x, w, dy, 1e-6)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx, want_dx, dtype)
    # dw sums every row: compare relative to its size
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_l2(dw, want_dw) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_autograd_function_matches_plain_autograd(dtype):
    """``ops.rmsnorm``, the autograd function around K2 (on the CPU its
    forward is K2's plain version), against PyTorch's autograd through the
    plain version."""
    rng = np.random.default_rng(6)
    _, x = _arr(rng, (3, 20, 64), dtype)
    _, w = _arr(rng, (64,), "float32")
    _, dy = _arr(rng, (3, 20, 64), dtype)
    x.requires_grad_(True)
    w.requires_grad_(True)
    got = torch.autograd.grad(ops.rmsnorm(x, w, 1e-6), (x, w), dy)
    want = torch.autograd.grad(trn.rmsnorm_plain(x, w, 1e-6), (x, w), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5 if dtype == "float32"
                                   else 2e-2, rtol=1e-5 if dtype == "float32"
                                   else 2e-2)


# -- cross entropy --------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked, dtype):
    rng = np.random.default_rng(7)
    jl, logits = _arr(rng, (2, 9, 300), dtype, scale=3.0)
    labels = rng.integers(0, 300, (2, 9))
    mask = (rng.random((2, 9)) > 0.3) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.as_tensor(mask)
    want, vjp = jax.vjp(lambda a: jc.cross_entropy(
        a, jnp.asarray(labels, jnp.int32), jmask), jl)
    (want_d,) = vjp(jnp.ones((), jnp.float32) * 1.5)
    logits.requires_grad_(True)
    got = tc.cross_entropy(logits, torch.as_tensor(labels, dtype=torch.int32),
                           tmask)
    (got_d,) = torch.autograd.grad(got, logits, torch.tensor(1.5))
    assert got.dtype == torch.float32 and got_d.dtype == logits.dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _close(got_d, want_d, dtype, (1e-7, 1e-5))


# -- model: loss and grads ------------------------------------------------------
def _model_pair(arch, dtype, remat, seed=0):
    """``remat``: False, True (policy "full") or "dots"."""
    kw = dict(dtype=dtype, remat=bool(remat))
    if remat == "dots":
        kw["remat_policy"] = "dots"
    jcfg = jax_get_arch(arch, reduced=True).replace(**kw)
    tcfg = get_arch(arch, reduced=True).replace(**kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(seed))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("remat", [False, True, "dots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, remat):
    """Loss and every leaf's gradient, relative L2: 1e-5 with fp32
    activations; 3e-2 with bf16, or for a leaf where the reference's own
    bf16 gradient lies farther than that from its fp32 gradient, that
    distance (the bf16 rounding of the reference itself: qwen2.5-3b's
    ``bk``, a sum of dk over every token, has 0.042). Remat off, "full"
    and "dots" (the reference under its own "dots" policy)."""
    jcfg, tcfg, jparams, tparams = _model_pair(arch, dtype, remat)
    batch = _batch(jcfg.vocab_size, 2, 24)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jax_build_model(jcfg).loss_fn)(
        jparams, jbatch)
    jleaves = jax.tree.leaves(jgrads)
    tol = [1e-5] * len(jleaves)
    if dtype == "bfloat16":
        j32 = jax.grad(jax_build_model(jcfg.replace(dtype="float32")).loss_fn)(
            jparams, jbatch)
        tol = [max(3e-2, _rel_l2(a, b)) for a, b in zip(jleaves,
                                                       jax.tree.leaves(j32))]
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    loss = build_model(tcfg).loss_fn(
        tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ps)
    assert abs(loss.item() - float(jloss)) <= min(tol) * abs(float(jloss))
    assert len(jleaves) == len(grads)
    for g, jg, p, t in zip(grads, jleaves, ps, tol):
        assert g.shape == tuple(jg.shape) and g.dtype == p.dtype
        assert _rel_l2(g, jg) <= t


def test_remat_recomputes_the_same_grads():
    _, tcfg, _, tparams = _model_pair("qwen2.5-3b", "float32", False)
    batch = {k: torch.as_tensor(v) for k, v in _batch(256, 2, 16).items()}
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    out = []
    for remat in (False, True):
        api = build_model(tcfg.replace(remat=remat))
        out.append(torch.autograd.grad(api.loss_fn(tparams, batch), ps))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-34b"])
def test_remat_dots_grads_equal_full_to_the_bit(arch, dtype):
    """Remat "dots" hands the backward the matmul outputs that "full"
    recomputes, the same bits: loss and every gradient equal to the bit."""
    _, tcfg, _, tparams = _model_pair(arch, dtype, True)
    batch = {k: torch.as_tensor(v) for k, v in _batch(256, 2, 16).items()}
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    out = []
    for policy in ("full", "dots"):
        loss = build_model(tcfg.replace(remat_policy=policy)).loss_fn(tparams, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    (full_loss, full), (dots_loss, dots) = out
    assert torch.equal(full_loss, dots_loss)
    assert all(torch.equal(a, b) for a, b in zip(full, dots))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-34b"])
def test_remat_dots_saves_the_reference_residuals(arch, dtype, monkeypatch):
    """What each checkpointed block keeps under "dots", as a multiset of
    shapes: the reference's residuals (``saved_residuals`` of one
    ``jax.checkpoint``-ed block under ``dots_with_no_batch_dims_saveable``:
    q, k, v, the attention output projection, the MLP's input projections)
    and the output of the MLP's ``wo`` beside them, which the reference's
    XLA drops since its backward never reads it (it only enters the
    residual add) and the port's selective checkpoint keeps (it saves every
    matmul output). One such set per layer, none of the head's matmul."""
    jcfg, tcfg, jparams, tparams = _model_pair(arch, dtype, "dots")
    b, s = 2, 16
    x = jnp.ones((b, s, jcfg.d_model), DTYPES[dtype])
    block = jax.checkpoint(
        functools.partial(jtr.apply_block, cfg=jcfg, positions=jnp.arange(s)),
        policy=jc.remat_policy(jcfg))
    p0 = jax.tree.map(lambda a: a[0], jparams["blocks"])
    want = saved_by_reference(lambda p, x: block(p, x)[0], p0, x)
    want = (want + [(b * s, jcfg.d_model, dtype)]) * jcfg.num_layers
    saved = saved_by_port(monkeypatch)
    batch = {k: torch.as_tensor(v) for k, v in _batch(256, b, s).items()}
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    torch.autograd.grad(build_model(tcfg).loss_fn(tparams, batch), ps)
    assert sorted(saved) == sorted(want)


@pytest.mark.parametrize("policy", ["full", "none", "no-such-policy", "dots"])
def test_remat_policy_names_follow_reference(policy):
    """Every ``remat_policy`` name but "dots" means full remat, in the
    reference (``repro/models/common.py::remat_policy``) and in the port;
    "dots" saves the projections' outputs in both. The port's loss and
    grads under ``policy`` equal its "full" policy's to the bit (a saved
    output is the bits a recompute would give), and the reference agrees
    within 1e-5 relative L2 (fp32 activations)."""
    jcfg, tcfg, jparams, tparams = _model_pair("qwen2.5-3b", "float32", True)
    jcfg, tcfg = (c.replace(remat_policy=policy) for c in (jcfg, tcfg))
    full = policy != "dots"
    assert (jc.remat_policy(jcfg) is None) == (tc.remat_policy(tcfg) is None) == full
    batch = _batch(jcfg.vocab_size, 2, 16)
    jloss, jgrads = jax.value_and_grad(jax_build_model(jcfg).loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    out = []
    for cfg in (tcfg, tcfg.replace(remat_policy="full")):
        loss = build_model(cfg).loss_fn(tparams, tbatch)
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    (loss, grads), (full_loss, full_grads) = out
    assert torch.equal(loss, full_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, full_grads))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        assert _rel_l2(g, jg) <= 1e-5


@pytest.mark.parametrize("arch", DENSE_ARCHS + ["recurrentgemma-2b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_spec_and_count_match_reference(arch, reduced):
    jspec = jax_build_model(jax_get_arch(arch, reduced=reduced)).param_spec()
    spec = build_model(get_arch(arch, reduced=reduced)).param_spec()
    assert count_params(spec) == jax_count_params(jspec)
    assert all(x.device.type == "meta" for x in leaves(spec))
    assert [tuple(x.shape) for x in leaves(spec)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jspec)]


# -- optimizer ------------------------------------------------------------------
def test_lr_schedule_matches_reference():
    for cfg in (TrainConfig(), TrainConfig(warmup_steps=3, total_steps=20,
                                           learning_rate=1e-2)):
        jcfg = JTrainConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})
        for step in range(0, cfg.total_steps + 5):
            want = float(jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
            assert topt.lr_schedule(cfg, step) == pytest.approx(want, rel=1e-6,
                                                                abs=1e-12)


def test_adamw_and_clip_match_reference_over_ten_steps():
    rng = np.random.default_rng(8)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}

    def tree(f):
        return {k: tree_of(v, f) for k, v in shapes.items()}

    def tree_of(v, f):
        return {k: tree_of(x, f) for k, x in v.items()} if isinstance(v, dict) \
            else f(v)

    jparams = tree(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    cfg = TrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2,
                      grad_clip=2.0)
    jcfg = JTrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2,
                        grad_clip=2.0)
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(tparams)
    for i in range(10):
        scale = 0.2 if i % 2 else 3.0     # clip on every other step
        jg = tree(lambda s: jnp.asarray(rng.standard_normal(s) * scale,
                                        jnp.float32))
        tg = bridge.params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        jg, jnorm = jopt.clip_by_global_norm(jg, jcfg.grad_clip)
        jparams, jstate, jlr = jopt.adamw_update(jg, jstate, jparams, jcfg)
        tnorm = topt.clip_by_global_norm(tg, cfg.grad_clip)
        tlr = topt.adamw_update(tg, tstate, tparams, cfg)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        assert tlr == pytest.approx(float(jlr), rel=1e-6)
    assert tstate["count"] == int(jstate["count"]) == 10
    for name, t, j in (("params", tparams, jparams), ("m", tstate["m"], jstate["m"]),
                       ("v", tstate["v"], jstate["v"])):
        # 1e-6 of each leaf's scale: m and v sum ten clipped steps whose
        # clip scales differ in the last bit (norms summed in another order)
        for a, b in zip(leaves(t), jax.tree.leaves(j)):
            b = _np(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=name)


# -- steps ------------------------------------------------------------------------
@pytest.mark.parametrize("microbatch", [0, 2])
def test_gspmd_step_matches_reference(microbatch):
    """Three single-device steps of reduced qwen2.5-3b with fp32
    activations: losses and gnorms within 1e-5 relative, params as
    ``_params_close`` states."""
    arch, dtype = "qwen2.5-3b", "float32"
    jcfg, tcfg, _, _ = _model_pair(arch, dtype, False)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                 microbatch=microbatch)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jstep, *_ = jax_gspmd_step(jmodel, mesh, JParallelConfig(), JTrainConfig(**train))
    jparams, jopt_state = jax_gspmd_init(jmodel, mesh, JParallelConfig())
    init = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tstep = make_gspmd_train_step(tmodel, None, ParallelConfig(), TrainConfig(**train))
    _, topt_state = gspmd_init_state(tmodel, None, ParallelConfig(), device="cpu")
    tparams = trainable(tparams)
    for i in range(3):
        batch = _batch(jcfg.vocab_size, 4, 16, seed=i)
        jparams, jopt_state, jm = jstep(jparams, jopt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, topt_state, tm = tstep(
            tparams, topt_state, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _params_close(tparams, jax.tree.leaves(jparams), init, 1e-3)


def test_themis_step_on_one_rank_matches_gspmd_step():
    """The reference's Themis step raises on a one-device mesh; the port's
    issues no collective there and computes what the GSPMD step computes."""
    from repro_torch.launch.mesh import Mesh

    cfg = get_arch("qwen2.5-3b", reduced=True).replace(dtype="float32",
                                                      remat=False)
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
        batch = {k: torch.as_tensor(v) for k, v in _batch(256, 4, 16, i).items()}
        pt, ot, mt = step_t(pt, ot, batch)
        pg, og, mg = step_g(pg, og, batch)
        assert float(mt["loss"]) == pytest.approx(float(mg["loss"]), rel=1e-6)
        assert float(mt["gnorm"]) == pytest.approx(float(mg["gnorm"]), rel=1e-5)
    _params_close(pt, pg, init, 1e-3)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


# -- data and driver --------------------------------------------------------------
def test_synthetic_batches_are_byte_equal():
    for seed, step in ((0, 0), (3, 17)):
        a = SyntheticLM(1000, 8, 33, seed=seed).batch_at(step)
        b = JSyntheticLM(1000, 8, 33, seed=seed).batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


class _FakeMesh:
    """Coordinates of one rank of a (pod 2, data 2, model 2) mesh."""

    def __init__(self, pod, data, model):
        self.size = 8
        self.coords = {"pod": pod, "data": data, "model": model}

    def axis_size(self, axis):
        return 2

    def local_rank(self, axis):
        return self.coords[axis]

    def block_index(self, axes):
        from repro_torch.launch.mesh import Mesh

        return Mesh.block_index(self, axes)


def test_local_rows_follow_the_reference_batch_spec():
    """P(("model","data","pod")): rank (p, d, m) takes block m*4 + d*2 + p."""
    batch = SyntheticLM(50, 16, 4).batch_at(0)
    seen = []
    for p in range(2):
        for d in range(2):
            for m in range(2):
                rows = local_rows(batch, _FakeMesh(p, d, m))["tokens"]
                blk = m * 4 + d * 2 + p
                assert np.array_equal(rows, batch["tokens"][2 * blk:2 * blk + 2])
                seen.append(blk)
    assert sorted(seen) == list(range(8))


def test_prefetcher_serves_the_stream_in_order():
    ds = SyntheticLM(100, 4, 8, seed=2)
    pf = Prefetcher(ds, None, "cpu", start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = next(pf)
            assert step == want
            assert batch["tokens"].numpy().tobytes() == \
                ds.batch_at(want)["tokens"].tobytes()
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    pf = Prefetcher(ds, None, "cpu", fixed_step=0)
    try:
        b0, b1 = next(pf)[1], next(pf)[1]
        assert torch.equal(b0["tokens"], b1["tokens"])
    finally:
        pf.close()


def test_opt_state_from_jax_takes_this_ranks_blocks():
    opt = {"master": np.arange(24, dtype=np.float32).reshape(2, 12),
           "m": np.zeros((2, 12), np.float32), "v": np.ones((2, 12), np.float32),
           "count": np.asarray(3, np.int32),
           "err": np.arange(40, dtype=np.float32).reshape(4, 10)}
    got = bridge.opt_state_from_jax(opt, "cpu", block=(1, 4))
    assert got["count"] == 3
    assert got["master"].tolist() == [[3, 4, 5], [15, 16, 17]]
    assert got["err"].tolist() == list(range(10, 20))
    full = bridge.opt_state_from_jax({"m": {"w": np.ones(3, np.float32)},
                                      "v": {"w": np.ones(3, np.float32)},
                                      "count": 0}, "cpu")
    assert full["m"]["w"].shape == (3,) and full["count"] == 0


@pytest.mark.parametrize("dp_sync", ["gspmd", "themis", "hier_baseline"])
def test_launch_train_end_to_end_on_cpu(dp_sync, capsys):
    res = ttrain.main(["--reduced", "--arch", "qwen2.5-3b", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--dp-sync", dp_sync,
                       "--fixed-batch", "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert "step     3 loss=" in out and "gnorm=" in out and "lr=" in out
    assert res["peak_mem_bytes"] is None
    if dp_sync != "gspmd":
        assert "themis chunk orders (16 chunks)" in out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
def test_launch_train_remat_dots_trains_as_full(arch, capsys):
    """``--remat-policy dots`` through ``launch/train.py``: the same losses and
    params as "full", to the bit, over three steps."""
    argv = ["--reduced", "--arch", arch, "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "40", "--fixed-batch", "--lr", "1e-2"]
    full, dots = (ttrain.main(argv + ["--remat-policy", p]) for p in ("full", "dots"))
    out = capsys.readouterr().out
    assert "remat=full" in out and "remat=dots" in out
    assert dots["cfg"].remat_policy == "dots" and dots["losses"] == full["losses"]
    assert all(torch.equal(a, b) for a, b in zip(leaves(dots["params"]),
                                                 leaves(full["params"])))
