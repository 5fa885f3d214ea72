"""Shared helpers of the port's model-family tests (``tests/test_torch_{moe,
vlm, whisper, xlstm}.py``): reduced configs of both packages, the
reference's params moved into the port through numpy, and the checks every
family runs the same way (configs field for field, init shapes and scales,
loss and gradients against ``jax.value_and_grad``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models.registry import leaves

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ZERO_LAUNCHES = {"flash_attention": 0, "rmsnorm": 0, "rglru_scan": 0,
                 "slstm_scan": 0, "flash_attention_sm90": 0, "flash_attention_bwd": 0,
                 "flash_attention_bwd_sm90": 0, "rmsnorm_bwd": 0,
                 "rglru_scan_bwd": 0}


def cfgs(arch, dtype="float32", **kw):
    """The reduced config of both packages, remat off unless ``kw`` says."""
    kw = dict(remat=False, dtype=dtype, **kw)
    return (jax_get_arch(arch, reduced=True).replace(**kw),
            get_arch(arch, reduced=True).replace(**kw))


def params(jcfg, seed=0):
    """The reference's init, and the same values as the port's params."""
    jp = jax_build_model(jcfg).init(jax.random.key(seed))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def np_(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def both(a, dtype="float32"):
    """A numpy array as a JAX array in ``dtype`` and the same values as a
    CPU tensor."""
    j = jnp.asarray(a, DTYPES[dtype])
    return j, bridge.params_from_jax(np.asarray(j), "cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def close(got, want, tol):
    np.testing.assert_allclose(np_(got), np_(want), atol=tol, rtol=tol)


def rel_l2(got, want):
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def assert_config_matches(arch):
    for reduced in (False, True):
        j = jax_get_arch(arch, reduced=reduced)
        t = get_arch(arch, reduced=reduced)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}


def assert_init_matches(arch):
    """The port's init from its own generator: the reference's tree, leaf
    shapes and dtypes, and each leaf's std within sampling noise."""
    jcfg, tcfg = cfgs(arch)
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    tp = build_model(tcfg).init(0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl_ = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(
               tp, is_leaf=lambda x: isinstance(x, torch.Tensor))}
    assert len(jl) == len(tl_)
    for path, jv in jl:
        t = tl_[jax.tree_util.keystr(path)]
        assert str(t.dtype) == f"torch.{jv.dtype.name}", path
        tv, jv = bridge.to_numpy(t), np_(jv)
        assert tv.shape == jv.shape, path
        np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.25, atol=1e-6)
        if tv.std() == 0:          # constants (norm weights, biases)
            np.testing.assert_array_equal(tv, jv)
    spec = build_model(tcfg).param_spec()
    assert [tuple(x.shape) for x in leaves(spec)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]


def assert_loss_and_grads_match(arch, dtype, batch, *, gap=1.0, fp32_tol=1e-5,
                                **kw):
    """Loss and every leaf's gradient of the port's ``loss_fn`` against
    ``jax.value_and_grad`` of the reference's, relative L2. fp32
    activations: ``fp32_tol``, and 3e-2 for a leaf whose param is bf16 (its
    gradient is bf16 in both, and the port sums the embedding's gradient
    in fp32). bf16 activations: max(3e-2, gap * g), where g is the
    reference's own distance from its fp32-activation gradient on that leaf
    (the dense family's rule, ``tests/test_torch_train.py``, with gap 1);
    with ``gap`` > 1 (the hybrid's rule, ROADMAP §3, for a family whose
    bf16 gradients take two independent roundings, such as MoE routing at
    near-ties) the port's gradient is also held to the reference's fp32
    one at max(3e-2, 1.5 g). ``batch``: numpy arrays (integer
    "tokens"/"labels", float "patches" or "frames", passed in the
    activations' dtype to both)."""
    jcfg, tcfg = cfgs(arch, dtype, **kw)
    jparams, tparams = params(jcfg)
    jbatch, tbatch = {}, {}
    for k, v in batch.items():
        if v.dtype.kind == "f":
            jbatch[k], tbatch[k] = both(v, dtype)
        else:
            jbatch[k], tbatch[k] = jnp.asarray(v, jnp.int32), torch.as_tensor(v)
    jloss, jgrads = jax.value_and_grad(jax_build_model(jcfg).loss_fn)(
        jparams, jbatch)
    jleaves = jax.tree.leaves(jgrads)
    ps = leaves(tparams)
    tol = [3e-2 if p.dtype == torch.bfloat16 else fp32_tol for p in ps]
    j32 = None
    if dtype == "bfloat16":
        j32 = jax.tree.leaves(jax.grad(
            jax_build_model(jcfg.replace(dtype="float32")).loss_fn)(jparams, jbatch))
        own = [rel_l2(a, b) for a, b in zip(jleaves, j32)]
        tol = [max(3e-2, gap * g) for g in own]
    for p in ps:
        p.requires_grad_(True)
    loss = build_model(tcfg).loss_fn(tparams, tbatch)
    grads = torch.autograd.grad(loss, ps)
    assert abs(loss.item() - float(jloss)) <= min(tol) * abs(float(jloss))
    assert len(jleaves) == len(grads)
    worst = []
    for i, (g, jg, p, t) in enumerate(zip(grads, jleaves, ps, tol)):
        assert g.shape == tuple(jg.shape) and g.dtype == p.dtype
        worst.append(rel_l2(g, jg) / t)
        if j32 is not None and gap > 1.0:
            worst.append(rel_l2(g, j32[i]) / max(3e-2, 1.5 * own[i]))
    assert max(worst) <= 1.0, max(worst)
