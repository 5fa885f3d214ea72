"""The port's serving path against the reference package on the CPU.

Reduced llama3-8b and qwen2.5-3b (qkv bias, tied embeddings), and of the
dense configs added later, qwen2.5-14b (GQA 40/8, qkv bias) and granite-34b
(MQA, the non-gated GELU-tanh MLP): JAX init -> numpy ->
``bridge.params_from_jax``; prefill logits, caches and decode steps of
``repro_torch`` against ``repro.models``. Tolerances: 1e-4 for the fp32
config, 3e-2 for bf16 (``tests/test_models_smoke.py``'s decode tolerance).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_arch
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.train.serve import make_serve_fns

ARCHS = ["llama3-8b", "qwen2.5-3b"]
DENSE_ARCHS = ARCHS + ["qwen2.5-14b", "granite-34b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _setup(arch, dtype="bfloat16", kv_quant=False, seed=0):
    jcfg = jax_get_arch(arch, reduced=True).replace(
        remat=False, dtype=dtype, kv_quant=kv_quant)
    tcfg = get_arch(arch, reduced=True).replace(
        remat=False, dtype=dtype, kv_quant=kv_quant)
    jparams = jax_build_model(jcfg).init(jax.random.key(seed))
    tparams = bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_configs_match_reference():
    """Field for field, for all ten architectures of the reference, which
    the port registers, and no other name."""
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs

    assert list_archs() == jax_list_archs() and len(list_archs()) == 10
    for arch in list_archs():
        for reduced in (False, True):
            j = jax_get_arch(arch, reduced=reduced)
            t = get_arch(arch, reduced=reduced)
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                {f: getattr(j, f) for f in j.__dataclass_fields__}
    with pytest.raises(KeyError):
        get_arch("deepseek-moe-17b")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_shapes_and_scales_match_reference(arch):
    jcfg = jax_get_arch(arch, reduced=True)
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    tp = build_model(get_arch(arch, reduced=True)).init(0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl_ = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(
               jax.tree.map(bridge.to_numpy, tp,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)))}
    assert len(jl) == len(tl_)
    for path, jv in jl:
        tv = tl_[jax.tree_util.keystr(path)]
        assert tv.shape == jv.shape and tv.dtype == jv.dtype
        # same distribution: equal stds within sampling noise
        np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.25, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    b, s, steps = 2, 12, 4
    toks = _tokens(jcfg, b, s)
    # prefill exactly as the reference's api does (cache of the prompt length)
    j_logits, j_cache = jax.jit(jax_build_model(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)})
    tol = TOL[dtype]
    np.testing.assert_allclose(bridge.to_numpy(t_logits), _np(j_logits),
                               atol=tol, rtol=tol)
    tc = bridge.cache_to_numpy(t_cache)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], _np(j_cache[key]), atol=tol,
                                   rtol=tol)
    # a cache with room for the decode steps
    jpf = jax.jit(functools.partial(jtr.prefill, cfg=jcfg, max_len=s + steps))
    jdec = jax.jit(jax_build_model(jcfg).decode_step)
    j_logits, j_cache = jpf(jparams, jnp.asarray(toks, jnp.int32))
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                s + steps)
    tok = np.argmax(_np(j_logits)[:, -1], -1)
    for i in range(steps):
        j_logits, j_cache = jdec(jparams, j_cache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok),
                                   s + i)
        np.testing.assert_allclose(bridge.to_numpy(t_logits), _np(j_logits),
                                   atol=tol, rtol=tol)
        tok = np.argmax(_np(j_logits)[:, 0], -1)
    tc = bridge.cache_to_numpy(t_cache)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], _np(j_cache[key]), atol=tol,
                                   rtol=tol)
    assert launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                               "rglru_scan": 0, "slstm_scan": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_bwd": 0,
                               "flash_attention_bwd_sm90": 0, "rmsnorm_bwd": 0,
                               "rglru_scan_bwd": 0}


def test_kv_quantize_matches_reference_exactly():
    from repro.models.transformer import _kv_quantize as jq

    rng = np.random.default_rng(0)
    for dt in (jnp.bfloat16, jnp.float32):
        x = np.asarray(jnp.asarray(rng.standard_normal((4, 64, 2, 16)) * 3, dt))
        jcodes, jscale = jq(jnp.asarray(x))
        tcodes, tscale = ttr._kv_quantize(bridge.params_from_jax(x, "cpu"))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(bridge.to_numpy(tscale), _np(jscale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_kv_cache_matches_reference(arch, dtype):
    """In the fp32 config the int8 codes agree within 1 (observed: 0). In
    bf16, k and v from the two frameworks' matmuls may differ by one bf16
    ulp; the bf16 quotient x / scale then moves by one of its own ulps (0.5
    for codes of 64 and up) and its rounding by one more. With this seed,
    a few dozen of the 2,304 codes of k and of v differ by 2 in both archs
    (none by more), so the bf16 limit is 2. On the same k and v the codes
    are equal (``test_kv_quantize_matches_reference_exactly``)."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype, kv_quant=True, seed=1)
    b, s = 2, 16
    toks = _tokens(jcfg, b, s, seed=1)
    j_logits, j_cache = jtr.prefill(jparams, jnp.asarray(toks, jnp.int32),
                                    jcfg, max_len=s + 2)
    t_logits, t_cache = ttr.prefill(tparams, torch.as_tensor(toks), tcfg,
                                    max_len=s + 2)
    np.testing.assert_allclose(bridge.to_numpy(t_logits), _np(j_logits),
                               atol=3e-2, rtol=3e-2)
    nxt = np.array([5, 9])
    j_logits, j_cache = jtr.decode_step(jparams, j_cache, jnp.asarray(nxt, jnp.int32),
                                        jnp.asarray(s, jnp.int32), jcfg)
    t_logits, t_cache = ttr.decode_step(tparams, t_cache, torch.as_tensor(nxt),
                                        s, tcfg)
    np.testing.assert_allclose(bridge.to_numpy(t_logits), _np(j_logits),
                               atol=3e-2, rtol=3e-2)
    tc = bridge.cache_to_numpy(t_cache)
    for key in ("k", "v"):
        assert tc[key].dtype == np.int8
        diff = np.abs(tc[key].astype(np.int32) - np.asarray(j_cache[key], np.int32))
        assert diff.max() <= (1 if dtype == "float32" else 2)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[key], _np(j_cache[key]), rtol=2e-2)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(t[:n]) then decode(t[n]) reproduces forward's logits at n, in
    the port and against the reference's forward."""
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=1)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 17))
    tt = torch.as_tensor(toks)
    full = ttr.forward(tparams, tt, tcfg)
    _, caches = ttr.prefill(tparams, tt[:, :-1], tcfg, max_len=17)
    step_logits, _ = ttr.decode_step(tparams, caches, tt[:, -1], 16, tcfg)
    np.testing.assert_allclose(bridge.to_numpy(step_logits[:, 0]),
                               bridge.to_numpy(full[:, -1]), atol=3e-2, rtol=3e-2)
    jfull = jtr.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    np.testing.assert_allclose(bridge.to_numpy(full), _np(jfull), atol=3e-2,
                               rtol=3e-2)


def test_decode_past_cache_raises():
    _, tcfg, _, tparams = _setup("llama3-8b")
    toks = torch.as_tensor(_tokens(tcfg, 1, 8))
    _, caches = ttr.prefill(tparams, toks, tcfg, max_len=8)
    with pytest.raises(ValueError, match="do not fit"):
        ttr.decode_step(tparams, caches, toks[:, -1], 8, tcfg)


@pytest.mark.parametrize("arch,path", [
    ("deepseek-moe-16b", ("blocks", "moe", "shared", "wg")),
    ("whisper-medium", ("dec_blocks", "cross_attn", "wk")),
    ("xlstm-1.3b", ("periods", "mlstm", "wq"))])
def test_bridge_carries_every_family_tree(arch, path):
    """``bridge.params_from_jax`` keeps any nesting: "moe" (and its "shared"
    MLP) inside "blocks", "enc_blocks" and "dec_blocks", "periods" with
    "mlstm" stacked twice; every leaf equal to the bit."""
    jp = jax.tree.map(np.asarray, jax_build_model(
        jax_get_arch(arch, reduced=True)).init(jax.random.key(0)))
    tp = bridge.params_from_jax(jp, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [jax.tree_util.keystr(k) for k, _ in jl] == \
        [jax.tree_util.keystr(k) for k in tl]
    for (k, v), t in zip(jl, tl.values()):
        np.testing.assert_array_equal(bridge.to_numpy(t), np.asarray(v, np.float32))
    leaf_j, leaf_t = jp, tp
    for key in path:
        leaf_j, leaf_t = leaf_j[key], leaf_t[key]
    assert tuple(leaf_t.shape) == leaf_j.shape


@pytest.mark.parametrize("extra", [[], ["--kv-quant"], ["--arch", "qwen2.5-3b"],
                                   ["--arch", "granite-34b", "--layers", "1"]])
def test_launch_serve_end_to_end_on_cpu(extra, capsys):
    from repro_torch.launch import serve

    res = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", *extra])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    assert res["caches"]["k"].shape[2] == 8 + 3
    assert res["caches"]["k"].shape[0] == (1 if "--layers" in extra else 2)
