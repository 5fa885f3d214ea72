"""The port's VLM family (internvl2-26b's backbone: patch embeddings in front
of the dense decoder) against the reference on the CPU.

Reduced internvl2-26b (16 patches, d_model 64, GQA 4/2). JAX init -> numpy
-> ``bridge.params_from_jax``; the same seeded patches go to both as bf16
standard normals (as both packages' ``launch/serve.py`` draw them).

The reference's ``launch/serve.py`` decodes at ``prompt_len + i``
(``src/repro/launch/serve.py:72``), inside the P patch positions of a cache
of P + prompt_len (``src/repro/models/registry.py:76-77``): it overwrites an
earlier position's k/v and gives the new token the wrong rotary position
(ROADMAP §3, R8). The port decodes at P + prompt_len + i in a cache of
P + prompt_len + gen positions. So these tests hold the port to the
reference's model functions called directly, ``transformer.prefill(...,
max_len=P+S+steps, extra_embeds=patches)`` and ``decode_step`` at the
explicit positions P+S+i, and not to its launcher.

Tolerances: 1e-4 in fp32. In bf16 the patches (standard normals, as the
launchers draw them) make the activations some 50 times larger than the
token embeddings, and the reference's own bf16 logits lie up to 0.044-0.071
from its fp32 logits on these inputs (g, its own gap on the same call).
The port's bf16 logits carry a rounding of their own beside the
reference's (0.045-0.051 from the reference's, 0.051-0.072 from its fp32
logits), so they are held by the hybrid family's rule (ROADMAP §3):
within max(3e-2, 2 g) of the reference's bf16 and max(3e-2, 1.5 g) of its
fp32 logits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_twins import (
    TOL,
    ZERO_LAUNCHES,
    assert_config_matches,
    assert_init_matches,
    assert_loss_and_grads_match,
    both,
    cfgs,
    close,
    np_,
    params,
    tokens,
)
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.train.serve import make_serve_fns

ARCH = "internvl2-26b"


def _patches(cfg, b, seed=0, dtype="bfloat16"):
    x = np.random.default_rng(seed).standard_normal((b, cfg.num_patches, cfg.d_model))
    return both(x, dtype)


def _close_bf16(got, want, want32):
    """The hybrid family's rule (ROADMAP §3) on max |.|: within max(3e-2, 2 g)
    of the reference's bf16 values and max(3e-2, 1.5 g) of its fp32
    values, g = max |want - want32|."""
    g = np.abs(np_(want) - np_(want32)).max()
    np.testing.assert_allclose(np_(got), np_(want), atol=max(3e-2, 2 * g), rtol=0)
    np.testing.assert_allclose(np_(got), np_(want32), atol=max(3e-2, 1.5 * g),
                               rtol=0)


def test_config_matches_reference():
    assert_config_matches(ARCH)


def test_init_shapes_and_scales_match_reference():
    assert_init_matches(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg = cfgs(ARCH, dtype)
    jparams, tparams = params(jcfg)
    b, s, steps, p = 2, 12, 4, jcfg.num_patches
    toks = tokens(jcfg, b, s)
    jpatch, tpatch = _patches(jcfg, b)
    jtoks = jnp.asarray(toks, jnp.int32)
    # the reference in fp32 on the same inputs: its own bf16 gap (bf16 only)
    cfg32 = jcfg.replace(dtype="float32")

    def check(got, want, want32):
        if dtype == "float32":
            close(got, want, TOL[dtype])
        else:
            _close_bf16(got, want, want32)

    # the reference's api: a cache of P + S positions
    j_logits, j_cache = jax.jit(jax_build_model(jcfg).prefill)(
        jparams, {"tokens": jtoks, "patches": jpatch})
    j32_logits, j32_cache = jax.jit(jax_build_model(cfg32).prefill)(
        jparams, {"tokens": jtoks, "patches": jpatch})
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks),
                                          "patches": tpatch})
    assert t_cache["k"].shape[2] == p + s
    check(t_logits, j_logits, j32_logits)
    for key in ("k", "v"):
        check(t_cache[key], j_cache[key], j32_cache[key])
    # room for the decode steps, decoding at P+S+i
    runs = {}
    for name, cfg in (("ref", jcfg), ("ref32", cfg32)):
        jpf = jax.jit(functools.partial(jtr.prefill, cfg=cfg, max_len=p + s + steps))
        runs[name] = [jax.jit(jax_build_model(cfg).decode_step),
                      *jpf(jparams, jtoks, extra_embeds=jpatch)]
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks),
                                          "patches": tpatch}, p + s + steps)
    tok = np.argmax(np_(runs["ref"][1])[:, -1], -1)
    for i in range(steps):
        for run in runs.values():
            run[1:] = run[0](jparams, run[2], jnp.asarray(tok, jnp.int32),
                             jnp.asarray(p + s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok),
                                   p + s + i)
        check(t_logits, runs["ref"][1], runs["ref32"][1])
        tok = np.argmax(np_(runs["ref"][1])[:, 0], -1)
    for key in ("k", "v"):
        check(t_cache[key], runs["ref"][2][key], runs["ref32"][2][key])
    assert launch_counts() == ZERO_LAUNCHES


def test_generate_decodes_after_the_patches():
    """``launch.serve.generate`` learns P from the batch: its greedy ids
    equal the reference's model functions decoding at P+S+i (fp32)."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg)
    b, s, gen, p = 2, 8, 3, jcfg.num_patches
    toks = tokens(jcfg, b, s, seed=4)
    jpatch, tpatch = _patches(jcfg, b, seed=4)
    api = build_model(tcfg)
    pre, dec = make_serve_fns(api, device="cpu")
    server = serve.Server(tcfg, api, tparams, pre, dec, torch.device("cpu"))
    res = serve.generate(server, {"tokens": torch.as_tensor(toks),
                                  "patches": tpatch}, gen)
    assert res["caches"]["k"].shape[2] == p + s + gen
    logits, cache = jtr.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                                p + s + gen, extra_embeds=jpatch)
    want = [np.argmax(np_(logits)[:, -1], -1)]
    for i in range(gen):
        logits, cache = jtr.decode_step(jparams, cache,
                                        jnp.asarray(want[-1], jnp.int32),
                                        jnp.asarray(p + s + i, jnp.int32), jcfg)
        want.append(np.argmax(np_(logits)[:, 0], -1))
    np.testing.assert_array_equal(res["ids"].numpy(), np.stack(want, 1))


def test_reference_launcher_position_overwrites_a_patch_slot():
    """R8, shown on the reference: decoding at S (its launcher's position) in
    the cache of P + S writes slot S, which held an earlier position's k/v,
    and its logits differ from decoding at P + S."""
    jcfg, _ = cfgs(ARCH)
    jparams, _ = params(jcfg)
    b, s, p = 2, 8, jcfg.num_patches
    toks = jnp.asarray(tokens(jcfg, b, s), jnp.int32)
    jpatch, _ = _patches(jcfg, b)
    logits, cache = jtr.prefill(jparams, toks, jcfg, p + s + 1,
                                extra_embeds=jpatch)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    at_launcher, c1 = jtr.decode_step(jparams, cache, tok, jnp.asarray(s, jnp.int32),
                                    jcfg)
    at_port, _ = jtr.decode_step(jparams, cache, tok, jnp.asarray(p + s, jnp.int32),
                                 jcfg)
    assert not np.array_equal(np_(c1["k"][:, :, s]), np_(cache["k"][:, :, s]))
    assert np.abs(np_(at_launcher) - np_(at_port)).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_returns_text_logits_and_matches_reference(dtype):
    jcfg, tcfg = cfgs(ARCH, dtype)
    jparams, tparams = params(jcfg)
    toks = tokens(jcfg, 2, 10, seed=5)
    jpatch, tpatch = _patches(jcfg, 2, seed=5)
    got = build_model(tcfg).forward(tparams, torch.as_tensor(toks),
                                    patches=tpatch)
    assert got.shape == (2, 10, jcfg.vocab_size)
    want, want32 = (jtr.forward(jparams, jnp.asarray(toks, jnp.int32), cfg,
                                extra_embeds=jpatch)
                    for cfg in (jcfg, jcfg.replace(dtype="float32")))
    if dtype == "float32":
        close(got, want, TOL[dtype])
    else:
        _close_bf16(got, want, want32)


def test_decode_matches_teacher_forcing():
    """prefill(patches, t[:n]) + decode(t[n]) at P+n against ``forward``
    over the patches and n+1 tokens, in the port (bf16)."""
    _, tcfg = cfgs(ARCH, "bfloat16")
    jcfg, _ = cfgs(ARCH)
    _, tparams = params(jcfg, seed=1)
    p = tcfg.num_patches
    tt = torch.as_tensor(tokens(tcfg, 2, 17, seed=3))
    _, tpatch = _patches(tcfg, 2, seed=3)
    full = ttr.forward(tparams, tt, tcfg, extra_embeds=tpatch)
    _, caches = ttr.prefill(tparams, tt[:, :-1], tcfg, max_len=p + 17,
                            extra_embeds=tpatch)
    step, _ = ttr.decode_step(tparams, caches, tt[:, -1], p + 16, tcfg)
    close(step[:, 0], full[:, -1], 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    rng = np.random.default_rng(0)
    jcfg, _ = cfgs(ARCH)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "patches": rng.standard_normal((2, jcfg.num_patches, jcfg.d_model))}
    assert_loss_and_grads_match(ARCH, dtype, batch)


def test_synthetic_batch_draws_as_the_reference_launcher():
    """Tokens, then patches, from one numpy generator; the patches rounded
    to bf16 from float64, as ``jnp.asarray(..., jnp.bfloat16)`` rounds
    them."""
    cfg = build_model(cfgs(ARCH)[1]).cfg
    got = serve.synthetic_batch(cfg, 3, 7, seed=2, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 7))
    patches = jnp.asarray(rng.standard_normal((3, cfg.num_patches, cfg.d_model)),
                          jnp.bfloat16)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    assert got["patches"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(got["patches"]), np_(patches))


def test_launch_serve_end_to_end_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    assert res["caches"]["k"].shape[2] == 16 + 8 + 3
    assert launch_counts() == ZERO_LAUNCHES
