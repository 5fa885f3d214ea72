"""The port's audio family (whisper-medium's encoder-decoder) against the
reference on the CPU.

Reduced whisper-medium (2 encoder and 2 decoder layers, d_model 64, 4 heads,
30 frames). JAX init -> numpy -> ``bridge.params_from_jax``; the same
seeded frames (bf16 standard normals, as both launchers draw them) go
to both. The encoder attends without a mask and the cross-attention has
S != T, so these tests run the port's blockwise flash (K1's CPU route) on
non-causal shapes.

The reference's registry sizes the decoder cache to the prompt
(``src/repro/models/registry.py:136-137``) and its decode steps then clamp
onto the last slot (R3's kind of fault); the tests call
``whisper.prefill(..., max_len=S+steps)`` of both packages directly.
Tolerances: 1e-4 in fp32, 3e-2 in bf16 (``tests/test_torch_serve.py``);
the bf16-stored caches, one bf16 ulp apart at most, 2e-2 in both
(``tests/test_torch_recurrent.py``).
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
from repro.models import common as jcommon
from repro.models import whisper as jwh
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import whisper as twh
from repro_torch.train.serve import make_serve_fns

ARCH = "whisper-medium"


def _frames(cfg, b, seed=0, dtype="bfloat16"):
    x = np.random.default_rng(seed).standard_normal((b, cfg.num_frames, cfg.d_model))
    return both(x, dtype)


def test_config_matches_reference():
    assert_config_matches(ARCH)


def test_init_shapes_and_scales_match_reference():
    assert_init_matches(ARCH)


def _sin_cos_f64(pos, div):
    """sin and cos, interleaved, of the fp32 products ``pos * div`` in
    float64."""
    arg = (pos[:, None] * div[None, :]).astype(np.float64)
    out = np.zeros((len(pos), 2 * len(div)))
    out[:, 0::2], out[:, 1::2] = np.sin(arg), np.cos(arg)
    return out


@pytest.mark.parametrize("seq,dim,offset", [(30, 64, 0), (1500, 1024, 0),
                                            (5, 64, 437), (1, 1024, 65535)])
def test_sinusoidal_positions_match_reference(seq, dim, offset):
    """``div`` comes from each framework's fp32 exp, equal or one ulp apart
    (on 10% of the entries at dim 1024). The port's sin and cos lie within
    1e-6 of float64's on its own fp32 ``pos * div`` products, and within
    1e-5 of the reference's plus the largest gap between the two fp32
    products that the ulp makes (1.2e-4 at 1500 positions, 3.1e-3 at
    65535; ROADMAP §3)."""
    got = tcommon.sinusoidal_positions(seq, dim, offset=offset)
    want = np.asarray(jcommon.sinusoidal_positions(seq, dim, offset=offset))
    assert got.dtype == torch.float32
    pos = np.arange(offset, offset + seq, dtype=np.float32)
    scale = -np.log(10000.0) / dim
    t_div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * scale).numpy()
    j_div = np.asarray(jnp.exp(jnp.arange(0, dim, 2, dtype=jnp.float32) * scale))
    assert (np.abs(t_div - j_div) <= np.spacing(j_div)).all()
    np.testing.assert_allclose(got.numpy(), _sin_cos_f64(pos, t_div), atol=1e-6,
                               rtol=0)
    args = [(pos[:, None] * d[None, :]).astype(np.float64) for d in (t_div, j_div)]
    moved = np.abs(args[0] - args[1]).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 + moved, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    jcfg, tcfg = cfgs(ARCH, dtype)
    jparams, tparams = params(jcfg)
    jf, tf = _frames(jcfg, 2)
    close(twh.encode(tparams, tf, tcfg), jwh.encode(jparams, jf, jcfg), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg = cfgs(ARCH, dtype)
    jparams, tparams = params(jcfg)
    b, s, steps = 2, 12, 4
    toks = tokens(jcfg, b, s)
    jf, tf = _frames(jcfg, b)
    tol = TOL[dtype]
    jpf = jax.jit(functools.partial(jwh.prefill, cfg=jcfg, max_len=s + steps))
    jdec = jax.jit(jax_build_model(jcfg).decode_step)
    j_logits, j_state = jpf(jparams, jf, jnp.asarray(toks, jnp.int32))
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_state = prefill(tparams, {"tokens": torch.as_tensor(toks),
                                          "frames": tf}, s + steps)
    close(t_logits, j_logits, tol)
    close(t_state["memory"], j_state["memory"], tol)
    tok = np.argmax(np_(j_logits)[:, -1], -1)
    for i in range(steps):
        j_logits, j_state = jdec(jparams, j_state, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
        t_logits, t_state = decode(tparams, t_state, torch.as_tensor(tok), s + i)
        close(t_logits, j_logits, tol)
        tok = np.argmax(np_(j_logits)[:, 0], -1)
    for key in ("k", "v"):        # bf16-stored: one bf16 ulp apart at most
        assert t_state["kv"][key].shape == j_state["kv"][key].shape
        close(t_state["kv"][key], j_state["kv"][key], max(tol, 2e-2))
    assert launch_counts() == ZERO_LAUNCHES


def test_registry_prefill_sizes_the_cache_to_the_prompt():
    """Without ``max_len`` the api's prefill sizes the cache to the prompt,
    as the reference's registry does; its logits and cache are the
    reference's."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg)
    toks = tokens(jcfg, 2, 9, seed=2)
    jf, tf = _frames(jcfg, 2, seed=2)
    j_logits, j_state = jax.jit(jax_build_model(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32), "frames": jf})
    t_logits, t_state = build_model(tcfg).prefill(
        tparams, {"tokens": torch.as_tensor(toks), "frames": tf})
    assert t_state["kv"]["k"].shape[2] == 9
    close(t_logits, j_logits, TOL["float32"])
    close(t_state["kv"]["k"], j_state["kv"]["k"], 2e-2)     # bf16-stored


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jcfg, tcfg = cfgs(ARCH, dtype)
    jparams, tparams = params(jcfg)
    toks = tokens(jcfg, 2, 10, seed=5)
    jf, tf = _frames(jcfg, 2, seed=5)
    got = build_model(tcfg).forward(tparams, torch.as_tensor(toks), frames=tf)
    memory = jwh.encode(jparams, jf, jcfg)
    want, _ = jwh.decode(jparams, memory, jnp.asarray(toks, jnp.int32), jcfg)
    close(got, want, TOL[dtype])


def test_decode_matches_teacher_forcing():
    """prefill(frames, t[:n]) + decode(t[n]) against ``forward`` over n+1
    tokens, in the port (bf16)."""
    _, tcfg = cfgs(ARCH, "bfloat16")
    jcfg, _ = cfgs(ARCH)
    _, tparams = params(jcfg, seed=1)
    tt = torch.as_tensor(tokens(tcfg, 2, 17, seed=3))
    _, tf = _frames(tcfg, 2, seed=3)
    full = twh.forward(tparams, tt, tf, tcfg)
    _, state = twh.prefill(tparams, tf, tt[:, :-1], tcfg, max_len=17)
    step, _ = twh.decode_step(tparams, state, tt[:, -1], 16, tcfg)
    close(step[:, 0], full[:, -1], 3e-2)


def test_decode_past_cache_raises():
    _, tcfg = cfgs(ARCH)
    jcfg, _ = cfgs(ARCH)
    _, tparams = params(jcfg)
    tt = torch.as_tensor(tokens(tcfg, 1, 8))
    _, tf = _frames(tcfg, 1)
    _, state = twh.prefill(tparams, tf, tt, tcfg, max_len=8)
    with pytest.raises(ValueError, match="do not fit"):
        twh.decode_step(tparams, state, tt[:, -1], 8, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    rng = np.random.default_rng(0)
    jcfg, _ = cfgs(ARCH)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "frames": rng.standard_normal((2, jcfg.num_frames, jcfg.d_model))}
    # bf16: the hybrid's rule; the decoder's self-attention wq and wk read
    # 0.050 and 0.041 from the reference's bf16 gradients, whose own gap is
    # 0.047 and 0.038 (and 0.032 and 0.026 from its fp32 ones)
    assert_loss_and_grads_match(ARCH, dtype, batch, gap=2.0)


def test_remat_recomputes_the_same_grads():
    """``cfg.remat`` checkpoints each encoder and decoder block; the
    gradients equal those without it."""
    jcfg, tcfg = cfgs(ARCH)
    _, tparams = params(jcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, jcfg.vocab_size, (2, 8))),
             "labels": torch.as_tensor(rng.integers(0, jcfg.vocab_size, (2, 8))),
             "frames": torch.as_tensor(rng.standard_normal(
                 (2, jcfg.num_frames, jcfg.d_model)), dtype=torch.float32)}
    from repro_torch.models.registry import leaves

    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    grads = [torch.autograd.grad(build_model(tcfg.replace(remat=r)).loss_fn(
        tparams, batch), ps) for r in (False, True)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_synthetic_batch_draws_as_the_reference_launcher():
    cfg = cfgs(ARCH)[1]
    got = serve.synthetic_batch(cfg, 2, 5, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    frames = jnp.asarray(rng.standard_normal((2, cfg.num_frames, cfg.d_model)),
                         jnp.bfloat16)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    np.testing.assert_array_equal(np_(got["frames"]), np_(frames))
    assert set(got) == {"tokens", "frames"}


def test_launch_serve_end_to_end_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    assert res["caches"]["kv"]["k"].shape[2] == 8 + 3
    assert res["caches"]["memory"].shape == (2, 30, 64)
    assert launch_counts() == ZERO_LAUNCHES
