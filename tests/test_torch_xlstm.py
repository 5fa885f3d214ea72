"""The port's SSM family (xlstm-1.3b: mLSTM and sLSTM blocks) against the
reference on the CPU.

Reduced xlstm-1.3b (two periods of 7 mLSTM blocks and one sLSTM block,
d_model 64, 4 heads: mLSTM head dim 32, sLSTM head dim 16). JAX init ->
numpy -> ``bridge.params_from_jax``. Prompts of 300 tokens are longer than
one chunk of 256, so the chunk loop carries C and n across chunks and the
last chunk is padded.

Tolerances. One block on the same inputs: 1e-5 in fp32 (observed: 3.2e-6
on outputs up to 10), 3e-2 in bf16; the chunk scan alone 1e-5. The whole
model in fp32: 1e-3 on the logits and states (observed: 2.3e-4, rel. L2
1.3e-5): the 16 blocks' errors of a few ulps add up on a residual stream
that grows to magnitude 10. Gradients in fp32: 1e-3 relative L2 per leaf
(observed: 1e-4 at most). The whole model in bf16 is chaotic in the
reference itself: its bf16 logits lie 25% (rel. L2) from its own fp32
logits, and its bf16 gradients 65-104% from its fp32 ones, so the port's
whole-model bf16 results are held by the hybrid family's rule on relative
L2 (ROADMAP §3: within max(3e-2, 2 g) of the reference's bf16 values and
max(3e-2, 1.5 g) of its fp32 values, g the reference's own gap), and the
bf16 comparison proper is made block by block. Teacher forcing (the
port's decode against its own forward): rel. L2 3e-2 and the reference's
own absolute 1e-1 (``tests/test_models_smoke.py``) in bf16 (observed:
0.023 and 0.066; the reference reads 0.026 and 0.078 on the same check);
the bf16-stored conv history, one bf16 ulp apart at most, 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_twins import (
    ZERO_LAUNCHES,
    assert_config_matches,
    assert_init_matches,
    assert_loss_and_grads_match,
    both,
    cfgs,
    close,
    np_,
    params,
    rel_l2,
    tokens,
)
from repro.models import build_model as jax_build_model
from repro.models import xlstm as jxl
from repro_torch import bridge
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import xlstm as txl
from repro_torch.models.registry import leaves
from repro_torch.train.serve import make_serve_fns

ARCH = "xlstm-1.3b"
LONG = 300          # > CHUNK = 256: two chunks, the second padded
MODEL_TOL = {"float32": 1e-3}


def _hybrid_rule(got, want, want32):
    """Relative L2 within max(3e-2, 2 g) of ``want`` (bf16) and max(3e-2,
    1.5 g) of ``want32``, g = rel_l2(want, want32); returns the readings."""
    g = rel_l2(want, want32)
    r, r32 = rel_l2(got, want), rel_l2(got, want32)
    assert r <= max(3e-2, 2 * g) and r32 <= max(3e-2, 1.5 * g), (r, r32, g)
    return r, r32, g


def _close_states(got, want, tol):
    """The recurrent states, leaf by leaf: fp32 C, n, c at ``tol``, the bf16
    conv history (and h where it is bf16) at 2e-2."""
    g, w = bridge.cache_to_numpy(got), jax.tree.map(np_, want)
    for key in ("C", "n", "conv"):
        close(g["mlstm"][key], w["mlstm"][key], 2e-2 if key == "conv" else tol)
    close(g["slstm"]["c"], w["slstm"]["c"], tol)
    close(g["slstm"]["h"], w["slstm"]["h"], max(tol, 2e-2)
          if got["slstm"]["h"].dtype == torch.bfloat16 else tol)


def test_config_matches_reference():
    assert_config_matches(ARCH)


def test_init_shapes_and_scales_match_reference():
    """Periods of mLSTM blocks stacked twice: (2, 7, ...) for each leaf."""
    assert_init_matches(ARCH)
    p = build_model(cfgs(ARCH)[1]).param_spec()
    assert p["periods"]["mlstm"]["wq"].shape == (2, 7, 4, 32, 32)
    assert p["periods"]["slstm"]["r_gates"].shape == (2, 4, 16, 64)


@pytest.mark.parametrize("s", [LONG, 256, 37])
def test_mlstm_chunk_scan_matches_reference(s):
    rng = np.random.default_rng(s)
    b, nh, dh = 2, 4, 32
    arrays = [rng.standard_normal((b, s, nh, dh)) * 0.5 for _ in range(3)]
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, nh))))
    logf = -np.log1p(np.exp(-(rng.standard_normal((b, s, nh)) + 3.0)))
    C0 = rng.standard_normal((b, nh, dh, dh)) * 0.1
    n0 = rng.standard_normal((b, nh, dh)) * 0.1
    js, ts = zip(*(both(a) for a in (*arrays, i, logf, C0, n0)))
    for got, want in zip(txl._mlstm_chunk_scan(*ts), jxl._mlstm_chunk_scan(*js)):
        close(got, want, 1e-5)


def test_decay_above_the_diagonal_may_overflow():
    """Forget gates near 0 make exp(cl_l - cl_m) overflow to inf above the
    diagonal; the mask must pick zero there (no nan), as ``jnp.where``
    does in the reference."""
    b, s, nh, dh = 1, 64, 2, 8
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, nh, dh)),
                               dtype=torch.float32) for _ in range(3))
    i = torch.full((b, s, nh), 0.5)
    logf = torch.full((b, s, nh), -5.0)       # 63 * 5 = 315 > log(fp32 max)
    h, C, n = txl._mlstm_chunk_scan(q, k, v, i, logf,
                                    torch.zeros((b, nh, dh, dh)),
                                    torch.zeros((b, nh, dh)))
    assert torch.isfinite(h).all() and torch.isfinite(C).all()
    j = jxl._mlstm_chunk_scan(*(jnp.asarray(x.numpy()) for x in (q, k, v, i, logf)),
                              jnp.zeros((b, nh, dh, dh)), jnp.zeros((b, nh, dh)))
    close(h, j[0], 1e-5)


def test_prefill_and_decode_match_reference_fp32():
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg)
    b, s, steps = 2, LONG, 3
    toks = tokens(jcfg, b, s)
    tol = MODEL_TOL["float32"]
    j_logits, j_cache = jax.jit(jax_build_model(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    jdec = jax.jit(jax_build_model(jcfg).decode_step)
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)})
    close(t_logits, j_logits, tol)
    _close_states(t_cache, j_cache, tol)
    tok = np.argmax(np_(j_logits)[:, -1], -1)
    for i in range(steps):
        j_logits, j_cache = jdec(jparams, j_cache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok), s + i)
        close(t_logits, j_logits, tol)
        tok = np.argmax(np_(j_logits)[:, 0], -1)
    _close_states(t_cache, j_cache, tol)
    assert launch_counts() == ZERO_LAUNCHES


def test_prefill_and_decode_bf16_by_the_hybrid_rule(capsys):
    jcfg, tcfg = cfgs(ARCH, "bfloat16")
    cfg32 = jcfg.replace(dtype="float32")
    jparams, tparams = params(jcfg)
    b, s, steps = 2, LONG, 3
    toks = tokens(jcfg, b, s)
    refs = {}
    for name, cfg in (("bf16", jcfg), ("fp32", cfg32)):
        api = jax_build_model(cfg)
        refs[name] = [jax.jit(api.decode_step), *jax.jit(api.prefill)(
            jparams, {"tokens": jnp.asarray(toks, jnp.int32)})]
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)})
    readings = [_hybrid_rule(t_logits, refs["bf16"][1], refs["fp32"][1])]
    tok = np.argmax(np_(refs["bf16"][1])[:, -1], -1)
    for i in range(steps):
        for run in refs.values():
            run[1:] = run[0](jparams, run[2], jnp.asarray(tok, jnp.int32),
                             jnp.asarray(s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok), s + i)
        readings.append(_hybrid_rule(t_logits, refs["bf16"][1], refs["fp32"][1]))
        tok = np.argmax(np_(refs["bf16"][1])[:, 0], -1)
    print("rel L2 (port-ref bf16, port-ref fp32, ref's own gap):", readings)
    assert launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_match_reference(dtype):
    """One mLSTM block (no state over 300 tokens; from a state: a prompt,
    then a decode step) and one sLSTM block (from a state, then a step), on
    the same inputs in both packages."""
    jcfg, tcfg = cfgs(ARCH, dtype)
    jp, tp = params(jcfg)
    tol = 1e-5 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(7)
    b, d = 2, jcfg.d_model
    xs = [both(rng.standard_normal((b, n, d)), dtype) for n in (LONG, 20, 1)]
    for kind in ("mlstm", "slstm"):
        jl = jax.tree.map(lambda a: a[0, 0] if kind == "mlstm" else a[0],
                          jp["periods"][kind])
        tl = bridge.params_from_jax(jax.tree.map(np.asarray, jl), "cpu")
        japply = jxl.apply_mlstm if kind == "mlstm" else jxl.apply_slstm
        tapply = txl.apply_mlstm if kind == "mlstm" else txl.apply_slstm
        jinit = (jxl.init_mlstm_state if kind == "mlstm" else jxl.init_slstm_state)
        tstate = (txl.init_mlstm_state if kind == "mlstm" else
                  txl.init_slstm_state)(tcfg, b)
        close(tapply(tl, xs[0][1], tcfg), japply(jl, xs[0][0], jcfg)[0], tol)
        jstate = jinit(jcfg, b)
        for jx, tx in xs[1:]:
            jout, jstate = japply(jl, jx, jcfg, state=jstate)
            close(tapply(tl, tx, tcfg, state=tstate), jout, tol)
        for key, val in tstate.items():
            close(val, jstate[key], 2e-2 if val.dtype == torch.bfloat16 else tol)


def test_forward_matches_reference_fp32():
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg)
    toks = tokens(jcfg, 1, LONG, seed=5)
    got = build_model(tcfg).forward(tparams, torch.as_tensor(toks))
    want, _ = jxl.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    close(got, want, MODEL_TOL["float32"])


def test_decode_matches_teacher_forcing():
    """prefill(t[:n]) + decode(t[n]) against ``forward`` over n+1 tokens in
    the port, n = 300, bf16."""
    _, tcfg = cfgs(ARCH, "bfloat16")
    jcfg, _ = cfgs(ARCH)
    _, tparams = params(jcfg, seed=1)
    tt = torch.as_tensor(tokens(tcfg, 2, LONG + 1, seed=3))
    full = txl.forward(tparams, tt, tcfg)
    _, caches = txl.prefill(tparams, tt[:, :-1], tcfg)
    step, _ = txl.decode_step(tparams, caches, tt[:, -1], LONG, tcfg)
    assert rel_l2(step[:, 0], full[:, -1]) <= 3e-2
    np.testing.assert_allclose(np_(step[:, 0]), np_(full[:, -1]), atol=1e-1, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    rng = np.random.default_rng(0)
    jcfg, _ = cfgs(ARCH)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 24)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 24))}
    assert_loss_and_grads_match(ARCH, dtype, batch, gap=2.0, fp32_tol=1e-3)


def test_remat_recomputes_the_same_grads():
    """``cfg.remat`` checkpoints each period; the gradients equal those
    without it."""
    jcfg, tcfg = cfgs(ARCH)
    _, tparams = params(jcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, jcfg.vocab_size, (2, 12))),
             "labels": torch.as_tensor(rng.integers(0, jcfg.vocab_size, (2, 12)))}
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    grads = [torch.autograd.grad(build_model(tcfg.replace(remat=r)).loss_fn(
        tparams, batch), ps) for r in (False, True)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_launch_serve_end_to_end_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    assert res["caches"]["mlstm"]["C"].shape == (2, 7, 2, 4, 32, 32)
    assert res["caches"]["slstm"]["c"].shape == (2, 2, 64)
    assert launch_counts() == ZERO_LAUNCHES
