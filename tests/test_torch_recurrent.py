"""The port's hybrid family (recurrentgemma) against the reference on the CPU.

Reduced recurrentgemma-2b (one (rec, rec, attn) period and a (rec, rec)
tail, window 32) with ``remat=False``: JAX init -> numpy ->
``bridge.params_from_jax``. The same seeded numpy inputs go through
``repro.models.recurrent`` and ``repro_torch.models.recurrent``.
Tolerances. Layers: 1e-5 in fp32, 2e-2 in bf16. The whole model: 1e-4 in
the fp32 config (observed: 1.4e-6 on the logits); in bf16 the reference's
own absolute 1e-1 (``tests/test_models_smoke.py``'s recurrent decode
check), since the two frameworks' bf16 matmuls round differently and the
difference grows over the layers and the scan: on the forward logits here
port and reference differ by up to 0.037 (rel. L2 0.025), and the
reference's bf16 logits differ from its own fp32 logits by up to 0.028.
On the CPU the port scans sequentially and the reference with
``associative_scan``: the same fp32 sums in another order, inside these
tolerances. Prompts of 40 tokens are longer than the window, so the ring
buffer wraps in prefill and again in decode.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import recurrent as jrec
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttr
from repro_torch.train.serve import make_serve_fns

ARCH = "recurrentgemma-2b"
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-1, 0.0)}   # (atol, rtol)
BF16_ULP = (2e-2, 2e-2)      # bf16-stored caches in the fp32 config
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ZERO_LAUNCHES = {"flash_attention": 0, "rmsnorm": 0, "rglru_scan": 0,
                 "slstm_scan": 0, "mlstm_scan": 0, "flash_attention_sm90": 0,
                 "flash_attention_bwd": 0,
                 "flash_attention_bwd_sm90": 0, "rmsnorm_bwd": 0,
                 "rglru_scan_bwd": 0, "slstm_scan_bwd": 0,
                 "mlstm_scan_bwd": 0}


def _cfgs(dtype="float32"):
    kw = dict(remat=False, dtype=dtype)
    return (jax_get_arch(ARCH, reduced=True).replace(**kw),
            get_arch(ARCH, reduced=True).replace(**kw))


def _params(jcfg, seed=0):
    jparams = jax_build_model(jcfg).init(jax.random.key(seed))
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                           device="cpu")


def _inputs(seed, shapes, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s) * scale, DTYPES[dtype])
          for s in shapes]
    return js, [bridge.params_from_jax(np.asarray(j), "cpu") for j in js]


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _rec_params(jcfg, seed=0):
    jp = jrec.init_rec(jax.random.key(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# -- config and init ------------------------------------------------------------
def test_config_matches_reference():
    for reduced in (False, True):
        j = jax_get_arch(ARCH, reduced=reduced)
        t = get_arch(ARCH, reduced=reduced)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}


def test_init_shapes_and_scales_match_reference():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    tp = build_model(tcfg).init(0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl_ = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(
               jax.tree.map(bridge.to_numpy, tp,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)))}
    assert len(jl) == len(tl_) and len(tp["tail"]) == 2
    for path, jv in jl:
        tv = tl_[jax.tree_util.keystr(path)]
        assert tv.shape == jv.shape and tv.dtype == jv.dtype
        np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.25, atol=1e-6)
        if jax.tree_util.keystr(path).endswith("['lam']"):
            np.testing.assert_allclose(tv, jv, rtol=1e-6)


# -- RG-LRU pieces --------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_and_rglru_coeffs_match_reference(dtype):
    jcfg, _ = _cfgs(dtype)
    jp, tp = _rec_params(jcfg)
    r, cw = jcfg.d_rnn, jcfg.conv_width
    (jx, jst, jx1), (x, st, x1) = _inputs(
        1, [(2, 9, r), (2, cw - 1, r), (2, 1, r)], dtype)
    tol = LAYER_TOL[dtype]
    _close(trec.causal_conv1d(tp["conv_w"], x),
           jrec.causal_conv1d(jp["conv_w"], jx), tol)
    (out, hist), (jout, jhist) = (trec.conv1d_step(tp["conv_w"], x1, st),
                                  jrec.conv1d_step(jp["conv_w"], jx1, jst))
    _close(out, jout, tol)
    _close(hist, jhist, 0)
    (a, b), (ja, jb) = trec._rglru_coeffs(tp, x), jrec._rglru_coeffs(jp, jx)
    assert a.dtype == b.dtype == torch.float32
    _close(a, ja, 1e-5 if dtype == "float32" else 1e-2)
    _close(b, jb, 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["stateless", "step", "prefill"])
def test_apply_rec_matches_reference(branch, dtype):
    """The three branches of ``apply_rec``: no state (forward), one decode
    step (S == 1) and prefill from a carried state; the state the port
    writes in place equals the reference's new state."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _rec_params(jcfg, seed=2)
    s = {"stateless": 11, "step": 1, "prefill": 11}[branch]
    (jx, jh), (x, h) = _inputs(3, [(2, s, jcfg.d_model), (2, jcfg.d_rnn)], dtype)
    jstate = tstate = None
    if branch != "stateless":
        (jconv,), (conv,) = _inputs(4, [(2, jcfg.conv_width - 1, jcfg.d_rnn)],
                                    "bfloat16")
        jstate = {"h": jh.astype(jnp.float32), "conv": jconv}
        tstate = {"h": h.float(), "conv": conv}
    jout, jnew = jrec.apply_rec(jp, jx, jcfg, state=jstate)
    tout, tnew = trec.apply_rec(tp, x, tcfg, state=tstate)
    tol = LAYER_TOL[dtype]
    _close(tout, jout, tol)
    if branch == "stateless":
        assert tnew is None and jnew is None
        return
    assert tnew is tstate and tnew["conv"].dtype == torch.bfloat16
    _close(tnew["h"], jnew["h"], tol)
    _close(tnew["conv"], jnew["conv"], tol)


# -- local attention with the ring buffer ----------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_cache_attention_matches_reference(dtype):
    w, cur = 32, 45
    (jq, jk, jv), (q, k, v) = _inputs(
        5, [(2, 1, 4, 16), (2, w, 1, 16), (2, w, 1, 16)], dtype)
    kpos = np.arange(w)[None].repeat(2, 0) + 14        # 14 .. 45
    kpos[1, 20:] = -1                                  # empty slots
    got = ttr._window_cache_attention(q, k, v, torch.as_tensor(kpos, dtype=torch.int32),
                                      cur, w)
    want = jtr._window_cache_attention(jq, jk, jv, jnp.asarray(kpos, jnp.int32),
                                       cur, w)
    assert got.dtype == q.dtype
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_apply_attn_prefill_and_decode_match_reference(dtype):
    """A 40-token prompt into a 32-slot ring buffer, then 4 decode steps
    (positions 40-43 overwrite slots 8-11); outputs and the buffer (k, v,
    pos) after each step."""
    jcfg, tcfg = _cfgs(dtype)
    w = jcfg.local_window
    jp = jtr.init_attn(jax.random.key(6), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b, s, steps = 2, 40, 4
    (jx,), (x,) = _inputs(7, [(b, s + steps, jcfg.d_model)], dtype)
    hd, kv = jcfg.resolved_head_dim, jcfg.num_kv_heads
    jcache = {"k": jnp.zeros((b, w, kv, hd), jnp.bfloat16),
              "v": jnp.zeros((b, w, kv, hd), jnp.bfloat16),
              "pos": jnp.full((b, w), -1, jnp.int32)}
    tcache = trec.init_caches(tcfg, b)["periods"]["s2_attn"]
    tcache = {k: t[0] for k, t in tcache.items()}
    tol = LAYER_TOL[dtype]
    for pos0, n in [(0, s)] + [(s + i, 1) for i in range(steps)]:
        jout, jcache = jtr.apply_attn(jp, jx[:, pos0:pos0 + n], jcfg,
                                      positions=jnp.arange(n) + pos0,
                                      cache=jcache, window=w)
        tout = ttr.apply_attn(tp, x[:, pos0:pos0 + n], tcfg, pos0=pos0,
                              cache=tcache, window=w)
        _close(tout, jout, tol)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], tol)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert sorted(tcache["pos"][0].tolist()) == list(range(s + steps - w, s + steps))


# -- the whole model ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and every cache (h, conv, ring k/v/pos) of the port's
    serving fns against the reference's api, then 4 decode steps."""
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _params(jcfg)
    b, s, steps = 2, 40, 4
    toks = _tokens(jcfg, b, s)
    japi = jax_build_model(jcfg)
    j_logits, j_cache = jax.jit(japi.prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                s + steps)
    tol = TOL[dtype]

    def check_caches():
        """Positions exactly. In the fp32 config h at ``tol`` and the bf16
        caches (conv history, ring k/v) within one bf16 ulp, since values
        that differ in the last fp32 bits may round to neighbouring bf16
        values."""
        jc = jax.tree.map(_np, j_cache)
        tc = bridge.cache_to_numpy(t_cache)
        assert jax.tree.structure(jc) == jax.tree.structure(tc)
        for (path, jv), tv in zip(jax.tree_util.tree_leaves_with_path(jc),
                                  jax.tree.leaves(tc)):
            key = jax.tree_util.keystr(path)
            if key.endswith("['pos']"):
                np.testing.assert_array_equal(tv, jv)
            else:
                atol, rtol = tol if dtype == "bfloat16" or key.endswith(
                    "['h']") else BF16_ULP
                np.testing.assert_allclose(tv, jv, atol=atol, rtol=rtol,
                                           err_msg=key)

    _close(t_logits, j_logits, tol)
    check_caches()
    jdec = jax.jit(japi.decode_step)
    tok = np.argmax(_np(j_logits)[:, -1], -1)
    for i in range(steps):
        j_logits, j_cache = jdec(jparams, j_cache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok), s + i)
        _close(t_logits, j_logits, tol)
        tok = np.argmax(_np(j_logits)[:, 0], -1)
    check_caches()
    assert launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_and_teacher_forcing(dtype):
    """``forward`` against the reference's, and prefill(t[:n]) + decode(t[n])
    against forward's logits at n: within 3e-2 in the fp32 config, where the
    bf16 conv history rounds the decode step's last inputs (observed 5e-3),
    and within the bf16 tolerance in bf16."""
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _params(jcfg, seed=1)
    toks = _tokens(jcfg, 2, 41, seed=3)
    tt = torch.as_tensor(toks)
    full = trec.forward(tparams, tt, tcfg)
    jfull, _ = jax.jit(functools.partial(jrec.forward, cfg=jcfg))(
        jparams, jnp.asarray(toks, jnp.int32))
    tol = TOL[dtype]
    _close(full, jfull, tol)
    _, caches = trec.prefill(tparams, tt[:, :-1], tcfg)
    step, _ = trec.decode_step(tparams, caches, tt[:, -1], 40, tcfg)
    _close(step[:, 0], full[:, -1], 3e-2 if dtype == "float32" else tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [5, 26])
def test_teacher_forcing_gap_within_reference_own_gap(layers, dtype):
    """prefill(t[:60]) + decode(t[60]) against forward at 60, for the port
    and for the reference on the same weights: the port's gap is no larger
    than the reference's own. The reference's decode arithmetic differs
    from its forward (the conv step's einsum against tap-by-tap sums, bf16
    window-attention probabilities, the bf16 conv history), and depth
    grows that. 26 layers are recurrentgemma-2b's depth at width 256.
    Observed rel. L2 (reference / port): 5 layers 0.0033 / 0.0034 in fp32,
    0.024 / 0.016 in bf16; 26 layers 0.0077 / 0.0077 in fp32, 0.059 /
    0.047 in bf16."""
    kw = dict(remat=False, dtype=dtype, num_layers=layers)
    if layers == 26:
        kw.update(d_model=256, d_rnn=256, num_heads=4, head_dim=64, d_ff=512,
                  vocab_size=512)
    jcfg = jax_get_arch(ARCH, reduced=True).replace(**kw)
    tcfg = get_arch(ARCH, reduced=True).replace(**kw)
    jparams, tparams = _params(jcfg)
    toks = _tokens(jcfg, 2, 61)
    jt = jnp.asarray(toks, jnp.int32)
    japi = jax_build_model(jcfg)
    jfull, _ = jax.jit(functools.partial(jrec.forward, cfg=jcfg))(jparams, jt)
    _, jcache = jax.jit(japi.prefill)(jparams, {"tokens": jt[:, :-1]})
    jstep, _ = jax.jit(japi.decode_step)(jparams, jcache, jt[:, -1],
                                         jnp.asarray(60, jnp.int32))
    tt = torch.as_tensor(toks)
    full = trec.forward(tparams, tt, tcfg)
    _, caches = trec.prefill(tparams, tt[:, :-1], tcfg)
    step, _ = trec.decode_step(tparams, caches, tt[:, -1], 60, tcfg)

    def rel(a, b):
        a, b = _np(a), _np(b)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    ref_gap = rel(jstep[:, 0], jfull[:, -1])
    port_gap = rel(step[:, 0], full[:, -1])
    assert port_gap <= 1.25 * ref_gap, (port_gap, ref_gap)


@pytest.mark.parametrize("extra", [[], ["--kv-quant"]])
def test_launch_serve_end_to_end_on_cpu(extra, capsys):
    """The CLI on the reduced config; ``--kv-quant`` leaves the bf16 ring
    buffers as they are, as in the reference."""
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "3", *extra])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    ring = res["caches"]["periods"]["s2_attn"]
    assert ring["k"].dtype == torch.bfloat16 and ring["k"].shape[2] == 32
    assert sorted(ring["pos"][0, 0].tolist()) == list(range(43 - 32, 43))
    assert launch_counts() == ZERO_LAUNCHES
