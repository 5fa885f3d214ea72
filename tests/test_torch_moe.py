"""The port's MoE family (``models/moe.py`` in the transformer) against the
reference on the CPU.

Reduced deepseek-moe-16b (8 experts, top 2, one shared expert) and
qwen3-moe-235b-a22b (8 experts, top 2, GQA 4/2, no shared expert), with the
published capacity factor 1.25, so the dispatch drops assignments. JAX init
-> numpy -> ``bridge.params_from_jax``.

Routing is exact in fp32: every layer's top-k ids and the dispatch plan
(sort order, keep mask, buffer rows) equal the reference's, on the
reference's own layer inputs, and the logits agree within 1e-4. In bf16 the
two frameworks' CPU matmuls round one ulp apart (ROADMAP §3), so a token
whose k-th and (k+1)-th gates lie within an ulp may take another expert:
one layer's routing is held to the reference on bf16 inputs, with the
number of tokens whose top-k set differs printed and bounded, and the
outputs compared at 3e-2 on the tokens whose sets and keep masks agree.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.common import rms_norm as jrms
from repro_torch import bridge
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.train.serve import make_serve_fns

ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
# tokens of a (4, 64) bf16 batch whose top-k set may differ from the
# reference's (near-ties within one bf16 ulp of the router's logits): 2 of
# the 256 in both archs with these seeds
BF16_FLIPS_MAX = 4


def _ref_route(p, x, cfg):
    """The reference's routing and dispatch plan, its own lines
    (``src/repro/models/moe.py:52-72``), returning what ``apply_moe`` keeps
    internal."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = jmoe.expert_capacity(cfg, s)
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(gates, k)
    flat_ids = ids.reshape(b, s * k)
    order = jnp.argsort(flat_ids, axis=-1, stable=True)
    sorted_ids = jnp.take_along_axis(flat_ids, order, axis=-1)
    seg_start = jax.vmap(
        lambda row: jnp.searchsorted(row, jnp.arange(e), side="left"))(sorted_ids)
    pos_in_e = jnp.arange(s * k)[None, :] - jnp.take_along_axis(
        seg_start, sorted_ids, axis=-1)
    keep = pos_in_e < c
    dest = jnp.where(keep, sorted_ids * c + pos_in_e, e * c)
    return [np.asarray(a) for a in (ids, order, keep, dest)]


def _port_route(p, x, cfg):
    _, ids, order, keep, dest = tmoe.route(p, x, cfg)
    return [a.numpy() for a in (ids, order, keep, dest)]


def _layer_params(jp, tp, i):
    return (jax.tree.map(lambda a: a[i], jp["blocks"]),
            ttr._layer(tp["blocks"], i))


# -- configs and init -----------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert_config_matches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_scales_match_reference(arch):
    assert_init_matches(arch)


def test_expert_capacity_matches_reference():
    _, tcfg = cfgs("deepseek-moe-16b")
    jcfg, _ = cfgs("deepseek-moe-16b")
    for s in (1, 2, 7, 16, 512, 513):
        for cf in (1.0, 1.25, 4.0):
            assert tmoe.expert_capacity(tcfg.replace(capacity_factor=cf), s) == \
                jmoe.expert_capacity(jcfg.replace(capacity_factor=cf), s)


# -- one layer ------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_fp32_routes_exactly_as_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jp, tp = params(jcfg)
    jl, tl = _layer_params(jp, tp, 0)
    x = np.random.default_rng(1).standard_normal((4, 64, jcfg.d_model))
    jx, tx = both(x)
    for got, want in zip(_port_route(tl["moe"], tx, tcfg),
                         _ref_route(jl["moe"], jx, jcfg)):
        np.testing.assert_array_equal(got, want)
    keep = _port_route(tl["moe"], tx, tcfg)[2]
    assert 0 < keep.sum() < keep.size     # capacity 1.25 drops some
    close(tmoe.apply_moe(tl["moe"], tx, tcfg),
          jmoe.apply_moe(jl["moe"], jx, jcfg), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16_near_ties(arch, capsys):
    """bf16: the top-k sets agree for all but at most BF16_FLIPS_MAX tokens
    (the number is printed); outputs agree at 3e-2 on the tokens whose sets
    and keep masks agree."""
    jcfg, tcfg = cfgs(arch, "bfloat16")
    jp, tp = params(jcfg)
    jl, tl = _layer_params(jp, tp, 0)
    x = np.random.default_rng(2).standard_normal((4, 64, jcfg.d_model))
    jx, tx = both(x, "bfloat16")
    t_ids, t_order, t_keep, _ = _port_route(tl["moe"], tx, tcfg)
    j_ids, j_order, j_keep, _ = _ref_route(jl["moe"], jx, jcfg)
    same_set = (np.sort(t_ids, -1) == np.sort(j_ids, -1)).all(-1)   # (B,S)
    flips = int((~same_set).sum())
    print(f"{arch}: {flips} of {same_set.size} tokens take another top-k set")
    assert flips <= BF16_FLIPS_MAX

    def kept(order, keep):           # (B,S,k) keep mask in (token, slot) order
        out = np.zeros_like(keep)
        np.put_along_axis(out, order, keep, axis=-1)
        return out.reshape(t_ids.shape)

    agree = same_set & (kept(t_order, t_keep) == kept(j_order, j_keep)).all(-1)
    got = np_(tmoe.apply_moe(tl["moe"], tx, tcfg))
    want = np_(jmoe.apply_moe(jl["moe"], jx, jcfg))
    np.testing.assert_allclose(got[agree], want[agree], atol=3e-2, rtol=3e-2)


def test_capacity_drop_free_matches_dense_mixture():
    """``tests/test_models_smoke.py``'s check on the port: with a capacity
    factor high enough that nothing drops, the MoE layer equals the dense
    weighted mixture of the expert MLPs."""
    _, tcfg = cfgs("deepseek-moe-16b", capacity_factor=100.0,
                   num_shared_experts=0)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, tcfg)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 16, tcfg.d_model)), dtype=torch.float32)
    got = tmoe.apply_moe(p, x, tcfg)
    w, ids = torch.topk(torch.softmax(x @ p["router"], -1),
                        tcfg.experts_per_token, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for e in range(tcfg.num_experts):
        gate = torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wi"][e])
        sel = ((ids == e).to(x.dtype) * w).sum(-1, keepdim=True)
        want = want + (gate @ p["wo"][e]) * sel
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


# -- the whole model ------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_every_layer_routes_exactly_as_reference_in_fp32(arch, monkeypatch):
    """fp32: each layer's MoE input in the port's ``forward``, routed by the
    port, gives the reference's ids, order, keep and dest on the
    reference's own input to that layer (its block's lines run one by
    one, ``src/repro/models/transformer.py:187-198``)."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = params(jcfg)
    toks = tokens(jcfg, 2, 24)
    seen = []
    orig = tmoe.apply_moe

    def record(p, x, cfg):
        seen.append((p, x))
        return orig(p, x, cfg)

    monkeypatch.setattr(tmoe, "apply_moe", record)
    ttr.forward(tp, torch.as_tensor(toks), tcfg)
    x = jp["embed"].astype(jnp.float32)[jnp.asarray(toks)]
    positions = jnp.arange(toks.shape[1])
    for i in range(jcfg.num_layers):
        jl, _ = _layer_params(jp, tp, i)
        h, _ = jtr.apply_attn(jl["attn"], jrms(x, jl["ln1"].astype(x.dtype),
                                               jcfg.norm_eps),
                              jcfg, positions=positions)
        x = x + h
        h = jrms(x, jl["ln2"].astype(x.dtype), jcfg.norm_eps)
        p_l, x_l = seen[i]
        for got, want in zip(_port_route(p_l, x_l, tcfg), _ref_route(jl["moe"], h, jcfg)):
            np.testing.assert_array_equal(got, want)
        x = x + jmoe.apply_moe(jl["moe"], h, jcfg)
    assert len(seen) == jcfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_fp32(arch):
    jcfg, tcfg = cfgs(arch)
    jparams, tparams = params(jcfg)
    b, s, steps = 2, 12, 4
    toks = tokens(jcfg, b, s)
    j_logits, j_cache = jax.jit(jax_build_model(jcfg).prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)})
    close(t_logits, j_logits, TOL["float32"])
    for key in ("k", "v"):
        close(t_cache[key], j_cache[key], TOL["float32"])
    jpf = jax.jit(functools.partial(jtr.prefill, cfg=jcfg, max_len=s + steps))
    jdec = jax.jit(jax_build_model(jcfg).decode_step)
    j_logits, j_cache = jpf(jparams, jnp.asarray(toks, jnp.int32))
    t_logits, t_cache = prefill(tparams, {"tokens": torch.as_tensor(toks)},
                                s + steps)
    tok = np.argmax(np_(j_logits)[:, -1], -1)
    for i in range(steps):
        j_logits, j_cache = jdec(jparams, j_cache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
        t_logits, t_cache = decode(tparams, t_cache, torch.as_tensor(tok), s + i)
        close(t_logits, j_logits, TOL["float32"])
        tok = np.argmax(np_(j_logits)[:, 0], -1)
    for key in ("k", "v"):
        close(t_cache[key], j_cache[key], TOL["float32"])
    assert launch_counts() == ZERO_LAUNCHES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch, dtype):
    """prefill(t[:n]) + decode(t[n]) against ``forward`` over n+1 tokens, in
    the port, with a capacity factor of E/k, where nothing drops (at the
    published factor a prompt of n tokens can drop assignments that a
    decode step, capacity k, keeps)."""
    _, tcfg = cfgs(arch, dtype)
    tcfg = tcfg.replace(capacity_factor=tcfg.num_experts / tcfg.experts_per_token)
    jcfg, _ = cfgs(arch)
    _, tparams = params(jcfg, seed=1)
    tt = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 17)))
    full = ttr.forward(tparams, tt, tcfg)
    _, caches = ttr.prefill(tparams, tt[:, :-1], tcfg, max_len=17)
    step, _ = ttr.decode_step(tparams, caches, tt[:, -1], 16, tcfg)
    # decode reads k/v from the bf16 cache, forward does not: 3e-2 for both
    close(step[:, 0], full[:, -1], 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    """The hybrid's bf16 rule (``gap=2``): routing at bf16 near-ties and the
    reference's bf16 scatter-add (one rounding per added term) take the
    reference's own bf16 gradients 10% (deepseek) to 50% (qwen3, bf16
    params) from its fp32 ones, where the port's lie within 3e-2 of those."""
    rng = np.random.default_rng(0)
    jcfg, _ = cfgs(arch)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 16))}
    assert_loss_and_grads_match(arch, dtype, batch, gap=2.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_end_to_end_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "[serve] decode:" in out and "sample output ids" in out
    assert res["ids"].shape == (2, 4)
    assert torch.isfinite(res["last_logits"].float()).all()
    assert res["caches"]["k"].shape[2] == 8 + 3
    assert launch_counts() == ZERO_LAUNCHES
