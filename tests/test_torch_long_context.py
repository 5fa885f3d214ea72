"""The port at the repo's shape cells' lengths, scaled to the reduced widths,
against the reference on the CPU.

``chip_smoke.py`` runs the four shape cells of ``configs/base.py``
(prefill_32k, decode_32k with the bf16 and the int8 KV cache, long_500k and
train_4k) on the card at one card's share of their global batch. Here the
same paths run at lengths that are long for the reduced configs:

- reduced llama3-8b: a 1,024-token prompt (16x its d_model) and 4 decode
  steps, with the bf16 cache and with ``kv_quant``, against the reference's
  ``prefill`` / ``decode_step`` at ``tests/test_torch_serve.py``'s bounds;
  the reference's own gap between its int8 and bf16 caches is printed;
- ``chip_smoke.py``'s int8 gates (the logits' gap from the bf16 cache's,
  the codes of layer 0 against the values they encode) pass the sound
  cache and refuse planted faults;
- reduced recurrentgemma-2b: a prompt of 64 windows (2,048 tokens at
  window 32: the ring buffer wraps 64 times) and 4 decode steps, at
  ``tests/test_torch_recurrent.py``'s bounds;
- ``launch/dryrun.py::pick_microbatch`` (train_4k's accumulation) equal to
  the reference's for every arch and shape on the production meshes and on
  one data replica of them;
- ``init_cache``'s bytes per position and row at llama3-8b's full size
  equal to the roofline's KV formula, the reckoning of the card's memory;
- the Themis step's gradient accumulation (``--microbatch``, which the
  reference's Themis step ignores) against the GSPMD step's and the
  reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro.train.step import gspmd_init_state as jax_gspmd_init
from repro.train.step import make_gspmd_train_step as jax_gspmd_step
from _sim_twins import chip_smoke
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, ShapeConfig, TrainConfig, get_arch
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models import transformer as tr
from repro_torch.models.registry import leaves
from repro_torch.train.serve import make_serve_fns
from repro_torch.train.step import (
    gspmd_init_state,
    make_gspmd_train_step,
    make_themis_train_step,
)

# tests/test_torch_serve.py's and tests/test_torch_recurrent.py's bounds
DENSE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
HYBRID_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-1, 0.0)}
DENSE_PROMPT, HYBRID_PROMPT, STEPS = 1024, 2048, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    atol, rtol = tol
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pair(arch, dtype, **kw):
    jcfg = jax_get_arch(arch, reduced=True).replace(remat=False, dtype=dtype, **kw)
    tcfg = get_arch(arch, reduced=True).replace(remat=False, dtype=dtype, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jparams = jax_build_model(jcfg).init(jax.random.key(seed))
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _reference_serve(jcfg, jparams, toks, steps, fed=None):
    """The reference's prefill logits and each decode step's, and its cache
    after them; the decode steps are fed ``fed``, or else the greedy
    tokens of the reference's own logits (returned too, for the port to
    take the same ones)."""
    s = toks.shape[1]
    japi = jax_build_model(jcfg)
    if jcfg.family == "hybrid":
        logits, cache = jax.jit(japi.prefill)(
            jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    else:
        logits, cache = jax.jit(functools.partial(
            jtr.prefill, cfg=jcfg, max_len=s + steps))(jparams, jnp.asarray(toks, jnp.int32))
    out, fed = [logits], list(fed or [])
    dec = jax.jit(japi.decode_step)
    for i in range(steps):
        if i == len(fed):
            fed.append(np.argmax(_np(logits)[:, -1], -1))
        logits, cache = dec(jparams, cache, jnp.asarray(fed[i], jnp.int32),
                            jnp.asarray(s + i, jnp.int32))
        out.append(logits)
    return out, fed, cache


def _port_serve(tcfg, tparams, toks, fed):
    prefill, decode = make_serve_fns(build_model(tcfg), device="cpu")
    s = toks.shape[1]
    logits, cache = prefill(tparams, {"tokens": torch.as_tensor(toks)}, s + len(fed))
    out = [logits]
    for i, tok in enumerate(fed):
        logits, cache = decode(tparams, cache, torch.as_tensor(tok), s + i)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("kv_quant", [False, True])
def test_dense_long_prompt_matches_reference(kv_quant, capsys):
    """Reduced llama3-8b in bf16, 2 x 1,024 tokens then 4 decode steps (the
    same tokens fed to every run): the prefill's and every step's logits
    against the reference's within max(3e-2, 2 g) abs + 3e-2 rel, g the
    largest distance of the reference's bf16 logits from its own fp32 run
    at that step: the hybrid's rule (ROADMAP §3) for two independent bf16
    roundings. At 16 tokens ``test_torch_serve.py``'s 3e-2 holds; at 1,024
    the two frameworks' bf16 attention over the long prompt rounds apart
    by up to 0.07 (g up to 0.085). So the port's bf16 logits must also
    lie within 1.5x the reference's own relative L2 from the reference's
    fp32 run (read: 0.0101-0.0226 against 0.0104-0.0216). With
    ``kv_quant`` the first layer's int8 codes lie within 2 of the
    reference's and its scales within 2e-2 relative (``test_torch_serve.py``'s
    int8 bounds: its k and v come from the same embeddings, one bf16 ulp
    apart at most); a deeper layer's k and v come from the two sides' bf16
    attention over the prompt, some of its codes then up to 4 apart, so
    the logits bound them. The reference's own gap between its int8 and
    its bf16 cache's logits is printed."""
    jcfg, tcfg = _pair("llama3-8b", "bfloat16", kv_quant=kv_quant)
    jparams, tparams = _params(jcfg)
    toks = _tokens(jcfg, 2, DENSE_PROMPT)
    want, fed, jcache = _reference_serve(jcfg, jparams, toks, STEPS)
    got, cache = _port_serve(tcfg, tparams, toks, fed)
    j32 = jcfg.replace(dtype="float32")
    want32, _, _ = _reference_serve(j32, jparams, toks, STEPS, fed)
    readings = []
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        own = float(np.abs(_np(w) - _np(w32)).max())
        readings.append((float(np.abs(_np(g) - _np(w)).max()), own,
                         _rel_l2(g, w32), _rel_l2(w, w32)))
        _close(g, w, (max(DENSE_TOL["bfloat16"][0], 2 * own), DENSE_TOL["bfloat16"][1]),
               f"step {i}")
        assert _rel_l2(g, w32) <= 1.5 * _rel_l2(w, w32), (i, readings[-1])
    with capsys.disabled():
        print(f"\nkv_quant={kv_quant}: per step (prefill, 4 decode steps) max |port - "
              "reference| bf16, the reference's own bf16-vs-fp32 gap g, rel. L2 of "
              "the port's and the reference's bf16 logits from the reference's fp32 "
              "run: " + "; ".join(" ".join(f"{x:.3g}" for x in r) for r in readings))
    assert launch_counts()["flash_attention"] == 0
    if not kv_quant:
        return
    tc = bridge.cache_to_numpy(cache)
    for key in ("k", "v"):
        diff = np.abs(tc[key][0].astype(np.int32) - np.asarray(jcache[key][0], np.int32))
        assert tc[key].dtype == np.int8 and diff.max() <= 2, (key, diff.max())
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[key][0], _np(jcache[key][0]), rtol=2e-2)
    # the reference's own int8-vs-bf16 gap, the bf16 cache fed the same tokens
    bf16, _, _ = _reference_serve(jcfg.replace(kv_quant=False), jparams, toks,
                                  STEPS, fed)
    gaps = [_rel_l2(q, b) for q, b in zip(want, bf16)]
    codes = [int(np.abs(tc[key].astype(np.int32)
                        - np.asarray(jcache[key], np.int32))[layer].max())
             for key in ("k", "v") for layer in range(tcfg.num_layers)]
    with capsys.disabled():
        print(f"\nreference int8-vs-bf16 KV cache, reduced llama3-8b, "
              f"{DENSE_PROMPT}-token prompt: logits rel. L2 prefill "
              f"{gaps[0]:.3e}, decode steps {[f'{g:.3e}' for g in gaps[1:]]}; "
              f"port vs reference codes, largest gap per layer (k, then v): {codes}")
    assert max(gaps) < INT8_GAP_CEILING, gaps


# the largest relative L2 between the reference's int8 and bf16 caches'
# logits that this test accepts (read: 1.90e-2 at the prefill, 1.11e-2 to
# 1.62e-2 at the decode steps)
INT8_GAP_CEILING = 2e-2


def test_int8_gates_catch_planted_faults(capsys):
    """``chip_smoke.py``'s two int8 gates at the reduced config, 2 x 1,024
    tokens in bf16, on the port. The first decode step's logits with the
    int8 cache lie within ``INT8_VS_BF16_LIMIT`` of the bf16 cache's,
    and with every position's codes read with the previous position's
    scales beyond it. Layer 0's codes against the bf16 cache's values
    there lie within ``INT8_CODE_LIMITS``, and the same values quantised
    with a truncating or a flooring round beyond them. The logits of a
    cache quantised with a truncating round are printed beside the sound
    ones: their gap from the bf16 cache's moves less than bf16 noise, so
    only the codes gate sees that fault."""
    cs = chip_smoke()
    cfg = get_arch("llama3-8b", reduced=True).replace(remat=False, dtype="bfloat16")
    params = build_model(cfg).init(0, "cpu")
    toks = torch.as_tensor(_tokens(cfg, 2, DENSE_PROMPT))
    s, real = DENSE_PROMPT, tr._kv_quantize

    def first_step(kv_quant, tok=None, quantize=real, scales_off=False):
        """The prefill's greedy tokens, the first decode step's logits fed
        ``tok`` (else those tokens) and the cache; ``scales_off`` reads
        every position's codes with the previous position's scales."""
        prefill, decode = make_serve_fns(build_model(cfg.replace(kv_quant=kv_quant)), "cpu")
        tr._kv_quantize = quantize
        try:
            with torch.inference_mode():
                logits, cache = prefill(params, {"tokens": toks}, s + 1)
                greedy = logits[:, -1].argmax(-1)
                feed = cache
                if scales_off:
                    feed = {**cache, **{k: torch.roll(cache[k], 1, dims=2)
                                        for k in ("k_scale", "v_scale")}}
                step = decode(params, feed, greedy if tok is None else tok, s)
        finally:
            tr._kv_quantize = real
        return greedy, step[0][:, 0].float(), cache

    def gap(x):
        return ((x - bf16).norm() / bf16.norm()).item()

    tok, bf16, cache16 = first_step(False)
    _, int8, cache8 = first_step(True, tok)
    _, trunc, _ = first_step(True, tok, functools.partial(cs._planted_quantize, rnd=torch.trunc))
    _, off, _ = first_step(True, tok, scales_off=True)
    gaps = {"sound": gap(int8), "trunc": gap(trunc), "scales one position off": gap(off)}
    x0 = {k: cache16[k][0, :, :s] for k in ("k", "v")}
    codes = cs._int8_code_gate(cache8, x0, s)
    with capsys.disabled():
        print(f"\nint8-vs-bf16 first decode logits, rel. L2: {gaps}; layer-0 codes "
              f"(rms, bias, within {cs.INT8_CODE_LIMITS}): {codes}")
    assert gaps["sound"] <= cs.INT8_VS_BF16_LIMIT < gaps["scales one position off"], gaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prompt_of_64_windows_matches_reference(dtype):
    """Reduced recurrentgemma-2b, 2 x 2,048 tokens (64 windows of 32: the
    ring buffer wraps in prefill, the scan runs 2,048 steps from its zero
    state) then 4 decode steps: the prefill's and every step's logits at
    ``test_torch_recurrent.py``'s bounds, the ring buffer's positions
    exactly."""
    jcfg, tcfg = _pair("recurrentgemma-2b", dtype)
    jparams, tparams = _params(jcfg)
    toks = _tokens(jcfg, 2, HYBRID_PROMPT)
    want, fed, _ = _reference_serve(jcfg, jparams, toks, STEPS)
    got, cache = _port_serve(tcfg, tparams, toks, fed)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, HYBRID_TOL[dtype], f"step {i}")
    w = tcfg.local_window
    last = HYBRID_PROMPT + STEPS
    pos = cache["periods"]["s2_attn"]["pos"][0, 0]
    assert sorted(pos.tolist()) == list(range(last - w, last))


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16},
                                  {"data": 16, "model": 1}],
                         ids=["16x16", "2x16x16", "one-replica"])
def test_pick_microbatch_equals_the_reference(axes):
    """Every arch x ``ALL_SHAPES`` x {gspmd, themis} parallel configs (and
    sequence sharding on and off): the port's ``pick_microbatch`` equal to
    the reference's; at one data replica of the 16x16 mesh, where
    ``chip_smoke.py``'s train_4k cell runs, qwen2.5-3b takes 8."""
    from repro.configs import ParallelConfig as JPar
    from repro.configs.base import ALL_SHAPES as J_SHAPES

    from repro_torch.configs import list_archs
    from repro_torch.configs.base import ALL_SHAPES, TRAIN_4K
    from repro_torch.launch.dryrun import pick_microbatch

    ref = _reference_pick_microbatch()
    dp = axes.get("data", 1) * axes.get("pod", 1)
    n = 0
    for arch in list_archs():
        cfg, jcfg = get_arch(arch), jax_get_arch(arch)
        for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
            assert shape.name == jshape.name
            for sp in (False, True):
                par = ParallelConfig(data=dp, model=axes["model"], seq_sharding=sp)
                jpar = JPar(data=dp, model=axes["model"], seq_sharding=sp)
                assert pick_microbatch(cfg, shape, axes, par) == ref(
                    jcfg, jshape, axes, jpar), (arch, shape.name, sp)
                n += 1
    assert n == 10 * 4 * 2
    if axes == {"data": 16, "model": 1}:
        assert pick_microbatch(get_arch("qwen2.5-3b"), TRAIN_4K, axes,
                               ParallelConfig(data=16)) == 8


def _reference_pick_microbatch():
    """The reference's ``pick_microbatch``, read from its source (importing
    ``repro.launch.dryrun`` would set this process's ``XLA_FLAGS``)."""
    import ast
    import importlib.util

    src = importlib.util.find_spec("repro.launch.dryrun").origin
    tree = ast.parse(open(src).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "pick_microbatch")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), src, "exec"), ns)
    return ns["pick_microbatch"]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_cache_bytes_per_position_equal_the_roofline(kv_quant):
    """llama3-8b at full size: ``init_cache``'s bytes for one row and one
    position, on meta, equal the port's and the reference's
    ``kv_cache_bytes`` for one row and one position (131,072 B in bf16;
    66,560 B with int8 codes and bf16 scales), and the reference's own
    ``init_cache``'s."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import roofline as jrl

    from repro_torch.launch import roofline as trl
    from repro_torch.models import transformer as ttr

    cfg = get_arch("llama3-8b").replace(kv_quant=kv_quant)
    jcfg = jax_get_arch("llama3-8b").replace(kv_quant=kv_quant)
    cache = ttr.init_cache(cfg, 1, 1, device="meta")
    got = sum(t.numel() * t.element_size() for t in cache.values())
    jcache = jax.eval_shape(lambda: jtr.init_cache(jcfg, 1, 1))
    jgot = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jcache))
    want = trl.kv_cache_bytes(cfg, ShapeConfig("one", 1, 1, "decode"))
    assert got == jgot == want == jrl.kv_cache_bytes(
        jcfg, JShapeConfig("one", 1, 1, "decode"))
    assert got == (66_560 if kv_quant else 131_072)
    # decode_32k's caches at one card's share: 8 rows of 32,784 positions
    assert got * 8 * 32_784 / 2**30 == pytest.approx(16.25 if kv_quant else 32.02,
                                                     abs=0.01)


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_themis_step_accumulates_microbatches():
    """Reduced qwen2.5-3b with fp32 activations, 3 steps of 4 rows at
    ``microbatch`` 2: the port's one-rank Themis step against the port's
    GSPMD step (losses within 1e-6, gnorms 1e-5 relative; the same
    gradients, summed in the same order) and against the reference's GSPMD
    step at the same microbatches (losses and gnorms within 1e-5, params
    within 1e-2 of each leaf's update and 0.1 lr, as
    ``test_torch_train.py``'s GSPMD test). The Themis step's loss runs on
    two slices of 2 rows each, where the reference's Themis step would take
    all 4 rows at once."""
    from repro_torch.launch.mesh import Mesh

    arch, lr = "qwen2.5-3b", 1e-3
    jcfg, tcfg = _pair(arch, "float32")
    train = dict(learning_rate=lr, warmup_steps=1, total_steps=10, microbatch=2)
    jmodel, api = jax_build_model(jcfg), build_model(tcfg)
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    jstep, *_ = jax_gspmd_step(jmodel, jmesh, JParallelConfig(), JTrainConfig(**train))
    jparams, jopt = jax_gspmd_init(jmodel, jmesh, JParallelConfig())
    init = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    mesh = Mesh((1, 1), ("data", "model"), "cpu")
    rows = []

    def loss_fn(params, batch):
        rows.append(batch["tokens"].shape[0])
        return api.loss_fn(params, batch)

    step_t, init_t, _ = make_themis_train_step(
        dataclasses.replace(api, loss_fn=loss_fn), mesh, ParallelConfig(dp_sync="themis", chunks_per_collective=5),
        TrainConfig(**train))
    pt, ot = init_t(0, "cpu", params=bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    step_g = make_gspmd_train_step(api, None, ParallelConfig(), TrainConfig(**train))
    pg, og = gspmd_init_state(api, None, ParallelConfig(), device="cpu",
                              params=bridge.params_from_jax(
                                  jax.tree.map(np.asarray, jparams), "cpu"))
    for i in range(3):
        batch = _batch(jcfg.vocab_size, 4, 16, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        rows.clear()
        pt, ot, mt = step_t(pt, ot, tb)
        assert rows == [2, 2]
        pg, og, mg = step_g(pg, og, tb)
        assert float(mt["loss"]) == pytest.approx(float(mg["loss"]), rel=1e-6)
        assert float(mt["gnorm"]) == pytest.approx(float(mg["gnorm"]), rel=1e-5)
        assert float(mt["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(mt["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
        assert all(p.grad is None for p in leaves(pt))
    for a, b, c in zip(leaves(pt), jax.tree.leaves(jparams), init):
        a, b = _np(a), _np(b)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - c)
        assert np.abs(a - b).max() <= 0.1 * lr


@pytest.mark.parametrize("dp_sync", ["gspmd", "themis"])
def test_microbatch_steps_hold_one_gradient_sum(dp_sync):
    """At ``microbatch`` 4, when each slice's loss starts, the step holds
    one gradient of each param beside the params and the optimizer state,
    the running sum in the params' ``.grad`` (from the second slice on;
    no other tensor of the MLP's ``wo`` shape beyond those at the first
    slice's start). The previous slice's gradients are gone; on one card
    that is the difference between train_4k's GSPMD step fitting and not
    (11.5 GiB of qwen2.5-3b's fp32 gradients)."""
    import gc
    import warnings

    from repro_torch.launch.mesh import Mesh

    cfg = get_arch("qwen2.5-3b", reduced=True).replace(dtype="float32", remat=False)
    api = build_model(cfg)
    train = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=4)
    shape = tuple(api.param_spec()["blocks"]["mlp"]["wo"].shape)
    seen, params = [], None

    def loss_fn(p, batch):
        grads = {id(q.grad) for q in leaves(params) if q.grad is not None}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            n = sum(1 for o in gc.get_objects() if isinstance(o, torch.Tensor)
                    and tuple(o.shape) == shape and id(o) not in grads)
        seen.append((n, len(grads)))
        return api.loss_fn(p, batch)

    rec = dataclasses.replace(api, loss_fn=loss_fn)
    if dp_sync == "gspmd":
        step = make_gspmd_train_step(rec, None, ParallelConfig(), train)
        params, opt = gspmd_init_state(api, None, ParallelConfig(), device="cpu")
    else:
        step, init, _ = make_themis_train_step(
            rec, Mesh((1, 1), ("data", "model"), "cpu"),
            ParallelConfig(dp_sync="themis", chunks_per_collective=5), train)
        params, opt = init(0, "cpu")
    assert sum(tuple(q.shape) == shape for q in leaves(params)) == 1
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size, 8, 16, 0).items()}
    step(params, opt, batch)
    n_leaves = len(leaves(params))
    extra = [n - seen[0][0] for n, _ in seen]
    with_grad = [g for _, g in seen]
    assert extra == [0] * 4 and with_grad == [0] + [n_leaves] * 3, seen


def test_themis_update_runs_chunk_by_chunk(monkeypatch):
    """The Themis step's AdamW update runs on one chunk's shard at a time,
    so its two temporaries are a chunk's size: over a whole rank's shard
    they were 23 GiB at qwen2.5-3b on one card, where the step ran out of
    memory. The chunked update computes the same values elementwise."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import step as tstep

    cfg = get_arch("qwen2.5-3b", reduced=True).replace(dtype="float32", remat=False)
    api = build_model(cfg)
    sizes, real = [], tstep.adamw_step_

    def adamw_step_(p, *args, **kw):
        sizes.append(tuple(p.shape))
        return real(p, *args, **kw)

    monkeypatch.setattr(tstep, "adamw_step_", adamw_step_)
    step, init, _ = make_themis_train_step(
        api, Mesh((1, 1), ("data", "model"), "cpu"),
        ParallelConfig(dp_sync="themis", chunks_per_collective=5),
        TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10))
    params, opt = init(0, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size, 4, 16, 0).items()}
    step(params, opt, batch)
    assert sizes == [tuple(opt["master"].shape[1:])] * 5


@pytest.mark.parametrize("device, preset, want", [
    ("cuda", {}, {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}),
    ("cuda", {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"},
     {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"}),
    ("cuda", {"PYTORCH_ALLOC_CONF": "backend:native"}, {"PYTORCH_ALLOC_CONF": "backend:native"}),
    ("cpu", {}, {}),
], ids=["unset", "cuda-conf-set", "alloc-conf-set", "cpu"])
def test_cuda_runs_default_to_expandable_segments(monkeypatch, device, preset, want):
    """An entry point's CUDA device (``device.resolve_device``) sets the
    caching allocator's expandable segments, which long_500k needs on one
    card, unless the caller made an allocator setting; a CPU run sets
    nothing."""
    from repro_torch import device as dev

    env = dict(preset)
    monkeypatch.setattr(dev.os, "environ", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dev.resolve_device(device).type == device
    assert env == want
