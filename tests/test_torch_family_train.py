"""Training the MoE, VLM, audio and SSM families: what the CPU can check.

On the card ``chip_smoke.py`` trains whisper-medium, internvl2-26b,
qwen3-moe-235b-a22b and xlstm-1.3b through ``launch/train.py`` and holds
their kernels to the plain versions. Here:

- K1's autograd function without a mask, the branch whisper's encoder and
  cross-attention train through (S = T and T != S with T ragged against
  the reference's kv block of 128 and the port's plain backward's of
  1024; GQA groups 1, 6 and 16), against the
  reference's ``jax.vjp`` of its public ``ops.flash_attention(..., False,
  0)`` (the Pallas forward in interpret mode, the XLA recompute backward):
  fp32 within 1e-5 abs / 1e-4 rel, bf16 within 2e-2 of max(1, each
  gradient's largest magnitude), launching nothing;
- the clip and AdamW on bf16 params (qwen3-moe's own ``param_dtype``, the
  port's only training path with bf16 params) against the reference's
  ``clip_by_global_norm`` and ``adamw_update`` over ten steps;
- ``launch/train.py`` end to end on the four reduced configs: finite,
  falling losses, the first equal to the bit to the port's ``loss_fn`` on
  the initial weights and the driver's batch (whisper's frames included),
  and for the VLM one more step through the returned ``step_fn`` with stub
  patches in front of the tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.kernels import ops as jops
from repro.train import optimizer as jopt
from repro_torch import bridge
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.registry import leaves
from repro_torch.train import optimizer as topt

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a case runs: the suite runs
    several workers on the machine's cores, and the reduced models' small
    ops, each split over a thread per core, then spend most of their time
    waiting for those threads. The values do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,t", [
    (2, 64, 4, 4, 32, 64),        # S = T, MHA (whisper's encoder)
    (1, 48, 4, 4, 64, 1100),      # T != S, T ragged against both packages' kv
                                  # blocks, 128 and 1024 (whisper's cross-attention)
    (1, 130, 6, 1, 32, 130),      # group 6, S = T ragged
    (1, 40, 16, 1, 64, 150),      # group 16, T != S, T ragged
])
def test_cpu_noncausal_flash_backward_matches_reference(b, s, h, kv, d, t, dtype):
    reset_launch_counts()
    rng = np.random.default_rng(26)
    js = [jnp.asarray(rng.standard_normal(shape), DTYPES[dtype])
          for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]
    jq, jk, jv, jg = js
    q, k, v, g = (bridge.params_from_jax(np.asarray(x), "cpu") for x in js)
    want = jax.vjp(lambda a, x, c: jops.flash_attention(a, x, c, False, 0),
                   jq, jk, jv)[1](jg)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(tops.flash_attention(q, k, v, False, 0), (q, k, v), g)
    for x, y, ref in zip(got, want, (q, k, v)):
        assert x.dtype == ref.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(x), _np(y), atol=1e-5, rtol=1e-4)
        else:      # the card's bf16 bound: two bf16 roundings of P and dS
            err = np.abs(_np(x) - _np(y)).max()
            assert err <= 2e-2 * max(1.0, np.abs(_np(y)).max()), err
    assert set(launch_counts().values()) == {0}, launch_counts()


def test_adamw_and_clip_on_bf16_params_match_reference():
    """Ten clipped and unclipped steps on a tree of bf16 params with bf16
    gradients, as qwen3-moe trains: the norms within 1e-6 relative (the two
    sum the leaves in another order), the params equal to the bit (both
    scale each bf16 gradient by the clip scale cast to bf16, update in
    fp32 with the same rounding steps and round the param to bf16 once),
    m and v within ``test_adamw_and_clip_match_reference_over_ten_steps``'s
    bound of 1e-6 of each leaf's scale."""
    rng = np.random.default_rng(9)
    # two leaf shapes: the reference's eager update compiles each op per shape
    shapes = {"experts": (2, 16, 24), "attn": {"wq": (16, 24), "wo": (16, 24)},
              "embed": (16, 24)}

    def tree(f, node=shapes):
        return {k: tree(f, v) if isinstance(v, dict) else f(v) for k, v in node.items()}

    jparams = tree(lambda s: jnp.asarray(rng.standard_normal(s), jnp.bfloat16))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert all(p.dtype == torch.bfloat16 for p in leaves(tparams))
    kw = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2, grad_clip=2.0)
    cfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(tparams)
    for i in range(10):
        scale = 0.02 if i % 2 else 3.0    # clip on every other step
        jg = tree(lambda s: jnp.asarray(rng.standard_normal(s) * scale, jnp.bfloat16))
        tg = bridge.params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        jg, jnorm = jopt.clip_by_global_norm(jg, jcfg.grad_clip)
        jparams, jstate, jlr = jopt.adamw_update(jg, jstate, jparams, jcfg)
        tnorm = topt.clip_by_global_norm(tg, cfg.grad_clip)
        tlr = topt.adamw_update(tg, tstate, tparams, cfg)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        assert (float(tnorm) > cfg.grad_clip) == (i % 2 == 0)
        assert tlr == pytest.approx(float(jlr), rel=1e-6)
        for a, b in zip(leaves(tg), jax.tree.leaves(jg)):    # the clipped grads
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(a), _np(b))
    assert tstate["count"] == int(jstate["count"]) == 10
    for a, b in zip(leaves(tparams), jax.tree.leaves(jparams)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(a), _np(b))
    for name, t, j in (("m", tstate["m"], jstate["m"]), ("v", tstate["v"], jstate["v"])):
        for a, b in zip(leaves(t), jax.tree.leaves(j)):
            b = _np(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b",
                                  "qwen3-moe-235b-a22b", "xlstm-1.3b"])
def test_launch_train_families_end_to_end_on_cpu(arch, capsys):
    """Three steps of the reduced config through the driver on one fixed
    batch: finite, falling losses, the first equal to the bit to ``loss_fn``
    of the initial weights on the batch the driver returns (whisper's stub
    frames in it); qwen3-moe keeps its bf16 params. The VLM, whose batches
    the driver draws without patches as the reference's does, then takes
    one step through the returned ``step_fn`` with 16 stub patches in front
    of the tokens, its loss equal to ``loss_fn`` on that batch."""
    res = ttrain.main(["--reduced", "--arch", arch, "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--log-every", "1",
                       "--fixed-batch", "--lr", "1e-2"])
    assert "step     3 loss=" in capsys.readouterr().out
    losses = res["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    cfg = res["cfg"]
    assert cfg == get_arch(arch, reduced=True)
    api = build_model(cfg)
    batch = res["batch"]
    assert ("frames" in batch) == (cfg.family == "audio")
    init = api.init(0, "cpu")
    if arch == "qwen3-moe-235b-a22b":
        assert {p.dtype for p in leaves(init)} == {torch.bfloat16}
        assert {p.dtype for p in leaves(res["params"])} == {torch.bfloat16}
    for p in leaves(init):
        p.requires_grad_(True)
    assert api.loss_fn(init, batch).item() == losses[0]
    if cfg.family == "vlm":
        patched = {**batch, "patches": tserve.synthetic_batch(cfg, 2, 16, device="cpu")["patches"]}
        with torch.no_grad():
            want = api.loss_fn(res["params"], patched).item()
            unpatched = api.loss_fn(res["params"], batch).item()
        _, _, m = res["step_fn"](res["params"], res["opt"], patched)
        assert float(m["loss"]) == want and np.isfinite(want)
        assert want != unpatched
