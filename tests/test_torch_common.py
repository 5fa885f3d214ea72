"""The port's shared layers against ``repro/models/common.py`` on the CPU.

The same seeded numpy inputs go through the JAX function and its port.
Tolerances: attention 5e-6/5e-5 in fp32 (``tests/test_kernels.py``),
rms_norm 1e-5 in fp32, everything 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch import bridge
from repro_torch.models import common as tc

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, shapes, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s) * scale, DTYPES[dtype])
          for s in shapes]
    return js, [bridge.params_from_jax(np.asarray(j), "cpu") for j in js]


def _close(got, want, dtype, fp32_tol=(5e-6, 5e-5)):
    atol, rtol = fp32_tol if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(bridge.to_numpy(got),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope(dtype, theta):
    (jx,), (x,) = _inputs(0, [(2, 24, 3, 32)], dtype)
    jpos = jnp.arange(24) + 7
    got = tc.apply_rope(x, torch.arange(24) + 7, theta)
    assert got.dtype == x.dtype
    _close(got, jc.apply_rope(jx, jpos, theta), dtype, fp32_tol=(1e-5, 1e-5))


def test_repeat_kv():
    (jk,), (k,) = _inputs(1, [(2, 5, 3, 8)])
    _close(tc._repeat_kv(k, 4), jc._repeat_kv(jk, 4), "float32", (0, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,window,q_offset,s,t", [
    (4, 2, 0, 0, 40, 40),      # GQA prefill
    (4, 1, 16, 0, 40, 40),     # MQA + sliding window
    (4, 2, 0, 40, 1, 41),      # decode step
    (4, 4, 8, 24, 16, 40),     # chunk at an offset, windowed
])
def test_naive_attention(dtype, h, kv, window, q_offset, s, t):
    (jq, jk, jv), (q, k, v) = _inputs(
        2, [(2, s, h, 16), (2, t, kv, 16), (2, t, kv, 16)], dtype)
    got = tc.naive_attention(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    want = jc.naive_attention(jq, jk, jv, causal=True, window=window,
                              q_offset=q_offset)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,q_offset", [(0, 0), (16, 0), (0, 20)])
def test_blockwise_flash_forward(dtype, window, q_offset):
    (jq, jk, jv), (q, k, v) = _inputs(
        3, [(2, 100, 4, 32), (2, 120, 2, 32), (2, 120, 2, 32)], dtype)
    got = tc.flash_attention_xla(q, k, v, causal=True, window=window,
                                 q_offset=q_offset, block_q=32, block_k=32)
    want = jc.flash_attention_xla(jq, jk, jv, causal=True, window=window,
                                  q_offset=q_offset, block_q=32, block_k=32)
    _close(got, want, dtype)
    _, tl = tc._flash_fwd_impl(q, k, v, q_offset, True, window, 32, 32)
    _, jl = jc._flash_fwd_impl(jq, jk, jv, q_offset, True, window, 32, 32)
    _close(tl, jl, "float32", fp32_tol=(1e-5, 1e-5))
    if dtype == "float32":
        _close(got, tc.naive_attention(q, k, v, causal=True, window=window,
                                       q_offset=q_offset), dtype)


@pytest.mark.parametrize("impl", ["xla_flash", "pallas", "naive"])
def test_attention_dispatch_on_cpu(impl):
    (jq, jk, jv), (q, k, v) = _inputs(
        4, [(1, 48, 4, 16), (1, 48, 2, 16), (1, 48, 2, 16)])
    got = tc.attention(q, k, v, impl=impl)
    _close(got, jc.naive_attention(jq, jk, jv), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
    (jx, jwi, jwo, jwg), (x, wi, wo, wg) = _inputs(
        5, [(2, 7, 32), (32, 64), (64, 32), (32, 64)], "float32", 0.3)
    jp = {"wi": jwi, "wo": jwo, "wg": jwg}
    tp = {"wi": wi, "wo": wo, "wg": wg}
    jx = jx.astype(DTYPES[dtype])
    x = x.to(torch.bfloat16) if dtype == "bfloat16" else x
    _close(tc.apply_mlp(tp, x, gated), jc.apply_mlp(jp, jx, gated), dtype,
           fp32_tol=(1e-5, 1e-5))


def test_init_mlp_shapes_and_scales():
    import jax

    jp = jc.init_mlp(jax.random.key(0), 64, 256, True)
    tp = tc.init_mlp(torch.Generator().manual_seed(0), 64, 256, True,
                     lead=(3,))
    for name in ("wi", "wo", "wg"):
        assert tuple(tp[name].shape) == (3, *jp[name].shape)
        np.testing.assert_allclose(float(tp[name].std()),
                                   float(jnp.std(jp[name])), rtol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    (jx,), (x,) = _inputs(6, [(3, 9, 64)], dtype, 2.0)
    (jw,), (w,) = _inputs(7, [(64,)], dtype)
    got = tc.rms_norm(x, w, 1e-6)
    assert got.dtype == x.dtype
    _close(got, jc.rms_norm(jx, jw, 1e-6), dtype, fp32_tol=(1e-5, 1e-5))
