"""K1's and K2's backward kernels: what the CPU can check of them.

The kernels (``csrc/flash_attention_bwd_sm90.cu``,
``csrc/flash_attention_bwd.cu`` and the Triton kernels in
``kernels/rmsnorm.py``) run only on the card, where ``chip_smoke.py`` holds
them against their plain versions. Here:

- the route each call takes (``bwd_route``);
- a CPU backward through ``ops.flash_attention`` or ``ops.rmsnorm`` runs
  the plain version, launches nothing, and equals the reference's
  ``jax.vjp`` of its public op at the training tests' tolerances (fp32 1e-5
  abs / 1e-4 rel, bf16 2e-2; dw relative to its size);
- on a CPU tensor the wrappers return the plain backwards' results to the
  bit, and on a tensor that is neither on the CPU nor on a card they raise;
- each source exports the C symbol its wrapper binds, with the argument
  types the wrapper declares;
- the build key covers the shared headers;
- the plain RMSNorm versions compute in fp64 on fp64 inputs, the exact
  reference that ``chip_smoke.py`` holds K2's fp32 gradients to.
"""
import ctypes
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import common as jc
from repro_torch import bridge
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models.common import flash_attention_bwd

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, shapes, dtype):
    """Both frameworks' copies of the same seeded inputs, rounded once."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), DTYPES[dtype]) for s in shapes]
    return js, [bridge.params_from_jax(np.asarray(j), "cpu") for j in js]


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    atol, rtol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 256, "sm90"), (torch.float32, 16, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_backward_route_choice(dtype, d, want):
    assert tfa.bwd_route(dtype, d) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,t,win", [
    (2, 128, 4, 2, 64, 128, 0),
    (1, 200, 8, 1, 64, 200, 0),       # MQA + ragged seq
    (2, 96, 4, 4, 32, 96, 32),        # sliding window
    (1, 64, 2, 2, 128, 256, 0),       # cross-length kv
    (1, 257, 3, 3, 16, 257, 64),      # odd sizes
])
def test_cpu_flash_backward_launches_nothing_and_matches_reference(
        b, s, h, kv, d, t, win, dtype):
    """K1's autograd function on the CPU, at ``tests/test_kernels.py``'s
    shapes, against the reference's VJP of its public
    ``ops.flash_attention`` (the Pallas forward in interpret mode, the XLA
    recompute backward): fp32 within 1e-5 abs / 1e-4 rel, bf16 within 2e-2
    of max(1, each gradient's largest magnitude), the bound ``chip_smoke.py``
    holds the kernels to (bf16 rounds P and dS in a different place on each
    side)."""
    reset_launch_counts()
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(
        21, [(b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d)], dtype)
    want = jax.vjp(lambda a, x, c: jops.flash_attention(a, x, c, True, win),
                   jq, jk, jv)[1](jg)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(tops.flash_attention(q, k, v, True, win), (q, k, v), g)
    for x, y, ref in zip(got, want, (q, k, v)):
        assert x.dtype == ref.dtype
        if dtype == "float32":
            _close(x, y, dtype)
        else:      # the card's bf16 bound: two bf16 roundings of P and dS
            err = np.abs(_np(x) - _np(y)).max()
            assert err <= 2e-2 * max(1.0, np.abs(_np(y)).max()), err
    assert set(launch_counts().values()) == {0}, launch_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_rmsnorm_backward_launches_nothing_and_matches_reference(dtype):
    """K2's autograd function on the CPU against the reference's VJP of its
    ``rms_norm`` (dw relative to its size, as it sums every row); K1's
    autograd function is held the same way by
    ``tests/test_torch_train.py::test_flash_backward_matches_reference``."""
    reset_launch_counts()
    (jx, jw, jdy), (x, w, dy) = _inputs(22, [(3, 20, 64), (64,), (3, 20, 64)],
                                        dtype)
    jdx, jdw = jax.vjp(lambda a, b: jc.rms_norm(a, b, 1e-6), jx, jw)[1](jdy)
    x.requires_grad_(True)
    w.requires_grad_(True)
    dx, dw = torch.autograd.grad(tops.rmsnorm(x, w, 1e-6), (x, w), dy)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx, jdx, dtype)
    rel = np.linalg.norm(_np(dw) - _np(jdw)) / np.linalg.norm(_np(jdw))
    assert rel <= (1e-5 if dtype == "float32" else 2e-2)
    assert set(launch_counts().values()) == {0}, launch_counts()


def test_cpu_wrappers_are_the_plain_backwards():
    (_, _, _), (q, k, v) = _inputs(23, [(1, 70, 4, 16), (1, 70, 1, 16),
                                        (1, 70, 1, 16)], "float32")
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    out, lse = tfa.flash_attention(q, k, v, causal=True, window=24)
    got = tfa.flash_attention_backward(q, k, v, out, lse, g, causal=True, window=24)
    want = flash_attention_bwd(q, k, v, out, lse, g, causal=True, window=24)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, w, dy = (torch.randn(s, generator=torch.Generator().manual_seed(i))
                for i, s in enumerate(((5, 48), (48,), (5, 48))))
    assert all(torch.equal(a, b) for a, b in zip(
        trn.rmsnorm_grad(x, w, dy), trn.rmsnorm_backward(x, w, dy)))


def test_backward_wrappers_reject_non_cpu_non_cuda():
    """All on meta (the dry run): empty gradients of the inputs' shapes and
    dtypes, 2.5x the forward's FLOPs (K1) and 8 an element (K2) tallied, no
    launch; on mixed devices they raise."""
    from repro_torch import kernels

    q = torch.zeros((1, 8, 2, 16), device="meta")
    k = torch.zeros((1, 8, 1, 16), device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    kernels.reset_meta_flops()
    before = kernels.launch_counts()
    dq, dk, dv = tfa.flash_attention_backward(q, k, k, q, lse, q)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert all(t.is_meta for t in (dq, dk, dv))
    x = torch.zeros((4, 16), device="meta")
    dx, dw = trn.rmsnorm_grad(x, torch.zeros((16,), device="meta"), x)
    assert dx.shape == (4, 16) and dw.shape == (16,) and dx.is_meta
    assert kernels.meta_flops() == int(2.5 * 4 * 16 * 2 * 36) + 8 * 64
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_backward(q, k, k, q, torch.zeros((1, 2, 8)), q)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm_grad(x, torch.zeros((16,)), x)


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("key", sorted(tfa.KERNELS), ids="-".join)
def test_sources_export_the_symbols_the_wrapper_binds(key):
    source, symbol, argtypes = tfa.KERNELS[key]
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"{source}.cu does not export {symbol}"
    params = [p.strip() for p in found.group(1).split(",")]
    declared = [ctypes.c_void_p if "*" in p else _CTYPE[p.split()[0]] for p in params]
    assert declared == argtypes


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert {"hopper.cuh", "attention_bwd.cuh"} <= set(headers)
    monkeypatch.setattr(_build, "CSRC", csrc)
    for header in headers:
        before = {n: _build._target(n) for n in ("flash_attention_bwd_sm90",
                                                  "flash_attention_sm90")}
        with open(csrc / header, "a") as f:
            f.write("\n// edited\n")
        after = {n: _build._target(n) for n in before}
        assert all(before[n] != after[n] for n in before), header
    before = _build._target("rglru_scan")
    (csrc / "rglru_scan.cu").write_text((csrc / "rglru_scan.cu").read_text() + "\n")
    assert _build._target("rglru_scan") != before


def test_plain_rmsnorm_versions_compute_fp64_inputs_in_fp64():
    rng = np.random.default_rng(25)
    x, dy = (rng.standard_normal((64, 48)) for _ in range(2))
    w = rng.standard_normal(48)
    r = 1.0 / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)
    want_y = x * r * w
    want_dw = (dy * x * r).sum(0)
    dn = dy * w
    want_dx = r * (dn - x * r * (dn * x * r).mean(-1, keepdims=True))
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, w, dy))
    y = trn.rmsnorm_plain(xt, wt)
    dx, dw = trn.rmsnorm_backward(xt, wt, dyt)
    assert y.dtype == dx.dtype == dw.dtype == torch.float64
    for got, want in ((y, want_y), (dx, want_dx), (dw, want_dw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    y32 = trn.rmsnorm_plain(xt.float(), wt.float()).double()
    assert (y32 - y).abs().max() > 1e-9      # the fp32 evaluation is not this
