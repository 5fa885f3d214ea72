"""The mLSTM's chunk recurrence (``repro_torch.kernels.mlstm``) against the
reference on the CPU.

The reference has no Pallas kernel here: it runs ``_mlstm_chunk_scan``'s
``body`` under ``jax.lax.scan`` over chunks (``repro/models/xlstm.py:108``).
The port splits it in two: ``mlstm_intra_terms`` (the carry-free terms of
every chunk, in torch) and ``mlstm_carry`` (the loop over chunks, one
launch of ``csrc/mlstm_scan.cu`` on the card; ``mlstm_carry_plain``, the
kernel's arithmetic chunk by chunk, on the CPU). The same seeded numpy
inputs go through the reference's scan and through the two parts: batch 1,
2 heads of 8, S = 5 x 256 + 37 (a ragged last chunk) and S = 100 (one
chunk shorter than 256), from zeros and from a state; the state the saving
forward keeps for every chunk against the reference's scan over the chunks
before it. Tolerances: fp32 1e-5 (the scan's, ``tests/test_kernels.py``),
bf16 2e-2. The kernel itself runs only on the card (``chip_smoke.py``'s
``_mlstm_checks``); here its shapes, its plan and its C interface.
"""
import ctypes
import re

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _family_twins import both, close
from repro.models import xlstm as jxl
from repro_torch import kernels
from repro_torch.kernels import _build, mlstm, ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
S_LONG = 5 * mlstm.CHUNK + 37


def _inputs(s, with_state, seed=31):
    """q, k, v normal / 2, sigmoid input gates, log forget gates near
    log(sigmoid(3)), and C0, n0 (or zeros); numpy, batch 1, 2 heads of 8."""
    rng = np.random.default_rng(seed)
    b, nh, dh = 1, 2, 8
    arrays = [rng.standard_normal((b, s, nh, dh)) * 0.5 for _ in range(3)]
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, nh))))
    logf = -np.log1p(np.exp(-(rng.standard_normal((b, s, nh)) + 3.0)))
    scale = 0.1 if with_state else 0.0
    C0 = rng.standard_normal((b, nh, dh, dh)) * scale
    n0 = rng.standard_normal((b, nh, dh)) * scale
    return (*arrays, i, logf, C0, n0)


def _both(arrays, dtype):
    """q, k, v in the activations' dtype; the gates and the state in fp32."""
    return zip(*(both(a, dtype if n < 3 else "float32") for n, a in enumerate(arrays)))


def _two_parts(q, k, v, i, logf, C0, n0, group=None):
    cl, h_intra, d_intra = mlstm.mlstm_intra_terms(q, k, v, i, logf, group)
    return mlstm.mlstm_carry_plain(q, k, v, i, cl, h_intra, d_intra, C0, n0)


@pytest.mark.parametrize("s", [S_LONG, 100], ids=["ragged", "short"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_intra_terms_and_carry_match_the_reference(dtype, with_state, s):
    """h, C and n of the two parts against the reference's scan, on the same
    inputs; with ``save`` the same bits, and the nc - 1 states between
    chunks, C and n entering chunk j > 0, against the reference's scan over
    chunks 0 .. j-1."""
    arrays = _inputs(s, with_state)
    js, ts = _both(arrays, dtype)
    got = _two_parts(*ts)
    for g, want in zip(got, jxl._mlstm_chunk_scan(*js)):
        close(g, want, TOL[dtype])
    q, k, v, i, logf, C0, n0 = ts
    saved = mlstm.mlstm_carry_plain(q, k, v, i, *mlstm.mlstm_intra_terms(q, k, v, i, logf),
                                    C0, n0, save=True)
    assert all(torch.equal(a, b) for a, b in zip(saved[:3], got))
    L, nc = mlstm._chunks(s)
    assert saved[3].shape == (1, nc - 1, 2, 8, 8) and saved[4].shape == (1, nc - 1, 2, 8)
    for j in range(1, nc):
        head = [x[:, :j * L] for x in js[:5]]
        _, want_C, want_n = jxl._mlstm_chunk_scan(*head, js[5], js[6])
        close(saved[3][:, j - 1], want_C, TOL[dtype])
        close(saved[4][:, j - 1], want_n, TOL[dtype])


@pytest.mark.parametrize("group", [1, 2, 5])
def test_intra_terms_do_not_depend_on_the_group(group):
    """Any batch of chunks gives the same intra terms as the default."""
    _, ts = _both(_inputs(S_LONG, False), "float32")
    want = mlstm.mlstm_intra_terms(*ts[:5])
    for g, w in zip(mlstm.mlstm_intra_terms(*ts[:5], group), want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_intra_group_caps_the_bytes():
    """The intra pass's batch at long_500k (B 1, 4 heads of 1024, chunks of
    256) holds about INTRA_GROUP_BYTES of temporaries; short prompts take one
    chunk a batch at least."""
    g = mlstm.intra_group(1, 4, 1024, 524288)
    per_chunk = 4 * 256 * (20 * 256 + 4 * 1024)
    assert g == mlstm.INTRA_GROUP_BYTES // per_chunk and 50 <= g <= 200
    assert mlstm.intra_group(4, 4, 1024, 2048) >= 8
    assert mlstm.intra_group(10**6, 64, 4096, 4096) == 1


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
def test_ops_on_the_cpu_is_the_plain_loop_and_launches_nothing(grad):
    """``ops.mlstm_chunk_scan`` on CPU tensors runs the two plain parts (their
    bits), with and without autograd (the saving forward), and launches no
    kernel; under autograd the gradients flow through the backward's plain
    route."""
    _, ts = _both(_inputs(S_LONG, True), "float32")
    ts = [t.clone().requires_grad_(grad) for t in ts]
    before = kernels.launch_counts()
    with torch.set_grad_enabled(grad):
        got = ops.mlstm_chunk_scan(*ts)
    with torch.no_grad():
        want = _two_parts(*ts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if grad:
        sum(x.sum() for x in got).backward()
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in ts)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("s", [S_LONG, 100, 512])
def test_meta_branch_counts_the_plain_loops_flops(s):
    """On meta tensors ``ops.mlstm_chunk_scan`` runs the intra terms and the
    kernel's meta branch: empty outputs of the kernel's shapes and dtypes,
    no launch, and, with ``kernels.meta_flops()``, the FLOPs that
    ``torch.utils.flop_counter`` counts for the two plain parts on the same
    meta tensors (the ragged last chunk padded, as the kernel runs it). On
    mixed devices the kernel's wrapper raises."""
    b, nh, dh = 2, 4, 32

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")

    q, k, v = (meta(b, s, nh, dh, dt=torch.bfloat16) for _ in range(3))
    i, logf = meta(b, s, nh), meta(b, s, nh)
    C0, n0 = meta(b, nh, dh, dh), meta(b, nh, dh)
    with FlopCounterMode(display=False) as plain:
        _two_parts(q, k, v, i, logf, C0, n0)
    kernels.reset_meta_flops()
    before = kernels.launch_counts()
    with torch.no_grad(), FlopCounterMode(display=False) as intra:
        h, C, n = ops.mlstm_chunk_scan(q, k, v, i, logf, C0, n0)
    assert kernels.launch_counts() == before
    assert all(x.is_meta for x in (h, C, n))
    assert (h.shape, C.shape, n.shape) == ((b, s, nh, dh), (b, nh, dh, dh), (b, nh, dh))
    assert h.dtype == torch.bfloat16 and C.dtype == n.dtype == torch.float32
    assert kernels.meta_flops() == mlstm.carry_flops(b, s, nh, dh) > 0
    assert intra.get_total_flops() + kernels.meta_flops() == plain.get_total_flops()
    cl = meta(b, s, nh)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm_carry(q, k, v, i, cl, q, cl, torch.zeros((b, nh, dh, dh)), n0)


def test_plan_at_the_paths_shapes_and_its_refusals():
    """xlstm-1.3b (4 heads of 1024): 32 columns of C a block, B x 4 x 32
    blocks, 227,888 bytes of shared memory on the mma route (bf16: two ring
    stages of q and k beside C^T) and 207,360 on the SIMT route (fp32); the
    reduced config's dh 32 one block a head; the tests' dh 8 the whole
    head. Head dims other than 8, 16 and multiples of 32, and C^T beyond
    227 KB, raise."""
    assert mlstm.plan(4, 4, 1024, 2) == (32, 512, 227888)
    assert mlstm.plan(1, 4, 1024, 2) == (32, 128, 227888)
    assert mlstm.plan(4, 4, 1024, 4) == (32, 512, 207360)
    assert mlstm.plan(2, 4, 32, 2) == (32, 8, 96944)
    assert mlstm.plan(2, 4, 32, 4) == (32, 8, 76416)
    assert mlstm.plan(1, 2, 8, 2) == (8, 2, 22944)
    assert mlstm.plan(1, 2, 8, 4) == (8, 2, 31136)
    assert (mlstm.route(2, 1024), mlstm.route(2, 32), mlstm.route(2, 8),
            mlstm.route(4, 1024)) == ("mma", "mma", "simt", "simt")
    for dh in (24, 48, 100):
        with pytest.raises(ValueError, match="head dim"):
            mlstm.plan(1, 4, dh, 2)
    with pytest.raises(ValueError, match="shared memory"):
        mlstm.plan(1, 4, 2048, 2)


def test_source_exports_the_symbol_the_wrapper_binds():
    """``repro_mlstm_scan``'s C parameters are the ctypes signature the
    wrapper binds, and the block's constants (``mlstm.cuh``, shared with the
    backward) are the wrapper's."""
    symbol, argtypes = mlstm.KERNEL
    text = (_build.CSRC / "mlstm_scan.cu").read_text()
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"mlstm_scan.cu does not export {symbol}"
    declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (p.strip() for p in found.group(1).split(","))]
    assert declared == argtypes
    text = (_build.CSRC / "mlstm.cuh").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
              for name in ("THREADS", "ROWS", "MMA_COLS", "MMA_DT")}
    assert consts == {"THREADS": mlstm.THREADS, "ROWS": mlstm.CHUNK,
                      "MMA_COLS": mlstm.MMA_COLS, "MMA_DT": mlstm.MMA_DT}
    assert mlstm.ROWS == mlstm.CHUNK
