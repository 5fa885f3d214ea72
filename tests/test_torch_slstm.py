"""The sLSTM recurrence (``repro_torch.kernels.slstm``) against the
reference on the CPU.

The reference has no Pallas kernel here: it runs ``_slstm_cell`` under
``jax.lax.scan`` (``repro/models/xlstm.py`` ``apply_slstm``). The same
seeded numpy inputs go through that scan and through ``slstm_scan_plain``
(the step loop the CPU wrapper runs, and the card's kernel is held to in
``chip_smoke.py``): nh 4 and dh 16 (the reduced xlstm-1.3b's sLSTM), B 2, S
up to 64, with and without a state. Tolerances: fp32 1e-5 (the scan's,
``tests/test_kernels.py``), bf16 2e-2. The gate mapping is the reference's
flat split of the per-head product, checked against a planted per-head
split that a head-local kernel would compute, and the kernel's column
layout (``csrc/slstm_scan.cu``) is mirrored here in numpy.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _family_twins import both, cfgs, close, np_, params
from repro.models import xlstm as jxl
from repro_torch import bridge, kernels
from repro_torch.kernels import _build
from repro_torch.kernels import slstm
from repro_torch.models import xlstm as txl

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, NH, DH = 2, 4, 16
D = NH * DH


def _inputs(seed, s, with_state, nh=NH, dh=DH):
    """gx (B, S, 4D) normal, r_gates (nh, dh, 4dh) at the reference's init
    scale (fan-in dh), h0 in (-1, 1) and c0 normal (or None); numpy."""
    rng = np.random.default_rng(seed)
    d = nh * dh
    gx = rng.standard_normal((B, s, 4 * d))
    r = rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh)
    if not with_state:
        return gx, r, None, None
    return gx, r, np.tanh(rng.standard_normal((B, d))), rng.standard_normal((B, d))


@jax.jit
def _reference_scan(gx, r, h0, c0):
    """``apply_slstm``'s scan over ``jxl._slstm_cell``, from (h0, c0)."""
    nh, dh = r.shape[:2]
    dt = gx.dtype

    def step(carry, g_t):
        h, c = carry
        h2, c2 = jxl._slstm_cell(g_t, h, c.astype(jnp.float32), r, nh, dh)
        return (h2.astype(dt), c2), h2.astype(dt)

    (hf, cf), hs = jax.lax.scan(step, (h0, c0), gx.transpose(1, 0, 2))
    return hs.transpose(1, 0, 2), hf, cf


def _both(gx, r, h0, c0, dtype):
    """The inputs in both packages: gx, r and h0 in ``dtype``, c0 fp32;
    zeros for a missing state on the reference's side."""
    (jgx, tgx), (jr, tr_) = both(gx, dtype), both(r, dtype)
    if h0 is None:
        zeros = np.zeros((gx.shape[0], gx.shape[2] // 4))
        return (jgx, jr, both(zeros, dtype)[0], both(zeros)[0]), (tgx, tr_, None, None)
    (jh, th), (jc, tc) = both(h0, dtype), both(c0)
    return (jgx, jr, jh, jc), (tgx, tr_, th, tc)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_the_reference_scan(dtype, with_state):
    j, t = _both(*_inputs(1, 64, with_state), dtype)
    got, want = slstm.slstm_scan_plain(*t), _reference_scan(*j)
    assert got[0].dtype == got[1].dtype == t[0].dtype and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        close(g, w, TOL[dtype])


@pytest.mark.parametrize("s", [1, 37])
def test_cpu_wrapper_is_the_plain_loop_and_launches_nothing(s):
    for with_state in (False, True):
        t = _both(*_inputs(2, s, with_state), "float32")[1]
        before = kernels.launch_counts()
        got, want = slstm.slstm_scan(*t), slstm.slstm_scan_plain(*t)
        assert kernels.launch_counts() == before
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _one_step_np(gx, r, h, c, gates):
    """One cell step in fp64 numpy, ``gates`` (B, 4, D) built from the
    per-head product gr (B, nh, 4dh) by the mapping under test."""
    g = gx.reshape(gx.shape[0], 4, -1) + gates

    def sig(x):
        return 1 / (1 + np.exp(-x))

    c2 = sig(g[:, 1]) * c + sig(g[:, 0]) * np.tanh(g[:, 2])
    return sig(g[:, 3]) * np.tanh(c2), c2


@pytest.mark.parametrize("nh", [4, 2])
def test_gate_mapping_is_the_reference_flat_split(nh):
    """The per-head product's column e of head h is gate (h*4dh + e) // D,
    channel (h*4dh + e) % D (the reference reshapes (B, nh, 4dh) to (B, 4D)
    before it splits the gates), not gate e // dh of channel h*dh + e % dh,
    the split a kernel that keeps each head's work apart would make. With
    nh 4 the gate is the head; with nh 2 each head holds two gates."""
    dh = D // nh
    gx, r, h0, c0 = _inputs(3, 1, True, nh=nh, dh=dh)
    gr = np.einsum("bhd,hde->bhe", h0.reshape(B, nh, dh), r)
    flat = gr.reshape(B, 4, D)
    per_head = gr.reshape(B, nh, 4, dh).transpose(0, 2, 1, 3).reshape(B, 4, D)
    want = _one_step_np(gx[:, 0], r, h0, c0, flat)
    planted = _one_step_np(gx[:, 0], r, h0, c0, per_head)
    assert np.abs(want[0] - planted[0]).max() > 0.1      # the two split apart
    j, t = _both(gx, r, h0, c0, "float32")
    got, ref = slstm.slstm_scan_plain(*t), _reference_scan(*j)
    for g, w in zip((got[1], got[2]), want):
        np.testing.assert_allclose(np_(g), w, atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(np_(ref[2]), want[1], atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("cpb", [16, 6])
def test_kernel_column_layout_gives_the_flat_split(cpb):
    """``csrc/slstm_scan.cu``'s columns in numpy: block j0 = k * cpb holds
    column c = (gate c // cpb, channel j0 + c % cpb) and reads r_gates at
    head idx // 4dh, column idx % 4dh of idx = gate * D + channel, against
    h's slice of that head; every (gate, channel) product equals the
    reference's flat split, for a cpb that divides D and one that does not
    (the last block holds fewer channels)."""
    for nh in (4, 2):
        dh = D // nh
        _, r, h, _ = _inputs(4, 1, True, nh=nh, dh=dh)
        want = np.einsum("bhd,hde->bhe", h.reshape(B, nh, dh), r).reshape(B, 4, D)
        got = np.full((B, 4, D), np.nan)
        for j0 in range(0, D, cpb):
            for c in range(4 * cpb):
                q, jj = c // cpb, c % cpb
                if j0 + jj >= D:
                    continue
                idx = q * D + j0 + jj
                head, e = idx // (4 * dh), idx % (4 * dh)
                got[:, q, j0 + jj] = h[:, head * dh:(head + 1) * dh] @ r[head, :, e]
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("grad", [True, False], ids=["autograd", "no_grad"])
def test_apply_slstm_matches_the_reference(grad, monkeypatch):
    """One sLSTM block of the reduced xlstm-1.3b through the bridge's
    weights: 20 steps from zeros, then 5 steps and one step from the
    carried state, against the reference's ``apply_slstm`` (fp32, 1e-5).
    Under autograd the model runs ``slstm_scan_plain`` and
    ``slstm_scan`` never; under ``no_grad`` one ``slstm_scan`` a block."""
    calls = []
    wrapper = slstm.slstm_scan
    monkeypatch.setattr(slstm, "slstm_scan", lambda *a: calls.append(1) or wrapper(*a))
    jcfg, tcfg = cfgs("xlstm-1.3b")
    jp, _ = params(jcfg)
    jl = jax.tree.map(lambda a: a[0], jp["periods"]["slstm"])
    tl = bridge.params_from_jax(jax.tree.map(np.asarray, jl), "cpu")
    for p in tl.values():
        p.requires_grad_(grad)
    rng = np.random.default_rng(5)
    xs = [both(rng.standard_normal((B, n, jcfg.d_model))) for n in (20, 5, 1)]
    jstate, tstate = jxl.init_slstm_state(jcfg, B), txl.init_slstm_state(tcfg, B)
    with torch.set_grad_enabled(grad):
        close(txl.apply_slstm(tl, xs[0][1], tcfg), jxl.apply_slstm(jl, xs[0][0], jcfg)[0],
              TOL["float32"])
        for jx, tx in xs[1:]:
            jout, jstate = jxl.apply_slstm(jl, jx, jcfg, state=jstate)
            out = txl.apply_slstm(tl, tx, tcfg, state=tstate)
            assert out.requires_grad == grad
            close(out, jout, TOL["float32"])
    for key, val in tstate.items():
        close(val, jstate[key], 2e-2 if val.dtype == torch.bfloat16 else TOL["float32"])
    assert len(calls) == (0 if grad else 3)


def test_meta_branch_counts_the_plain_loops_flops():
    """On meta tensors (the dry run) the wrapper returns empty outputs of
    the kernel's shapes and dtypes, launches nothing and adds to
    ``kernels.meta_flops()`` what ``torch.utils.flop_counter`` counts for the
    plain loop on the same meta tensors: the products, 2 B S nh dh 4dh. On
    mixed devices it raises."""
    s = 7
    gx = torch.empty((B, s, 4 * D), dtype=torch.bfloat16, device="meta")
    r = torch.empty((NH, DH, 4 * DH), dtype=torch.bfloat16, device="meta")
    h0 = torch.empty((B, D), dtype=torch.bfloat16, device="meta")
    c0 = torch.empty((B, D), device="meta")
    for state in ((None, None), (h0, c0)):
        kernels.reset_meta_flops()
        before = kernels.launch_counts()
        hs, h, c = slstm.slstm_scan(gx, r, *state)
        assert kernels.launch_counts() == before
        assert all(x.is_meta for x in (hs, h, c))
        assert (hs.shape, h.shape, c.shape) == ((B, s, D), (B, D), (B, D))
        assert hs.dtype == h.dtype == torch.bfloat16 and c.dtype == torch.float32
        with FlopCounterMode(display=False) as counter:
            slstm.slstm_scan_plain(gx, r, *state)
        assert kernels.meta_flops() == counter.get_total_flops() == 2 * B * s * NH * DH * 4 * DH
    with pytest.raises(ValueError, match="CUDA"):
        slstm.slstm_scan(gx, torch.zeros((NH, DH, 4 * DH), dtype=torch.bfloat16))


def test_plan_at_the_paths_shapes_and_its_refusals():
    """xlstm-1.3b (D 2048, dh 512) on the H100's 132 SMs: 16 channels a
    block, 128 blocks, 83,072 bytes of shared memory at (4, bf16) and
    165,120 at (4, fp32); the reduced config 2 channels a block (an even
    count: a block publishes h in 4-byte words). Beyond 227 KB, or more
    (row, channel) pairs than the block keeps, it raises."""
    assert slstm.plan(4, 2048, 512, 2, 132) == (16, 128, 83072)
    assert slstm.plan(4, 2048, 512, 4, 132) == (16, 128, 165120)
    assert slstm.plan(1, 2048, 512, 2, 132) == (16, 128, 69920)
    assert slstm.plan(2, 64, 16, 4, 132) == (2, 32, 1104)
    with pytest.raises(ValueError, match="shared memory"):
        slstm.plan(16, 2048, 512, 4, 132)
    with pytest.raises(ValueError, match="pairs"):
        slstm.plan(129, 2048, 8, 2, 132)


def test_source_exports_the_symbol_the_wrapper_binds():
    symbol, argtypes = slstm.KERNEL
    text = (_build.CSRC / "slstm_scan.cu").read_text()
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert found, f"slstm_scan.cu does not export {symbol}"
    declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in (p.strip() for p in found.group(1).split(","))]
    assert declared == argtypes
    threads = re.search(r"constexpr int THREADS = (\d+);", text)
    pairs = re.search(r"constexpr int MAX_PAIRS = (\d+);", text)
    assert (int(threads.group(1)), int(pairs.group(1))) == (slstm.THREADS, slstm.MAX_PAIRS)
