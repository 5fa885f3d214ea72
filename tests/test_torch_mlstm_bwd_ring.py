"""The mLSTM backward kernel's design (``csrc/mlstm_scan_bwd.cu``: the
forward's ring turned round, which also writes T = k dC, dv's carried term)
on the CPU: what can be held here of a kernel that runs only on the card.

- ``plan_bwd`` and ``smem_bytes_bwd`` against the source's layouts: two
  ring stages of q and k slices beside dC^T at xlstm-1.3b's dh 1024 and no
  room for a third; no tile of g (its fragments stay in registers).
- ``mlstm_carry_bwd_plain``'s T against ``einsum(k_j, dC_j)`` on the chunks
  it covers (every chunk but the last, the last too where dC_n is given),
  read before each chunk's update, with and without ``need_state``, with a
  ragged last chunk; the kernel's bf16 split of dC (high and low parts)
  within the chip gate's 1e-4 and one bf16 part above it.
- ``mlstm_backward``'s gradients against ``jax.vjp`` of the reference's
  scan where only one of dC, dn is given (T covering the last chunk or
  not), at ``tests/test_torch_mlstm_bwd.py``'s tolerances.
- ``carry_bwd_flops`` against ``flop_counter`` on the plain version.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _family_twins import both, np_, rel_l2
from repro.models import xlstm as jxl
from repro_torch.kernels import _build, mlstm

SMEM_SPLIT_TOL = 1e-4      # chip_smoke.py's MLSTM_SPLIT_TOL


def _layout_fields(src, struct):
    found = re.search(rf"struct {struct} \{{[^}}]*size_t ([^;]+);", src)
    assert found, struct
    return [x.strip() for x in found.group(1).split(",")]


def test_smem_bytes_bwd_mirrors_the_source_and_holds_two_stages():
    """The mma layout's parts are the source's (stages, dC^T, dn, the dC
    tiles, u, the partial sums, the mbarriers; no g), its constants the
    wrapper's, and the bytes at dh 1024 their sum: two stages of a slice of
    q and of k, dC^T's 32 rows of dh + 4 floats, dn, four bf16 tiles of 32 x
    CBS, u's 256 floats, two buffers of 128 partial sums, four mbarriers and
    1024 bytes of alignment. A third stage, or g's fp32 tile of a chunk,
    would not fit."""
    src = (_build.CSRC / "mlstm_scan_bwd.cu").read_text()
    assert _layout_fields(src, "MmaLayout") == ["stage", "c", "n", "cb", "vec", "red", "bar",
                                                 "total"]
    assert _layout_fields(src, "Layout")[:6] == ["c", "n", "q", "k", "g", "vec"]
    for name, value in (("NST", mlstm.NST), ("CBS", mlstm.CBS)):
        found = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert found, name
        assert eval(found.group(1), {"MMA_DT": mlstm.MMA_DT, "KPAD": 8}) == value, name
    slice_bytes = 256 * 32 * 2
    stages, c, n = mlstm.NST * 2 * slice_bytes, 32 * 1028 * 4, 1024 * 4
    tiles, u, part, bars = 4 * 32 * mlstm.CBS * 2, 256 * 4, 2 * 128 * 4, 2 * mlstm.NST * 8
    smem = mlstm.smem_bytes_bwd(1024, 2, True)
    assert smem == stages + c + n + tiles + u + part + bars + 1024 == 214560
    assert smem <= mlstm.SMEM_LIMIT < min(smem + 2 * slice_bytes, smem + 256 * 32 * 4)
    assert mlstm.plan_bwd(1, 4, 1024, 2) == (32, 128, smem)


@pytest.mark.parametrize("dh, elem", [(8, 2), (16, 4), (32, 4), (1024, 4)])
def test_simt_layout_stages_q_k_and_g(dh, elem):
    """The SIMT route's bytes: dC^T (rows of dh + 4), dn, a staged slice of
    q and of k (rows of DT + 1 floats or DT + 2 bf16), g's fp32 columns of
    the chunk, u and 256 partial sums, 16-byte aligned each."""
    e = min(dh, 32)
    dt = min(e, 16)
    a16 = lambda x: (x + 15) // 16 * 16
    qs = dt + (2 if elem == 2 else 1)
    want = (a16(4 * e * (dh + 4)) + a16(4 * dh) + 2 * a16(elem * 256 * qs) + 4 * 256 * e
            + 256 * 4 + 256 * 4)
    assert mlstm.smem_bytes_bwd(dh, elem, False) == want <= mlstm.SMEM_LIMIT


def _carry_inputs(s, seed, dt=torch.float64):
    rng = np.random.default_rng(seed)
    b, nh, dh = 2, 2, 8
    q, k, g = (torch.tensor(rng.standard_normal((b, s, nh, dh)) * 0.5, dtype=dt)
               for _ in range(3))
    u = torch.tensor(rng.standard_normal((b, s, nh)), dtype=dt)
    cl = torch.tensor(np.cumsum(-0.05 * rng.random((b, s, nh)), 1), dtype=dt)
    dC = torch.tensor(rng.standard_normal((b, nh, dh, dh)), dtype=dt)
    dn = torch.tensor(rng.standard_normal((b, nh, dh)), dtype=dt)
    return q, k, g, u, cl, dC, dn


@pytest.mark.parametrize("given", ["none", "dC", "dC_dn", "dn"])
@pytest.mark.parametrize("need_state", [False, True])
def test_plain_T_is_k_times_the_leaving_dC(need_state, given):
    """On S = 3 x 256 + 37 (a ragged last chunk): T has the rows of the
    chunks whose leaving dC is not zero (all but the last; all where dC_n is
    given) and equals k_j dC_j there, dC_j the cotangent leaving chunk j
    (dCs[j], or dC_n for the last): the read runs before the update. The
    states are those of the loop without T."""
    s = 3 * 256 + 37
    q, k, g, u, cl, dC, dn = _carry_inputs(s, 51)
    dC_n = dC if "dC" in given else None
    dn_n = dn if "dn" in given else None
    dCs, dns, dC0, dn0, T = mlstm.mlstm_carry_bwd_plain(q, k, g, u, cl, dC_n, dn_n, need_state)
    rows = 4 * 256 if dC_n is not None else 3 * 256
    assert T.shape == (2, min(rows, s), 2, 8) and T.dtype == torch.float64
    leaving = list(dCs.unbind(1)) + [dC_n]
    for j in range(4):
        r = slice(256 * j, min(256 * (j + 1), s))
        if leaving[j] is None:
            assert r.start >= T.shape[1]
            continue
        want = torch.einsum("blhd,bhde->blhe", k[:, r], leaving[j])
        torch.testing.assert_close(T[:, r], want, rtol=1e-12, atol=1e-12)
    # the carried states as the loop without the read computes them
    L, nc = 256, 4
    C = torch.zeros_like(dC) if dC_n is None else dC_n
    n = torch.zeros_like(dn) if dn_n is None else dn_n
    for j in range(nc - 1, -1 if need_state else 0, -1):
        r = slice(j * L, min((j + 1) * L, s))
        e_end = torch.exp(cl[:, r.stop - 1])
        C = e_end[..., None, None] * C + torch.einsum("blhd,blhe->bhde", q[:, r], g[:, r])
        n = e_end[..., None] * n + torch.einsum("blh,blhd->bhd", u[:, r], q[:, r])
        if j:
            torch.testing.assert_close(dCs[:, j - 1], C, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(dns[:, j - 1], n, rtol=1e-12, atol=1e-12)
    assert (dC0 is None) == (not need_state)
    if need_state:
        torch.testing.assert_close(dC0, C, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dn0, n, rtol=1e-12, atol=1e-12)


def test_one_chunk_reads_only_where_dC_n_is_given():
    """S = 100, one chunk: no dC_n, no ``need_state``: nothing runs and T has
    no rows; with dC_n the one chunk's read runs alone."""
    q, k, g, u, cl, dC, dn = _carry_inputs(100, 52)
    assert mlstm.mlstm_carry_bwd_plain(q, k, g, u, cl)[4].shape == (2, 0, 2, 8)
    T = mlstm.mlstm_carry_bwd_plain(q, k, g, u, cl, dC)[4]
    torch.testing.assert_close(T, torch.einsum("blhd,bhde->blhe", k, dC))


def test_split_read_keeps_the_gate_a_single_bf16_part_fails():
    """The mma route's read in numpy: bf16 k times dC split into bf16 high
    and low parts, fp32 sums, against k dC in fp64 at dh 1024: within the
    chip gate's 1e-4 relative L2, and one bf16 part (the control) above it."""
    rng = np.random.default_rng(53)
    bf = jnp.bfloat16
    k = np.asarray(jnp.asarray(rng.standard_normal((256, 1024)) * 0.5, bf), np.float64)
    dC = rng.standard_normal((1024, 32)) * np.exp(rng.standard_normal((1024, 32)))
    hi = np.asarray(jnp.asarray(dC.astype(np.float32), bf), np.float64)
    lo = np.asarray(jnp.asarray((dC.astype(np.float32) - hi).astype(np.float32), bf), np.float64)
    exact = k @ dC
    split = (k.astype(np.float32) @ hi.astype(np.float32)
             + k.astype(np.float32) @ lo.astype(np.float32))
    one = k.astype(np.float32) @ hi.astype(np.float32)
    err = lambda x: np.linalg.norm(x - exact) / np.linalg.norm(exact)
    assert err(split) <= SMEM_SPLIT_TOL / 10 < SMEM_SPLIT_TOL < err(one)


@pytest.mark.parametrize("given", ["dC", "dn"])
def test_backward_with_one_of_dC_dn_matches_the_reference_vjp(given):
    """``mlstm_backward`` on the CPU (T from ``mlstm_carry_bwd_plain``) with
    a cotangent on h and on one of the last C and n (the other None: the
    reference's zeros), no first state: dq, dk, dv, di and dlogf against
    ``jax.vjp`` of the reference's scan within 1e-5 abs / 1e-4 rel (fp32).
    With dC given T covers the last chunk; with dn alone it does not."""
    rng = np.random.default_rng(54)
    b, s, nh, dh = 1, 2 * 256 + 37, 2, 8
    q, k, v = (rng.standard_normal((b, s, nh, dh)) * 0.5 for _ in range(3))
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, nh))))
    logf = -np.log1p(np.exp(-(rng.standard_normal((b, s, nh)) + 3.0)))
    C0, n0 = np.zeros((b, nh, dh, dh)), np.zeros((b, nh, dh))
    dh_ = rng.standard_normal((b, s, nh, dh))
    dC = rng.standard_normal((b, nh, dh, dh)) if given == "dC" else np.zeros((b, nh, dh, dh))
    dn = rng.standard_normal((b, nh, dh)) if given == "dn" else np.zeros((b, nh, dh))
    js, ts = zip(*(both(a) for a in (q, k, v, i, logf, C0, n0)))
    _, vjp = jax.vjp(jxl._mlstm_chunk_scan, *js)
    want = vjp(tuple(jnp.asarray(x, jnp.float32) for x in (dh_, dC, dn)))[:5]
    tq, tk, tv, ti, tlogf = ts[:5]
    cl, h_intra, d_intra, qk = mlstm.mlstm_intra_terms(tq, tk, tv, ti, tlogf, keep_qk=True)
    h, _, _, Cs, ns = mlstm.mlstm_carry_plain(tq, tk, tv, ti, cl, h_intra, d_intra, None, None,
                                              save=True)
    cot = [both(x)[1] for x in (dh_, dC, dn)]
    got = mlstm.mlstm_backward(tq, tk, tv, ti, tlogf, cl, d_intra, qk, None, None, Cs, ns, h,
                               cot[0], cot[1] if given == "dC" else None,
                               cot[2] if given == "dn" else None)[:5]
    for name, a, w in zip(("dq", "dk", "dv", "di", "dlogf"), got, want):
        np.testing.assert_allclose(np_(a), np_(w), atol=1e-5, rtol=1e-4, err_msg=name)
    assert max(rel_l2(a, w) for a, w in zip(got, want)) < 1e-5


@pytest.mark.parametrize("need_state, read_last", [(False, False), (True, False),
                                                    (False, True), (True, True)])
def test_carry_bwd_flops_counts_the_reads(need_state, read_last):
    """``carry_bwd_flops`` is what ``flop_counter`` counts in
    ``mlstm_carry_bwd_plain`` on meta tensors: the updates' q^T g and q^T u
    and the reads' k dC, one a chunk read."""
    b, s, nh, dh = 2, 3 * 256 + 37, 4, 32
    meta = lambda *shape: torch.empty(shape, device="meta")
    q, k, g = (meta(b, s, nh, dh) for _ in range(3))
    u, cl = meta(b, s, nh), meta(b, s, nh)
    dC = meta(b, nh, dh, dh) if read_last else None
    with FlopCounterMode(display=False) as counter:
        out = mlstm.mlstm_carry_bwd_plain(q, k, g, u, cl, dC, None, need_state)
    assert counter.get_total_flops() == mlstm.carry_bwd_flops(b, s, nh, dh, need_state,
                                                              read_last)
    L, nc = 256, 4
    assert mlstm.carry_bwd_flops(b, s, nh, dh, need_state, read_last) == 2 * b * L * nh * dh * (
        (nc - 1 + need_state) * (dh + 1) + (nc - 1 + read_last) * dh)
    assert out[4].shape == (b, min((nc - 1 + read_last) * L, s), nh, dh)
