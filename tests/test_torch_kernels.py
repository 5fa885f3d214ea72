"""The port's kernels against the reference's Pallas kernels, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; here that is
held against the Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it) and against ``ref.py``'s oracles, with
``test_kernels.py``'s shapes and tolerances. The CUDA kernels themselves
are checked against these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as fa_raw
from repro.kernels.rglru import rglru_scan as rg_raw
from repro.kernels.rmsnorm import rmsnorm as rn_raw
from repro.models.common import _flash_fwd_impl, flash_attention_xla
from repro_torch import bridge
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import rmsnorm as trn

FA_SHAPES = [
    (2, 128, 4, 2, 64, 128, 0),
    (1, 200, 8, 1, 64, 200, 0),       # MQA + ragged seq
    (2, 96, 4, 4, 32, 96, 32),        # sliding window
    (1, 64, 2, 2, 128, 256, 0),       # cross-length kv
    (1, 257, 3, 3, 16, 257, 64),      # odd sizes
]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, shapes, dtype):
    """Both frameworks' copies of the same seeded inputs, rounded once."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), DTYPES[dtype]) for s in shapes]
    ts = [bridge.params_from_jax(np.asarray(j), "cpu") for j in js]
    return js, ts


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else bridge.to_numpy(x)


def _close(got, want, dtype, fp32_tol=(5e-6, 5e-5)):
    atol, rtol = fp32_tol if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


# -- K1: flash attention ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,tk,win", FA_SHAPES)
def test_flash_attention_plain_matches_pallas_and_oracle(b, s, h, kv, d, tk,
                                                         win, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(
        0, [(b, s, h, d), (b, tk, kv, d), (b, tk, kv, d)], dtype)
    out, lse = tfa.flash_attention(q, k, v, causal=True, window=win)
    assert out.dtype == q.dtype and lse.shape == (b, h, s)
    pallas = fa_raw(jq, jk, jv, causal=True, window=win, block_q=64,
                    block_k=64, interpret=True)
    _close(out, pallas, dtype)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=True, window=win),
           dtype)
    _close(tref.flash_attention_ref(q, k, v, causal=True, window=win),
           jref.flash_attention_ref(jq, jk, jv, causal=True, window=win), dtype)
    # the per-row log-sum-exp the kernel also writes, against the reference's
    # blockwise forward on the fp32-upcast inputs (the kernel's arithmetic;
    # the blockwise path itself rounds bf16 scores before the upcast)
    up = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    _, jlse = _flash_fwd_impl(*up, 0, True, win, 64, 64)
    np.testing.assert_allclose(_f32(lse), _f32(jlse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,tk,win", [
    (1, 80, 10, 1, 80, 32),           # recurrentgemma's MQA, S > window
    (2, 70, 4, 2, 70, 0),
])
def test_flash_attention_plain_head_dim_256(b, s, h, kv, tk, win, dtype):
    """d = 256, the hybrid family's head dim, against the Pallas kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(
        8, [(b, s, h, 256), (b, tk, kv, 256), (b, tk, kv, 256)], dtype)
    out, lse = tfa.flash_attention(q, k, v, causal=True, window=win)
    _close(out, fa_raw(jq, jk, jv, causal=True, window=win, block_q=32,
                       block_k=32, interpret=True), dtype)
    up = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    _, jlse = _flash_fwd_impl(*up, 0, True, win, 32, 32)
    np.testing.assert_allclose(_f32(lse), _f32(jlse), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_non_causal_and_gqa(causal):
    (jq, jk, jv), (q, k, v) = _inputs(
        1, [(2, 130, 4, 16), (2, 130, 2, 16), (2, 130, 2, 16)], "float32")
    out, _ = tfa.flash_attention(q, k, v, causal=causal)
    _close(out, fa_raw(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                       interpret=True), "float32")


def test_flash_attention_wrapper_rejects_non_cpu_non_cuda():
    """Meta tensors (the dry run) take the shape-only branch: empty outputs
    of the kernel's shapes and dtypes, the kernel's FLOPs tallied, no
    launch; inputs on mixed devices, neither all on the CPU, all on a card
    nor all on meta, raise."""
    from repro_torch import kernels

    q = torch.zeros((1, 8, 2, 16), device="meta")
    kernels.reset_meta_flops()
    before = kernels.launch_counts()
    out, lse = tfa.flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert lse.is_meta and lse.shape == (1, 2, 8) and lse.dtype == torch.float32
    y = trn.rmsnorm(torch.zeros((4, 16), device="meta"),
                    torch.zeros((16,), device="meta"))
    assert y.is_meta and y.shape == (4, 16)
    # 8 causal rows: 36 (q, k) pairs a head, 2 products of 2 FLOPs; 4 a norm element
    assert kernels.meta_flops() == 4 * 16 * 2 * 36 + 4 * 64
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, torch.zeros((1, 8, 2, 16)), q)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(torch.zeros((4, 16), device="meta"), torch.zeros((16,)))


# -- K1's sm90 route: its numerics, route choice and layout check --------------
def _sm90_scheme(q, k, v, *, causal, window):
    """Test-local emulation of ``csrc/flash_attention_sm90.cu``'s arithmetic:
    128-row q tiles in two 64-row warpgroups, BK = 128 kv rows at d <= 128
    and 64 at d = 256, the kernel's tile skipping and edge-only masking,
    online softmax in base 2 with scale * log2(e) folded in, l summed from
    fp32 p, P rounded to bf16 before P.V, fp32 accumulation."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    bq, bk = 128, 64 if d == 256 else 128
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    neg2 = torch.tensor(-1e30, dtype=torch.float32) * log2e
    scale_log2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) * log2e
    heads = torch.arange(h) // (h // kvh)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, s, h, d))
    lse = torch.zeros((b, h, s))
    for q0 in range(0, s, bq):
        k_end = min(t, q0 + bq, s) if causal else t
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        kt_begin = k_begin // bk
        n_tiles = max(0, -(-k_end // bk) - kt_begin)
        for qa in (q0, q0 + 64):
            qb = qa + 63
            if qa >= s:
                continue                  # rows the kernel computes, never stores
            rows = torch.arange(qa, min(qa + 64, s))
            qq = qf[:, rows]
            m = torch.full((b, h, len(rows)), neg2.item())
            l = torch.zeros((b, h, len(rows)))
            acc = torch.zeros((b, h, len(rows), d))
            for i in range(n_tiles):
                k0 = (kt_begin + i) * bk
                if (causal and k0 > qb) or (window > 0 and k0 + bk - 1 <= qa - window):
                    continue
                cols = torch.arange(k0, k0 + bk)
                valid = cols < t
                kt = torch.zeros((b, bk, kvh, d))
                vt = torch.zeros((b, bk, kvh, d))
                kt[:, valid], vt[:, valid] = kf[:, cols[valid]], vf[:, cols[valid]]
                sc = torch.einsum("brhd,bchd->bhrc", qq, kt[:, :, heads])
                if (k0 + bk > t or (causal and k0 + bk - 1 > qa)
                        or (window > 0 and k0 <= qb - window)):
                    qpos, kpos = rows[:, None], cols[None, :]
                    ok = valid[None, :] & torch.ones_like(qpos, dtype=torch.bool)
                    if causal:
                        ok &= qpos >= kpos
                    if window > 0:
                        ok &= kpos > qpos - window
                    sc = torch.where(ok, sc * scale_log2, neg2)
                else:
                    sc = sc * scale_log2
                mx = torch.maximum(m, sc.amax(-1))
                corr = torch.exp2(m - mx)
                m = mx
                p = torch.exp2(sc - m[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhrc,bchd->bhrd", p.to(torch.bfloat16).float(), vt[:, :, heads])
            denom = l.clamp_min(1e-30)
            out[:, rows] = (acc / denom[..., None]).permute(0, 2, 1, 3)
            lse[:, :, rows] = m * np.log(2.0) + torch.log(denom)
    return out.to(torch.bfloat16), lse


@pytest.mark.parametrize("b,s,h,kv,d,tk,win", [
    *[c for c in FA_SHAPES if c[4] >= 64],
    (2, 300, 10, 1, 256, 300, 128),   # chip_smoke's hybrid-like shape
    (2, 160, 8, 2, 128, 200, 0),      # d = 128 GQA, T > S
    # window None: not causal, as in chip_smoke.py
    (2, 200, 8, 2, 64, 300, None),
    (1, 300, 4, 1, 128, 130, None),
    (1, 130, 2, 1, 256, 200, None),
])
def test_sm90_scheme_matches_pallas_and_plain(b, s, h, kv, d, tk, win):
    """The sm90 kernel's numerics, rehearsed on the CPU: output within the
    bf16 2e-2 of the Pallas kernel, LSE within the fp32 2e-5 of the plain
    version (``chip_smoke.py``'s tolerances for the kernel on the card)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        12, [(b, s, h, d), (b, tk, kv, d), (b, tk, kv, d)], "bfloat16")
    causal, win = win is not None, win or 0
    out, lse = _sm90_scheme(q, k, v, causal=causal, window=win)
    blk = 32 if d == 256 else 64
    _close(out, fa_raw(jq, jk, jv, causal=causal, window=win, block_q=blk,
                       block_k=blk, interpret=True), "bfloat16")
    p_out, p_lse = tfa.flash_attention_plain(q, k, v, causal=causal, window=win)
    _close(out, p_out, "bfloat16")
    np.testing.assert_allclose(_f32(lse), _f32(p_lse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "sm90"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 16, "simt"),
])
def test_flash_attention_route_choice(dtype, d, want):
    assert tfa.route(dtype, d) == want


def test_tma_layout_check_rejects_misalignment_and_odd_strides():
    bf = torch.bfloat16
    tfa.check_tma_layout(torch.zeros((2, 8, 4, 64), dtype=bf), "q")
    misaligned = torch.zeros(1 + 2 * 8 * 4 * 64, dtype=bf)[1:].view(2, 8, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        tfa.check_tma_layout(misaligned, "q")
    odd_stride = torch.zeros((2, 8, 4, 68), dtype=bf)[..., :64]   # 136-byte rows
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.check_tma_layout(odd_stride, "k")
    with pytest.raises(ValueError, match="contiguous"):
        tfa.check_tma_layout(torch.zeros((2, 8, 64, 4), dtype=bf).transpose(2, 3), "v")


def test_layout_check_by_route():
    """The sm90 kernel takes strided views (TMA reads them through their
    strides); the SIMT kernel takes contiguous tensors only."""
    bf = torch.bfloat16
    qkv = torch.zeros((2, 8, 4 + 2 * 2, 64), dtype=bf)
    cache = torch.zeros((2, 12, 2, 2, 64), dtype=bf)
    q, k, v = qkv[:, :, :4], cache[:, :8, 0], cache[:, :8, 1]
    tfa.check_layout("sm90", q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.check_layout("simt", q, k, v)
    tfa.check_layout("simt", q.contiguous(), k.contiguous(), v.contiguous())
    misaligned = torch.zeros(1 + 2 * 8 * 2 * 64, dtype=bf)[1:].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        tfa.check_layout("sm90", q, misaligned, v)


# -- K2: RMSNorm --------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype", [
    ((4, 37, 128), "bfloat16"),
    ((8, 256), "float32"),
    ((1, 1, 512), "float32"),
    ((7, 384), "float32"),
    ((7, 384), "bfloat16"),
])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    (jx,), (x,) = _inputs(2, [shape], dtype)
    (jw,), (w,) = _inputs(3, [shape[-1:]], "float32")
    out = trn.rmsnorm(x, w)
    assert out.dtype == x.dtype and out.shape == x.shape
    tol = (2e-5, 2e-5)
    _close(out, rn_raw(jx, jw, interpret=True), dtype, fp32_tol=tol)
    _close(tref.rmsnorm_ref(x, w), jref.rmsnorm_ref(jx, jw), dtype, fp32_tol=tol)


# -- K3: RG-LRU scan -----------------------------------------------------------
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,s,c", [
    (2, 100, 96), (1, 257, 64), (3, 16, 300),      # test_kernels.py's shapes
    (2, 1, 8), (1, 33, 130), (3, 128, 8),          # its sweep's sizes
])
def test_rglru_scan_plain_matches_pallas_and_oracle(b, s, c, with_h0):
    rng = np.random.default_rng(9)
    ja = jnp.asarray(rng.uniform(0.0, 0.999, (b, s, c)), jnp.float32)
    (jb, jh0), (tb, th0) = _inputs(10, [(b, s, c), (b, c)], "float32")
    ta = bridge.params_from_jax(np.asarray(ja), "cpu")
    jh0, th0 = (jh0, th0) if with_h0 else (None, None)
    out = trg.rglru_scan(ta, tb, th0)
    assert out.dtype == torch.float32 and out.shape == (b, s, c)
    want = jref.rglru_scan_ref(ja, jb, jh0)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _f32(out), _f32(rg_raw(ja, jb, jh0, block_c=64, block_t=64,
                               interpret=True)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(tref.rglru_scan_ref(ta, tb, th0)),
                               _f32(want), atol=1e-5, rtol=1e-5)


def test_rglru_scan_wrapper_rejects_non_cpu_non_cuda():
    """All on meta (the dry run): an empty output, 2 FLOPs an element
    tallied, no launch; on mixed devices it raises."""
    a = torch.zeros((1, 4, 8), device="meta")
    before, launched = trg.meta_flops, trg.launches
    h = trg.rglru_scan(a, a)
    assert h.is_meta and h.shape == a.shape and h.dtype == a.dtype
    assert trg.meta_flops - before == 2 * 32 and trg.launches == launched
    with pytest.raises(ValueError, match="CUDA"):
        trg.rglru_scan(a, torch.zeros((1, 4, 8)))


# -- ops on the CPU -------------------------------------------------------------
def test_ops_take_plain_paths_on_cpu_and_count_nothing():
    reset_launch_counts()
    (jq, jk, jv), (q, k, v) = _inputs(
        4, [(1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)], "float32")
    _close(tops.flash_attention(q, k, v), jops.flash_attention(jq, jk, jv),
           "float32")
    (jx,), (x,) = _inputs(5, [(3, 5, 64)], "bfloat16")
    (jw,), (w,) = _inputs(6, [(64,)], "bfloat16")
    _close(tops.rmsnorm(x, w), jops.rmsnorm(jx, jw), "bfloat16")
    (ja, jb, jh0), (a, b, h0) = _inputs(11, [(2, 20, 16), (2, 20, 16), (2, 16)],
                                        "float32")
    np.testing.assert_allclose(_f32(tops.rglru_scan(a * 0.5, b, h0)),
                               _f32(jops.rglru_scan(ja * 0.5, jb, jh0)),
                               atol=1e-5, rtol=1e-5)
    assert launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                               "rglru_scan": 0, "slstm_scan": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_bwd": 0,
                               "flash_attention_bwd_sm90": 0, "rmsnorm_bwd": 0,
                               "rglru_scan_bwd": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_q_offset_matches_xla_flash(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(
        7, [(2, 16, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)], dtype)
    got = tops.flash_attention(q, k, v, causal=True, q_offset=32)
    want = flash_attention_xla(jq, jk, jv, causal=True, q_offset=32)
    _close(got, want, dtype)
