"""K3's blocked mirrors against the sequential scan and the reference, on the
CPU.

The CUDA kernels of ``csrc/rglru_scan.cu`` split each time tile of
``warps * steps`` steps across warps and fold the warps' aggregates, so they
associate the scan otherwise than the sequential loop. The mirrors
``rglru_scan_blocked_plain`` and ``rglru_scan_backward_blocked_plain``
repeat that order in PyTorch; on the card each kernel equals its mirror to
the bit (``chip_smoke.py``). Here the same seeded numpy inputs go through
the mirrors, the sequential plain versions, the reference's Pallas kernel in
interpret mode, ``repro.kernels.ref.rglru_scan_ref`` and ``jax.vjp`` of it,
within the scan's 1e-5 (``tests/test_kernels.py``), at the kernels' own
tiles and others: S = 1, S below one tile, ragged S, S a whole number of
tiles, C not a multiple of 32, with and without h0.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_scan_ref
from repro.kernels.rglru import rglru_scan as pallas_rglru_scan
from repro_torch.kernels import _build
from repro_torch.kernels import rglru as trg

SCAN_TOL = 1e-5
# (B, S, C): S = 1; S below one tile and C = 130; ragged S (one tile and a
# bit, two and a bit); S a whole number of the forward's 128-step tiles;
# C 40 and 300
SHAPES = [(2, 1, 8), (1, 33, 130), (2, 100, 96), (1, 257, 64), (3, 128, 8),
          (1, 256, 40), (3, 16, 300)]
# (forward tile, backward tile) as (warps, steps): the kernels' own, then others
TILES = [((trg.FWD_WARPS, trg.FWD_STEPS), (trg.BWD_WARPS, trg.BWD_STEPS)),
         ((4, 8), (4, 8)), ((2, 3), (16, 4)), ((16, 4), (2, 3))]
TILE_IDS = ["kernels", "4x8", "2x3_16x4", "16x4_2x3"]


@functools.lru_cache(maxsize=None)
def _inputs(shape, with_h0):
    """a in [0, 0.999); b, h0 and the cotangent g normal; numpy fp32."""
    rng = np.random.default_rng([*shape, with_h0])
    b, s, c = shape
    a = (rng.random(shape) * 0.999).astype(np.float32)
    bb, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, c)).astype(np.float32) if with_h0 else None
    return a, bb, h0, g


@jax.jit
def _jax_outputs(a, b, h0, g):
    h, vjp = jax.vjp(rglru_scan_ref, *((a, b) if h0 is None else (a, b, h0)))
    pallas = pallas_rglru_scan(a, b, h0, block_c=64, block_t=64, interpret=True)
    return h, pallas, vjp(g)


@functools.lru_cache(maxsize=None)
def _reference(shape, with_h0):
    """The reference's h (``rglru_scan_ref``), the Pallas kernel's h in
    interpret mode, and ``jax.vjp`` of ``rglru_scan_ref`` at g, as numpy."""
    h, pallas, grads = _jax_outputs(*(None if x is None else jnp.asarray(x)
                                      for x in _inputs(shape, with_h0)))
    return np.asarray(h), np.asarray(pallas), tuple(np.asarray(x) for x in grads)


def _torch(shape, with_h0):
    a, bb, h0, g = _inputs(shape, with_h0)
    return (torch.from_numpy(a), torch.from_numpy(bb),
            None if h0 is None else torch.from_numpy(h0), torch.from_numpy(g))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_mirror_matches_sequential_and_reference(shape, tiles, with_h0):
    a, bb, h0, _ = _torch(shape, with_h0)
    (warps, steps), _ = tiles
    got = trg.rglru_scan_blocked_plain(a, bb, h0, warps=warps, steps=steps)
    assert got.dtype == torch.float32 and got.shape == shape
    ref_h, pallas_h, _ = _reference(shape, with_h0)
    _close(got, trg.rglru_scan_plain(a, bb, h0))
    _close(got, ref_h)
    _close(got, pallas_h)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("tiles", TILES, ids=TILE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_mirror_matches_sequential_and_reference_vjp(shape, tiles, with_h0):
    a, bb, h0, g = _torch(shape, with_h0)
    _, (warps, steps) = tiles
    h = trg.rglru_scan_plain(a, bb, h0)
    got = trg.rglru_scan_backward_blocked_plain(a, h, g, h0, warps=warps, steps=steps)
    want = trg.rglru_scan_backward_plain(a, h, g, h0)
    _, _, ref_grads = _reference(shape, with_h0)
    assert (got[2] is None) == (h0 is None) == (len(ref_grads) == 2)
    for x, y, z in zip(got, want, ref_grads):
        assert x.dtype == torch.float32 and x.shape == y.shape
        _close(x, y)
        _close(x, z)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_one_warp_mirror_is_the_sequential_loop(shape, with_h0):
    """With one warp nothing is folded: each tile's steps run from the
    carry, in the sequential loop's order, so the bits are the loop's."""
    a, bb, h0, g = _torch(shape, with_h0)
    h = trg.rglru_scan_plain(a, bb, h0)
    assert torch.equal(trg.rglru_scan_blocked_plain(a, bb, h0, warps=1, steps=5), h)
    got = trg.rglru_scan_backward_blocked_plain(a, h, g, h0, warps=1, steps=5)
    want = trg.rglru_scan_backward_plain(a, h, g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, want) if y is not None)


def test_mirror_defaults_are_the_kernels_constants():
    """The mirrors' default tiles and the lanes a block are the numbers the
    CUDA source compiles with."""
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    defines = dict(re.findall(r"#define RGLRU_(\w+) (\d+)", text))
    lanes = re.search(r"constexpr int LANES = (\d+);", text)
    assert lanes and int(lanes.group(1)) == trg.LANES == 32
    assert {k: int(v) for k, v in defines.items()} == {
        "FWD_WARPS": trg.FWD_WARPS, "FWD_STEPS": trg.FWD_STEPS,
        "BWD_WARPS": trg.BWD_WARPS, "BWD_STEPS": trg.BWD_STEPS}
    fwd = trg.rglru_scan_blocked_plain.__kwdefaults__
    bwd = trg.rglru_scan_backward_blocked_plain.__kwdefaults__
    assert fwd == {"warps": trg.FWD_WARPS, "steps": trg.FWD_STEPS}
    assert bwd == {"warps": trg.BWD_WARPS, "steps": trg.BWD_STEPS}
