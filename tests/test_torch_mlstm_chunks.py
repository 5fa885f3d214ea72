"""The mLSTM's chunk scan (``repro_torch.models.xlstm._mlstm_chunk_scan``)
against the reference's over several groups of chunks, on the CPU.

The port runs the reference's per-chunk formulas CHUNK_GROUP chunks at a
time (the carry of C and n chunk by chunk inside a group). Here six chunks
of 256, the last ragged, go through the reference's ``_mlstm_chunk_scan``
and through the port's with groups of 1, 2, 4 and the default, from zeros
and from a carried state: fp32 within the scan's 1e-5
(``tests/test_kernels.py``), bf16 within 2e-2.
"""
import numpy as np
import pytest

from _family_twins import both, close
from repro.models import xlstm as jxl
from repro_torch.models import xlstm as txl

S = 5 * txl.CHUNK + 37


def _inputs(with_state):
    """q, k, v normal / 2, sigmoid input gates, log forget gates near
    log(sigmoid(3)), and C0, n0 (or zeros); numpy, batch 1, 2 heads of 8."""
    rng = np.random.default_rng(31)
    b, nh, dh = 1, 2, 8
    arrays = [rng.standard_normal((b, S, nh, dh)) * 0.5 for _ in range(3)]
    i = 1 / (1 + np.exp(-rng.standard_normal((b, S, nh))))
    logf = -np.log1p(np.exp(-(rng.standard_normal((b, S, nh)) + 3.0)))
    scale = 0.1 if with_state else 0.0
    C0 = rng.standard_normal((b, nh, dh, dh)) * scale
    n0 = rng.standard_normal((b, nh, dh)) * scale
    return (*arrays, i, logf, C0, n0)


@pytest.mark.parametrize("group", [1, 2, 4, None], ids=["g1", "g2", "g4", "default"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_chunk_scan_matches_reference(dtype, with_state, group, monkeypatch):
    if group is not None:
        monkeypatch.setattr(txl, "CHUNK_GROUP", group)
    arrays = _inputs(with_state)
    # q, k, v in the activations' dtype; the gates and the state in fp32
    js, ts = zip(*(both(a, dtype if n < 3 else "float32") for n, a in enumerate(arrays)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in zip(txl._mlstm_chunk_scan(*ts), jxl._mlstm_chunk_scan(*js)):
        close(got, want, tol)
