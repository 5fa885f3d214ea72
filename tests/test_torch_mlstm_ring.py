"""The mLSTM forward kernel's mma route (``csrc/mlstm_scan.cu``) on the CPU:
what can be held here of a kernel that runs only on the card.

- Its grid at xlstm-1.3b's heads: one block an SM (its shared memory holds
  no second block), so B x 128 blocks take ceil(B x 128 / 132) waves of an
  H100's 132 SMs: one at batch 1 (long_500k), four at batch 4.
- ``smem_bytes`` against the source's layout: the ring's NST stages of a
  slice of q and of k beside C^T, with no room for a third stage at dh 1024.
"""
import re

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import mlstm

H100_SMS = 132


@pytest.mark.parametrize("b, waves", [(1, 1), (2, 2), (4, 4), (8, 8)])
def test_the_grid_takes_the_waves_of_its_batch(b, waves):
    """B x 4 heads x 32 column blocks of 32 columns, each alone on its SM."""
    cols, blocks, smem = mlstm.plan(b, 4, 1024, 2)
    assert (cols, blocks) == (32, b * 4 * 32)
    assert smem <= mlstm.SMEM_LIMIT < 2 * smem
    assert -(-blocks // H100_SMS) == waves


def test_smem_bytes_mirrors_the_source_and_holds_two_stages():
    """The layout's constants agree with the source's, and the bytes at
    xlstm-1.3b's dh 1024 are the sum of the parts: two stages of a slice of
    q and of k, v's tile, C^T's 32 rows of dh + 4 floats, n, two bf16 tiles
    of C's slices, three row vectors, two buffers of n's partial sums, six
    mbarriers and 1024 bytes of alignment. A third stage would not fit."""
    src = (_build.CSRC / "mlstm_scan.cu").read_text()
    for name, value in (("NST", mlstm.NST), ("CBS", mlstm.CBS)):
        found = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert found, name
        assert eval(found.group(1), {"MMA_DT": mlstm.MMA_DT, "KPAD": 8}) == value, name
    slice_bytes = 256 * 32 * 2
    stages, v = mlstm.NST * 2 * slice_bytes, 256 * 32 * 2
    c, n, cb = 32 * 1028 * 4, 1024 * 4, 2 * 32 * mlstm.CBS * 2
    vec, part, bars = 3 * 256 * 4, 2 * 4 * 32 * 4, (2 * mlstm.NST + 2) * 8
    smem = mlstm.smem_bytes(1024, 2, True)
    assert smem == stages + v + c + n + cb + vec + part + bars + 1024 == 227888
    assert smem <= mlstm.SMEM_LIMIT < smem + 2 * slice_bytes
