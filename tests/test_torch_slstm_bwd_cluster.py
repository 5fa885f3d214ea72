"""The sLSTM backward kernel's clusters (``csrc/slstm_scan_bwd.cu``, bf16) on
the CPU: what can be held here of a kernel that runs only on the card.

- ``slstm.plan_bwd`` at xlstm-1.3b's shapes (B 1 and 4, D 2048, nh 4, bf16
  and fp32) with an H100's residency (the most clusters of 16, 8, 4 and 2
  blocks of 512 threads it holds at once: 7, 15, 30 and 66), its refusals,
  and its route for every shape the forward's bf16 plan takes;
  ``smem_bytes_bwd`` against the source's layout constants.
- A model in numpy of the exchange of dg over a few steps, run under random
  interleavings of the blocks, with the kernel's index arithmetic (each
  gate's head and the ranks of the cluster's blocks in it, the words stored
  to L2, the sends of a block's own chunks, the relays' assignment of other
  clusters' chunks): every block receives every chunk of its heads' range
  of dg_t exactly once, with its owner's value of that step, and no buffer
  (a block's two in shared memory, the two of tagged words in L2) is
  written before its last reader of the step before is done.
- The m16n8k16 tiling of dh_rec mirrored in numpy (A fragments from
  r_gates' rows with the k terms 4 t4 .. 4 t4 + 3 a lane, B fragments from
  the rows of dg, KP partial sums an output added in the kernel's tree),
  equal to the h cotangent ``jax.vjp`` gives of the reference's
  ``_slstm_cell`` (``repro/models/xlstm.py``) on the same seeded inputs.
"""
import ctypes
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import xlstm as jxl
from repro_torch.kernels import _build
from repro_torch.kernels import slstm

# an H100 80GB HBM3's residency for the kernel's blocks (one an SM): the
# most clusters of each size it holds at once
H100 = {16: 7, 8: 15, 4: 30, 2: 66}.get
SMS = 132
WARPS = slstm.THREADS // 32


def _src():
    return (_build.CSRC / "slstm_scan_bwd.cu").read_text()


# -- the plan ------------------------------------------------------------------
@pytest.mark.parametrize("b, elem, want", [
    (4, 2, (16, 32, 64, 57744)),      # training: 64 blocks of 32 channels, a cluster a head
    (1, 2, (16, 32, 64, None)),
    (4, 4, (1, 16, 128, 165888)),     # fp32: PR 29's cooperative grid
    (1, 4, (1, 16, 128, 139776)),
])
def test_plan_bwd_at_the_paths_shapes(b, elem, want):
    """At xlstm-1.3b's D 2048 and nh 4 bf16 takes the forward's grid, 4
    clusters of 16 blocks of 32 channels (a cluster is a head), and fp32
    the cooperative grid of 128 blocks of 16; the shared bytes are
    ``smem_bytes_bwd``'s and ``smem_bytes_bwd_coop``'s."""
    got = slstm.plan_bwd(b, 2048, 512, elem, SMS, H100)
    cluster, cpb, grid, smem = got
    assert got[:3] == want[:3]
    fn = slstm.smem_bytes_bwd if cluster > 1 else slstm.smem_bytes_bwd_coop
    assert smem == fn(elem, b, 2048, 512, cpb) <= slstm.SMEM_LIMIT
    if want[3] is not None:
        assert smem == want[3]
    assert grid % cluster == 0 and (grid - cluster) * cpb < 2048 <= grid * cpb


def test_plan_bwd_refusals_and_routes():
    """A card that holds no cluster is refused (never the cooperative grid
    instead); too many (row, channel) pairs and too much shared memory are
    refused; a bf16 shape whose clusters' block would not fit its shared
    memory (nh 1, B 32: 64 KB rows of dg, two buffers) takes the
    cooperative grid."""
    with pytest.raises(ValueError, match="residency"):
        slstm.plan_bwd(4, 2048, 512, 2, SMS, lambda cluster: 0)
    with pytest.raises(ValueError, match="pairs"):
        slstm.plan_bwd(129, 2048, 512, 2, SMS, H100)
    with pytest.raises(ValueError, match="shared memory"):
        slstm.plan_bwd(16, 2048, 512, 4, SMS, H100)
    assert slstm.smem_bytes_bwd(2, 32, 512, 512, 32) > slstm.SMEM_LIMIT
    assert slstm.plan_bwd(32, 512, 512, 2, SMS, H100)[0] == 1


def test_every_shape_the_forward_takes_the_backward_takes():
    """Training never meets a refusal in the backward after the forward
    passed: each (B, D, nh) the forward's bf16 plan takes, the backward's
    takes too, in clusters wherever 32 channels a block fit."""
    for d in (64, 128, 192, 256, 320, 512, 1024, 1856, 2048):
        for nh in (1, 2, 4):
            for b in (1, 2, 3, 4, 8, 16, 32):
                dh = d // nh
                try:
                    slstm.plan(b, d, dh, 2, SMS, H100)
                except ValueError:
                    continue
                cluster, cpb, grid, smem = slstm.plan_bwd(b, d, dh, 2, SMS, H100)
                assert smem <= slstm.SMEM_LIMIT
                if slstm.smem_bytes_bwd(2, b, d, dh, 32) <= slstm.SMEM_LIMIT and b <= 32:
                    assert cluster > 1 and cpb in (16, 32), (b, d, nh)


def test_smem_bytes_bwd_mirrors_the_source():
    """The constants of the clusters' layout agree with the source's, and
    the bytes at the training shape are the sum of its parts: barriers,
    the cluster's row offsets, two padded buffers of dg, the KP partial sums
    for 8 rows, the new dg, the stages of g, dy and c."""
    src = _src()
    for name, value in (("NST", slstm.NST_BWD), ("HPAD", slstm.HPAD_BWD), ("KP", slstm.KP),
                        ("CPAIRS", slstm.CPAIRS), ("MAX_MT", 2)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    assert "constexpr int GS = MAX_MT * 16 + 4;" in src and slstm.GS == 2 * 16 + 4
    bars, rows = 8 * (2 + slstm.NST_BWD), 4 * 16
    dg = 2 * 4 * (2 * 2048 + slstm.HPAD_BWD)
    part, new = 4 * slstm.KP * 8 * slstm.GS, 2 * 4 * 4 * 32
    stage = 2 * 4 * 4 * 32 + 2 * 4 * 32 + 4 * 4 * 32
    assert slstm.smem_bytes_bwd(2, 4, 2048, 512, 32) == (
        bars + rows + dg + part + new + slstm.NST_BWD * stage) == 57744


def test_source_exports_the_symbols_the_wrapper_binds():
    src = _src()
    for symbol, argtypes in (slstm.KERNEL_BWD, slstm.CLUSTERS_BWD):
        found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
        assert found, f"slstm_scan_bwd.cu does not export {symbol}"
        declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                    for p in (p.strip() for p in found.group(1).split(","))]
        assert declared == argtypes, symbol


# -- the exchange ---------------------------------------------------------------
class _Exchange:
    """The kernel's exchange of dg in numpy, with its index arithmetic:
    ``nblk`` blocks of cpb channels in clusters of ``cs`` (padded to whole
    clusters), B rows. A chunk is (row b, flat value f of its first of 8
    values); chunk (b, q D + j) is owned by block j / cpb. Step it of a
    block: "publish" (its chunks of dg_it: the words to L2 buffer it & 1
    where ``outside`` says, tagged it + 1; each chunk to the ranks lo .. hi
    of its gate, as warp w sends to rank w); "relay" (once the tags of its
    chunks are it + 1: the kernel's slots x -> (chunk x & 3, row, pair of
    source cluster and needed gate) give the other clusters' chunks it
    polls and sends to lo .. hi, a lane a rank); "wait"
    (once its mbarrier has counted B x nspan x 4dh values); "products"
    (reads buffer it & 1). Every write is checked against the last read of
    the buffer it overwrites, every read for exactly the chunks of the
    block's heads, once each, from their owners at that step."""

    def __init__(self, d, nh, cpb, cs, b, steps):
        self.d, self.nh, self.cpb, self.cs, self.b, self.steps = d, nh, cpb, cs, b, steps
        self.dh = d // nh
        self.e4 = 4 * self.dh
        self.nblk = -(-d // cpb)
        self.nclusters = -(-self.nblk // cs)
        self.grid = self.nclusters * cs
        self.smem = [[{} for _ in range(2)] for _ in range(self.grid)]
        self.read_done = [[-1, -1] for _ in range(self.grid)]   # step last read from a buffer
        self.l2 = [{}, {}]                 # (b, f) -> (owner, tag)
        self.l2_reads = [{}, {}]           # (b, f) -> blocks that polled this tag
        self.at = [(0, "publish")] * self.grid
        self._relays = {}
        # the blocks that poll each chunk
        self.pollers = {}
        for k in range(self.grid):
            for bb, ff, _, _ in self.relays(k):
                self.pollers.setdefault((bb, ff), set()).add(k)

    # the kernel's per-block constants
    def nch(self, k):
        return max(0, min(self.cpb, self.d - k * self.cpb))

    def ranges(self, cl):
        """lo, hi (ranks; lo > hi: none) and outside of each gate q."""
        k_first = cl * self.cs
        k_last = min(k_first + self.cs, self.nblk) - 1
        out = []
        for q in range(4):
            hc = q * self.nh // 4
            first, last = hc * self.dh // self.cpb, ((hc + 1) * self.dh - 1) // self.cpb
            none = last < k_first or first > k_last
            lo = 15 if none else max(first, k_first) - k_first
            hi = 0 if none else min(last, k_last) - k_first
            out.append((lo, hi, first < k_first or last > k_last))
        return out

    def hbase(self, k):
        return k * self.cpb // self.dh * self.e4

    def heads_range(self, k):
        """The (b, f) chunks of block k's heads' range of dg."""
        h_lo = k * self.cpb // self.dh
        nspan = (k * self.cpb + self.nch(k) - 1) // self.dh - h_lo + 1 if self.nch(k) else 0
        return {(b, f) for b in range(self.b)
                for f in range(h_lo * self.e4, (h_lo + nspan) * self.e4, 8)}

    def relays(self, k):
        """The kernel's relay slots of block k: (b, f, lo, hi)."""
        if k not in self._relays:
            self._relays[k] = self._relay_slots(k)
        return self._relays[k]

    def _relay_slots(self, k):
        cs, cl, rank = self.cs, k // self.cs, k % self.cs
        lb = max(self.b - 1, 1).bit_length()
        rng = self.ranges(cl)
        needq = [q for q in range(4) if rng[q][0] <= rng[q][1]]
        nq = len(needq)
        out = []
        for x in range((self.nclusters - 1) * nq << (2 + lb)):
            v, b, pair = x & 3, x >> 2 & ((1 << lb) - 1), x >> (2 + lb)
            mi = pair // nq
            q = needq[pair - mi * nq]
            ks = rank + cs * (mi + (mi >= cl))
            if (ks >= self.nblk or b >= self.b or 8 * v >= self.cpb
                    or ks * self.cpb + 8 * v >= self.d):
                continue
            lo, hi, _ = rng[q]
            out.append((b, q * self.d + ks * self.cpb + 8 * v, lo, hi))
        return out

    def write(self, target, p, key, owner, step):
        assert self.read_done[target][p] >= step - 2, ("overwritten", target, p, step)
        f = key[1] - self.hbase(target)
        assert 0 <= f < 4 * self.d, ("outside the row", target, key)
        self.smem[target][p].setdefault(key, []).append((owner, step))

    def enabled(self, k):
        it, what = self.at[k]
        if it >= self.steps:
            return False
        if what == "relay":
            return all(self.l2[it & 1].get((b, f), (None, 0))[1] == it + 1
                       for b, f, _, _ in self.relays(k))
        if what == "wait":
            got = self.smem[k][it & 1]
            return sum(len(v) for v in got.values()) == len(self.heads_range(k))
        return True

    def run(self, k):
        it, what = self.at[k]
        p, cl = it & 1, k // self.cs
        first = cl * self.cs
        if what == "publish":
            rng = self.ranges(cl)
            nch = self.nch(k)
            for b in range(self.b):
                for q in range(4):
                    lo, hi, outside = rng[q]
                    for v in range(4):
                        if 8 * v >= nch:
                            continue
                        key = (b, q * self.d + k * self.cpb + 8 * v)
                        if outside:
                            prev = self.l2[p].get(key)
                            if prev is not None:     # its pollers of step it - 2 are done
                                assert self.l2_reads[p].get(key, set()) == self.pollers.get(
                                    key, set()), (key, it)
                            self.l2[p][key] = (k, it + 1)
                            self.l2_reads[p][key] = set()
                        for w in range(min(self.cs, WARPS)):
                            if first + w < self.nblk and lo <= w <= hi:
                                self.write(first + w, p, key, k, it)
            self.at[k] = (it, "relay")
        elif what == "relay":
            for b, f, lo, hi in self.relays(k):
                owner, _ = self.l2[p][(b, f)]
                self.l2_reads[p][(b, f)].add(k)
                for w in range(lo, hi + 1):
                    self.write(first + w, p, (b, f), owner, it)
            self.at[k] = (it, "wait")
        elif what == "wait":
            self.at[k] = (it, "products")
        else:
            got, want = self.smem[k][p], self.heads_range(k)
            assert set(got) == want, (k, it, sorted(set(got) ^ want)[:4])
            for (b, f), recv in got.items():
                assert recv == [((f % self.d) // self.cpb, it)], (k, it, b, f, recv)
            self.smem[k][p] = {}
            self.read_done[k][p] = it
            self.at[k] = (it + 1, "publish")

    def simulate(self, seed):
        rng = random.Random(seed)
        while any(it < self.steps for it, _ in self.at):
            ready = [k for k in range(self.grid) if self.enabled(k)]
            assert ready, "the exchange deadlocks"
            self.run(rng.choice(ready))


@pytest.mark.parametrize("d, nh, cpb, cs, b", [
    (256, 4, 16, 4, 2),     # a cluster a head, as at xlstm-1.3b's shapes
    (256, 4, 32, 4, 3),     # a cluster spans two heads
    (256, 2, 16, 4, 1),     # a head spans two clusters, two gates a head
    (128, 1, 16, 2, 2),     # one head over four clusters (16-channel blocks, 2 chunks each)
    (192, 4, 32, 4, 2),     # blocks span heads; the last cluster padded by two blocks
    (320, 4, 16, 8, 5),     # 20 blocks in clusters of 8; rows past a power of two
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exchange_delivers_each_chunk_once(d, nh, cpb, cs, b, seed):
    _Exchange(d, nh, cpb, cs, b, 5).simulate(seed)


# -- the products' tiles --------------------------------------------------------
def _tree(parts):
    """The kernel's fixed tree over the KP partial sums (neighbours first)."""
    v = list(parts)
    w = 1
    while w < len(v):
        for k in range(0, len(v) - w, 2 * w):
            v[k] = v[k] + v[k + w]
        w *= 2
    return v[0]


def _mma_dh_rec(dg, r, j0, cpb, d):
    """dh_rec (B, cpb) of the block of channels j0 .. as the kernel forms it:
    warp w takes k part kp = w % KP and m-tiles mg MPW .. (mg = w / KP);
    m-tile m holds channels j0 + m 16 + row of r's rows (A), k-step x the
    terms (kb + x) 16 + 4 t4 .. 4 t4 + 3 of each lane's fragments, B from the
    rows of dg at the m-tile's head; two chains a tile (even and odd steps)
    added into the warp's partial sums, then the KP sums in the tree."""
    nh, dh = r.shape[:2]
    e4, b = 4 * dh, dg.shape[0]
    kp_n = slstm.KP
    mpw = 2 * kp_n // WARPS
    nks = e4 // 16
    kpw = -(-nks // kp_n)
    nch = min(cpb, d - j0)
    rows = r.reshape(d, e4)
    parts = np.zeros((kp_n, b, 32))
    for w in range(WARPS):
        kp, mg = w % kp_n, w // kp_n
        kb = kp * kpw
        kn = max(0, min(kpw, nks - kb))
        for mm in range(mpw):
            m = mg * mpw + mm
            if m >= cpb // 16:
                continue
            head = (j0 + m * 16) // dh
            acc = np.zeros((2, b, 16))
            for x in range(kn):
                for t4 in range(4):
                    terms = (kb + x) * 16 + 4 * t4 + np.arange(4)
                    for row in range(16):
                        jj = m * 16 + row
                        a = rows[j0 + jj, terms] if jj < nch else np.zeros(4)
                        acc[x & 1, :, row] += dg[:, head * e4 + terms] @ a
            parts[kp, :, m * 16:m * 16 + 16] = acc[0] + acc[1]
    return np.stack([[_tree(parts[:, bb, jj]) for jj in range(nch)] for bb in range(b)])


@pytest.mark.parametrize("nh, cpb", [(4, 16), (2, 32), (1, 16)])
def test_mma_tiles_give_the_reference_vjp(nh, cpb):
    """The blocks' tiled products of one step's dg (the cell's backward in
    fp64 from the reference's own gates), over D 64, equal the h cotangent
    of ``jax.vjp`` of the reference's ``_slstm_cell`` on the same seeded
    inputs and cotangents (fp32 JAX, 1e-5)."""
    d, b = 64, 2
    dh = d // nh
    rng = np.random.default_rng(23 + nh)
    gx = rng.standard_normal((b, 4 * d))
    r = rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh)
    h = np.tanh(rng.standard_normal((b, d)))
    c = rng.standard_normal((b, d))
    dh_new, dc_new = rng.standard_normal((b, d)), rng.standard_normal((b, d))

    def sig(x):
        return 1 / (1 + np.exp(-x))

    g = gx + np.einsum("bhd,hde->bhe", h.reshape(b, nh, dh), r).reshape(b, 4 * d)
    si, sf, so = sig(g[:, :d]), sig(g[:, d:2 * d]), sig(g[:, 3 * d:])
    tz = np.tanh(g[:, 2 * d:3 * d])
    c_new = sf * c + si * tz
    tc = np.tanh(c_new)
    dc = dc_new + dh_new * so * (1 - tc * tc)
    dg = np.concatenate([dc * tz * si * (1 - si), dc * c * sf * (1 - sf),
                         dc * si * (1 - tz * tz), dh_new * tc * so * (1 - so)], axis=1)
    got = np.concatenate([_mma_dh_rec(dg, r, j0, cpb, d) for j0 in range(0, d, cpb)], axis=1)
    f32 = jnp.float32
    _, vjp = jax.vjp(lambda hh: jxl._slstm_cell(jnp.asarray(gx, f32), hh, jnp.asarray(c, f32),
                                                jnp.asarray(r, f32), nh, dh),
                     jnp.asarray(h, f32))
    (want,) = vjp((jnp.asarray(dh_new, f32), jnp.asarray(dc_new, f32)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
