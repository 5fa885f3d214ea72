"""The sLSTM forward kernel's clusters (``csrc/slstm_scan.cu``) on the CPU:
what can be held here of a kernel that runs only on the card.

- ``slstm.plan`` at xlstm-1.3b's shapes (B 1 and 4, bf16 and fp32) and the
  reduced config's, with an H100's residency (the most clusters of 16, 8, 4
  and 2 blocks of 512 threads it holds at once: 7, 15, 30 and 66), and its
  refusals; ``smem_bytes`` against the source's layout constants.
- A model in numpy of the exchange of h over a few steps, run under random
  interleavings of the blocks, as the kernel runs it (one block of a
  cluster polls each of the other clusters' words and sends it into every
  block of the cluster; each block waits on its mbarrier) and as two of its
  timed variants do (every block polling every word itself; a cluster
  barrier): every block receives every chunk of h_{t-1} exactly once, with
  its owner's value of that step, and no buffer (a block's two in shared
  memory, the two of tagged words in L2) is written before its last reader
  of the step before is done.
- The bf16 products' m16n8k16 tiling mirrored in numpy (A fragments from
  r_gates with the k terms 4 t4 .. 4 t4 + 3 a lane, B fragments from rows of
  h, KS partial sums a column), whose gates, run through one cell step,
  equal the reference's ``_slstm_cell`` (``repro/models/xlstm.py``) on the
  same seeded inputs.
- The exported C symbols and the constants the wrapper mirrors.
"""
import ctypes
import random
import re

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


def _src():
    return (_build.CSRC / "slstm_scan.cu").read_text()


@pytest.mark.parametrize("b, d, dh, elem, want", [
    (4, 2048, 512, 2, (16, 32, 64)),      # the prefill, the decode step, training
    (1, 2048, 512, 2, (16, 32, 64)),      # long_500k
    (4, 2048, 512, 4, (2, 16, 128)),      # fp32: 20 channels a block would not fit
    (1, 2048, 512, 4, (16, 20, 112)),
    (2, 64, 16, 2, (4, 16, 4)),           # the reduced config: 4 blocks, one cluster
    (2, 64, 16, 4, (16, 4, 16)),
])
def test_plan_at_the_paths_shapes(b, d, dh, elem, want):
    """At xlstm-1.3b's D 2048 the H100 holds no 128 blocks in clusters of
    8 or 16 (15 x 8, 7 x 16), so bf16 takes 32 channels a block (two
    m-tiles a gate) in 4 clusters of 16; fp32 at batch 4 would need 20
    channels a block, whose 160 KB of r_gates and two 32 KB buffers of h do
    not fit, and takes clusters of 2 at 16. The grid is whole clusters and
    the shared bytes are ``smem_bytes``'s."""
    cluster, cpb, grid, smem = slstm.plan(b, d, dh, elem, SMS, H100)
    assert (cluster, cpb, grid) == want
    assert grid % cluster == 0 and (grid - cluster) * cpb < d <= grid * cpb
    assert smem == slstm.smem_bytes(elem, b, d, dh, cpb) <= slstm.SMEM_LIMIT
    assert b * cpb <= slstm.MAX_PAIRS * slstm.THREADS


def test_plan_follows_the_cards_residency():
    """A card that held 16 clusters of 8 and 8 of 16 would take 16 channels
    a block in 8 clusters of 16; one that held clusters of 2 only, 16 in
    64 of them; one that held none is refused."""
    assert slstm.plan(4, 2048, 512, 2, SMS, {16: 8, 8: 16, 4: 32, 2: 66}.get) == (
        16, 16, 128, slstm.smem_bytes(2, 4, 2048, 512, 16))
    assert slstm.plan(4, 2048, 512, 2, SMS, {16: 0, 8: 0, 4: 0, 2: 66}.get)[:3] == (2, 16, 128)
    with pytest.raises(ValueError, match="residency"):
        slstm.plan(4, 2048, 512, 2, SMS, lambda cluster: 0)


@pytest.mark.parametrize("b, d, dh, elem, match", [
    (16, 2048, 512, 4, "shared memory"),
    (129, 2048, 8, 2, "pairs"),
    (4, 2048, 1024, 2, "tiles"),          # dh 1024: more k-steps than a warp keeps
    (4, 2048, 256, 2, "tiles"),           # 8 heads: a gate's columns span two
])
def test_plan_refusals(b, d, dh, elem, match):
    with pytest.raises(ValueError, match=match):
        slstm.plan(b, d, dh, elem, SMS, H100)


def test_smem_bytes_mirrors_the_source():
    """The constants of the layout agree with the source's, and the bytes
    at the prefill's shape are the sum of its parts: barriers, two padded
    buffers of h, the KS partial sums for 8 rows, the new h, the stages."""
    src = _src()
    for name, value in (("NST", slstm.NST), ("HPAD", slstm.HPAD)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    assert "constexpr int KS = WARPS / 4;" in src and slstm.KS == 512 // 32 // 4
    bars, h = 8 * (2 + slstm.NST), 2 * 4 * (2 * 2048 + slstm.HPAD)
    part, hnew, stages = 4 * 4 * 32 * slstm.KS * 8, 2 * 4 * 32, slstm.NST * 2 * 4 * 4 * 32
    assert slstm.smem_bytes(2, 4, 2048, 512, 32) == bars + h + part + hnew + stages
    rs = 4 * 4 * 16 * 512                 # fp32 keeps r_gates' columns in shared memory
    assert (slstm.smem_bytes(4, 4, 2048, 512, 16)
            == bars + rs + 2 * 4 * (4 * 2048 + slstm.HPAD) + 16 * 16 * 4 + 4 * 4 * 16
            + slstm.NST * 4 * 4 * 4 * 16)


def test_source_exports_the_symbols_the_wrapper_binds():
    src = _src()
    for symbol, argtypes in (slstm.KERNEL, slstm.CLUSTERS):
        found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
        assert found, f"slstm_scan.cu does not export {symbol}"
        declared = [ctypes.c_void_p if "*" in p else ctypes.c_int
                    for p in (p.strip() for p in found.group(1).split(","))]
        assert declared == argtypes, symbol


# -- the exchange ---------------------------------------------------------------
class _Exchange:
    """The kernel's exchange of h in numpy: ``grid`` blocks in clusters of
    ``cs``, block j owning the 16-byte chunks [j oc, (j + 1) oc) of each of
    B rows (``nchunk`` a row; blocks past them pad the last cluster). Step
    t of a block: poll h_{t-1}'s chunks of the other clusters from the L2
    buffer (t - 1) & 1 once their tag is t, with ``relay`` (the kernel)
    those that fall to it (i = rank + cs x, the source's formula), sent
    into buffer (t - 1) & 1 of every block of its cluster, else every one
    of them for itself, stored into its own buffer; wait on its mbarrier
    for what is sent to it (``relay``: every chunk, else its cluster's), or
    with ``cluster_barrier`` until every block of the cluster has polled
    and sent; the products read buffer (t - 1) & 1; its
    own chunks of h_t into buffer t & 1 of every block of its cluster and,
    as words tagged t + 1, into the L2 buffer t & 1. Records every write
    with its source, and checks each read and overwrite."""

    def __init__(self, grid, cs, oc, nchunk, b, steps, relay, cluster_barrier):
        self.grid, self.cs, self.oc, self.nchunk, self.b, self.steps = (
            grid, cs, oc, nchunk, b, steps)
        self.relay, self.cluster_barrier = relay, cluster_barrier
        # smem[j][p][(row, chunk)] = list of (owner, step, sender) received
        self.smem = [[{} for _ in range(2)] for _ in range(grid)]
        self.l2 = [{} for _ in range(2)]              # (row, chunk) -> (owner, tag)
        self.read_done = [[-1] * 2 for _ in range(grid)]   # the step whose h a buffer last gave
        self.l2_reads = [{} for _ in range(2)]       # (row, chunk) -> blocks that polled it
        self.at = [(0, "poll")] * grid
        self.arrived = {}                             # (cluster, t) -> blocks at the barrier

    def owner(self, u):
        return u // self.oc

    def cluster(self, j):
        return j // self.cs

    def polls(self, j):
        """The (row, chunk)s of the other clusters block j polls."""
        cs, cl, rank = self.cs, self.cluster(j), j % self.cs
        cc = cs * self.oc
        own_lo = min(self.nchunk, cl * cc)
        own_n = min(self.nchunk, own_lo + cc) - own_lo
        nfr = self.nchunk - own_n
        out, x = [], 0
        while (i := (rank + cs * x if self.relay else x)) < self.b * nfr:
            r = i % nfr
            out.append((i // nfr, r if r < own_lo else r + own_n))
            x += 1
        return out

    def peers(self, j):
        return range(self.cluster(j) * self.cs, self.cluster(j) * self.cs + self.cs)

    def write(self, target, p, key, owner, step, sender):
        # the buffer's last reader is done with h_{step-2}
        assert self.read_done[target][p] >= step - 2, (target, p, step)
        self.smem[target][p].setdefault(key, []).append((owner, step, sender))

    def counted(self, j, t):
        """Whether block j's mbarrier has counted the bytes of h_{t-1} it
        waits for: every chunk (relay), or its own cluster's."""
        got = self.smem[j][(t - 1) & 1]
        return all((row, u) in got for row in range(self.b) for u in range(self.nchunk)
                   if self.relay or self.cluster(self.owner(u)) == self.cluster(j))

    def enabled(self, j):
        t, what = self.at[j]
        if t >= self.steps:
            return False
        if what == "poll" and t > 0:
            return all(self.l2[(t - 1) & 1].get(key, (None, -1))[1] == t
                       for key in self.polls(j))
        if what == "wait" and t > 0:
            if self.cluster_barrier:
                return len(self.arrived.get((self.cluster(j), t), ())) == self.cs
            return self.counted(j, t)
        return True

    def run(self, j):
        t, what = self.at[j]
        if what == "poll":
            if t > 0:
                p = (t - 1) & 1
                for key in self.polls(j):
                    owner, _ = self.l2[p][key]
                    self.l2_reads[p].setdefault(key, set()).add(j)
                    for k in (self.peers(j) if self.relay else (j,)):
                        self.write(k, p, key, owner, t - 1, j)
                self.arrived.setdefault((self.cluster(j), t), set()).add(j)
            self.at[j] = (t, "wait")
        elif what == "wait":
            if t > 0:
                p = (t - 1) & 1
                got = self.smem[j][p]
                for row in range(self.b):
                    for u in range(self.nchunk):
                        recv = got.get((row, u), [])
                        assert len(recv) == 1, (j, t, row, u, recv)
                        owner, step, sender = recv[0]
                        assert (owner, step) == (self.owner(u), t - 1), (j, t, row, u, recv)
                        mine = self.cluster(owner) == self.cluster(j)
                        if mine:        # from its owner, through the cluster
                            assert sender == owner, (j, t, row, u, recv)
                        else:           # polled by this block or relayed in its cluster
                            assert sender == j or (self.relay and
                                                   self.cluster(sender) == self.cluster(j))
                self.smem[j][p] = {}
                self.read_done[j][p] = t - 1
            self.at[j] = (t, "push")
        else:
            if t + 1 < self.steps and j * self.oc < self.nchunk:
                p = t & 1
                mine = range(j * self.oc, min((j + 1) * self.oc, self.nchunk))
                for row in range(self.b):
                    for u in mine:
                        for k in self.peers(j):
                            self.write(k, p, (row, u), j, t, j)
                        if self.grid > self.cs:
                            # every poller of the words' step t - 2 is done with them
                            prev = self.l2[p].get((row, u))
                            if prev is not None:
                                readers = self.l2_reads[p].get((row, u), set())
                                want = {k for k in range(self.grid) if (row, u) in self.polls(k)}
                                assert want and readers == want, (j, t, row, u, readers, want)
                            self.l2[p][(row, u)] = (j, t + 1)
                            self.l2_reads[p][(row, u)] = set()
            self.at[j] = (t + 1, "poll")

    def simulate(self, seed):
        rng = random.Random(seed)
        while any(t < self.steps for t, _ in self.at):
            ready = [j for j in range(self.grid) if self.enabled(j)]
            assert ready, "the exchange deadlocks"
            self.run(rng.choice(ready))


@pytest.mark.parametrize("grid, cs, oc, nchunk, b", [
    (8, 4, 2, 16, 2),       # two clusters of 4, every block whole
    (8, 4, 2, 13, 1),       # the last block partial, the last block of the grid empty
    (4, 2, 4, 16, 3),       # clusters of 2
    (4, 4, 2, 8, 2),        # one cluster: no words in L2
])
@pytest.mark.parametrize("relay, cluster_barrier", [(True, False), (False, False), (True, True)],
                         ids=["relay", "direct", "relay_cluster_barrier"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exchange_protocol_delivers_each_chunk_once(grid, cs, oc, nchunk, b, relay,
                                                    cluster_barrier, seed):
    _Exchange(grid, cs, oc, nchunk, b, 6, relay, cluster_barrier).simulate(seed)


# -- the bf16 products' tiles ---------------------------------------------------
def _mma_gates(h, r, j0, cpb, d, ks_n=slstm.KS):
    """The block's gate pre-activations' products (B, 4, cpb) as the bf16
    kernel forms them: gate q's m-tile m holds the columns (q, m 16 + row);
    warp (q, ks) runs the k-steps [ks kpw, (ks + 1) kpw) of 16 terms, lane
    (g, t4) giving the terms 4 t4 .. 4 t4 + 3 of each as the fragments' two
    k pairs, in A from r_gates and in B from h's row; the KS partial sums of
    a column are added in order."""
    nh, dh = r.shape[:2]
    e4, b = 4 * dh, h.shape[0]
    nks = dh // 16
    kpw = -(-nks // ks_n)
    out = np.zeros((b, 4, cpb))
    for q in range(4):
        hq = (q * d + j0) // e4
        for m in range(cpb // 16):
            for row in range(16):
                jj = m * 16 + row
                if j0 + jj >= d:
                    continue
                idx = q * d + j0 + jj
                assert idx // e4 == hq       # a gate's columns lie in one head
                total = np.zeros(b)
                for ks in range(ks_n):
                    part = np.zeros(b)
                    for x in range(max(0, min(kpw, nks - ks * kpw))):
                        k0 = (ks * kpw + x) * 16
                        for t4 in range(4):
                            terms = k0 + 4 * t4 + np.arange(4)
                            a = r[hq, terms, idx % e4]                     # A: a0 a0' a2 a2'
                            bv = h[:, hq * dh + terms]                     # B: b0 b0' b1 b1'
                            part += bv @ a
                    total += part
                out[:, q, jj] = total
    return out


@pytest.mark.parametrize("nh", [4, 2, 1])
def test_mma_tiles_give_the_reference_cell(nh):
    """Two blocks of 32 channels over D 64 (the reduced width, nh heads):
    their tiled products, added to gx and run through one cell step in fp64,
    equal the reference's ``_slstm_cell`` on the same seeded inputs (fp32
    JAX, 1e-5)."""
    d, b, cpb = 64, 2, 32
    dh = d // nh
    rng = np.random.default_rng(11)
    gx = rng.standard_normal((b, 4 * d))
    r = rng.standard_normal((nh, dh, 4 * dh)) / np.sqrt(dh)
    h = np.tanh(rng.standard_normal((b, d)))
    c = rng.standard_normal((b, d))
    prods = np.concatenate([_mma_gates(h, r, j0, cpb, d) for j0 in range(0, d, cpb)], axis=2)
    g = gx.reshape(b, 4, d) + prods

    def sig(x):
        return 1 / (1 + np.exp(-x))

    c2 = sig(g[:, 1]) * c + sig(g[:, 0]) * np.tanh(g[:, 2])
    h2 = sig(g[:, 3]) * np.tanh(c2)
    f32 = jnp.float32
    want_h, want_c = jxl._slstm_cell(jnp.asarray(gx, f32), jnp.asarray(h, f32),
                                     jnp.asarray(c, f32), jnp.asarray(r, f32), nh, dh)
    np.testing.assert_allclose(h2, np.asarray(want_h), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c2, np.asarray(want_c), atol=1e-5, rtol=1e-5)
