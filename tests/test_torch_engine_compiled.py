"""The port's compiled engine (``repro_torch.core.engine_compiled``) and its
wave kernel against the reference's, on the CPU.

The wave kernel (``wave_done_times``) is the reference's ``jax.jit`` kernel
rewritten as vectorized torch, in float64: within ``JIT_RTOL`` of the JAX
kernel at the reference test's shape (24 MB RS, 12 chunks); within 1e-9 of
both packages' ``simulate_compiled`` at 4 x 1024 and 16 x 4096 chunks; within
1e-12 of the sequential ``wave_done_times_plain``. The JAX kernel runs in
float32 and misses its own ``JIT_RTOL`` from 16 x 4096 chunks on (ROADMAP
R5), so it is compared only at small sizes. On this CUDA-less machine the
kernel runs with ``device="cpu"``; without it, it raises.
"""
import numpy as np
import pytest
import torch

from repro.core import engine_compiled as j_ec
from repro.core.scheduler import schedule_collective as j_schedule
from repro.core.simulator import build_task_arrays as j_build_task_arrays
from repro.core.simulator import simulate as j_simulate
from repro.core.latency_model import LatencyModel as JLatencyModel
from repro.topology import make_table2_topologies as j_table2
from repro_torch.core import engine_compiled as ec
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.scheduler import schedule_collective
from repro_torch.core.simulator import build_task_arrays, simulate
from repro_torch.topology import make_table2_topologies

MB = 1e6
WAVE_TOPOLOGY = "3D-SW_SW_SW_hetero"
J_TOPOS = j_table2()
T_TOPOS = make_table2_topologies()
SIM_RTOL = 1e-9
PLAIN_RTOL = 1e-12


def _wave_stream(topo, schedule, size, n_requests, n_chunks, period=100e-6):
    """``n_requests`` baseline RS requests of ``n_chunks`` chunks, one every
    ``period`` seconds, each chunk a group of its own."""
    one = schedule(topo, "RS", size, n_chunks, "baseline")
    groups = [[c] for _ in range(n_requests) for c in one]
    issue = [r * period for r in range(n_requests) for _ in one]
    return groups, issue


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))


def test_wave_kernel_within_jit_rtol_of_jax_kernel_at_reference_shape():
    """The reference test's stream (24 MB baseline RS, 12 chunks, all issued
    at 0): the port's kernel against the JAX kernel within ``JIT_RTOL``, and
    against the port's compiled engine within rounding."""
    groups, issue = _wave_stream(T_TOPOS[WAVE_TOPOLOGY], schedule_collective, 24 * MB,
                                 1, 12, 0.0)
    j_groups, _ = _wave_stream(J_TOPOS[WAVE_TOPOLOGY], j_schedule, 24 * MB, 1, 12, 0.0)
    done = ec.wave_done_times(*ec.wave_arrays(T_TOPOS[WAVE_TOPOLOGY], groups, issue),
                              device="cpu")
    j_done = j_ec.wave_done_times(*j_ec.wave_arrays(J_TOPOS[WAVE_TOPOLOGY], j_groups,
                                                    issue))
    assert done.shape == (12,) and done.dtype == np.float64
    assert ec.JIT_RTOL == j_ec.JIT_RTOL == 1e-4
    assert _rel(done, j_done) <= ec.JIT_RTOL
    res = simulate(T_TOPOS[WAVE_TOPOLOGY], groups, engine="compiled", issue_times=issue,
                   fusion=False)
    assert _rel(done, res.group_finish) <= SIM_RTOL


def test_wave_kernel_within_jit_rtol_of_jax_kernel_at_4x1024():
    """4 requests of 1024 chunks, 100 us apart: the largest stream on which
    the JAX kernel (float32) still meets its own tolerance."""
    groups, issue = _wave_stream(T_TOPOS[WAVE_TOPOLOGY], schedule_collective, 20 * MB,
                                 4, 1024)
    j_groups, j_issue = _wave_stream(J_TOPOS[WAVE_TOPOLOGY], j_schedule, 20 * MB, 4, 1024)
    done = ec.wave_done_times(*ec.wave_arrays(T_TOPOS[WAVE_TOPOLOGY], groups, issue),
                              device="cpu")
    j_done = j_ec.wave_done_times(*j_ec.wave_arrays(J_TOPOS[WAVE_TOPOLOGY], j_groups,
                                                    j_issue))
    assert _rel(done, j_done) <= ec.JIT_RTOL


@pytest.mark.parametrize("n_requests,n_chunks", [(4, 1024), (16, 4096)])
def test_wave_kernel_matches_both_compiled_engines(n_requests, n_chunks):
    """The stream that ``chip_smoke.py``'s ``phase_wave`` runs, at two sizes:
    the kernel within 1e-9 of the port's and the reference's
    ``simulate(engine="compiled", fusion=False)``, which agree with each
    other to the bit, and within 1e-12 of the sequential plain version."""
    topo, j_topo = T_TOPOS[WAVE_TOPOLOGY], J_TOPOS[WAVE_TOPOLOGY]
    groups, issue = _wave_stream(topo, schedule_collective, 20 * MB, n_requests, n_chunks)
    j_groups, j_issue = _wave_stream(j_topo, j_schedule, 20 * MB, n_requests, n_chunks)
    arrays = ec.wave_arrays(topo, groups, issue)
    done = ec.wave_done_times(*arrays, device="cpu")
    res = simulate(topo, groups, engine="compiled", issue_times=issue, fusion=False)
    j_res = j_simulate(j_topo, j_groups, engine="compiled", issue_times=j_issue,
                       fusion=False)
    assert res.diff_fields(j_res) == []
    assert _rel(done, res.group_finish) <= SIM_RTOL
    assert _rel(done, j_res.group_finish) <= SIM_RTOL
    assert _rel(done, ec.wave_done_times_plain(*arrays)) <= PLAIN_RTOL


def test_wave_arrays_equal_reference():
    """``wave_arrays`` is a copy: the same four arrays, element for element,
    on a stream with staggered requests."""
    topo, j_topo = T_TOPOS[WAVE_TOPOLOGY], J_TOPOS[WAVE_TOPOLOGY]
    groups, issue = _wave_stream(topo, schedule_collective, 20 * MB, 3, 64)
    j_groups, j_issue = _wave_stream(j_topo, j_schedule, 20 * MB, 3, 64)
    got = ec.wave_arrays(topo, groups, issue)
    want = j_ec.wave_arrays(j_topo, j_groups, j_issue)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_wave_kernel_on_random_segments_matches_plain():
    """Several dims per rank, ties in arrival time, arrivals out of chunk
    order: the closed form against the sequential recurrence."""
    rng = np.random.default_rng(3)
    C, R = 500, 4
    issue = rng.choice([0.0, 1e-4, 2e-4], size=C)
    occupy = rng.uniform(1e-6, 5e-5, size=(C, R))
    fixed = rng.uniform(0.0, 1e-5, size=(C, R))
    dims = rng.integers(0, 3, size=(C, R))
    got = ec.wave_done_times(issue, occupy, fixed, dims, device="cpu")
    want = ec.wave_done_times_plain(issue, occupy, fixed, dims)
    assert _rel(got, want) <= PLAIN_RTOL
    j_want = j_ec.wave_done_times(issue, occupy, fixed, dims)
    assert _rel(got, j_want) <= ec.JIT_RTOL


def test_wave_arrays_reject_unequal_stage_counts():
    """A stream whose chunks have unequal stage counts (an RS beside an AR)
    is not wave-shaped: ``ValueError``, as in the reference."""
    topo, j_topo = T_TOPOS[WAVE_TOPOLOGY], J_TOPOS[WAVE_TOPOLOGY]
    groups = [schedule_collective(topo, "RS", 4 * MB, 4, "baseline"),
              schedule_collective(topo, "AR", 4 * MB, 4, "baseline")]
    j_groups = [j_schedule(j_topo, "RS", 4 * MB, 4, "baseline"),
                j_schedule(j_topo, "AR", 4 * MB, 4, "baseline")]
    with pytest.raises(ValueError, match="equal stage counts"):
        ec.wave_arrays(topo, groups, [0.0, 0.0])
    with pytest.raises(ValueError, match="equal stage counts"):
        j_ec.wave_arrays(j_topo, j_groups, [0.0, 0.0])


def test_wave_kernel_asks_for_the_card_and_counts_only_card_calls(monkeypatch):
    """With no ``device`` the kernel runs on CUDA; where CUDA is absent it
    raises, with no CPU fallback. A CPU call launches nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = (np.zeros(2), np.ones((2, 1)), np.zeros((2, 1)), np.zeros((2, 1), np.int64))
    before = ec.launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ec.wave_done_times(*arrays)
    assert not ec.jit_available()
    assert list(ec.wave_done_times(*arrays, device="cpu")) == [1.0, 2.0]
    assert ec.launches == before


def test_wave_kernel_empty_stream():
    empty = (np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    assert ec.wave_done_times(*empty, device="cpu").shape == (0,)
    assert ec.wave_done_times_plain(*empty).shape == (0,)


@pytest.mark.parametrize("name", ["2D-SW_SW", "4D-Ring_FC_Ring_SW"])
def test_task_arrays_equal_reference(name):
    """The SoA task build the compiled engine replays: every column equal."""
    topo, j_topo = T_TOPOS[name], J_TOPOS[name]
    groups = [schedule_collective(topo, c, 30 * MB, 8, "themis") for c in ("AR", "RS", "AG")]
    j_groups = [j_schedule(j_topo, c, 30 * MB, 8, "themis") for c in ("AR", "RS", "AG")]
    args = ([1, 0, 2], ["a", "b", "a"])
    got = build_task_arrays(LatencyModel.for_topology(topo), groups, *args)
    want = j_build_task_arrays(JLatencyModel.for_topology(j_topo), j_groups, *args)
    for col in ("n_tasks", "chunk", "stage", "dim", "wire", "fixed", "group", "prio",
                "tenant", "last", "first_handles", "group_wire", "fingerprint"):
        assert getattr(got, col) == getattr(want, col), col


def test_simulate_compiled_direct_equals_reference():
    """``simulate_compiled`` called directly, with priorities, tenants and
    a shared prebuilt task-array replay."""
    name = "3D-FC_Ring_SW"
    topo, j_topo = T_TOPOS[name], J_TOPOS[name]
    groups = [schedule_collective(topo, c, 30 * MB, 8, "themis") for c in ("AR", "RS", "AG")]
    j_groups = [j_schedule(j_topo, c, 30 * MB, 8, "themis") for c in ("AR", "RS", "AG")]
    kw = dict(issue_times=[0.0, 2e-4, 5e-4], priorities=[0, 1, 0],
              tenants=["a", "b", "a"], streams=["x", "y", "x"], intra="FIFO",
              fusion=True, fusion_limit=8, jitter=0.05, seed=3)
    ta = build_task_arrays(LatencyModel.for_topology(topo), groups, kw["priorities"],
                           kw["tenants"])
    got = ec.simulate_compiled(topo, groups, task_arrays=ta, **kw)
    again = ec.simulate_compiled(topo, groups, task_arrays=ta, **kw)
    want = j_ec.simulate_compiled(j_topo, j_groups, **kw)
    assert got.diff_fields(want) == [] and again.diff_fields(want) == []


def test_blocked_scans_match_plain_scans():
    """The wave kernel's row scans, a row split into blocks of
    ``_SCAN_BLOCK``: the max to the bit, the sum within rounding; a single
    row as several."""
    gen = torch.Generator().manual_seed(5)
    width = 3 * ec._SCAN_BLOCK
    for rows in (1, 3):
        table = torch.rand((rows, width), generator=gen, dtype=torch.float64)
        assert torch.equal(ec._blocked_scan(table, "max"), table.cummax(1).values)
        got, want = ec._blocked_scan(table, "sum"), table.cumsum(1)
        assert float(((got - want).abs() / want).max()) <= PLAIN_RTOL
        assert torch.equal(ec._rows_cumsum(table), table.cumsum(1))


def test_wave_kernel_on_segments_longer_than_a_block():
    """Segments that span several scan blocks, on three dims per rank."""
    rng = np.random.default_rng(8)
    C, R = 7000, 3
    issue = np.sort(rng.uniform(0.0, 2e-3, size=C))
    occupy = rng.uniform(1e-7, 5e-6, size=(C, R))
    fixed = rng.uniform(0.0, 1e-6, size=(C, R))
    dims = rng.integers(0, 3, size=(C, R))
    got = ec.wave_done_times(issue, occupy, fixed, dims, device="cpu")
    assert _rel(got, ec.wave_done_times_plain(issue, occupy, fixed, dims)) <= PLAIN_RTOL
