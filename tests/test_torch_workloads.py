"""The port's Fig. 12 workloads (``repro_torch.core.workloads``) and the
Fig. 8 / Fig. 12 grids that ``chip_smoke.py``'s ``phase_simulator`` prints,
against the reference, on the CPU.

Every value is a simulated fabric time computed on the host and must equal
the reference's exactly: the workloads' collectives, ``split_topology``,
``dp_bucket_requests``, ``calibrate_compute`` and ``iteration_time`` (with
and without ``overlap_buckets=8``) on the six Table-2 topologies, and the
Fig. 8 all-reduce makespans with their summary.
"""
import dataclasses
import statistics
import sys
from pathlib import Path

import pytest

from repro.core import workloads as jw
from repro.core.simulator import simulate_scheduled as j_simulate_scheduled
from repro.topology import make_table2_topologies as j_table2
from repro_torch.core import workloads as tw
from repro_torch.topology import make_table2_topologies

ROOT = Path(__file__).resolve().parents[1]
J_TOPOS = j_table2()
T_TOPOS = make_table2_topologies()
NAMES = list(T_TOPOS)
WORKLOADS = list(tw.ALL_WORKLOADS)
PAPER_IDEAL = {"resnet152": 1.54, "gnmt": 1.32, "dlrm": 1.33, "transformer_1t": 1.26}
VARIANTS = [("baseline", "FIFO"), ("themis", "SCF"), ("themis", "FIFO"), ("ideal", "SCF")]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _workload_fields(w):
    return (w.name, w.compute_fwd_s, w.compute_bwd_s, w.mp_npus, w.dp_buckets,
            [dataclasses.astuple(o) for o in w.comm_ops])


def _iter_tuple(r):
    return (r.compute_s, r.exposed_dp_s, r.exposed_mp_s, r.total_s)


def test_workload_registry_and_definitions_equal_reference():
    assert WORKLOADS == list(jw.ALL_WORKLOADS)
    for name in WORKLOADS:
        assert _workload_fields(tw.ALL_WORKLOADS[name]()) == _workload_fields(
            jw.ALL_WORKLOADS[name]())
    assert tw.resnet152_param_buckets() == jw.resnet152_param_buckets()
    assert (_workload_fields(tw.make_transformer_1t())
            == _workload_fields(jw.make_transformer_1t()))


@pytest.mark.parametrize("name", NAMES)
def test_split_topology_equals_reference(name):
    for mp in (1, 2, 8, 16, 64, 128):
        for got, want in zip(tw.split_topology(T_TOPOS[name], mp),
                             jw.split_topology(J_TOPOS[name], mp)):
            assert got.name == want.name
            assert [(d.npus, d.topo.value, d.link_gbps, d.links_per_npu,
                     d.step_latency_s, d.straggler_sigma) for d in got.dims] == \
                [(d.npus, d.topo.value, d.link_gbps, d.links_per_npu,
                  d.step_latency_s, d.straggler_sigma) for d in want.dims]


@pytest.mark.parametrize("wname", WORKLOADS)
def test_dp_bucket_requests_equal_reference(wname):
    for n in (1, 3, 8, 32):
        got = tw.dp_bucket_requests(tw.ALL_WORKLOADS[wname](), n)
        want = jw.dp_bucket_requests(jw.ALL_WORKLOADS[wname](), n)
        assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r)
                                                         for r in want]


@pytest.mark.parametrize("wname", WORKLOADS)
def test_calibrate_compute_and_iteration_time_equal_reference(wname):
    """Fig. 12's cell: the compute time calibrated to the paper's Ideal,
    then each policy's iteration time on the six topologies, with the
    one-sync-point model and with 8 overlapped gradient buckets."""
    w, jw_ = tw.ALL_WORKLOADS[wname](), jw.ALL_WORKLOADS[wname]()
    c = tw.calibrate_compute(w, list(T_TOPOS.values()), PAPER_IDEAL[wname])
    jc = jw.calibrate_compute(jw_, list(J_TOPOS.values()), PAPER_IDEAL[wname])
    assert c == jc
    assert _workload_fields(w) == _workload_fields(jw_)
    for name in NAMES:
        for policy, intra in VARIANTS:
            for overlap in (0, 8):
                got = tw.iteration_time(w, T_TOPOS[name], policy, intra=intra,
                                        overlap_buckets=overlap)
                want = jw.iteration_time(jw_, J_TOPOS[name], policy, intra=intra,
                                         overlap_buckets=overlap)
                assert _iter_tuple(got) == _iter_tuple(want), (name, policy, overlap)


def test_fig12_grid_equals_reference():
    """``chip_smoke.fig12_grid`` (what ``phase_simulator`` prints) equals the
    same computation through the reference, row for row and in summary."""
    rows, summary = _chip_smoke().fig12_grid()
    topos = list(J_TOPOS.values())
    want_rows = []
    for wname, make in jw.ALL_WORKLOADS.items():
        w = make()
        c = jw.calibrate_compute(w, topos, PAPER_IDEAL[wname])
        themis, ideal = [], []
        for topo in topos:
            b = jw.iteration_time(w, topo, "baseline", intra="FIFO").total_s
            t = jw.iteration_time(w, topo, "themis", intra="SCF").total_s
            i = jw.iteration_time(w, topo, "ideal").total_s
            want_rows.append({"workload": wname, "topology": topo.name,
                              "baseline_fifo_s": b, "themis_scf_s": t, "ideal_s": i})
            themis.append(b / t)
            ideal.append(b / i)
        assert summary[wname] == {"compute_s": c, "themis_avg": statistics.mean(themis),
                                  "themis_max": max(themis),
                                  "ideal_avg": statistics.mean(ideal)}
    assert rows == want_rows


def test_fig8_grid_equals_reference():
    """``chip_smoke.fig8_grid``: the six topologies x 100-1000 MB all-reduce
    makespans under baseline/FIFO, themis/FIFO and themis/SCF, equal to the
    reference's ``simulate_scheduled``, and the summary from them."""
    rows, summary = _chip_smoke().fig8_grid()
    assert len(rows) == 6 * 5
    fifo, scf = [], []
    for row in rows:
        topo = J_TOPOS[row["topology"]]
        want = {label: j_simulate_scheduled(topo, "AR", row["size_mb"] * 1e6,
                                            policy=policy, intra=intra)[0].makespan
                for label, policy, intra in (("baseline_fifo_s", "baseline", "FIFO"),
                                             ("themis_fifo_s", "themis", "FIFO"),
                                             ("themis_scf_s", "themis", "SCF"))}
        assert {k: row[k] for k in want} == want
        fifo.append(want["baseline_fifo_s"] / want["themis_fifo_s"])
        scf.append(want["baseline_fifo_s"] / want["themis_scf_s"])
    assert summary == {"avg_speedup_fifo": sum(fifo) / len(fifo),
                       "avg_speedup_scf": sum(scf) / len(scf), "max_speedup_scf": max(scf)}
