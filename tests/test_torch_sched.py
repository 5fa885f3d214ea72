"""The port's copy of the scheduler core and its schedule bridge against the
reference, on the CPU.

Chunk axis orders are integer outputs and must be equal, element for
element: ``themis_axis_orders`` under the themis, baseline and themis_scf
policies and ``themis_axis_orders_stream``, over the
``tests/test_comms_bridge.py`` axes and a grid of mesh sizes, byte counts
and chunk counts; every scheduler policy's chunk schedules on the paper's
topologies. ``predicted_axis_loads`` within 1e-12 relative.
"""
import math

import pytest

from repro.comms import schedule_bridge as jsb
from repro.core.scheduler import POLICIES as JPOLICIES
from repro.core.scheduler import schedule_collective as j_schedule_collective
from repro.topology import make_current_topology as j_current
from repro.topology import make_table2_topologies as j_table2
from repro.topology import make_tpu_pod_topology as j_tpu_pod
from repro_torch.comms import schedule_bridge as tsb
from repro_torch.core.scheduler import POLICIES, schedule_collective
from repro_torch.topology import (
    make_current_topology,
    make_table2_topologies,
    make_tpu_pod_topology,
)

AXES = {"model": 16, "data": 16, "pod": 2}
MESHES = [AXES, {"model": 2, "data": 2, "pod": 2}, {"data": 2, "model": 4},
          {"data": 8}, {"model": 8, "data": 4, "pod": 4}, {"pod": 4, "model": 2},
          {}]
NBYTES = [1234 * 4, 4e9, 12e9]
CHUNKS = [1, 4, 16, 64]


def _mesh_id(m):
    return "x".join(f"{k}{v}" for k, v in m.items()) or "one-rank"


@pytest.mark.parametrize("axes", MESHES, ids=_mesh_id)
def test_topology_from_axes_matches_reference(axes):
    t, names = tsb.topology_from_axes(axes)
    j, jnames = jsb.topology_from_axes(axes)
    assert names == jnames
    assert t.num_dims == j.num_dims
    for a, b in zip(t.dims, j.dims):
        assert (a.npus, a.topo.value, a.link_gbps, a.links_per_npu,
                a.step_latency_s, a.aggr_bw_bytes) == \
            (b.npus, b.topo.value, b.link_gbps, b.links_per_npu,
             b.step_latency_s, b.aggr_bw_bytes)


@pytest.mark.parametrize("policy", ["themis", "baseline", "themis_scf",
                                    "hier_baseline"])
@pytest.mark.parametrize("axes", MESHES, ids=_mesh_id)
def test_axis_orders_equal_reference(axes, policy):
    for nbytes in NBYTES:
        for n in CHUNKS:
            got = tsb.themis_axis_orders(axes, nbytes, n, policy)
            want = jsb.themis_axis_orders(axes, nbytes, n, policy)
            assert [tuple(o) for o in got] == [tuple(o) for o in want], (
                nbytes, n)


@pytest.mark.parametrize("issue_times", [None, [0.0, 0.0, 0.0],
                                         [10.0, 0.0, 1e-3]])
@pytest.mark.parametrize("axes", MESHES[:5], ids=_mesh_id)
def test_stream_orders_equal_reference(axes, issue_times):
    buckets = [4e9, 1e8, 4e9]
    for policy in ("themis", "baseline"):
        for n in (4, 16):
            got = tsb.themis_axis_orders_stream(axes, buckets, n, policy,
                                                issue_times=issue_times)
            want = jsb.themis_axis_orders_stream(axes, buckets, n, policy,
                                                 issue_times=issue_times)
            assert [[tuple(o) for o in b] for b in got] == \
                [[tuple(o) for o in b] for b in want]


@pytest.mark.parametrize("axes", MESHES[:6], ids=_mesh_id)
def test_predicted_axis_loads_match_reference(axes):
    for nbytes in NBYTES:
        orders = jsb.themis_axis_orders(axes, nbytes, 16, "themis")
        orders[0] = tuple(reversed(orders[0]))          # a non-greedy order too
        got = tsb.predicted_axis_loads(axes, nbytes, orders)
        want = jsb.predicted_axis_loads(axes, nbytes, orders)
        assert got.keys() == want.keys()
        for k in want:
            assert math.isclose(got[k], want[k], rel_tol=1e-12, abs_tol=0.0)


def _topologies(table2, current, tpu_pod):
    return {**table2(), "current": current(), "tpu-pod": tpu_pod(),
            "tpu-pod-small": tpu_pod(2, 2, 2)}


@pytest.mark.parametrize("policy", JPOLICIES)
@pytest.mark.parametrize("collective", ["AR", "RS", "AG"])
def test_scheduler_policies_equal_reference(policy, collective):
    assert POLICIES == JPOLICIES
    mine = _topologies(make_table2_topologies, make_current_topology,
                       make_tpu_pod_topology)
    ref = _topologies(j_table2, j_current, j_tpu_pod)
    assert mine.keys() == ref.keys()
    for name in ref:
        for nbytes, n in ((64e6, 8), (1e9, 64)):
            got = schedule_collective(mine[name], collective, nbytes, n, policy)
            want = j_schedule_collective(ref[name], collective, nbytes, n,
                                         policy)
            assert [(c.index, c.size_bytes,
                     [(ph.value, d) for ph, d in c.schedule]) for c in got] == \
                [(c.index, c.size_bytes,
                  [(ph.value, d) for ph, d in c.schedule]) for c in want], name
