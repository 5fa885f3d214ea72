"""The port's batch runner (``repro_torch.core.batch``) and topology search
(``repro_torch.topology.search``) against the reference, on the CPU.

``simulate_batch`` must equal ``simulate_scenario`` in the port, scenario by
scenario, and both must equal the reference's on the same scenarios
(``SimResult.diff_fields(...) == []``); the vectorized task build equals the
scalar one; ``search_topologies`` evaluates the same candidates with the same
scores, prunes the same number and returns the same best and Pareto front.
"""
import dataclasses
import random

import pytest

from repro.core import batch as jb
from repro.core.latency_model import LatencyModel as JLatencyModel
from repro.core.requests import CollectiveRequest as JRequest
from repro.core.scheduler import schedule_collective as j_schedule
from repro.core.simulator import build_task_arrays as j_build_task_arrays
from repro.core.workloads import dp_bucket_requests as j_dp_bucket_requests
from repro.core.workloads import make_resnet152 as j_make_resnet152
from repro.topology import make_table2_topologies as j_table2
from repro.topology import make_tpu_pod_topology as j_tpu_pod
from repro.topology import search as js
from repro_torch.core import batch as tb
from repro_torch.core import simulate_batch, simulate_scenario
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import POLICIES, schedule_collective
from repro_torch.core.simulator import build_task_arrays
from repro_torch.core.workloads import dp_bucket_requests, make_resnet152
from repro_torch.topology import make_table2_topologies, make_tpu_pod_topology
from repro_torch.topology import search as ts

MB = 1e6
J_TOPOS = j_table2()
T_TOPOS = make_table2_topologies()


def _requests(seed, n):
    rng = random.Random(seed)
    fields = [(rng.choice(("AR", "RS", "AG")), rng.uniform(1, 60) * MB,
               rng.uniform(0, 3e-3), rng.choice((0, 0, 1)), rng.choice(("a", "b")),
               f"s{i % 3}") for i in range(n)]
    mk = (lambda cls: tuple(cls(c, s, issue_time=t, priority=p, tenant=ten, stream=st)
                            for c, s, t, p, ten, st in fields))
    return mk(JRequest), mk(CollectiveRequest)


def _scenarios(policy, j_reqs, reqs):
    """The same scenarios for both packages: two fabrics x seeds x
    disciplines x engines x fusion, jitter on."""
    out = []
    for name in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
        for seed in (0, 1):
            for intra, engine, fusion in (("SCF", "indexed", True), ("FIFO", "compiled", True),
                                          ("SCF", "compiled", False),
                                          ("FIFO", "reference", True)):
                kw = dict(policy=policy, chunks_per_collective=6, intra=intra,
                          fusion=fusion, jitter=0.05, seed=seed, engine=engine,
                          water_filling=seed == 1)
                out.append((jb.Scenario(J_TOPOS[name], j_reqs, **kw),
                            tb.Scenario(T_TOPOS[name], reqs, **kw)))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_batch_equals_scenarios_and_reference(policy):
    j_reqs, reqs = _requests(300 + POLICIES.index(policy), 8)
    pairs = _scenarios(policy, j_reqs, reqs)
    caches = tb.BatchCaches()
    got = simulate_batch([t for _, t in pairs], caches=caches)
    again = simulate_batch([t for _, t in pairs], caches=caches)
    want = jb.simulate_batch([j for j, _ in pairs])
    for (j_sc, sc), g, a, w in zip(pairs, got, again, want):
        assert g.diff_fields(simulate_scenario(sc)) == []
        assert g.diff_fields(w) == [] and a.diff_fields(w) == []
        assert simulate_scenario(sc).diff_fields(jb.simulate_scenario(j_sc)) == []


def test_scenario_fields_and_validation_equal_reference():
    assert ([f.name for f in dataclasses.fields(tb.Scenario)]
            == [f.name for f in dataclasses.fields(jb.Scenario)])
    with pytest.raises(ValueError, match="requests or traffic"):
        tb.Scenario(T_TOPOS["2D-SW_SW"], ())
    with pytest.raises(ValueError, match="replan=True requires faults"):
        tb.Scenario(T_TOPOS["2D-SW_SW"], (CollectiveRequest("AR", MB),), replan=True)


def _columns(ta):
    """A task-array build's columns as plain lists (the vectorized build
    holds some as numpy arrays)."""
    return {col: (getattr(ta, col) if col in ("n_tasks", "fingerprint")
                  else list(getattr(ta, col)))
            for col in ("n_tasks", "chunk", "stage", "dim", "wire", "fixed", "group",
                        "prio", "tenant", "last", "first_handles", "group_wire",
                        "fingerprint")}


@pytest.mark.parametrize("name", ["2D-SW_SW", "4D-Ring_SW_SW_SW"])
def test_vectorized_task_build_equals_scalar_and_reference(name):
    """``build_task_arrays_vectorized`` (shared stage vectors across a
    batch) equals the scalar build and the reference's, column by column,
    with an empty group in the stream."""
    topo, j_topo = T_TOPOS[name], J_TOPOS[name]
    groups = [schedule_collective(topo, c, s * MB, 8, "themis")
              for c, s in (("AR", 40), ("RS", 12), ("AG", 12))] + [[]]
    j_groups = [j_schedule(j_topo, c, s * MB, 8, "themis")
                for c, s in (("AR", 40), ("RS", 12), ("AG", 12))] + [[]]
    args = ([0, 1, 0, 0], ["a", "b", "a", "b"])
    lm, j_lm = LatencyModel.for_topology(topo), JLatencyModel.for_topology(j_topo)
    vec = tb.build_task_arrays_vectorized(lm, groups, *args)
    scalar = build_task_arrays(lm, groups, *args)
    want = j_build_task_arrays(j_lm, j_groups, *args)
    j_vec = jb.build_task_arrays_vectorized(j_lm, j_groups, *args)
    assert _columns(vec) == _columns(scalar) == _columns(want) == _columns(j_vec)


def test_search_helpers_equal_reference():
    assert ts.enumerate_bw_shares(3, 6) == js.enumerate_bw_shares(3, 6)
    base, j_base = make_tpu_pod_topology(2, 8, 8), j_tpu_pod(2, 8, 8)
    cand = ts.bw_split_topology(base, (0.5, 0.25, 0.25), perm=(2, 0, 1))
    j_cand = js.bw_split_topology(j_base, (0.5, 0.25, 0.25), perm=(2, 0, 1))
    assert cand.name == j_cand.name
    assert [(d.npus, d.topo.value, d.link_gbps) for d in cand.dims] == [
        (d.npus, d.topo.value, d.link_gbps) for d in j_cand.dims]
    reqs = [CollectiveRequest("AR", r.size_bytes)
            for r in dp_bucket_requests(make_resnet152(), 6)]
    j_reqs = [JRequest("AR", r.size_bytes)
              for r in j_dp_bucket_requests(j_make_resnet152(), 6)]
    for name in T_TOPOS:
        assert (ts.stream_lower_bound(T_TOPOS[name], reqs)
                == js.stream_lower_bound(J_TOPOS[name], j_reqs))


def _search_key(res):
    def cand(c):
        return (c.topology.name, c.shares, c.denom, c.perm, c.makespan, c.bw_utilization,
                c.lower_bound)
    return (cand(res.default), cand(res.best), [cand(c) for c in res.pareto],
            [cand(c) for c in res.evaluated], res.pruned, res.scenarios_run,
            res.improvement)


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no_prune"])
def test_search_topologies_equals_reference(prune):
    """The LIBRA-style search over BW splits and dim orders of a TPU pod
    fabric for a ResNet-152 gradient burst, scored over two jittered seeds."""
    kw = dict(granularity=5, rounds=1, top_k=3, seeds=(0, 1), jitter=0.08,
              chunks_per_collective=6, prune=prune)
    reqs = [CollectiveRequest("AR", r.size_bytes)
            for r in dp_bucket_requests(make_resnet152(), 4)]
    j_reqs = [JRequest("AR", r.size_bytes)
              for r in j_dp_bucket_requests(j_make_resnet152(), 4)]
    got = ts.search_topologies(make_tpu_pod_topology(2, 4, 4), reqs,
                               ts.SearchConfig(**kw))
    want = js.search_topologies(j_tpu_pod(2, 4, 4), j_reqs, js.SearchConfig(**kw))
    assert _search_key(got) == _search_key(want)


def test_search_topologies_on_table2_fabric_equals_reference():
    kw = dict(granularity=8, rounds=2, top_k=4, chunks_per_collective=8)
    reqs = [CollectiveRequest("AR", r.size_bytes)
            for r in dp_bucket_requests(make_resnet152(), 6)]
    j_reqs = [JRequest("AR", r.size_bytes)
              for r in j_dp_bucket_requests(j_make_resnet152(), 6)]
    got = ts.search_topologies(T_TOPOS["2D-SW_SW"], reqs, ts.SearchConfig(**kw))
    want = js.search_topologies(J_TOPOS["2D-SW_SW"], j_reqs, js.SearchConfig(**kw))
    assert _search_key(got) == _search_key(want)
