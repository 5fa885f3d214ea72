"""The port's flight recorder and bandwidth timelines (``repro_torch.obs``:
``Tracer``, ``parse_chrome_trace``, ``BwTimeline``) against the reference's,
on the CPU.

The same multi-tenant request streams and dependency graphs run traced
through each engine of both packages: the traced result equals the
untraced one and the reference's, and the recorded events (services,
enqueues, releases, dependency edges), the Chrome trace export and the
``BwTimeline`` views (utilization, windowed shares, queue depth) are equal
to the reference's.
"""
import random

import pytest

from repro.core.requests import CollectiveRequest as JRequest
from repro.core.scheduler import schedule_collective as j_schedule
from repro.core.simulator import simulate as j_simulate
from repro.core.simulator import simulate_requests as j_simulate_requests
from repro.obs import BwTimeline as JBwTimeline
from repro.obs import Tracer as JTracer
from repro.obs import parse_chrome_trace as j_parse_chrome_trace
from repro.topology import make_table2_topologies as j_table2
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import schedule_collective
from repro_torch.core.simulator import simulate, simulate_requests
from repro_torch.obs import BwTimeline, Tracer, parse_chrome_trace
from repro_torch.topology import make_table2_topologies

MB = 1e6
J_TOPOS = j_table2()
T_TOPOS = make_table2_topologies()
ENGINES = ("indexed", "reference", "compiled")
EVENTS = ("services", "enqueues", "releases", "dep_edges", "grants", "preempts",
          "makespan", "dim_bw", "dim_wire", "dim_busy", "dim_activity", "group_issue",
          "group_finish", "group_streams", "group_tenants", "topology_name", "n_groups",
          "num_dims")


def _requests(seed, n):
    rng = random.Random(seed)
    fields = [(rng.choice(("AR", "RS", "AG")), rng.uniform(1, 60) * MB,
               rng.uniform(0, 3e-3), rng.choice((0, 0, 1)), rng.choice(("a", "b")),
               f"s{i % 3}") for i in range(n)]
    mk = (lambda cls: [cls(c, s, issue_time=t, priority=p, tenant=ten, stream=st)
                       for c, s, t, p, ten, st in fields])
    return mk(JRequest), mk(CollectiveRequest)


def _assert_events_equal(trc, j_trc):
    for name in EVENTS:
        assert getattr(trc, name) == getattr(j_trc, name), name
    # a compiled run falls back to indexed under a tracer, in both packages
    assert trc.engine == j_trc.engine and trc.finished and j_trc.finished
    assert trc.event_counts() == j_trc.event_counts()
    assert trc.service_wire() == j_trc.service_wire()
    assert trc.service_busy() == j_trc.service_busy()
    for d in range(trc.num_dims):
        assert trc.ops_served(d) == j_trc.ops_served(d)


def _assert_timelines_equal(trc, j_trc, window):
    tl, j_tl = BwTimeline.from_tracer(trc), JBwTimeline.from_tracer(j_trc)
    assert tl.avg_bw_utilization() == j_tl.avg_bw_utilization()
    assert tl.windows(window) == j_tl.windows(window)
    assert tl.per_dim_utilization(window) == j_tl.per_dim_utilization(window)
    assert tl.per_dim_shares(window) == j_tl.per_dim_shares(window)
    assert tl.queue_depth(window) == j_tl.queue_depth(window)
    for d in range(tl.num_dims):
        assert tl.dim_utilization(d) == j_tl.dim_utilization(d)
        assert tl.activity_rate(d) == j_tl.activity_rate(d)


@pytest.mark.parametrize("policy", ["baseline", "themis"])
@pytest.mark.parametrize("engine", ENGINES)
def test_traced_streams_equal_reference(engine, policy):
    """Two tenants' request streams on two fabrics, FIFO and SCF: the traced
    run equals the untraced run and the reference's; the events and the
    timelines equal the reference's."""
    j_reqs, reqs = _requests(700 + ENGINES.index(engine), 12)
    for name in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
        for intra in ("SCF", "FIFO"):
            kw = dict(policy=policy, chunks_per_collective=8, intra=intra, engine=engine)
            plain, _ = simulate_requests(T_TOPOS[name], reqs, **kw)
            trc, j_trc = Tracer(), JTracer()
            traced, _ = simulate_requests(T_TOPOS[name], reqs, tracer=trc, **kw)
            want, _ = j_simulate_requests(J_TOPOS[name], j_reqs, tracer=j_trc, **kw)
            assert traced.diff_fields(plain) == [] and traced.diff_fields(want) == []
            _assert_events_equal(trc, j_trc)
            _assert_timelines_equal(trc, j_trc, traced.makespan / 7)


@pytest.mark.parametrize("engine", ["indexed", "reference"])
def test_traced_dependency_graph_equals_reference(engine, tmp_path):
    """A dependency graph with compute nodes: one release per group, one
    edge per dependency, and the Chrome export parses to the reference's."""
    rng = random.Random(900)
    name = "3D-SW_SW_SW_hetero"
    j_groups, groups, deps, delay = [], [], [], []
    for i in range(12):
        deps.append(tuple(sorted(rng.sample(range(i), rng.randrange(0, min(i, 2) + 1)))))
        delay.append(rng.uniform(0, 2e-4))
        if rng.random() < 0.25:
            j_groups.append([])
            groups.append([])
        else:
            coll, size = rng.choice(("AR", "RS", "AG")), rng.uniform(1, 40) * MB
            j_groups.append(j_schedule(J_TOPOS[name], coll, size, 6, "themis"))
            groups.append(schedule_collective(T_TOPOS[name], coll, size, 6, "themis"))
    kw = dict(deps=deps, dep_delay_s=delay, tenants=["a", "b"] * 6, engine=engine)
    trc, j_trc = Tracer(), JTracer()
    got = simulate(T_TOPOS[name], groups, tracer=trc, **kw)
    want = j_simulate(J_TOPOS[name], j_groups, tracer=j_trc, **kw)
    assert got.diff_fields(want) == []
    assert sorted(g for g, _ in trc.releases) == list(range(12))
    assert len(trc.dep_edges) == sum(len(d) for d in deps)
    _assert_events_equal(trc, j_trc)
    _assert_timelines_equal(trc, j_trc, got.makespan / 5)
    assert trc.to_chrome_trace() == j_trc.to_chrome_trace()
    trc.save(tmp_path / "run.trace.json")
    parsed = parse_chrome_trace(tmp_path / "run.trace.json")
    assert parsed == parse_chrome_trace(trc.to_chrome_trace())
    assert parsed == j_parse_chrome_trace(j_trc.to_chrome_trace())


def test_timeline_from_result_equals_reference():
    j_reqs, reqs = _requests(5, 10)
    name = "4D-Ring_FC_Ring_SW"
    got, _ = simulate_requests(T_TOPOS[name], reqs, chunks_per_collective=8)
    want, _ = j_simulate_requests(J_TOPOS[name], j_reqs, chunks_per_collective=8)
    tl = BwTimeline.from_result(got, T_TOPOS[name])
    j_tl = JBwTimeline.from_result(want, J_TOPOS[name])
    assert tl.avg_bw_utilization() == j_tl.avg_bw_utilization()
    assert tl.avg_bw_utilization() == got.avg_bw_utilization(T_TOPOS[name])
    for d in range(tl.num_dims):
        assert tl.dim_utilization(d) == j_tl.dim_utilization(d)
        assert tl.activity_rate(d) == j_tl.activity_rate(d)
    # windowed series need the tracer's per-service events, in both packages
    for timeline in (tl, j_tl):
        with pytest.raises(ValueError, match="per-service events"):
            timeline.per_dim_utilization(got.makespan / 6)


def test_tracer_refuses_reuse_and_unfinished_export():
    trc = Tracer()
    reqs = [CollectiveRequest("AR", 4 * MB)]
    simulate_requests(T_TOPOS["2D-SW_SW"], reqs, chunks_per_collective=4, tracer=trc)
    with pytest.raises(RuntimeError, match="one Tracer records one"):
        simulate_requests(T_TOPOS["2D-SW_SW"], reqs, chunks_per_collective=4, tracer=trc)
    fresh = Tracer()
    with pytest.raises(RuntimeError, match="finished run"):
        fresh.to_chrome_trace()
    with pytest.raises(ValueError, match="finished run"):
        BwTimeline.from_tracer(fresh)
