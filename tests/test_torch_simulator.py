"""The port's simulator (``repro_torch.core.simulator``: the ``indexed``,
``compiled`` and ``reference`` engines) against the reference's, on the CPU.

Each port engine is compared with the **same** engine of the reference,
field for field (``SimResult.diff_fields(...) == []``), over the Table-2
topologies x {RS, AG, AR} x the scheduler's policies x {FIFO, SCF}, with
fusion on and off, staggered issue times, priorities, seeded jitter,
tenants and streams, dependency gating, enforced orders and the invariant
sanitizer. No test asserts indexed == reference or "Themis never loses to
the baseline by more than 10%": the reference itself breaks both (ROADMAP
R2, R4). Also: admission control (``repro_torch.fleet``) on each engine,
Sec. 4.6's consistency helpers, Sec. 6.3's insights, and the engine lint
over the port's copies of ``core`` and ``tenancy``.
"""
import dataclasses
import random
import sys
from pathlib import Path

import pytest

from repro.core import consistency as j_consistency
from repro.core import engine_compiled as j_ec
from repro.core import insights as j_insights
from repro.core.requests import CollectiveRequest as JRequest
from repro.core.scheduler import POLICIES as J_POLICIES
from repro.core.scheduler import schedule_collective as j_schedule
from repro.core.simulator import simulate as j_simulate
from repro.core.simulator import simulate_requests as j_simulate_requests
from repro.core.simulator import simulate_scheduled as j_simulate_scheduled
from repro.obs import Tracer as JTracer
from repro.topology import make_table2_topologies as j_table2
from repro.topology import make_tpu_pod_topology as j_tpu_pod
from repro_torch.core import consistency, insights
from repro_torch.core import engine_compiled as ec
from repro_torch.core.invariants import InvariantViolation
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import POLICIES, schedule_collective
from repro_torch.core.simulator import (
    ENGINES,
    simulate,
    simulate_requests,
    simulate_scheduled,
)
from repro_torch.obs import Tracer
from repro_torch.topology import make_table2_topologies, make_tpu_pod_topology

ROOT = Path(__file__).resolve().parents[1]
MB = 1e6
J_TOPOS = j_table2()
T_TOPOS = make_table2_topologies()
SIZES = {"RS": 48 * MB, "AG": 36 * MB, "AR": 60 * MB}


def _same(got, want):
    assert got.diff_fields(want) == []


def _stats(res, by):
    return {k: dataclasses.asdict(v) for k, v in res.stream_stats(by).items()}


def _requests(rng, n, tenants=("default",)):
    """Random request streams as field tuples, for either package."""
    return [(rng.choice(("AR", "RS", "AG")), rng.uniform(1, 60) * MB,
             rng.uniform(0, 3e-3), rng.choice((0, 0, 1)), rng.choice(tenants),
             f"s{i % 3}") for i in range(n)]


def _both_requests(fields):
    mk = (lambda cls: [cls(c, s, issue_time=t, priority=p, tenant=ten, stream=st)
                       for c, s, t, p, ten, st in fields])
    return mk(JRequest), mk(CollectiveRequest)


def test_policies_and_engines_match_reference_lists():
    assert POLICIES == J_POLICIES
    assert ENGINES == ("indexed", "compiled", "reference")


@pytest.mark.parametrize("fusion", [True, False], ids=["fusion", "no_fusion"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_scheduled_collectives_equal_reference_engine(engine, policy, fusion):
    """Every Table-2 topology x {RS, AG, AR} x {FIFO, SCF}: the port's engine
    gives the reference engine's result, and the same chunk schedules."""
    for name, j_topo in J_TOPOS.items():
        for coll, size in SIZES.items():
            for intra in ("FIFO", "SCF"):
                kw = dict(policy=policy, chunks_per_collective=8, intra=intra,
                          fusion=fusion, engine=engine)
                want, j_chunks = j_simulate_scheduled(j_topo, coll, size, **kw)
                got, chunks = simulate_scheduled(T_TOPOS[name], coll, size, **kw)
                _same(got, want)
                assert [c.schedule for c in chunks] == [c.schedule for c in j_chunks]


@pytest.mark.parametrize("intra", ["FIFO", "SCF"])
@pytest.mark.parametrize("engine", ENGINES)
def test_request_streams_equal_reference_engine(engine, intra):
    """Staggered issue times, priorities, tenants and streams through
    ``simulate_requests`` under every policy."""
    rng = random.Random(11 + ENGINES.index(engine))
    for policy in POLICIES:
        for name in ("2D-SW_SW", "3D-SW_SW_SW_hetero", "4D-Ring_FC_Ring_SW"):
            j_reqs, reqs = _both_requests(_requests(rng, 10, ("a", "b")))
            kw = dict(policy=policy, chunks_per_collective=6, intra=intra,
                      engine=engine)
            want, j_groups = j_simulate_requests(J_TOPOS[name], j_reqs, **kw)
            got, groups = simulate_requests(T_TOPOS[name], reqs, **kw)
            _same(got, want)
            assert ([[c.schedule for c in g] for g in groups]
                    == [[c.schedule for c in g] for g in j_groups])
            for by in ("stream", "tenant"):
                assert _stats(got, by) == _stats(want, by)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", ENGINES)
def test_seeded_jitter_equals_reference_engine(engine, seed):
    """Jitter on the Table-2 fabrics and jitter plus DCN stragglers on a TPU
    pod fabric: the same seed draws the same noise in both packages."""
    for j_topo, topo in ((J_TOPOS["3D-SW_SW_SW_homo"], T_TOPOS["3D-SW_SW_SW_homo"]),
                         (j_tpu_pod(2, 4, 4, dcn_straggler_sigma=0.4),
                          make_tpu_pod_topology(2, 4, 4, dcn_straggler_sigma=0.4))):
        for fusion in (True, False):
            j_groups = [j_schedule(j_topo, c, s, 6, "themis", water_filling=True)
                        for c, s in SIZES.items()]
            groups = [schedule_collective(topo, c, s, 6, "themis", water_filling=True)
                      for c, s in SIZES.items()]
            kw = dict(issue_times=[0.0, 4e-4, 9e-4], priorities=[0, 1, 0],
                      fusion=fusion, jitter=0.15, seed=seed, engine=engine)
            _same(simulate(topo, groups, **kw), j_simulate(j_topo, j_groups, **kw))


def _dag(rng, n_nodes, j_topo, topo):
    """A random dependency graph: request groups and empty compute groups,
    each with up to three predecessors and a compute delay."""
    j_groups, groups, deps, delay, issue = [], [], [], [], []
    for i in range(n_nodes):
        n_deps = rng.randrange(0, min(i, 3) + 1) if i else 0
        deps.append(tuple(sorted(rng.sample(range(i), n_deps))))
        delay.append(rng.uniform(0, 2e-4))
        issue.append(rng.uniform(0, 1e-3) if not n_deps else 0.0)
        if rng.random() < 0.25:
            j_groups.append([])
            groups.append([])
        else:
            coll, size = rng.choice(("AR", "RS", "AG")), rng.uniform(1, 40) * MB
            j_groups.append(j_schedule(j_topo, coll, size, 6, "themis"))
            groups.append(schedule_collective(topo, coll, size, 6, "themis"))
    return j_groups, groups, dict(deps=deps, dep_delay_s=delay, issue_times=issue)


@pytest.mark.parametrize("engine", ENGINES)
def test_dependency_gating_equals_reference_engine(engine):
    """``deps`` / ``dep_delay_s``: resolved issue times and finishes."""
    rng = random.Random(500 + ENGINES.index(engine))
    for name in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
        for intra in ("FIFO", "SCF"):
            j_groups, groups, kw = _dag(rng, 14, J_TOPOS[name], T_TOPOS[name])
            want = j_simulate(J_TOPOS[name], j_groups, intra=intra, engine=engine, **kw)
            got = simulate(T_TOPOS[name], groups, intra=intra, engine=engine, **kw)
            _same(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_enforced_order_and_invariants_equal_reference_engine(engine):
    """An enforced per-dim order (Sec. 4.6.2) under jitter, and the armed
    invariant sanitizer; the compiled engine falls back to indexed for
    both, as the reference's does."""
    name = "3D-SW_SW_SW_homo"
    j_groups = [j_schedule(J_TOPOS[name], "AR", 100 * MB, 16, "themis")]
    groups = [schedule_collective(T_TOPOS[name], "AR", 100 * MB, 16, "themis")]
    order = consistency.fix_intra_dim_order(T_TOPOS[name], groups)
    assert order == j_consistency.fix_intra_dim_order(J_TOPOS[name], j_groups)
    for seed in (1, 2):
        kw = dict(enforced_order=order, jitter=0.5, seed=seed, engine=engine)
        got = simulate(T_TOPOS[name], groups, **kw)
        _same(got, j_simulate(J_TOPOS[name], j_groups, **kw))
        assert got.dim_op_order == order
    rng = random.Random(77)
    j_reqs, reqs = _both_requests(_requests(rng, 8))
    kw = dict(chunks_per_collective=6, engine=engine, check_invariants=True)
    got, _ = simulate_requests(T_TOPOS["2D-SW_SW"], reqs, **kw)
    want, _ = j_simulate_requests(J_TOPOS["2D-SW_SW"], j_reqs, **kw)
    _same(got, want)


def test_consistency_helpers_equal_reference():
    for name in ("3D-SW_SW_SW_homo", "4D-Ring_SW_SW_SW"):
        j_chunks = j_schedule(J_TOPOS[name], "AR", 100 * MB, 16, "themis")
        chunks = schedule_collective(T_TOPOS[name], "AR", 100 * MB, 16, "themis")
        for intra in ("FIFO", "SCF"):
            assert (consistency.verify_consistent_execution(
                        T_TOPOS[name], [chunks], intra=intra, jitter=0.5, trials=3)
                    == j_consistency.verify_consistent_execution(
                        J_TOPOS[name], [j_chunks], intra=intra, jitter=0.5, trials=3))


@pytest.mark.parametrize("name", list(T_TOPOS))
def test_insights_equal_reference(name):
    """Sec. 6.3's pair verdicts and utilization bounds, exactly."""
    topo, j_topo = T_TOPOS[name], J_TOPOS[name]
    assert ([(v.dim_k, v.dim_l, v.ratio, v.verdict) for v in insights.analyze(topo)]
            == [(v.dim_k, v.dim_l, v.ratio, v.verdict) for v in j_insights.analyze(j_topo)])
    assert (insights.baseline_utilization_bound(topo)
            == j_insights.baseline_utilization_bound(j_topo))
    assert (insights.themis_utilization_bound(topo)
            == j_insights.themis_utilization_bound(j_topo))


def test_result_summaries_equal_reference():
    """The derived metrics of one run: utilization, activity, spans."""
    rng = random.Random(5)
    name = "4D-Ring_FC_Ring_SW"
    j_reqs, reqs = _both_requests(_requests(rng, 12, ("a", "b")))
    got, _ = simulate_requests(T_TOPOS[name], reqs, chunks_per_collective=8)
    want, _ = j_simulate_requests(J_TOPOS[name], j_reqs, chunks_per_collective=8)
    assert got.avg_bw_utilization(T_TOPOS[name]) == want.avg_bw_utilization(J_TOPOS[name])
    assert got.finish_time() == want.finish_time()
    for d in range(T_TOPOS[name].num_dims):
        assert got.activity_rate(d) == want.activity_rate(d)
        assert got.groups_interleave_on(d) == want.groups_interleave_on(d)
    for g in range(len(reqs)):
        assert got.group_span(g) == want.group_span(g)
    for tag in ("s0", "s1", "s2"):
        assert got.stream_finish(tag) == want.stream_finish(tag)


def test_compiled_fallback_signal_equals_reference():
    """The compiled engine's one fallback signal (``LAST_FALLBACK``,
    ``FALLBACK_COUNTS``) moves as the reference's does, and a fallen-back
    run still equals the reference's."""
    name = "2D-SW_SW"
    j_groups = [j_schedule(J_TOPOS[name], "AR", 10 * MB, 6, "themis")]
    groups = [schedule_collective(T_TOPOS[name], "AR", 10 * MB, 6, "themis")]
    order = consistency.fix_intra_dim_order(T_TOPOS[name], groups)
    signals = []
    for mod, sim, topo, gr, trc in ((ec, simulate, T_TOPOS[name], groups, Tracer),
                                    (j_ec, j_simulate, J_TOPOS[name], j_groups, JTracer)):
        mod.reset_fallbacks()
        seen, results = [], []
        for kw in ({}, {"check_invariants": True}, {"tracer": trc()},
                   {"enforced_order": order}, {"check_invariants": True}):
            results.append(sim(topo, gr, engine="compiled", **kw))
            seen.append(mod.LAST_FALLBACK)
        signals.append((seen, dict(mod.FALLBACK_COUNTS), results))
        mod.reset_fallbacks()
    (seen, counts, got), (j_seen, j_counts, want) = signals
    assert seen == j_seen == [None, "check_invariants", "tracer", "enforced_order",
                              "check_invariants"]
    assert counts == j_counts == {"check_invariants": 2, "tracer": 1,
                                  "enforced_order": 1}
    for a, b in zip(got, want):
        _same(a, b)
    assert (ec.fast_path_blocker(tracer=object(), check_invariants=True)
            == j_ec.fast_path_blocker(tracer=object(), check_invariants=True) == "tracer")
    assert ec.FAST_PATH_BLOCKERS == j_ec.FAST_PATH_BLOCKERS


def test_sanitizer_raises_on_corrupted_state():
    """The copied invariants fire where the reference's do: an idle dim
    with queued work, a lost chunk, a wire-byte mismatch."""
    from repro_torch.core.invariants import check_final, check_work_conserving

    with pytest.raises(InvariantViolation, match="work conservation"):
        check_work_conserving(0, 1.0, queue_len=2, busy_until=0.5,
                              inflight=None, engine="unit")
    base = dict(engine="unit", num_dims=1,
                dim_busy=[1.0], dim_services=[[(0.0, 1.0, (0,))]],
                group_finish=[1.0], resolved_issue=[0.0], makespan=1.0)
    with pytest.raises(InvariantViolation, match="lost chunks"):
        check_final(tasks=[((0, 0), 0, 8.0, "t"), ((1, 0), 0, 8.0, "t")],
                    dim_wire=[16.0], dim_order=[[(0, 0)]], **base)
    with pytest.raises(InvariantViolation, match="conservation violated"):
        check_final(tasks=[((0, 0), 0, 8.0, "t")],
                    dim_wire=[9.0], dim_order=[[(0, 0)]], **base)


def test_argument_errors_match_reference():
    topo, j_topo = T_TOPOS["2D-SW_SW"], J_TOPOS["2D-SW_SW"]
    chunks = schedule_collective(topo, "AR", 10 * MB, 4, "themis")
    j_chunks = j_schedule(j_topo, "AR", 10 * MB, 4, "themis")
    for call, j_call, exc in (
            (lambda: simulate(topo, [], engine="turbo"),
             lambda: j_simulate(j_topo, [], engine="turbo"), ValueError),
            (lambda: simulate(topo, chunks), lambda: j_simulate(j_topo, j_chunks),
             TypeError),
            (lambda: simulate(topo, [chunks], issue_times=[-1.0]),
             lambda: j_simulate(j_topo, [j_chunks], issue_times=[-1.0]), ValueError),
            (lambda: simulate(topo, [chunks], dep_delay_s=[0.0]),
             lambda: j_simulate(j_topo, [j_chunks], dep_delay_s=[0.0]), ValueError),
            (lambda: simulate_scheduled(topo, "AR", MB, replan=True),
             lambda: j_simulate_scheduled(j_topo, "AR", MB, replan=True), ValueError)):
        with pytest.raises(exc) as got:
            call()
        with pytest.raises(exc) as want:
            j_call()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("engine", ENGINES)
def test_admission_equals_reference_engine(engine):
    """``admission`` (``repro_torch.fleet.AdmissionController``, one per run
    and package) on random request chains under each policy: the shed
    groups and every other field equal the same reference engine's, and so
    do the controllers' books; the compiled engine falls back to indexed,
    as the reference's does."""
    from types import SimpleNamespace

    from repro.fleet import AdmissionController as JAdmission
    from repro.fleet import unit_of_group as j_unit_of_group
    from repro_torch.fleet import ADMISSION_POLICIES, AdmissionController, unit_of_group

    rng = random.Random(900 + ENGINES.index(engine))
    name = "2D-SW_SW"
    for policy in ADMISSION_POLICIES:
        # 10 request chains of two collectives, the second gated on the first
        j_groups, groups, deps, issue = [], [], [], []
        for i in range(20):
            coll, size = rng.choice(("AR", "RS", "AG")), rng.uniform(1, 40) * MB
            j_groups.append(j_schedule(J_TOPOS[name], coll, size, 6, "themis"))
            groups.append(schedule_collective(T_TOPOS[name], coll, size, 6, "themis"))
            deps.append((i - 1,) if i % 2 else ())
            issue.append(0.0 if i % 2 else rng.uniform(0, 1e-3))
        kw = dict(deps=deps, dep_delay_s=[1e-5] * 20, issue_times=issue)
        # the units are the chains; unit_of_group reads only these fields
        graph = SimpleNamespace(deps_idx=deps, nodes=[
            SimpleNamespace(request="r", priority=rng.choice((0, 1, 2))) for _ in groups])
        unit_of, unit_priority = unit_of_group(graph)
        assert (unit_of, unit_priority) == j_unit_of_group(graph)
        ctl_kw = dict(policy=policy, capacity=1, unit_priority=unit_priority)
        if policy == "deadline-aware":
            ctl_kw.update(deadline_s=2e-4, est_service_s=2e-4)
        j_ctl, ctl = JAdmission(unit_of, **ctl_kw), AdmissionController(unit_of, **ctl_kw)
        want = j_simulate(J_TOPOS[name], j_groups, engine=engine, admission=j_ctl,
                          check_invariants=True, **kw)
        got = simulate(T_TOPOS[name], groups, engine=engine, admission=ctl,
                       check_invariants=True, **kw)
        _same(got, want)
        assert got.shed_groups == want.shed_groups and got.shed_groups, policy
        assert (ctl.n_admitted, ctl.n_shed, ctl.shed_units) == (
            j_ctl.n_admitted, j_ctl.n_shed, j_ctl.shed_units)
        if engine == "compiled":
            assert ec.LAST_FALLBACK == "admission"


def test_engine_lint_passes_on_the_port_core():
    """``tools/lint_engine.py`` over ``src/repro_torch/core`` and
    ``src/repro_torch/tenancy`` (the reference's two default trees): no float
    equality, no wall-clock reads, no unguarded tracer, fault or admission
    calls, no scalar mutation in vector zones."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import lint_engine
    finally:
        sys.path.remove(str(ROOT / "tools"))
    assert lint_engine.main([str(ROOT / "src" / "repro_torch" / "core"),
                             str(ROOT / "src" / "repro_torch" / "tenancy")]) == 0
