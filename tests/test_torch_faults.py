"""The port's fault-injection fabric (``repro_torch.faults``) against the
reference's, on the CPU.

Mirrors ``tests/test_faults.py`` (timeline validation; degradation, outage,
flap and straggler semantics; retry and failure accounting; Themis
re-planning under degraded bandwidth; the tracer's fault events) and the
faults x dependency cases of ``tests/test_engine_equiv.py``. Every scenario
is built twice from the same numbers, once per package, and each port
engine is held to the **same** reference engine field for field. No test
asserts indexed == reference: the reference's own engines differ by an ulp
under faults (ROADMAP §3, R2), and ``test_chaos_differential_engines_agree``
fails there for that reason. The last test holds ``chip_smoke.py``'s
``phase_faults`` scenarios to ``benchmarks/faults_study.py``'s.
"""
import math
import random

import pytest
from _sim_twins import (MB, PORT, REF, assert_same, chip_smoke, plain, raises_alike, same_run,
                        study)

TOPO = "2D-SW_SW"


def _reqs(ns, n=4, size=8.0 * MB, gap=2e-4):
    return [ns.CollectiveRequest("AR", size, issue_time=i * gap) for i in range(n)]


def _run(ns, eng, reqs=None, faults=None, **kw):
    res, _ = ns.simulate_requests(ns.TOPOS[TOPO], reqs or _reqs(ns), chunks_per_collective=8,
                                  engine=eng, check_invariants=True,
                                  faults=faults(ns) if faults else None, **kw)
    return res


def _run_both(eng, faults=None, reqs=None, **kw):
    """The port's result of ``_run``, held to the reference's."""
    return same_run(lambda ns: _run(ns, eng, reqs(ns) if reqs else None, faults, **kw))


ENGINES2 = ("indexed", "reference")

# ---------------------------------------------------------------------------
# FaultSchedule validation
# ---------------------------------------------------------------------------
BAD_EVENTS = {
    "negative start": lambda ns: ns.BwDegradation(dim=0, start=-1.0, end=1.0, factor=0.5),
    "empty window": lambda ns: ns.BwDegradation(dim=0, start=1.0, end=1.0, factor=0.5),
    "nan start": lambda ns: ns.DimOutage(dim=0, start=float("nan")),
    "zero factor": lambda ns: ns.BwDegradation(dim=0, start=0.0, end=1.0, factor=0.0),
    "factor above 1": lambda ns: ns.BwDegradation(dim=0, start=0.0, end=1.0, factor=1.5),
    "zero sigma": lambda ns: ns.StragglerBurst(dim=0, start=0.0, end=1.0, sigma=0.0),
    "flap period": lambda ns: ns.LinkFlap(dim=0, start=0.0, down_s=2.0, period_s=1.0,
                                          count=2),
    "flap count": lambda ns: ns.LinkFlap(dim=0, start=0.0, down_s=1.0, period_s=2.0,
                                         count=0),
    "timeout": lambda ns: ns.RetryPolicy(timeout_s=0.0),
    "max attempts": lambda ns: ns.RetryPolicy(max_attempts=0),
}


@pytest.mark.parametrize("case", list(BAD_EVENTS))
def test_event_window_validation(case):
    raises_alike(BAD_EVENTS[case])


def test_compile_rejects_out_of_range_dims_and_overlaps():
    raises_alike(lambda ns: ns.FaultSchedule(events=(
        ns.BwDegradation(dim=5, start=0.0, end=1.0, factor=0.5),)).compile(2))
    raises_alike(lambda ns: ns.FaultSchedule(events=(
        ns.BwDegradation(dim=0, start=0.0, end=1.0, factor=0.5),
        ns.DimOutage(dim=0, start=0.5, end=0.7))).compile(2))
    raises_alike(lambda ns: ns.FaultSchedule(events=(
        ns.StragglerBurst(dim=0, start=0.0, end=1.0, sigma=0.1),
        ns.StragglerBurst(dim=0, start=0.5, end=2.0, sigma=0.2))).compile(2))

    def compiled(ns):
        return ns.FaultSchedule(events=(
            ns.BwDegradation(dim=0, start=0.0, end=1.0, factor=0.5),
            ns.BwDegradation(dim=0, start=1.0, end=2.0, factor=0.25),
            ns.StragglerBurst(dim=0, start=0.5, end=1.5, sigma=0.1),
            ns.DimOutage(dim=1, start=0.5, end=0.7),
            ns.LinkFlap(dim=1, start=1.0, down_s=0.1, period_s=0.3, count=3),
        )).compile(2)

    got = compiled(PORT)
    assert plain(got) == plain(compiled(REF))
    assert got.num_dims == 2
    assert [b.t for b in got.boundaries] == sorted(b.t for b in got.boundaries)


def test_retry_policy_backoff_grows():
    for kw in (dict(timeout_s=1.0, backoff_s=0.5, multiplier=2.0, jitter=0.0), {},
               dict(backoff_s=3e-5, multiplier=1.5)):
        got, want = PORT.RetryPolicy(**kw), REF.RetryPolicy(**kw)
        assert plain(got) == plain(want)
        assert [got.delay(a) for a in range(1, 8)] == [want.delay(a) for a in range(1, 8)]
    rp = PORT.RetryPolicy(timeout_s=1.0, backoff_s=0.5, multiplier=2.0, jitter=0.0)
    assert rp.delay(1) == pytest.approx(0.5)
    assert rp.delay(3) == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# simulate() input validation
# ---------------------------------------------------------------------------
def test_simulate_rejects_bad_issue_times_and_sizes():
    def chunks(ns):
        return ns.schedule_collective(ns.TOPOS[TOPO], "AR", 4 * MB, 4, "themis")

    raises_alike(lambda ns: ns.simulate(ns.TOPOS[TOPO], [chunks(ns)], issue_times=[-1e-6]))
    raises_alike(lambda ns: ns.simulate(ns.TOPOS[TOPO], [chunks(ns)],
                                        issue_times=[float("nan")]))
    raises_alike(lambda ns: ns.simulate(ns.TOPOS[TOPO],
                                        [[ns.Chunk(index=0, size_bytes=float("nan"))]]))


def test_simulate_rejects_inconsistent_fault_arguments():
    def faults(ns):
        return ns.FaultSchedule(events=(ns.BwDegradation(dim=0, start=1e-4, end=1.0,
                                                         factor=0.5),))

    assert "replanner requires faults" in raises_alike(
        lambda ns: ns.simulate(ns.TOPOS[TOPO], [], replanner=lambda now, f, p: {}))
    assert "mutually exclusive" in raises_alike(
        lambda ns: ns.simulate(ns.TOPOS[TOPO], [], faults=faults(ns),
                               enforced_order=[[] for _ in ns.TOPOS[TOPO].dims]))
    assert "compiled for" in raises_alike(
        lambda ns: ns.simulate(ns.TOPOS[TOPO], [], faults=faults(ns).compile(3)))
    assert "replan=True requires faults" in raises_alike(
        lambda ns: ns.simulate_requests(ns.TOPOS[TOPO], _reqs(ns, 1), replan=True))
    assert "replan=True requires faults" in raises_alike(
        lambda ns: ns.simulate_scheduled(ns.TOPOS[TOPO], "AR", MB, replan=True))


# ---------------------------------------------------------------------------
# Degradation / outage / flap / straggler semantics, engine by engine
# ---------------------------------------------------------------------------
def _degrade(end):
    return lambda ns: ns.FaultSchedule(events=(
        ns.BwDegradation(dim=1, start=1e-4, end=end, factor=0.25),))


@pytest.mark.parametrize("eng", ENGINES2)
def test_degradation_slows_run(eng):
    clean = _run_both(eng)
    res = _run_both(eng, _degrade(1.0))
    assert res.makespan > clean.makespan
    assert not res.failed_groups
    assert res.dim_wire_bytes == pytest.approx(clean.dim_wire_bytes)


@pytest.mark.parametrize("eng", ENGINES2)
def test_degradation_that_ends_mid_run_rerates_back_up(eng):
    forever = _run_both(eng, _degrade(1.0))
    brief = _run_both(eng, _degrade(4e-4))
    assert brief.makespan < forever.makespan


def _outage(end, attempts, timeout=5e-5):
    return lambda ns: ns.FaultSchedule(
        events=(ns.DimOutage(dim=1, start=1e-4, end=end),),
        retry=ns.RetryPolicy(timeout_s=timeout, backoff_s=2e-5, max_attempts=attempts))


@pytest.mark.parametrize("eng", ENGINES2)
def test_outage_retries_then_recovers(eng):
    res = _run_both(eng, _outage(6e-4, 10))
    assert sum(res.group_retries) > 0
    assert not res.failed_groups
    assert len(res.group_finish) == 4


@pytest.mark.parametrize("eng", ENGINES2)
def test_permanent_outage_exhausts_retries_and_fails_groups(eng):
    res = _run_both(eng, _outage(math.inf, 3))
    assert res.failed_groups
    for g, t in res.failed_groups:
        assert 0 <= g < 4 and t >= 1e-4
        assert res.group_retries[g] >= 3


@pytest.mark.parametrize("eng", ENGINES2)
def test_straggler_burst_is_deterministic(eng):
    def burst(ns):
        return ns.FaultSchedule(events=(ns.StragglerBurst(dim=0, start=0.0, end=1.0,
                                                          sigma=0.5),))

    a = _run_both(eng, burst)
    assert_same(a, _run(PORT, eng, faults=burst))   # same seed, same draws
    assert a.makespan != _run(PORT, eng).makespan


@pytest.mark.parametrize("eng", ENGINES2)
def test_link_flap_outage_windows_fire_in_sequence(eng):
    def flap(ns):
        return ns.FaultSchedule(
            events=(ns.LinkFlap(dim=1, start=1e-4, down_s=5e-5, period_s=3e-4, count=3),),
            retry=ns.RetryPolicy(timeout_s=3e-5, backoff_s=2e-5, max_attempts=20))

    res = _run_both(eng, flap, reqs=lambda ns: _reqs(ns, 6))
    assert not res.failed_groups


# ---------------------------------------------------------------------------
# Re-planning under degraded bandwidth
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factors", [(1.0, 0.25), (0.0, 1.0), (0.5, 0.5), (1.0, 1.0)])
def test_degraded_topology_scales_link_bw(factors):
    got = PORT.degraded_topology(PORT.TOPOS[TOPO], factors)
    assert plain(got) == plain(REF.degraded_topology(REF.TOPOS[TOPO], factors))
    base = PORT.TOPOS[TOPO]
    assert got.num_dims == base.num_dims
    for d, f in enumerate(factors):
        assert got.dims[d].link_gbps == pytest.approx(max(f, 1e-6) * base.dims[d].link_gbps)
    raises_alike(lambda ns: ns.degraded_topology(ns.TOPOS[TOPO], [1.0]))
    raises_alike(lambda ns: ns.degraded_topology(ns.TOPOS[TOPO], [1.0, 1.5]))


def _replan_reqs(ns):
    return [ns.CollectiveRequest("AR", float(1 << 26), issue_time=i * 1e-4) for i in range(6)]


@pytest.mark.parametrize("eng", ENGINES2)
def test_replanning_beats_no_replanning_under_degradation(eng):
    def run(replan):
        return same_run(lambda ns: ns.simulate_requests(
            ns.TOPOS[TOPO], _replan_reqs(ns), chunks_per_collective=16, engine=eng,
            check_invariants=True, replan=replan,
            faults=ns.FaultSchedule(events=(
                ns.BwDegradation(dim=1, start=1.5e-4, end=1.0, factor=0.1),))))[0]

    assert run(False).makespan / run(True).makespan > 1.15


@pytest.mark.parametrize("policy", ["themis", "baseline"])
def test_make_replanner_reschedules_pending_groups(policy):
    def replanned(ns):
        topo = ns.TOPOS[TOPO]
        chunks = ns.schedule_collective(topo, "AR", float(1 << 24), 8, "themis")
        more = ns.schedule_collective(topo, "RS", float(1 << 22), 4, "themis")
        rp = ns.make_replanner(topo, policy)
        return chunks, rp(1e-4, [1.0, 0.1], [(0, 2e-4, chunks), (3, 3e-4, more),
                                             (4, 4e-4, [])])

    chunks, out = replanned(PORT)
    assert plain(out) == plain(replanned(REF)[1])
    assert set(out) == {0, 3}
    assert len(out[0]) == len(chunks)
    for oc, nc in zip(chunks, out[0]):
        assert nc.size_bytes == oc.size_bytes
        assert len(nc.schedule) == len(oc.schedule)


@pytest.mark.parametrize("policy", ["themis", "baseline"])
@pytest.mark.parametrize("factors", [(1.0, 0.1), (0.0, 1.0), (0.3, 0.7)])
def test_replan_degraded_equals_reference(policy, factors):
    """``ThemisScheduler.replan_degraded`` on a Table-2 fabric: the same
    replanned dim orders as the reference's, for every pending group."""
    def replanned(ns):
        topo = ns.TOPOS["3D-SW_SW_SW_hetero"] if len(factors) == 3 else ns.TOPOS[TOPO]
        sched = ns.ThemisScheduler(ns.LatencyModel.for_topology(topo), policy)
        pending = [(g, g * 1e-4, ns.schedule_collective(topo, coll, size * MB, 6, "themis"))
                   for g, (coll, size) in enumerate((("AR", 40), ("RS", 12), ("AG", 7)))]
        return sched.replan_degraded(pending, factors, bw_floor=1e-5)

    assert plain(replanned(PORT)) == plain(replanned(REF))


def test_replan_against_empty_pending_is_noop():
    assert PORT.make_replanner(PORT.TOPOS[TOPO], "themis")(0.0, [0.5, 1.0], []) == {}


# ---------------------------------------------------------------------------
# The argument paths the port used to refuse
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eng", ["indexed", "compiled", "reference"])
def test_simulate_with_faults_and_replanner_equals_reference(eng):
    """``simulate(faults=..., replanner=...)`` on hand-scheduled groups
    (the compiled engine falls back to indexed under faults, as the
    reference's does)."""
    def run(ns):
        topo = ns.TOPOS["3D-SW_SW_SW_hetero"]
        groups = [ns.schedule_collective(topo, c, s * MB, 6, "themis")
                  for c, s in (("AR", 30), ("RS", 20), ("AG", 25), ("AR", 8))]
        faults = ns.FaultSchedule(
            events=(ns.BwDegradation(dim=2, start=5e-5, end=1.0, factor=0.2),
                    ns.StragglerBurst(dim=0, start=0.0, end=2e-4, sigma=0.3)),
            retry=ns.RetryPolicy(timeout_s=5e-5, backoff_s=2e-5))
        return ns.simulate(topo, groups, issue_times=[0.0, 2e-5, 4e-5, 6e-5],
                           jitter=0.05, seed=3, engine=eng, faults=faults,
                           replanner=ns.make_replanner(topo, "themis"))

    same_run(run)


@pytest.mark.parametrize("eng", ["indexed", "compiled", "reference"])
@pytest.mark.parametrize("replan", [False, True])
def test_simulate_scheduled_with_faults_equals_reference(eng, replan):
    same_run(lambda ns: ns.simulate_scheduled(
        ns.TOPOS[TOPO], "AR", 64 * MB, chunks_per_collective=16, engine=eng, replan=replan,
        faults=ns.FaultSchedule(events=(ns.BwDegradation(dim=1, start=2e-5, end=1.0,
                                                         factor=0.1),))))


def test_scenario_with_faults_and_replan_equals_reference():
    """A ``Scenario`` with ``faults`` and ``replan`` through
    ``simulate_scenario`` and ``simulate_batch``."""
    def scenarios(ns):
        out = []
        for replan in (False, True):
            for seed, jitter in ((0, 0.0), (4, 0.1)):
                out.append(ns.Scenario(
                    ns.TOPOS[TOPO], tuple(_replan_reqs(ns)), chunks_per_collective=8,
                    jitter=jitter, seed=seed, replan=replan,
                    faults=ns.FaultSchedule(events=(
                        ns.BwDegradation(dim=1, start=1.5e-4, end=1.0, factor=0.2),
                        ns.DimOutage(dim=0, start=3e-4, end=5e-4)))))
        return out

    got, want = scenarios(PORT), scenarios(REF)
    batch = PORT.simulate_batch(got)
    for g, w, b in zip(got, want, batch):
        assert_same(PORT.simulate_scenario(g), REF.simulate_scenario(w))
        assert_same(b, REF.simulate_scenario(w))


# ---------------------------------------------------------------------------
# Tracer round trip
# ---------------------------------------------------------------------------
def _traced(ns, faults, n, replan=False):
    trc = ns.Tracer()
    res, _ = ns.simulate_requests(ns.TOPOS[TOPO], _reqs(ns, n), chunks_per_collective=8,
                                  engine="indexed", check_invariants=replan,
                                  faults=faults(ns), replan=replan, tracer=trc)
    return res, trc


def test_tracer_records_fault_events_and_chrome_roundtrip(tmp_path):
    def faults(ns):
        return ns.FaultSchedule(
            events=(ns.BwDegradation(dim=1, start=1e-4, end=5e-4, factor=0.25),
                    ns.DimOutage(dim=0, start=2e-4, end=5e-4)),
            retry=ns.RetryPolicy(timeout_s=5e-5, backoff_s=2e-5, max_attempts=10))

    res, trc = _traced(PORT, faults, 6, replan=True)
    j_res, j_trc = _traced(REF, faults, 6, replan=True)
    assert_same(res, j_res)
    counts = trc.event_counts()
    assert counts == j_trc.event_counts()
    assert counts["faults"] >= 4
    assert counts["retries"] == sum(res.group_retries)
    assert counts["replans"] >= 1
    trc.save(tmp_path / "port.trace.json")
    j_trc.save(tmp_path / "ref.trace.json")
    parsed = PORT.parse_chrome_trace(tmp_path / "port.trace.json")
    assert parsed == REF.parse_chrome_trace(tmp_path / "ref.trace.json")
    for key in ("faults", "retries", "replans", "aborts", "rerates", "group_fails"):
        assert parsed[key] == counts[key], key


def test_tracer_counts_group_failures():
    res, trc = _traced(PORT, _outage(math.inf, 2), 4)
    j_res, j_trc = _traced(REF, _outage(math.inf, 2), 4)
    assert_same(res, j_res)
    assert trc.event_counts() == j_trc.event_counts()
    assert trc.event_counts()["group_fails"] == len(res.failed_groups) > 0


# ---------------------------------------------------------------------------
# Fault-free identity + randomized chaos differential
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eng", ENGINES2)
def test_faults_none_is_the_default_path(eng):
    base = _run_both(eng)
    assert_same(_run(PORT, eng, faults=lambda ns: None), base)
    assert base.group_retries == [] and base.failed_groups == []


def _chaos(ns, seed):
    """``test_faults.py``'s chaos draw for ``seed``, in package ``ns``."""
    rng = random.Random(9000 + seed)
    horizon = 2e-3
    events = []
    for dim in (0, 1):
        t0 = rng.uniform(0.1, 0.5) * horizon
        kind = rng.choice(("degrade", "outage", "burst"))
        if kind == "degrade":
            events.append(ns.BwDegradation(dim=dim, start=t0, end=t0 + 0.4 * horizon,
                                           factor=rng.uniform(0.1, 0.8)))
        elif kind == "outage":
            events.append(ns.DimOutage(dim=dim, start=t0, end=t0 + 0.15 * horizon))
        else:
            events.append(ns.StragglerBurst(dim=dim, start=t0, end=t0 + 0.4 * horizon,
                                            sigma=rng.uniform(0.05, 0.4)))
    faults = ns.FaultSchedule(events=tuple(events), retry=ns.RetryPolicy(
        timeout_s=5e-5, backoff_s=2e-5, max_attempts=rng.choice((2, 10))))
    reqs = [ns.CollectiveRequest(rng.choice(("AR", "RS", "AG")), rng.uniform(2, 20) * MB,
                                 issue_time=rng.uniform(0, 1e-3)) for _ in range(8)]
    return faults, reqs


@pytest.mark.parametrize("seed", range(6))
def test_chaos_differential_engines_agree(seed):
    """The reference's six seeded chaos draws: port indexed equals
    reference indexed and port reference equals reference reference (the
    reference's own indexed and reference engines differ here, R2)."""
    for eng in ENGINES2:
        def run(ns):
            faults, reqs = _chaos(ns, seed)
            return _run(ns, eng, reqs, lambda _: faults)

        same_run(run)


# ---------------------------------------------------------------------------
# Faults x dependency-gated streams (tests/test_engine_equiv.py)
# ---------------------------------------------------------------------------
def _chain_graph(ns, tails):
    head = [ns.TrafficNode("head", request=ns.CollectiveRequest("AR", 16 * MB), start_s=0.0)]
    return ns.TrafficGraph(tuple(head + tails))


@pytest.mark.parametrize("eng", ENGINES2)
def test_dependency_release_survives_retried_predecessor(eng):
    def run(ns):
        graph = _chain_graph(ns, [ns.TrafficNode(
            f"tail{i}", request=ns.CollectiveRequest("AR", 4 * MB), deps=("head",),
            compute_s=1e-5) for i in range(3)])
        faults = ns.FaultSchedule(
            events=(ns.DimOutage(dim=1, start=5e-5, end=6e-4),),
            retry=ns.RetryPolicy(timeout_s=4e-5, backoff_s=2e-5, max_attempts=20))
        return ns.simulate_traffic(ns.TOPOS[TOPO], graph, chunks_per_collective=6,
                                   engine=eng, check_invariants=True, faults=faults)

    res, _ = same_run(run)
    assert sum(res.group_retries) > 0
    assert not res.failed_groups
    head_finish = res.group_finish[0]
    assert head_finish > 6e-4
    for i in range(1, 4):
        assert res.group_issue[i] == pytest.approx(head_finish + 1e-5)
        assert res.group_finish[i] >= res.group_issue[i]


@pytest.mark.parametrize("eng", ENGINES2)
def test_dependency_release_survives_failed_predecessor(eng):
    def run(ns):
        graph = _chain_graph(ns, [
            ns.TrafficNode("mid", request=ns.CollectiveRequest("AR", 4 * MB), deps=("head",)),
            ns.TrafficNode("leaf", request=ns.CollectiveRequest("AR", 4 * MB), deps=("mid",)),
            ns.TrafficNode("free", request=ns.CollectiveRequest("AR", 4 * MB), start_s=0.0)])
        faults = ns.FaultSchedule(
            events=(ns.DimOutage(dim=1, start=5e-5),),
            retry=ns.RetryPolicy(timeout_s=4e-5, backoff_s=2e-5, max_attempts=2))
        return ns.simulate_traffic(ns.TOPOS[TOPO], graph, chunks_per_collective=6,
                                   engine=eng, check_invariants=True, faults=faults)

    res, _ = same_run(run)
    failed = {g for g, _ in res.failed_groups}
    assert 0 in failed and {1, 2} <= failed


def _rand_graph(ns, rng, n_nodes, tenants=("default",)):
    """``tests/test_engine_equiv.py``'s random DAG, in package ``ns``."""
    nodes = []
    for i in range(n_nodes):
        n_deps = rng.randrange(0, min(i, 3) + 1) if i else 0
        deps = tuple(f"n{j}" for j in sorted(rng.sample(range(i), n_deps)))
        if rng.random() < 0.25:
            nodes.append(ns.TrafficNode(
                f"n{i}", compute_s=rng.uniform(0, 5e-4), deps=deps,
                start_s=rng.uniform(0, 1e-3) if not deps else 0.0,
                tenant=rng.choice(tenants)))
        else:
            req = ns.CollectiveRequest(
                rng.choice(("AR", "RS", "AG")), rng.uniform(1, 40) * MB,
                priority=rng.choice((0, 0, 1)), stream=f"s{i % 3}",
                tenant=rng.choice(tenants))
            nodes.append(ns.TrafficNode(
                f"n{i}", request=req, compute_s=rng.uniform(0, 2e-4), deps=deps,
                start_s=rng.uniform(0, 1e-3) if not deps else 0.0))
    return ns.TrafficGraph(tuple(nodes))


@pytest.mark.parametrize("eng", ENGINES2)
@pytest.mark.parametrize("arb_policy", ["weighted-fair", "strict-priority"])
def test_dependency_release_survives_preempted_predecessor(arb_policy, eng):
    """Faults x preemption x dependencies: the port's engine equals the
    reference's same engine, and so does the arbiter's preemption count
    (the reference's two engines differ here, R2)."""
    arbs = {}

    def run(ns):
        specs = [ns.TenantSpec("a", weight=1.0), ns.TenantSpec("b", weight=3.0, priority=2)]
        faults = ns.FaultSchedule(events=(
            ns.BwDegradation(dim=1, start=1e-4, end=8e-4, factor=0.2),
            ns.BwDegradation(dim=0, start=2e-4, end=6e-4, factor=0.5)))
        arbs[ns.root] = ns.FabricArbiter(arb_policy, specs, quantum_chunks=3,
                                         preemption=True)
        return ns.simulate_traffic(
            ns.TOPOS[TOPO], _rand_graph(ns, random.Random(41), 12, ("a", "b")),
            chunks_per_collective=6, arbiter=arbs[ns.root], engine=eng,
            check_invariants=True, faults=faults)

    same_run(run)
    assert arbs["repro_torch"].preempt_count == arbs["repro"].preempt_count


# ---------------------------------------------------------------------------
# chip_smoke.py's phase_faults against benchmarks/faults_study.py
# ---------------------------------------------------------------------------
def test_chip_smoke_fault_scenarios_equal_faults_study():
    """``chip_smoke.py``'s identity, 24 chaos scenarios and the re-planning
    sweep (what ``phase_faults`` prints and gates) equal the study's own
    parts at full size, value for value; the study's timings are not part
    of what it returns."""
    cs, fs = chip_smoke(), study("faults_study")
    assert cs.REPLAN_GATE == fs.REPLAN_GATE
    assert cs.faults_identity() == fs.identity_part(False)[0]
    chaos = cs.faults_chaos()
    assert chaos == fs.chaos_part(False)[0]
    assert chaos["n_scenarios"] == 24 and chaos["all_identical"]
    sweep = cs.faults_sweep()
    assert sweep == fs.sweep_part(False)[0]
    assert sweep["factors"] == [0.7, 0.5, 0.25, 0.1] and sweep["gate_passed"]
