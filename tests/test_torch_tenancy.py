"""The port's multi-tenant fabric (``repro_torch.tenancy``) against the
reference's, on the CPU.

Mirrors ``tests/test_tenancy.py`` (tenant-tagged streams, the arbiter
policies, preemption and byte conservation, the shared Dim Load Tracker,
the per-tenant aggregates) and the arbiter cases of
``tests/test_engine_equiv.py`` (every discipline, preemption with jitter
and re-arm penalties, the sanitizer, the batch runner, tracing). Each
scenario is built twice from the same numbers, once per package, and each
port engine is held to the **same** reference engine field for field, with
the arbiters' own books (preemptions, served bytes); no test asserts
indexed == reference (ROADMAP §3, R2). The last tests hold
``chip_smoke.py``'s ``phase_tenancy`` to ``benchmarks/tenancy_study.py``.
"""
import random

import pytest
from _sim_twins import (ARB_POLICIES, MB, PORT, REF, assert_same, chip_smoke, plain,
                        raises_alike, same_run, schedules, study)

TOPO2D = "2D-SW_SW"
ENGINES2 = ("indexed", "reference")


def _asym_scenario(ns):
    """Heavy batch tenant (big ARs, first in line) + light latency tenant."""
    heavy = ns.synthetic_requests("heavy", "AR", 300 * MB, 2)
    light = ns.synthetic_requests("light", "AR", 8 * MB, 6, gap_s=0.0004, start_s=0.0002)
    specs = [ns.TenantSpec("heavy", weight=1.0),
             ns.TenantSpec("light", weight=1.0, priority=1, slo_slowdown=1.5)]
    return specs, heavy + light


def _rand_requests(ns, rng, n, tenants=("default",)):
    return [ns.CollectiveRequest(rng.choice(("AR", "RS", "AG")), rng.uniform(1, 60) * MB,
                                 issue_time=rng.uniform(0, 3e-3),
                                 priority=rng.choice((0, 0, 1)), tenant=rng.choice(tenants),
                                 stream=f"s{i % 3}")
            for i in range(n)]


def _two_specs(ns):
    return [ns.TenantSpec("a", weight=2.0),
            ns.TenantSpec("b", weight=1.0, priority=1, slo_slowdown=1.5)]


def _same_arbiters(arbs):
    """The port's arbiter kept the reference's books: preemptions, virtual
    times and served bytes per dim and tenant."""
    got, want = arbs["repro_torch"], arbs["repro"]
    assert got.preempt_count == want.preempt_count
    assert got.discipline_state() == want.discipline_state()
    for t in want.specs:
        assert got.served_bytes(t) == want.served_bytes(t)


# --------------------------------------------------------------------------
# Tenant-tagged request streams
# --------------------------------------------------------------------------
def test_tenant_job_emits_tagged_iterated_stream():
    def job(ns):
        spec = ns.TenantSpec("resnet", weight=2.0, iterations=3, n_buckets=4,
                             arrival_offset_s=0.01)
        return ns.TenantJob(spec, ns.make_resnet152())

    reqs = job(PORT).requests()
    assert plain(reqs) == plain(job(REF).requests())
    assert len(reqs) == 12 and all(r.tenant == "resnet" for r in reqs)
    assert min(r.issue_time for r in reqs) >= 0.01
    it0 = [r for r in reqs if r.stream.startswith("resnet/it0/")]
    it2 = [r for r in reqs if r.stream.startswith("resnet/it2/")]
    assert max(r.issue_time for r in it0) < min(r.issue_time for r in it2)
    assert sum(b.size_bytes for b in it0) == pytest.approx(
        sum(o.size_bytes for o in job(PORT).workload.comm_ops), rel=1e-9)


@pytest.mark.parametrize("kw", [dict(weight=0.0), dict(slo_slowdown=0.5),
                                dict(iterations=0), dict(n_buckets=0)],
                         ids=["weight", "slo", "iterations", "buckets"])
def test_tenant_spec_validation(kw):
    raises_alike(lambda ns: ns.TenantSpec("x", **kw))


@pytest.mark.parametrize("n,kind,size,kw", [
    (3, "AR", 40 * MB, {}), (5, "RS", 7 * MB, dict(gap_s=1e-4, start_s=2e-3)),
    (2, "AG", 1 * MB, dict(gap_s=0.0))])
def test_synthetic_requests_equal_reference(n, kind, size, kw):
    assert (plain(PORT.synthetic_requests("t", kind, size, n, **kw))
            == plain(REF.synthetic_requests("t", kind, size, n, **kw)))


# --------------------------------------------------------------------------
# Arbiter policies
# --------------------------------------------------------------------------
def test_arbiter_policy_validation():
    raises_alike(lambda ns: ns.FabricArbiter("round-robin", []))
    raises_alike(lambda ns: ns.FabricArbiter("fifo", [], quantum_chunks=0))
    raises_alike(lambda ns: ns.FabricArbiter("weighted-fair", [], preempt_penalty_s=-1.0))
    assert PORT.ARBITER_POLICIES == REF.ARBITER_POLICIES
    assert PORT.FabricArbiter("fifo", []).preemption is False
    assert PORT.FabricArbiter("weighted-fair", []).preempt_penalty_s == 0.0
    raises_alike(lambda ns: ns.simulate(ns.TOPOS[TOPO2D], [], preempt_penalty_s=-1e-4))


def _fairness(ns, policy, **arb_kw):
    specs, reqs = _asym_scenario(ns)
    iso = ns.isolated_latencies(ns.TOPOS[TOPO2D], reqs, chunks_per_collective=8)
    arb = ns.FabricArbiter(policy, specs, **arb_kw)
    res, _ = ns.simulate_fabric(ns.TOPOS[TOPO2D], reqs, arbiter=arb, chunks_per_collective=8)
    reps = ns.tenant_reports(res, reqs, iso, {s.name: s for s in specs})
    return res, reps, arb, iso


def test_weighted_fair_beats_fifo_for_light_tenant():
    stats = {}
    for policy in ("fifo", "weighted-fair"):
        res, reps, _, iso = _fairness(PORT, policy)
        j_res, j_reps, _, j_iso = _fairness(REF, policy)
        assert_same(res, j_res)
        assert plain(iso) == plain(j_iso) and plain(reps) == plain(j_reps)
        assert PORT.fairness_index(reps) == REF.fairness_index(j_reps)
        stats[policy] = (reps, PORT.fairness_index(reps))
    assert stats["weighted-fair"][0]["light"].mean_slowdown < stats["fifo"][0][
        "light"].mean_slowdown
    assert stats["weighted-fair"][1] > stats["fifo"][1]


def test_strict_priority_serves_high_priority_first():
    res, reps, arb, _ = _fairness(PORT, "strict-priority")
    j_res, j_reps, j_arb, _ = _fairness(REF, "strict-priority")
    assert_same(res, j_res)
    assert plain(reps) == plain(j_reps) and arb.preempt_count == j_arb.preempt_count
    assert reps["light"].mean_slowdown < _fairness(PORT, "fifo")[1]["light"].mean_slowdown
    assert arb.preempt_count > 0


def test_slo_boost_kicks_in_on_violation():
    arbs = {ns.root: ns.FabricArbiter("slo-aware", [ns.TenantSpec("t", weight=1.0,
                                                                  slo_slowdown=1.5)],
                                      isolated_latency={"t": 0.010}) for ns in (REF, PORT)}
    for step in (None, 0.030, 0.012, 0.016):
        if step is not None:
            for arb in arbs.values():
                arb.on_group_finish(0, "t", step)
        got, want = arbs["repro_torch"], arbs["repro"]
        assert got.slo_boost("t") == want.slo_boost("t")
        assert got.effective_weight("t") == want.effective_weight("t")
        if step is not None:
            assert got.observed_slowdown("t") == want.observed_slowdown("t")
    arb = PORT.FabricArbiter("slo-aware", [PORT.TenantSpec("t", slo_slowdown=1.5)],
                             isolated_latency={"t": 0.010})
    assert arb.slo_boost("t") == 1.0
    arb.on_group_finish(0, "t", 0.030)
    assert arb.observed_slowdown("t") == pytest.approx(3.0)
    assert arb.slo_boost("t") == pytest.approx(2.0)
    arb.on_group_finish(0, "t", 0.012)
    assert arb.slo_boost("t") == 1.0


def test_slo_debt_arbiter_equals_reference():
    """The elastic ``SloDebtArbiter`` on the asymmetric scenario, both
    engines: the same results and the same books as the reference's."""
    for eng in ENGINES2:
        arbs = {}

        def run(ns):
            specs, reqs = _asym_scenario(ns)
            arbs[ns.root] = ns.SloDebtArbiter(specs, isolated_latency={"light": 0.002})
            return ns.simulate_fabric(ns.TOPOS[TOPO2D], reqs, arbiter=arbs[ns.root],
                                      chunks_per_collective=8, engine=eng)

        same_run(run)
        _same_arbiters(arbs)


def test_arbiter_of_the_reference_is_not_indexable_in_the_port():
    """The indexed engine takes only the port's own ``FabricArbiter``: one
    made by the reference package runs on the reference engine (so tests
    always build the port's arbiters themselves)."""
    for policy in ARB_POLICIES:
        assert PORT._arbiter_indexable(PORT.FabricArbiter(policy, _two_specs(PORT)))
        assert not PORT._arbiter_indexable(REF.FabricArbiter(policy, _two_specs(REF)))
    assert PORT._arbiter_indexable(None) is False


# --------------------------------------------------------------------------
# Preemption correctness
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["weighted-fair", "strict-priority"])
def test_preemption_conserves_bytes(policy):
    arbs = {}

    def run(ns):
        specs, reqs = _asym_scenario(ns)
        arbs[ns.root] = ns.FabricArbiter(policy, specs)
        return ns.simulate_fabric(ns.TOPOS[TOPO2D], reqs, arbiter=arbs[ns.root],
                                  policy="baseline", chunks_per_collective=8)

    res, _ = same_run(run)
    _same_arbiters(arbs)
    assert arbs["repro_torch"].preempt_count > 0
    _, reqs = _asym_scenario(PORT)
    lm = PORT.LatencyModel(PORT.TOPOS[TOPO2D])
    want = sum(lm.total_wire_bytes(r.collective, r.size_bytes) for r in reqs)
    assert sum(res.dim_wire_bytes) == pytest.approx(want, rel=1e-9)
    for g, r in enumerate(reqs):
        assert res.group_finish[g] > r.issue_time


def test_preemption_splits_inflight_service():
    def reqs(ns):
        heavy = ns.synthetic_requests("heavy", "AR", 300 * MB, 1)
        solo, _ = ns.simulate_fabric(ns.TOPOS[TOPO2D], heavy, chunks_per_collective=8)
        return heavy + ns.synthetic_requests("light", "AR", 4 * MB, 1,
                                             start_s=0.25 * solo.makespan)

    finishes = {}
    for preempt in (True, False):
        arbs = {}

        def run(ns):
            arbs[ns.root] = ns.FabricArbiter(
                "weighted-fair", [ns.TenantSpec("heavy"), ns.TenantSpec("light")],
                preemption=preempt, quantum_chunks=8)
            return ns.simulate_fabric(ns.TOPOS[TOPO2D], reqs(ns), arbiter=arbs[ns.root],
                                      chunks_per_collective=8)

        res, _ = same_run(run)
        _same_arbiters(arbs)
        finishes[preempt] = res.group_finish[1]
        if preempt:
            assert arbs["repro_torch"].preempt_count > 0
            assert any(res.groups_interleave_on(k) for k in range(2))
    assert finishes[True] < finishes[False]


# --------------------------------------------------------------------------
# Cross-tenant Themis: shared vs per-tenant Dim Load Trackers
# --------------------------------------------------------------------------
def test_shared_tracker_sees_other_tenants_loads():
    def scheduled(ns, shared, solo=False):
        a = ns.synthetic_requests("a", "AR", 200 * MB, 1)
        b = ns.synthetic_requests("b", "AR", 50 * MB, 1, start_s=1e-4)
        return ns.schedule_tenant_requests(ns.TOPOS[TOPO2D], b if solo else a + b,
                                           shared_tracker=shared, chunks_per_collective=8)

    for shared in (True, False):
        assert schedules(scheduled(PORT, shared)) == schedules(scheduled(REF, shared))
    shared, per_t = scheduled(PORT, True), scheduled(PORT, False)
    b_solo = scheduled(PORT, True, solo=True)
    assert [c.schedule for c in per_t[1]] == [c.schedule for c in b_solo[0]]
    assert [c.schedule for c in shared[1]] != [c.schedule for c in per_t[1]]


def test_shared_tracker_helps_on_some_scenario():
    wins = 0
    for tname in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
        out = {}
        for shared in (True, False):
            def run(ns):
                specs = [ns.TenantSpec(n) for n in ("a", "b", "c")]
                reqs = []
                for i, s in enumerate(specs):
                    reqs += ns.synthetic_requests(s.name, "AR", 200 * MB, 3, gap_s=0.003,
                                                  start_s=i * 0.001)
                return ns.simulate_fabric(ns.TOPOS[tname], reqs,
                                          arbiter=ns.FabricArbiter("weighted-fair", specs),
                                          shared_tracker=shared, chunks_per_collective=32)

            out[shared] = same_run(run)[0].finish_time()
        wins += out[True] < out[False]
    assert wins >= 1


# --------------------------------------------------------------------------
# SimResult per-stream/tenant aggregation and the metrics
# --------------------------------------------------------------------------
def test_stream_stats_aggregation():
    def run(ns):
        reqs = (ns.synthetic_requests("a", "AR", 40 * MB, 2)
                + ns.synthetic_requests("b", "RS", 20 * MB, 3, gap_s=1e-4))
        return ns.simulate_requests(ns.TOPOS[TOPO2D], reqs, policy="themis",
                                    chunks_per_collective=8)

    res, _ = same_run(run)
    j_res, _ = run(REF)
    by_tenant = res.stream_stats(by="tenant")
    assert plain(by_tenant) == plain(j_res.stream_stats(by="tenant"))
    assert set(by_tenant) == {"a", "b"}
    assert by_tenant["a"].n == 2 and by_tenant["b"].n == 3
    assert sum(s.wire_bytes for s in by_tenant.values()) == pytest.approx(
        sum(res.dim_wire_bytes), rel=1e-9)
    assert res.stream_finish("a", by="tenant") == by_tenant["a"].finish
    raises_alike(lambda ns: run(ns)[0].stream_stats(by="nope"))


@pytest.mark.parametrize("xs", [[], [2.0, 2.0, 2.0], [1.0, 0.0, 0.0], [1.0, 2.0],
                                [0.3, 1.7, 2.9, 0.01]])
def test_jain_index_basics(xs):
    assert PORT.jain_index(xs) == REF.jain_index(xs)
    assert 0.0 < PORT.jain_index(xs) <= 1.0 + 1e-12


def test_tenant_report_helpers_equal_reference():
    """``mean_slowdown``, ``slo_violations``, ``fairness_index`` over the
    reports of every arbiter policy on the asymmetric scenario."""
    for policy in ARB_POLICIES:
        _, reps, _, _ = _fairness(PORT, policy)
        _, j_reps, _, _ = _fairness(REF, policy)
        for name in ("mean_slowdown", "slo_violations", "fairness_index"):
            assert getattr(PORT, name)(reps) == getattr(REF, name)(j_reps), (policy, name)


# --------------------------------------------------------------------------
# Engines under arbiters (tests/test_engine_equiv.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("eng", ENGINES2)
@pytest.mark.parametrize("arb_policy", ARB_POLICIES)
def test_engines_under_arbiters_equal_reference(arb_policy, eng):
    for tname in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
        arbs = {}

        def run(ns):
            rng = random.Random(200 + ARB_POLICIES.index(arb_policy) + len(tname))
            arbs[ns.root] = ns.FabricArbiter(arb_policy, _two_specs(ns),
                                             isolated_latency={"b": 0.001})
            return ns.simulate_fabric(ns.TOPOS[tname],
                                      _rand_requests(ns, rng, 14, ("a", "b")),
                                      arbiter=arbs[ns.root], chunks_per_collective=8,
                                      engine=eng)

        same_run(run)
        _same_arbiters(arbs)


@pytest.mark.parametrize("eng", ENGINES2)
def test_custom_order_key_subclass_falls_back_to_reference(eng):
    def run(ns):
        class LargestFirst(ns.FabricArbiter):
            def order_key(self, task, dim, now):
                return (-task.wire_bytes, task.arrival_seq)

        specs = [ns.TenantSpec("a"), ns.TenantSpec("b")]
        reqs = _rand_requests(ns, random.Random(42), 10, ("a", "b"))
        return ns.simulate_fabric(ns.TOPOS[TOPO2D], reqs,
                                  arbiter=LargestFirst("weighted-fair", specs),
                                  chunks_per_collective=8, engine=eng)

    res, _ = same_run(run)
    stock, _ = PORT.simulate_fabric(
        PORT.TOPOS[TOPO2D], _rand_requests(PORT, random.Random(42), 10, ("a", "b")),
        arbiter=PORT.FabricArbiter("weighted-fair", [PORT.TenantSpec("a"),
                                                     PORT.TenantSpec("b")]),
        chunks_per_collective=8)
    assert stock.dim_op_order != res.dim_op_order


def _heavy_light(ns, n_light=3, start=5e-4):
    return (ns.synthetic_requests("heavy", "AR", 300 * MB, 1)
            + ns.synthetic_requests("light", "AR", 4 * MB, n_light, gap_s=2e-4,
                                    start_s=start))


@pytest.mark.parametrize("eng", ["indexed", "compiled", "reference"])
@pytest.mark.parametrize("jitter", [0.0, 0.15])
def test_preemption_heavy_scenario_with_jitter_equals_reference(jitter, eng):
    """``simulate(arbiter=...)`` on hand-scheduled tenant groups, jitter
    on the preemption path (the compiled engine falls back to indexed)."""
    arbs = {}

    def run(ns):
        reqs = _heavy_light(ns)
        groups = ns.schedule_tenant_requests(ns.TOPOS[TOPO2D], reqs, chunks_per_collective=8)
        arbs[ns.root] = ns.FabricArbiter("weighted-fair", [ns.TenantSpec("heavy"),
                                                           ns.TenantSpec("light")],
                                         quantum_chunks=8)
        return ns.simulate(ns.TOPOS[TOPO2D], groups, issue_times=[r.issue_time for r in reqs],
                           tenants=[r.tenant for r in reqs], arbiter=arbs[ns.root],
                           jitter=jitter, seed=5, engine=eng)

    same_run(run)
    _same_arbiters(arbs)
    assert arbs["repro_torch"].preempt_count > 0


@pytest.mark.parametrize("eng", ENGINES2)
def test_preempt_penalty_charges_requeued_chunks(eng):
    finishes = {}
    for penalty in (0.0, 2e-3):
        arbs = {}

        def run(ns):
            arbs[ns.root] = ns.FabricArbiter("weighted-fair", [ns.TenantSpec("heavy"),
                                                               ns.TenantSpec("light")],
                                             quantum_chunks=8, preempt_penalty_s=penalty)
            return ns.simulate_fabric(ns.TOPOS[TOPO2D], _heavy_light(ns, 1),
                                      arbiter=arbs[ns.root], chunks_per_collective=8,
                                      engine=eng)

        res, _ = same_run(run)
        _same_arbiters(arbs)
        assert arbs["repro_torch"].preempt_count > 0
        finishes[penalty] = res.finish_time()
    assert finishes[2e-3] > finishes[0.0]


def _penalty_specs(ns):
    return [ns.TenantSpec("heavy", weight=1.0),
            ns.TenantSpec("light", weight=4.0, priority=5, slo_slowdown=1.2)]


@pytest.mark.parametrize("arb_policy", ARB_POLICIES)
@pytest.mark.parametrize("penalty", [0.0, 1e-3])
def test_preemption_conserves_bytes_under_all_disciplines(arb_policy, penalty):
    lm = PORT.LatencyModel(PORT.TOPOS[TOPO2D])
    want = sum(lm.total_wire_bytes(r.collective, r.size_bytes) for r in _heavy_light(PORT))
    for eng in ENGINES2:
        arbs = {}

        def run(ns):
            arbs[ns.root] = ns.FabricArbiter(arb_policy, _penalty_specs(ns), quantum_chunks=8,
                                             preempt_penalty_s=penalty,
                                             isolated_latency={"light": 0.001})
            return ns.simulate_fabric(ns.TOPOS[TOPO2D], _heavy_light(ns),
                                      arbiter=arbs[ns.root], chunks_per_collective=8,
                                      engine=eng, check_invariants=True)

        res, _ = same_run(run)
        _same_arbiters(arbs)
        assert sum(res.dim_wire_bytes) == pytest.approx(want, rel=1e-9)
        if arb_policy != "fifo":
            assert arbs["repro_torch"].preempt_count > 0


@pytest.mark.parametrize("arb_policy", ["strict-priority", "weighted-fair", "slo-aware"])
def test_preempt_penalty_rearm_delays_drain(arb_policy):
    for eng in ENGINES2:
        finishes = {}
        for penalty in (0.0, 2e-3):
            def run(ns):
                arb = ns.FabricArbiter(arb_policy, _penalty_specs(ns), quantum_chunks=8,
                                       preempt_penalty_s=penalty,
                                       isolated_latency={"light": 0.001})
                return ns.simulate_fabric(ns.TOPOS[TOPO2D], _heavy_light(ns), arbiter=arb,
                                          chunks_per_collective=8, engine=eng,
                                          check_invariants=True)

            finishes[penalty] = same_run(run)[0].finish_time()
        assert finishes[2e-3] > finishes[0.0]


@pytest.mark.parametrize("arb_policy", ARB_POLICIES)
def test_simulate_batch_under_arbiters_equals_reference(arb_policy):
    """``Scenario(arbiter_factory=...)`` through ``simulate_batch`` and
    ``simulate_scenario`` in the port equals the reference's
    ``simulate_scenario``, scenario by scenario."""
    def scenarios(ns):
        rng = random.Random(400 + ARB_POLICIES.index(arb_policy))
        out = []
        for tname in ("2D-SW_SW", "3D-SW_SW_SW_hetero"):
            reqs = tuple(_rand_requests(ns, rng, 12, ("a", "b")))
            factory = (lambda: ns.FabricArbiter(arb_policy, _two_specs(ns), quantum_chunks=4,
                                                isolated_latency={"b": 0.001}))
            for jitter, seed, engine in ((0.0, 0, "indexed"), (0.1, 7, "indexed"),
                                         (0.1, 7, "reference")):
                out.append(ns.Scenario(ns.TOPOS[tname], reqs, chunks_per_collective=8,
                                       jitter=jitter, seed=seed, engine=engine,
                                       arbiter_factory=factory))
        return out

    got, want = scenarios(PORT), scenarios(REF)
    for g, w, b in zip(got, want, PORT.simulate_batch(got)):
        ref = REF.simulate_scenario(w)
        assert_same(b, ref)
        assert_same(PORT.simulate_scenario(g), ref)


def _assert_trace_faithful(trc, res, topo):
    wire, busy = trc.service_wire(), trc.service_busy()
    for d in range(topo.num_dims):
        assert wire[d] == pytest.approx(res.dim_wire_bytes[d], rel=1e-12, abs=1e-12)
        assert busy[d] == pytest.approx(res.dim_busy[d], rel=1e-12, abs=1e-12)
        assert trc.ops_served(d) == res.dim_op_order[d]
        assert len(trc.services[d]) == len(res.dim_services[d])


@pytest.mark.parametrize("eng", ENGINES2)
@pytest.mark.parametrize("arb_policy", ARB_POLICIES)
def test_tracing_under_arbiters_equals_reference(arb_policy, eng):
    """Traced arbiter runs: the port's traced and untraced results and its
    trace (grants, preemptions, enqueues, releases) equal the reference's
    on the same engine."""
    out = {}
    for ns in (REF, PORT):
        rng = random.Random(800 + ARB_POLICIES.index(arb_policy))
        reqs = _rand_requests(ns, rng, 14, ("a", "b"))
        kw = dict(chunks_per_collective=8, engine=eng)
        plain_res, _ = ns.simulate_fabric(
            ns.TOPOS[TOPO2D], reqs, arbiter=ns.FabricArbiter(
                arb_policy, _two_specs(ns), isolated_latency={"b": 0.001}), **kw)
        trc = ns.Tracer()
        traced, _ = ns.simulate_fabric(
            ns.TOPOS[TOPO2D], reqs, arbiter=ns.FabricArbiter(
                arb_policy, _two_specs(ns), isolated_latency={"b": 0.001}), tracer=trc, **kw)
        out[ns.root] = (plain_res, traced, trc)
    (p, t, trc), (j_p, j_t, j_trc) = out["repro_torch"], out["repro"]
    assert_same(p, j_p)
    assert_same(t, j_t)
    for field in ("grants", "preempts", "enqueues", "releases", "services"):
        assert plain(getattr(trc, field)) == plain(getattr(j_trc, field)), field
    assert not t.diff_fields(p)
    assert len(trc.grants) == sum(len(s) for s in trc.services)
    _assert_trace_faithful(trc, t, PORT.TOPOS[TOPO2D])


# --------------------------------------------------------------------------
# chip_smoke.py's phase_tenancy against benchmarks/tenancy_study.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tname", ["2D-SW_SW", "3D-SW_SW_SW_homo", "3D-SW_SW_SW_hetero"])
def test_chip_smoke_tenancy_scenarios_equal_tenancy_study(tname):
    """``chip_smoke.py``'s fairness and workloads sweeps, preemption cost and
    tracker ablation on each of the study's topologies equal the study's
    ``_sweep``, ``_preemption_cost`` and ``_ablation`` (their simulated
    values; the study's timings are dropped)."""
    cs, ts = chip_smoke(), study("tenancy_study")
    assert cs.TENANCY_TOPOLOGIES == ts.TOPO_NAMES and cs.TENANCY_POLICIES == ts.POLICIES
    assert cs.TENANCY_CHUNKS == ts.CHUNKS
    assert cs.PREEMPT_PENALTIES_S == ts.PREEMPT_PENALTIES_S
    topo, j_topo = PORT.TOPOS[tname], REF.TOPOS[tname]
    fairness, ctx = cs.tenancy_sweep(topo, "fairness")
    _, j_fairness, j_ctx = ts._sweep(j_topo, ts._fairness_tenants)
    assert fairness == j_fairness
    assert plain(ctx) == plain(j_ctx)
    assert cs.tenancy_sweep(topo, "workloads")[0] == ts._sweep(j_topo, ts._workload_tenants)[1]
    assert cs.tenancy_preemption_cost(topo, *ctx) == ts._preemption_cost(j_topo, *j_ctx)[1]
    assert cs.tenancy_ablation(topo) == ts._ablation(j_topo)[1]


def test_chip_smoke_tenancy_study_passes_the_studys_checks():
    """``tenancy_study()`` (what ``phase_tenancy`` prints and gates): both
    checks hold on all three topologies, as in ``BENCH_tenancy.json``."""
    import json

    report = chip_smoke().tenancy_study()
    bench = json.loads((study("tenancy_study").OUT_JSON).read_text())
    assert report["checks"] == bench["checks"]
    assert set(report["scenarios"]) == set(bench["scenarios"])
