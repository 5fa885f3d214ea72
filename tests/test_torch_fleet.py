"""The port's serving fleet (``repro_torch.fleet``) against the reference's,
on the CPU.

Mirrors ``tests/test_fleet.py`` (the arrival processes, ``fleet_traffic``,
the admission controller's policies driven directly, shed-aware stream
stats, the SLO-debt arbiter, ``calibrate_admission``) and the admission
cases of ``tests/test_engine_equiv.py`` (seeded arrivals, fleet traffic,
the three policies, tracer invariance, admission under faults). Each
scenario is built twice from the same numbers, once per package, and the
port's arrival times, controllers and results equal the reference's to the
bit; each port engine is held to the **same** reference engine, never
indexed to reference (ROADMAP §3, R2). The last tests hold
``chip_smoke.py``'s ``phase_fleet`` to ``benchmarks/fleet_study.py``.
"""
import math

import pytest
from _sim_twins import (ENGINES, PORT, REF, assert_same, chip_smoke, plain, raises_alike,
                        same_run, study)

TOPO = "2D-SW_SW"
COSTS = dict(prefill_bytes=64e6, decode_bytes=2e6,
             prefill_s=1e-3, decode_s=1e-4, prefill_ops=2, gen_tokens=3)
# tests/test_engine_equiv.py's overload costs
OVERLOAD_COSTS = dict(prefill_bytes=2e9, decode_bytes=64e6,
                      prefill_s=5e-3, decode_s=2e-4, prefill_ops=2)


def _both(make):
    """``make(ns)`` for the port and the reference: (port's, reference's)."""
    return make(PORT), make(REF)


def _same_times(make, **bounds):
    """The port's arrival process ``make(ns)`` draws the reference's times
    to the bit; returns the port's."""
    got, want = _both(lambda ns: make(ns).times(**bounds))
    assert got == want
    return got


# --------------------------------------------------------------------------
# Arrival processes
# --------------------------------------------------------------------------
def test_arrival_bounds_validation():
    for bounds, msg in ((dict(), "needs n=, horizon_s="), (dict(n=-1), "n must be >= 0"),
                        (dict(horizon_s=-1.0), "horizon_s must be >= 0")):
        assert msg in raises_alike(lambda ns, b=bounds: ns.PoissonArrivals(10.0).times(**b))
    assert "rate_rps must be > 0" in raises_alike(lambda ns: ns.PoissonArrivals(0.0))
    assert _same_times(lambda ns: ns.PoissonArrivals(10.0), n=0) == []
    assert len(_same_times(lambda ns: ns.PoissonArrivals(10.0), n=5)) == 5
    assert all(t <= 2.0 for t in _same_times(lambda ns: ns.PoissonArrivals(10.0), horizon_s=2.0))


def test_poisson_mean_rate_is_plausible():
    ts = _same_times(lambda ns: ns.PoissonArrivals(100.0, seed=1), horizon_s=20.0)
    assert len(ts) == pytest.approx(2000, rel=0.1)


def test_diurnal_rate_modulation_and_validation():
    assert "amplitude" in raises_alike(lambda ns: ns.DiurnalArrivals(10.0, amplitude=1.0))
    d, j_d = _both(lambda ns: ns.DiurnalArrivals(100.0, amplitude=0.9, period_s=4.0, seed=2))
    assert d.rate_at(1.0) == j_d.rate_at(1.0) == pytest.approx(190.0)
    assert d.rate_at(3.0) == j_d.rate_at(3.0) == pytest.approx(10.0)
    ts = d.times(horizon_s=40.0)
    assert ts == j_d.times(horizon_s=40.0)
    hi = sum(1 for t in ts if d.rate_at(t) > 100.0)
    assert hi / len(ts) > 0.7


def test_mmpp_burstiness_and_validation():
    for args, msg in ((((10.0,), (1.0,)), ">= 2 states"),
                      (((10.0, 20.0), (1.0,)), "entries for"),
                      (((0.0, 0.0), (1.0, 1.0)), "at least one state rate")):
        assert msg in raises_alike(lambda ns, a=args: ns.MMPPArrivals(*a))
    ts = _same_times(lambda ns: ns.MMPPArrivals((5.0, 500.0), (0.5, 0.5), seed=3),
                     horizon_s=20.0)
    assert 0.3 * 20 * 5 < len(ts) < 20 * 500
    gaps = sorted(b - a for a, b in zip(ts, ts[1:]))
    assert gaps[len(gaps) // 10] < 0.01
    assert sum(1 for x in gaps if x > 0.05) >= 10


def test_mmpp_silent_state_produces_gaps():
    ts = _same_times(lambda ns: ns.MMPPArrivals((0.0, 200.0), (0.1, 0.1), seed=4),
                     horizon_s=2.0)
    assert ts
    assert max(b - a for a, b in zip(ts, ts[1:])) > 0.05


def test_trace_arrivals_replay_and_validation():
    assert "ascending" in raises_alike(lambda ns: ns.TraceArrivals((2.0, 1.0)))
    make = lambda ns: ns.TraceArrivals((0.1, 0.5, 0.9, 1.5), start_s=1.0)  # noqa: E731
    assert _same_times(make, horizon_s=1.0) == [1.1, 1.5, 1.9]
    assert _same_times(make, n=2) == [1.1, 1.5]


# --------------------------------------------------------------------------
# fleet_traffic assembly
# --------------------------------------------------------------------------
def _tenants(ns):
    return [ns.FleetTenant("web", ns.PoissonArrivals(50.0, seed=1), serving=dict(COSTS),
                           weight=2.0, slo_slowdown=3.0),
            ns.FleetTenant("batch", ns.PoissonArrivals(30.0, seed=2), serving=dict(COSTS),
                           priority=-1)]


def _graph(ns, horizon_s=0.2):
    return ns.fleet_traffic(_tenants(ns), horizon_s=horizon_s)


def test_fleet_traffic_tags_streams_tenants_and_units():
    g, j_g = _both(_graph)
    assert plain(g.nodes) == plain(j_g.nodes)
    assert {"web/decode", "web/prefill", "batch/decode"} <= {n.stream_tag for n in g.nodes}
    assert {n.tenant_tag for n in g.nodes} == {"web", "batch"}
    uo, up = PORT.unit_of_group(g)
    assert (uo, up) == REF.unit_of_group(j_g)
    n_req = sum(1 for n in g.nodes if n.name.endswith("prefill-compute"))
    assert max(uo) + 1 == n_req
    web = {uo[i] for i, n in enumerate(g.nodes) if n.tenant_tag == "web"}
    batch = {uo[i] for i, n in enumerate(g.nodes) if n.tenant_tag == "batch"}
    assert all(up[u] == 0 for u in web) and all(up[u] == -1 for u in batch)


def test_fleet_traffic_empty_bounds_raise():
    assert "no tenant produced arrivals" in raises_alike(lambda ns: _graph(ns, 0.0))


def test_fleet_tenant_specs_match_tags():
    specs, j_specs = _both(lambda ns: ns.fleet_tenant_specs(_tenants(ns)))
    assert plain(specs) == plain(j_specs)
    assert [s.name for s in specs] == ["web", "batch"]
    assert specs[0].weight == 2.0 and specs[0].slo_slowdown == 3.0
    assert specs[1].priority == -1


# --------------------------------------------------------------------------
# AdmissionController policy logic (driven directly, no engine)
# --------------------------------------------------------------------------
class _Twin:
    """One controller per package, driven through the same calls: every
    call returns the port's answer after checking it equals the
    reference's, and the two controllers' books stay equal."""

    def __init__(self, n_units, groups_per_unit=1, **kw):
        unit_of = [u for u in range(n_units) for _ in range(groups_per_unit)]
        self.ctls = [ns.AdmissionController(unit_of, **kw) for ns in (PORT, REF)]
        for c in self.ctls:
            c.begin(len(unit_of), "unit")

    def __getattr__(self, name):
        def call(*args):
            got, want = (getattr(c, name)(*args) for c in self.ctls)
            assert got == want
            self.same_books()
            return got
        return call

    def same_books(self):
        got, want = self.ctls
        assert (got.n_admitted, got.n_shed, got.shed_units, got._occupancy) == (
            want.n_admitted, want.n_shed, want.shed_units, want._occupancy)

    @property
    def port(self):
        return self.ctls[0]


def test_admission_validation():
    for kw, msg in ((dict(policy="lifo"), "unknown admission policy"),
                    (dict(capacity=0), "capacity must be >= 1"),
                    (dict(policy="shed-lowest-priority"), "needs unit_priority"),
                    (dict(policy="deadline-aware"), "needs deadline_s")):
        assert msg in raises_alike(lambda ns, k=kw: ns.AdmissionController([0], **k))
    assert "covers 1 groups" in raises_alike(
        lambda ns: ns.AdmissionController([0]).begin(2, "unit"))
    assert PORT.ADMISSION_POLICIES == REF.ADMISSION_POLICIES == (
        "reject-newest", "shed-lowest-priority", "deadline-aware")


def test_reject_newest_sheds_arrivals_past_capacity():
    ctl = _Twin(4, policy="reject-newest", capacity=2)
    assert ctl.on_ready(0, 0.0) == ()
    assert ctl.on_ready(1, 1.0) == ()
    assert ctl.on_ready(2, 2.0) == (2,)
    ctl.on_finish(0, 3.0)
    assert ctl.on_ready(3, 4.0) == ()
    assert ctl.port.n_admitted == 3 and ctl.port.n_shed == 1
    assert ctl.port.shed_units == [2]
    assert ctl.on_ready(2, 5.0) is None


def test_shed_lowest_priority_evicts_queued_victim():
    ctl = _Twin(3, policy="shed-lowest-priority", capacity=1,
                unit_priority={0: -1, 1: 5, 2: -7})
    assert ctl.on_ready(0, 0.0) == ()
    assert ctl.on_ready(1, 1.0) == (0,)
    assert ctl.on_ready(2, 2.0) == (2,)
    assert ctl.port.shed_units == [0, 2]


def test_shed_lowest_priority_ties_break_to_newest():
    ctl = _Twin(2, policy="shed-lowest-priority", capacity=1, unit_priority={0: 0, 1: 0})
    assert ctl.on_ready(0, 0.0) == ()
    assert ctl.on_ready(1, 1.0) == (1,)


def test_shed_serving_unit_is_never_a_victim():
    ctl = _Twin(2, policy="shed-lowest-priority", capacity=1, unit_priority={0: -9, 1: 5})
    assert ctl.on_ready(0, 0.0) == ()
    ctl.on_serving(0, 0.5)
    assert ctl.on_ready(1, 1.0) == (1,)


def test_deadline_aware_expires_and_drops_at_the_door():
    ctl = _Twin(5, policy="deadline-aware", capacity=1, deadline_s=1.0, est_service_s=0.6)
    assert ctl.on_ready(0, 0.0) == ()
    assert ctl.on_ready(1, 0.1) == ()
    assert ctl.on_ready(2, 0.2) == (2,)
    ctl.on_serving(0, 0.3)
    assert ctl.on_ready(3, 1.5) == (1,)
    assert ctl.on_ready(4, 1.6) == (4,)
    assert ctl.port.shed_units == [2, 1, 4]


def test_multi_group_units_decide_once_and_finish_once():
    ctl = _Twin(2, groups_per_unit=3, policy="reject-newest", capacity=1)
    assert ctl.on_ready(0, 0.0) == ()
    assert ctl.on_ready(3, 0.1) == (3, 4, 5)
    assert ctl.on_ready(4, 0.2) is None
    assert ctl.on_ready(2, 0.3) is None
    for g in (0, 1):
        ctl.on_finish(g, 1.0)
        ctl.on_finish(g, 1.0)
    assert ctl.port._occupancy == 1
    ctl.on_finish(2, 2.0)
    assert ctl.port._occupancy == 0


# --------------------------------------------------------------------------
# Shed-aware stream stats (the all-dead sentinel)
# --------------------------------------------------------------------------
def test_stream_stats_survive_fully_shed_streams():
    def shed_all(ns):
        g = _graph(ns)
        ctl = ns.AdmissionController(ns.unit_of_group(g)[0], policy="reject-newest",
                                     capacity=1)
        return ns.simulate_traffic(ns.TOPOS[TOPO], g, admission=ctl, check_invariants=True)

    res, _ = same_run(shed_all)
    assert res.shed_groups
    stats = res.stream_stats()
    assert plain(stats) == plain(shed_all(REF)[0].stream_stats())
    for st in stats.values():
        assert st.n_live >= 0
        assert not math.isnan(st.latency_mean) and not math.isnan(st.latency_p99)
        assert st.finish >= 0.0
        if st.n_live == 0:
            assert st.latency_mean == 0.0 and st.latency_max == 0.0
    res2, _ = same_run(lambda ns: ns.simulate_traffic(ns.TOPOS[TOPO], _graph(ns)))
    assert all(st.n_live == -1 for st in res2.stream_stats().values())


def test_simulate_validates_admission_arguments():
    msg = raises_alike(lambda ns: ns.simulate(ns.TOPOS[TOPO], [],
                                              admission=ns.AdmissionController([0])))
    assert "admission requires deps" in msg


# --------------------------------------------------------------------------
# SloDebtArbiter: the debted integrator
# --------------------------------------------------------------------------
def _debt_arb(ns, **kw):
    specs = [ns.TenantSpec("a", slo_slowdown=2.0), ns.TenantSpec("b")]
    return ns.SloDebtArbiter(specs, isolated_latency={"a": 1.0}, **kw)


def _debt_twins(**kw):
    return _both(lambda ns: _debt_arb(ns, **kw))


def _same_boosts(arbs, *tenants):
    got, want = arbs
    for t in tenants:
        assert (got.debt(t), got.boost(t), got.effective_weight(t)) == (
            want.debt(t), want.boost(t), want.effective_weight(t))


def test_slo_debt_validation():
    for kw, msg in ((dict(horizon_s=0.0), "horizon_s"), (dict(gain=-1.0), "gain"),
                    (dict(alpha=0.0), "alpha"), (dict(deadband=-0.1), "deadband")):
        assert msg in raises_alike(lambda ns, k=kw: _debt_arb(ns, **k))
    assert _debt_arb(PORT).policy == "weighted-fair"


def test_slo_debt_boost_integrates_and_decays():
    arbs = _debt_twins(horizon_s=10.0, gain=1.0, alpha=1.0, deadband=0.0)
    arb = arbs[0]
    for a in arbs:
        a.on_enqueued(0, "a", 1.0)
    assert arb.boost("a") == 1.0
    for a in arbs:
        a.on_group_finish(0, "a", 5.0)
    _same_boosts(arbs, "a")
    assert arb.debt("a") == pytest.approx(3.0)
    assert arb.boost("a") == pytest.approx(4.0)
    assert arb.effective_weight("a") == pytest.approx(4.0)
    for a in arbs:
        a.on_enqueued(0, "a", 20.0)
    _same_boosts(arbs, "a")
    assert arb.debt("a") == 0.0 and arb.boost("a") == pytest.approx(1.0)
    for a in arbs:
        a.on_group_finish(1, "b", 100.0)
    _same_boosts(arbs, "a", "b")
    assert arb.boost("b") == 1.0


def test_slo_debt_damping_and_deadband():
    arbs = _debt_twins(horizon_s=100.0, gain=1.0, alpha=0.5, deadband=0.0)
    for a in arbs:
        a.on_enqueued(0, "a", 1.0)
        a.on_group_finish(0, "a", 4.0)
    _same_boosts(arbs, "a")
    assert arbs[0].boost("a") == pytest.approx(2.0)
    for a in arbs:
        a.on_enqueued(0, "a", 1.1)
    _same_boosts(arbs, "a")
    assert arbs[0].boost("a") == pytest.approx(2.5)
    frozen = _debt_twins(horizon_s=100.0, alpha=0.3, deadband=0.9)
    for a in frozen:
        a.on_enqueued(0, "a", 1.0)
        a.on_group_finish(0, "a", 2.2)
    _same_boosts(frozen, "a")
    assert frozen[0].boost("a") == 1.0


def test_slo_debt_max_boost_clamp_and_state():
    arbs = _debt_twins(horizon_s=100.0, gain=10.0, max_boost=3.0, alpha=1.0, deadband=0.0)
    for a in arbs:
        a.on_enqueued(0, "a", 1.0)
        a.on_group_finish(0, "a", 50.0)
    _same_boosts(arbs, "a")
    assert arbs[0].boost("a") == pytest.approx(3.0)
    state = arbs[0].discipline_state()
    assert state == arbs[1].discipline_state()
    assert state["policy"] == "weighted-fair" and state["discipline"] == "slo-debt"
    assert state["boosts"]["a"] == pytest.approx(3.0)


# --------------------------------------------------------------------------
# calibrate_admission (observe -> actuate)
# --------------------------------------------------------------------------
def test_calibrate_admission_from_traced_run():
    def calibrate(ns):
        g = _graph(ns)
        trc = ns.Tracer()
        res, _ = ns.simulate_traffic(ns.TOPOS[TOPO], g, tracer=trc)
        tl = ns.BwTimeline.from_tracer(trc)
        n_req = sum(1 for n in g.nodes if n.name.endswith("prefill-compute"))
        out = ns.calibrate_admission(tl, window_s=res.makespan / 8, n_requests=n_req,
                                     target_depth=2.0, chunks_per_unit=64.0 * 5)
        return g, tl, n_req, out

    (g, tl, n_req, out), (_, _, _, want) = _both(calibrate)
    assert out == want
    assert out["capacity"] >= 1
    assert out["est_service_s"] == pytest.approx(tl.makespan / n_req)
    assert out["peak_depth"] > 0
    assert 0 < out["busiest_dim_share"] <= 1.0 + 1e-9
    with pytest.raises(ValueError, match="n_requests"):
        PORT.calibrate_admission(tl, window_s=1.0, n_requests=0)
    with pytest.raises(ValueError, match="chunks_per_unit"):
        PORT.calibrate_admission(tl, window_s=1.0, n_requests=1, chunks_per_unit=0.0)
    ctl = PORT.AdmissionController([0] * len(g.nodes), capacity=int(out["capacity"]))
    assert ctl.capacity == out["capacity"]


# --------------------------------------------------------------------------
# Admission on the engines (tests/test_engine_equiv.py's fleet cases)
# --------------------------------------------------------------------------
def _fleet_graph(ns, rate=250.0, horizon=0.2, seed=5):
    tenants = [
        ns.FleetTenant("web", ns.PoissonArrivals(rate, seed=seed),
                       serving=dict(gen_tokens=6, **OVERLOAD_COSTS), weight=2.0),
        ns.FleetTenant("batch", ns.MMPPArrivals((0.2 * rate, 2.0 * rate), (0.04, 0.04),
                                                seed=seed + 1),
                       serving=dict(gen_tokens=4, **OVERLOAD_COSTS), priority=-1)]
    return ns.fleet_traffic(tenants, horizon_s=horizon)


def test_arrival_processes_are_seed_deterministic_and_restateable():
    def procs(ns):
        return [ns.PoissonArrivals(120.0, seed=3),
                ns.DiurnalArrivals(120.0, amplitude=0.7, period_s=0.5, seed=4),
                ns.MMPPArrivals((40.0, 400.0), (0.05, 0.02), seed=5)]

    for p, j_p in zip(*_both(procs)):
        a = p.times(horizon_s=0.4)
        assert a == p.times(horizon_s=0.4) == j_p.times(horizon_s=0.4)
        assert all(t2 > t1 for t1, t2 in zip(a, a[1:]))
    assert (PORT.PoissonArrivals(120.0, seed=3).times(horizon_s=0.4)
            != PORT.PoissonArrivals(120.0, seed=9).times(horizon_s=0.4))


# the reference engine takes about 35 s a package on this graph (one CPU core)
@pytest.mark.parametrize("engine", [pytest.param(e, marks=pytest.mark.slow)
                                    if e == "reference" else e for e in ENGINES])
def test_fleet_traffic_runs_as_the_reference_engine(engine):
    graph = _fleet_graph(PORT)
    assert graph.nodes == _fleet_graph(PORT).nodes
    assert plain(graph.nodes) == plain(_fleet_graph(REF).nodes)
    same_run(lambda ns: ns.simulate_traffic(ns.TOPOS[TOPO], _fleet_graph(ns), engine=engine,
                                            check_invariants=True))


def _admission_run(ns, engine, policy="reject-newest", tracer=None, faults=None, check=True):
    graph = _fleet_graph(ns, rate=350.0)
    uo, up = ns.unit_of_group(graph)
    kw = dict(policy=policy, capacity=3, unit_priority=up)
    if policy == "deadline-aware":
        kw.update(deadline_s=0.05, est_service_s=0.01)
    adm = ns.AdmissionController(uo, **kw)
    res, _ = ns.simulate_traffic(ns.TOPOS[TOPO], graph, engine=engine, admission=adm,
                                 tracer=tracer, faults=faults(ns) if faults else None,
                                 check_invariants=check)
    return res, adm


def _same_admission(engine, **kw):
    """The run under admission equals the reference engine's, controller's
    books included; returns the port's (result, controller)."""
    (res, adm), (j_res, j_adm) = _both(lambda ns: _admission_run(ns, engine, **kw))
    assert_same(res, j_res)
    assert (adm.n_admitted, adm.n_shed, adm.shed_units) == (
        j_adm.n_admitted, j_adm.n_shed, j_adm.shed_units)
    return res, adm


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", ["reject-newest", "shed-lowest-priority", "deadline-aware"])
def test_engines_under_admission_equal_the_reference(policy, engine):
    res, adm = _same_admission(engine, policy=policy)
    assert adm.n_shed > 0 and res.shed_groups


@pytest.mark.parametrize("engine", ENGINES)
def test_admission_decisions_invariant_under_tracer(engine):
    """Arming the port's flight recorder moves no admission decision, and
    its trace records the reference's sheds and admits."""
    untraced, adm = _same_admission(engine, check=False)
    trc, j_trc = PORT.Tracer(), REF.Tracer()
    traced, adm_t = _admission_run(PORT, engine, check=False, tracer=trc)
    j_traced, _ = _admission_run(REF, engine, check=False, tracer=j_trc)
    assert_same(traced, j_traced)
    assert_same(traced, untraced)
    assert (adm_t.n_shed, adm_t.shed_units) == (adm.n_shed, adm.shed_units)
    assert len(trc.sheds) == len(traced.shed_groups)
    assert len(trc.admits) == adm_t.n_admitted
    assert plain(trc.sheds) == plain(j_trc.sheds) and plain(trc.admits) == plain(j_trc.admits)
    counts = trc.event_counts()
    assert counts == j_trc.event_counts()
    assert counts["sheds"] == len(trc.sheds) and counts["admits"] == len(trc.admits)


@pytest.mark.parametrize("engine", ENGINES)
def test_admission_composes_with_faults_as_the_reference(engine):
    def faults(ns):
        return ns.FaultSchedule(events=(ns.DimOutage(dim=1, start=0.03, end=0.06),),
                                retry=ns.RetryPolicy(timeout_s=0.02, backoff_s=0.005,
                                                     max_attempts=6))

    res, _ = _same_admission(engine, faults=faults)
    assert res.shed_groups and sum(res.group_retries) > 0
    assert {g for g, _ in res.shed_groups}.isdisjoint({g for g, _ in res.failed_groups})


# --------------------------------------------------------------------------
# chip_smoke.py's phase_fleet against benchmarks/fleet_study.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def calib():
    """``chip_smoke.fleet_calibrate`` at full size equals the study's
    ``calibrate_part``; both are cheap, so the later parts start from it."""
    cs, fs = chip_smoke(), study("fleet_study")
    assert cs.FLEET_COSTS == fs.COSTS
    assert (cs.P99_GATE, cs.GOODPUT_GATE) == (fs.P99_GATE, fs.GOODPUT_GATE)
    got, want = cs.fleet_calibrate(), fs.calibrate_part(False)[0]
    assert got == want
    return got


def test_chip_smoke_fleet_calibrate_equals_fleet_study(calib):
    readings = {k: v for k, v in chip_smoke().FLEET_READINGS.items()
                if k in ("sat_rate_rps", "capacity", "est_service_s")}
    assert readings == {"sat_rate_rps": f"{calib['sat_rate_rps']:.0f}",
                        "capacity": calib["capacity"],
                        "est_service_s": f"{calib['est_service_s']:.2e}"}


def test_chip_smoke_fleet_knee_equals_fleet_study_at_quick_size(calib):
    """The knee at the study's quick loads (0.75, 1.0, 1.5x): every point's
    p99, goodput and shed rate and the three gates."""
    got = chip_smoke().fleet_knee(calib, quick=True)
    assert got == study("fleet_study").knee_part(True, calib)[0]
    assert all(got["gates"].values())


def test_chip_smoke_fleet_differential_equals_fleet_study_at_quick_size(calib):
    """The four overload scenarios at the quick horizon: the port's indexed
    equals its reference on each, compiled equals indexed, and the shed
    counts equal the study's."""
    got = chip_smoke().fleet_differential(calib, quick=True)
    assert got["compiled_equal_indexed"] == [True] * 4
    want = study("fleet_study").differential_part(True, calib)[0]
    assert {k: v for k, v in got.items() if k != "compiled_equal_indexed"} == want
    assert got["total_shed_groups"] > 0


def test_chip_smoke_fleet_slo_debt_equals_fleet_study_at_quick_size():
    cs, fs = chip_smoke(), study("fleet_study")
    got = cs.fleet_slo_debt(quick=True)
    assert got == fs.slo_debt_part(True)[0]
    assert got["wins"] >= got["needed"]
    assert [t["topology"] for t in got["topologies"]] == list(cs.FLEET_SLO_TOPOLOGIES[:2])
