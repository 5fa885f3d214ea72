"""The port's prover (``repro_torch.verify``) against the reference's, on the
CPU.

Mirrors ``tests/test_verify.py`` (the expression layer, the engine witness
against the declarative model, the verdicts over the default instances,
counterexample replay, the pinned virtual-time staleness regression, the
optional z3 backend). Each instance is encoded once per package from the
same numbers, and the port's witnesses, constraints and reports equal the
reference's as plain values, each port engine against the **same**
reference engine. Also: the port's ``TraceRecorder`` runs on the port's
indexed engine, and ``chip_smoke.py``'s ``phase_verify`` equals
``benchmarks/verify_study.py``.
"""
import pytest
from _sim_twins import PORT, REF, assert_same, chip_smoke, plain, raises_alike, study

MB = 1e6


def _props(ns):
    return {p.name: p for p in ns.ALL_PROPERTIES}


def _instances(ns):
    return {i.name: i for i in ns.default_instances()}


def _same_encoding(enc, want):
    """The port's encoding equals the reference's: the engine's result, the
    witness and every constraint."""
    assert_same(enc.result, want.result)
    assert enc.env == want.env
    assert plain(enc.constraints) == plain(want.constraints)
    assert plain(enc.requests) == plain(want.requests)
    assert (enc.op_count, enc.expected_wire, enc.total_wire) == (
        want.op_count, want.expected_wire, want.total_wire)


# --------------------------------------------------------------------------
# Expression layer
# --------------------------------------------------------------------------
def test_smt_evaluate_arithmetic_and_logic():
    env = {"x": 3.0, "y": -2.0}
    for ns in (PORT, REF):
        V = ns.Var
        e = (V("x") * 2 + V("y")) / 4
        got = (ns.evaluate(e, env), ns.evaluate(ns.Max(V("x"), V("y"), 5), env),
               ns.evaluate(ns.Min(V("x"), V("y")), env), ns.evaluate(ns.Abs(V("y")), env),
               ns.evaluate(ns.And(V("x") > 0, ns.Not(V("y") > 0)), env),
               ns.evaluate(ns.Implies(V("x") > 10, V("y") > 0), env),
               ns.evaluate(V("x").eq(V("y")), env), ns.free_vars(e), repr(e))
        assert got == (pytest.approx(1.0), 5.0, -2.0, 2.0, True, True, False, {"x", "y"},
                       "(((x * 2) + y) / 4)")


# --------------------------------------------------------------------------
# Encoding: the engine witness must satisfy the declarative model
# --------------------------------------------------------------------------
def test_every_default_instance_encodes_and_validates():
    insts, j_insts = PORT.default_instances(), REF.default_instances()
    assert plain(insts) == plain(j_insts)
    assert len(insts) >= 3
    n_assignments = 0
    for inst, j_inst in zip(insts, j_insts):
        for assignment in inst.assignments(quick=True):
            enc = PORT.encode_assignment(inst, assignment)
            PORT.validate_encoding(enc)
            _same_encoding(enc, REF.encode_assignment(j_inst, assignment))
            n_assignments += 1
            assert enc.constraints and enc.env
            for c in enc.constraints:
                assert PORT.free_vars(c) <= set(enc.env)
    assert n_assignments >= 6


@pytest.mark.parametrize("engine", ["reference", "indexed"])
def test_encoding_equals_the_reference_engine(engine):
    """Each port engine's encoding equals the same reference engine's; and,
    as in the reference, the port's two engines give one witness."""
    inst, j_inst = PORT.default_instances()[0], REF.default_instances()[0]
    assignment = inst.assignments()[0]
    enc = PORT.encode_assignment(inst, assignment, engine=engine)
    _same_encoding(enc, REF.encode_assignment(j_inst, assignment, engine=engine))
    other = PORT.encode_assignment(inst, assignment,
                                   engine="indexed" if engine == "reference" else "reference")
    assert enc.result.diff_fields(other.result) == []
    assert enc.env == other.env


# --------------------------------------------------------------------------
# Prover verdicts over the default suite
# --------------------------------------------------------------------------
def test_suite_decides_all_properties_with_expected_verdicts():
    rep = PORT.verify_suite(quick=True)
    assert plain(rep) == plain(REF.verify_suite(quick=True))
    assert rep["n_instances"] >= 3
    assert len(rep["properties_decided"]) >= 4
    verdicts = {(v["instance"], v["property"]): v for v in rep["verdicts"]}
    for (inst, prop), v in verdicts.items():
        if prop in ("work_conservation", "bytes_conservation", "no_lost_chunks",
                    "starvation_freedom"):
            assert v["status"] == "proved", (inst, prop)
    assert verdicts[("wf-rearrival-clamped", "bounded_slowdown")]["status"] == "proved"
    stale = verdicts[("wf-rearrival-stale", "bounded_slowdown")]
    assert stale["status"] == "refuted" and stale["counterexamples"]
    assert verdicts[("fifo-mixed", "bounded_slowdown")]["status"] == "refuted"
    for v in rep["verdicts"]:
        if v["status"] == "refuted":
            assert v["replays"], (v["instance"], v["property"])
            for r in v["replays"]:
                assert r["engines_bit_identical"]
                assert r["violated_on"] == ["indexed", "reference"]
                assert r["requests"]


def test_verify_suite_equals_the_reference_report():
    """The full grid (what ``verify_study.py`` runs): 24 decisions, 22
    proved, 2 refuted, 2 replays, equal to the reference's report."""
    rep = PORT.verify_suite()
    assert plain(rep) == plain(REF.verify_suite())
    assert (rep["n_decided"], rep["n_proved"], rep["n_refuted"]) == (24, 22, 2)
    assert sum(len(v["replays"]) for v in rep["verdicts"]) == 2


def test_replay_counterexample_rejects_non_violating_assignment():
    msg = raises_alike(lambda ns: ns.replay_counterexample(
        _instances(ns)["wf-rearrival-clamped"], {"rearrive": 3e-4},
        _props(ns)["bounded_slowdown"]), AssertionError)
    assert "did not reproduce" in msg


def test_trace_recorder_runs_on_the_indexed_engine():
    """The port's recorder is the port's ``FabricArbiter``, so the port's
    indexed engine takes it and a replay compares two engines; the
    reference's recorder would fall back to the port's reference engine."""
    inst, j_inst = _instances(PORT)["wf-rearrival-stale"], _instances(REF)["wf-rearrival-stale"]
    rec = inst.build_arbiter({"rearrive": 6e-4})
    assert isinstance(rec, PORT.TraceRecorder) and isinstance(rec, PORT.FabricArbiter)
    assert PORT._arbiter_indexable(rec)
    assert not PORT._arbiter_indexable(j_inst.build_arbiter({"rearrive": 6e-4}))
    assert PORT._arbiter_indexable(inst.build_arbiter({"rearrive": 6e-4}, recorder=False))


# --------------------------------------------------------------------------
# The pinned solver-derived regression: weighted-fair vt staleness
# --------------------------------------------------------------------------
def _staleness_instance(ns, vt_clamp):
    reqs = [ns.RequestTemplate("a", 1 * MB, 0.0)]
    reqs += [ns.RequestTemplate("b", 4 * MB, i * 1e-6) for i in range(8)]
    reqs += [ns.RequestTemplate("a", 4 * MB, ("rearrive", i * 1e-6)) for i in range(4)]
    return ns.FabricInstance(
        name=f"pinned-vt-staleness-{'fixed' if vt_clamp else 'bug'}",
        tenants=(ns.TenantSpec("a", weight=1.0), ns.TenantSpec("b", weight=1.0)),
        requests=tuple(reqs), policy="weighted-fair", quantum_chunks=2, preemption=True,
        vt_clamp=vt_clamp, chunks_per_collective=2,
        free=(ns.FreeVar("rearrive", (6e-4,)),), slowdown_window_start="rearrive",
        contended_dim=0, slowdown_slack_quanta=2.0)


def test_vt_staleness_counterexample_is_pinned():
    cex = {"rearrive": 6e-4}
    replay = PORT.replay_counterexample(_staleness_instance(PORT, False), cex,
                                        _props(PORT)["bounded_slowdown"])
    assert replay == REF.replay_counterexample(_staleness_instance(REF, False), cex,
                                               _props(REF)["bounded_slowdown"])
    assert replay["violated_on"] == ["indexed", "reference"]
    for eng in ("reference", "indexed"):
        enc = PORT.encode_assignment(_staleness_instance(PORT, True), cex, engine=eng)
        PORT.validate_encoding(enc)
        _same_encoding(enc, REF.encode_assignment(_staleness_instance(REF, True), cex,
                                                  engine=eng))
        assert PORT.evaluate(PORT.bounded_slowdown(enc), enc.env)


class _T:
    def __init__(self, tenant, wire):
        self.tenant, self.wire_bytes = tenant, wire
        self.fixed_delay, self.op_id = 0.0, (0, 0)


def _two_services_then_rearrival(ns, **kw):
    arb = ns.FabricArbiter("weighted-fair", [ns.TenantSpec("a"), ns.TenantSpec("b")], **kw)
    arb.on_served(0, [_T("b", 10.0)], now=0.0)
    arb.on_served(0, [_T("b", 10.0)], now=1.0)
    arb.on_enqueued(0, "a", now=2.0)
    return arb


def test_vt_clamp_hooks_and_snapshot():
    arb, j_arb = _two_services_then_rearrival(PORT), _two_services_then_rearrival(REF)
    assert arb.vt_clamp
    assert arb.virtual_time(0, "a") == pytest.approx(arb.vt_floor(0))
    assert arb.vt_floor(0) == pytest.approx(10.0)
    assert arb.served_snapshot()[(0, "b")] == pytest.approx(20.0)
    assert (arb.virtual_time(0, "a"), arb.vt_floor(0), arb.served_snapshot(),
            arb.discipline_state()) == (j_arb.virtual_time(0, "a"), j_arb.vt_floor(0),
                                        j_arb.served_snapshot(), j_arb.discipline_state())
    stale = _two_services_then_rearrival(PORT, vt_clamp=False)
    assert stale.virtual_time(0, "a") == 0.0
    assert stale.discipline_state() == _two_services_then_rearrival(
        REF, vt_clamp=False).discipline_state()


# --------------------------------------------------------------------------
# Optional z3 backend: must agree with the native witness decision
# --------------------------------------------------------------------------
def test_z3_backend_agrees_with_native_when_installed():
    pytest.importorskip("z3")
    insts, props = _instances(PORT), _props(PORT)
    for name, prop, want in (("wf-rearrival-clamped", "bounded_slowdown", "proved"),
                             ("wf-rearrival-stale", "bounded_slowdown", "refuted"),
                             ("sp-preempt", "starvation_freedom", "proved")):
        v_native = PORT.decide_property(insts[name], props[prop], quick=True,
                                        backend="native", replay=False)
        v_z3 = PORT.decide_property(insts[name], props[prop], quick=True, backend="z3",
                                    replay=False)
        assert v_native.status == want and v_z3.status == want
        assert "z3" in v_z3.backends


# --------------------------------------------------------------------------
# chip_smoke.py's phase_verify against benchmarks/verify_study.py
# --------------------------------------------------------------------------
def test_chip_smoke_verify_prover_equals_verify_study():
    cs, vs = chip_smoke(), study("verify_study")
    assert cs.VERIFY_EXPECTED_REFUTED == vs.EXPECTED_REFUTED
    rep, flipped, unreplayed = cs.verify_prover()
    assert rep == vs.prover_part(False)[0]
    assert flipped == [] and unreplayed == []
    assert {"n_decided": rep["n_decided"], "n_proved": rep["n_proved"],
            "n_refuted": rep["n_refuted"],
            "replays": sum(len(v["replays"]) for v in rep["verdicts"])} == cs.VERIFY_READINGS


def test_chip_smoke_verify_sanitizer_leaves_results_unchanged():
    out = chip_smoke().verify_sanitizer(quick=True)
    assert set(out) == {"indexed", "reference"}
    for r in out.values():
        assert r["results_identical"]
        assert r["off_s"] > 0 and r["on_s"] > 0


def test_chip_smoke_verify_z3_reports_nothing_without_z3(monkeypatch):
    """``phase_verify`` decides with the witness backend, as the study's
    recorded run did, and prints z3's verdicts only where z3 is importable."""
    import repro_torch.verify

    cs = chip_smoke()
    assert cs.VERIFY_BACKEND == "native"
    monkeypatch.setattr(repro_torch.verify, "z3_available", lambda: False)
    assert cs.verify_z3() is None
