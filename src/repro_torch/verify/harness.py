"""Prove/refute fairness properties per instance; replay counterexamples.

``decide_property`` sweeps an instance's free-variable grid: each
assignment is encoded (:func:`encode_assignment` — which runs the real
engine with the runtime sanitizer armed), the witness is validated
against the constraint system, and ``constraints => property`` is
decided (witness evaluation, or a z3 linear-arithmetic proof when
installed).  A property is **proved** on the instance when it holds for
every assignment, **refuted** when some assignment violates it.

Every refutation round-trips: :func:`replay_counterexample` rebuilds the
violating assignment as a concrete ``CollectiveRequest`` stream and
replays it through ``simulate_requests`` on *both* engines, asserting
(a) the two engines agree bit-identically and (b) the property is
violated on each — so every counterexample the solver finds is
automatically a differential regression test (``tests/test_verify.py``
pins the virtual-time staleness one permanently).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.tenancy.tenants import TenantSpec
from repro_torch.verify.encode import (
    Encoding,
    FabricInstance,
    FreeVar,
    RequestTemplate,
    encode_assignment,
    validate_encoding,
)
from repro_torch.verify.properties import ALL_PROPERTIES, Property
from repro_torch.verify.smt import solve_encoding, z3_available


@dataclass
class PropertyVerdict:
    instance: str
    prop: str
    status: str                      # "proved" | "refuted"
    n_assignments: int
    counterexamples: list = field(default_factory=list)
    backends: tuple = ()
    replays: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "instance": self.instance,
            "property": self.prop,
            "status": self.status,
            "n_assignments": self.n_assignments,
            "counterexamples": self.counterexamples,
            "backends": sorted(self.backends),
            "replays": self.replays,
        }


def decide_property(inst: FabricInstance, prop: Property,
                    quick: bool = False, backend: str = "auto",
                    replay: bool = True,
                    encodings: list | None = None) -> PropertyVerdict:
    """Decide one property over the instance's assignment grid."""
    if encodings is None:
        encodings = build_encodings(inst, quick)
    cexs = []
    backends = set()
    for enc in encodings:
        holds, used = solve_encoding(
            enc.constraints, prop.formula(enc), enc.env, backend)
        backends.add(used)
        if not holds:
            cexs.append(dict(enc.assignment))
    verdict = PropertyVerdict(
        instance=inst.name, prop=prop.name,
        status="proved" if not cexs else "refuted",
        n_assignments=len(encodings),
        counterexamples=cexs, backends=tuple(backends))
    if cexs and replay:
        verdict.replays.append(replay_counterexample(inst, cexs[0], prop))
    return verdict


def build_encodings(inst: FabricInstance,
                    quick: bool = False) -> list[Encoding]:
    """Encode + validate every assignment on the instance's grid."""
    out = []
    for assignment in inst.assignments(quick):
        enc = encode_assignment(inst, assignment)
        validate_encoding(enc)
        out.append(enc)
    return out


def replay_counterexample(inst: FabricInstance, assignment: dict,
                          prop: Property) -> dict:
    """Round-trip a violating assignment into a ``simulate_requests``
    replay on both engines; assert the engines agree bit-identically and
    the property is violated on each."""
    from repro_torch.verify.smt import evaluate

    encs = {eng: encode_assignment(inst, assignment, engine=eng)
            for eng in ("reference", "indexed")}
    diff = encs["reference"].result.diff_fields(encs["indexed"].result)
    violated = {eng: not bool(evaluate(prop.formula(enc), enc.env))
                for eng, enc in encs.items()}
    if diff:
        raise AssertionError(
            f"{inst.name} {assignment}: counterexample replay diverged "
            f"between engines on fields {diff}")
    if not all(violated.values()):
        raise AssertionError(
            f"{inst.name} {assignment}: counterexample did not reproduce "
            f"the {prop.name} violation on both engines: {violated}")
    req = encs["reference"].requests
    return {
        "assignment": dict(assignment),
        "requests": [
            {"tenant": r.tenant, "size_bytes": r.size_bytes,
             "issue_time": r.issue_time, "priority": r.priority}
            for r in req],
        "violated_on": sorted(k for k, v in violated.items() if v),
        "engines_bit_identical": True,
    }


def verify_suite(instances=None, properties=None, quick: bool = False,
                 backend: str = "auto", replay: bool = True) -> dict:
    """Decide every applicable (instance, property) pair; the report
    shape is what ``benchmarks/verify_study.py`` serializes."""
    if instances is None:
        instances = default_instances()
    if properties is None:
        properties = ALL_PROPERTIES
    verdicts = []
    for inst in instances:
        encodings = build_encodings(inst, quick)
        for prop in properties:
            if not prop.applies(inst):
                continue
            verdicts.append(decide_property(
                inst, prop, quick=quick, backend=backend, replay=replay,
                encodings=encodings))
    return {
        "z3_available": z3_available(),
        "quick": quick,
        "n_instances": len(instances),
        "n_decided": len(verdicts),
        "n_proved": sum(v.status == "proved" for v in verdicts),
        "n_refuted": sum(v.status == "refuted" for v in verdicts),
        "properties_decided": sorted({v.prop for v in verdicts}),
        "verdicts": [v.as_dict() for v in verdicts],
    }


# ---------------------------------------------------------------------------
# The default instance suite.
# ---------------------------------------------------------------------------
MB = 1e6


def _wf_rearrival(vt_clamp: bool) -> FabricInstance:
    """Weighted-fair, equal weights; tenant ``a`` idles then re-arrives
    with a burst while ``b`` stays backlogged.  With the SFQ clamp off,
    ``a``'s stale (low) virtual time lets it monopolize the fabric until
    its clock catches up — bounded_slowdown is refuted.  With the clamp
    on, ``a`` re-enters at the dim's current virtual clock and the
    tenants share by weight — proved."""
    suffix = "clamped" if vt_clamp else "stale"
    reqs = [RequestTemplate("a", 1 * MB, 0.0)]
    reqs += [RequestTemplate("b", 4 * MB, i * 1e-6) for i in range(8)]
    reqs += [RequestTemplate("a", 4 * MB, ("rearrive", i * 1e-6))
             for i in range(4)]
    return FabricInstance(
        name=f"wf-rearrival-{suffix}",
        tenants=(TenantSpec("a", weight=1.0), TenantSpec("b", weight=1.0)),
        requests=tuple(reqs),
        policy="weighted-fair",
        quantum_chunks=2,
        preemption=True,
        vt_clamp=vt_clamp,
        chunks_per_collective=2,
        free=(FreeVar("rearrive", (3e-4, 6e-4)),),
        slowdown_window_start="rearrive",
        contended_dim=0,
        slowdown_slack_quanta=2.0,
        notes="virtual-time staleness on idle->busy re-arrival",
    )


def _sp_preempt() -> FabricInstance:
    """Strict-priority with chunk-granularity preemption and a re-arm
    penalty grid: finite high-priority load must not starve the
    low-priority tenant, and preemption splits must conserve bytes."""
    reqs = [RequestTemplate("lo", 8 * MB, 0.0)]
    reqs += [RequestTemplate("hi", 1 * MB, 5e-5 + i * 1e-4)
             for i in range(3)]
    return FabricInstance(
        name="sp-preempt",
        tenants=(TenantSpec("lo", priority=0), TenantSpec("hi", priority=10)),
        requests=tuple(reqs),
        policy="strict-priority",
        quantum_chunks=4,
        preemption=True,
        preempt_penalty_s="penalty",
        chunks_per_collective=2,
        free=(FreeVar("penalty", (0.0, 2e-5)),),
        notes="preemption + re-arm penalty under strict priority",
    )


def _fifo_mixed() -> FabricInstance:
    """FIFO with unequal weights: arrival order ignores weights, so the
    weight-proportional-share property is expected to be refuted (the
    conservation and starvation properties still hold)."""
    reqs = []
    for i in range(4):
        reqs.append(RequestTemplate("a", 4 * MB, i * 2e-6))
        reqs.append(RequestTemplate("b", 4 * MB, 1e-6 + i * 2e-6))
    return FabricInstance(
        name="fifo-mixed",
        tenants=(TenantSpec("a", weight=1.0), TenantSpec("b", weight=4.0)),
        requests=tuple(reqs),
        policy="fifo",
        quantum_chunks=2,
        preemption=False,
        chunks_per_collective=2,
        slowdown_slack_quanta=2.0,
        contended_dim=0,
        notes="fifo ignores weights: fairness refuted, conservation holds",
    )


def _wf_preempt() -> FabricInstance:
    """Weighted-fair + preemption + penalty grid: the conservation and
    work-conservation theorems across preemption splits."""
    reqs = [RequestTemplate("big", 8 * MB, 0.0),
            RequestTemplate("big", 8 * MB, 1e-6)]
    reqs += [RequestTemplate("small", 1 * MB, 1e-4 + i * 2e-4)
             for i in range(4)]
    return FabricInstance(
        name="wf-preempt",
        tenants=(TenantSpec("big", weight=1.0),
                 TenantSpec("small", weight=4.0)),
        requests=tuple(reqs),
        policy="weighted-fair",
        quantum_chunks=4,
        preemption=True,
        preempt_penalty_s="penalty",
        chunks_per_collective=2,
        free=(FreeVar("penalty", (0.0, 1e-5, 2e-5)),),
        slowdown_slack_quanta=8.0,
        notes="byte conservation across weighted-fair preemption splits",
    )


def default_instances() -> list[FabricInstance]:
    return [
        _wf_rearrival(vt_clamp=True),
        _wf_rearrival(vt_clamp=False),
        _sp_preempt(),
        _fifo_mixed(),
        _wf_preempt(),
    ]
