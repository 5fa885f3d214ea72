"""Encode small fabric instances as constraints over service variables.

A :class:`FabricInstance` is a tiny multi-tenant workload (2-3 tenants,
2 dims, a few chunks per collective) with one arbiter discipline and a
grid of *free variables* (re-arrival times, sizes, preemption penalties).
For each assignment of the free variables, :func:`encode_assignment`
produces an :class:`Encoding`: a constraint system over named real
variables that mirrors the engines' semantics —

  * ``S_d_k`` / ``F_d_k`` — start/finish of the k-th service on dim d,
    linked by the rate equation ``F == S + bytes/bw`` (preemption-shrunk
    services keep only the bytes that drained), per-dim non-overlap
    ``F_k <= S_{k+1}``, and chunk-chain readiness ``S >= F_prev + A``
    (a stage readies only after its predecessor's service drains plus the
    fixed latency; chunks cut by a preemption with ``preempt_penalty_s``
    re-ready only after the re-arm penalty);
  * ``C_g`` — completion of request g, the max over its chunks' final
    stage done-times;
  * ``VT_d_T_i`` / ``FL_d_j`` — the weighted-fair virtual-time chains and
    per-dim SFQ floor, advanced exactly as ``FabricArbiter`` advances
    them (service increments, preemption refunds, and — when ``vt_clamp``
    is on — the arrival clamp ``VT' == max(VT, FL)``), plus the
    discipline's order condition: at each fair service start the served
    tenant's virtual time is <= every other pending tenant's.

The *witness* for the system is the real engine's trace: the instance is
run through ``simulate_requests`` (with ``check_invariants=True``, so the
runtime sanitizer is armed during witness generation) under a
:class:`TraceRecorder` arbiter that logs every hook call.  The witness
values of all variables come from that trace; :func:`validate_encoding`
asserts the witness satisfies every constraint — this is the
model-vs-engine cross-check.  Because every variable is pinned by an
equality chain rooted in instance constants (the system is functionally
determined), a property can then be decided by witness evaluation alone;
with z3 installed the harness instead proves ``constraints => property``
in linear real arithmetic (see :mod:`repro_torch.verify.smt`).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.simulator import SimResult, build_task_arrays, simulate_requests
from repro_torch.tenancy.arbiter import FabricArbiter
from repro_torch.tenancy.tenants import TenantSpec
from repro_torch.topology.algorithms import TopoKind
from repro_torch.topology.topology import NetworkDim, Topology
from repro_torch.verify import smt
from repro_torch.verify.smt import Const, Max, Min, Sum, Var

_EPS = 1e-12


def small_topology(name: str = "verify-2d", npus: tuple[int, int] = (4, 4),
                   gbps: tuple[float, float] = (200.0, 100.0)) -> Topology:
    """A tiny 2-dim switch topology for verification instances."""
    return Topology(name, (
        NetworkDim(npus[0], TopoKind.SWITCH, gbps[0], 1, 700e-9),
        NetworkDim(npus[1], TopoKind.SWITCH, gbps[1], 1, 1700e-9),
    ))


@dataclass(frozen=True)
class FreeVar:
    """One free variable of an instance: a name plus its finite domain."""

    name: str
    values: tuple[float, ...]


@dataclass(frozen=True)
class RequestTemplate:
    """A request whose size/issue time may be a constant, a free-variable
    name, or an offset ``(name, delta)`` from a free variable."""

    tenant: str
    size_bytes: float | str | tuple = 4e6
    issue_time: float | str | tuple = 0.0
    stream: str = ""
    priority: int = 0


def _resolve(v, assignment: dict) -> float:
    if isinstance(v, str):
        return assignment[v]
    if isinstance(v, tuple):
        name, delta = v
        return assignment[name] + delta
    return float(v)


@dataclass(frozen=True)
class FabricInstance:
    """One small verification instance (see module docstring)."""

    name: str
    tenants: tuple[TenantSpec, ...]
    requests: tuple[RequestTemplate, ...]
    policy: str = "weighted-fair"
    quantum_chunks: int = 2
    preemption: bool = True
    preempt_penalty_s: float | str = 0.0
    vt_clamp: bool = True
    chunks_per_collective: int = 2
    free: tuple[FreeVar, ...] = ()
    topology: Topology = field(default_factory=small_topology)
    # Fairness-window start for the bounded-slowdown property: a free-var
    # name (e.g. the re-arrival instant) or a constant; None starts at the
    # latest first-arrival among the audited tenant pair.
    slowdown_window_start: float | str | None = None
    # Contended dim the slowdown property audits (innermost by default).
    contended_dim: int = 0
    # Fairness slack multiplier (units of one quantum of max-size chunks
    # per unit weight); see properties.bounded_slowdown.
    slowdown_slack_quanta: float = 3.0
    notes: str = ""

    def assignments(self, quick: bool = False) -> list[dict]:
        """Every free-variable assignment on the grid (``quick`` keeps at
        most 4 by striding; grid corners are retained)."""
        if not self.free:
            return [{}]
        grids = [fv.values for fv in self.free]
        out = [dict(zip((fv.name for fv in self.free), combo))
               for combo in itertools.product(*grids)]
        if quick and len(out) > 4:
            stride = (len(out) - 1) / 3.0
            keep = sorted({round(i * stride) for i in range(4)})
            out = [out[i] for i in keep]
        return out

    def build_requests(self, assignment: dict) -> list[CollectiveRequest]:
        reqs = [CollectiveRequest(
            collective="AR",
            size_bytes=_resolve(t.size_bytes, assignment),
            issue_time=_resolve(t.issue_time, assignment),
            priority=t.priority,
            tenant=t.tenant,
            stream=t.stream or t.tenant,
        ) for t in self.requests]
        # simulate_requests schedules in list order; keep issue order so a
        # request's index is stable across assignments.
        reqs.sort(key=lambda r: (r.issue_time, r.tenant))
        return reqs

    def build_arbiter(self, assignment: dict,
                      recorder: bool = True) -> FabricArbiter:
        cls = TraceRecorder if recorder else FabricArbiter
        return cls(
            self.policy, self.tenants,
            preemption=self.preemption,
            quantum_chunks=self.quantum_chunks,
            preempt_penalty_s=_resolve(self.preempt_penalty_s, assignment),
            vt_clamp=self.vt_clamp,
        )

    def weight(self, tenant: str) -> float:
        for s in self.tenants:
            if s.name == tenant:
                return max(s.weight, 1e-12)
        return 1.0

    def priority(self, tenant: str) -> int:
        for s in self.tenants:
            if s.name == tenant:
                return s.priority
        return 0


class TraceRecorder(FabricArbiter):
    """A ``FabricArbiter`` that logs every simulator hook call.

    ``order_key`` is untouched, so the indexed engine still bucket-indexes
    this arbiter — recording is identical on both engines.  Events (in
    engine call order, which is deterministic):

      * ``("enq", dim, tenant, t, vt_after)``
      * ``("serve", dim, t, tenant, ops, bytes, fixed, vt_before, incs)``
      * ``("preempt", dim, t, tenant, cut_ops, refund)``
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.events: list[tuple] = []
        self._serving: dict[int, str] = {}

    def on_enqueued(self, dim, tenant, now):
        super().on_enqueued(dim, tenant, now)
        self.events.append(
            ("enq", dim, tenant, now, self.virtual_time(dim, tenant)))

    def on_served(self, dim, batch, now):
        vt_before = self.virtual_time(dim, batch[0].tenant)
        super().on_served(dim, batch, now)
        self._serving[dim] = batch[0].tenant
        self.events.append((
            "serve", dim, now, batch[0].tenant,
            tuple(t.op_id for t in batch),
            tuple(t.wire_bytes for t in batch),
            tuple(t.fixed_delay for t in batch),
            vt_before, dict(self._inflight_inc.get(dim, {}))))

    def on_preempted(self, dim, cut, now):
        incs = self._inflight_inc.get(dim, {})
        refund = sum(incs.get(t.op_id, 0.0) for t in cut)
        super().on_preempted(dim, cut, now)
        self.events.append(("preempt", dim, now, self._serving.get(dim),
                            tuple(t.op_id for t in cut), refund))


@dataclass
class SvcRec:
    """One (possibly preemption-shrunk) service in the witness trace."""

    dim: int
    k: int                     # index within the dim's service sequence
    tenant: str
    ops: list                  # kept op ids, in batch order
    op_bytes: dict             # op id -> wire bytes
    op_fixed: dict             # op id -> fixed delay
    start: float
    end: float
    cuts: list                 # [(t_preempt, cut op ids)], chronological

    @property
    def a(self) -> float:      # done-event latency = max fixed over kept
        return max(self.op_fixed[o] for o in self.ops)

    @property
    def bytes(self) -> float:
        return sum(self.op_bytes[o] for o in self.ops)

    def svar(self) -> Var:
        return Var(f"S_{self.dim}_{self.k}")

    def fvar(self) -> Var:
        return Var(f"F_{self.dim}_{self.k}")


@dataclass
class Encoding:
    """The constraint system + witness for one (instance, assignment)."""

    instance: FabricInstance
    assignment: dict
    engine: str
    requests: list
    result: SimResult
    env: dict                       # witness: var name -> value
    constraints: list               # list[smt.Expr]
    services: list                  # per dim: list[SvcRec]
    op_service: dict                # op id -> SvcRec finally serving it
    op_ready: dict                  # op id -> ground ready time (latest)
    op_count: dict                  # op id -> times served across the run
    expected_ops: dict              # op id -> (dim, wire) for EVERY task of
    #                                 the scheduled groups (served or not —
    #                                 how a lost chunk becomes visible)
    expected_wire: list             # per-dim sum over expected_ops
    total_wire: list                # per-dim sum of kept task wire bytes
    bw: list                        # per-dim bytes/s
    penalty: float
    makespan: float

    def cvar(self, g: int) -> Var:
        return Var(f"C_{g}")

    def tenant_window_bytes(self, tenant: str, dim: int,
                            w0: float, w1: float) -> smt.Expr:
        """Bytes served to ``tenant`` on ``dim`` inside [w0, w1], as a
        symbolic sum of per-service window overlap * bw (a service
        straddling a window edge counts partially — the engines drain a
        batch at a constant rate)."""
        terms = []
        for svc in self.services[dim]:
            if svc.tenant != tenant or svc.end <= w0 or svc.start >= w1:
                continue
            overlap = (Min(svc.fvar(), Const(w1))
                       - Max(svc.svar(), Const(w0)))
            terms.append(Max(Const(0.0), overlap) * Const(self.bw[dim]))
        return Sum(terms)

    def tenant_span(self, tenant: str, dim: int) -> tuple[float, float]:
        """Ground [first ready, last finish] of the tenant's ops on dim."""
        lo, hi = float("inf"), 0.0
        for svc in self.services[dim]:
            if svc.tenant != tenant:
                continue
            for op in svc.ops:
                lo = min(lo, self.op_ready[op])
            hi = max(hi, svc.end)
        return lo, hi


class EncodingError(AssertionError):
    """The engine trace and the declarative model disagree — either an
    engine bug or an encoder bug; both must fail loudly."""


def encode_assignment(inst: FabricInstance, assignment: dict,
                      engine: str = "reference") -> Encoding:
    """Run the instance under a recording arbiter and build the
    constraint system (see module docstring)."""
    requests = inst.build_requests(assignment)
    arb = inst.build_arbiter(assignment, recorder=True)
    res, groups = simulate_requests(
        inst.topology, requests,
        policy="baseline",
        chunks_per_collective=inst.chunks_per_collective,
        arbiter=arb, engine=engine, check_invariants=True)

    num_dims = inst.topology.num_dims
    bw = [d.aggr_bw_bytes for d in inst.topology.dims]
    penalty = _resolve(inst.preempt_penalty_s, assignment)

    # ---- reconstruct per-dim services from the recorder ---------------------
    services: list[list[SvcRec]] = [[] for _ in range(num_dims)]
    op_count: dict = {}
    for ev in arb.events:
        if ev[0] == "serve":
            _, dim, t, tenant, ops, byts, fixeds, _vtb, _incs = ev
            services[dim].append(SvcRec(
                dim=dim, k=len(services[dim]), tenant=tenant,
                ops=list(ops), op_bytes=dict(zip(ops, byts)),
                op_fixed=dict(zip(ops, fixeds)),
                start=t, end=0.0, cuts=[]))
        elif ev[0] == "preempt":
            _, dim, t, _tenant, cut, _refund = ev
            svc = services[dim][-1]
            cut_set = set(cut)
            svc.ops = [o for o in svc.ops if o not in cut_set]
            svc.cuts.append((t, cut))
    for dim in range(num_dims):
        if len(services[dim]) != len(res.dim_services[dim]):
            raise EncodingError(
                f"{inst.name}: recorder saw {len(services[dim])} services "
                f"on dim {dim}, engine reports "
                f"{len(res.dim_services[dim])}")
        for svc, (s, e, _g) in zip(services[dim], res.dim_services[dim]):
            if abs(svc.start - s) > _EPS:
                raise EncodingError(
                    f"{inst.name}: service start mismatch on dim {dim}: "
                    f"recorder {svc.start!r} vs engine {s!r}")
            svc.end = e

    op_service: dict = {}
    total_wire = [0.0] * num_dims
    rearm: dict = {}
    for per_dim in services:
        for svc in per_dim:
            for t_cut, cut in svc.cuts:
                for op in cut:
                    rearm[op] = t_cut
            for op in svc.ops:
                op_service[op] = svc
                op_count[op] = op_count.get(op, 0) + 1
                total_wire[svc.dim] += svc.op_bytes[op]

    # Chunk chains and chunk -> group mapping (mirror of the engines'
    # global chunk-id offset scheme over the scheduled groups).
    chain_ops: dict[int, dict[int, tuple]] = {}
    for op in op_service:
        chain_ops.setdefault(op[0], {})[op[1]] = op
    chunk_group: dict[int, int] = {}
    offset = 0
    for g, group in enumerate(groups):
        for c in group:
            chunk_group[c.index + offset] = g
        if group:
            offset += max(c.index for c in group) + 1

    # The EXPECTED task set, built independently of the trace through the
    # engines' own SoA builder — a chunk stage the trace never served shows
    # up here and nowhere else (that is what "lost" means).
    ta = build_task_arrays(
        LatencyModel.for_topology(inst.topology), groups,
        [r.priority for r in requests], [r.tenant for r in requests])
    expected_ops: dict = {}
    expected_wire = [0.0] * num_dims
    for h in range(ta.n_tasks):
        expected_ops[(ta.chunk[h], ta.stage[h])] = (ta.dim[h], ta.wire[h])
        expected_wire[ta.dim[h]] += ta.wire[h]

    env: dict[str, float] = {}
    constraints: list = []

    # ---- service arithmetic -------------------------------------------------
    for dim in range(num_dims):
        for svc in services[dim]:
            env[svc.svar().name] = svc.start
            env[svc.fvar().name] = svc.end
            # Rate equation: only the kept bytes drain (no jitter in
            # verification instances, so rate == dim bandwidth).
            constraints.append(
                svc.fvar().eq(svc.svar() + Const(svc.bytes / bw[dim])))
        # Per-dim services never overlap and are start-ordered.
        for a, b in zip(services[dim], services[dim][1:]):
            constraints.append(a.fvar() <= b.svar())

    # ---- readiness chains ---------------------------------------------------
    op_ready: dict = {}

    def ready_of(op) -> tuple[smt.Expr, float]:
        cid, s = op
        if s == 0:
            t0 = res.group_issue[chunk_group[cid]]
            base: smt.Expr = Const(t0)
            ground = t0
        else:
            prev = chain_ops[cid][s - 1]
            psvc = op_service[prev]
            base = psvc.fvar() + Const(psvc.a)
            ground = psvc.end + psvc.a
        if op in rearm and penalty > 0:
            base = Max(base, Const(rearm[op] + penalty))
            ground = max(ground, rearm[op] + penalty)
        return base, ground

    for op, svc in op_service.items():
        expr, ground = ready_of(op)
        op_ready[op] = ground
        constraints.append(expr <= svc.svar())

    # ---- completion times ---------------------------------------------------
    for g in range(len(groups)):
        terms = []
        for cid, stages in chain_ops.items():
            if chunk_group[cid] != g:
                continue
            last = stages[max(stages)]
            lsvc = op_service[last]
            terms.append(lsvc.fvar() + Const(lsvc.a))
        if terms:
            env[f"C_{g}"] = res.group_finish[g]
            constraints.append(Var(f"C_{g}").eq(Max(*terms)))

    # Exact queue occupancy per (dim, tenant), replayed from the recorder's
    # event stream: an "enq" adds one task (preemption-cut chunks re-enqueue
    # and log again), a "serve" removes its batch.  Time-based pendingness
    # would be wrong — an op readied at the same timestamp as a serve sits
    # behind it in the event heap and was NOT a candidate at that decision.
    qcount: dict[tuple[int, str], int] = {}

    def _replay_queue(ev) -> None:
        if ev[0] == "enq":
            qcount[(ev[1], ev[2])] = qcount.get((ev[1], ev[2]), 0) + 1
        elif ev[0] == "serve":
            qcount[(ev[1], ev[3])] = qcount.get((ev[1], ev[3]), 0) - len(ev[4])

    # ---- virtual-time chains (fair policies), one interleaved pass ----------
    if inst.policy in ("weighted-fair", "slo-aware"):
        vt_idx: dict[tuple, int] = {}
        fl_idx: dict[int, int] = {}
        tenant_names = [s.name for s in inst.tenants]

        def vt_var(dim, tn) -> Var:
            return Var(f"VT_{dim}_{tn}_{vt_idx.get((dim, tn), 0)}")

        def vt_advance(dim, tn, value) -> Var:
            vt_idx[(dim, tn)] = vt_idx.get((dim, tn), 0) + 1
            v = vt_var(dim, tn)
            env[v.name] = value
            return v

        for d in range(num_dims):
            for tn in tenant_names:
                env[f"VT_{d}_{tn}_0"] = 0.0
                constraints.append(Var(f"VT_{d}_{tn}_0").eq(0.0))

        for ev in arb.events:
            if ev[0] == "enq":
                _, dim, tn, t, vt_after = ev
                if inst.vt_clamp and fl_idx.get(dim) is not None:
                    old = vt_var(dim, tn)
                    new = vt_advance(dim, tn, vt_after)
                    constraints.append(
                        new.eq(Max(old, Var(f"FL_{dim}_{fl_idx[dim]}"))))
            elif ev[0] == "serve":
                _, dim, t, tn, ops, byts, fixeds, vt_before, incs = ev
                cur = vt_var(dim, tn)
                # Discipline order condition: the served tenant's clock is
                # minimal among tenants with queued work at the decision.
                for other in tenant_names:
                    if other != tn and qcount.get((dim, other), 0) > 0:
                        constraints.append(cur <= vt_var(dim, other))
                # SFQ floor advances to this service's start tag.
                j = fl_idx[dim] = fl_idx.get(dim, -1) + 1
                flv = Var(f"FL_{dim}_{j}")
                env[flv.name] = vt_before
                constraints.append(flv.eq(cur))
                inc = sum(incs.values())
                new = vt_advance(dim, tn, vt_before + inc)
                constraints.append(new.eq(cur + Const(inc)))
            else:  # preempt: refund the cut chunks' virtual time
                _, dim, t, tn, cut, refund = ev
                cur = vt_var(dim, tn)
                new = vt_advance(dim, tn, env[cur.name] - refund)
                constraints.append(new.eq(cur - Const(refund)))
            _replay_queue(ev)
    elif inst.policy == "strict-priority":
        # Order condition: a served tenant's priority dominates every
        # queued tenant's at the decision instant (ground comparison —
        # priorities are instance constants).
        for ev in arb.events:
            if ev[0] == "serve":
                _, dim, t, tn, *_rest = ev
                for other in (s.name for s in inst.tenants):
                    if other == tn:
                        continue
                    if qcount.get((dim, other), 0) > 0:
                        constraints.append(
                            Const(inst.priority(other))
                            <= Const(inst.priority(tn)))
            _replay_queue(ev)

    return Encoding(
        instance=inst, assignment=dict(assignment), engine=engine,
        requests=requests, result=res, env=env, constraints=constraints,
        services=services, op_service=op_service, op_ready=op_ready,
        op_count=op_count, expected_ops=expected_ops,
        expected_wire=expected_wire, total_wire=total_wire, bw=bw,
        penalty=penalty, makespan=res.makespan)


def validate_encoding(enc: Encoding, tol: float = 1e-6) -> None:
    """Assert the engine witness satisfies every constraint.

    Comparisons get ``tol`` slack — the witness floats carry the engines'
    own accumulation order.  A failure means the declarative model and
    the implementation disagree, which is exactly the divergence this
    subsystem exists to catch.
    """
    for c in enc.constraints:
        if not _holds(c, enc.env, tol):
            raise EncodingError(
                f"{enc.instance.name} {enc.assignment}: engine witness "
                f"violates model constraint {c!r}")


def _holds(c, env, tol: float) -> bool:
    if isinstance(c, smt.Cmp):
        a = smt.evaluate(c.a, env)
        b = smt.evaluate(c.b, env)
        if c.op == "==":
            return abs(a - b) <= tol + 1e-9 * max(abs(a), abs(b))
        if c.op == "<=":
            return a <= b + tol
        return a < b + tol
    if isinstance(c, smt.NaryBool) and c.op == "and":
        return all(_holds(x, env, tol) for x in c.args)
    return bool(smt.evaluate(c, env))
