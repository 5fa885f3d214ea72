"""Fabric arbiter: inter-tenant queue disciplines with preemptive service.

The arbiter is the pluggable per-dimension discipline the simulator
(:func:`repro_torch.core.simulator.simulate`) consults when multiple tenants'
chunk stages are ready on one network dimension:

  * ``fifo``            — tenant-blind arrival order (the do-nothing
                          baseline every shared fabric starts from).
  * ``strict-priority`` — higher :attr:`TenantSpec.priority` always first;
                          preempts in-flight lower-priority service.
  * ``weighted-fair``   — bytes-weighted max-min per dimension, deficit-
                          counter style: each (dim, tenant) pair accrues
                          virtual time ``bytes / weight`` as its chunks are
                          served, and the tenant with the smallest virtual
                          time is served next, so over any backlogged
                          interval tenants receive bandwidth proportional
                          to their weights.
  * ``slo-aware``       — weighted-fair whose effective weight is boosted
                          by ``observed_slowdown / slo`` once a tenant's
                          running slowdown (vs. its isolated latency)
                          exceeds its SLO target.

Preemption: when a tenant whose virtual time trails the in-flight tenant's
(or whose strict priority exceeds it) becomes ready, the simulator splits
the in-flight multi-chunk service at chunk granularity — chunks whose data
has not started draining return to the queue (``on_preempted`` refunds
their bytes), so a small latency-sensitive tenant never waits behind a
1 GB collective's full service.

Virtual-time staleness: a (dim, tenant) virtual time only advances while
the tenant is served, so a tenant that goes idle keeps a *stale* clock —
far behind tenants that kept consuming (it then monopolizes the dim on
re-arrival to "catch up" on service it never queued for), or far ahead of
a newcomer starting at 0 (it is then starved until the newcomer catches
up).  The fix is the start-time-fair-queuing clamp (``vt_clamp``, default
on): each dim tracks a virtual-time *floor* — the start tag of its most
recent service — and an arriving task raises its tenant's virtual time to
that floor (``on_enqueued``).  For continuously backlogged tenants the
clamp is a no-op (a backlogged tenant's clock is never behind the start
tag of a service that beat it), so only idle→busy transitions are
affected.  ``repro_torch.verify`` proves the bounded-slowdown property with the
clamp on and extracts the monopolization counterexample with it off.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from repro_torch.tenancy.tenants import TenantSpec

ARBITER_POLICIES = ("fifo", "strict-priority", "weighted-fair", "slo-aware")


class FabricArbiter:
    """Per-dim inter-tenant discipline + preemption policy.

    Duck-typed against the simulator's hooks: ``order_key``,
    ``should_preempt``, ``on_served``, ``on_preempted``,
    ``on_group_finish``, plus the ``preemption`` / ``quantum_chunks``
    attributes.

    ``isolated_latency`` maps tenant -> mean isolated request latency
    (seconds), the reference the slo-aware policy measures slowdown
    against; tenants absent from the map are treated as meeting their SLO.

    ``preempt_penalty_s`` is the re-arm latency a preemption charges: the
    chunks cut from an in-flight service only become ready again that many
    seconds after the split (modeling the cost of tearing down and
    re-issuing the collective).  0.0 — the default, for backward
    compatibility — keeps splits free.

    ``vt_clamp`` enables the fair-policy virtual-time floor clamp (see the
    module docstring); turn it off only to reproduce the pre-fix staleness
    behavior (the ``repro_torch.verify`` counterexamples pin it).
    """

    def __init__(
        self,
        policy: str,
        specs: Iterable[TenantSpec] = (),
        *,
        preemption: bool = True,
        quantum_chunks: int = 8,
        isolated_latency: Mapping[str, float] | None = None,
        preempt_penalty_s: float = 0.0,
        vt_clamp: bool = True,
    ):
        if policy not in ARBITER_POLICIES:
            raise ValueError(
                f"unknown arbiter policy {policy!r}; want {ARBITER_POLICIES}")
        if quantum_chunks < 1:
            raise ValueError("quantum_chunks must be >= 1")
        if preempt_penalty_s < 0:
            raise ValueError("preempt_penalty_s must be >= 0")
        self.policy = policy
        self.specs: dict[str, TenantSpec] = {s.name: s for s in specs}
        # FIFO never reorders, so preempting would be pure overhead.
        self.preemption = preemption and policy != "fifo"
        self.quantum_chunks = quantum_chunks
        self.preempt_penalty_s = preempt_penalty_s
        self.vt_clamp = vt_clamp
        self.isolated_latency = dict(isolated_latency or {})
        self._served: dict[tuple[int, str], float] = {}  # (dim, tenant) -> bytes
        # Virtual time accrues *at service time* (bytes / weight-then), so a
        # later slo-aware weight boost rescales only future service, not the
        # tenant's whole served history.
        self._vt: dict[tuple[int, str], float] = {}
        # Per-dim virtual-time floor: the start tag (pre-increment virtual
        # time) of the dim's most recent service — the SFQ v(t) an arriving
        # tenant's clock is clamped up to (see module docstring).
        self._vt_floor: dict[int, float] = {}
        self._inflight_inc: dict[int, dict] = {}  # dim -> {op_id: vt inc}
        self._latency: dict[str, dict[int, float]] = {}  # tenant -> {group: s}
        self._lat_sum: dict[str, float] = {}  # running sum of _latency values
        self._preempt_count = 0

    # -- tenant lookups ------------------------------------------------------
    def spec(self, tenant: str) -> TenantSpec:
        # order_key runs in the simulator hot loop: cache default specs for
        # unregistered tenants instead of allocating one per lookup
        got = self.specs.get(tenant)
        if got is None:
            got = self.specs[tenant] = TenantSpec(tenant)
        return got

    def effective_weight(self, tenant: str) -> float:
        w = max(self.spec(tenant).weight, 1e-12)
        if self.policy == "slo-aware":
            w *= self.slo_boost(tenant)
        return w

    def observed_slowdown(self, tenant: str) -> float | None:
        """Running mean request latency over the isolated reference."""
        iso = self.isolated_latency.get(tenant)
        lats = self._latency.get(tenant)
        if not iso or not lats:
            return None
        return (self._lat_sum[tenant] / len(lats)) / iso

    def slo_boost(self, tenant: str) -> float:
        slo = self.spec(tenant).slo_slowdown
        slowdown = self.observed_slowdown(tenant)
        if slo is None or slowdown is None:
            return 1.0
        return max(1.0, slowdown / slo)

    def virtual_time(self, dim: int, tenant: str) -> float:
        return self._vt.get((dim, tenant), 0.0)

    def vt_floor(self, dim: int) -> float:
        """The dim's SFQ virtual clock: start tag of its latest service."""
        return self._vt_floor.get(dim, 0.0)

    # -- simulator hooks -----------------------------------------------------
    def on_enqueued(self, dim: int, tenant: str, now: float) -> None:
        """A task of ``tenant`` joined ``dim``'s ready queue.

        Fair policies clamp the tenant's virtual time up to the dim's floor
        so an idle period neither banks catch-up credit (stale-low clock →
        monopolization) nor penalizes the tenant against newcomers
        (stale-high clock → starvation).  No-op for continuously backlogged
        tenants — their clock is never below the floor (the simulator
        always serves the minimum clock, so a backlogged tenant's clock is
        at least the start tag of any service that beat it).
        """
        if not self.vt_clamp or self.policy in ("fifo", "strict-priority"):
            return
        floor = self._vt_floor.get(dim)
        if floor is None:
            return
        key = (dim, tenant)
        if self._vt.get(key, 0.0) < floor:
            self._vt[key] = floor
    def order_key(self, task, dim: int, now: float):
        if self.policy == "fifo":
            return (task.arrival_seq,)
        if self.policy == "strict-priority":
            return (-self.spec(task.tenant).priority, task.arrival_seq)
        # weighted-fair / slo-aware: smallest virtual time first; SCF-style
        # size tiebreak within a tenant keeps short chunks from idling.
        return (self.virtual_time(dim, task.tenant),
                task.wire_bytes, task.arrival_seq)

    def should_preempt(self, dim: int, running, candidate, now: float) -> bool:
        if self.policy == "fifo" or running.tenant == candidate.tenant:
            return False
        if self.policy == "strict-priority":
            return (self.spec(candidate.tenant).priority
                    > self.spec(running.tenant).priority)
        # Fair policies: preempt only if the candidate tenant would *still*
        # trail the running tenant after receiving one chunk of service —
        # the one-chunk hysteresis stops equal-share tenants thrashing.
        vt_cand = (self.virtual_time(dim, candidate.tenant)
                   + candidate.wire_bytes / self.effective_weight(candidate.tenant))
        return vt_cand < self.virtual_time(dim, running.tenant)

    def on_served(self, dim: int, batch, now: float) -> None:
        # Advance the dim's virtual clock to this service's start tag (the
        # served tenant's pre-increment virtual time) — monotone, because
        # the simulator always serves the minimum clock and clamps only
        # raise clocks toward the floor.
        self._vt_floor[dim] = self._vt.get((dim, batch[0].tenant), 0.0)
        incs = self._inflight_inc[dim] = {}
        for t in batch:
            key = (dim, t.tenant)
            self._served[key] = self._served.get(key, 0.0) + t.wire_bytes
            inc = t.wire_bytes / self.effective_weight(t.tenant)
            self._vt[key] = self._vt.get(key, 0.0) + inc
            incs[t.op_id] = inc

    def on_preempted(self, dim: int, cut, now: float) -> None:
        # Refund exactly the virtual time charged when the service started
        # (the weight may have changed since; the charge must round-trip).
        self._preempt_count += 1
        incs = self._inflight_inc.get(dim, {})
        for t in cut:
            key = (dim, t.tenant)
            self._served[key] -= t.wire_bytes
            self._vt[key] -= incs.pop(t.op_id, 0.0)

    def on_group_finish(self, group: int, tenant: str, latency: float) -> None:
        # Chunk chains of one request retire progressively; keeping the
        # latest observation per group converges to the request's latency.
        lats = self._latency.setdefault(tenant, {})
        self._lat_sum[tenant] = (self._lat_sum.get(tenant, 0.0)
                                 + latency - lats.get(group, 0.0))
        lats[group] = latency

    # -- reporting / introspection -------------------------------------------
    @property
    def preempt_count(self) -> int:
        return self._preempt_count

    def served_bytes(self, tenant: str) -> float:
        return sum(v for (d, t), v in self._served.items() if t == tenant)

    def served_snapshot(self) -> dict[tuple[int, str], float]:
        """Copy of the per-(dim, tenant) served-bytes ledger.  The runtime
        invariant sanitizer (``simulate(check_invariants=True)``) snapshots
        this at simulation start and checks the per-dim served delta against
        the engine's wire-byte accounting at the end."""
        return dict(self._served)

    def discipline_state(self) -> dict:
        """Structured snapshot of the discipline's internal state — what the
        SMT encoder (``repro_torch.verify.encode``) mirrors and the sanitizer
        cross-checks.  Keys are JSON-friendly (tuple keys stringified)."""
        return {
            "policy": self.policy,
            "preemption": self.preemption,
            "quantum_chunks": self.quantum_chunks,
            "preempt_penalty_s": self.preempt_penalty_s,
            "vt_clamp": self.vt_clamp,
            "virtual_time": {f"{d}/{t}": v
                             for (d, t), v in sorted(self._vt.items())},
            "vt_floor": dict(sorted(self._vt_floor.items())),
            "served_bytes": {f"{d}/{t}": v
                             for (d, t), v in sorted(self._served.items())},
            "preempt_count": self._preempt_count,
        }
