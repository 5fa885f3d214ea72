"""Admission control and load shedding in front of the engines.

Closed-loop runs always finish; open-loop runs past saturation queue
unboundedly unless something says *no*.  :class:`AdmissionController`
is that something: a bounded admission queue over request *units*
(weakly-connected components of the traffic graph — one serving
request chain each) with three deterministic policies:

- ``reject-newest``     — queue full ⇒ the arriving unit is shed;
- ``shed-lowest-priority`` — queue full ⇒ the lowest-priority queued
  unit (ties → latest arrival) is shed to make room; degenerates to
  reject-newest among equals;
- ``deadline-aware``    — queued units past their deadline are expired,
  and an arrival whose projected queueing delay (backlog × estimated
  service time) already exceeds the deadline is dropped at the door.

The engines drive the controller at three deterministic points — a
unit's first ready-event pop (the admission decision), its first chunk
entering service, and each chunk-group completion — always in event-time
order and identically on both engines, so shed sets are bit-identical
indexed vs reference.  The controller consumes no RNG and no sequence
numbers.  Shed victims are always pure queue residents (no chunk served
yet), so the engines only purge queues — nothing in flight is killed.

Capacity is expressed in *admitted units resident at once*;
:func:`calibrate_admission` derives it (and the per-unit service-time
estimate the deadline policy needs) from a traced at-capacity run's
``BwTimeline`` — closing the observe→actuate loop the ROADMAP asks for.
"""
from __future__ import annotations

from repro_torch.obs.timeline import BwTimeline

__all__ = ["ADMISSION_POLICIES", "AdmissionController", "unit_of_group",
           "calibrate_admission"]

ADMISSION_POLICIES = ("reject-newest", "shed-lowest-priority",
                      "deadline-aware")

_UNKNOWN, _QUEUED, _SERVING, _SHED, _DONE = range(5)


def unit_of_group(graph) -> tuple[list[int], dict[int, int]]:
    """Map each chunk-group (graph node) to its request unit.

    Units are the weakly-connected components of the dependency graph —
    after ``merge_graphs`` each serving request chain is exactly one
    component.  Returns ``(unit_of, unit_priority)`` where ``unit_of[g]``
    is the unit id of group ``g`` (node order) and ``unit_priority`` maps
    unit id → the max priority over its *request* nodes (compute-only
    gates carry no tenant priority and are neutral; a unit with no
    request nodes gets 0).
    """
    n = len(graph.nodes)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, preds in enumerate(graph.deps_idx):
        for p in preds:
            ra, rb = find(i), find(p)
            if ra != rb:
                parent[ra] = rb
    roots: dict[int, int] = {}
    unit_of = []
    unit_priority: dict[int, int] = {}
    has_req: set[int] = set()
    for i in range(n):
        r = find(i)
        u = roots.setdefault(r, len(roots))
        unit_of.append(u)
        node = graph.nodes[i]
        if node.request is None:
            unit_priority.setdefault(u, 0)
        else:
            pr = node.priority
            if u not in has_req or pr > unit_priority[u]:
                unit_priority[u] = pr
            has_req.add(u)
    return unit_of, unit_priority


class AdmissionController:
    """Bounded admission queue with deterministic shed policies.

    Parameters
    ----------
    unit_of:
        ``unit_of[g]`` → unit id for every chunk-group ``g`` (see
        :func:`unit_of_group`).  Groups of one unit are admitted or shed
        together.
    policy:
        One of :data:`ADMISSION_POLICIES`.
    capacity:
        Max units resident (admitted, not yet finished) at once.
    unit_priority:
        Required for ``shed-lowest-priority``: unit id → priority
        (higher = more important).
    deadline_s / est_service_s:
        Required for ``deadline-aware``: per-unit queueing deadline and
        the estimated service time used to project the backlog delay.
    """

    def __init__(self, unit_of, *, policy: str = "reject-newest",
                 capacity: int = 8, unit_priority=None,
                 deadline_s: float | None = None,
                 est_service_s: float | None = None) -> None:
        if policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; "
                f"pick from {ADMISSION_POLICIES}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy == "shed-lowest-priority" and unit_priority is None:
            raise ValueError(
                "shed-lowest-priority needs unit_priority= (unit -> prio)")
        if policy == "deadline-aware" and (
                deadline_s is None or est_service_s is None):
            raise ValueError(
                "deadline-aware needs deadline_s= and est_service_s=")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if est_service_s is not None and est_service_s <= 0:
            raise ValueError(
                f"est_service_s must be > 0, got {est_service_s}")
        self.unit_of = list(unit_of)
        self.policy = policy
        self.capacity = capacity
        self.unit_priority = dict(unit_priority or {})
        self.deadline_s = deadline_s
        self.est_service_s = est_service_s
        self._n_units = (max(self.unit_of) + 1) if self.unit_of else 0
        self._groups_of: list[list[int]] = [[] for _ in
                                            range(self._n_units)]
        for g, u in enumerate(self.unit_of):
            self._groups_of[u].append(g)
        self._reset()

    # -- engine-facing hooks (deterministic, no RNG / seq consumption) --

    def begin(self, n_groups: int, engine: str) -> None:
        """Engine handshake at run start: validate sizes and reset all
        per-run state so one controller drives many runs (and both
        engines of a differential pair) identically."""
        if n_groups != len(self.unit_of):
            raise ValueError(
                f"admission unit_of covers {len(self.unit_of)} groups "
                f"but the run has {n_groups}")
        self.engine = engine
        self._reset()

    def _reset(self) -> None:
        n = self._n_units
        self._state = [_UNKNOWN] * n
        self._remaining = [len(gs) for gs in self._groups_of]
        self._done = [False] * len(self.unit_of)
        self._arrive_t = [0.0] * n
        self._arrive_ord = [-1] * n
        self._n_arrived = 0
        self._occupancy = 0
        self.n_admitted = 0
        self.n_shed = 0
        self.shed_units: list[int] = []

    def on_ready(self, g: int, now: float):
        """Admission decision at group ``g``'s first ready pop.

        Returns ``None`` when the owning unit was already decided (the
        group rides that decision), an empty tuple to admit with no
        victims, or a non-empty tuple of chunk-group ids the engine must
        shed (which may include ``g``'s own unit).
        """
        u = self.unit_of[g]
        if self._state[u] != _UNKNOWN:
            return None
        self._arrive_t[u] = now
        self._arrive_ord[u] = self._n_arrived
        self._n_arrived += 1
        shed: list[int] = []

        def shed_unit(v: int) -> None:
            if self._state[v] == _QUEUED:
                self._occupancy -= 1
            self._state[v] = _SHED
            self.n_shed += 1
            self.shed_units.append(v)
            shed.extend(gg for gg in self._groups_of[v]
                        if not self._done[gg])

        if self.policy == "deadline-aware":
            # Expire queued units already past their deadline (unit-id
            # order — deterministic, engine-independent), then project
            # the arrival's queueing delay off the remaining backlog and
            # drop at the door if it already blows the deadline.  The
            # queue may run past ``capacity`` while the projected wait
            # stays inside the deadline — the bound is time, not slots.
            for v in range(self._n_units):
                if (self._state[v] == _QUEUED
                        and self._arrive_t[v] + self.deadline_s <= now):
                    shed_unit(v)
            backlog = self._occupancy - self.capacity + 1
            admit = backlog * self.est_service_s <= self.deadline_s
        elif self._occupancy < self.capacity:
            admit = True
        elif self.policy == "shed-lowest-priority":
            pool = [v for v in range(self._n_units)
                    if self._state[v] == _QUEUED]
            victim = min(
                pool + [u],
                key=lambda v: (self.unit_priority.get(v, 0),
                               -self._arrive_ord[v]))
            admit = victim != u
            if admit:
                shed_unit(victim)
        else:
            admit = False
        if admit:
            self._state[u] = _QUEUED
            self._occupancy += 1
            self.n_admitted += 1
        else:
            shed_unit(u)
        return tuple(shed)

    def on_serving(self, g: int, now: float) -> None:
        """First chunk of ``g`` entered service."""
        u = self.unit_of[g]
        if self._state[u] == _QUEUED:
            self._state[u] = _SERVING

    def on_finish(self, g: int, now: float) -> None:
        """Chunk-group ``g`` completed (idempotent per group)."""
        if self._done[g]:
            return
        self._done[g] = True
        u = self.unit_of[g]
        self._remaining[u] -= 1
        if self._remaining[u] == 0 and self._state[u] in (_QUEUED,
                                                          _SERVING):
            self._occupancy -= 1
            self._state[u] = _DONE


def calibrate_admission(timeline: BwTimeline, *, window_s: float,
                        n_requests: int, target_depth: float = 1.0,
                        chunks_per_unit: float = 1.0) -> dict[str, float]:
    """Derive admission parameters from a traced at-capacity run.

    ``timeline`` is the ``BwTimeline`` of a run *at* (not past)
    saturation.  Capacity comes from the peak windowed queue depth
    scaled to ``target_depth`` (depth 1.0 ⇒ admit what the observed
    fabric kept busy); ``est_service_s`` from makespan / requests; the
    busiest dim's share concentration is reported for diagnostics.
    ``chunks_per_unit`` converts the timeline's chunk-stage queue depth
    into request units (chunks per collective × wire collectives per
    request) — the controller's capacity is expressed in units.
    Returns kwargs for :class:`AdmissionController` (``capacity``,
    ``est_service_s``) plus ``peak_depth`` / ``busiest_dim_share``.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if chunks_per_unit <= 0:
        raise ValueError("chunks_per_unit must be > 0")
    depth = timeline.queue_depth(window_s)
    peak = max((max(col) for col in depth if col), default=0.0)
    peak /= chunks_per_unit
    shares = timeline.per_dim_shares(window_s)
    busiest = 0.0
    for cols in shares.values():
        for col in cols:
            if col:
                busiest = max(busiest, max(col))
    return {
        "capacity": max(1, int(round(peak * target_depth))),
        "est_service_s": timeline.makespan / n_requests,
        "peak_depth": peak,
        "busiest_dim_share": busiest,
    }
