"""Themis Scheduler — paper Algorithm 1, plus beyond-paper variants.

Policies:
  * ``baseline``      — static multi-rail hierarchical order (Sec. 2.3):
                        RS dim1..dimD then AG dimD..dim1, same for all chunks.
  * ``themis``        — Algorithm 1: greedy per-chunk order by sorted dim
                        loads (ascending for RS, descending for AG), with the
                        threshold guard reverting to baseline order; for AR
                        the AG order is the reverse of the RS order (line 8).
  * ``themis_indep_ag`` (beyond paper) — exploits the full (D! x D!) space of
                        Observation 1: after committing a chunk's RS loads,
                        the AG order is re-derived from the *updated* loads
                        instead of being forced to reverse(RS).
  * ``lookahead``     (beyond paper) — evaluates all D! RS orders for each
                        chunk and commits the one minimizing the projected
                        makespan (max dim load).  D <= 4 keeps this <= 24
                        candidates per chunk.
  * ``themis_guarded`` (beyond paper) — greedy, but a chunk's reordered
                        schedule is committed only if its projected makespan
                        beats the baseline order's.  Fixes the greedy's
                        overshoot on *just-enough* provisioned networks
                        (starting RS on a slow dim loads it with the full
                        un-shrunk chunk) at 2 evaluations per chunk.

All policies return the same artifact: a list of ``Chunk``s whose
``schedule`` is the ordered list of (phase, dim) stage ops.

The port's copy of ``repro/core/scheduler.py`` (it imports nothing from
``repro``): the same code, without ``replan_degraded``, whose fault model
(``repro/faults``) the port does not carry. ``tests/test_torch_sched.py``
holds its chunk orders equal to the reference's.
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

from repro_torch.core.chunking import Chunk, coalesce_by_order, split_equal
from repro_torch.core.latency_model import LatencyModel, StageOp
from repro_torch.core.load_tracker import DimLoadTracker
from repro_torch.core.requests import CollectiveRequest
from repro_torch.obs.metrics import ScheduleDecision, current_registry
from repro_torch.topology import Phase, Topology

POLICIES = ("baseline", "themis", "themis_indep_ag", "lookahead",
            "themis_guarded")

# Threshold = predicted runtime of an RS/AG of size chunk/16 on the dim with
# the lowest current load (paper Sec. 5.3).
THRESHOLD_DIVISOR = 16.0


def baseline_order(num_dims: int, collective: str) -> list[StageOp]:
    """Sec. 2.3 static schedule: RS dim1->dimD, AG dimD->dim1."""
    rs = [(Phase.RS, k) for k in range(num_dims)]
    ag = [(Phase.AG, k) for k in reversed(range(num_dims))]
    if collective == "RS":
        return rs
    if collective == "AG":
        return ag
    return rs + ag


def _collective_of(chunks: Sequence[Chunk]) -> str | None:
    """Recover the collective kind from scheduled chunks (RS-only, AG-only
    or both phases -> AR).  ``None`` if no chunk carries a schedule."""
    for c in chunks:
        if c.schedule:
            phases = {phase for phase, _ in c.schedule}
            if len(phases) == 2:
                return "AR"
            return "RS" if Phase.RS in phases else "AG"
    return None


def _sorted_dims(loads: Sequence[float], descending: bool) -> list[int]:
    # Stable sort; ties resolve to lower dim index (deterministic across
    # NPUs — required for Sec. 4.6.1 inter-dim schedule consistency).
    return sorted(range(len(loads)), key=lambda k: (loads[k],), reverse=descending)


@dataclass
class ThemisScheduler:
    """Implements SCHEDULE_COLLECTIVE / SCHEDULER.SCHEDULE of Algorithm 1.

    ``tracker`` may be supplied to share one Dim Load Tracker between
    several scheduler instances — the cross-tenant Themis mode
    (``repro.tenancy``) gives every tenant's scheduler the same fabric-wide
    tracker so each tenant's chunk orders steer around *other tenants'*
    residual loads, not just their own.

    ``metrics`` (a :class:`repro.obs.MetricsRegistry`) turns on decision
    logging, memo-cache hit/miss counters and span timers; ``None``
    (default) adopts the process-global registry if one is installed
    (``repro.obs.enable_global``, the ``benchmarks/run.py --trace`` path)
    and otherwise disables instrumentation — every call site is guarded,
    so the off path costs one branch per event.
    """

    latency_model: LatencyModel
    policy: str = "themis"
    tracker: DimLoadTracker | None = None
    metrics: object | None = None

    # Caches are bounded: equal-size chunk runs produce a handful of distinct
    # (size, schedule) pairs, but adversarial streams with many distinct
    # sizes must not grow memory without bound.
    _CACHE_CAP = 4096

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; want {POLICIES}")
        if self.tracker is None:
            self.tracker = DimLoadTracker(self.latency_model)
        if self.metrics is None:
            self.metrics = current_registry()
        # Last greedy decision's memo signature / hit flag, captured only
        # while a registry is installed (feeds the per-request decision log).
        self._last_sig: tuple = ()
        self._last_hit = False
        # (chunk_bytes, schedule) -> dense per-dim load delta.  Exact: the
        # delta a schedule adds is independent of the current loads.
        self._delta_cache: dict[tuple, list[float]] = {}
        # Rank-signature memo for the greedy order (see _greedy_order).
        self._greedy_cache: dict[tuple, tuple[StageOp, ...]] = {}
        # (min_dim, chunk_bytes) -> Sec. 5.3 threshold.
        self._thr_cache: dict[tuple[int, float], float] = {}
        # collective -> the D! lookahead candidate schedules.
        self._cand_cache: dict[str, list[tuple[StageOp, ...]]] = {}

    def _stage_deltas(self, chunk_bytes: float, sched) -> list[float]:
        """Per-dim load vector one chunk adds via ``sched`` (memoized)."""
        key = (chunk_bytes, tuple(sched))
        got = self._delta_cache.get(key)
        reg = self.metrics
        if reg is not None:
            reg.inc("scheduler.delta_cache.hit" if got is not None
                    else "scheduler.delta_cache.miss")
        if got is None:
            if len(self._delta_cache) >= self._CACHE_CAP:
                self._delta_cache.clear()
            got = self._delta_cache[key] = self.latency_model.calc_loads_list(
                chunk_bytes, sched)
        return got

    @contextlib.contextmanager
    def isolated_run(self) -> Iterator["ThemisScheduler"]:
        """Scope one scenario's scheduling on a shared scheduler.

        The reuse contract: memo caches (`_stage_deltas`, greedy orders,
        thresholds, lookahead candidates) are *exact* — they depend only on
        the latency model — so sharing one scheduler across many scenarios
        is free and decision-identical.  Tracker state is *not* shareable:
        it accumulates each scheduled chunk's load.  Inside this context the
        scheduler runs against a fresh :class:`DimLoadTracker`; on exit the
        caller's tracker (including an injected cross-tenant shared tracker)
        is restored untouched, so scenarios never observe each other's
        loads and the caller's state survives.  Used by
        ``simulate_requests(scheduler=...)`` and ``core.batch``.
        """
        prev = self.tracker
        self.tracker = DimLoadTracker(self.latency_model)
        try:
            yield self
        finally:
            self.tracker = prev

    def schedule_stream(
        self,
        requests: Sequence[CollectiveRequest],
        chunks_per_collective: int,
        *,
        water_filling: bool = False,
    ) -> list[list[Chunk]]:
        """Schedule a request stream in global issue order (ties broken by
        list position), returning chunk groups indexed like ``requests``.
        The single definition of the stream-scheduling contract —
        ``simulate_requests`` and ``repro.core.batch`` both call this, so
        batch results cannot drift from standalone runs."""
        order = sorted(range(len(requests)),
                       key=lambda i: (requests[i].issue_time, i))
        groups: list[list[Chunk]] = [[] for _ in requests]
        for i in order:
            groups[i] = self.schedule_request(
                requests[i], chunks_per_collective,
                water_filling=water_filling)
        return groups

    # -- public API -----------------------------------------------------------
    def schedule_collective(
        self,
        collective: str,
        collective_bytes: float,
        chunks_per_collective: int,
        *,
        water_filling: bool = False,
    ) -> list[Chunk]:
        """Returns chunks with their stage schedules (Algorithm 1).

        One-shot mode: the tracker is reset per collective (Sec. 4.4) —
        correct when collectives run back-to-back.  For overlapping
        collectives use :meth:`schedule_request`.
        """
        if collective not in ("AR", "RS", "AG"):
            raise ValueError(f"unsupported collective {collective}")
        reg = self.metrics
        with (reg.span("scheduler.schedule_pass") if reg is not None
                else contextlib.nullcontext()):
            self.tracker.reset(collective)
            chunks = self._split_and_schedule(
                collective, collective_bytes, chunks_per_collective,
                water_filling=water_filling)
        if reg is not None:
            reg.inc("scheduler.collectives_scheduled")
        return chunks

    def schedule_request(
        self,
        request: CollectiveRequest,
        chunks_per_collective: int,
        *,
        water_filling: bool = False,
    ) -> list[Chunk]:
        """Incremental path for overlapping collectives (Sec. 4.4's
        running-load view extended across requests).

        Instead of resetting the Dim Load Tracker per collective, the
        tracker's clock advances to the request's issue time (draining loads
        already served) and the request's A_K is *added* — so a bucket
        issued mid-backprop sees the residual contention of every collective
        still in flight and is steered around it.
        """
        reg = self.metrics
        with (reg.span("scheduler.schedule_pass") if reg is not None
                else contextlib.nullcontext()):
            self.tracker.advance_to(request.issue_time)
            self.tracker.begin_collective(request.collective)
            chunks = self._split_and_schedule(
                request.collective, request.size_bytes,
                chunks_per_collective, water_filling=water_filling)
        if reg is not None:
            reg.inc("scheduler.requests_scheduled")
            reg.log_decision(ScheduleDecision(
                collective=request.collective,
                tenant=request.tenant,
                policy=self.policy,
                chunk_order=(tuple(dim for _, dim in chunks[0].schedule)
                             if chunks else ()),
                rank_signature=self._last_sig,
                cache_hit=self._last_hit,
                num_chunks=len(chunks)))
        return chunks

    def _split_and_schedule(
        self,
        collective: str,
        collective_bytes: float,
        chunks_per_collective: int,
        *,
        water_filling: bool,
    ) -> list[Chunk]:
        if collective == "AG":
            # Collective size convention (paper Sec. 2.3 / footnote 7): the
            # size is the large end — the gathered result.  Chunks start at
            # the pre-gather per-NPU resident size.
            collective_bytes = collective_bytes / self.latency_model.topology.total_npus
        if water_filling and self.policy != "baseline":
            micro = split_equal(collective_bytes, max(1024, 8 * chunks_per_collective))
            for chunk in micro:
                chunk.schedule = self._schedule_chunk(collective, chunk.size_bytes)
            return coalesce_by_order(micro, chunks_per_collective)
        chunks = split_equal(collective_bytes, chunks_per_collective)
        for chunk in chunks:
            chunk.schedule = self._schedule_chunk(collective, chunk.size_bytes)
        return chunks

    # -- Algorithm 1 SCHEDULER.SCHEDULE ---------------------------------------
    def _schedule_chunk(self, collective: str, chunk_bytes: float) -> list[StageOp]:
        d = self.latency_model.topology.num_dims
        if self.policy == "baseline":
            sched = baseline_order(d, collective)
        elif self.policy == "lookahead":
            sched = self._lookahead_order(collective, chunk_bytes)
        elif self.policy == "themis_guarded":
            sched = self._pick_by_projection(
                collective, chunk_bytes,
                [self._greedy_order(collective, chunk_bytes),
                 baseline_order(d, collective)])
        else:
            sched = self._greedy_order(collective, chunk_bytes)
        self.tracker.update_loads(self._stage_deltas(chunk_bytes, sched))
        return sched

    def _below_threshold(self, loads: Sequence[float], chunk_bytes: float) -> bool:
        min_dim = min(range(len(loads)), key=loads.__getitem__)
        threshold = self._thr_cache.get((min_dim, chunk_bytes))
        if threshold is None:
            wire, _ = self.latency_model.stage_wire_bytes(
                min_dim, Phase.RS, chunk_bytes / THRESHOLD_DIVISOR
            )
            if len(self._thr_cache) >= self._CACHE_CAP:
                self._thr_cache.clear()
            threshold = self._thr_cache[(min_dim, chunk_bytes)] = (
                self.latency_model.wire_time(min_dim, wire))
        return max(loads) - min(loads) < threshold

    def _greedy_order(self, collective: str, chunk_bytes: float) -> list[StageOp]:
        """Algorithm 1 greedy order, memoized on the *load-rank signature*.

        Outside the independent-AG variant the greedy output is a pure
        function of (collective, below-threshold flag, sorted dim
        permutation) — so equal-size chunk runs reuse the schedule until the
        dim ranking flips, which is what makes water_filling's >=1024
        micro-chunk pass cheap.  ``themis_indep_ag``'s AG pass depends on
        the load *values* (not just ranks), so it is recomputed each time
        (its RS-delta lookup still hits ``_stage_deltas``).
        """
        d = self.latency_model.topology.num_dims
        loads = self.tracker.get_loads()
        below = self._below_threshold(loads, chunk_bytes)
        if (self.policy == "themis_indep_ag" and collective == "AR"
                and not below):
            rs_dims = _sorted_dims(loads, descending=False)
            rs = [(Phase.RS, k) for k in rs_dims]
            delta = self._stage_deltas(chunk_bytes, rs)
            ag_loads = [loads[k] + delta[k] for k in range(d)]
            ag = [(Phase.AG, k) for k in _sorted_dims(ag_loads, descending=True)]
            return rs + ag
        if below:
            sig = (collective, True)
        elif collective == "AG":
            sig = (collective, False, tuple(_sorted_dims(loads, descending=True)))
        else:  # RS and AR need the ascending permutation only
            sig = (collective, False, tuple(_sorted_dims(loads, descending=False)))
        got = self._greedy_cache.get(sig)
        reg = self.metrics
        if reg is not None:
            reg.inc("scheduler.greedy_cache.hit" if got is not None
                    else "scheduler.greedy_cache.miss")
            self._last_sig = sig
            self._last_hit = got is not None
        if got is None:
            if below:
                sched = baseline_order(d, collective)
            elif collective == "RS":
                sched = [(Phase.RS, k) for k in sig[2]]
            elif collective == "AG":
                sched = [(Phase.AG, k) for k in sig[2]]
            else:  # AR: AG = reverse(RS) (Alg. 1 line 8)
                sched = ([(Phase.RS, k) for k in sig[2]]
                         + [(Phase.AG, k) for k in reversed(sig[2])])
            if len(self._greedy_cache) >= self._CACHE_CAP:
                self._greedy_cache.clear()
            got = self._greedy_cache[sig] = tuple(sched)
        return list(got)

    def _pick_by_projection(
        self, collective: str, chunk_bytes: float,
        candidates: list[list[StageOp]],
    ) -> list[StageOp]:
        loads = self.tracker.get_loads()
        best = None
        for cand in candidates:
            delta = self._stage_deltas(chunk_bytes, cand)
            proj = [a + b for a, b in zip(loads, delta)]
            key = (max(proj), sum(proj))
            if best is None or key < best[0]:
                best = (key, cand)
        return best[1]

    def _candidate_orders(self, collective: str) -> list[tuple[StageOp, ...]]:
        """All D! candidate schedules of ``collective`` (memoized)."""
        got = self._cand_cache.get(collective)
        if got is None:
            d = self.latency_model.topology.num_dims
            cands: list[tuple[StageOp, ...]] = []
            for perm in itertools.permutations(range(d)):
                if collective == "RS":
                    cand = [(Phase.RS, k) for k in perm]
                elif collective == "AG":
                    cand = [(Phase.AG, k) for k in perm]
                else:
                    cand = [(Phase.RS, k) for k in perm] + [
                        (Phase.AG, k) for k in reversed(perm)
                    ]
                cands.append(tuple(cand))
            got = self._cand_cache[collective] = cands
        return got

    def _lookahead_order(self, collective: str, chunk_bytes: float) -> list[StageOp]:
        """D! enumeration with memoized per-candidate load deltas: after the
        first chunk of a size, each candidate evaluation is a vector add +
        max — the winner itself depends on the current load values, so it is
        re-picked per chunk (rank-only memoization would change decisions)."""
        loads = self.tracker.get_loads()
        best: tuple[tuple[float, float], tuple[StageOp, ...]] | None = None
        for cand in self._candidate_orders(collective):
            delta = self._stage_deltas(chunk_bytes, cand)
            proj = [a + b for a, b in zip(loads, delta)]
            key = (max(proj), sum(proj))
            if best is None or key < best[0]:
                best = (key, cand)
        assert best is not None
        return list(best[1])


def schedule_collective(
    topology: Topology,
    collective: str,
    collective_bytes: float,
    chunks_per_collective: int = 64,
    policy: str = "themis",
    *,
    water_filling: bool = False,
) -> list[Chunk]:
    """Convenience wrapper: build model+scheduler and schedule one collective."""
    sched = ThemisScheduler(LatencyModel.for_topology(topology), policy)
    return sched.schedule_collective(
        collective,
        collective_bytes,
        chunks_per_collective,
        water_filling=water_filling,
    )
