"""Batch/fleet evaluation — amortize everything shared across scenarios.

A :class:`Scenario` is one independent (topology, request stream, policy,
arbiter, discipline, jitter seed) simulation — exactly the argument set of
:func:`repro_torch.core.simulator.simulate_requests`.  :func:`simulate_batch`
runs N scenarios in one process and shares every piece of work that is a
pure function of a subset of the scenario fields:

  * **LatencyModel / StageTables** — memoized per topology
    (``LatencyModel.for_topology``), built once per distinct fabric no
    matter how many scenarios visit it;
  * **chunk schedules** — a scenario's chunk groups depend only on
    (topology, policy, requests, chunks_per_collective, water_filling).
    Scenarios differing in seed/jitter/discipline/arbiter (a robustness
    sweep, an arbiter ablation, a multi-seed scoring pass) share one
    scheduling pass through a pooled per-(topology, policy)
    ``ThemisScheduler`` whose memo caches stay warm across the whole batch
    (``ThemisScheduler.isolated_run`` keeps tracker state scenario-local);
  * **SoA task arrays** — built once per distinct chunk-group family with
    the vectorized builder below and replayed into every run
    (``simulate(task_arrays=...)``);
  * **per-(size, schedule) stage vectors** — the per-stage wire-factor /
    step-delay evaluation collapses to one scalar pass per equivalence
    class (:func:`repro_torch.core.chunking.schedule_classes`) broadcast with
    numpy over all member chunks; the vectors are additionally shared
    across *topologies* with the same per-dim NPU counts and step delays,
    so a bandwidth-split search re-evaluates no stage math at all.

The event loop itself stays per-scenario and defaults to the unmodified
indexed engine, so every result is bit-identical to a standalone
``simulate_requests(..., engine="indexed")`` call — the equivalence suite
(``tests/test_engine_equiv.py``) and ``benchmarks/topo_search.py`` assert
this field-for-field.  ``Scenario.engine="compiled"`` swaps in the
cohort-vectorized fast path (``repro_torch.core.engine_compiled``) per scenario;
its numpy path is bit-identical too, so batches mixing engines still
agree field-for-field, and scenarios the fast path cannot serve (tracer,
arbiter, faults) fall back to indexed with the documented signal.

Dependency-gated streams (``Scenario.traffic``, a
``repro_torch.traffic.TrafficGraph``) ride the same machinery: the scheduling
pass and the vectorized task build are shared per graph family exactly
like request streams, and dependency resolution stays in the per-scenario
event loop — so pipeline and serving scenarios batch as cheaply as
training ones.

This is the port's copy of ``repro/core/batch.py``, imports aside.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.chunking import Chunk, schedule_classes
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import ThemisScheduler
from repro_torch.obs.metrics import current_registry
from repro_torch.core.simulator import (
    SimResult,
    TaskArrays,
    simulate,
    stage_sequence,
    task_arrays_fingerprint,
)
from repro_torch.topology import Topology


@dataclass(frozen=True)
class Scenario:
    """One independent simulation of a request stream on a fabric.

    Mirrors :func:`repro_torch.core.simulator.simulate_requests`; anything not a
    field here is shared batch machinery.  ``arbiter_factory`` (not an
    instance) because arbiters are stateful and each scenario must get a
    fresh one; ``label`` is free-form for reporting.

    ``traffic`` (a :class:`repro_torch.traffic.TrafficGraph`, mutually exclusive
    with ``requests``) runs a *dependency-gated* stream instead of a
    fixed-time one: the scheduling pass walks the graph's estimated-issue
    order and the vectorized task build is reused unchanged, while
    dependency resolution stays in the per-scenario event loop
    (``simulate(deps=...)``).

    ``tracer_factory`` (not an instance — one :class:`repro_torch.obs.Tracer`
    records exactly one run) arms the flight recorder on this scenario's
    simulation; retrieve the armed tracers via the factory's own records
    (e.g. ``lambda: traces.append(Tracer()) or traces[-1]``) or a closure
    per scenario.

    ``faults`` (a :class:`repro_torch.faults.FaultSchedule`) injects a fault
    timeline into this scenario's run; ``replan=True`` additionally arms
    the Themis graceful-degradation hook (re-plans un-issued chunks at
    each BW fault boundary).  Faults are deliberately NOT part of
    :meth:`schedule_key` — the fault-free chunk schedules are what
    re-planning degrades from, so scenarios differing only in faults
    still share one scheduling pass and one task-array build.

    ``engine`` selects the event loop (``"indexed"`` default,
    ``"compiled"`` for the cohort-vectorized fast path, ``"reference"``
    for the oracle).  Like faults it is NOT part of :meth:`schedule_key`:
    engines share schedules and task arrays, which is exactly what makes
    a compiled-vs-indexed differential sweep cheap.
    """

    topology: Topology
    requests: tuple[CollectiveRequest, ...] = ()
    policy: str = "themis"
    chunks_per_collective: int = 64
    water_filling: bool = False
    intra: str = "SCF"
    fusion: bool = True
    fusion_limit: int = 8
    jitter: float = 0.0
    seed: int = 0
    arbiter_factory: Callable[[], Any] | None = None
    preempt_penalty_s: float | None = None
    label: str = ""
    traffic: Any | None = None   # repro_torch.traffic.TrafficGraph
    tracer_factory: Callable[[], Any] | None = None
    faults: Any | None = None    # repro_torch.faults.FaultSchedule
    replan: bool = False
    engine: str = "indexed"

    def __post_init__(self):
        object.__setattr__(self, "requests", tuple(self.requests))
        if self.traffic is not None and self.requests:
            raise ValueError(
                "pass either requests or traffic, not both")
        if self.traffic is None and not self.requests:
            raise ValueError("scenario needs requests or traffic")
        if self.replan and self.faults is None:
            raise ValueError("replan=True requires faults")

    def schedule_key(self) -> tuple:
        """Everything the chunk schedules are a function of."""
        return (self.topology, self.policy, self.requests, self.traffic,
                self.chunks_per_collective, self.water_filling)


def simulate_scenario(scenario: Scenario) -> SimResult:
    """Run one scenario standalone — the un-amortized reference path
    (fresh scheduler, scalar task build, no shared caches) every batch
    result must match bit-for-bit.  This is what a loop of individual
    ``simulate()`` calls does, and the baseline the fleet benchmark times
    ``simulate_batch`` against."""
    sc = scenario
    if sc.traffic is not None:
        from repro_torch.traffic.engine import schedule_traffic

        groups = schedule_traffic(
            sc.topology, sc.traffic, policy=sc.policy,
            chunks_per_collective=sc.chunks_per_collective,
            water_filling=sc.water_filling)
        return _run_scenario(sc, groups, None)
    sched = ThemisScheduler(LatencyModel.for_topology(sc.topology), sc.policy)
    groups = sched.schedule_stream(
        sc.requests, sc.chunks_per_collective,
        water_filling=sc.water_filling)
    return _run_scenario(sc, groups, None)


class BatchCaches:
    """Cross-scenario caches; pass one instance to successive
    :func:`simulate_batch` calls (e.g. search rounds) to keep them warm."""

    _GROUP_CAP = 256        # scheduled chunk-group families
    _CLASS_CAP = 8192       # per-(size, schedule) stage vectors
    _SCHED_CAP = 64         # pooled schedulers — a topology search visits
    #                         hundreds of fabrics; memo reuse only pays
    #                         within one, so cap and clear like the rest

    def __init__(self) -> None:
        self._schedulers: dict[tuple, ThemisScheduler] = {}
        self._groups: dict[tuple, tuple[list[list[Chunk]], TaskArrays]] = {}
        self._class_vectors: dict[tuple, tuple] = {}

    # -- scheduling (shared across seeds/disciplines/arbiters) ---------------
    def _scheduler(self, topology: Topology, policy: str) -> ThemisScheduler:
        key = (topology, policy)
        got = self._schedulers.get(key)
        if got is None:
            if len(self._schedulers) >= self._SCHED_CAP:
                self._schedulers.pop(next(iter(self._schedulers)))
            got = self._schedulers[key] = ThemisScheduler(
                LatencyModel.for_topology(topology), policy)
        return got

    def groups_and_arrays(
        self, sc: Scenario
    ) -> tuple[list[list[Chunk]], TaskArrays]:
        key = sc.schedule_key()
        got = self._groups.get(key)
        if got is None:
            sched = self._scheduler(sc.topology, sc.policy)
            if sc.traffic is not None:
                from repro_torch.traffic.engine import schedule_traffic

                groups = schedule_traffic(
                    sc.topology, sc.traffic, policy=sc.policy,
                    chunks_per_collective=sc.chunks_per_collective,
                    water_filling=sc.water_filling, scheduler=sched)
                pri = [n.priority for n in sc.traffic.nodes]
                ten = [n.tenant_tag for n in sc.traffic.nodes]
            else:
                with sched.isolated_run():
                    groups = sched.schedule_stream(
                        sc.requests, sc.chunks_per_collective,
                        water_filling=sc.water_filling)
                pri = [r.priority for r in sc.requests]
                ten = [r.tenant for r in sc.requests]
            ta = self._build_arrays(sc.topology, groups, pri, ten)
            if len(self._groups) >= self._GROUP_CAP:
                self._groups.pop(next(iter(self._groups)))
            got = self._groups[key] = (groups, ta)
        return got

    # -- vectorized SoA task build -------------------------------------------
    def _build_arrays(
        self,
        topology: Topology,
        chunk_groups: list[list[Chunk]],
        priorities: list[int],
        tenants: list[str],
    ) -> TaskArrays:
        lm = LatencyModel.for_topology(topology)
        reg = current_registry()
        with (reg.span("batch.build_task_arrays") if reg is not None
                else nullcontext()):
            return build_task_arrays_vectorized(lm, chunk_groups, priorities,
                                                tenants, self._class_vectors)


def _factor_key(tbl) -> tuple:
    """Stage vectors depend only on per-dim NPU counts (wire factors) and
    step delays — NOT on bandwidths — so a BW-split search shares them
    across every candidate topology."""
    return (tuple(tbl.npus), tuple(tbl.rs_step), tuple(tbl.ag_step))


def _class_stage_vectors(tbl, size_bytes: float, sched: tuple):
    """Per-stage (dims, wires, fixed delays) of one (size, schedule) class.

    Delegates the float math to the builders' single shared scalar loop
    (:func:`repro_torch.core.simulator.stage_sequence`); it runs once per class
    and is broadcast over every member chunk, which is what makes the
    vectorized builder bit-identical to the scalar one.
    """
    dims, wires, fixeds = stage_sequence(tbl, size_bytes, sched)
    return (np.asarray(dims, dtype=np.int64),
            np.asarray(wires, dtype=np.float64),
            np.asarray(fixeds, dtype=np.float64))


def build_task_arrays_vectorized(
    latency_model: LatencyModel,
    chunk_groups: list[list[Chunk]],
    priorities: list[int],
    tenants: list[str],
    class_cache: dict | None = None,
) -> TaskArrays:
    """Numpy-assembled SoA build, bit-identical to
    :func:`repro_torch.core.simulator.build_task_arrays`.

    Per-stage float math runs once per (size, schedule) equivalence class
    (memoized in ``class_cache`` across groups, scenarios, and — via
    :func:`_factor_key` — across same-shape topologies); numpy only
    gathers, repeats and concatenates the resulting vectors, so no float
    op differs from the scalar path.  ``group_wire`` is accumulated
    scalar-sequentially in task order because float addition is
    order-sensitive and the results must match the scalar build bit-for-
    bit.
    """
    tbl = latency_model.stage_tables
    cache = class_cache if class_cache is not None else {}
    fkey = _factor_key(tbl)
    n_groups = len(chunk_groups)

    chunk_parts: list[np.ndarray] = []
    stage_parts: list[np.ndarray] = []
    dim_parts: list[np.ndarray] = []
    wire_parts: list[np.ndarray] = []
    fixed_parts: list[np.ndarray] = []
    group_lens: list[int] = []      # tasks per group, for t_group/prio/tenant
    last_idx: list[np.ndarray] = []  # absolute handles of final stages
    first_parts: list[np.ndarray] = []
    group_wire = [0.0] * n_groups

    h = 0
    offset = 0
    for g, group in enumerate(chunk_groups):
        scheduled = [c for c in group if c.schedule]
        if not scheduled:
            group_lens.append(0)
            if group:
                offset += max(c.index for c in group) + 1
            continue
        classes, class_of = schedule_classes(scheduled)
        vecs = []
        for key in classes:
            ck = (fkey,) + key
            got = cache.get(ck)
            if got is None:
                if len(cache) >= BatchCaches._CLASS_CAP:
                    cache.pop(next(iter(cache)))
                got = cache[ck] = _class_stage_vectors(tbl, key[0], key[1])
            vecs.append(got)
        lens = {v[0].shape[0] for v in vecs}
        cids = np.fromiter((c.index + offset for c in scheduled),
                           dtype=np.int64, count=len(scheduled))
        sel = np.asarray(class_of, dtype=np.int64)
        if len(lens) == 1:
            # Uniform stage count (the norm: one collective per group) —
            # one fancy-index gather covers the whole group.
            L = lens.pop()
            dims_m = np.stack([v[0] for v in vecs])[sel]
            wires_m = np.stack([v[1] for v in vecs])[sel]
            fixed_m = np.stack([v[2] for v in vecs])[sel]
            n_chunks = len(scheduled)
            dim_parts.append(dims_m.ravel())
            wire_parts.append(wires_m.ravel())
            fixed_parts.append(fixed_m.ravel())
            chunk_parts.append(np.repeat(cids, L))
            stage_parts.append(np.tile(np.arange(L, dtype=np.int64), n_chunks))
            stage_counts = np.full(n_chunks, L, dtype=np.int64)
        else:  # pragma: no cover - mixed-length schedules in one group
            dim_parts.append(np.concatenate([vecs[c][0] for c in class_of]))
            wire_parts.append(np.concatenate([vecs[c][1] for c in class_of]))
            fixed_parts.append(np.concatenate([vecs[c][2] for c in class_of]))
            stage_counts = np.fromiter(
                (vecs[c][0].shape[0] for c in class_of), dtype=np.int64,
                count=len(class_of))
            chunk_parts.append(np.repeat(cids, stage_counts))
            stage_parts.append(np.concatenate(
                [np.arange(n, dtype=np.int64) for n in stage_counts]))
        n_tasks_g = int(stage_counts.sum())
        firsts = h + np.concatenate(
            ([0], np.cumsum(stage_counts[:-1]))) if len(stage_counts) else \
            np.empty(0, dtype=np.int64)
        first_parts.append(firsts)
        last_idx.append(firsts + stage_counts - 1)
        group_lens.append(n_tasks_g)
        # order-sensitive sequential sum — must equal the scalar `gw += wire`
        gw = 0.0
        for w in wire_parts[-1].tolist():
            gw += w
        group_wire[g] = gw
        h += n_tasks_g
        offset += max(c.index for c in group) + 1

    n_tasks = h
    if n_tasks:
        t_chunk = np.concatenate(chunk_parts).tolist()
        t_stage = np.concatenate(stage_parts).tolist()
        t_dim = np.concatenate(dim_parts).tolist()
        t_wire = np.concatenate(wire_parts).tolist()
        t_fixed = np.concatenate(fixed_parts).tolist()
        first_handles = np.concatenate(first_parts).astype(np.int64).tolist()
        t_last = np.zeros(n_tasks, dtype=bool)
        t_last[np.concatenate(last_idx).astype(np.int64)] = True
        t_last = t_last.tolist()
    else:
        t_chunk = t_stage = t_dim = []
        t_wire = t_fixed = []
        first_handles = []
        t_last = []
    t_group: list[int] = []
    t_prio: list[int] = []
    t_tenant: list[str] = []
    for g, n in enumerate(group_lens):
        if n:
            t_group.extend([g] * n)
            t_prio.extend([priorities[g]] * n)
            t_tenant.extend([tenants[g]] * n)
    return TaskArrays(n_tasks, t_chunk, t_stage, t_dim, t_wire, t_fixed,
                      t_group, t_prio, t_tenant, t_last, first_handles,
                      group_wire,
                      task_arrays_fingerprint(chunk_groups, priorities,
                                              tenants))


def _run_scenario(sc: Scenario, groups: list[list[Chunk]],
                  ta: TaskArrays) -> SimResult:
    arb = sc.arbiter_factory() if sc.arbiter_factory is not None else None
    trc = sc.tracer_factory() if sc.tracer_factory is not None else None
    replanner = None
    if sc.replan:
        from repro_torch.faults.replan import make_replanner

        replanner = make_replanner(sc.topology, sc.policy)
    if sc.traffic is not None:
        kw = sc.traffic.sim_kwargs()
    else:
        kw = dict(
            issue_times=[r.issue_time for r in sc.requests],
            priorities=[r.priority for r in sc.requests],
            tenants=[r.tenant for r in sc.requests],
            streams=[r.stream for r in sc.requests])
    return simulate(
        sc.topology, groups,
        intra=sc.intra, fusion=sc.fusion, fusion_limit=sc.fusion_limit,
        jitter=sc.jitter, seed=sc.seed,
        arbiter=arb, preempt_penalty_s=sc.preempt_penalty_s,
        engine=sc.engine, task_arrays=ta, tracer=trc,
        faults=sc.faults, replanner=replanner, **kw)


def simulate_batch(
    scenarios: Sequence[Scenario] | Iterable[Scenario],
    *,
    caches: BatchCaches | None = None,
) -> list[SimResult]:
    """Run N independent scenarios with shared precomputation.

    Results are bit-identical to running each scenario standalone
    (:func:`simulate_scenario`, which honors ``Scenario.engine`` the same
    way); only the amortized work differs.  Pass a :class:`BatchCaches` to keep schedules, task
    arrays and stage vectors warm across successive batches (the topology
    search reuses one across rounds).
    """
    caches = caches if caches is not None else BatchCaches()
    results: list[SimResult] = []
    for sc in scenarios:
        groups, ta = caches.groups_and_arrays(sc)
        results.append(_run_scenario(sc, groups, ta))
    return results
