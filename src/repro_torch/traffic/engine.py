"""Schedule and simulate traffic graphs on the collective engine.

Scheduling a dependency-gated stream has a chicken-and-egg problem: the
Themis chunk orders depend on each request's issue time, but with
dependencies the issue times are an *output* of the simulation.  The
resolution mirrors how the real system behaves — requests arrive online:

  * the **scheduling pass** walks request nodes in a deterministic
    estimated-issue order (:meth:`TrafficGraph.estimate_times`: dependency
    resolution against contention-free ``ideal_time`` durations) through
    ``ThemisScheduler.schedule_request``, so the Dim Load Tracker's
    running-load view advances exactly as in the fixed-time path;
  * the **simulation pass** (``simulate(deps=...)``) gates each group's
    release on its predecessors' *actual* finish times — dependency
    resolution stays in the event loop, where contention lives.

For a dependency-free graph the estimates are exact, the scheduling order
equals ``ThemisScheduler.schedule_stream``'s, and results are bit-identical
to ``simulate_requests`` (pinned by the differential suite).
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace

from repro_torch.core.chunking import Chunk
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.topology import Topology

from repro_torch.traffic.ir import TrafficGraph


def schedule_traffic(
    topology: Topology,
    graph: TrafficGraph,
    *,
    policy: str = "themis",
    chunks_per_collective: int = 64,
    water_filling: bool = False,
    scheduler=None,
) -> list[list[Chunk]]:
    """Chunk-schedule every request node of ``graph`` (estimated-issue
    order, one incremental scheduler), returning chunk groups indexed like
    ``graph.nodes`` (compute nodes get an empty group).

    ``scheduler`` follows the ``simulate_requests`` reuse contract: a
    shared ``ThemisScheduler`` keeps its memo caches warm across calls but
    schedules against a scenario-local tracker (``isolated_run``).
    """
    from repro_torch.core.scheduler import ThemisScheduler

    lm = LatencyModel.for_topology(topology)
    est_issue, _ = graph.estimate_times(lm)
    if scheduler is None:
        sched_ctx = ThemisScheduler(lm, policy).isolated_run()
    else:
        if scheduler.latency_model.topology != topology:
            raise ValueError(
                "scheduler was built for topology "
                f"{scheduler.latency_model.topology.name!r}; reusing its "
                f"memos on {topology.name!r} is unspecified — build one "
                "scheduler per topology")
        sched_ctx = scheduler.isolated_run()
    groups: list[list[Chunk]] = [[] for _ in graph.nodes]
    order = sorted(
        (i for i, n in enumerate(graph.nodes) if n.request is not None),
        key=lambda i: (est_issue[i], i))
    with sched_ctx as sched:
        for i in order:
            req = _dc_replace(graph.nodes[i].request,
                              issue_time=est_issue[i])
            groups[i] = sched.schedule_request(
                req, chunks_per_collective, water_filling=water_filling)
    return groups


def simulate_traffic(
    topology: Topology,
    graph: TrafficGraph,
    *,
    policy: str = "themis",
    chunks_per_collective: int = 64,
    intra: str = "SCF",
    fusion: bool = True,
    water_filling: bool = False,
    jitter: float = 0.0,
    seed: int = 0,
    arbiter=None,
    preempt_penalty_s: float | None = None,
    engine: str = "indexed",
    scheduler=None,
    check_invariants: bool = False,
    tracer=None,
    faults=None,
    replan: bool = False,
    admission=None,
) -> tuple[SimResult, list[list[Chunk]]]:
    """Schedule and simulate a traffic graph — the dependency-aware
    counterpart of ``simulate_requests``.

    ``tracer`` arms the flight recorder (:class:`repro_torch.obs.Tracer`); on a
    dependency-gated graph the exported Chrome trace carries flow arrows
    for every resolved dependency edge.

    ``faults`` (a :class:`repro_torch.faults.FaultSchedule`) injects a fault
    timeline; ``replan=True`` additionally arms Themis graceful
    degradation (re-plan un-issued chunks at each BW fault boundary).

    ``admission`` (a :class:`repro_torch.fleet.AdmissionController`) puts an
    admission/shedding gate in front of the engines — shed requests land
    in ``SimResult.shed_groups`` (traffic graphs always carry deps, the
    admission prerequisite).

    The returned ``SimResult`` is indexed like ``graph.nodes``:
    ``group_issue`` holds each node's *resolved* issue time, so
    ``stream_stats()`` latencies measure eligibility-to-finish (queueing +
    service) per request — the right denominator for serving SLOs.
    Multi-tenant graphs run under ``arbiter`` exactly like request streams
    (the per-dim inter-tenant disciplines and preemption are downstream of
    release, so they compose with dependency gating unchanged).

    ``engine="compiled"`` runs the cohort-vectorized fast path; dependency
    gating is on its supported surface, so dep-heavy serving graphs get
    the speedup bit-identically (arbiter/tracer/faults/admission scenarios
    fall back to indexed with the documented signal).
    """
    if replan and faults is None:
        raise ValueError("replan=True requires faults")
    replanner = None
    if replan:
        from repro_torch.faults.replan import make_replanner

        replanner = make_replanner(topology, policy)
    groups = schedule_traffic(
        topology, graph, policy=policy,
        chunks_per_collective=chunks_per_collective,
        water_filling=water_filling, scheduler=scheduler)
    res = simulate(
        topology, groups, intra=intra, fusion=fusion, jitter=jitter,
        seed=seed, arbiter=arbiter, preempt_penalty_s=preempt_penalty_s,
        engine=engine, check_invariants=check_invariants, tracer=tracer,
        faults=faults, replanner=replanner, admission=admission,
        **graph.sim_kwargs())
    return res, groups
