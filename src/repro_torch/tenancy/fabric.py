"""Shared-fabric entry points: cross-tenant Themis scheduling + joint
simulation under an inter-tenant arbiter.

Two load-tracking modes for the Themis chunk scheduler:

  * **shared tracker** (default, the cross-tenant Themis) — every tenant's
    :class:`~repro_torch.core.scheduler.ThemisScheduler` shares one fabric-wide
    :class:`~repro_torch.core.load_tracker.DimLoadTracker`, so a tenant's chunk
    orders steer around the residual loads *other tenants* have placed on
    each dimension;
  * **per-tenant trackers** (the ablation) — each tenant schedules against
    only its own load view, blind to the rest of the fabric.
"""
from __future__ import annotations

from repro_torch.core.chunking import Chunk
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.load_tracker import DimLoadTracker
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import ThemisScheduler
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.topology import Topology


def schedule_tenant_requests(
    topology: Topology,
    requests: list[CollectiveRequest],
    *,
    policy: str = "themis",
    shared_tracker: bool = True,
    chunks_per_collective: int = 64,
    water_filling: bool = False,
) -> list[list[Chunk]]:
    """Schedule a multi-tenant request stream in global issue order.

    Each tenant gets its own ``ThemisScheduler``; with ``shared_tracker``
    they all observe (and charge) one fabric-wide Dim Load Tracker, so the
    tracker's clock advances monotonically through the merged stream and a
    request sees every tenant's in-flight residual load.  Without it, each
    tenant's tracker only ever sees that tenant's own requests.
    """
    lm = LatencyModel.for_topology(topology)
    shared = DimLoadTracker(lm) if shared_tracker else None
    schedulers: dict[str, ThemisScheduler] = {}
    groups: list[list[Chunk]] = [[] for _ in requests]
    order = sorted(range(len(requests)),
                   key=lambda i: (requests[i].issue_time, i))
    for i in order:
        r = requests[i]
        sched = schedulers.get(r.tenant)
        if sched is None:
            sched = ThemisScheduler(lm, policy, tracker=shared)
            schedulers[r.tenant] = sched
        groups[i] = sched.schedule_request(
            r, chunks_per_collective, water_filling=water_filling)
    return groups


def simulate_fabric(
    topology: Topology,
    requests: list[CollectiveRequest],
    *,
    policy: str = "themis",
    shared_tracker: bool = True,
    arbiter=None,
    chunks_per_collective: int = 64,
    intra: str = "SCF",
    fusion: bool = True,
    water_filling: bool = False,
    engine: str = "indexed",
    check_invariants: bool = False,
    tracer=None,
    faults=None,
    replan: bool = False,
) -> tuple[SimResult, list[list[Chunk]]]:
    """Schedule and simulate a multi-tenant stream on one shared fabric.

    ``arbiter`` (a :class:`~repro_torch.tenancy.arbiter.FabricArbiter`) supplies
    the inter-tenant per-dim discipline and preemption; ``None`` falls back
    to the single-job ``intra`` discipline, i.e. tenants share dims but no
    policy arbitrates between them.  Its ``preempt_penalty_s`` sets the
    re-arm latency preempted chunks pay before requeueing.  ``engine``
    selects the simulator engine (see :func:`repro_torch.core.simulator.simulate`);
    ``"compiled"`` is bit-identical on arbiter-free streams and falls back
    to indexed (documented signal) when an arbiter or tracer is armed.
    ``tracer`` arms the flight recorder (:class:`repro_torch.obs.Tracer`) on the
    joint simulation — tenant lanes in the exported trace come from the
    request tags.  ``faults`` (a :class:`repro_torch.faults.FaultSchedule`)
    injects a fault timeline; ``replan=True`` additionally arms Themis
    graceful degradation.
    """
    if replan and faults is None:
        raise ValueError("replan=True requires faults")
    replanner = None
    if replan:
        from repro_torch.faults.replan import make_replanner

        replanner = make_replanner(topology, policy)
    groups = schedule_tenant_requests(
        topology, requests, policy=policy, shared_tracker=shared_tracker,
        chunks_per_collective=chunks_per_collective,
        water_filling=water_filling)
    res = simulate(
        topology,
        groups,
        issue_times=[r.issue_time for r in requests],
        priorities=[r.priority for r in requests],
        intra=intra,
        fusion=fusion,
        tenants=[r.tenant for r in requests],
        streams=[r.stream for r in requests],
        arbiter=arbiter,
        engine=engine,
        check_invariants=check_invariants,
        tracer=tracer,
        faults=faults,
        replanner=replanner,
    )
    return res, groups


def isolated_latencies(
    topology: Topology,
    requests: list[CollectiveRequest],
    *,
    policy: str = "themis",
    chunks_per_collective: int = 64,
    intra: str = "SCF",
    fusion: bool = True,
) -> dict[str, list[float]]:
    """Per-tenant isolated reference: each tenant's stream simulated alone
    on the full fabric (same arrival pattern, no contention).  Returns
    tenant -> per-request issue-to-finish latencies in that tenant's
    request order — the denominator of every slowdown/SLO metric.
    """
    by_tenant: dict[str, list[CollectiveRequest]] = {}
    for r in requests:
        by_tenant.setdefault(r.tenant, []).append(r)
    out: dict[str, list[float]] = {}
    for tenant, reqs in by_tenant.items():
        res, _ = simulate_fabric(
            topology, reqs, policy=policy, shared_tracker=True,
            chunks_per_collective=chunks_per_collective, intra=intra,
            fusion=fusion)
        out[tenant] = [res.group_finish[i] - res.group_issue[i]
                       for i in range(len(reqs))]
    return out
