"""Tenants: workloads sharing one multi-dimensional fabric.

A :class:`TenantSpec` describes a tenant's share contract — scheduling
weight, optional strict priority, an SLO expressed as the maximum
acceptable slowdown versus running alone, and its arrival offset on the
shared fabric.  A :class:`TenantJob` binds a spec to a workload and emits
its traffic in either representation:

  * :meth:`TenantJob.requests` — the fixed-time backprop bucket stream
    (``dp_bucket_requests``) over many iterations, as tenant-tagged
    :class:`~repro_torch.core.requests.CollectiveRequest`s (open-loop: iteration
    starts are clocked by a fixed period regardless of contention);
  * :meth:`TenantJob.traffic` — a dependency-gated
    :class:`~repro_torch.traffic.TrafficGraph` (closed-loop training by default;
    any graph via ``traffic_builder`` — e.g. a *serving* prefill/decode
    tenant, which has no training workload at all), namespaced and tagged
    with the tenant's name so :func:`tenant_traffic` can merge many
    tenants onto one fabric under the existing arbiters.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Callable, Iterable

from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.workloads import Workload, dp_bucket_requests

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for type hints
    from repro_torch.traffic.ir import TrafficGraph


@dataclass(frozen=True)
class TenantSpec:
    """Share contract of one tenant on the shared fabric.

    ``weight``        — weighted-fair share (bytes-weighted max-min).
    ``priority``      — strict-priority rank (higher preempts lower).
    ``slo_slowdown``  — max acceptable slowdown vs. running alone
                        (None: best-effort, no SLO).
    ``arrival_offset_s`` — when the tenant's first iteration starts.
    ``iterations``    — how many training iterations to emit.
    ``n_buckets``     — gradient buckets per iteration.
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    slo_slowdown: float | None = None
    arrival_offset_s: float = 0.0
    iterations: int = 1
    n_buckets: int = 8

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.slo_slowdown is not None and self.slo_slowdown < 1.0:
            raise ValueError("slo_slowdown is a slowdown factor; must be >= 1")
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")
        if self.n_buckets < 1:
            raise ValueError("n_buckets must be >= 1")


@dataclass
class TenantJob:
    """A tenant running a workload on the shared fabric.

    With a training ``workload``, :meth:`requests` emits the gradient
    bucket stream per iteration, tagged with the tenant's name: iteration
    *i*'s backward pass starts at
    ``arrival_offset + i * period + compute_fwd``; its buckets issue
    progressively through the backward pass exactly as in the single-job
    overlap engine.  ``iteration_gap_s`` overrides the period between
    iteration starts (default: the workload's full compute time —
    communication-bound tenants then overlap their own iterations too).

    ``traffic_builder`` makes the tenant's traffic an arbitrary
    dependency-gated graph instead (see :meth:`traffic`) — serving tenants
    pass e.g. ``lambda job: serving_traffic(...)`` and need no training
    workload.
    """

    spec: TenantSpec
    workload: Workload | None = None
    iteration_gap_s: float | None = None
    traffic_builder: Callable[["TenantJob"], "TrafficGraph"] | None = None

    def _require_workload(self) -> Workload:
        if self.workload is None:
            raise ValueError(
                f"tenant {self.spec.name!r} has no training workload; "
                "give it one or use traffic() with a traffic_builder")
        return self.workload

    @property
    def period_s(self) -> float:
        if self.iteration_gap_s is not None:
            return self.iteration_gap_s
        return self._require_workload().compute_s

    def requests(self) -> list[CollectiveRequest]:
        out: list[CollectiveRequest] = []
        base = dp_bucket_requests(self._require_workload(),
                                  self.spec.n_buckets)
        for it in range(self.spec.iterations):
            t0 = (self.spec.arrival_offset_s + it * self.period_s
                  + self.workload.compute_fwd_s)
            for r in base:
                out.append(replace(
                    r,
                    issue_time=t0 + r.issue_time,
                    priority=self.spec.priority,
                    tenant=self.spec.name,
                    stream=f"{self.spec.name}/it{it}/{r.stream}",
                ))
        return out

    def traffic(self) -> "TrafficGraph":
        """The tenant's dependency-gated traffic graph.

        ``traffic_builder(self)`` when given, else the closed-loop
        :func:`~repro_torch.traffic.training_traffic` re-expression of this
        tenant's training stream (``iteration_gap_s`` becomes the
        iteration-start floor).  Either way the graph is namespaced under
        the tenant's name, its requests tagged/prioritized per the spec,
        and shifted by the arrival offset — ready to merge with other
        tenants via :func:`tenant_traffic`.
        """
        from repro_torch.traffic.builders import training_traffic
        from repro_torch.traffic.ir import retag

        if self.traffic_builder is not None:
            g = self.traffic_builder(self)
        else:
            g = training_traffic(
                self._require_workload(), n_buckets=self.spec.n_buckets,
                iterations=self.spec.iterations,
                min_period_s=self.iteration_gap_s)
        s = self.spec
        return retag(g, name_prefix=f"{s.name}/", tenant=s.name,
                     stream_prefix=f"{s.name}/", priority=s.priority,
                     start_offset_s=s.arrival_offset_s)


def tenant_traffic(jobs: Iterable[TenantJob]) -> "TrafficGraph":
    """Merge every tenant's traffic graph into one fabric-wide graph —
    training and serving tenants mix freely; run it with
    ``repro_torch.traffic.simulate_traffic(..., arbiter=FabricArbiter(...))``."""
    from repro_torch.traffic.ir import merge_graphs

    return merge_graphs(*(job.traffic() for job in jobs))


def synthetic_requests(
    name: str,
    collective: str,
    size_bytes: float,
    count: int,
    gap_s: float = 0.0,
    start_s: float = 0.0,
    priority: int = 0,
) -> list[CollectiveRequest]:
    """A synthetic tenant stream: ``count`` equal collectives, ``gap_s``
    apart, starting at ``start_s`` — handy for arbiter tests and studies
    that do not need a full workload model."""
    return [
        CollectiveRequest(collective, size_bytes,
                          issue_time=start_s + i * gap_s,
                          priority=priority, stream=name, tenant=name)
        for i in range(count)
    ]
