"""Per-tenant fairness / SLO metrics over a joint fabric simulation.

Slowdown is measured per request — joint issue-to-finish latency over the
same request's latency when the tenant runs alone — then averaged per
tenant; Jain's fairness index over per-tenant slowdowns summarizes how
evenly contention is shared (1.0 = all tenants degrade equally).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.simulator import SimResult
from repro_torch.tenancy.tenants import TenantSpec


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index: (sum x)^2 / (n * sum x^2), in (0, 1]."""
    xs = [x for x in xs]
    if not xs:
        return 1.0
    sq = sum(x * x for x in xs)
    if sq == 0:
        return 1.0
    return sum(xs) ** 2 / (len(xs) * sq)


@dataclass(frozen=True)
class TenantReport:
    tenant: str
    n_requests: int
    finish_s: float            # last request drained
    mean_latency_s: float
    mean_slowdown: float | None   # None when no isolated reference
    slo_slowdown: float | None
    slo_violated: bool | None
    wire_bytes: float
    bw_share: float            # fraction of all wire bytes moved


def tenant_reports(
    res: SimResult,
    requests: list[CollectiveRequest],
    isolated: Mapping[str, list[float]] | None = None,
    specs: Mapping[str, TenantSpec] | None = None,
) -> dict[str, TenantReport]:
    """Aggregate a joint run into per-tenant reports.

    ``isolated`` maps tenant -> per-request isolated latencies in that
    tenant's request order (see
    :func:`repro_torch.tenancy.fabric.isolated_latencies`).
    """
    isolated = isolated or {}
    specs = specs or {}
    # aggregation (finish / latency / wire) comes from the SimResult helper;
    # only the per-request slowdown ratios need the request ordering
    stats = res.stream_stats(by="tenant")
    members: dict[str, list[int]] = {}
    for g, r in enumerate(requests):
        members.setdefault(r.tenant, []).append(g)
    total_wire = sum(s.wire_bytes for s in stats.values()) or 1.0
    out: dict[str, TenantReport] = {}
    for tenant, gs in members.items():
        st = stats[tenant]
        iso = isolated.get(tenant)
        slowdown = None
        if iso and len(iso) == len(gs):
            lats = [res.group_finish[g] - res.group_issue[g] for g in gs]
            ratios = [l / i for l, i in zip(lats, iso) if i > 0]
            slowdown = sum(ratios) / len(ratios) if ratios else None
        spec = specs.get(tenant)
        slo = spec.slo_slowdown if spec else None
        out[tenant] = TenantReport(
            tenant=tenant,
            n_requests=st.n,
            finish_s=st.finish,
            mean_latency_s=st.latency_mean,
            mean_slowdown=slowdown,
            slo_slowdown=slo,
            slo_violated=(None if slowdown is None or slo is None
                          else slowdown > slo),
            wire_bytes=st.wire_bytes,
            bw_share=st.wire_bytes / total_wire,
        )
    return out


def fairness_index(reports: Mapping[str, TenantReport]) -> float | None:
    """Jain's index over per-tenant mean slowdowns (needs references)."""
    sd = [r.mean_slowdown for r in reports.values()]
    if any(s is None for s in sd):
        return None
    return jain_index([s for s in sd if s is not None])


def mean_slowdown(reports: Mapping[str, TenantReport]) -> float | None:
    sd = [r.mean_slowdown for r in reports.values()]
    if not sd or any(s is None for s in sd):
        return None
    return sum(sd) / len(sd)


def slo_violations(reports: Mapping[str, TenantReport]) -> int:
    return sum(1 for r in reports.values() if r.slo_violated)
