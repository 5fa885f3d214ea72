"""Multi-tenant fabric scheduling (beyond paper).

Themis (Sec. 4.4) balances dimension loads *within* one job's collectives;
this package grows the arrival-time-aware engine into a shared-fabric
multi-tenant subsystem: tenants wrap workload request streams with share
contracts (weight / priority / SLO), a :class:`FabricArbiter` arbitrates
per-dimension service between tenants (fifo, strict-priority,
weighted-fair, slo-aware) with chunk-granularity preemption, and the
cross-tenant Themis mode shares one fabric-wide Dim Load Tracker so every
tenant's chunk orders steer around the other tenants' residual loads.

The port's copy of ``repro/tenancy``, imports aside: plain Python, as the
reference is.  Give the port's simulator arbiters of this package: the
indexed engine takes only its own ``FabricArbiter``, and runs any other
object (one of the reference's included) on the reference engine.
"""
from repro_torch.tenancy.arbiter import ARBITER_POLICIES, FabricArbiter
from repro_torch.tenancy.elastic import SloDebtArbiter
from repro_torch.tenancy.fabric import (
    isolated_latencies,
    schedule_tenant_requests,
    simulate_fabric,
)
from repro_torch.tenancy.metrics import (
    TenantReport,
    fairness_index,
    jain_index,
    mean_slowdown,
    slo_violations,
    tenant_reports,
)
from repro_torch.tenancy.tenants import (
    TenantJob,
    TenantSpec,
    synthetic_requests,
    tenant_traffic,
)

__all__ = [
    "ARBITER_POLICIES",
    "FabricArbiter",
    "SloDebtArbiter",
    "TenantJob",
    "TenantReport",
    "TenantSpec",
    "fairness_index",
    "isolated_latencies",
    "jain_index",
    "mean_slowdown",
    "schedule_tenant_requests",
    "simulate_fabric",
    "slo_violations",
    "synthetic_requests",
    "tenant_reports",
    "tenant_traffic",
]
