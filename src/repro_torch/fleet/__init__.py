"""Overload-resilient serving fleet (beyond paper).

The demand-side half of robustness: where ``repro_torch.faults``
breaks the *fabric* mid-run, this package breaks the *load* — open-loop
seeded arrival processes (Poisson / diurnal / MMPP-bursty / trace
replay) feed ``serving_traffic`` request chains past saturation, an
:class:`AdmissionController` in front of both engines sheds what the
fabric cannot serve (``SimResult.shed_groups``, distinct from
``failed_groups``), and :class:`~repro_torch.tenancy.elastic.SloDebtArbiter`
re-weights tenants from accumulated slowdown *debt* over a horizon
instead of the instantaneous slo-aware boost.  ``benchmarks/
fleet_study.py`` sweeps offered load through and past the knee.

The port's copy of ``repro/fleet``, imports aside: plain Python, as the
reference is.  Arrival times come from the stdlib's ``random.Random(seed)``,
as in the reference, so the draws are the reference's to the bit.  Build one
:class:`AdmissionController` per run and hand it to the port's simulator
only: it keeps per-run state.
"""
from repro_torch.fleet.admission import (
    ADMISSION_POLICIES,
    AdmissionController,
    calibrate_admission,
    unit_of_group,
)
from repro_torch.fleet.arrivals import (
    ArrivalProcess,
    DiurnalArrivals,
    FleetTenant,
    MMPPArrivals,
    PoissonArrivals,
    TraceArrivals,
    fleet_tenant_specs,
    fleet_traffic,
)

__all__ = [
    "ADMISSION_POLICIES",
    "AdmissionController",
    "ArrivalProcess",
    "DiurnalArrivals",
    "FleetTenant",
    "MMPPArrivals",
    "PoissonArrivals",
    "TraceArrivals",
    "calibrate_admission",
    "fleet_tenant_specs",
    "fleet_traffic",
    "unit_of_group",
]
