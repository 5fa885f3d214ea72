"""Fault-injection fabric: deterministic fault timelines, outage retry
semantics, and Themis re-planning under degraded bandwidth.

See :mod:`repro_torch.faults.schedule` for the timeline model and
:mod:`repro_torch.faults.replan` for the graceful-degradation hook.

The port's copy of ``repro/faults``, imports aside: plain Python, as the
reference is (the simulator runs on the host).
"""
from repro_torch.faults.replan import degraded_topology, make_replanner
from repro_torch.faults.schedule import (
    BwDegradation,
    CompiledFaults,
    DimOutage,
    FaultBoundary,
    FaultSchedule,
    LinkFlap,
    RetryPolicy,
    StragglerBurst,
)

__all__ = [
    "BwDegradation",
    "CompiledFaults",
    "DimOutage",
    "FaultBoundary",
    "FaultSchedule",
    "LinkFlap",
    "RetryPolicy",
    "StragglerBurst",
    "degraded_topology",
    "make_replanner",
]
