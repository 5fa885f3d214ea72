"""Themis core — the paper's contribution, in the port.

Scheduling (Algorithm 1), latency model (Sec. 4.4), chunking, consistency
(Sec. 4.6), the multi-rail simulator used for evaluation (its three
engines ``indexed``, ``compiled`` and ``reference``), the Fig. 12
workload models, the batch runner and the Sec. 6.3 provisioning analysis:
the port's copies of ``repro/core``, imports aside.  The simulator runs on
the host, as the reference's does; the compiled engine's wave kernel
(``engine_compiled.wave_done_times``) runs on the card.  ``arbiter``
(``repro_torch.tenancy``), ``faults`` and ``replanner``
(``repro_torch.faults``), a scenario's ``traffic``
(``repro_torch.traffic``) and ``admission`` (``repro_torch.fleet``) run as
in the reference.
"""
from repro_torch.core.chunking import Chunk, coalesce_by_order, schedule_classes, split_equal
from repro_torch.core.consistency import fix_intra_dim_order, verify_consistent_execution
from repro_torch.core.latency_model import LatencyModel, StageOp, stage_transition
from repro_torch.core.load_tracker import DimLoadTracker
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import (
    POLICIES,
    ThemisScheduler,
    baseline_order,
    schedule_collective,
)
from repro_torch.core.simulator import (
    SimResult,
    simulate,
    simulate_requests,
    simulate_scheduled,
)

def __getattr__(name):
    # The batch layer needs numpy; everything else in repro_torch.core is
    # stdlib-only.  Lazy loading keeps `import repro_torch.core` working in
    # numpy-less environments for users who never touch it (same pattern
    # as repro.topology's search symbols).
    if name in ("BatchCaches", "Scenario", "simulate_batch",
                "simulate_scenario"):
        from repro_torch.core import batch

        return getattr(batch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchCaches",
    "Chunk",
    "CollectiveRequest",
    "DimLoadTracker",
    "LatencyModel",
    "POLICIES",
    "Scenario",
    "SimResult",
    "StageOp",
    "ThemisScheduler",
    "baseline_order",
    "coalesce_by_order",
    "fix_intra_dim_order",
    "schedule_classes",
    "schedule_collective",
    "simulate",
    "simulate_batch",
    "simulate_requests",
    "simulate_scenario",
    "simulate_scheduled",
    "split_equal",
    "stage_transition",
    "verify_consistent_execution",
]
