"""Observability: event tracing, BW timelines, and scheduler metrics.

Off by default and zero-overhead when disabled — instrumented code pays
one ``if trc is not None`` / ``if reg is not None`` branch per event and
nothing else, and an armed tracer never perturbs results (hooks are
append-only; they consume no tie-break sequence numbers and no jitter
RNG draws, so traced runs are bit-identical to untraced ones — asserted
by ``benchmarks/obs_study.py`` and ``tests/test_engine_equiv.py``).

    from repro_torch.obs import Tracer, BwTimeline
    trc = Tracer()
    res = simulate(topo, groups, tracer=trc)
    trc.save("run.trace.json")            # open in https://ui.perfetto.dev
    tl = BwTimeline.from_tracer(trc)
    shares = tl.per_dim_shares(window=0.05)
"""
from repro_torch.obs.metrics import (
    MetricsRegistry,
    ScheduleDecision,
    current_registry,
    disable_global,
    enable_global,
)
from repro_torch.obs.timeline import BwTimeline
from repro_torch.obs.tracer import Tracer, parse_chrome_trace

__all__ = [
    "Tracer",
    "parse_chrome_trace",
    "BwTimeline",
    "MetricsRegistry",
    "ScheduleDecision",
    "enable_global",
    "disable_global",
    "current_registry",
]
