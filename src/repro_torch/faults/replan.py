"""Graceful-degradation re-planning against a faulted fabric.

Themis's whole objective is load balance *against each dim's bandwidth* —
so when a fault changes a dim's effective BW mid-run, the chunk orders
computed for the healthy fabric are no longer balanced (a chunk that
fronts its ReduceScatter on a now-slow dim carries ~P x more wire bytes
over it than one that defers the dim to the end of the order).  The
re-planner recomputes the paper's objective on a *degraded topology*:
the same fabric with each dim's ``link_gbps`` scaled by the fault
timeline's current per-dim factor (fully-out dims clamped to a tiny
floor so the greedy scheduler steers everything it can away from them).

``make_replanner`` builds the closure the engines call at fault
boundaries; the heavy lifting is
:meth:`repro_torch.core.scheduler.ThemisScheduler.replan_degraded`, which
re-plans only the **un-issued** chunks of **pending** (not-yet-started)
request groups — in-flight work is never rewritten, so conservation
invariants keep holding.  The hook is deterministic and consumes no RNG,
which keeps the two engines in lockstep.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from repro_torch.topology import Topology


def degraded_topology(base: Topology, factors: Sequence[float], *,
                      floor: float = 1e-6,
                      name: str | None = None) -> Topology:
    """``base`` with each dim's ``link_gbps`` scaled by ``factors[d]``.

    Fully-out dims (factor 0) are clamped to ``floor`` x nominal rather
    than zero: the latency model needs finite rates, and a near-zero BW
    makes the scheduler's water-filling push all movable load onto the
    surviving dims — which is exactly the re-planning objective.
    """
    if len(factors) != base.num_dims:
        raise ValueError(
            f"factors must have one entry per dim "
            f"({len(factors)} != {base.num_dims})")
    dims = []
    for d, f in zip(base.dims, factors):
        if not 0.0 <= f <= 1.0:
            raise ValueError(f"BW factor {f!r} out of range [0, 1]")
        dims.append(replace(d, link_gbps=d.link_gbps * max(f, floor)))
    label = name or f"{base.name}@degraded"
    return Topology(label, tuple(dims))


def make_replanner(topology: Topology, policy: str = "themis", *,
                   bw_floor: float = 1e-6):
    """Build the graceful-degradation hook for ``simulate(replanner=...)``.

    The returned callable has the engine-facing signature
    ``replanner(now, factors, pending) -> {group_id: chunks}`` where
    ``pending`` is ``[(group_id, issue_time, chunks), ...]`` in issue
    order and ``factors`` is the current per-dim BW multiplier vector.
    """
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.core.scheduler import ThemisScheduler

    base = ThemisScheduler(LatencyModel.for_topology(topology), policy)

    def replanner(now, factors, pending):
        return base.replan_degraded(pending, factors, bw_floor=bw_floor)

    return replanner
