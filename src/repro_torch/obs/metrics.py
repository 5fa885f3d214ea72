"""Counters, span timers, and scheduler decision logs.

A :class:`MetricsRegistry` is the sink ``ThemisScheduler`` (and the batch
runner) report into: monotonically increasing counters (memo-cache
hits/misses, schedule passes), wall-clock span timers around expensive
phases (schedule passes, vectorized task builds), and a bounded log of
per-request :class:`ScheduleDecision` records (chosen chunk order +
load-rank signature): the answer to "why did the scheduler pick this
order".

Instrumented code holds a registry that may be ``None`` (the default) and
guards every call site on it, mirroring the tracer's zero-overhead
contract.  For CLI surfacing (``benchmarks/run.py --trace``) there is a
process-global registry — :func:`enable_global` / :func:`current_registry`
— so benchmarks that construct schedulers internally get instrumented
without threading a parameter through every entry point.

Wall-clock timing lives here (and only here): the engine/scheduler lint
forbids ``perf_counter`` in `repro.core`/`repro.tenancy`, so spans are
measured behind this module boundary.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ScheduleDecision:
    """One scheduler choice: which chunk order a request got and why."""

    collective: str          # "AR" / "RS" / "AG"
    tenant: str
    policy: str
    chunk_order: tuple[int, ...]   # dim visit order of the first chunk
    rank_signature: tuple    # load-rank memo key the order was derived from
    cache_hit: bool          # served from the greedy-order memo?
    num_chunks: int


@dataclass
class MetricsRegistry:
    """Counters + span timers + a bounded decision log.

    ``max_decisions`` bounds the decision log (FIFO eviction) so long
    sweeps can leave a registry enabled without unbounded growth.
    """

    max_decisions: int = 10_000
    counters: dict[str, int] = field(default_factory=dict)
    spans: dict[str, list[float]] = field(default_factory=dict)
    decisions: list[ScheduleDecision] = field(default_factory=list)

    # -- counters ------------------------------------------------------------
    def inc(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    # -- span timers ---------------------------------------------------------
    @contextmanager
    def span(self, name: str):
        """Time a with-block on the wall clock; durations accumulate per
        span name (seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(
                time.perf_counter() - t0)

    # -- decision log --------------------------------------------------------
    def log_decision(self, decision: ScheduleDecision) -> None:
        self.decisions.append(decision)
        if len(self.decisions) > self.max_decisions:
            del self.decisions[: len(self.decisions) - self.max_decisions]

    # -- reporting -----------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """JSON-friendly dump: counters, span aggregates, decision count."""
        return {
            "counters": dict(sorted(self.counters.items())),
            "spans": {
                name: {
                    "count": len(times),
                    "total_s": sum(times),
                    "max_s": max(times),
                }
                for name, times in sorted(self.spans.items())
            },
            "decisions": len(self.decisions),
        }

    def report_rows(self) -> list[str]:
        """Human-readable summary lines for CLI output."""
        rows = []
        for name, v in sorted(self.counters.items()):
            rows.append(f"  counter  {name:<40s} {v}")
        for name, times in sorted(self.spans.items()):
            rows.append(
                f"  span     {name:<40s} n={len(times)} "
                f"total={sum(times) * 1e3:.2f}ms "
                f"max={max(times) * 1e3:.3f}ms")
        rows.append(f"  decisions logged: {len(self.decisions)}")
        return rows


# -- process-global registry (CLI surfacing) ---------------------------------
_GLOBAL: MetricsRegistry | None = None


def enable_global(max_decisions: int = 10_000) -> MetricsRegistry:
    """Install (and return) a process-global registry.  Schedulers built
    afterwards with ``metrics=None`` pick it up."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry(max_decisions=max_decisions)
    return _GLOBAL


def disable_global() -> None:
    global _GLOBAL
    _GLOBAL = None


def current_registry() -> MetricsRegistry | None:
    """The process-global registry, or ``None`` when metrics are off."""
    return _GLOBAL
