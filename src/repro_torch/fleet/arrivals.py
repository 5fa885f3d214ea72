"""Open-loop arrival processes for the serving fleet.

Everything upstream of this module is *closed-loop*: a fixed tenant set
issues a fixed request list and the only question is how fast the fabric
drains it.  The planetary-scale serving regime is open-loop — users keep
arriving whether or not the fabric is keeping up — so offered load is an
exogenous *process*, not a list.  This module provides the seeded,
deterministic generators that turn a rate profile into concrete arrival
times:

- :class:`PoissonArrivals` — homogeneous Poisson (exponential gaps);
- :class:`DiurnalArrivals` — sinusoidally modulated Poisson via thinning
  (peak-hour / trough-hour daily cycle);
- :class:`MMPPArrivals` — Markov-modulated Poisson (bursty: cycles
  through states with different rates and exponential dwell times);
- :class:`TraceArrivals` — replay of an explicit timestamp trace.

All generators are **stateless**: ``times()`` constructs a fresh
``random.Random(seed)`` on every call, so the same generator object
yields bit-identical streams when called twice (the determinism the
differential engine tests rely on).

:func:`fleet_traffic` assembles a multi-tenant traffic graph by feeding
each tenant's arrival times into the ``serving_traffic`` builder and
merging the per-tenant graphs; :func:`fleet_tenant_specs` derives the
matching arbiter share contracts.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

from repro_torch.traffic.builders import serving_traffic
from repro_torch.traffic.ir import TrafficGraph, merge_graphs, retag
from repro_torch.tenancy.tenants import TenantSpec

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "DiurnalArrivals",
    "MMPPArrivals",
    "TraceArrivals",
    "FleetTenant",
    "fleet_traffic",
    "fleet_tenant_specs",
]


def _check_bounds(n, horizon_s) -> None:
    if n is None and horizon_s is None:
        raise ValueError("times() needs n=, horizon_s=, or both")
    if n is not None and n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if horizon_s is not None and horizon_s < 0:
        raise ValueError(f"horizon_s must be >= 0, got {horizon_s}")


class ArrivalProcess:
    """Base class: a seeded, re-callable arrival-time generator."""

    def times(self, *, n: int | None = None,
              horizon_s: float | None = None) -> list[float]:
        """Arrival times (seconds, ascending), bounded by count/horizon.

        At least one of ``n`` (max arrivals) and ``horizon_s`` (max time
        past ``start_s``) must be given.  Calling twice with the same
        bounds returns bit-identical lists.
        """
        raise NotImplementedError


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate_rps`` requests/second."""

    rate_rps: float
    seed: int = 0
    start_s: float = 0.0

    def __post_init__(self) -> None:
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")

    def times(self, *, n: int | None = None,
              horizon_s: float | None = None) -> list[float]:
        _check_bounds(n, horizon_s)
        rng = random.Random(self.seed)
        out: list[float] = []
        t = self.start_s
        end = None if horizon_s is None else self.start_s + horizon_s
        while n is None or len(out) < n:
            t += rng.expovariate(self.rate_rps)
            if end is not None and t > end:
                break
            out.append(t)
        return out


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidally modulated Poisson (daily peak/trough cycle).

    Instantaneous rate ``rate_rps * (1 + amplitude*sin(2π(t-phase)/period))``
    realized by thinning a homogeneous process at the peak rate — the
    standard exact method for inhomogeneous Poisson simulation.
    """

    rate_rps: float
    amplitude: float = 0.5
    period_s: float = 86400.0
    phase_s: float = 0.0
    seed: int = 0
    start_s: float = 0.0

    def __post_init__(self) -> None:
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1), got {self.amplitude}")
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate at absolute time ``t``."""
        phase = 2.0 * math.pi * (t - self.phase_s) / self.period_s
        return self.rate_rps * (1.0 + self.amplitude * math.sin(phase))

    def times(self, *, n: int | None = None,
              horizon_s: float | None = None) -> list[float]:
        _check_bounds(n, horizon_s)
        rng = random.Random(self.seed)
        peak = self.rate_rps * (1.0 + self.amplitude)
        out: list[float] = []
        t = self.start_s
        end = None if horizon_s is None else self.start_s + horizon_s
        while n is None or len(out) < n:
            t += rng.expovariate(peak)
            if end is not None and t > end:
                break
            if rng.random() * peak <= self.rate_at(t):
                out.append(t)
        return out


@dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """Markov-modulated Poisson: bursty arrivals via cycling rate states.

    The process visits ``rates[k]`` for an exponential dwell with mean
    ``dwell_s[k]``, then moves to the next state cyclically.  Within a
    state, arrivals are Poisson at that state's rate; candidate gaps
    that cross a state boundary are truncated and redrawn at the new
    rate — exact for Poisson by memorylessness.  A two-state
    (calm, burst) configuration is the classic bursty-traffic model.
    """

    rates: tuple[float, ...]
    dwell_s: tuple[float, ...]
    seed: int = 0
    start_s: float = 0.0

    def __post_init__(self) -> None:
        if len(self.rates) < 2:
            raise ValueError("MMPP needs >= 2 states")
        if len(self.dwell_s) != len(self.rates):
            raise ValueError(
                f"dwell_s has {len(self.dwell_s)} entries for "
                f"{len(self.rates)} rates")
        if any(r < 0 for r in self.rates):
            raise ValueError(f"rates must be >= 0, got {self.rates}")
        if not any(r > 0 for r in self.rates):
            raise ValueError("at least one state rate must be > 0")
        if any(d <= 0 for d in self.dwell_s):
            raise ValueError(f"dwell_s must be > 0, got {self.dwell_s}")

    def times(self, *, n: int | None = None,
              horizon_s: float | None = None) -> list[float]:
        _check_bounds(n, horizon_s)
        rng = random.Random(self.seed)
        out: list[float] = []
        t = self.start_s
        end = None if horizon_s is None else self.start_s + horizon_s
        state = 0
        state_end = t + rng.expovariate(1.0 / self.dwell_s[0])
        while n is None or len(out) < n:
            rate = self.rates[state]
            if rate <= 0.0:
                # Silent state: no arrivals until the next transition.
                t = state_end
            else:
                cand = t + rng.expovariate(rate)
                if cand <= state_end:
                    if end is not None and cand > end:
                        break
                    out.append(cand)
                    t = cand
                    continue
                t = state_end
            if end is not None and t > end:
                break
            state = (state + 1) % len(self.rates)
            state_end = t + rng.expovariate(1.0 / self.dwell_s[state])
        return out


@dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay an explicit, ascending timestamp trace."""

    trace: tuple[float, ...]
    start_s: float = 0.0

    def __post_init__(self) -> None:
        if any(b < a for a, b in zip(self.trace, self.trace[1:])):
            raise ValueError("trace timestamps must be ascending")

    def times(self, *, n: int | None = None,
              horizon_s: float | None = None) -> list[float]:
        _check_bounds(n, horizon_s)
        out = [self.start_s + t for t in self.trace]
        if horizon_s is not None:
            end = self.start_s + horizon_s
            out = [t for t in out if t <= end]
        if n is not None:
            out = out[:n]
        return out


@dataclass(frozen=True)
class FleetTenant:
    """One serving tenant: an arrival process plus per-request costs.

    ``serving`` holds the keyword arguments forwarded to
    ``serving_traffic`` (prefill/decode bytes and seconds, gen_tokens,
    ...) — everything except ``n_requests``/``arrival_times``/``name``,
    which :func:`fleet_traffic` supplies from the arrival process.
    """

    name: str
    arrivals: ArrivalProcess
    serving: dict = field(default_factory=dict)
    priority: int = 0
    weight: float = 1.0
    slo_slowdown: float | None = None


def fleet_traffic(tenants, *, horizon_s: float | None = None,
                  max_requests: int | None = None) -> TrafficGraph:
    """Merge each tenant's open-loop request chains into one graph.

    Every request chain is its own weakly-connected component, which is
    what makes a request the natural admission/shedding unit downstream.
    Tenants with no arrivals inside the bounds contribute nothing.
    """
    graphs = []
    for ft in tenants:
        arrival_times = ft.arrivals.times(n=max_requests,
                                          horizon_s=horizon_s)
        if not arrival_times:
            continue
        g = serving_traffic(name=ft.name, arrival_times=arrival_times,
                            **ft.serving)
        graphs.append(retag(g, tenant=ft.name, priority=ft.priority,
                            stream_prefix=f"{ft.name}/"))
    if not graphs:
        raise ValueError("no tenant produced arrivals inside the bounds")
    return merge_graphs(*graphs)


def fleet_tenant_specs(tenants) -> list[TenantSpec]:
    """Arbiter share contracts matching :func:`fleet_traffic` tags."""
    return [TenantSpec(name=ft.name, weight=ft.weight,
                       priority=ft.priority, slo_slowdown=ft.slo_slowdown)
            for ft in tenants]
