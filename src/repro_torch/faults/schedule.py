"""Deterministic fault timelines for the simulation engines.

A :class:`FaultSchedule` is a declarative, seed-free description of what
goes wrong on the fabric and when: per-dim bandwidth degradation windows,
full dim outages, periodic link flaps (a train of short outages), and
NPU-straggler bursts that layer an *extra* lognormal sigma on top of the
PR-5 ``straggler_sigma`` baked into the topology.  The schedule itself is
pure data — frozen, hashable (so it can ride inside a frozen
:class:`repro_torch.core.batch.Scenario`) and engine-agnostic.

``compile(num_dims)`` validates the schedule against a concrete topology
(dims in range, no overlapping windows of the same family on one dim) and
lowers it to a sorted list of :class:`FaultBoundary` *value-change events*
— the only representation the engines consume.  Each boundary carries the
dim's new (factor, sigma) state plus three precomputed transition flags,
so the engine event loops never re-derive float comparisons in the hot
path:

  * ``bw_change``  — the BW factor changed (includes to/from an outage);
  * ``down_start`` — the dim just went fully out (factor -> 0);
  * ``down_end``   — the dim just recovered (factor 0 -> up).

Outages use the :class:`RetryPolicy` attached to the schedule: a queued
collective chunk on a fully-out dim times out after ``timeout_s``, retries
with exponential backoff (jittered from the *simulation's* RNG stream, so
runs stay reproducible and both engines stay in lockstep), and after
``max_attempts`` the whole request group is marked failed
(``SimResult.failed_groups``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Union


def _check_window(name: str, start: float, end: float) -> None:
    if math.isnan(start) or math.isnan(end):
        raise ValueError(f"{name}: NaN window bound (start={start!r}, "
                         f"end={end!r})")
    if start < 0:
        raise ValueError(f"{name}: negative start time {start!r} "
                         "(fault times are simulation seconds >= 0)")
    if end <= start:
        raise ValueError(f"{name}: empty or inverted window "
                         f"[{start!r}, {end!r}) — end must exceed start")


@dataclass(frozen=True)
class BwDegradation:
    """Dim ``dim`` runs at ``factor`` x its nominal BW over [start, end)."""

    dim: int
    start: float
    end: float
    factor: float

    def __post_init__(self) -> None:
        _check_window("BwDegradation", self.start, self.end)
        if not (0.0 < self.factor <= 1.0) or math.isnan(self.factor):
            raise ValueError(
                f"BwDegradation: factor {self.factor!r} out of range "
                "(0, 1] — use DimOutage for a fully-out dim")

    def bw_windows(self):
        yield (self.start, self.end, self.factor)

    def sigma_windows(self):
        return ()


@dataclass(frozen=True)
class DimOutage:
    """Dim ``dim`` is fully out (no service starts, in-flight work cut and
    requeued under the retry policy) over [start, end).  ``end`` may be
    ``math.inf`` for a permanent outage."""

    dim: int
    start: float
    end: float = math.inf

    def __post_init__(self) -> None:
        _check_window("DimOutage", self.start, self.end)

    def bw_windows(self):
        yield (self.start, self.end, 0.0)

    def sigma_windows(self):
        return ()


@dataclass(frozen=True)
class LinkFlap:
    """A train of ``count`` short outages on ``dim``: down for ``down_s``
    at ``start + i * period_s`` for i in 0..count-1."""

    dim: int
    start: float
    down_s: float
    period_s: float
    count: int

    def __post_init__(self) -> None:
        if math.isnan(self.start) or self.start < 0:
            raise ValueError(f"LinkFlap: bad start time {self.start!r}")
        if not self.down_s > 0 or math.isnan(self.down_s):
            raise ValueError(f"LinkFlap: down_s {self.down_s!r} must be > 0")
        if self.period_s < self.down_s or math.isnan(self.period_s):
            raise ValueError(
                f"LinkFlap: period_s {self.period_s!r} must be >= down_s "
                f"{self.down_s!r} (flap windows may not overlap)")
        if self.count < 1:
            raise ValueError(f"LinkFlap: count {self.count!r} must be >= 1")

    def bw_windows(self):
        for i in range(self.count):
            t0 = self.start + i * self.period_s
            yield (t0, t0 + self.down_s, 0.0)

    def sigma_windows(self):
        return ()


@dataclass(frozen=True)
class StragglerBurst:
    """Extra lognormal straggler noise on ``dim`` over [start, end):
    service times drawn in the window are multiplied by an additional
    ``lognormvariate(0, sigma)`` on top of the topology's baseline
    ``straggler_sigma`` (the PR-5 DCN model)."""

    dim: int
    start: float
    end: float
    sigma: float

    def __post_init__(self) -> None:
        _check_window("StragglerBurst", self.start, self.end)
        if not self.sigma > 0 or math.isnan(self.sigma):
            raise ValueError(
                f"StragglerBurst: sigma {self.sigma!r} must be > 0")

    def bw_windows(self):
        return ()

    def sigma_windows(self):
        yield (self.start, self.end, self.sigma)


FaultEvent = Union[BwDegradation, DimOutage, LinkFlap, StragglerBurst]


@dataclass(frozen=True)
class RetryPolicy:
    """Timeout/backoff semantics for chunks queued on a fully-out dim.

    A chunk that has sat ``timeout_s`` in the queue of a down dim gives up
    its slot and re-arrives after ``backoff_s * multiplier**(attempt-1)``,
    optionally stretched by ``(1 + jitter * U[0,1))`` drawn from the
    simulation RNG.  ``max_attempts`` timeouts fail the chunk's whole
    request group.
    """

    timeout_s: float = 0.1
    backoff_s: float = 0.1
    multiplier: float = 2.0
    jitter: float = 0.25
    max_attempts: int = 5

    def __post_init__(self) -> None:
        if not self.timeout_s > 0 or math.isnan(self.timeout_s):
            raise ValueError(f"RetryPolicy: timeout_s {self.timeout_s!r} "
                             "must be > 0")
        if self.backoff_s < 0 or math.isnan(self.backoff_s):
            raise ValueError(f"RetryPolicy: backoff_s {self.backoff_s!r} "
                             "must be >= 0")
        if self.multiplier < 1.0 or math.isnan(self.multiplier):
            raise ValueError(f"RetryPolicy: multiplier {self.multiplier!r} "
                             "must be >= 1")
        if self.jitter < 0 or math.isnan(self.jitter):
            raise ValueError(f"RetryPolicy: jitter {self.jitter!r} "
                             "must be >= 0")
        if self.max_attempts < 1:
            raise ValueError(f"RetryPolicy: max_attempts "
                             f"{self.max_attempts!r} must be >= 1")

    def delay(self, attempt: int) -> float:
        """Base (un-jittered) backoff before re-arrival number ``attempt``."""
        return self.backoff_s * self.multiplier ** (attempt - 1)


class FaultBoundary(NamedTuple):
    """One value-change event on one dim (engine consumption form)."""

    t: float
    dim: int
    factor: float      # BW multiplier in effect from t (0.0 == fully out)
    sigma: float       # extra straggler sigma in effect from t
    bw_change: bool    # factor changed at t (incl. outage start/end)
    down_start: bool   # factor transitioned  >0 -> 0
    down_end: bool     # factor transitioned   0 -> >0


@dataclass(frozen=True)
class CompiledFaults:
    """``FaultSchedule.compile(num_dims)`` output: sorted boundaries plus
    the retry policy, ready for the engines."""

    boundaries: tuple[FaultBoundary, ...]
    retry: RetryPolicy
    num_dims: int


def _change_points(wins: list[tuple[float, float, float]],
                   base: float) -> list[tuple[float, float]]:
    """Lower sorted non-overlapping (start, end, value) windows over a
    ``base`` background into deduplicated (time, new_value) points."""
    pts: dict[float, float] = {}
    for _, end, _ in wins:
        if math.isfinite(end):
            pts[end] = base
    for start, _, v in wins:
        pts[start] = v  # a window starting where another ends wins the tie
    out: list[tuple[float, float]] = []
    prev = base
    for t in sorted(pts):
        v = pts[t]
        if v != prev:
            out.append((t, v))
            prev = v
    return out


@dataclass(frozen=True)
class FaultSchedule:
    """A declarative fault timeline: a set of fault events plus the retry
    policy applied during outages.  Validate + lower with
    :meth:`compile`; the engines only ever see the compiled form."""

    events: tuple[FaultEvent, ...] = ()
    retry: RetryPolicy = field(default_factory=RetryPolicy)

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, (BwDegradation, DimOutage, LinkFlap,
                                   StragglerBurst)):
                raise ValueError(
                    f"FaultSchedule: unknown event type {type(ev).__name__}")

    def compile(self, num_dims: int) -> CompiledFaults:
        """Validate against a ``num_dims``-dim topology and lower to sorted
        :class:`FaultBoundary` events.

        Raises ``ValueError`` for out-of-range dims and for overlapping
        windows of the same family (BW-affecting events — degradations,
        outages, flaps — may not overlap each other on one dim; straggler
        bursts may not overlap each other; a burst may overlap a BW
        window).  Windows that merely touch (``a.end == b.start``) are
        fine.
        """
        bw_wins: dict[int, list[tuple[float, float, float]]] = {}
        sg_wins: dict[int, list[tuple[float, float, float]]] = {}
        for ev in self.events:
            if not 0 <= ev.dim < num_dims:
                raise ValueError(
                    f"{type(ev).__name__}: dim {ev.dim} out of range for a "
                    f"{num_dims}-dim topology")
            for w in ev.bw_windows():
                bw_wins.setdefault(ev.dim, []).append(w)
            for w in ev.sigma_windows():
                sg_wins.setdefault(ev.dim, []).append(w)
        for family, wins_by_dim in (("BW", bw_wins), ("straggler", sg_wins)):
            for dim, wins in wins_by_dim.items():
                wins.sort()
                for (s0, e0, _), (s1, e1, _) in zip(wins, wins[1:]):
                    if s1 < e0:
                        raise ValueError(
                            f"overlapping {family} fault windows on dim "
                            f"{dim}: [{s0!r}, {e0!r}) and [{s1!r}, {e1!r}) "
                            "— fault windows of one family must be "
                            "disjoint per dim")

        boundaries: list[FaultBoundary] = []
        for dim in sorted(set(bw_wins) | set(sg_wins)):
            f_pts = dict(_change_points(bw_wins.get(dim, []), 1.0))
            s_pts = dict(_change_points(sg_wins.get(dim, []), 0.0))
            f, s = 1.0, 0.0
            for t in sorted(set(f_pts) | set(s_pts)):
                nf = f_pts.get(t, f)
                ns = s_pts.get(t, s)
                boundaries.append(FaultBoundary(
                    t, dim, nf, ns,
                    bw_change=nf != f,
                    down_start=f > 0.0 and nf == 0.0,
                    down_end=f == 0.0 and nf > 0.0))
                f, s = nf, ns
        boundaries.sort(key=lambda b: (b.t, b.dim))
        return CompiledFaults(tuple(boundaries), self.retry, num_dims)
