"""Windowed bandwidth/queue/share timelines derived from a trace.

:class:`BwTimeline` is the canonical time-resolved view of one simulation
run — the input the ROADMAP's closed-loop contention-aware scheduler will
consume (observed per-dim BW shares fed back into ``ThemisScheduler``),
and the single implementation of the interval math the Fig. 9 / Fig. 11
benchmarks used to hand-roll.

Two constructors, two fidelity levels:

  * :meth:`BwTimeline.from_result` — scalar aggregates only (per-dim wire
    bytes, busy time, activity intervals, makespan).  Enough for the
    paper's figures: ``avg_bw_utilization`` and ``activity_rate`` are the
    *same expressions* as ``SimResult``'s, so ported benchmarks stay
    numerically identical.
  * :meth:`BwTimeline.from_tracer` — full event fidelity from a
    :class:`~repro_torch.obs.tracer.Tracer`: windowed per-dim utilization,
    per-tenant BW shares (``per_dim_shares``), and queue-depth series.

A service drains wire bytes uniformly over its interval (exactly the
engines' service model), so windowed byte attribution is overlap-weighted
and integrates back to the per-dim totals to float precision — the
``benchmarks/obs_study.py`` gate asserts both ends against
``SimResult.avg_bw_utilization`` / ``dim_busy``.

This is the port's copy of ``repro/obs/timeline.py``, imports aside; it
leaves out nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.tracer import (
    SVC_END,
    SVC_OPS,
    SVC_START,
    SVC_TENANT,
    SVC_WIRE,
    Tracer,
)


@dataclass
class BwTimeline:
    """Time-resolved per-dim bandwidth view of one simulation run."""

    num_dims: int
    makespan: float
    dim_bw: list[float]                 # bytes/s per dim
    dim_wire: list[float]               # total wire bytes per dim
    dim_busy: list[float]               # total busy seconds per dim
    activity: list[list[tuple[float, float]]]  # pending-work intervals
    # Full-fidelity fields (tracer-backed only):
    services: list[list[list]] | None = None   # Tracer.services layout
    enqueues: list[tuple[int, float]] = field(default_factory=list)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_result(cls, result, topology) -> "BwTimeline":
        """Build from a ``SimResult`` (aggregate fidelity; no windowed
        share/queue series — record a trace for those)."""
        return cls(
            num_dims=topology.num_dims,
            makespan=result.makespan,
            dim_bw=[d.aggr_bw_bytes for d in topology.dims],
            dim_wire=list(result.dim_wire_bytes),
            dim_busy=list(result.dim_busy),
            activity=[list(a) for a in result.dim_activity],
        )

    @classmethod
    def from_tracer(cls, tracer: Tracer) -> "BwTimeline":
        """Build from a finished :class:`Tracer` (full event fidelity)."""
        if not tracer.finished:
            raise ValueError(
                "tracer has not recorded a finished run; pass it to "
                "simulate(..., tracer=...) first")
        return cls(
            num_dims=tracer.num_dims,
            makespan=tracer.makespan,
            dim_bw=list(tracer.dim_bw),
            dim_wire=list(tracer.dim_wire),
            dim_busy=list(tracer.dim_busy),
            activity=[list(a) for a in tracer.dim_activity],
            services=tracer.services,
            enqueues=tracer.enqueues,
        )

    # -- aggregate metrics (the SimResult expressions, verbatim) -------------
    def avg_bw_utilization(self) -> float:
        """Weighted-average BW utilization (weights = per-dim BW budget) —
        the paper's Fig. 11 metric; identical expression to
        ``SimResult.avg_bw_utilization``."""
        if self.makespan <= 0:
            return 0.0
        total_bw = sum(self.dim_bw)
        moved = sum(self.dim_wire)
        return moved / (self.makespan * total_bw)

    def dim_utilization(self, dim: int) -> float:
        """One dimension's BW utilization over the whole run."""
        if self.makespan <= 0 or self.dim_bw[dim] <= 0:
            return 0.0
        return self.dim_wire[dim] / (self.makespan * self.dim_bw[dim])

    def activity_rate(self, dim: int) -> float:
        """Fraction of the makespan ``dim`` had pending work — the Fig. 9
        metric; identical expression to ``SimResult.activity_rate``."""
        if self.makespan <= 0:
            return 0.0
        return sum(e - s for s, e in self.activity[dim]) / self.makespan

    # -- windowed series (tracer-backed) -------------------------------------
    def windows(self, window: float) -> list[tuple[float, float]]:
        """Half-open windows ``[t, min(t+window, makespan))`` tiling the
        run.  The final window is truncated at the makespan so rates stay
        normalized by actual covered time."""
        if window <= 0:
            raise ValueError("window must be > 0 seconds")
        out = []
        t = 0.0
        while t < self.makespan:
            out.append((t, min(t + window, self.makespan)))
            t += window
        return out or [(0.0, 0.0)]

    def _need_services(self) -> list[list[list]]:
        if self.services is None:
            raise ValueError(
                "windowed series need per-service events; build this "
                "timeline with BwTimeline.from_tracer(...)")
        return self.services

    def per_dim_utilization(self, window: float) -> list[list[float]]:
        """``[dim][window]`` BW utilization: bytes drained in the window
        (uniform-drain overlap weighting) over the window's capacity.
        Sums back to :meth:`dim_utilization` exactly (up to float order).
        """
        services = self._need_services()
        wins = self.windows(window)
        out: list[list[float]] = []
        for dim in range(self.num_dims):
            cap = self.dim_bw[dim]
            vals = []
            for (w0, w1) in wins:
                span = w1 - w0
                vals.append(0.0 if span <= 0 or cap <= 0 else
                            self._drained(services[dim], w0, w1) /
                            (span * cap))
            out.append(vals)
        return out

    def per_dim_shares(
        self, window: float
    ) -> dict[str, list[list[float]]]:
        """Per-tenant observed BW share: ``{tenant: [dim][window]}`` where
        each entry is the fraction of the dim's capacity that tenant's
        services drained in the window.  This is the feedback signal the
        closed-loop controller consumes (ROADMAP: observed per-dim BW
        shares -> scheduler), and the time-resolved version of
        ``repro.tenancy.metrics``' aggregate shares.

        Attribution is by granted (head) tenant — exact under an arbiter,
        whose service batches are same-tenant by construction.
        """
        services = self._need_services()
        wins = self.windows(window)
        tenants = sorted({rec[SVC_TENANT]
                          for per_dim in services for rec in per_dim})
        out = {t: [[0.0] * len(wins) for _ in range(self.num_dims)]
               for t in tenants}
        for dim in range(self.num_dims):
            cap = self.dim_bw[dim]
            for rec in services[dim]:
                rows = out[rec[SVC_TENANT]][dim]
                for w, (w0, w1) in enumerate(wins):
                    span = w1 - w0
                    if span <= 0 or cap <= 0:
                        continue
                    got = _overlap_bytes(rec, w0, w1)
                    if got:
                        rows[w] += got / (span * cap)
        return out

    def queue_depth(self, window: float) -> list[list[float]]:
        """``[dim][window]`` time-averaged ready-queue depth, integrated
        from enqueue events (+1) and service starts (−batch size)."""
        services = self._need_services()
        wins = self.windows(window)
        out: list[list[float]] = []
        for dim in range(self.num_dims):
            deltas = [(t, 1) for (d, t) in self.enqueues if d == dim]
            deltas += [(rec[SVC_START], -len(rec[SVC_OPS]))
                       for rec in services[dim]]
            # Enqueues settle before the dequeue at the same timestamp
            # (the engine enqueues, then starts a service).
            deltas.sort(key=lambda p: (p[0], -p[1]))
            out.append(_integrate_depth(deltas, wins))
        return out

    @staticmethod
    def _drained(recs: list[list], w0: float, w1: float) -> float:
        acc = 0.0
        for rec in recs:
            acc += _overlap_bytes(rec, w0, w1)
        return acc


def _overlap_bytes(rec: list, w0: float, w1: float) -> float:
    """Bytes of one service draining inside ``[w0, w1)`` under the
    engines' uniform-drain service model."""
    s, e, wire = rec[SVC_START], rec[SVC_END], rec[SVC_WIRE]
    lo, hi = max(s, w0), min(e, w1)
    if hi <= lo:
        return 0.0
    if e <= s:  # zero-length service (zero-wire stages): all-or-nothing
        return wire if w0 <= s < w1 else 0.0
    return wire * (hi - lo) / (e - s)


def _integrate_depth(deltas: list[tuple[float, int]],
                     wins: list[tuple[float, float]]) -> list[float]:
    """Time-average a step function (given as sorted (t, delta) events)
    over each window."""
    out = []
    i0 = 0
    for (w0, w1) in wins:
        span = w1 - w0
        if span <= 0:
            out.append(0.0)
            continue
        # depth entering the window = sum of deltas strictly before w0
        depth = 0
        area = 0.0
        t = w0
        j = 0
        while j < len(deltas) and deltas[j][0] < w0:
            depth += deltas[j][1]
            j += 1
        while j < len(deltas) and deltas[j][0] < w1:
            ts, d = deltas[j]
            area += depth * (ts - t)
            depth += d
            t = ts
            j += 1
        area += depth * (w1 - t)
        out.append(area / span)
        i0 = i0  # windows are independent; rescan keeps code simple
    return out
