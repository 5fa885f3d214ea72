"""Dim Load Tracker (paper Fig. 6 / Algorithm 1).

Maintains the accumulated predicted communication time ("load") each network
dimension has been assigned by the chunks scheduled so far.

Two operating modes:

  * **one-shot** (legacy, `reset()`): loads are re-initialized to each
    dimension's fixed delay ``A_K`` at the start of every collective
    (Sec. 4.4) — correct when collectives run back-to-back, one at a time.
  * **running** (arrival-time-aware, `advance_to()` + `begin_collective()`):
    the tracker keeps a wall-clock cursor; each dimension drains its pending
    load at one second of work per second of wall time, and a new request
    arriving at time *t* sees the *residual* loads of everything still in
    flight plus its own ``A_K``.  This is the paper Sec. 4.4 running-load
    view extended across overlapping collectives (backprop bucket streams),
    where scheduling-policy differences actually materialize.
"""
from __future__ import annotations

from repro_torch.core.latency_model import LatencyModel


class DimLoadTracker:
    def __init__(self, latency_model: LatencyModel):
        self._lm = latency_model
        self._loads: list[float] = [0.0] * latency_model.topology.num_dims
        self._now: float = 0.0

    # -- one-shot mode (per-collective reset, Algorithm 1) ------------------
    def reset(self, collective: str) -> None:
        """Re-initialize loads to A_K of ``collective`` ('RS'|'AG'|'AR')."""
        self._loads = [
            self._lm.fixed_delay(k, collective)
            for k in range(self._lm.topology.num_dims)
        ]
        self._now = 0.0

    # -- running mode (arrival-time-aware, across collectives) --------------
    def advance_to(self, t: float) -> None:
        """Drain pending loads by the wall time elapsed since the last
        observation.  Each dimension is a serial resource working off its
        queue at unit rate, so ``dt`` seconds retire ``dt`` seconds of load
        (floored at zero for dims that went idle)."""
        dt = t - self._now
        if dt <= 0:
            return
        self._loads = [max(0.0, l - dt) for l in self._loads]
        self._now = t

    def begin_collective(self, collective: str) -> None:
        """Charge each dim's fixed delay A_K for a new collective *without*
        discarding residual loads of collectives still in flight."""
        for k in range(len(self._loads)):
            self._loads[k] += self._lm.fixed_delay(k, collective)

    @property
    def now(self) -> float:
        return self._now

    # -- shared ---------------------------------------------------------------
    def get_loads(self) -> list[float]:
        return list(self._loads)

    def update(self, new_load: dict[int, float]) -> None:
        for dim_idx, secs in new_load.items():
            self._loads[dim_idx] += secs

    def update_loads(self, deltas: list[float]) -> None:
        """Elementwise add of a dense per-dim load vector (the hot-path
        variant of :meth:`update`, fed by ``calc_loads_list``; adding the
        vector's 0.0 entries is a float no-op, so both paths agree bit-for-
        bit)."""
        loads = self._loads
        for k, v in enumerate(deltas):
            if v:
                loads[k] += v

    @property
    def imbalance(self) -> float:
        return max(self._loads) - min(self._loads)

    @property
    def min_load_dim(self) -> int:
        return min(range(len(self._loads)), key=self._loads.__getitem__)
