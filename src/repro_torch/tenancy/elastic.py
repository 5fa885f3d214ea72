"""SLO-debt elastic tenant weights (the PR-2 slo-aware follow-on).

The base ``slo-aware`` policy boosts a tenant's weight from its
*instantaneous* running-mean slowdown — a memoryless controller that
reacts the moment the mean crosses the SLO and releases the moment it
dips back, so under bursty open-loop load the boost flaps on and off
with every burst.  :class:`SloDebtArbiter` replaces that with a debted
integrator: each finished request deposits its SLO *excess* (observed
slowdown minus the SLO target, clamped at zero) into a sliding horizon,
the accumulated debt sets a boost target, and the applied boost moves
toward the target through an EMA with a relative deadband — hysteresis
and damping, so weights track sustained violation and ignore noise.

The subclass acts only through :meth:`effective_weight` (it runs as
``weighted-fair`` and never overrides ``order_key``), so it stays on the
indexed engine's fast arbiter path and is consulted identically by both
engines — differential bit-identity is preserved by construction.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from repro_torch.tenancy.arbiter import FabricArbiter
from repro_torch.tenancy.tenants import TenantSpec

__all__ = ["SloDebtArbiter"]


class SloDebtArbiter(FabricArbiter):
    """Weighted-fair arbiter whose weights integrate SLO debt.

    Parameters
    ----------
    horizon_s:
        Sliding window over which per-request SLO excess accumulates;
        observations older than ``horizon_s`` (by the arbiter's event
        pseudo-clock) are forgotten.
    gain:
        Boost target is ``1 + gain * debt`` (debt = summed excess
        slowdown inside the horizon), clamped at ``max_boost``.
    alpha:
        EMA damping toward the target per update (1.0 = undamped).
    deadband:
        Relative dead zone: boost updates smaller than
        ``deadband * current`` are dropped — the hysteresis that stops
        weight oscillation under alternating bursts.
    """

    def __init__(
        self,
        specs: Iterable[TenantSpec] = (),
        *,
        horizon_s: float = 50.0,
        gain: float = 1.0,
        max_boost: float = 8.0,
        alpha: float = 0.3,
        deadband: float = 0.05,
        isolated_latency: Mapping[str, float] | None = None,
        preemption: bool = True,
        quantum_chunks: int = 8,
        preempt_penalty_s: float = 0.0,
        vt_clamp: bool = True,
    ):
        if horizon_s <= 0:
            raise ValueError("horizon_s must be > 0")
        if gain < 0 or max_boost < 1:
            raise ValueError("gain must be >= 0 and max_boost >= 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if deadband < 0:
            raise ValueError("deadband must be >= 0")
        super().__init__(
            "weighted-fair", specs, preemption=preemption,
            quantum_chunks=quantum_chunks,
            isolated_latency=isolated_latency,
            preempt_penalty_s=preempt_penalty_s, vt_clamp=vt_clamp)
        self.horizon_s = horizon_s
        self.gain = gain
        self.max_boost = max_boost
        self.alpha = alpha
        self.deadband = deadband
        # on_group_finish carries no timestamp, so the arbiter keeps a
        # monotone pseudo-clock fed by the timestamped hooks — both
        # engines call them at identical event times, so the clock (and
        # everything derived from it) is engine-independent.
        self._now = 0.0
        # tenant -> {group: (finish pseudo-time, slowdown)}
        self._obs: dict[str, dict[int, tuple[float, float]]] = {}
        self._boost: dict[str, float] = {}

    # -- timestamped hooks feed the pseudo-clock -----------------------------
    def on_enqueued(self, dim: int, tenant: str, now: float) -> None:
        if now > self._now:
            self._now = now
        super().on_enqueued(dim, tenant, now)
        self._update_boost(tenant)

    def on_served(self, dim: int, batch, now: float) -> None:
        if now > self._now:
            self._now = now
        super().on_served(dim, batch, now)

    def on_group_finish(self, group: int, tenant: str,
                        latency: float) -> None:
        super().on_group_finish(group, tenant, latency)
        iso = self.isolated_latency.get(tenant)
        slo = self.spec(tenant).slo_slowdown
        if not iso or slo is None:
            return
        self._obs.setdefault(tenant, {})[group] = (self._now,
                                                   latency / iso)
        self._update_boost(tenant)

    # -- the debted integrator ----------------------------------------------
    def debt(self, tenant: str) -> float:
        """Summed SLO excess inside the horizon (0.0 = meeting SLO)."""
        slo = self.spec(tenant).slo_slowdown
        obs = self._obs.get(tenant)
        if slo is None or not obs:
            return 0.0
        cutoff = self._now - self.horizon_s
        return sum(max(0.0, sd - slo) for t, sd in obs.values()
                   if t >= cutoff)

    def boost(self, tenant: str) -> float:
        """The damped boost currently applied to ``tenant``'s weight."""
        return self._boost.get(tenant, 1.0)

    def _update_boost(self, tenant: str) -> None:
        if self.spec(tenant).slo_slowdown is None:
            return
        obs = self._obs.get(tenant)
        if obs:
            cutoff = self._now - self.horizon_s
            stale = [g for g, (t, _) in obs.items() if t < cutoff]
            for g in stale:
                del obs[g]
        target = min(1.0 + self.gain * self.debt(tenant), self.max_boost)
        cur = self._boost.get(tenant, 1.0)
        new = cur + self.alpha * (target - cur)
        if abs(new - cur) < self.deadband * cur:
            return
        self._boost[tenant] = new

    def effective_weight(self, tenant: str) -> float:
        return (max(self.spec(tenant).weight, 1e-12)
                * self._boost.get(tenant, 1.0))

    def discipline_state(self) -> dict:
        state = super().discipline_state()
        state["discipline"] = "slo-debt"
        state["boosts"] = dict(sorted(self._boost.items()))
        state["horizon_s"] = self.horizon_s
        return state
