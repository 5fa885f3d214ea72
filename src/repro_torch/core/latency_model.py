"""Themis Latency Model (paper Sec. 4.4).

Total latency of network dimension K:

    Latency(dimK) = A_K + N_K * B_K + idle_K

- ``A_K``   fixed delay = number_of_steps * step_latency (collective-algorithm
            and system dependent; obtained offline).
- ``B_K``   per-byte latency = 1 / aggregate-BW of dimK.
- ``N_K``   total bytes each NPU sends on dimK = sum of per-chunk ``n_K^i``.
- ``idle_K`` minimized by SCF intra-dim scheduling (Sec. 4.3), not predicted.

The Latency Model predicts ``n_K^i * B_K`` as the load of chunk #i on dimK
(paper: "Since N_K only participates with B_K, the Latency Model only
considers n_K^i x B_K as the latency of chunk #i on dimK").
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import ClassVar, Sequence

from repro_torch.topology import Phase, Topology

# A stage of a chunk's schedule: which phase runs on which dimension index.
StageOp = tuple[Phase, int]


@dataclass(frozen=True)
class StageTables:
    """Flat per-dim factor arrays for allocation-free stage math.

    ``wire = rs_wire[k] * size`` (RS) / ``ag_wire[k] * size`` (AG) and the
    post-stage size is ``size / npus[k]`` / ``size * npus[k]`` — the exact
    expressions of :func:`stage_transition`, just precomputed per dim.
    """

    rs_wire: list[float]    # (P-1)/P per dim (0.0 when P <= 1)
    ag_wire: list[float]    # float(P-1) per dim (0.0 when P <= 1)
    npus: list[int]
    rs_step: list[float]    # step_delay(dim, RS)
    ag_step: list[float]    # step_delay(dim, AG)
    per_byte: list[float]   # 1 / aggr_bw_bytes
    bw: list[float]         # aggr_bw_bytes


def stage_transition(phase: Phase, npus: int, size_before: float) -> tuple[float, float]:
    """(wire_bytes_per_npu, size_after) for one RS/AG stage.

    ``size_before`` is the chunk's per-NPU resident bytes before the stage.
    RS shrinks the chunk P x; AG grows it P x.  Wire bytes are symmetric:
    a dimension moves (P-1)/P of the *large-end* size either way, matching
    the paper's Fig. 5 stage-latency accounting.
    """
    if npus <= 1:
        return 0.0, size_before
    if phase == Phase.RS:
        return (npus - 1) / npus * size_before, size_before / npus
    # AG: (P-1) * size_before == (P-1)/P * size_after
    return (npus - 1) * size_before, size_before * npus


@dataclass(frozen=True)
class LatencyModel:
    """Predicts per-chunk, per-dimension communication latency.

    Instances are cheap, but :attr:`stage_tables` is not free to rebuild in
    a loop of ``simulate()`` calls — use :meth:`for_topology` to share one
    memoized instance per topology (the simulator does this internally).
    """

    topology: Topology

    # Per-topology instance cache (for_topology).  Topology is a frozen
    # value type, so equality-keyed sharing is safe: a "changed" topology is
    # a different key, which is the invalidation rule.  Bounded so topology
    # searches generating thousands of candidates cannot grow it forever.
    _instances: ClassVar[dict[Topology, "LatencyModel"]] = {}
    _INSTANCE_CAP: ClassVar[int] = 1024
    # Monotonic count of StageTables builds — lets tests assert that loops
    # of simulate() calls stop rebuilding the flat factor tables.
    stage_table_builds: ClassVar[int] = 0

    @classmethod
    def for_topology(cls, topology: Topology) -> "LatencyModel":
        """Shared memoized instance for ``topology`` (stage tables built
        once per distinct topology, not once per ``simulate()`` call)."""
        d = cls._instances
        got = d.pop(topology, None)
        if got is None:
            if len(d) >= cls._INSTANCE_CAP:
                # evict the least-recently-used entry only — clearing
                # everything would drop hot topologies (the search's base/
                # incumbent fabrics) along with the candidate churn
                d.pop(next(iter(d)))
            got = cls(topology)
        # (re)insert at the end: dict order is the LRU recency order
        d[topology] = got
        return got

    # ---- fixed-delay term --------------------------------------------------
    def fixed_delay(self, dim_idx: int, collective: str) -> float:
        """A_K for running ``collective`` ('RS' | 'AG' | 'AR') on dimK."""
        d = self.topology.dims[dim_idx]
        if collective == "AR":
            steps = d.algorithm.steps(d.npus, Phase.RS) + d.algorithm.steps(
                d.npus, Phase.AG
            )
        else:
            steps = d.algorithm.steps(d.npus, Phase(collective))
        return steps * d.step_latency_s

    def step_delay(self, dim_idx: int, phase: Phase) -> float:
        """A-term of a single RS or AG stage on dimK."""
        d = self.topology.dims[dim_idx]
        return d.algorithm.steps(d.npus, phase) * d.step_latency_s

    # ---- bandwidth term ----------------------------------------------------
    def per_byte_latency(self, dim_idx: int) -> float:
        return 1.0 / self.topology.dims[dim_idx].aggr_bw_bytes

    def wire_time(self, dim_idx: int, wire_bytes: float) -> float:
        return wire_bytes * self.per_byte_latency(dim_idx)

    def stage_wire_bytes(
        self, dim_idx: int, phase: Phase, size_before: float
    ) -> tuple[float, float]:
        return stage_transition(phase, self.topology.dims[dim_idx].npus, size_before)

    # ---- flat per-dim tables for the hot paths ------------------------------
    @cached_property
    def stage_tables(self) -> "StageTables":
        """Precomputed per-dim factors so the simulator/scheduler hot loops
        run on flat arrays instead of method calls per stage.

        The factors are built with the *same* float expressions as
        :func:`stage_transition` / :meth:`step_delay`, so results computed
        from them are bit-identical to the method-call path (required by the
        indexed-engine equivalence gate).
        """
        LatencyModel.stage_table_builds += 1
        rs_wire, ag_wire, npus = [], [], []
        rs_step, ag_step, per_byte, bw = [], [], [], []
        for d in self.topology.dims:
            n = d.npus
            npus.append(n)
            rs_wire.append((n - 1) / n if n > 1 else 0.0)
            ag_wire.append(float(n - 1) if n > 1 else 0.0)
            rs_step.append(d.algorithm.steps(n, Phase.RS) * d.step_latency_s)
            ag_step.append(d.algorithm.steps(n, Phase.AG) * d.step_latency_s)
            per_byte.append(1.0 / d.aggr_bw_bytes)
            bw.append(d.aggr_bw_bytes)
        return StageTables(rs_wire, ag_wire, npus, rs_step, ag_step,
                           per_byte, bw)

    # ---- per-chunk load prediction (Algorithm 1 lines 28-29) ---------------
    def calc_loads(
        self, chunk_bytes: float, schedule: Sequence[StageOp]
    ) -> dict[int, float]:
        """Predicted BW-term load each dim receives from one chunk.

        ``schedule`` is the ordered list of (phase, dim) stages the chunk
        traverses; sizes evolve stage to stage.  Returns {dim_idx: seconds}.
        """
        loads: dict[int, float] = {}
        size = chunk_bytes
        for phase, dim_idx in schedule:
            wire, size = self.stage_wire_bytes(dim_idx, phase, size)
            loads[dim_idx] = loads.get(dim_idx, 0.0) + self.wire_time(dim_idx, wire)
        return loads

    def calc_loads_list(
        self, chunk_bytes: float, schedule: Sequence[StageOp]
    ) -> list[float]:
        """Dense variant of :meth:`calc_loads`: returns a per-dim load vector
        of length ``num_dims`` (0.0 for untouched dims).  Bit-identical per
        dim to the dict path; avoids a dict allocation per chunk."""
        t = self.stage_tables
        out = [0.0] * self.topology.num_dims
        size = chunk_bytes
        rs = Phase.RS
        for phase, k in schedule:
            n = t.npus[k]
            if n <= 1:
                continue
            if phase == rs:
                out[k] += t.rs_wire[k] * size * t.per_byte[k]
                size = size / n
            else:
                out[k] += t.ag_wire[k] * size * t.per_byte[k]
                size = size * n
        return out

    # ---- ideal bound (paper Table 3 'Ideal') --------------------------------
    def ideal_time(self, collective: str, size_bytes: float) -> float:
        """Communication latency at 100% BW utilization of every dimension."""
        p = self.topology.total_npus
        per_npu_bytes = (p - 1) / p * size_bytes
        if collective == "AR":
            per_npu_bytes *= 2.0  # RS + AG
        return per_npu_bytes / self.topology.total_bw_bytes

    def total_wire_bytes(self, collective: str, size_bytes: float) -> float:
        """Schedule-invariant total bytes per NPU summed over all dims."""
        p = self.topology.total_npus
        b = (p - 1) / p * size_bytes
        return 2.0 * b if collective == "AR" else b

    def dim_lower_bounds(self, collective: str, size_bytes: float) -> list[float]:
        """Per-dim busy-time lower bound (seconds) of one collective.

        The wire bytes a schedule places on dimK are minimized when dimK
        runs at the small end of the size evolution (last RS stage / first
        AG stage): ``(P_K - 1) * size / total_npus`` bytes, doubled for AR
        (RS + AG both cross the dim).  No schedule, fusion, arbiter, or
        preemption can put fewer bytes on the dim, and a dim is a serial
        BW resource, so the simulated makespan is >= every dim's bound —
        the pruning certificate used by the topology search.
        """
        p = self.topology.total_npus
        out = []
        for d in self.topology.dims:
            if d.npus <= 1:
                out.append(0.0)
                continue
            w = (d.npus - 1) * size_bytes / p
            if collective == "AR":
                w *= 2.0
            out.append(w / d.aggr_bw_bytes)
        return out
