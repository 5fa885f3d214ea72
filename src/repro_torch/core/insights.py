"""BW-provisioning analysis for network designers (paper Sec. 6.3).

For any two dimensions K < L, compare BW(dimK) against
``P_K * P_{K+1} * ... * P_{L-1} * BW(dimL)``:

  * Just-Enough      (==): baseline scheduling already saturates both dims.
  * Over-Provisioned  (<): baseline strands dimL bandwidth; Themis recovers it.
  * Under-Provisioned (>): no chunk schedule can fully drive both dims —
                           a design point to prohibit.

This is the port's copy of ``repro/core/insights.py``, imports aside; it
leaves out nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.topology import Topology


@dataclass(frozen=True)
class PairVerdict:
    dim_k: int
    dim_l: int
    ratio: float      # BW(dimK) / (prod(P_K..P_{L-1}) * BW(dimL))
    verdict: str      # 'just-enough' | 'over-provisioned' | 'under-provisioned'


def classify_pair(topology: Topology, k: int, l: int, tol: float = 0.05) -> PairVerdict:
    assert k < l
    prod = 1
    for i in range(k, l):
        prod *= topology.dims[i].npus
    ratio = topology.dims[k].aggr_bw_bytes / (prod * topology.dims[l].aggr_bw_bytes)
    if abs(ratio - 1.0) <= tol:
        verdict = "just-enough"
    elif ratio < 1.0:
        verdict = "over-provisioned"  # dimL has excess BW baseline wastes
    else:
        verdict = "under-provisioned"
    return PairVerdict(k, l, ratio, verdict)


def analyze(topology: Topology, tol: float = 0.05) -> list[PairVerdict]:
    out = []
    for k in range(topology.num_dims):
        for l in range(k + 1, topology.num_dims):
            out.append(classify_pair(topology, k, l, tol))
    return out


def baseline_utilization_bound(topology: Topology) -> float:
    """Closed-form baseline avg BW utilization for a large All-Reduce.

    Baseline loads: n_K = (P_K - 1)/P_K * S / prod(P_1..P_{K-1}); makespan is
    the slowest dim; utilization = sum(n_K) / (T * sum(BW)).
    """
    s = 1.0
    shrink = 1.0
    n = []
    for d in topology.dims:
        n.append((d.npus - 1) / d.npus * s * shrink)
        shrink /= d.npus
    t = max(nk / d.aggr_bw_bytes for nk, d in zip(n, topology.dims))
    return sum(n) / (t * topology.total_bw_bytes)


def themis_utilization_bound(topology: Topology) -> float:
    """Fractional (water-filling) utilization bound for Themis.

    Upper-bounded by 1.0; below 1.0 when some pair is under-provisioned such
    that no schedule can keep every dim busy (Sec. 6.3).  Computed by greedy
    fractional assignment with many micro-chunks.
    """
    from repro_torch.core.scheduler import schedule_collective
    from repro_torch.core.latency_model import LatencyModel

    lm = LatencyModel(topology)
    chunks = schedule_collective(topology, "AR", 1e9, 2048, "themis")
    loads = {k: 0.0 for k in range(topology.num_dims)}
    for c in chunks:
        for k, secs in lm.calc_loads(c.size_bytes, c.schedule).items():
            loads[k] += secs
    t = max(loads.values())
    moved = sum(
        loads[k] * topology.dims[k].aggr_bw_bytes for k in loads
    )
    return moved / (t * topology.total_bw_bytes)
