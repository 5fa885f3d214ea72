"""Bridge: Themis scheduler -> per-chunk axis orders of the Themis train step
(port of the scheduling half of ``repro/comms/schedule_bridge.py``).

The paper computes schedules once and reuses them (Sec. 4.6.2), so Themis's
greedy pass runs once when the step is built: the mesh axes are modelled as
a Themis topology (the reference's TPU mapping, ICI axes innermost, the DCN
'pod' axis outermost, kept exactly so that the orders equal the
reference's), Algorithm 1 runs over the gradient buffer, and the per-chunk
axis orders are what ``comms/hierarchical.py`` issues over
``torch.distributed``. The HLO collective audit (``collective_stats``)
waits for ROADMAP M13.
"""
from __future__ import annotations

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.requests import CollectiveRequest
from repro_torch.core.scheduler import ThemisScheduler, baseline_order
from repro_torch.topology import Phase
from repro_torch.topology.topology import NetworkDim, Topology, TopoKind


def topology_from_axes(axis_sizes: dict[str, int]) -> tuple[Topology, list[str]]:
    """Mesh axes -> Themis topology (dims innermost-first: model, data, pod).

    ICI axes: ring, 2 x 400 Gb/s links (~100 GB/s aggregate); pod axis: DCN
    NIC, 200 Gb/s.  Returns (topology, axis name per dim index).
    """
    order = [a for a in ("model", "data", "pod") if axis_sizes.get(a, 1) > 1]
    dims = []
    for a in order:
        if a == "pod":
            dims.append(NetworkDim(axis_sizes[a], TopoKind.SWITCH, 200.0, 1, 2e-5))
        else:
            dims.append(NetworkDim(axis_sizes[a], TopoKind.RING, 400.0, 2, 1e-6))
    return Topology("mesh", tuple(dims)), order


def themis_axis_orders(
    axis_sizes: dict[str, int],
    nbytes: float,
    n_chunks: int,
    policy: str = "themis",
) -> list[tuple[str, ...]]:
    """Per-chunk RS axis orders for a gradient All-Reduce of ``nbytes``."""
    topo, names = topology_from_axes(axis_sizes)
    if topo.num_dims == 0:
        return [()] * n_chunks
    if policy in ("baseline", "hier_baseline"):
        rs = [d for ph, d in baseline_order(topo.num_dims, "RS")]
        return [tuple(names[d] for d in rs)] * n_chunks
    sched = ThemisScheduler(LatencyModel.for_topology(topo),
                            policy if policy != "themis_scf" else "themis")
    chunks = sched.schedule_collective("AR", nbytes, n_chunks)
    orders = []
    for c in chunks:
        rs = [d for ph, d in c.schedule if ph == Phase.RS]
        orders.append(tuple(names[d] for d in rs))
    return orders


def themis_axis_orders_stream(
    axis_sizes: dict[str, int],
    bucket_bytes: list[float],
    n_chunks: int,
    policy: str = "themis",
    issue_times: list[float] | None = None,
) -> list[list[tuple[str, ...]]]:
    """Per-chunk RS axis orders for a *stream* of gradient-bucket ARs.

    Unlike :func:`themis_axis_orders` (one fused collective, tracker reset),
    this runs ONE incremental scheduler across the whole bucket stream
    (``schedule_request``): bucket k's chunk orders account for the residual
    dim loads of buckets 0..k-1 still in flight — the trace-time analogue of
    overlapping backprop collectives.  ``issue_times`` defaults to
    back-to-back issue (all 0.0, i.e. maximum residual contention).
    Returns one order list per bucket, each with ``n_chunks`` entries.
    """
    topo, names = topology_from_axes(axis_sizes)
    if topo.num_dims == 0:
        return [[()] * n_chunks for _ in bucket_bytes]
    if policy in ("baseline", "hier_baseline"):
        rs = [d for ph, d in baseline_order(topo.num_dims, "RS")]
        return [[tuple(names[d] for d in rs)] * n_chunks for _ in bucket_bytes]
    if issue_times is None:
        issue_times = [0.0] * len(bucket_bytes)
    sched = ThemisScheduler(
        LatencyModel.for_topology(topo),
        policy if policy != "themis_scf" else "themis")
    out: list[list[tuple[str, ...]] | None] = [None] * len(bucket_bytes)
    # schedule in issue order (the tracker clock only moves forward) while
    # returning orders indexed like the input buckets
    for i in sorted(range(len(bucket_bytes)), key=lambda i: (issue_times[i], i)):
        chunks = sched.schedule_request(
            CollectiveRequest("AR", bucket_bytes[i], issue_time=issue_times[i]),
            n_chunks)
        out[i] = [
            tuple(names[d] for ph, d in c.schedule if ph == Phase.RS)
            for c in chunks
        ]
    return out


def predicted_axis_loads(
    axis_sizes: dict[str, int], nbytes: float, orders: list[tuple[str, ...]]
) -> dict[str, float]:
    """Dim-Load-Tracker view of a chunk-order assignment (seconds/axis)."""
    topo, names = topology_from_axes(axis_sizes)
    lm = LatencyModel.for_topology(topo)
    idx = {n: i for i, n in enumerate(names)}
    loads = {n: 0.0 for n in names}
    per_chunk = nbytes / max(len(orders), 1)
    for order in orders:
        sched = [(Phase.RS, idx[a]) for a in order] + [
            (Phase.AG, idx[a]) for a in reversed(order)
        ]
        for d, secs in lm.calc_loads(per_chunk, sched).items():
            loads[names[d]] += secs
    return loads
