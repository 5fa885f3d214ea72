"""Bridge: Themis scheduler -> per-chunk axis orders of the Themis train step
(port of the scheduling half of ``repro/comms/schedule_bridge.py``).

The paper computes schedules once and reuses them (Sec. 4.6.2), so Themis's
greedy pass runs once when the step is built: the mesh axes are modelled as
a Themis topology (the reference's TPU mapping, ICI axes innermost, the DCN
'pod' axis outermost, kept exactly so that the orders equal the
reference's), Algorithm 1 runs over the gradient buffer, and the per-chunk
axis orders are what ``comms/hierarchical.py`` issues over
``torch.distributed``.

The collective audit (``collective_stats``) has no HLO to parse: a
``CollectiveCounter`` records every collective that runs inside it (the
functional collectives of DTensor's redistributions and the in-place
``torch.distributed`` calls of the Themis step, on any group) by the
reference's HLO kind names and result bytes, and ``collective_stats``
sums them under the reference's keys.
"""
from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

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


# -- collective audit -----------------------------------------------------------
# op name -> the reference's HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
}


def tensors_of(x) -> list:
    """The tensors in ``x`` (nested lists, tuples and dict values)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


def _group_size(args) -> int | None:
    """The size of the process group an op names: a ``ProcessGroup``
    argument (the in-place ops) or a group name (the functional ones)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except Exception:  # another script object
                continue
    for a in args:
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group,
                )

                return _resolve_process_group(a).size()
            except Exception:  # not a group name (a reduce op's name)
                continue
    return None


def _fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors_of(list(args)))


class CollectiveCounter(TorchDispatchMode):
    """Records every collective that runs inside it as (kind, result bytes,
    group size). The bytes are those of the op's result, as the reference
    counts an HLO op's result shape: an all-gather's is its group's size
    times its input, a reduce-scatter's its input over that size; a
    ``send`` counts as a collective-permute of its tensor (the matching
    ``recv`` is not counted again). DTensor's move of a split from one dim
    to another on a CUDA mesh (``_dtensor.shard_dim_alltoall``) counts as
    the all-to-all it is.

    An op on DTensors passes to DTensor (``NotImplemented``), so the
    counter sees the local ops and collectives that DTensor runs for it,
    on each rank's shards; the fake tensors of DTensor's sharding
    propagation are not counted. ``on_local_op(func, args, kwargs, out)``
    is called for every other op, for a subclass to count more."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int, int | None]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _fake(args):
            return out
        kind = (_KINDS.get(func._opname) if func.namespace in
                ("c10d", "_c10d_functional", "_dtensor") else None)
        if kind is not None:
            # the in-place ops write their first argument, the others return
            result = args[0] if func.namespace == "c10d" else out
            self.records.append((kind, _nbytes(result), _group_size(args)))
        else:
            self.on_local_op(func, args, kwargs, out)
        return out

    def on_local_op(self, func, args, kwargs, out) -> None:
        pass


def collective_stats(counter: CollectiveCounter) -> dict:
    """The reference's summary of the collectives a ``CollectiveCounter``
    recorded: bytes by kind and by group size, op counts, total bytes."""
    by_kind: dict[str, float] = defaultdict(float)
    by_group: dict[int, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for kind, nbytes, size in counter.records:
        by_kind[kind] += nbytes
        counts[kind] += 1
        if size is not None:
            by_group[size] += nbytes
    return {
        "bytes_by_kind": dict(by_kind),
        "bytes_by_group_size": dict(by_group),
        "op_counts": dict(counts),
        "total_bytes": float(sum(by_kind.values())),
    }
