"""Dependency-aware traffic subsystem.

One IR for every request stream the engine serves: fixed-time training
buckets, 1F1B pipeline stage streams, and serving prefill/decode chains —
:class:`TrafficNode`/:class:`TrafficGraph` express "this collective issues
when those finish plus this much compute", the builders generate the three
workload families, and :func:`simulate_traffic` runs a graph through the
incremental Themis scheduler and the dependency-gated simulator engines.

The port's copy of ``repro/traffic``, imports aside: plain Python, as the
reference is.
"""
from repro_torch.traffic.builders import (
    pipeline_traffic,
    serving_costs_from_arch,
    serving_traffic,
    training_traffic,
)
from repro_torch.traffic.engine import schedule_traffic, simulate_traffic
from repro_torch.traffic.ir import (
    TrafficGraph,
    TrafficNode,
    from_requests,
    merge_graphs,
    retag,
)

__all__ = [
    "TrafficGraph",
    "TrafficNode",
    "from_requests",
    "merge_graphs",
    "pipeline_traffic",
    "retag",
    "schedule_traffic",
    "serving_costs_from_arch",
    "serving_traffic",
    "simulate_traffic",
    "training_traffic",
]
