"""The port's copy of the names of ``repro/topology`` that the scheduler
core and the schedule bridge use (``algorithms.py`` and ``topology.py``,
copied as they are; ``search.py`` is not carried)."""
from .algorithms import (
    ALGO_BY_KIND,
    DIRECT,
    HALVING_DOUBLING,
    RING,
    CollectiveAlgorithm,
    Phase,
    TopoKind,
)
from .topology import (
    ALL_TOPOLOGIES,
    GBPS,
    NetworkDim,
    Topology,
    make_current_topology,
    make_table2_topologies,
    make_tpu_pod_topology,
)

__all__ = [
    "ALGO_BY_KIND",
    "ALL_TOPOLOGIES",
    "GBPS",
    "CollectiveAlgorithm",
    "DIRECT",
    "HALVING_DOUBLING",
    "NetworkDim",
    "Phase",
    "RING",
    "TopoKind",
    "Topology",
    "make_current_topology",
    "make_table2_topologies",
    "make_tpu_pod_topology",
]
