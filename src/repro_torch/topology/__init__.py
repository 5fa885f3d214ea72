"""The port's copy of ``repro/topology``: ``algorithms.py``, ``topology.py``
and ``search.py``, imports aside."""
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


def __getattr__(name):
    # repro_torch.topology.search imports repro_torch.core (batch scoring), which imports
    # repro_torch.topology — a lazy attribute breaks the would-be cycle while
    # keeping ``from repro_torch.topology import search_topologies`` working.
    _search_names = {
        "CandidateScore", "SearchConfig", "SearchResult",
        "bw_split_topology", "enumerate_bw_shares", "search_topologies",
        "stream_lower_bound",
    }
    if name in _search_names:
        from . import search

        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "ALGO_BY_KIND",
    "ALL_TOPOLOGIES",
    "GBPS",
    "CandidateScore",
    "CollectiveAlgorithm",
    "DIRECT",
    "HALVING_DOUBLING",
    "NetworkDim",
    "Phase",
    "RING",
    "SearchConfig",
    "SearchResult",
    "TopoKind",
    "Topology",
    "bw_split_topology",
    "enumerate_bw_shares",
    "make_current_topology",
    "make_table2_topologies",
    "make_tpu_pod_topology",
    "search_topologies",
    "stream_lower_bound",
]
