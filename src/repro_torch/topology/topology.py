"""Multi-dimensional network topologies (paper Table 2 + TPU pod models).

A ``Topology`` is an ordered list of ``NetworkDim``.  Dim 1 is the innermost
(highest-BW) dimension.  Bandwidths are *uni-directional aggregate* GB/s per
NPU for that dimension (paper's "Aggr BW/NPU", converted from Gb/s), and
``step_latency_s`` is the minimum NPU-to-NPU message latency on that
dimension (paper's "Network Latency").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .algorithms import ALGO_BY_KIND, CollectiveAlgorithm, TopoKind

GBPS = 1e9 / 8  # 1 Gb/s in bytes/s


@dataclass(frozen=True)
class NetworkDim:
    """One dimension of a hierarchical NPU network.

    ``straggler_sigma`` models service-time stragglers on this dimension:
    every service interval is multiplied by a lognormal(0, sigma) draw
    (median 1, heavy right tail — the classic DCN tail-latency shape).
    0.0 (default) keeps the dimension deterministic; the draw is seeded by
    ``simulate(seed=...)`` so runs are reproducible.
    """

    npus: int                      # peers participating on this dim (P_i)
    topo: TopoKind                 # physical topology of this dim
    link_gbps: float               # per-link uni-directional BW (Gb/s)
    links_per_npu: int             # links each NPU contributes to this dim
    step_latency_s: float          # min NPU->NPU message latency (s)
    straggler_sigma: float = 0.0   # lognormal service-straggler sigma

    @property
    def aggr_bw_bytes(self) -> float:
        """Aggregate uni-directional BW per NPU on this dim, bytes/s."""
        return self.link_gbps * self.links_per_npu * GBPS

    @property
    def algorithm(self) -> CollectiveAlgorithm:
        return ALGO_BY_KIND[self.topo]


@dataclass(frozen=True)
class Topology:
    name: str
    dims: tuple[NetworkDim, ...]

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    @property
    def total_npus(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.npus
        return n

    @property
    def total_bw_bytes(self) -> float:
        """Sum of per-NPU aggregate BW across all dims (for Ideal/util)."""
        return sum(d.aggr_bw_bytes for d in self.dims)

    def size_str(self) -> str:
        return "x".join(str(d.npus) for d in self.dims)


def _dim(npus, topo, link_gbps, links, lat_ns, straggler=0.0) -> NetworkDim:
    return NetworkDim(npus, topo, link_gbps, links, lat_ns * 1e-9, straggler)


SW = TopoKind.SWITCH
FC = TopoKind.FULLY_CONNECTED
RING = TopoKind.RING


def make_table2_topologies() -> dict[str, Topology]:
    """The six 1024-NPU next-gen topologies of paper Table 2."""
    t = {}
    t["2D-SW_SW"] = Topology(
        "2D-SW_SW",
        (
            _dim(16, SW, 200, 6, 700),
            _dim(64, SW, 800, 1, 1700),
        ),
    )
    t["3D-SW_SW_SW_homo"] = Topology(
        "3D-SW_SW_SW_homo",
        (
            _dim(16, SW, 200, 4, 700),
            _dim(8, SW, 200, 4, 700),
            _dim(8, SW, 800, 1, 1700),
        ),
    )
    t["3D-SW_SW_SW_hetero"] = Topology(
        "3D-SW_SW_SW_hetero",
        (
            _dim(16, SW, 200, 8, 700),
            _dim(8, SW, 200, 4, 700),
            _dim(8, SW, 400, 1, 1700),
        ),
    )
    t["3D-FC_Ring_SW"] = Topology(
        "3D-FC_Ring_SW",
        (
            _dim(8, FC, 200, 7, 700),
            _dim(16, RING, 200, 4, 700),
            _dim(8, SW, 400, 1, 1700),
        ),
    )
    t["4D-Ring_SW_SW_SW"] = Topology(
        "4D-Ring_SW_SW_SW",
        (
            _dim(4, RING, 1000, 2, 20),
            _dim(4, SW, 200, 8, 700),
            _dim(8, SW, 200, 4, 700),
            _dim(8, SW, 400, 1, 1700),
        ),
    )
    t["4D-Ring_FC_Ring_SW"] = Topology(
        "4D-Ring_FC_Ring_SW",
        (
            _dim(4, RING, 1500, 2, 20),
            _dim(8, FC, 200, 7, 700),
            _dim(4, RING, 200, 6, 700),
            _dim(8, SW, 800, 1, 1700),
        ),
    )
    return t


def make_current_topology() -> Topology:
    """Today's 2D system used as the paper's 'current' reference (Sec. 3):
    1200 Gb/s intra-node vs 100 Gb/s NIC."""
    return Topology(
        "current-2D",
        (
            _dim(16, SW, 200, 6, 700),
            _dim(64, SW, 100, 1, 1700),
        ),
    )


def make_tpu_pod_topology(
    pods: int = 2, data: int = 16, model: int = 16,
    *, dcn_straggler_sigma: float = 0.0,
) -> Topology:
    """TPU-v5e-flavored hierarchy used by the JAX integration layer.

    dim1: `model` axis — ICI ring, ~50 GB/s/link (2 links usable per axis).
    dim2: `data` axis  — ICI ring on the second mesh axis.
    dim3: `pod` axis   — DCN through NICs (~200 Gb/s per host).

    Dims are ordered innermost-first like the paper.

    ``dcn_straggler_sigma``: lognormal straggler sigma on the DCN pod
    dimension (ICI dims stay deterministic) — cross-pod collectives ride
    a shared datacenter network whose tail is what Sec. 4.6's schedule-
    consistency experiments care about.  Seeded via ``simulate(seed=...)``.
    """
    if dcn_straggler_sigma < 0:
        raise ValueError("dcn_straggler_sigma must be >= 0")
    if dcn_straggler_sigma and pods <= 1:
        raise ValueError(
            "dcn_straggler_sigma needs a DCN dimension (pods > 1); a "
            "single-pod topology would silently ignore it")
    dims = []
    if model > 1:
        dims.append(_dim(model, RING, 400, 2, 1000))   # 50 GB/s * 2 links
    if data > 1:
        dims.append(_dim(data, RING, 400, 2, 1000))
    if pods > 1:
        dims.append(_dim(pods, SW, 200, 1, 20000,      # DCN NIC
                         straggler=dcn_straggler_sigma))
    name = f"tpu-{pods}x{data}x{model}"
    if dcn_straggler_sigma and pods > 1:
        name += f"-dcnjit{dcn_straggler_sigma:g}"
    return Topology(name, tuple(dims))


ALL_TOPOLOGIES: dict[str, Topology] = {
    **make_table2_topologies(),
    "current-2D": make_current_topology(),
}
