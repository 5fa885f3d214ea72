"""Per-dimension topology-aware collective algorithms (paper Table 1).

Each network dimension runs a basic, contention-free collective algorithm
chosen by its physical topology:

    Ring            -> ring algorithm            (P-1 steps for RS/AG)
    FullyConnected  -> direct algorithm          (1 step)
    Switch          -> halving-doubling          (log2(P) steps)

For a chunk whose per-NPU resident size is ``S`` bytes *before* the stage,
all three algorithms move ``n = (P-1)/P * S`` bytes per NPU on that
dimension for either Reduce-Scatter or All-Gather (bandwidth-optimal), and
the chunk shrinks (RS) or grows (AG) by ``P`` after the stage.  They differ
in the number of serialized steps, which feeds the fixed-latency term
``A_K = steps * step_latency`` of the paper's latency model (Sec. 4.4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum


class Phase(str, Enum):
    RS = "RS"  # Reduce-Scatter
    AG = "AG"  # All-Gather


class TopoKind(str, Enum):
    RING = "Ring"
    FULLY_CONNECTED = "FullyConnected"
    SWITCH = "Switch"


@dataclass(frozen=True)
class CollectiveAlgorithm:
    """Cost model of the basic collective used on one network dimension."""

    kind: TopoKind

    def steps(self, npus: int, phase: Phase) -> int:
        """Number of serialized network steps for one RS or AG stage."""
        if npus <= 1:
            return 0
        if self.kind == TopoKind.RING:
            return npus - 1
        if self.kind == TopoKind.FULLY_CONNECTED:
            return 1
        # Halving-doubling on a switch.
        return int(math.ceil(math.log2(npus)))

    def bytes_on_wire(self, npus: int, chunk_bytes: float) -> float:
        """Bytes each NPU sends on this dimension for one RS/AG stage.

        ``chunk_bytes`` is the per-NPU resident size *before* the stage
        (paper's chunk-size convention, Sec. 2.3).
        """
        if npus <= 1:
            return 0.0
        return (npus - 1) / npus * chunk_bytes


RING = CollectiveAlgorithm(TopoKind.RING)
DIRECT = CollectiveAlgorithm(TopoKind.FULLY_CONNECTED)
HALVING_DOUBLING = CollectiveAlgorithm(TopoKind.SWITCH)

ALGO_BY_KIND = {
    TopoKind.RING: RING,
    TopoKind.FULLY_CONNECTED: DIRECT,
    TopoKind.SWITCH: HALVING_DOUBLING,
}
