"""Chunk-schedule consistency (paper Sec. 4.6).

Inter-dimension consistency (4.6.1) is structural in our implementation:
the Latency Model and Dim Load Tracker are deterministic pure functions of
offline parameters (A_K, B_K), so every NPU derives the *same* per-chunk
schedules.  (In the JAX integration this is even stronger — a single SPMD
program is compiled once and runs on all devices.)

Intra-dimension consistency (4.6.2): runtime variation could make chunks
ready in different orders on different NPUs and deadlock the collective.
Themis therefore simulates the execution offline (deterministically) and
fixes the per-dimension op order; at runtime every NPU serves ops in exactly
this order, idling rather than serving out of turn.  The order is computed
once per (collective, schedule) and reused across training iterations.

This is the port's copy of ``repro/core/consistency.py``, imports aside;
it leaves out nothing.
"""
from __future__ import annotations

from repro_torch.core.chunking import Chunk
from repro_torch.core.simulator import OpId, simulate
from repro_torch.topology import Topology


def fix_intra_dim_order(
    topology: Topology,
    chunk_groups: list[list[Chunk]],
    *,
    intra: str = "SCF",
    fusion: bool = True,
) -> list[list[OpId]]:
    """Deterministic offline simulation -> per-dim mandated op order."""
    res = simulate(topology, chunk_groups, intra=intra, fusion=fusion)
    return res.dim_op_order


def verify_consistent_execution(
    topology: Topology,
    chunk_groups: list[list[Chunk]],
    *,
    intra: str = "SCF",
    jitter: float = 0.3,
    trials: int = 5,
) -> bool:
    """With the mandated order enforced, per-dim service order is identical
    across runs regardless of runtime jitter (deadlock-freedom argument)."""
    order = fix_intra_dim_order(topology, chunk_groups, intra=intra)
    for trial in range(trials):
        res = simulate(
            topology,
            chunk_groups,
            intra=intra,
            enforced_order=order,
            jitter=jitter,
            seed=trial + 1,
        )
        if res.dim_op_order != order:
            return False
    return True
