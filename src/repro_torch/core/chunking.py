"""Splitter (paper Fig. 6 step 2) — divide a collective into chunks.

The paper uses equal-size chunks (default 64 per collective).  We also
provide a beyond-paper *water-filling* splitter: run the greedy scheduler
with a large number of virtual micro-chunks to estimate the fractional mass
each dimension-order should receive, then coalesce the micro-chunks into at
most ``chunks_per_collective`` real chunks of *unequal* sizes whose order
classes match the fractional solution.  This approaches the Ideal bound with
far fewer chunks (lower A-term overhead).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.latency_model import StageOp


@dataclass
class Chunk:
    """One schedulable unit of a collective."""

    index: int
    size_bytes: float
    # Ordered stages assigned by the scheduler; empty until scheduled.
    schedule: list[StageOp] = field(default_factory=list)


def split_equal(collective_bytes: float, chunks_per_collective: int) -> list[Chunk]:
    """Paper's Splitter: equal-size chunks."""
    if chunks_per_collective < 1:
        raise ValueError("chunks_per_collective must be >= 1")
    size = collective_bytes / chunks_per_collective
    return [Chunk(i, size) for i in range(chunks_per_collective)]


def schedule_classes(chunks: list[Chunk]) -> tuple[list[tuple[float, tuple]], list[int]]:
    """Group chunks by their (size, schedule) equivalence class.

    Two chunks with the same size and the same stage order produce *exactly*
    the same per-stage wire bytes and fixed delays, so the per-stage float
    evaluation only needs to run once per class.  Returns ``(classes,
    class_of_chunk)`` where ``classes[i]`` is the ``(size_bytes, schedule)``
    key of class *i* and ``class_of_chunk[j]`` is chunk *j*'s class index,
    in chunk order.  Equal-split collectives have a handful of classes (one
    per distinct dim order the scheduler emitted); the vectorized task
    builder (``repro.core.batch``) broadcasts each class's stage vectors
    across its members instead of re-deriving them chunk by chunk.
    """
    class_idx: dict[tuple, int] = {}
    classes: list[tuple[float, tuple]] = []
    class_of_chunk: list[int] = []
    for c in chunks:
        key = (c.size_bytes, tuple(c.schedule))
        got = class_idx.get(key)
        if got is None:
            got = class_idx[key] = len(classes)
            classes.append(key)
        class_of_chunk.append(got)
    return classes, class_of_chunk


def coalesce_by_order(
    micro_chunks: list[Chunk], max_chunks: int
) -> list[Chunk]:
    """Merge scheduled micro-chunks with identical stage orders.

    Used by the water-filling splitter: after greedily scheduling many tiny
    chunks, chunks sharing the same dimension order are mass-equivalent and
    can be fused into one larger chunk, preserving the per-dimension byte
    assignment exactly while reducing per-chunk fixed overhead.
    """
    groups: dict[tuple, Chunk] = {}
    for c in micro_chunks:
        key = tuple(c.schedule)
        if key in groups:
            groups[key].size_bytes += c.size_bytes
        else:
            groups[key] = Chunk(len(groups), c.size_bytes, list(c.schedule))
    merged = list(groups.values())
    merged.sort(key=lambda c: -c.size_bytes)
    if len(merged) > max_chunks:
        # Fold the smallest groups into the largest group of the same first
        # dimension (keeps per-dim loads close to the fractional solution).
        keep, spill = merged[:max_chunks], merged[max_chunks:]
        for s in spill:
            target = min(
                (k for k in keep if k.schedule and s.schedule
                 and k.schedule[0][1] == s.schedule[0][1]),
                key=lambda k: k.size_bytes,
                default=keep[-1],
            )
            target.size_bytes += s.size_bytes
        merged = keep
    for i, c in enumerate(merged):
        c.index = i
    return merged
