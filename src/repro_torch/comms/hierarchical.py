"""Chunked hierarchical collectives over mesh axes, on ``torch.distributed``
(port of ``repro/comms/hierarchical.py``).

The paper's multi-rail hierarchical algorithm (Sec. 2.3): an All-Reduce over
D mesh axes is a pipeline of per-axis Reduce-Scatters followed by
All-Gathers in reverse order; the gradient buffer is split into chunks and
**each chunk carries its own axis order**, the Themis schedule (Sec. 4).
A chunk's AG order is the reverse of its RS order (Algorithm 1 line 8), so
the pairs invert each other exactly and the element layout round-trips.

Each call takes the ``launch.mesh.Mesh`` whose per-axis process groups carry
it. A reduce-scatter over a group hands group rank j the j-th block, as
JAX's ``psum_scatter(tiled=True)`` hands it to ``axis_index`` j. The list
forms ``dist.reduce_scatter`` and ``dist.all_gather`` are used, over views
of one buffer: ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` are
deprecated in newer PyTorch, and the list forms exist in every version the
port runs on.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

AxisOrder = tuple[str, ...]


def world_size(axes: tuple[str, ...], mesh) -> int:
    return math.prod(mesh.axis_size(a) for a in axes)


def chunk_len(n: int, n_chunks: int, world: int) -> int:
    """Length of each of the ``n_chunks`` equal chunks that hold ``n``
    elements, zero-padded at the end to a multiple of ``world``."""
    return -(-n // (n_chunks * world)) * world


def pad_to_chunks(flat: torch.Tensor, n_chunks: int, axes: tuple[str, ...],
                  mesh):
    """Pad a flat vector so it splits into n_chunks divisible by the world."""
    n = flat.shape[0]
    per = chunk_len(n, n_chunks, world_size(axes, mesh))
    padded = F.pad(flat, (0, n_chunks * per - n))
    return padded.reshape(n_chunks, per), n


def reduce_scatter_axis(y: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Sum ``y`` over the ranks of ``axis``; return this rank's block."""
    a = mesh.axis_size(axis)
    out = torch.empty(y.shape[0] // a, dtype=y.dtype, device=y.device)
    dist.reduce_scatter(out, list(y.contiguous().chunk(a)), group=mesh.group(axis))
    return out


def all_gather_axis(y: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Concatenate the blocks of the ranks of ``axis`` in their order."""
    a = mesh.axis_size(axis)
    out = torch.empty(y.shape[0] * a, dtype=y.dtype, device=y.device)
    dist.all_gather(list(out.chunk(a)), y.contiguous(), group=mesh.group(axis))
    return out


def chunked_reduce_scatter(chunks: torch.Tensor, orders: list[AxisOrder],
                           mesh) -> list[torch.Tensor]:
    """chunks: (C, L) local addends -> list of C shards (L/world each).

    Chunk i is reduce-scattered along ``orders[i]`` axis by axis; the shard
    this rank owns is the nested (order-lexicographic) block."""
    out = []
    for i, order in enumerate(orders):
        y = chunks[i]
        for ax in order:
            y = reduce_scatter_axis(y, ax, mesh)
        out.append(y)
    return out


def chunked_all_gather(shards: list[torch.Tensor], orders: list[AxisOrder],
                       mesh) -> torch.Tensor:
    """Inverse of ``chunked_reduce_scatter`` (AG order = reverse RS order)."""
    out = []
    for y, order in zip(shards, orders):
        for ax in reversed(order):
            y = all_gather_axis(y, ax, mesh)
        out.append(y)
    return torch.stack(out)  # (C, L)


def chunked_all_reduce(flat: torch.Tensor, orders: list[AxisOrder], mesh, *,
                       mean: bool = True) -> torch.Tensor:
    """Themis/baseline-scheduled hierarchical All-Reduce of a flat buffer."""
    axes = tuple(orders[0])
    chunks, n = pad_to_chunks(flat, len(orders), axes, mesh)
    shards = chunked_reduce_scatter(chunks, orders, mesh)
    if mean:
        w = world_size(axes, mesh)
        shards = [s / w for s in shards]
    gathered = chunked_all_gather(shards, orders, mesh)
    return gathered.reshape(-1)[:n]


# -- int8-on-the-wire reduce-scatter (beyond paper: gradient compression) ----
def _quantize(x: torch.Tensor):
    """Symmetric per-tensor int8: (codes, fp32 scale as a 0-d tensor)."""
    scale = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_reduce_scatter_axis(y: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Reduce-scatter with an int8 payload on the wire: quantize, send block
    j of the codes to group rank j (``all_to_all_single``), all-gather the
    scales, de-quantize and sum locally. 4x less wire traffic per hop than
    fp32; the error is compensated by the step's error feedback."""
    a = mesh.axis_size(axis)
    group = mesh.group(axis)
    q, scale = _quantize(y)
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    scales = torch.empty(a, dtype=scale.dtype, device=y.device)
    dist.all_gather(list(scales.chunk(a)), scale.reshape(1), group=group)
    deq = recv.reshape(a, -1).float() * scales[:, None]
    return deq.sum(0)


def chunked_reduce_scatter_int8(chunks: torch.Tensor, orders: list[AxisOrder],
                                mesh) -> list[torch.Tensor]:
    out = []
    for i, order in enumerate(orders):
        y = chunks[i]
        for ax in order:
            y = int8_reduce_scatter_axis(y, ax, mesh)
        out.append(y)
    return out
