"""GSPMD partition rules as DTensor placements (port of
``repro/sharding/specs.py``).

The rules are the reference's, name and rank based and divisibility-safe:
an axis is assigned to a dim only if the mesh axis's size divides it.

  * TP ("model"): last dim of input projections, first weight dim of output
    projections, the vocab dim of the embedding, the expert dim of MoE
    expert stacks.
  * FSDP ("data", optional): the complementary weight dim.
  * Optimizer states inherit the param spec; with ``zero >= 1`` an extra
    "data" axis goes to the largest unsharded dim (ZeRO-1).
  * Batches split (pod, data) over the batch dim; KV caches split batch and
    heads (or head_dim when the heads do not divide, as for MQA).

A spec is a plain tuple with one entry per tensor dim: None, an axis name,
or a tuple of axis names (the dim split over several axes, the first
major). The rules take anything with a ``.shape`` dict of axis sizes: the
port's ``launch.mesh.Mesh`` or a shape-only stand-in.

``placements(spec, mesh)`` turns a spec into DTensor placements over the
mesh's dims: ``Shard(i)`` on each mesh dim whose axis names tensor dim i,
``Replicate()`` elsewhere; ``spec_of`` is its inverse. DTensor splits a
tensor dim over several mesh dims in mesh-dim order, so a tuple entry is
taken only in the mesh's order (GSPMD's rules only make that order). The
Themis step's ``("model", "data", "pod")`` batch split is not a placement:
that step lays its shards out by hand.

``param_placements``, ``opt_placements`` and ``cache_placements`` map a
tree of tensors (nested dicts and lists, as the port's params and caches)
to a tree of placements by the reference's path strings
(``"blocks/attn/wq"``, ``"tail/0/ln1"``). ``distribute`` wraps each leaf's
local block as a DTensor (no collective: every rank holds the whole
tensor, made from the same seed), ``gather`` does the reverse (a
collective on every rank).
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.configs.base import ParallelConfig

IN_PROJ = re.compile(
    r"(wq|wk|wv|wi|wg|w_up|linear_x|linear_y|w_gates|router|w_i|w_f|r_gates)$"
)
OUT_PROJ = re.compile(r"(wo|w_down|linear_out|w_out)$")
BIAS = re.compile(r"(bq|bk|bv)$")

Spec = tuple


def _axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def _names(entry) -> list[str]:
    if entry is None:
        return []
    return [entry] if isinstance(entry, str) else list(entry)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    need = math.prod(_axis_size(mesh, a) for a in _names(axis))
    return dim % need == 0 and dim >= need


def _spec(shape, mesh, assign: dict[int, Any]) -> Spec:
    """assign: dim index (negative ok) -> axis name; divisibility-checked."""
    out = [None] * len(shape)
    for di, ax in assign.items():
        i = di % len(shape)
        if _fits(shape[i], mesh, ax):
            out[i] = ax
    return tuple(out)


def param_pspec(path_str: str, shape: tuple[int, ...], mesh,
                parallel: ParallelConfig) -> Spec:
    fsdp = "data" if parallel.fsdp else None
    name = path_str.rsplit("/", 1)[-1]
    rank = len(shape)

    if name == "embed":
        return _spec(shape, mesh, {0: "model", 1: fsdp})
    if name == "lm_head":
        return _spec(shape, mesh, {0: fsdp, 1: "model"})
    if "moe" in path_str and name in ("wi", "wg") and rank >= 3:
        # (..., E, D, F): expert parallelism + FSDP on d_model
        return _spec(shape, mesh, {-3: "model", -2: fsdp})
    if "moe" in path_str and name == "wo" and rank >= 3:
        return _spec(shape, mesh, {-3: "model", -1: fsdp})
    if BIAS.match(name):
        return _spec(shape, mesh, {-1: "model"})
    if IN_PROJ.search(name) and rank >= 2:
        return _spec(shape, mesh, {-1: "model", -2: fsdp})
    if OUT_PROJ.search(name) and rank >= 2:
        return _spec(shape, mesh, {-2: "model", -1: fsdp})
    return (None,) * rank


def opt_state_pspec(pspec: Spec, shape, mesh, parallel: ParallelConfig) -> Spec:
    """ZeRO-1: add a "data" axis to the largest unsharded dim if possible."""
    if parallel.zero < 1 or parallel.fsdp:
        return pspec  # fsdp already shards over data
    used = set()
    for e in pspec:
        used.update(_names(e))
    if "data" in used:
        return pspec
    dims = list(pspec) + [None] * (len(shape) - len(pspec))
    # largest unsharded, divisible dim
    cands = [i for i in range(len(shape))
             if dims[i] is None and _fits(shape[i], mesh, "data")]
    if not cands:
        return pspec
    i = max(cands, key=lambda j: shape[j])
    dims[i] = "data"
    return tuple(dims)


def batch_pspec(shape: tuple[int, ...], mesh, global_batch: int) -> Spec:
    dp = tuple(a for a in ("pod", "data") if _axis_size(mesh, a) > 1)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    out = [None] * len(shape)
    for i, d in enumerate(shape):
        if d == global_batch and _fits(d, mesh, dp) and dp is not None:
            out[i] = dp
            break
    return tuple(out)


def cache_pspec(path_str: str, shape, mesh, global_batch: int) -> Spec:
    """KV caches / recurrent states: batch over dp, heads/hd over model."""
    spec = list(batch_pspec(shape, mesh, global_batch))
    name = path_str.rsplit("/", 1)[-1]
    if name in ("k", "v") and len(shape) >= 4:
        # (..., T, KV, hd)
        if _fits(shape[-2], mesh, "model") and shape[-2] > 1:
            spec[-2] = "model"
        elif _fits(shape[-1], mesh, "model"):
            spec[-1] = "model"
    elif name in ("C", "n", "h", "conv", "memory") and len(shape) >= 2:
        if spec[-1] is None and _fits(shape[-1], mesh, "model") and shape[-1] >= 64:
            spec[-1] = "model"
    return tuple(spec)


# -- DTensor placements ------------------------------------------------------
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh.names``: ``Shard(i)`` on
    each mesh dim that names tensor dim i, ``Replicate()`` elsewhere. Axis
    names the mesh lacks are dropped (size 1). Raises ``ValueError`` when a
    tuple entry names its axes in another order than the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    mesh_names = _mesh_names(mesh)
    out = [Replicate()] * len(mesh_names)
    for i, entry in enumerate(spec):
        names = [a for a in _names(entry) if a in mesh_names]
        idx = [mesh_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis "
                             f"order {mesh_names}: DTensor splits a dim over "
                             "mesh dims in mesh order")
        for j in idx:
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {mesh_names[j]!r} named twice "
                                 f"in {spec!r}")
            out[j] = Shard(i)
    return tuple(out)


def _mesh_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names in order (a shape-only stand-in: its shape
    dict's keys)."""
    return tuple(getattr(mesh, "names", None) or mesh.shape)


def spec_of(pls, mesh, ndim: int) -> Spec:
    """The inverse of ``placements``: the spec that ``pls`` realise."""
    out: list = [[] for _ in range(ndim)]
    for name, p in zip(_mesh_names(mesh), pls):
        if p.is_shard():
            out[p.dim % ndim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on {name!r} has no spec")
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in out)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path_str, leaf)`` over nested dicts and lists (a tuple, as a
    spec or placements, is a leaf), the reference's ``_path_str`` as the
    path: dict keys and list indices joined by "/"."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{path}{i}/")
                for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def param_specs(tree, mesh, parallel: ParallelConfig):
    return tree_map_with_path(
        lambda path, x: param_pspec(path, tuple(x.shape), mesh, parallel), tree)


def opt_specs(tree, mesh, parallel: ParallelConfig):
    return tree_map_with_path(
        lambda path, x: opt_state_pspec(
            param_pspec(path, tuple(x.shape), mesh, parallel), tuple(x.shape),
            mesh, parallel), tree)


def cache_specs(tree, mesh, global_batch: int, stacked: bool | int = False):
    """``cache_pspec`` of every leaf. ``stacked``: every leaf carries a
    leading layer dim (an int: that many, as the xLSTM's (periods, blocks)
    stack), which stays whole: the rule is applied to one layer's shape. (On the stacked shape the rule splits the layer dim
    instead of the batch when the layer count equals the batch, and a
    layer's view of a cache split so is a gathered copy, which in-place
    writes would miss.) Where the counts differ the two specs are equal."""
    lead = int(stacked)

    def rule(path, x):
        shape = tuple(x.shape)
        return ((None,) * lead
                + cache_pspec(path, shape[lead:], mesh, global_batch))

    return tree_map_with_path(rule, tree)


def param_placements(tree, mesh, parallel: ParallelConfig):
    """Placements of every leaf of a param tree (``api.param_spec()`` or the
    params themselves) by ``param_pspec``."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              param_specs(tree, mesh, parallel))


def opt_placements(tree, mesh, parallel: ParallelConfig):
    """Placements of m and v (``opt_state_pspec``: ZeRO-1's extra "data")."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              opt_specs(tree, mesh, parallel))


def cache_placements(tree, mesh, global_batch: int,
                     stacked: bool | int = False):
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              cache_specs(tree, mesh, global_batch, stacked))


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def local_block(x, pls, dm):
    """This rank's block of the whole tensor ``x`` under placements ``pls``
    on the ``DeviceMesh`` ``dm`` (a view): each sharded mesh dim, in mesh
    order, cuts its dim into equal parts."""
    for j, p in enumerate(pls):
        if p.is_shard():
            n = dm.size(j)
            d = p.dim % x.dim()
            ln = x.shape[d] // n
            x = x.narrow(d, dm.get_local_rank(j) * ln, ln)
    return x


def local_shape(shape, pls, dm) -> tuple[int, ...]:
    """The shape of ``local_block``'s block of a tensor of ``shape``."""
    out = list(shape)
    for j, p in enumerate(pls):
        if p.is_shard():
            out[p.dim % len(out)] //= dm.size(j)
    return tuple(out)


def distribute_leaf(x, pls, mesh):
    """``x`` (the whole tensor, equal on every rank) as a DTensor of
    placements ``pls`` with no collective: this rank's block, a copy where
    it is smaller than ``x`` (so ``x`` can be freed), else ``x``'s own
    storage (every leaf on a one-rank mesh)."""
    from torch.distributed.tensor import DTensor

    local = local_block(x.detach(), pls, mesh.device_mesh)
    if local.numel() != x.numel():
        local = local.clone()
    out = DTensor.from_local(local, mesh.device_mesh, pls, run_check=False)
    return out.requires_grad_(x.requires_grad)


def distribute(tree, mesh, pls_tree):
    """Every leaf of ``tree`` as a DTensor (``distribute_leaf``)."""
    return _zip_map(lambda x, pls: distribute_leaf(x, pls, mesh), tree, pls_tree)


def gather(tree):
    """Every DTensor leaf as its whole tensor (a collective: every rank
    calls it); other leaves pass through."""
    from torch.distributed.tensor import DTensor

    def one(x):
        if isinstance(x, DTensor):
            return x.full_tensor()
        return x

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather(v) for v in tree]
    return one(tree)
