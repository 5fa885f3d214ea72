"""Train-step builders (port of ``repro/train/step.py``).

Two data-parallel gradient-sync modes:

* ``gspmd``: the production default of the reference, one GSPMD program
  with every collective inserted by XLA. The port runs it over DTensors on
  a mesh with a ``DeviceMesh`` (any process group, one rank included):
  params on ``param_pspec``'s placements (tensor parallelism on "model",
  FSDP on "data" with ``parallel.fsdp``), m and v on ``opt_state_pspec``'s
  (ZeRO-1), the batch split on ``batch_pspec``, the model's ``constrain``
  points inside a ``mesh_context`` (``seq_sharding`` too), and the
  collectives that DTensor's redistributions make. With no mesh, or a
  group-less 1x1 one, it is the single-device step. Both accumulate
  gradients over ``tcfg.microbatch`` slices of the batch. Every family
  runs sharded: each model module carries the reference's constraint
  points (the MoE's experts on "model", ``models/moe.py``).
* ``themis`` / ``hier_baseline``: the paper's technique. Every mesh axis is
  a data-parallel axis (pure-DP ZeRO-2). Gradients are flattened, chunked
  and reduce-scattered over ``torch.distributed`` with per-chunk axis orders
  from the Themis scheduler (``comms/schedule_bridge.py``, Algorithm 1 run
  once when the step is built); the sharded AdamW update runs on each
  rank's scattered shard against fp32 master shards; the updated
  parameters are all-gathered chunk by chunk in reverse order, in the
  params' dtype. ``hier_baseline`` pins the static dim1->dimD order for
  every chunk (paper Sec. 2.3). Optional int8-on-the-wire reduce-scatter
  with per-rank error feedback. Gradients accumulate over
  ``tcfg.microbatch`` slices of the local rows before the reduce-scatter
  (the reference's Themis step ignores ``microbatch``).

Each process runs one rank and passes the step its own rows of the global
batch (``data.pipeline.local_rows``): the reference's batch spec
``P(("model", "data", "pod"))`` makes "model" the major axis of the split.
Unlike the reference, a step updates ``params`` and the optimizer state in
place (and returns them), and a one-rank mesh runs the Themis step with no
collective at all (every order is ``()``), where the reference's
``axes[0]`` raises.
"""
from __future__ import annotations

import math
from contextlib import nullcontext

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.comms.hierarchical import (
    _quantize,
    chunk_len,
    chunked_all_gather,
    chunked_reduce_scatter,
    chunked_reduce_scatter_int8,
)
from repro_torch.comms.schedule_bridge import themis_axis_orders
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models.common import mesh_context
from repro_torch.models.registry import ModelApi, count_params, leaves
from repro_torch.sharding.specs import (
    batch_pspec,
    distribute,
    distribute_leaf,
    opt_placements,
    param_placements,
    placements,
)
from repro_torch.train.optimizer import (
    adamw_init,
    adamw_step_,
    adamw_update,
    bias_corrections,
    clip_by_global_norm,
    clip_scale,
    lr_schedule,
)


def trainable(params):
    """Mark every leaf of ``params`` as requiring grad (in place)."""
    for p in leaves(params):
        if not p.requires_grad:
            p.requires_grad_(True)
    return params


# --------------------------------------------------------------------------
# GSPMD mode
# --------------------------------------------------------------------------
def sharded(mesh) -> bool:
    """Whether ``mesh`` runs the sharded (DTensor) path: it has a
    ``DeviceMesh``, that is a process group is up."""
    return mesh is not None and mesh.device_mesh is not None


def shard_batch(batch: dict, mesh) -> dict:
    """Each array of ``batch`` as a DTensor split on ``batch_pspec``: a
    DTensor passes as it is, a plain tensor is the whole global batch (the
    same on every rank), of which this rank keeps its block."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, DTensor):
            v = torch.as_tensor(v)
            v = distribute_leaf(v, placements(
                batch_pspec(tuple(v.shape), mesh, v.shape[0]), mesh), mesh)
        out[k] = v
    return out


def _micro(batch: dict, n_micro: int, mesh) -> list[dict]:
    """The batch's ``n_micro`` slices of rows (slice i: rows i*B/n ..
    (i+1)*B/n - 1, as the reference reshapes them), each placed on the
    mesh by ``batch_pspec`` of its own rows."""
    if n_micro == 1:
        return [batch]
    if mesh is None:
        micro = {k: v.chunk(n_micro) for k, v in batch.items()}
        return [{k: v[i] for k, v in micro.items()} for i in range(n_micro)]
    whole = {k: v.full_tensor() for k, v in batch.items()}
    micro = {k: v.chunk(n_micro) for k, v in whole.items()}
    return [shard_batch({k: v[i] for k, v in micro.items()}, mesh)
            for i in range(n_micro)]


def _accumulate_grads(api: ModelApi, ps, params, batch: dict, n_micro: int,
                     mesh) -> tuple:
    """The loss and the gradients of ``ps``, the means over ``n_micro``
    slices of the batch's rows (``_micro``), each slice's backward adding
    into the params' ``.grad``: one gradient of each param is live beside
    the params, the running sum, and the previous slice's is gone before
    the next slice's backward. The ``.grad`` are taken and cleared."""
    loss = None
    for mb in _micro(batch, n_micro, mesh):
        loss_i = api.loss_fn(params, mb)
        torch.autograd.backward(loss_i, inputs=ps)
        loss_i = loss_i.detach()
        loss = loss_i if loss is None else loss + loss_i
    grads = [p.grad for p in ps]
    for p in ps:
        p.grad = None
    if n_micro > 1:
        inv = 1.0 / n_micro
        for g in grads:
            g.mul_(inv)
        loss = loss * inv
    return loss, grads


def make_gspmd_train_step(api: ModelApi, mesh, parallel: ParallelConfig,
                          tcfg: TrainConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates params and opt_state in place; metrics hold
    the loss and gnorm as plain tensors, equal on every rank, and the lr.

    On a sharded mesh (``sharded(mesh)``) params and m/v are DTensors from
    ``gspmd_init_state`` and ``batch`` is placed by ``shard_batch``.
    ``tcfg.microbatch`` > 1 accumulates gradients over that many slices of
    the batch's rows, so live activations are O(batch / microbatch)."""
    dmesh = mesh if sharded(mesh) else None
    if dmesh is None and (math.prod(parallel.mesh_shape) != 1
                          or (mesh is not None and mesh.size != 1)):
        raise ValueError(f"mesh {parallel.mesh_shape}: the sharded GSPMD step "
                         "needs a Mesh over a process group")
    n_micro = max(tcfg.microbatch, 1)

    def grads_of(params, batch):
        ps = leaves(trainable(params))
        loss, grads = _accumulate_grads(api, ps, params, batch, n_micro, dmesh)
        if dmesh is not None:
            # a gradient on its param's placements (reduce-scattered from a
            # partial sum where DTensor left one)
            grads = [g if g.placements == p.placements
                     else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, ps)]
        return loss, grads

    def step(params, opt_state, batch):
        with (nullcontext() if dmesh is None
              else mesh_context(dmesh, sp=parallel.seq_sharding)):
            if dmesh is not None:
                batch = shard_batch(batch, dmesh)
            loss, grads = grads_of(params, batch)
            with torch.no_grad():
                gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
                lr = adamw_update(grads, opt_state, params, tcfg)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step


def gspmd_init_state(api: ModelApi, mesh, parallel: ParallelConfig,
                     seed: int = 0, device=None, params=None):
    """Params from ``seed`` on ``device`` (``cuda`` unless given), or the
    given whole ``params``, and a fresh optimizer state. On a sharded mesh
    each rank makes the whole params from the seed and keeps its blocks as
    DTensors on ``param_placements``; m and v are zero DTensors on
    ``opt_placements``."""
    if params is None:
        params = api.init(seed, device)
    if not sharded(mesh):
        params = trainable(params)
        return params, adamw_init(params)
    params = trainable(distribute(params, mesh,
                                  param_placements(params, mesh, parallel)))
    return params, adamw_init(params, opt_placements(params, mesh, parallel))


def make_train_step(api: ModelApi, mesh, parallel: ParallelConfig,
                    tcfg: TrainConfig):
    """The reference's dispatcher: ``make_gspmd_train_step`` for
    ``dp_sync="gspmd"``, else ``make_themis_train_step``."""
    if parallel.dp_sync == "gspmd":
        return make_gspmd_train_step(api, mesh, parallel, tcfg)
    return make_themis_train_step(api, mesh, parallel, tcfg)


# --------------------------------------------------------------------------
# Manual Themis ZeRO-2 mode (pure DP over every mesh axis)
# --------------------------------------------------------------------------
def _local_shard(y: torch.Tensor, order: tuple[str, ...], mesh) -> torch.Tensor:
    """This rank's nested block of a replicated chunk (the block that the
    chunk's reduce-scatter in ``order`` leaves on this rank)."""
    for ax in order:
        a = mesh.axis_size(ax)
        i = mesh.local_rank(ax)
        ln = y.shape[0] // a
        y = y[i * ln:(i + 1) * ln]
    return y


def make_themis_train_step(api: ModelApi, mesh, parallel: ParallelConfig,
                           tcfg: TrainConfig):
    """ZeRO-2 DP step with Themis-scheduled chunked RS/AG.

    All mesh axes act as DP dims (a D-dim hierarchical collective, the
    paper's exact setting). Returns ``(step, init_state, orders)``;
    ``step(params, opt_state, local_batch)`` updates both in place; the
    optimizer state's m/v/master live in the reduce-scattered layout
    (C, per_chunk / world) and ``count`` on the host. Unlike the
    reference's, which ignores ``tcfg.microbatch``, it accumulates
    gradients over ``tcfg.microbatch`` slices of the local rows, as the
    GSPMD step does, before the one reduce-scatter."""
    axes = tuple(a for a in ("model", "data", "pod") if mesh.axis_size(a) > 1)
    axis_sizes = {a: mesh.axis_size(a) for a in axes}
    world = math.prod(axis_sizes.values())

    n_params = count_params(api.param_spec())
    n_chunks = parallel.chunks_per_collective
    policy = "themis" if parallel.dp_sync == "themis" else "baseline"
    orders = [tuple(o) for o in
              themis_axis_orders(axis_sizes, n_params * 4, n_chunks, policy)]

    per_chunk = chunk_len(n_params, n_chunks, world)
    use_int8 = parallel.compression == "int8"
    reduce_scatter = (chunked_reduce_scatter_int8 if use_int8
                      else chunked_reduce_scatter)

    n_micro = max(tcfg.microbatch, 1)

    def step(params, opt, batch):
        ps = leaves(trainable(params))
        loss, grads = _accumulate_grads(api, ps, params, batch, n_micro, None)
        with torch.no_grad():
            buf = torch.zeros(n_chunks * per_chunk, dtype=torch.float32,
                              device=ps[0].device)
            flat = buf[:n_params]
            torch.cat([g.reshape(-1).float() for g in grads], out=flat)
            del grads
            if use_int8:
                flat += opt["err"]
                q, s = _quantize(flat)
                opt["err"] = flat - q.float() * s
            chunks = buf.view(n_chunks, per_chunk)
            if world > 1:
                g_shard = torch.stack(reduce_scatter(chunks, orders, mesh))
                g_shard /= world                          # (C, shard_len)
            else:
                g_shard = chunks
            del buf, flat, chunks

            # global-norm clip across the scattered shards
            sq = g_shard.square().sum()
            for a in axes:
                dist.all_reduce(sq, group=mesh.group(a))
            gnorm = torch.sqrt(sq)
            g_shard *= clip_scale(gnorm, tcfg.grad_clip)

            # ZeRO-2 AdamW on the fp32 master shards
            count = opt["count"] + 1
            lr = lr_schedule(tcfg, count)
            c1, c2 = bias_corrections(tcfg, count)
            with torch.profiler.record_function("repro_torch.adamw"):
                # chunk by chunk, so the update's temporaries are one
                # chunk's shard: two of a whole shard were 23 GiB beside
                # qwen2.5-3b's 57.5 GiB of state on one rank
                for i in range(n_chunks):
                    adamw_step_(opt["master"][i], g_shard[i], opt["m"][i],
                                opt["v"][i], lr=lr, c1=c1, c2=c2, cfg=tcfg)
            opt["count"] = count
            del g_shard

            # all-gather the updated params (the params' dtype on the wire)
            p_dtype = ps[0].dtype
            gathered = chunked_all_gather(
                [opt["master"][i].to(p_dtype) for i in range(n_chunks)],
                orders, mesh).reshape(-1)
            off = 0
            for p in ps:
                p.copy_(gathered[off:off + p.numel()].view_as(p))
                off += p.numel()
            del gathered
            loss = loss.detach()
            for a in axes:
                dist.all_reduce(loss, group=mesh.group(a))
                loss /= axis_sizes[a]
        return params, opt, {"loss": loss, "gnorm": gnorm, "lr": lr}

    def init_state(seed: int = 0, device=None, params=None):
        """Params (from ``seed`` on ``device``, or the given ``params``) and
        this rank's optimizer state: its master shards cut from the params
        as the reduce-scatter will scatter the gradients."""
        if params is None:
            params = api.init(seed, device)
        with torch.no_grad():
            buf = torch.zeros(n_chunks * per_chunk, dtype=torch.float32,
                              device=leaves(params)[0].device)
            torch.cat([p.reshape(-1).float() for p in leaves(params)],
                      out=buf[:n_params])
            chunks = buf.view(n_chunks, per_chunk)
            master = torch.stack([_local_shard(chunks[i], orders[i], mesh)
                                  for i in range(n_chunks)])
            del buf, chunks
        err = (torch.zeros(n_params, dtype=torch.float32, device=master.device)
               if use_int8 else torch.zeros((), dtype=torch.float32,
                                            device=master.device))
        opt = {"master": master, "m": torch.zeros_like(master),
               "v": torch.zeros_like(master), "count": 0, "err": err}
        return trainable(params), opt

    return step, init_state, orders

