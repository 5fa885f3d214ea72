"""Train-step builders (port of ``repro/train/step.py``).

Two data-parallel gradient-sync modes:

* ``gspmd``: the production default of the reference, one GSPMD program
  with every collective inserted by XLA. The port runs it on a 1x1 mesh
  only, as the single-device step (with microbatch accumulation); a larger
  mesh raises until the sharded runtime is ported (ROADMAP M12).
* ``themis`` / ``hier_baseline``: the paper's technique. Every mesh axis is
  a data-parallel axis (pure-DP ZeRO-2). Gradients are flattened, chunked
  and reduce-scattered over ``torch.distributed`` with per-chunk axis orders
  from the Themis scheduler (``comms/schedule_bridge.py``, Algorithm 1 run
  once when the step is built); the sharded AdamW update runs on each
  rank's scattered shard against fp32 master shards; the updated
  parameters are all-gathered chunk by chunk in reverse order, in the
  params' dtype. ``hier_baseline`` pins the static dim1->dimD order for
  every chunk (paper Sec. 2.3). Optional int8-on-the-wire reduce-scatter
  with per-rank error feedback.

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

import torch
import torch.distributed as dist

from repro_torch.comms.hierarchical import (
    _quantize,
    chunk_len,
    chunked_all_gather,
    chunked_reduce_scatter,
    chunked_reduce_scatter_int8,
)
from repro_torch.comms.schedule_bridge import themis_axis_orders
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models.registry import ModelApi, count_params, leaves
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
# GSPMD mode (one device)
# --------------------------------------------------------------------------
def make_gspmd_train_step(api: ModelApi, mesh, parallel: ParallelConfig,
                          tcfg: TrainConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates params and opt_state in place.

    ``tcfg.microbatch`` > 1 accumulates gradients over that many slices of
    the batch's rows, so live activations are O(batch / microbatch)."""
    if math.prod(parallel.mesh_shape) != 1 or (mesh is not None and mesh.size != 1):
        raise NotImplementedError(
            f"mesh {parallel.mesh_shape}: the multi-rank GSPMD step is not "
            "ported yet (ROADMAP M12); use dp_sync='themis' on a mesh")
    n_micro = max(tcfg.microbatch, 1)

    def grads_of(params, batch):
        ps = leaves(trainable(params))
        if n_micro == 1:
            loss = api.loss_fn(params, batch)
            return loss.detach(), list(torch.autograd.grad(loss, ps))
        micro = {k: v.chunk(n_micro) for k, v in batch.items()}
        loss_sum, g_sum = None, None
        for i in range(n_micro):
            loss_i = api.loss_fn(params, {k: v[i] for k, v in micro.items()})
            g_i = torch.autograd.grad(loss_i, ps)
            loss_i = loss_i.detach()
            if g_sum is None:
                loss_sum, g_sum = loss_i, list(g_i)
            else:
                loss_sum = loss_sum + loss_i
                for a, b in zip(g_sum, g_i):
                    a.add_(b)
        inv = 1.0 / n_micro
        for g in g_sum:
            g.mul_(inv)
        return loss_sum * inv, g_sum

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            lr = adamw_update(grads, opt_state, params, tcfg)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step


def gspmd_init_state(api: ModelApi, mesh, parallel: ParallelConfig,
                     seed: int = 0, device=None):
    """Params from ``seed`` on ``device`` (``cuda`` unless given) and a
    fresh optimizer state."""
    params = trainable(api.init(seed, device))
    return params, adamw_init(params)


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
    (C, per_chunk / world) and ``count`` on the host."""
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

    def step(params, opt, batch):
        ps = leaves(trainable(params))
        loss = api.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps)
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
                adamw_step_(opt["master"], g_shard, opt["m"], opt["v"], lr=lr,
                            c1=c1, c2=c2, cfg=tcfg)
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

