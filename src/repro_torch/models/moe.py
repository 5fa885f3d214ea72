"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Sort-based, capacity-bounded token dispatch (MaxText/GShard "dropping"
style), per batch row: each row's (token, slot) assignments are sorted by
expert id (stable), ranked within their expert, and the first ``C`` of each
expert are scattered into a (B, E, C, D) buffer; the rest are dropped.

On a mesh (``x`` a DTensor, ``apply_moe_sharded``) the experts are split
over "model", as the reference's constraints put the buffer on ("dp",
"tp"): the routing and the dispatch plan run on each rank's local rows as
plain tensors (rows split over "dp" only, so every tp rank computes the same
plan), each rank slices its E/tp experts out of the buffer (no collective)
and runs the three products on them, with an FSDP split of d_model gathered
first, and the combine all-gathers the experts' outputs over "model" (the
reference's constraint back to ("dp", None)) before the per-row combine.
x's local rows enter twice with different gradient placements: through the
router its gradient is whole on every tp rank (Replicate), through the
dispatch it is partial over "model" (each rank holds its experts' share).

Two steps differ in form from the reference, not in value:

- The reference scatters with ``mode="drop"`` and gathers with
  ``mode="fill"``. Here the buffer has one spare row, index ``E*C``, that
  takes every dropped assignment and is sliced off; the gather reads it as
  zeros.
- The reference combines with a scatter-add over the sorted assignments
  (``y.at[token_of].add``), which on the card would add with atomics in an
  order that changes from run to run. Here the sorted assignments go back
  to (token, slot) order through the inverse permutation, and the k slots
  of each token are summed: a deterministic sum of the same terms.

Supports shared experts (DeepSeekMoE): ``num_shared_experts`` always-on
experts folded into one dense gated MLP of width shared*moe_d_ff.

The three expert products are plain batched matmuls over every expert's
full weights, as in the reference, whatever the number of tokens: a decode
step (S = 1, capacity k) reads all E experts' weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    _block,
    _replicated_local,
    apply_mlp,
    constrain,
    dense_init,
    init_mlp,
)


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
             lead: tuple = ()):
    """``lead``: leading (stacked-layer) dims of every weight."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    n = len(lead)
    p = {
        "router": dense_init(gen, (*lead, d, e), n, dtype, device),
        "wi": dense_init(gen, (*lead, e, d, f), n + 1, dtype, device),
        "wg": dense_init(gen, (*lead, e, d, f), n + 1, dtype, device),
        "wo": dense_init(gen, (*lead, e, f, d), n + 1, dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * cfg.moe_d_ff,
                               True, dtype, device, lead)
    return p


def expert_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    cap = int(tokens_per_row * cfg.experts_per_token * cfg.capacity_factor
              / cfg.num_experts)
    return max(cap, cfg.experts_per_token)


def route(p, x, cfg: ModelConfig):
    """Routing and dispatch plan of x (B,S,D): the top-k weights (B,S,k) in
    x's dtype and ids (B,S,k), and per row the sort ``order`` (B,A), the
    ``keep`` mask and the buffer row ``dest`` (E*C for a dropped
    assignment) of each sorted assignment, A = S*k."""
    c = expert_capacity(cfg, x.shape[1])
    logits = (x @ p["router"].to(x.dtype)).float()               # (B,S,E)
    gates = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(gates, cfg.experts_per_token, dim=-1)  # (B,S,k)
    weights = (weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
               ).to(x.dtype)
    return (weights, ids, *dispatch_plan(ids, cfg, c))


def dispatch_plan(ids, cfg: ModelConfig, c: int):
    """Per row of the top-k ``ids`` (B,S,k), at capacity ``c``: the sort
    ``order`` (B,A), ``keep`` and ``dest`` of each sorted assignment."""
    b, s, k = ids.shape
    e = cfg.num_experts
    flat_ids = ids.reshape(b, s * k)                              # (B,A)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    # position within expert = index - first index of that expert id
    experts = torch.arange(e, device=ids.device).expand(b, e).contiguous()
    seg_start = torch.searchsorted(sorted_ids, experts, side="left")  # (B,E)
    pos_in_e = (torch.arange(s * k, device=ids.device)[None, :]
                - torch.gather(seg_start, 1, sorted_ids))
    keep = pos_in_e < c
    dest = torch.where(keep, sorted_ids * c + pos_in_e,
                       torch.full_like(pos_in_e, e * c))
    return order, keep, dest


def _dispatch(x, dest, order, k: int, n_rows: int):
    """The (B, n_rows, D) buffer of x's sorted assignments at rows ``dest``
    (row n_rows - 1 is the spare one that takes the drops). Each token is
    copied to its k slots first and the copies are permuted by ``order``
    (assignment a comes from token a // k), so the backward sums each
    token's k gradients as a reduction and scatters a permutation, with
    no atomic adds of duplicates: the same bits from run to run on the
    card."""
    b, s, d = x.shape
    slots = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d)
    src = torch.gather(slots, 1, order[..., None].expand(b, s * k, d))
    rows = torch.arange(b, device=x.device)[:, None]
    return x.new_zeros((b, n_rows, d)).index_put((rows, dest), src)


def _experts(buf, wi, wg, wo):
    """The experts' gated MLP of buf (B, E, C, D) with weights (E, D, F) /
    (E, F, D)."""
    dt = buf.dtype
    up = torch.einsum("becd,edf->becf", buf, wi.to(dt))
    gate = torch.einsum("becd,edf->becf", buf, wg.to(dt))
    act = F.silu(gate) * up
    return torch.einsum("becf,efd->becd", act, wo.to(dt))


def _combine(out, weights, order, keep, dest, k: int):
    """The experts' outputs (B, E*C, D) back to tokens: each sorted
    assignment's row (the spare row reads as zeros), weighted, returned to
    (token, slot) order through the inverse permutation and summed over
    the k slots."""
    b, _, d = out.shape
    a_n = order.shape[1]
    rows = torch.arange(b, device=out.device)[:, None]
    out = torch.cat([out, out.new_zeros((b, 1, d))], dim=1)
    picked = out[rows, dest]                                      # (B,A,D)
    w_sorted = torch.gather(weights.reshape(b, a_n), 1, order)
    picked = picked * (w_sorted * keep)[..., None]
    a = torch.arange(a_n, device=out.device).expand(b, a_n)
    inv = torch.empty_like(order).scatter_(1, order, a)           # the inverse of order
    picked = torch.gather(picked, 1, inv[..., None].expand(b, a_n, d))
    return picked.reshape(b, a_n // k, k, d).sum(2)


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D)."""
    if isinstance(x, DTensor):
        return apply_moe_sharded(p, x, cfg)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = expert_capacity(cfg, s)
    weights, _, order, keep, dest = route(p, x, cfg)
    # scatter into the (B, E*C + 1, D) buffer; row E*C takes the drops
    buf = _dispatch(x, dest, order, k, e * c + 1)[:, :e * c].reshape(b, e, c, d)
    out = _experts(buf, p["wi"], p["wg"], p["wo"])
    y = _combine(out.reshape(b, e * c, d), weights, order, keep, dest, k)
    if cfg.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, gated=True)
    return y


def _local_experts(w, row_pls, expert_dims):
    """This rank's experts of a stacked expert weight (E, ., .): its split
    over "model" (``expert_dims``) kept, any other split (FSDP) gathered;
    the gradient partial over the mesh dims that split the rows."""
    mesh = w.device_mesh
    pls = tuple(Shard(0) if j in expert_dims else Replicate()
                for j in range(mesh.ndim))
    grad = tuple(Shard(0) if j in expert_dims else
                 Partial() if row_pls[j].is_shard() else Replicate()
                 for j in range(mesh.ndim))
    return w.redistribute(mesh, pls).to_local(grad_placements=grad)


def apply_moe_sharded(p, x, cfg: ModelConfig):
    """``apply_moe`` of a DTensor x with experts split over "model" (the
    module docstring); the plan and the combine run on local rows as plain
    tensors, so their sort, search and scatter never meet DTensor."""
    mesh = x.device_mesh
    e, k = cfg.num_experts, cfg.experts_per_token
    # the rows where they are (on "dp"), every other dim whole
    x = x.redistribute(mesh, tuple(pl if pl.is_shard() and pl.dim == 0
                                   else Replicate() for pl in x.placements))
    row_pls = tuple(x.placements)
    expert_dims = [j for j, pl in enumerate(p["wi"].placements)
                   if pl.is_shard() and pl.dim == 0]
    # x's rows: through the router whole on every rank, through the
    # dispatch partial over the expert split
    x_router = x.to_local(grad_placements=row_pls)
    x_disp = x.to_local(grad_placements=tuple(
        Partial() if j in expert_dims else pl for j, pl in enumerate(row_pls)))
    b, s, d = x_router.shape
    c = expert_capacity(cfg, s)
    weights, _, order, keep, dest = route(
        {"router": _replicated_local(p["router"], row_pls)}, x_router, cfg)
    buf = _dispatch(x_disp, dest, order, k, e * c + 1)[:, :e * c]
    e_loc = e // math.prod(mesh.size(j) for j in expert_dims)
    r = _block(mesh, expert_dims)
    buf = buf.reshape(b, e, c, d)[:, r * e_loc:(r + 1) * e_loc]
    out = _experts(buf, *(_local_experts(p[n], row_pls, expert_dims)
                          for n in ("wi", "wg", "wo")))
    # the combine: every expert's outputs on every rank of the expert split
    out = DTensor.from_local(out, mesh, tuple(
        Shard(1) if j in expert_dims else pl for j, pl in enumerate(row_pls)),
        run_check=False).redistribute(mesh, row_pls).to_local()
    y = _combine(out.reshape(b, e * c, d), weights, order, keep, dest, k)
    y = DTensor.from_local(y, mesh, row_pls, run_check=False)
    if cfg.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, gated=True)
    return constrain(y, "dp", None, None)
