"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Sort-based, capacity-bounded token dispatch (MaxText/GShard "dropping"
style), per batch row: each row's (token, slot) assignments are sorted by
expert id (stable), ranked within their expert, and the first ``C`` of each
expert are scattered into a (B, E, C, D) buffer; the rest are dropped. The
reference's sharding constraints (the expert-parallel all-to-all) have no
counterpart on one device.

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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_mlp, dense_init, init_mlp


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


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = expert_capacity(cfg, s)
    dt = x.dtype
    weights, _, order, keep, dest = route(p, x, cfg)
    token_of = order // k                                         # source token

    # scatter into the (B, E*C + 1, D) buffer; row E*C takes the drops
    src = torch.gather(x, 1, token_of[..., None].expand(b, s * k, d))
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e * c + 1, d))
    buf = buf.index_put((rows, dest), src)
    buf = buf[:, :e * c].reshape(b, e, c, d)

    up = torch.einsum("becd,edf->becf", buf, p["wi"].to(dt))
    gate = torch.einsum("becd,edf->becf", buf, p["wg"].to(dt))
    act = F.silu(gate) * up
    out = torch.einsum("becf,efd->becd", act, p["wo"].to(dt))

    # gather back (the spare row reads as zeros), weight, combine per token
    out = torch.cat([out.reshape(b, e * c, d), x.new_zeros((b, 1, d))], dim=1)
    picked = out[rows, dest]                                      # (B,A,D)
    w_sorted = torch.gather(weights.reshape(b, s * k), 1, order)
    picked = picked * (w_sorted * keep)[..., None]
    a = torch.arange(s * k, device=x.device).expand(b, s * k)
    inv = torch.empty_like(order).scatter_(1, order, a)           # the inverse of order
    picked = torch.gather(picked, 1, inv[..., None].expand(b, s * k, d))
    y = picked.reshape(b, s, k, d).sum(2)

    if cfg.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, gated=True)
    return y
