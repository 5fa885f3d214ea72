"""RecurrentGemma / Griffin: RG-LRU recurrent blocks + local attention.

Port of ``repro/models/recurrent.py``, serving and training. Block pattern
(rec, rec, attn) repeats; the layers of each pattern slot are stacked along
a leading axis under ``"periods"``, and the layers left over (26 = 8x3 + 2)
are a list under ``"tail"``, as in the reference.

RG-LRU (arXiv:2402.19427):
    i_t = sigmoid(W_x x_t),  r_t = sigmoid(W_a x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The scan runs through ``ops.rglru_scan``: kernel K3 and its backward
kernel on a CUDA tensor, the sequential plain versions on a CPU tensor
(the reference runs ``associative_scan``: the same fp32 sums in another
order). Decode carries h with one multiply-add per step. Local attention
keeps a ring buffer of ``local_window`` positions
(``transformer.apply_attn`` with ``window``).

Training (``loss_fn``): with ``cfg.remat`` and autograd recording, each
period runs under ``torch.utils.checkpoint``, as the reference wraps
``_apply_period`` in ``jax.checkpoint``; the tail blocks are not
checkpointed. The periods' weights come from ``torch.unbind`` of the
stacked tensors, so each stacked gradient comes from one backward op.

Unlike the reference, the caches are updated in place: ``prefill``
allocates them and ``decode_step`` writes them and returns the same dict.

Under a ``mesh_context`` with a ``DeviceMesh`` the reference's constraint
points apply (the recurrence's channels on "tp", the block outputs and the
embeddings on "dp", the logits' vocab on "tp"); the scan runs on local
channels (K3 on a CUDA shard), and the states are DTensors on
``cache_pspec``'s placements, written in their local shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.models.common import (
    _block,
    _placements_for,
    _replicated_local,
    apply_mlp,
    constrain,
    cross_entropy,
    dense_init,
    embed_init,
    init_mlp,
    remat_policy,
    rms_norm,
    rows_whole,
)

RGLRU_C = 8.0


# -- RG-LRU ------------------------------------------------------------------
def init_rec(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
             lead: tuple = ()):
    d, r, cw = cfg.d_model, cfg.d_rnn, cfg.conv_width
    n = len(lead)
    lam = torch.linspace(0.5, 4.0, r, device=device).to(dtype)
    return {
        "linear_y": dense_init(gen, (*lead, d, r), n, dtype, device),
        "linear_x": dense_init(gen, (*lead, d, r), n, dtype, device),
        "conv_w": dense_init(gen, (*lead, cw, r), n, dtype, device),
        "w_input_gate": dense_init(gen, (*lead, r, r), n, dtype, device),
        "w_a_gate": dense_init(gen, (*lead, r, r), n, dtype, device),
        "lam": lam.expand(*lead, r).clone(),          # Lambda init spread
        "linear_out": dense_init(gen, (*lead, r, d), n, dtype, device),
    }


def _rglru_coeffs(p, x):
    """x: (B,S,R) -> (a, b) fp32 of the linear recurrence h = a*h + b."""
    dt = x.dtype
    i = torch.sigmoid(x @ p["w_input_gate"].to(dt))
    r = torch.sigmoid(x @ p["w_a_gate"].to(dt))
    log_a = (-RGLRU_C * F.softplus(p["lam"].float())) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i.float() * x.float())
    return a, b


def rglru_scan(p, x, h0=None):
    """Linear recurrence over time.  x: (B,S,R); h0: (B,R) fp32.
    Returns (h in x's dtype, the last h in fp32)."""
    a, b = _rglru_coeffs(p, x)
    h = _scan(a, b, h0)
    return h.to(x.dtype), h[:, -1]


def _scan(a, b, h0):
    """``ops.rglru_scan``; on DTensors, on local shards: batch on "dp",
    channels on "tp", time whole."""
    if not isinstance(a, DTensor):
        return ops.rglru_scan(a, b, h0)
    mesh = a.device_mesh
    pls = _placements_for(a, "dp", None, "tp")
    a, b = a.redistribute(mesh, pls), b.redistribute(mesh, pls)
    if h0 is not None:
        h0 = h0.redistribute(mesh, _placements_for(h0, "dp", "tp")).to_local()
    h = ops.rglru_scan(a.to_local(), b.to_local(), h0)
    return DTensor.from_local(h, mesh, pls, run_check=False)


def rglru_step(p, x, h_prev):
    """Single decode step.  x: (B,1,R); h_prev: (B,R) fp32."""
    a, b = _rglru_coeffs(p, x)
    h = _step(a, b, h_prev)
    return h.to(x.dtype)[:, None], h


def _step(a, b, h_prev):
    """One step of the recurrence; on DTensors, on local channels."""
    if not isinstance(a, DTensor):
        return a[:, 0] * h_prev + b[:, 0]
    mesh = a.device_mesh
    pls = _placements_for(a, "dp", None, "tp")
    h_pls = _placements_for(h_prev, "dp", "tp")
    a, b = a.redistribute(mesh, pls).to_local(), b.redistribute(mesh, pls).to_local()
    h = a[:, 0] * h_prev.redistribute(mesh, h_pls).to_local() + b[:, 0]
    return DTensor.from_local(h, mesh, h_pls, run_check=False)


def causal_conv1d(w, x):
    """Per-channel causal conv.  w: (CW,R), x: (B,S,R)."""
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    return sum(pad[:, k:k + x.shape[1]] * w[k].to(x.dtype) for k in range(cw))


def conv1d_step(w, x, conv_state):
    """x: (B,1,R); conv_state: (B,CW-1,R) of previous inputs."""
    hist = torch.cat([conv_state.to(x.dtype), x], dim=1)     # (B,CW,R)
    out = torch.einsum("bkr,kr->br", hist, w.to(x.dtype))[:, None]
    return out, hist[:, 1:]


def _conv(w, xr, conv_state, cw: int):
    """The causal conv of xr (B,S,R), after the carried history
    ``conv_state`` (B,CW-1,R) where there is one: returns (xc, the new
    history, None without a state). On DTensors it runs on local channels:
    xr and the history with batch on "dp" and channels on "tp", and this
    rank's channels of w."""
    if isinstance(xr, DTensor):
        return _channels_local(_conv, w, xr, conv_state, cw)
    if conv_state is None:
        return causal_conv1d(w, xr), None
    if xr.shape[1] == 1:
        return conv1d_step(w, xr, conv_state)
    hist = torch.cat([conv_state.to(xr.dtype), xr], dim=1)
    return causal_conv1d(w, hist)[:, cw - 1:], hist[:, -(cw - 1):]


def _channels_local(fn, w, x, state, *args):
    """``fn(w, x, state, *args)`` on local shards of DTensors x and state
    (batch on "dp", channels on "tp") and this rank's channels of the
    replicated w (its gradient partial over the mesh dims that split x);
    the outputs take x's placements."""
    mesh = x.device_mesh
    pls = _placements_for(x, "dp", None, "tp")
    xl = x.redistribute(mesh, pls).to_local()
    sl = None if state is None else state.redistribute(mesh, pls).to_local()
    blk = _block(mesh, [j for j, p in enumerate(pls)
                        if p.is_shard() and p.dim == 2])
    n = xl.shape[-1]
    wl = _replicated_local(w, pls)[..., blk * n:(blk + 1) * n]
    return tuple(None if t is None else
                 DTensor.from_local(t, mesh, pls, run_check=False)
                 for t in fn(wl, xl, sl, *args))


def apply_rec(p, x, cfg: ModelConfig, *, state=None):
    """Recurrent module.  x: (B,S,D) -> (out (B,S,D), state). ``state``
    (h fp32, conv bf16) is written in place: one step for S == 1, the
    prompt scanned from the carried state otherwise."""
    dt = x.dtype
    s = x.shape[1]
    x = rows_whole(x)
    y = F.gelu(x @ p["linear_y"].to(dt), approximate="tanh")
    xr = constrain(x @ p["linear_x"].to(dt), "dp", None, "tp")
    xc, hist = _conv(p["conv_w"], xr, None if state is None else state["conv"],
                     cfg.conv_width)
    if state is None:
        h, _ = rglru_scan(p, xc)
    else:
        if s == 1:
            h, h_last = rglru_step(p, xc, state["h"])
        else:
            h, h_last = rglru_scan(p, xc, h0=state["h"])
        _store(state["h"], h_last)
        _store(state["conv"], hist)
    return constrain((h * y) @ p["linear_out"].to(dt), "dp", None, None), state


def _store(dst, src):
    """``dst.copy_(src)``; a DTensor state takes ``src`` brought to its
    placements, written into its local shard."""
    if isinstance(dst, DTensor):
        src = src.to(dst.dtype).redistribute(dst.device_mesh, dst.placements)
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


def init_rec_state(cfg: ModelConfig, batch: int, device=None, lead: tuple = ()):
    """h in fp32; the conv history in bf16 whatever ``cfg.dtype`` is, as in
    the reference."""
    return {
        "h": torch.zeros((*lead, batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=torch.bfloat16, device=device),
    }


# -- blocks -------------------------------------------------------------------
def init_griffin_block(gen, cfg: ModelConfig, kind: str, dtype=torch.float32,
                       device=None, lead: tuple = ()):
    p = {"ln1": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
         "ln2": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)}
    if kind == "rec":
        p["rec"] = init_rec(gen, cfg, dtype, device, lead)
    else:
        p["attn"] = tr.init_attn(gen, cfg, dtype, device, lead)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, True, dtype, device, lead)
    return p


def apply_griffin_block(p, x, cfg: ModelConfig, kind: str, *, pos0: int,
                        cache=None):
    h = rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    if kind == "rec":
        out, _ = apply_rec(p["rec"], h, cfg, state=cache)
    else:
        out = tr.apply_attn(p["attn"], h, cfg, pos0=pos0, cache=cache,
                            window=cfg.local_window)
    x = x + out
    h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, gated=True)


# -- model --------------------------------------------------------------------
def _layer_kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _n_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.block_pattern)


def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            device=None):
    """The reference's init distributions, drawn from ``gen`` on ``device``;
    each pattern slot's layers are drawn directly into stacked tensors."""
    n = _n_periods(cfg)
    periods = {f"s{j}_{kind}": init_griffin_block(gen, cfg, kind, dtype,
                                                  device, lead=(n,))
               for j, kind in enumerate(cfg.block_pattern)} if n else {}
    tail = [init_griffin_block(gen, cfg, kind, dtype, device)
            for kind in _layer_kinds(cfg)[n * len(cfg.block_pattern):]]
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "periods": periods,
        "tail": tail,
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


def _apply_period(slot_params, x, cfg: ModelConfig, *, pos0: int):
    for j, kind in enumerate(cfg.block_pattern):
        x = apply_griffin_block(slot_params[f"s{j}_{kind}"], x, cfg, kind,
                                pos0=pos0)
    return x


def _run_layers(params, x, cfg: ModelConfig, *, pos0: int, caches=None):
    """Without caches (training, ``forward``) the periods take views from
    ``torch.unbind``; with ``cfg.remat`` and autograd recording each period
    runs under ``torch.utils.checkpoint``: it saves its input (and under
    remat "dots" its projections' outputs), and the rest of its forward
    (K1, K2 and K3 included) runs again in the backward."""
    if caches is None:
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = remat_policy(cfg) or noop_context_fn
        periods = tr._unbind(params["periods"]) if params["periods"] else []
        for p_i in periods:
            if remat:
                x = checkpoint(_apply_period, p_i, x, cfg, pos0=pos0,
                               use_reentrant=False, context_fn=context_fn)
            else:
                x = _apply_period(p_i, x, cfg, pos0=pos0)
    else:
        for i in range(_n_periods(cfg)):
            for j, kind in enumerate(cfg.block_pattern):
                name = f"s{j}_{kind}"
                x = apply_griffin_block(
                    tr._layer(params["periods"][name], i), x, cfg, kind,
                    pos0=pos0, cache=tr._layer(caches["periods"][name], i))
    tail_kinds = _layer_kinds(cfg)[cfg.num_layers - len(params["tail"]):]
    for j, (p_l, kind) in enumerate(zip(params["tail"], tail_kinds)):
        c = None if caches is None else caches["tail"][j]
        x = apply_griffin_block(p_l, x, cfg, kind, pos0=pos0, cache=c)
    return x


def forward(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> logits (B,S,V) (tied embeddings)."""
    dt = tr.torch_dtype(cfg.dtype)
    x = _run_layers(params, tr._embed(params, tokens, cfg, dt, None), cfg,
                    pos0=0)
    return tr._logits(params, x, cfg, None)


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"} of
    (B,S), optional "mask")."""
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_caches(cfg: ModelConfig, batch: int, device=None):
    """Decode caches: ring-buffer KV (bf16, ``pos`` -1 where empty) for attn
    layers, (h, conv) for rec layers; stacked per pattern slot, a list for
    the tail."""
    w, hd = cfg.local_window, cfg.resolved_head_dim

    def one(kind, lead=()):
        if kind == "rec":
            return init_rec_state(cfg, batch, device, lead)
        kv = (*lead, batch, w, cfg.num_kv_heads, hd)
        return {"k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                "pos": torch.full((*lead, batch, w), -1, dtype=torch.int32,
                                  device=device)}

    n = _n_periods(cfg)
    periods = {f"s{j}_{kind}": one(kind, (n,))
               for j, kind in enumerate(cfg.block_pattern)} if n else {}
    tail = [one(kind) for kind in _layer_kinds(cfg)[n * len(cfg.block_pattern):]]
    return {"periods": periods, "tail": tail}


def prefill(params, tokens, cfg: ModelConfig):
    """Run the prompt with new caches: recurrent states scan through it, the
    window caches fill with its last ``window`` positions. Returns
    (last_logits (B,1,V), caches); the head runs on the last position only."""
    dt = tr.torch_dtype(cfg.dtype)
    x = tr._embed(params, tokens, cfg, dt, None)
    b = x.shape[0]
    caches = tr.place_cache(lambda dev: init_caches(cfg, b, device=dev), b,
                            stacked={"periods": True, "tail": False},
                            device=x.device)
    x = _run_layers(params, x, cfg, pos0=0, caches=caches)
    return tr._logits(params, x[:, -1:].contiguous(), cfg, None), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step. token (B,) int, pos int; updates ``caches`` in place."""
    dt = tr.torch_dtype(cfg.dtype)
    x = tr._embed(params, token[:, None], cfg, dt, None)
    x = _run_layers(params, x, cfg, pos0=int(pos), caches=caches)
    return tr._logits(params, x, cfg, None), caches
