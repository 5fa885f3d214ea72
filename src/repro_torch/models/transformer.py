"""Decoder-only transformer LM, dense family (port of ``repro/models/transformer.py``).

Params are nested dicts of tensors in the reference's layout: the layers'
weights are stacked along a leading axis under ``"blocks"``, and a loop over
that axis takes the place of ``jax.lax.scan``. The loop takes each layer's
weights as views from ``torch.unbind``, whose backward stacks the layers'
gradients once (a view from indexing would add a zero-filled gradient of
the whole stack per layer). Training path: ``loss_fn``, with per-layer
activation checkpointing (``cfg.remat``, ``models/common.remat_policy``).
Serving path: prefill + single-token decode with a static KV cache of
``max_len`` positions; training never passes a cache.

Unlike the reference, the cache is updated in place (the reference returns a
new one from a pure function): ``prefill`` allocates it and ``decode_step``
writes one position of it and returns the same dict. Writing past
``max_len`` raises, where the reference's ``dynamic_update_slice`` would
clamp the position and overwrite the last slot.

``apply_attn`` also serves the hybrid family's local attention
(``window > 0``, ``models/recurrent.py``) with its ring-buffer cache. The
dense family is the only one built here: MoE and VLM patches come with
ROADMAP item M11.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    NEG_INF,
    _repeat_kv,
    apply_mlp,
    apply_rope,
    attention,
    cross_entropy,
    dense_init,
    embed_init,
    init_mlp,
    remat_policy,
    rms_norm,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_family(cfg: ModelConfig):
    """Raise for a model family the port does not run yet."""
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP M11)")


# -- per-layer ---------------------------------------------------------------
def init_attn(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
              lead: tuple = ()):
    hd = cfg.resolved_head_dim
    n = len(lead)
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (*lead, d, h * hd), n, dtype, device),
        "wk": dense_init(gen, (*lead, d, kv * hd), n, dtype, device),
        "wv": dense_init(gen, (*lead, d, kv * hd), n, dtype, device),
        "wo": dense_init(gen, (*lead, h * hd, d), n, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((*lead, kv * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((*lead, kv * hd), dtype=dtype, device=device)
    return p


def _impl(cfg: ModelConfig) -> str:
    return "xla_flash" if cfg.attention_impl == "reference" else cfg.attention_impl


def apply_attn(p, x, cfg: ModelConfig, *, pos0: int, cache: dict | None = None,
               window: int = 0):
    """Returns the attention output. x: (B,S,D) at positions pos0 .. pos0+S-1.

    ``cache`` holds this layer's tensors, written in place. Dense: k/v of
    (B, max_len, ...) are written at ``pos0`` and attention reads the whole
    cached sequence, rounded to the cache's dtype, as the reference does.
    ``window > 0``: a ring buffer of ``window`` slots with their absolute
    positions (``pos``, -1 where empty); see ``_apply_window_cache``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype

    def proj(w, bias, nh):
        y = x @ p[w].to(dt)
        if bias in p:
            y = y + p[bias].to(dt)
        return y.reshape(b, s, nh, hd)

    q = proj("wq", "bq", cfg.num_heads)
    k = proj("wk", "bk", cfg.num_kv_heads)
    v = proj("wv", "bv", cfg.num_kv_heads)
    positions = torch.arange(s, device=x.device) + pos0
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and window > 0:
        out = _apply_window_cache(q, k, v, cache, cfg, positions, pos0, window)
    else:
        if cache is not None:
            k, v = _write_cache(k, v, cache, cfg, pos0)
        out = attention(q, k, v, impl=_impl(cfg), causal=True, window=window,
                        q_offset=pos0)
    out = out.reshape(b, s, cfg.num_heads * hd)
    return out @ p["wo"].to(dt)


def _write_cache(k, v, cache, cfg: ModelConfig, pos0: int):
    """Write k/v at ``pos0`` into the dense cache; return the whole cached
    k/v in k's dtype."""
    s, dt = k.shape[1], k.dtype
    max_len = cache["k"].shape[1]
    if pos0 < 0 or pos0 + s > max_len:
        raise ValueError(f"positions {pos0}..{pos0 + s - 1} do not fit a "
                         f"cache of {max_len}")
    sl = slice(pos0, pos0 + s)
    if cfg.kv_quant:
        # int8 KV cache with per-(token, head) max-abs bf16 scales.
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache["k"][:, sl] = kq
        cache["v"][:, sl] = vq
        cache["k_scale"][:, sl] = ks
        cache["v_scale"][:, sl] = vs
        return (cache["k"].to(dt) * cache["k_scale"].to(dt)[..., None],
                cache["v"].to(dt) * cache["v_scale"].to(dt)[..., None])
    cache["k"][:, sl] = k.to(cache["k"].dtype)
    cache["v"][:, sl] = v.to(cache["v"].dtype)
    return cache["k"].to(dt), cache["v"].to(dt)


def _apply_window_cache(q, k, v, cache, cfg: ModelConfig, positions, pos0: int,
                        window: int):
    """Local attention with a ring-buffer cache. Decode (S == 1) writes slot
    ``pos0 % window`` and attends over the buffer by absolute position;
    prefill attends over the prompt with the window mask (K1 on the card)
    and fills the buffer from its last ``min(S, window)`` positions. The
    buffer is bf16 (the reference's int8 branch never sees it)."""
    s, dt = q.shape[1], q.dtype
    if s == 1:
        slot = pos0 % window
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = pos0
        return _window_cache_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                                       cache["pos"], pos0, window)
    out = attention(q, k, v, impl=_impl(cfg), causal=True, window=window,
                    q_offset=pos0)
    wlen = min(s, window)
    slots = positions[-wlen:] % window
    cache["k"][:, slots] = k[:, -wlen:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, -wlen:].to(cache["v"].dtype)
    cache["pos"][:, slots] = positions[-wlen:].to(cache["pos"].dtype)
    return out


def _window_cache_attention(q, k, v, kpos, cur_pos: int, window: int):
    """Attention over a ring-buffer cache with absolute-position masking.
    q: (B,S,H,hd); k, v: (B,W,KV,hd); kpos: (B,W). Scores in q's dtype,
    then fp32; probabilities rounded to q's dtype, as the reference."""
    h, hd = q.shape[2], q.shape[3]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    sc = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    kp = kpos[:, None, None, :]
    valid = (kp <= cur_pos) & (kp > cur_pos - window)
    sc = torch.where(valid, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", pr, v)


def init_block(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
               lead: tuple = ()):
    return {
        "ln1": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
        "attn": init_attn(gen, cfg, dtype, device, lead),
        "ln2": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                        device, lead),
    }


def apply_block(p, x, cfg: ModelConfig, *, pos0: int, cache=None):
    h = apply_attn(p["attn"], rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps),
                   cfg, pos0=pos0, cache=cache)
    x = x + h
    h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, gated=cfg.gated_mlp)


# -- model -------------------------------------------------------------------
def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            device=None):
    """The reference's init distributions, drawn from ``gen`` on ``device``;
    the layers' weights are drawn directly into their stacked tensors."""
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "blocks": init_block(gen, cfg, dtype, device, lead=(cfg.num_layers,)),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, dtype,
                                  device)
    return p


def _layer(tree, i: int):
    """Layer ``i`` of a dict of stacked tensors: views, so writes to a
    cache's layer land in the stacked cache."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree) -> list:
    """A dict of stacked tensors -> one dict of views per layer."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _run_blocks(params, x, cfg: ModelConfig, *, pos0: int, caches=None):
    """With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint``: it saves its input (and under remat "dots"
    its projections' outputs), and the rest of its forward (K1 and K2
    included) runs again in the backward."""
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    context_fn = remat_policy(cfg) or noop_context_fn
    for i, p_l in enumerate(_unbind(params["blocks"])):
        if remat:
            x = checkpoint(apply_block, p_l, x, cfg, pos0=pos0,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = apply_block(p_l, x, cfg, pos0=pos0,
                            cache=None if caches is None else _layer(caches, i))
    return x


def _embed(params, tokens, cfg, dt):
    # Gather, then cast: the same values as casting the table first, without
    # a copy of the whole table.
    return params["embed"][tokens].to(dt)


def _logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["ln_f"].to(x.dtype), cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ w.to(x.dtype)


def forward(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> logits (B,S,V)."""
    dt = torch_dtype(cfg.dtype)
    x = _embed(params, tokens, cfg, dt)
    x = _run_blocks(params, x, cfg, pos0=0)
    return _logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"} of
    (B,S), optional "mask")."""
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


# -- serving ------------------------------------------------------------------
def _kv_quantize(x):
    """(B,S,KV,hd) -> (int8 values, bf16 per-(B,S,KV) scales); arithmetic in
    x's dtype with round-half-to-even, as the reference."""
    scale = torch.clamp(x.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A bf16 cache whatever ``cfg.dtype`` is (int8 codes and bf16 scales
    with ``kv_quant``), as the reference's."""
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    if cfg.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        }
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Run the prompt, fill a new cache; returns (last_logits (B,1,V), cache)."""
    dt = torch_dtype(cfg.dtype)
    x = _embed(params, tokens, cfg, dt)
    b = x.shape[0]
    caches = init_cache(cfg, b, max_len, device=x.device)
    x = _run_blocks(params, x, cfg, pos0=0, caches=caches)
    return _logits(params, x[:, -1:].contiguous(), cfg), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step. token (B,) int, pos int; updates ``caches`` in place."""
    dt = torch_dtype(cfg.dtype)
    x = _embed(params, token[:, None], cfg, dt)
    x = _run_blocks(params, x, cfg, pos0=int(pos), caches=caches)
    return _logits(params, x, cfg), caches
