"""Decoder-only transformer LM, dense family (port of ``repro/models/transformer.py``).

Params are nested dicts of tensors in the reference's layout: the layers'
weights are stacked along a leading axis under ``"blocks"``, and a loop over
that axis takes the place of ``jax.lax.scan``. Serving path: prefill +
single-token decode with a static KV cache of ``max_len`` positions.

Unlike the reference, the cache is updated in place (the reference returns a
new one from a pure function): ``prefill`` allocates it and ``decode_step``
writes one position of it and returns the same dict. Writing past
``max_len`` raises, where the reference's ``dynamic_update_slice`` would
clamp the position and overwrite the last slot.

Only the dense family is ported: MoE comes with ROADMAP item M11, and so do
the sliding-window ring-buffer cache of the hybrid family and VLM patches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_mlp,
    apply_rope,
    attention,
    dense_init,
    embed_init,
    init_mlp,
    rms_norm,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_family(cfg: ModelConfig):
    """Raise for a model family the port does not run yet."""
    if cfg.family != "dense":
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
               layer: int = 0):
    """Returns the attention output. x: (B,S,D) at positions pos0 .. pos0+S-1.

    With ``cache`` (stacked (L, B, max_len, ...) tensors), layer ``layer``'s
    k/v are written at ``pos0`` in place and attention reads the whole cached
    sequence, rounded to the cache's dtype, as the reference does."""
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

    if cache is not None:
        max_len = cache["k"].shape[2]
        if pos0 < 0 or pos0 + s > max_len:
            raise ValueError(f"positions {pos0}..{pos0 + s - 1} do not fit a "
                             f"cache of {max_len}")
        sl = slice(pos0, pos0 + s)
        if cfg.kv_quant:
            # int8 KV cache with per-(token, head) max-abs bf16 scales.
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            cache["k"][layer, :, sl] = kq
            cache["v"][layer, :, sl] = vq
            cache["k_scale"][layer, :, sl] = ks
            cache["v_scale"][layer, :, sl] = vs
            k = cache["k"][layer].to(dt) * cache["k_scale"][layer].to(dt)[..., None]
            v = cache["v"][layer].to(dt) * cache["v_scale"][layer].to(dt)[..., None]
        else:
            cache["k"][layer, :, sl] = k.to(cache["k"].dtype)
            cache["v"][layer, :, sl] = v.to(cache["v"].dtype)
            k, v = cache["k"][layer].to(dt), cache["v"][layer].to(dt)

    out = attention(q, k, v, impl=_impl(cfg), causal=True,
                    q_offset=pos0)
    out = out.reshape(b, s, cfg.num_heads * hd)
    return out @ p["wo"].to(dt)


def init_block(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
               lead: tuple = ()):
    return {
        "ln1": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
        "attn": init_attn(gen, cfg, dtype, device, lead),
        "ln2": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype,
                        device, lead),
    }


def apply_block(p, x, cfg: ModelConfig, *, pos0: int, cache=None, layer=0):
    h = apply_attn(p["attn"], rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps),
                   cfg, pos0=pos0, cache=cache, layer=layer)
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
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _run_blocks(params, x, cfg: ModelConfig, *, pos0: int, caches=None):
    for i in range(cfg.num_layers):
        x = apply_block(_layer(params["blocks"], i), x, cfg, pos0=pos0,
                        cache=caches, layer=i)
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
