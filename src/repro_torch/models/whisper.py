"""Whisper-style encoder-decoder transformer, audio backbone (port of
``repro/models/whisper.py``).

The conv/mel frontend is a stub: the model takes precomputed frame
embeddings (B, num_frames, d_model). Sinusoidal position encodings, RMS
norms, MHA. The encoder's blocks attend without a mask; the decoder's have
a causal self-attention with a KV cache, then a cross-attention to the
encoder memory. Every attention over more than one query goes through
``common.attention``: kernel K1 on a CUDA tensor (causal=False for the
encoder and the cross-attention, S != T there), the blockwise port of the
reference's XLA flash on the CPU.

As in the reference, a decode step computes the cross-attention's k/v from
the memory again in every layer. Unlike the reference, the KV cache is
updated in place and a write past ``max_len`` raises (the reference clamps
it onto the last slot); ``prefill`` takes ``max_len``, which a caller that
decodes must size to prompt + steps.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.models.common import (
    _CTX,
    apply_mlp,
    attention,
    constrain,
    cross_entropy,
    dense_init,
    embed_init,
    init_mlp,
    remat_policy,
    rms_norm,
    rows_whole,
    sinusoidal_positions,
)


def _init_proj(gen, cfg, dtype, device, lead):
    hd = cfg.resolved_head_dim
    n = len(lead)
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, (*lead, d, h * hd), n, dtype, device),
        "wk": dense_init(gen, (*lead, d, kv * hd), n, dtype, device),
        "wv": dense_init(gen, (*lead, d, kv * hd), n, dtype, device),
        "wo": dense_init(gen, (*lead, h * hd, d), n, dtype, device),
    }


def _proj_qkv(p, xq, xkv, cfg):
    xq, xkv = rows_whole(xq), rows_whole(xkv)
    b, s, _ = xq.shape
    t = xkv.shape[1]
    hd = cfg.resolved_head_dim
    dt = xq.dtype
    q = tr._heads_divide(xq @ p["wq"].to(dt), cfg.num_heads).reshape(
        b, s, cfg.num_heads, hd)
    k = tr._heads_divide(xkv @ p["wk"].to(dt), cfg.num_kv_heads).reshape(
        b, t, cfg.num_kv_heads, hd)
    v = tr._heads_divide(xkv @ p["wv"].to(dt), cfg.num_kv_heads).reshape(
        b, t, cfg.num_kv_heads, hd)
    return (constrain(q, "dp", None, "tp", None),
            constrain(k, "dp", None, "tp", None),
            constrain(v, "dp", None, "tp", None))


def _ones(cfg, dtype, device, lead):
    return torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)


def init_enc_block(gen, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    return {
        "ln1": _ones(cfg, dtype, device, lead),
        "attn": _init_proj(gen, cfg, dtype, device, lead),
        "ln2": _ones(cfg, dtype, device, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, False, dtype, device, lead),
    }


def apply_enc_block(p, x, cfg):
    h = rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _proj_qkv(p["attn"], h, h, cfg)
    o = attention(q, k, v, impl="xla_flash", causal=False)
    x = x + constrain(o.reshape(x.shape[0], x.shape[1], -1)
                      @ p["attn"]["wo"].to(x.dtype), "dp", "sp", None)
    h = rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, gated=False)


def init_dec_block(gen, cfg, dtype=torch.float32, device=None, lead: tuple = ()):
    return {
        "ln1": _ones(cfg, dtype, device, lead),
        "self_attn": _init_proj(gen, cfg, dtype, device, lead),
        "ln_x": _ones(cfg, dtype, device, lead),
        "cross_attn": _init_proj(gen, cfg, dtype, device, lead),
        "ln2": _ones(cfg, dtype, device, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, False, dtype, device, lead),
    }


def apply_dec_block(p, x, cfg, *, memory, pos0: int = 0, cache=None):
    """Self-attention (causal; with ``cache``, k/v written at ``pos0`` and the
    whole cache attended), cross-attention to ``memory``, MLP."""
    b, s, _ = x.shape
    dt = x.dtype
    h = rms_norm(x, p["ln1"].to(dt), cfg.norm_eps)
    q, k, v = _proj_qkv(p["self_attn"], h, h, cfg)
    if cache is not None:
        k, v = tr._write_cache(k, v, cache, pos0)
    o = attention(q, k, v, impl="xla_flash", causal=True, q_offset=pos0)
    x = x + constrain(o.reshape(b, s, -1) @ p["self_attn"]["wo"].to(dt),
                      "dp", "sp", None)
    h = rms_norm(x, p["ln_x"].to(dt), cfg.norm_eps)
    q, k, v = _proj_qkv(p["cross_attn"], h, memory, cfg)
    o = attention(q, k, v, impl="xla_flash", causal=False)
    x = x + constrain(o.reshape(b, s, -1) @ p["cross_attn"]["wo"].to(dt),
                      "dp", "sp", None)
    h = rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, gated=False)


def init_model(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None):
    """The reference's init distributions, drawn from ``gen`` on ``device``;
    the encoder's and the decoder's layers are drawn into stacked tensors."""
    return {
        "enc_blocks": init_enc_block(gen, cfg, dtype, device,
                                     lead=(cfg.encoder_layers,)),
        "dec_blocks": init_dec_block(gen, cfg, dtype, device,
                                     lead=(cfg.num_layers,)),
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "ln_enc": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, dtype,
                              device),
    }


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode(params, frames, cfg: ModelConfig):
    """frames: (B, F, D) precomputed frame embeddings (stub frontend) ->
    the memory (B, F, D)."""
    dt = tr.torch_dtype(cfg.dtype)
    x = frames.to(dt) + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                             device=frames.device).to(dt)
    x = constrain(x, "dp", "sp", None)
    context_fn = remat_policy(cfg) or noop_context_fn
    for p_l in tr._unbind(params["enc_blocks"]):
        if _remat(cfg):
            x = checkpoint(apply_enc_block, p_l, x, cfg, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = apply_enc_block(p_l, x, cfg)
    return rms_norm(x, params["ln_enc"].to(dt), cfg.norm_eps)


def decode(params, memory, tokens, cfg: ModelConfig, *, pos0: int = 0,
           caches=None, last_only: bool = False):
    """The decoder over tokens (B,S) at positions pos0 .. pos0+S-1 -> logits
    (B,S,V) (``last_only``: of the last position, (B,1,V)). ``caches``
    ({"k", "v"} of (L,B,max_len,KV,hd)) are written in place."""
    dt = tr.torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    pe = sinusoidal_positions(s, cfg.d_model, offset=pos0, device=tokens.device)
    x = constrain(tr._embed(params, tokens, cfg, dt, None) + pe.to(dt),
                  "dp", "sp", None)
    remat = caches is None and _remat(cfg)
    context_fn = remat_policy(cfg) or noop_context_fn
    for i, p_l in enumerate(tr._unbind(params["dec_blocks"])):
        if remat:
            x = checkpoint(apply_dec_block, p_l, x, cfg, memory=memory,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = apply_dec_block(p_l, x, cfg, memory=memory, pos0=pos0,
                                cache=None if caches is None else tr._layer(caches, i))
    if last_only:
        x = x[:, -1:].contiguous()
    x = rows_whole(rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps))
    return constrain(x @ params["lm_head"].to(dt), "dp", "sp", "tp")


def forward(params, tokens, frames, cfg: ModelConfig):
    """tokens (B,S), frames (B,F,D) -> logits (B,S,V)."""
    return decode(params, encode(params, frames, cfg), tokens, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"} of
    (B,S), "frames" (B,F,D), optional "mask")."""
    logits = forward(params, batch["tokens"], batch["frames"], cfg)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The decoder's self-attention cache, bf16 whatever ``cfg.dtype`` is,
    as in the reference."""
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def prefill(params, frames, tokens, cfg: ModelConfig, max_len: int):
    """Encode the frames, run the prompt into a new cache of ``max_len``
    positions; returns (last_logits (B,1,V), {"kv": cache, "memory"})."""
    b = tokens.shape[0]
    memory = _place_memory(encode(params, frames, cfg), b)
    caches = tr.place_cache(
        lambda dev: init_caches(cfg, b, max_len, device=dev), b,
        device=tokens.device)
    logits = decode(params, memory, tokens, cfg, caches=caches, last_only=True)
    return logits, {"kv": caches, "memory": memory}


def _place_memory(memory, batch: int):
    """A DTensor ``memory`` on ``cache_pspec``'s placements ("memory": batch
    on "dp", d_model on "model" where it is at least 64); else as it is."""
    if not isinstance(memory, DTensor):
        return memory
    from repro_torch.sharding.specs import cache_pspec, placements

    mesh = _CTX["mesh"]
    pls = placements(cache_pspec("memory", tuple(memory.shape), mesh, batch),
                     mesh)
    return memory.redistribute(memory.device_mesh, pls)


def decode_step(params, state, token, pos: int, cfg: ModelConfig):
    """One decode step. token (B,) int, pos int; updates the cache in place."""
    logits = decode(params, state["memory"], token[:, None], cfg, pos0=int(pos),
                    caches=state["kv"])
    return logits, state
