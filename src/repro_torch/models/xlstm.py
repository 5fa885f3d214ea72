"""xLSTM: mLSTM (matrix-memory) + sLSTM blocks, xLSTM[7:1] layout (port of
``repro/models/xlstm.py``).

mLSTM uses the chunkwise-parallel linear-recurrence form: within a chunk an
attention-like quadratic (L_c x L_c) with multiplicative gate decays; across
chunks a carried matrix state C (NH, dh, dh) and normalizer n (NH, dh):

    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

with sigmoid input and forget gates, as in the reference. sLSTM is a
per-head recurrent cell over time (``jax.lax.scan`` in the reference; here
the kernel ``kernels.slstm.slstm_scan`` where no gradient flows, the plain
step loop under autograd), with an O(1) decode state. The layers of each period (7 mLSTM
blocks stacked, then one sLSTM block) are stacked again over the periods
under ``"periods"``, in the reference's layout.

No Pallas kernel of the reference is in this family: on a CUDA tensor it
runs K2 (``rms_norm``), twice per block and once before the head, and the
sLSTM recurrence kernel once per sLSTM block of a prefill or decode step;
the rest is plain PyTorch.

Under a ``mesh_context`` with a ``DeviceMesh`` the reference's constraint
points apply (``up`` and the sLSTM's input gates on "tp", the block outputs
and the embeddings on "dp", the logits' vocab on "tp"). Between them each
block runs on local rows with its channels whole (``_rows_local``): the tp
split of ``up`` does not line up with its two halves, the mLSTM's head-wise
products need whole heads (xlstm-1.3b's 4 heads do not divide a tp of 16),
its group norm whole rows, and the sLSTM's scan over time runs on plain
tensors, one gather before it and one wrap after. The states are
DTensors on ``cache_pspec``'s placements, gathered whole over "model" per
block and written back into their own shards.

Unlike the reference, the states are updated in place: ``prefill``
allocates them and ``decode_step`` writes them and returns the same dict.
``prefill`` runs the head on the last position only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import slstm
from repro_torch.models import transformer as tr
from repro_torch.models.common import (
    _replicated_local,
    constrain,
    cross_entropy,
    dense_init,
    embed_init,
    remat_policy,
    rms_norm,
    rows_whole,
)
from repro_torch.models.recurrent import _store, causal_conv1d, conv1d_step

CHUNK = 256
CHUNK_GROUP = 32      # chunks whose state-free work runs as one batch


def _dims(cfg: ModelConfig):
    di = int(cfg.proj_factor * cfg.d_model)
    nh = cfg.num_heads
    return di, nh, di // nh


# -- mLSTM --------------------------------------------------------------------
def init_mlstm(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
               lead: tuple = ()):
    d = cfg.d_model
    di, nh, dh = _dims(cfg)
    n = len(lead)
    return {
        "ln": torch.ones((*lead, d), dtype=dtype, device=device),
        "w_up": dense_init(gen, (*lead, d, 2 * di), n, dtype, device),
        "conv_w": dense_init(gen, (*lead, cfg.conv_width, di), n, dtype, device),
        "wq": dense_init(gen, (*lead, nh, dh, dh), n + 1, dtype, device),
        "wk": dense_init(gen, (*lead, nh, dh, dh), n + 1, dtype, device),
        "wv": dense_init(gen, (*lead, nh, dh, dh), n + 1, dtype, device),
        "w_i": dense_init(gen, (*lead, di, nh), n, dtype, device),
        "w_f": dense_init(gen, (*lead, di, nh), n, dtype, device),
        "f_bias": torch.full((*lead, nh), 3.0, dtype=dtype, device=device),
        "gn": torch.ones((*lead, di), dtype=dtype, device=device),
        "w_down": dense_init(gen, (*lead, di, d), n, dtype, device),
    }


def _mlstm_chunk_scan(q, k, v, i, logf, C0, n0):
    """Chunkwise mLSTM. q,k,v: (B,S,NH,dh); i,logf: (B,S,NH) fp32.
    C0: (B,NH,dh,dh), n0: (B,NH,dh) fp32. Returns (h (B,S,NH,dh), C, n).
    The last chunk is zero-padded to CHUNK positions, as in the reference.

    The reference's loop over chunks computes, per chunk, the intra-chunk
    attention, the inter-chunk read of the carried (C, n) and the chunk's
    contribution to (C, n). Only the carry is sequential, so the chunks run
    CHUNK_GROUP at a time: each group's intra-chunk terms and contributions
    as batched ops, then the carry through the group chunk by chunk (a
    multiply and an add for each of C and n), then the group's inter-chunk
    reads against the carries entering its chunks, batched. Every value is
    the reference's formula for its chunk. The host issues a seventh of the
    launches a chunk-by-chunk loop did (a 32,768-token xlstm-1.3b prefill
    on an H100 80GB HBM3 at 700 W: 32,763 device launches against 233,524,
    chip_smoke.py's profile)."""
    b, s, nh, dh = q.shape
    dt = q.dtype
    L = min(CHUNK, s)
    nc = -(-s // L)
    pad = nc * L - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        i, logf = (F.pad(x, (0, 0, 0, pad)) for x in (i, logf))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n = C0, n0
    hs = []
    for g0 in range(0, nc, CHUNK_GROUP):
        g = min(CHUNK_GROUP, nc - g0)
        sl = slice(g0 * L, (g0 + g) * L)
        qc, kc, vc = (x[:, sl].reshape(b, g, L, nh, dh) for x in (q, k, v))
        ic, lfc = (x[:, sl].reshape(b, g, L, nh) for x in (i, logf))
        cl = torch.cumsum(lfc, dim=2)                  # (B,G,L,NH) log cumulative decay
        qk = torch.einsum("bglhd,bgmhd->bghlm", qc, kc).float()
        clt = cl.transpose(2, 3)                       # (B,G,NH,L)
        # above the diagonal the decay may overflow to inf; the mask picks
        # zero there (a multiply by the mask would make inf * 0 = nan)
        decay = torch.exp(clt[..., :, None] - clt[..., None, :])
        A = qk * decay * ic.transpose(2, 3)[..., None, :].float()
        A = torch.where(mask, A, 0.0)
        h_intra = torch.einsum("bghlm,bgmhd->bglhd", A.to(dt), vc)
        d_intra = A.sum(-1).transpose(2, 3)                        # (B,G,L,NH)
        ecl = torch.exp(cl)                                        # (B,G,L,NH)
        e_end = torch.exp(cl[:, :, -1])                            # (B,G,NH)
        w_end = torch.exp(cl[:, :, -1:] - cl) * ic.float()
        dC = torch.einsum("bglh,bglhd,bglhe->bghde", w_end, kc.float(), vc.float())
        dn = torch.einsum("bglh,bglhd->bghd", w_end, kc.float())
        Cs, ns = [], []                                # the carry entering each chunk
        for j in range(g):
            Cs.append(C)
            ns.append(n)
            C = e_end[:, j, :, None, None] * C + dC[:, j]
            n = e_end[:, j, :, None] * n + dn[:, j]
        h_inter = torch.einsum("bglhd,bghde->bglhe", qc, torch.stack(Cs, 1).to(dt)) * \
            ecl[..., None].to(dt)
        d_inter = torch.einsum("bglhd,bghd->bglh", qc.float(), torch.stack(ns, 1)) * ecl
        denom = torch.clamp_min(torch.abs(d_intra + d_inter), 1.0)
        h = (h_intra.float() + h_inter.float()) / denom[..., None]
        hs.append(h.to(dt).reshape(b, g * L, nh, dh))
    h = torch.cat(hs, dim=1)
    return h[:, :s], C, n


def apply_mlstm(p, x, cfg: ModelConfig, *, state=None):
    """x: (B,S,D) -> x + the block's output. ``state`` ({"C", "n"} fp32,
    "conv" bf16) is read and written in place: one step for S == 1, the
    prompt scanned from the carried state otherwise. On DTensors the block
    between ``w_up`` and ``w_down`` runs on local rows (``_rows_local``)."""
    dt = x.dtype
    h0 = rows_whole(rms_norm(x, p["ln"].to(dt), cfg.norm_eps))
    up = constrain(h0 @ p["w_up"].to(dt), "dp", None, "tp")
    mixed = _rows_local(_mlstm_mix, p, ("conv_w", "wq", "wk", "wv", "w_i",
                                        "w_f", "f_bias", "gn"), up, state, cfg)
    return x + constrain(mixed @ p["w_down"].to(dt), "dp", None, None)


def _mlstm_mix(p, up, state, cfg: ModelConfig):
    """The mLSTM block from the up projection (B,S,2*di) to the gated
    output (B,S,di) before ``w_down``, on plain tensors."""
    dt = up.dtype
    b, s, _ = up.shape
    di, nh, dh = _dims(cfg)
    xm, z = torch.chunk(up, 2, dim=-1)

    if state is None:
        xc = F.silu(causal_conv1d(p["conv_w"], xm))
    elif s == 1:
        c_out, conv_state = conv1d_step(p["conv_w"], xm, state["conv"].to(dt))
        xc = F.silu(c_out)
        new_conv = conv_state
    else:  # prefill from the carried conv state
        cw = cfg.conv_width
        hist = torch.cat([state["conv"].to(dt), xm], dim=1)
        xc = F.silu(causal_conv1d(p["conv_w"], hist)[:, cw - 1:])
        new_conv = hist[:, -(cw - 1):]

    def headwise(w, src):
        return torch.einsum("blhd,hde->blhe", src.reshape(b, s, nh, dh), w.to(dt))

    q = headwise(p["wq"], xc)
    k = headwise(p["wk"], xc) / torch.tensor(math.sqrt(dh), dtype=torch.float32
                                             ).to(dt)
    v = headwise(p["wv"], xm)
    gate_i = torch.sigmoid((xm @ p["w_i"].to(dt)).float())
    logf = F.logsigmoid((xm @ p["w_f"].to(dt)).float() + p["f_bias"].float())

    if state is None:
        C0 = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=up.device)
        n0 = torch.zeros((b, nh, dh), dtype=torch.float32, device=up.device)
    else:
        C0, n0 = state["C"], state["n"]

    if s == 1 and state is not None:
        f = torch.exp(logf[:, 0])                                  # (B,NH)
        kf, vf, qf = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C = f[:, :, None, None] * C0 + gate_i[:, 0][:, :, None, None] * \
            torch.einsum("bhd,bhe->bhde", kf, vf)
        n = f[:, :, None] * n0 + gate_i[:, 0][:, :, None] * kf
        num = torch.einsum("bhd,bhde->bhe", qf, C)
        den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), 1.0)
        h = (num / den[..., None]).to(dt)[:, None]
    else:
        h, C, n = _mlstm_chunk_scan(q, k, v, gate_i, logf, C0, n0)

    h = rms_norm(h.reshape(b, s, di), p["gn"].to(dt), cfg.norm_eps)
    if state is not None:
        state["C"].copy_(C)
        state["n"].copy_(n)
        state["conv"].copy_(new_conv)
    return h * F.silu(z)


def _rows_local(fn, p, names, x, state, cfg: ModelConfig):
    """``fn(p, x, state, cfg)`` (plain tensors in, one out); on a DTensor
    ``x`` it runs on this rank's rows with every other dim whole: x gathered
    to batch on "dp" only (a split of channels does not line up with the
    mLSTM's halves and heads, nor with the sLSTM's gates), the params
    ``names`` whole (their gradients partial over the mesh dims that split
    the rows) and each state leaf gathered the same way, written back into
    its own shard after where the gather made a copy; the output takes x's
    placements."""
    if not isinstance(x, DTensor):
        return fn(p, x, state, cfg)
    mesh = x.device_mesh

    def rows(t):
        return tuple(pl if pl.is_shard() and pl.dim == 0 else Replicate()
                     for pl in t.placements)

    x = x.redistribute(mesh, rows(x))
    local_p = {n: _replicated_local(p[n], x.placements) for n in names}
    whole = {} if state is None else {
        k: v.redistribute(mesh, rows(v)) for k, v in state.items()}
    out = fn(local_p, x.to_local(),
             None if state is None else {k: v.to_local() for k, v in whole.items()},
             cfg)
    for k, v in whole.items():
        if v.to_local().data_ptr() != state[k].to_local().data_ptr():
            _store(state[k], v)
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None, lead: tuple = ()):
    di, nh, dh = _dims(cfg)
    return {
        "C": torch.zeros((*lead, batch, nh, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((*lead, batch, nh, dh), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, di),
                            dtype=torch.bfloat16, device=device),
    }


# -- sLSTM --------------------------------------------------------------------
def init_slstm(gen, cfg: ModelConfig, dtype=torch.float32, device=None,
               lead: tuple = ()):
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    n = len(lead)
    return {
        "ln": torch.ones((*lead, d), dtype=dtype, device=device),
        "w_gates": dense_init(gen, (*lead, d, 4 * d), n, dtype, device),
        "r_gates": dense_init(gen, (*lead, nh, dh, 4 * dh), n + 1, dtype, device),
        "gn": torch.ones((*lead, d), dtype=dtype, device=device),
        "w_out": dense_init(gen, (*lead, d, d), n, dtype, device),
    }


def apply_slstm(p, x, cfg: ModelConfig, *, state=None):
    """x: (B,S,D) -> x + the block's output; the cell runs over the S steps
    (``_slstm_loop``). ``state`` ({"h", "c" fp32}) is read and written in
    place. On DTensors the scan runs on local rows: ``gx`` gathered to whole
    channels once before it, the output wrapped once after
    (``_rows_local``), so no DTensor op runs per step."""
    dt = x.dtype
    xn = rows_whole(rms_norm(x, p["ln"].to(dt), cfg.norm_eps))
    gx = constrain(xn @ p["w_gates"].to(dt), "dp", None, "tp")    # (B,S,4D)
    hseq = _rows_local(_slstm_loop, p, ("r_gates",), gx, state, cfg)
    out = rms_norm(hseq, p["gn"].to(dt), cfg.norm_eps) @ p["w_out"].to(dt)
    return x + constrain(out, "dp", None, None)


def _slstm_loop(p, gx, state, cfg: ModelConfig):
    """The sLSTM cell over the S steps of gx (B,S,4D) on plain tensors;
    returns h (B,S,D) and writes ``state`` in place.

    The route is fixed by autograd, not by failure: where no gradient flows
    (serving, sharded serving on local rows, the S = 1 decode step, the dry
    run's prefill) the whole scan is one ``kernels.slstm.slstm_scan``, the
    hand-written kernel on the card; under autograd it is
    ``slstm_scan_plain``, the step loop, until the kernel has a backward."""
    dt = gx.dtype
    r_gates = p["r_gates"].to(dt)          # cast once, not on every step
    h0, c0 = (None, None) if state is None else (state["h"].to(dt), state["c"])
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (gx, r_gates, h0, c0))
    if grad:
        hseq, h, c = slstm.slstm_scan_plain(gx, r_gates, h0, c0)
    else:
        hseq, h, c = slstm.slstm_scan(
            gx.contiguous(), r_gates.contiguous(),
            *(None if t is None else t.contiguous() for t in (h0, c0)))
    if state is not None:
        state["h"].copy_(h)
        state["c"].copy_(c)
    return hseq


def init_slstm_state(cfg: ModelConfig, batch: int, device=None, lead: tuple = ()):
    """h in the activations' dtype, c in fp32. The reference allocates h in
    bf16, but its prefill returns h in the activations' dtype (the scan's
    carry), and decode reads that: so with fp32 activations h is fp32."""
    return {
        "h": torch.zeros((*lead, batch, cfg.d_model),
                         dtype=tr.torch_dtype(cfg.dtype), device=device),
        "c": torch.zeros((*lead, batch, cfg.d_model), dtype=torch.float32,
                         device=device),
    }


# -- model ----------------------------------------------------------------------
def _shape(cfg: ModelConfig) -> tuple[int, int]:
    """(periods, mLSTM blocks per period)."""
    per = cfg.slstm_every
    return cfg.num_layers // per, per - 1


def init_lm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
            device=None):
    """The reference's init distributions, drawn from ``gen`` on ``device``
    directly into the stacked tensors: (periods, 7, ...) for the mLSTM
    blocks, (periods, ...) for the sLSTM blocks."""
    n_p, n_m = _shape(cfg)
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "periods": {"mlstm": init_mlstm(gen, cfg, dtype, device, lead=(n_p, n_m)),
                    "slstm": init_slstm(gen, cfg, dtype, device, lead=(n_p,))},
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, dtype,
                              device),
    }


def _apply_period(p_slot, x, cfg, caches=None):
    for j, p_l in enumerate(tr._unbind(p_slot["mlstm"])):
        x = apply_mlstm(p_l, x, cfg,
                        state=None if caches is None else tr._layer(caches["mlstm"], j))
    return apply_slstm(p_slot["slstm"], x, cfg,
                       state=None if caches is None else caches["slstm"])


def _run_periods(params, x, cfg: ModelConfig, caches=None):
    """With ``cfg.remat`` and autograd recording (no caches), each period
    runs under ``torch.utils.checkpoint``, as the reference wraps
    ``_apply_period`` in ``jax.checkpoint``."""
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    context_fn = remat_policy(cfg) or noop_context_fn
    for i, p_i in enumerate(tr._unbind(params["periods"])):
        if remat:
            x = checkpoint(_apply_period, p_i, x, cfg, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = _apply_period(p_i, x, cfg,
                              None if caches is None else tr._layer(caches, i))
    return x


def _head(params, x, cfg: ModelConfig):
    dt = x.dtype
    x = rows_whole(rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps))
    return constrain(x @ params["lm_head"].to(dt), "dp", None, "tp")


def forward(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> logits (B,S,V)."""
    dt = tr.torch_dtype(cfg.dtype)
    x = _run_periods(params, tr._embed(params, tokens, cfg, dt, None), cfg)
    return _head(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"} of
    (B,S), optional "mask")."""
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_caches(cfg: ModelConfig, batch: int, device=None):
    """The recurrent states, stacked as the params: (periods, 7, B, ...) for
    the mLSTM blocks, (periods, B, ...) for the sLSTM blocks."""
    n_p, n_m = _shape(cfg)
    return {"mlstm": init_mlstm_state(cfg, batch, device, lead=(n_p, n_m)),
            "slstm": init_slstm_state(cfg, batch, device, lead=(n_p,))}


def prefill(params, tokens, cfg: ModelConfig):
    """Run the prompt through new states; returns (last_logits (B,1,V),
    caches). The states have a fixed size, so there is no ``max_len``."""
    dt = tr.torch_dtype(cfg.dtype)
    x = tr._embed(params, tokens, cfg, dt, None)
    b = x.shape[0]
    caches = tr.place_cache(lambda dev: init_caches(cfg, b, device=dev), b,
                            stacked={"mlstm": 2, "slstm": 1}, device=x.device)
    x = _run_periods(params, x, cfg, caches)
    return _head(params, x[:, -1:].contiguous(), cfg), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step (``pos`` is not needed: the states carry the
    position); updates ``caches`` in place."""
    dt = tr.torch_dtype(cfg.dtype)
    x = _run_periods(params, tr._embed(params, token[:, None], cfg, dt, None), cfg,
                     caches)
    return _head(params, x, cfg), caches
