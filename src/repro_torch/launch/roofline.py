"""Roofline model: compute / memory / collective terms per (arch x shape x mesh).

Port of ``repro/launch/roofline.py``: the closed-form FLOP, HBM-byte and
collective-byte sums are the reference's, unchanged; only the four device
constants are those of an NVIDIA H100 SXM (dense rates, at its 700 W
limit):

    peak      989 TFLOP/s bf16 per GPU (data sheet: BF16 Tensor Core, dense)
    HBM BW    3.35 TB/s per GPU (data sheet: GPU memory bandwidth, HBM3)
    NVLink    450 GB/s per GPU per direction (NVLink 4: 900 GB/s
              bidirectional), the mesh axes inside a node
    network   50 GB/s per GPU (one 400 Gb/s NDR InfiniBand NIC per GPU), the
              pod axis between nodes

Terms (seconds):
    compute    = FLOPs / (GPUs x peak)
    memory     = HBM bytes / (GPUs x HBM BW)
    collective = per-axis wire bytes / link BW, the largest axis
                 (per-GPU bytes on each axis: the paper's N_K x B_K)

``model_flops_6nd`` over a measured step time at the bf16 peak is the share
of the peak that the step's useful work reaches (``chip_smoke.py``'s
training phases print it).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig

PEAK_FLOPS = 989e12        # H100 SXM, BF16 Tensor Core, dense
HBM_BW = 3.35e12           # H100 SXM, HBM3
NVLINK_BW = 450e9          # NVLink 4, per direction (900 GB/s both ways)
NET_BW = 50e9              # 400 Gb/s NDR InfiniBand, one NIC per GPU

BF16 = 2
FP32 = 4


# --------------------------------------------------------------------------
# Closed-form FLOPs
# --------------------------------------------------------------------------
def _layer_matmul_params(cfg: ModelConfig) -> float:
    """Weight-matmul params of ONE layer (active path for MoE)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = 2 * d * hd * (cfg.num_heads + cfg.num_kv_heads)
    if cfg.family == "moe":
        e_act = cfg.experts_per_token * 3 * d * cfg.moe_d_ff
        shared = cfg.num_shared_experts * 3 * d * cfg.moe_d_ff
        router = d * cfg.num_experts
        return attn + e_act + shared + router
    if cfg.family == "hybrid":
        rec = 2 * d * cfg.d_rnn + 2 * cfg.d_rnn * cfg.d_rnn + cfg.d_rnn * d
        att = attn
        mlp = 3 * d * cfg.d_ff
        pat = cfg.block_pattern
        frac_rec = pat.count("rec") / len(pat)
        return frac_rec * rec + (1 - frac_rec) * att + mlp
    if cfg.family == "ssm":
        di = int(cfg.proj_factor * d)
        dh = di // cfg.num_heads
        mls = d * 2 * di + 3 * di * dh + di * d
        sls = d * 4 * d + 4 * d * (d // cfg.num_heads) + d * d
        per = cfg.slstm_every
        return ((per - 1) * mls + sls) / per
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    return attn + mlp


def _total_layer_params(cfg: ModelConfig) -> float:
    n = cfg.num_layers
    if cfg.is_encoder_decoder:
        d, hd = cfg.d_model, cfg.resolved_head_dim
        attn = 2 * d * hd * (cfg.num_heads + cfg.num_kv_heads)
        mlp = 2 * d * cfg.d_ff
        enc = cfg.encoder_layers * (attn + mlp)
        dec = cfg.num_layers * (2 * attn + mlp)
        return enc + dec
    return n * _layer_matmul_params(cfg)


def _attn_context(cfg: ModelConfig, t: int) -> float:
    """Effective attended context per query (window-aware)."""
    pat = cfg.block_pattern
    if cfg.family == "hybrid" and cfg.local_window:
        frac_attn = pat.count("attn") / len(pat)
        return frac_attn * min(t, cfg.local_window)
    if cfg.family == "ssm":
        return 0.0  # linear recurrences: no KV attention
    return t


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return round(cfg.num_layers * pat.count("attn") / len(pat))
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


def analytic_fwd_flops(cfg: ModelConfig, batch: int, seq: int,
                       context: int | None = None) -> float:
    """Forward FLOPs for `batch` sequences of `seq` new tokens attending to
    `context` (defaults to seq, causal-halved when context == seq)."""
    tokens = batch * seq
    n_mm = _total_layer_params(cfg)
    flops = 2.0 * tokens * n_mm
    # lm head
    flops += 2.0 * tokens * cfg.d_model * cfg.vocab_size
    # attention score/value FLOPs
    t = context if context is not None else seq
    eff = _attn_context(cfg, t)
    causal_half = 0.5 if (context is None and seq == t and cfg.family != "hybrid") else 1.0
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    flops += 4.0 * batch * seq * eff * h * hd * _attn_layers(cfg) * causal_half
    if cfg.is_encoder_decoder:
        f = cfg.num_frames
        flops += 2.0 * batch * f * _total_layer_params(cfg) * (
            cfg.encoder_layers / (cfg.encoder_layers + cfg.num_layers))
        flops += 4.0 * batch * seq * f * h * hd * cfg.num_layers  # cross attn
    if cfg.family == "ssm":
        di = int(cfg.proj_factor * cfg.d_model)
        dh = di // cfg.num_heads
        # chunk quadratic + state outer products per token
        flops += tokens * cfg.num_layers * (4.0 * 256 * di + 4.0 * di * dh)
    if cfg.family == "hybrid":
        flops += tokens * cfg.num_layers * 0.66 * 8.0 * cfg.d_rnn  # rglru elementwise
    return flops


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    if shape.kind == "train":
        return 3.0 * analytic_fwd_flops(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return analytic_fwd_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token against a seq_len context
    return analytic_fwd_flops(cfg, shape.global_batch, 1, context=shape.seq_len)


def model_flops_6nd(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
                    n_active: int | None = None) -> float:
    """The assignment's MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE)."""
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def active_params(cfg: ModelConfig, n_params: int) -> int:
    if cfg.family != "moe":
        return n_params
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    expert_p = cfg.num_layers * e * 3 * d * f
    active_expert_p = cfg.num_layers * cfg.experts_per_token * 3 * d * f
    return n_params - expert_p + active_expert_p


# --------------------------------------------------------------------------
# Memory traffic (per device, per step)
# --------------------------------------------------------------------------
def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_params: int,
                       parallel: ParallelConfig, chips: int) -> float:
    """Per-device HBM traffic; the roofline memory term uses bytes/chip."""
    tp = parallel.model
    dp = max(chips // tp, 1)
    param_shard = n_params / (tp * (dp if parallel.fsdp else 1))
    b_loc = max(shape.global_batch // dp, 1)
    d = cfg.d_model
    if shape.kind == "train":
        # fwd read + bwd read + grad write (+ optimizer read/write fp32 x4)
        pbytes = param_shard * FP32
        traffic = 3 * pbytes + 4 * pbytes
        # activations (remat: ~2x writes/reads of layer outputs)
        traffic += 4 * b_loc * shape.seq_len * d * BF16 * cfg.num_layers / 8
        return traffic
    if shape.kind == "prefill":
        traffic = param_shard * FP32
        traffic += 2 * b_loc * shape.seq_len * d * BF16 * cfg.num_layers / 8
        traffic += kv_cache_bytes(cfg, shape) / chips
        return traffic
    # decode: all params + whole KV cache stream per token
    return param_shard * FP32 + kv_cache_bytes(cfg, shape) / chips


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b, t = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    kv_bytes = 1 + 2.0 / hd if cfg.kv_quant else BF16  # int8 + bf16 scales
    if cfg.family == "ssm":
        di = int(cfg.proj_factor * cfg.d_model)
        dh = di // cfg.num_heads
        per = cfg.slstm_every
        n_m = cfg.num_layers * (per - 1) // per
        return b * n_m * cfg.num_heads * dh * dh * FP32
    if cfg.family == "hybrid":
        attn_l = _attn_layers(cfg)
        rec_l = cfg.num_layers - attn_l
        w = min(t, cfg.local_window)
        return (attn_l * b * w * cfg.num_kv_heads * hd * 2 * BF16
                + rec_l * b * cfg.d_rnn * FP32)
    layers = cfg.num_layers
    return layers * b * t * cfg.num_kv_heads * hd * 2 * kv_bytes


# --------------------------------------------------------------------------
# Collective traffic (per device wire bytes, per axis)
# --------------------------------------------------------------------------
def analytic_collective_bytes(
    cfg: ModelConfig, shape: ShapeConfig, n_params: int,
    parallel: ParallelConfig, mesh_axes: dict[str, int],
) -> dict[str, float]:
    """Per-NPU wire bytes per mesh axis (the paper's N_K)."""
    tp = mesh_axes.get("model", 1)
    data = mesh_axes.get("data", 1)
    pods = mesh_axes.get("pod", 1)
    dp = data * pods
    d = cfg.d_model
    b_loc = max(shape.global_batch // dp, 1)
    out: dict[str, float] = {a: 0.0 for a in mesh_axes if mesh_axes[a] > 1}

    def add(axis, nbytes):
        if axis in out:
            p = mesh_axes[axis]
            out[axis] += (p - 1) / p * nbytes

    if shape.kind == "train":
        # DP gradient sync: hierarchical RS+AG over (data, pod) of the
        # TP-sharded grad buffer (fp32) — chunk shrinks across dims like the
        # paper's Fig. 5.
        shard = n_params / tp * FP32
        add("data", 2 * shard)
        add("pod", 2 * shard / data)
        if parallel.fsdp:
            add("data", 3 * n_params / tp * BF16)  # AG fwd + AG bwd + RS grads
        # TP activation collectives: ~4 per layer (2 fwd + 2 bwd)
        act = b_loc * shape.seq_len * d * BF16
        add("model", 4 * cfg.num_layers * act)
        if cfg.family == "moe":
            # EP all-to-all: dispatch+combine, fwd+bwd
            a2a = b_loc * shape.seq_len * cfg.experts_per_token * d * BF16
            add("model", 4 * a2a)
    else:
        act = b_loc * shape.seq_len * d * BF16
        if shape.kind == "prefill":
            add("model", 2 * cfg.num_layers * act)
            if cfg.family == "moe":
                add("model", 2 * b_loc * shape.seq_len *
                    cfg.experts_per_token * d * BF16)
        else:  # decode: one token
            tok = b_loc * 1 * d * BF16
            add("model", 2 * cfg.num_layers * tok)
            if cfg.family == "moe":
                add("model", 2 * b_loc * cfg.experts_per_token * d * BF16)
    return out


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    per_axis_s: dict[str, float]
    model_flops: float
    analytic_flops: float
    hlo_flops: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound step time (the perf score):
        (MODEL_FLOPS / peak) / max(compute, memory, collective)."""
        return (self.compute_s / self.step_time_s) * (
            self.model_flops / self.analytic_flops)


def compute_roofline(
    cfg: ModelConfig, shape: ShapeConfig, n_params: int,
    parallel: ParallelConfig, mesh_axes: dict[str, int],
    hlo_flops: float = 0.0,
) -> Roofline:
    chips = 1
    for v in mesh_axes.values():
        chips *= v
    flops = analytic_flops(cfg, shape)
    n_act = active_params(cfg, n_params)
    mf = model_flops_6nd(cfg, shape, n_params, n_act)
    compute_s = flops / (chips * PEAK_FLOPS)
    mem = analytic_hbm_bytes(cfg, shape, n_params, parallel, chips)
    memory_s = mem / HBM_BW
    per_axis = analytic_collective_bytes(cfg, shape, n_params, parallel, mesh_axes)
    per_axis_s = {
        a: v / (NET_BW if a == "pod" else NVLINK_BW) for a, v in per_axis.items()
    }
    collective_s = max(per_axis_s.values()) if per_axis_s else 0.0
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        per_axis_s=per_axis_s, model_flops=mf, analytic_flops=flops,
        hlo_flops=hlo_flops,
        useful_ratio=mf / flops if flops else 0.0,
    )
