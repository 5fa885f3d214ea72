"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) moe_d_ff=1536 vocab=151936, MoE 128 experts
top-8.  235B total / ~22B active params.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # dense fallback width (unused; all-MoE layers)
    vocab_size=151936,
    rope_theta=1e6,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    qkv_bias=False,
    param_dtype="bfloat16",   # as the reference config: 235 B params, 470 GB in bf16
)

REDUCED = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
)

register(CONFIG, REDUCED)
