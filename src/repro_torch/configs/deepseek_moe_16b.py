"""deepseek-moe-16b [arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16 == MHA) moe_d_ff=1408 vocab=102400,
2 shared + 64 routed experts top-6 (fine-grained expert segmentation).
First layer uses a dense FFN (d_ff=10944) per the released model; we model
all layers MoE + shared experts, matching the dominant structure.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=1e4,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
)

REDUCED = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    num_shared_experts=1,
)

register(CONFIG, REDUCED)
