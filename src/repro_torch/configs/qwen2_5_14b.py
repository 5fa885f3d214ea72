"""qwen2.5-14b [hf:Qwen/Qwen2.5 family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    rope_theta=1e6,
    qkv_bias=True,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256,
)

register(CONFIG, REDUCED)
