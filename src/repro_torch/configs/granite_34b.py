"""granite-34b [arXiv:2405.04324; hf] — llama-arch code model.

88L d_model=6144 48H (MQA: kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e4,
    gated_mlp=False,      # GPT-BigCode-style plain MLP (keeps params ~34B)
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    vocab_size=256,
)

register(CONFIG, REDUCED)
