"""recurrentgemma-2b [arXiv:2402.19427; hf] — Griffin: RG-LRU + local attn.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.  Block pattern:
two RG-LRU residual blocks then one local-attention block (1:2 attn:rec),
sliding window 2048.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=1e4,
    block_pattern=("rec", "rec", "attn"),
    d_rnn=2560,
    conv_width=4,
    local_window=2048,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    num_layers=5,                      # one full period + tail (rec, rec)
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=256, d_rnn=64, local_window=32,
)

register(CONFIG, REDUCED)
