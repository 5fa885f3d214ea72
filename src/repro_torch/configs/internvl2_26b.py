"""internvl2-26b [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT vision frontend is a STUB: the model takes precomputed patch
embeddings (batch, num_patches, d_model), prepended to the text sequence
(``launch/serve.py::synthetic_batch`` draws them from a seed).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    num_patches=256,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, num_patches=16,
)

register(CONFIG, REDUCED)
