"""whisper-medium [arXiv:2212.04356] — encoder-decoder, conv frontend stub.

24L enc + 24L dec, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865.
The conv1d/mel frontend is a STUB: the encoder takes precomputed frame
embeddings (batch, 1500, d_model) (``launch/serve.py::synthetic_batch``
draws them from a seed).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_frames=1500,
    rope_theta=1e4,                # (whisper uses learned abs pos; we use RoPE-free sinusoidal)
)

REDUCED = CONFIG.replace(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, num_frames=30,
)

register(CONFIG, REDUCED)
