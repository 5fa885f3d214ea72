"""xlstm-1.3b [arXiv:2405.04517] — sLSTM + mLSTM blocks.

48 blocks d_model=2048 4H vocab=50304, d_ff=0 (blocks carry their own
up-projections; proj_factor=2).  xLSTM[7:1] ratio: one sLSTM block per
8 blocks (6 sLSTM + 42 mLSTM).  Constant-size recurrent state ->
runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    proj_factor=2.0,
)

REDUCED = CONFIG.replace(
    num_layers=16,                 # two periods of (7 mLSTM + 1 sLSTM)
    d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256,
)

register(CONFIG, REDUCED)
