"""Architecture registry of the port — importing this package registers its configs.

All ten architectures of the reference package are registered, with the
same fields; ``get_arch`` raises ``KeyError`` for any other name.
"""
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    granite_34b,
    internvl2_26b,
    llama3_8b,
    qwen2_5_3b,
    qwen2_5_14b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    whisper_medium,
    xlstm_1_3b,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_arch,
    list_archs,
)
