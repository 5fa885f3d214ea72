"""Architecture registry of the port — importing this package registers its configs.

Only the architectures whose model family the port runs are registered;
``get_arch`` raises ``KeyError`` for any other name.
"""
from repro_torch.configs import (  # noqa: F401
    granite_34b,
    llama3_8b,
    qwen2_5_3b,
    qwen2_5_14b,
    recurrentgemma_2b,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_arch,
    list_archs,
)
