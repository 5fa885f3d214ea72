"""Architecture registry of the port — importing this package registers its configs.

Only the architectures whose model family the port runs are registered;
``get_arch`` raises ``KeyError`` for any other name.
"""
from repro_torch.configs import llama3_8b, qwen2_5_3b, recurrentgemma_2b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    get_arch,
    list_archs,
)
