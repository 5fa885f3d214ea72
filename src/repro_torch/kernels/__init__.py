"""The port's hand-written Hopper kernels, their plain versions and launch counts.

K1 flash attention forward (CUDA C++, ``csrc/flash_attention.cu``) and K2
RMSNorm (Triton, ``rmsnorm.py``). Each wrapper adds one to its module's
``launches`` where it launches its kernel, and nowhere else.
"""
from repro_torch.kernels import flash_attention, rmsnorm

_MODULES = {"flash_attention": flash_attention, "rmsnorm": rmsnorm}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
