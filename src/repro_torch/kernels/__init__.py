"""The port's hand-written Hopper kernels, their plain versions and launch counts.

K1 flash attention forward (CUDA C++, ``csrc/flash_attention.cu``), K2
RMSNorm (Triton, ``rmsnorm.py``) and K3 the RG-LRU scan (CUDA C++,
``csrc/rglru_scan.cu``). Each wrapper adds one to its module's
``launches`` where it launches its kernel, and nowhere else.
"""
from repro_torch.kernels import flash_attention, rglru, rmsnorm

_MODULES = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "rglru_scan": rglru}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
