"""The port's hand-written Hopper kernels, their plain versions and launch counts.

K1 flash attention forward (CUDA C++: ``csrc/flash_attention_sm90.cu`` for
bf16 at head dim 64-256, ``csrc/flash_attention.cu`` otherwise), K2
RMSNorm (Triton, ``rmsnorm.py``) and K3 the RG-LRU scan (CUDA C++,
``csrc/rglru_scan.cu``). Each wrapper adds one to its module's
``launches`` where it launches its kernel, and nowhere else;
``flash_attention_sm90`` counts the K1 launches that took the sm90 kernel,
and ``flash_attention`` stays the total.
"""
from repro_torch.kernels import flash_attention, rglru, rmsnorm

_MODULES = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
            "rglru_scan": rglru}


def launch_counts() -> dict[str, int]:
    counts = {name: mod.launches for name, mod in _MODULES.items()}
    counts["flash_attention_sm90"] = flash_attention.launches_sm90
    return counts


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    flash_attention.launches_sm90 = 0
