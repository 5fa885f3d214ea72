"""The port's hand-written Hopper kernels, their plain versions and launch counts.

K1 flash attention forward (CUDA C++: ``csrc/flash_attention_sm90.cu`` for
bf16 at head dim 64-256, ``csrc/flash_attention.cu`` otherwise) and
backward (``csrc/flash_attention_bwd_sm90.cu`` for bf16 at head dim 64,
128 and 256, ``csrc/flash_attention_bwd.cu`` otherwise), K2 RMSNorm forward and
backward (Triton, ``rmsnorm.py``), K3 the RG-LRU scan (CUDA C++,
``csrc/rglru_scan.cu``, forward and backward) and the sLSTM recurrence
(CUDA C++, ``csrc/slstm_scan.cu``, ``slstm.py``; the reference's
``jax.lax.scan``, no Pallas kernel). Each wrapper adds one to its count
where it launches its kernel, and nowhere else: ``flash_attention``,
``rmsnorm``, ``rglru_scan`` and ``slstm_scan`` count the forwards,
``flash_attention_bwd``, ``rmsnorm_bwd`` and ``rglru_scan_bwd`` the
backwards; ``flash_attention_sm90`` and
``flash_attention_bwd_sm90`` count the K1 launches that took an sm90
kernel, of the totals beside them.

On a meta tensor (the dry run, ``launch/dryrun.py``) each wrapper returns
empty outputs of its kernel's shapes and dtypes and adds the kernel's FLOPs
to its module's ``meta_flops`` (``meta_flops()`` sums them); it counts no
launch.
"""
from repro_torch.kernels import flash_attention, rglru, rmsnorm, slstm

_COUNTS = {"flash_attention": (flash_attention, "launches"),
           "rmsnorm": (rmsnorm, "launches"),
           "rglru_scan": (rglru, "launches"),
           "slstm_scan": (slstm, "launches"),
           "flash_attention_sm90": (flash_attention, "launches_sm90"),
           "flash_attention_bwd": (flash_attention, "launches_bwd"),
           "flash_attention_bwd_sm90": (flash_attention, "launches_bwd_sm90"),
           "rmsnorm_bwd": (rmsnorm, "launches_bwd"),
           "rglru_scan_bwd": (rglru, "launches_bwd")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTS.values():
        setattr(mod, attr, 0)


_META = (flash_attention, rmsnorm, rglru, slstm)


def meta_flops() -> int:
    """The FLOPs of the kernel calls on meta tensors since the last reset."""
    return sum(mod.meta_flops for mod in _META)


def reset_meta_flops() -> None:
    for mod in _META:
        mod.meta_flops = 0
