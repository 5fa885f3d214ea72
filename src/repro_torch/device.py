"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. There
is no silent CPU run: asking for CUDA (or asking for nothing) where CUDA is
absent raises.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import torch

# The caching allocator's setting for a CUDA run, unless the caller made
# one (PYTORCH_ALLOC_CONF or PYTORCH_CUDA_ALLOC_CONF): expandable segments.
# With fixed segments an H100 ran out of memory in long_500k's prefill
# (recurrentgemma-2b, 1 x 524,288) with 17.6 GiB reserved but unallocated,
# and in train_4k's Themis step (qwen2.5-3b, 16 x 4096) with 7.4 GiB.
# It takes effect only where it is set before the process's first CUDA
# allocation.
CUDA_ALLOC_CONF = "expandable_segments:True"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    absent. ``meta`` (shapes only) is the dry run's device. For CUDA, sets
    ``CUDA_ALLOC_CONF`` where the environment holds no allocator setting."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not ({"PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF"}
                                   & os.environ.keys()):
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = CUDA_ALLOC_CONF
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
