"""What the ctypes-bound kernels' wrappers share: the checks of the tensors
handed to a kernel, the meta test of the dry run, and the pointer of an
optional tensor. Used by ``slstm.py`` and ``mlstm.py``."""
from __future__ import annotations

import torch


def _check(named: dict, dt, fp32: tuple, what):
    """Raise unless the tensors ``named`` (None: absent) lie on one CUDA
    device, are contiguous and 16-byte aligned, and are in ``dt`` (bf16 or
    fp32), those named in ``fp32`` in fp32."""
    named = {k: v for k, v in named.items() if v is not None}
    first = next(iter(named.values()))
    if not (first.is_cuda and all(x.device == first.device for x in named.values())):
        raise ValueError(f"{what}: {', '.join(named)} must lie on one CUDA device "
                         f"(got {[str(x.device) for x in named.values()]})")
    if dt not in (torch.bfloat16, torch.float32) or any(
            x.dtype != (torch.float32 if k in fp32 else dt) for k, x in named.items()):
        raise ValueError(f"{what}: {', '.join(k for k in named if k not in fp32)} must "
                         f"share bf16 or fp32 and {', '.join(fp32)} be fp32 (got "
                         f"{[x.dtype for x in named.values()]})")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in named.values()):
        raise ValueError(f"{what}: {', '.join(named)} must be contiguous and 16-byte "
                         "aligned")


def _on_meta(*xs):
    return all(x is None or x.is_meta for x in xs)


def _ptr(x):
    return None if x is None else x.data_ptr()
