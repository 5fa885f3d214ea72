"""Move parameters and caches between the reference package and the port.

The two packages meet only through numpy: a test turns the reference's
params into nested dicts of numpy arrays and hands them here. This module
imports neither ``jax`` nor ``repro``. bfloat16 arrays (numpy's
``ml_dtypes`` extension type) travel as their raw 16 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a, device):
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device=None):
    """Nested dicts and lists of numpy arrays (the reference's param layout)
    -> the port's params: the same nesting, as tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return _to_tensor(tree, dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 widens to float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def cache_to_numpy(caches):
    """Nested dicts and lists of tensors -> the same nesting of arrays."""
    if isinstance(caches, dict):
        return {k: cache_to_numpy(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [cache_to_numpy(v) for v in caches]
    return to_numpy(caches)
