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


def opt_state_from_jax(opt: dict, device=None, *, block=None) -> dict:
    """The reference's optimizer state as numpy (nested dicts) -> the
    port's: the same keys as tensors on ``device``, ``count`` as an int.

    The GSPMD state is ``{"m", "v", "count"}`` with m and v shaped like the
    params. The Themis state holds global arrays whose devices own blocks:
    ``master``, ``m`` and ``v`` of (C, per_chunk) are split along their
    second dim, the int8 error feedback ``err`` of (world, n_params) along
    its first. ``block=(i, n)`` keeps block i of n of those, this rank's
    shard (``Mesh.block_index`` of the step's axes)."""
    dev = resolve_device(device)
    out = {}
    for key, val in opt.items():
        if key == "count":
            out[key] = int(np.asarray(val))
            continue
        if block is not None and not isinstance(val, dict):
            a = np.asarray(val)
            i, n = block
            if key in ("master", "m", "v"):
                w = a.shape[1] // n
                val = a[:, i * w:(i + 1) * w]
            elif key == "err" and a.ndim == 2:
                w = a.shape[0] // n
                val = a[i * w:(i + 1) * w].reshape(-1)
        out[key] = params_from_jax(val, dev)
    return out


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
