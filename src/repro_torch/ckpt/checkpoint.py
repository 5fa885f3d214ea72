"""Atomic, resumable checkpoints (port of ``repro/ckpt/checkpoint.py``).

The on-disk format is the reference's, so either package restores the
other's checkpoints:

* ``<dir>/tmp-<step>`` is written, then renamed to ``<dir>/step-%08d``;
* ``arrays.npz`` holds ``leaf_{i}``, the state's leaves in
  ``registry.leaves`` order (dict keys sorted, lists and tuples in order:
  the order of ``jax.tree.leaves``);
* ``meta.json`` holds ``step``, ``num_leaves``, ``paths``, ``time`` and
  ``extra`` (the trainer keeps its data cursor in ``extra["next_step"]``);
* ``MANIFEST.json`` (``{"latest_step": n}``) is written last, through a
  ``.tmp`` file and a rename, so a crash mid-write leaves the previous
  checkpoint the latest valid one; a manifest ahead of the data falls back
  to the newest ``step-*`` directory;
* only the newest ``keep`` checkpoints stay.

A state is nested dicts, lists and tuples of tensors and Python ints (the
port keeps the optimizer's step count on the host, where the reference
keeps a 0-d int32 array; an int is written as one). Each file is fsynced
before its rename. Unlike the reference:

* bfloat16 tensors are written as float32, which holds them exactly (numpy
  has no bfloat16 of its own), and cast back on restore;
* ``restore`` copies into the tensors of ``state_like`` in place, on their
  devices and in their dtypes: a second copy of a 3B model's params, m and
  v would not fit the card beside the first. There is no resharding: each
  process holds its whole state on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.registry import leaves


def _paths(tree: Any, prefix: tuple = ()) -> list[str]:
    """Each leaf's path, keys and indices joined by "/", as the reference
    writes them (``0/blocks/attn/wq`` for params in a (params, opt) tuple)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (i,))]
    return ["/".join(str(p) for p in prefix)]


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, complete on return)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")


def _write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, state, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``state`` as checkpoint ``step``; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host = [_to_host(x) for x in leaves(state)]
    _write(os.path.join(tmp, "arrays.npz"), lambda f: np.savez(
        f, **{f"leaf_{i}": a for i, a in enumerate(host)}))
    meta = {"step": step, "num_leaves": len(host), "paths": _paths(state),
            "time": time.time(), "extra": extra or {}}
    _write(os.path.join(tmp, "meta.json"),
           lambda f: f.write(json.dumps(meta).encode()))
    os.replace(tmp, final)
    _update_manifest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def _update_manifest(ckpt_dir: str, step: int) -> None:
    manifest = os.path.join(ckpt_dir, "MANIFEST.json")
    tmp = manifest + ".tmp"
    _write(tmp, lambda f: f.write(json.dumps({"latest_step": step}).encode()))
    os.replace(tmp, manifest)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The manifest's step if its directory exists, else the newest
    ``step-*`` directory (a manifest ahead of a partial write), else None."""
    manifest = os.path.join(ckpt_dir, "MANIFEST.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        step = json.load(f)["latest_step"]
    if os.path.exists(os.path.join(ckpt_dir, f"step-{step:08d}")):
        return step
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step-"))
    return steps[-1] if steps else None


def _fill(tree, values):
    """``tree`` rebuilt with its leaves taken from the iterator ``values``."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, values) for v in tree)
    return next(values)


@torch.no_grad()
def restore(ckpt_dir: str, state_like, *, step: int | None = None):
    """Load checkpoint ``step`` (default: the latest) into the structure of
    ``state_like``: each tensor is overwritten in place, each int replaced.
    Returns (state, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    targets = leaves(state_like)
    if len(targets) != meta["num_leaves"]:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, "
                         f"expected {len(targets)}")
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for i, ref in enumerate(targets):
            a = arrays[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i} ({meta['paths'][i]}): shape "
                                     f"{a.shape} in the checkpoint, "
                                     f"{tuple(ref.shape)} expected")
                ref.copy_(torch.from_numpy(a))
                out.append(ref)
            else:
                out.append(int(a))
    return _fill(state_like, iter(out)), meta["extra"]


class AsyncCheckpointer:
    """Snapshot to host memory, then write in a background thread.

    ``save_async`` returns once its host copy is complete, so the caller may
    update the state in place right after. A failed write raises from the
    next ``save_async`` or ``wait``. ``saves`` records, per checkpoint, its
    step, bytes, the seconds the caller waited for the previous write and
    for the host copy, and the seconds the write took."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.saves: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save_async(self, step: int, state, extra: dict | None = None) -> None:
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        host = _fill(state, iter([_to_host(x) for x in leaves(state)]))
        record = {"step": step, "bytes": sum(a.nbytes for a in leaves(host)),
                  "wait_s": t1 - t0, "snapshot_s": time.perf_counter() - t1}
        self.saves.append(record)

        def work():
            t = time.perf_counter()
            try:
                save(self.ckpt_dir, step, host, extra=extra, keep=self.keep)
            except Exception as e:      # handed to the next wait()
                self._error = e
            record["write_s"] = time.perf_counter() - t

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
