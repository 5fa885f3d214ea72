"""Synthetic, deterministic token pipeline with host prefetch (port of
``repro/data/pipeline.py``).

The stream is seeded and step-indexed (``np.random.default_rng((seed,
step))``), so its batches are byte-equal to the reference's. Each process
takes only its rank's rows of the global batch (``local_rows``): a
background thread cuts them, puts them in pinned memory on a CUDA run, and
the consumer copies them to the device with ``non_blocking=True``.

The rows follow the step's batch spec: the Themis step's
``P(("model", "data", "pod"))`` (``BATCH_AXES``), or the GSPMD step's
``batch_pspec`` ((pod, data) split, "model" replicated), which
``rows_to_dtensor`` wraps as the DTensor that step takes.
"""
from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

# the reference's batch spec P(("model", "data", "pod")): "model" is the
# major axis of the split of the batch dim
BATCH_AXES = ("model", "data", "pod")


@dataclass
class SyntheticLM:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(
            0, self.vocab_size, (self.global_batch, self.seq_len + 1),
            dtype=np.int32,
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _gspmd_axes(v, mesh) -> tuple[str, ...]:
    from repro_torch.sharding.specs import _names, batch_pspec

    return tuple(_names(batch_pspec(tuple(v.shape), mesh, v.shape[0])[0]))


def local_rows(batch: dict, mesh, dp_sync: str = "themis") -> dict:
    """This rank's rows of every array of ``batch`` (the whole batch on a
    one-rank mesh): split over ``BATCH_AXES`` for the Themis step, over
    ``batch_pspec``'s axes for ``dp_sync="gspmd"`` (all rows where the
    batch does not divide)."""
    if mesh is None or mesh.size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        axes = BATCH_AXES if dp_sync != "gspmd" else _gspmd_axes(v, mesh)
        parts = math.prod(mesh.axis_size(a) for a in axes)
        if v.shape[0] % parts:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{parts} ranks")
        i = mesh.block_index(axes)
        n = v.shape[0] // parts
        out[k] = v[i * n:(i + 1) * n]
    return out


def rows_to_dtensor(rows: dict, mesh, global_batch: int) -> dict:
    """This rank's ``local_rows(..., dp_sync="gspmd")`` of a global batch of
    ``global_batch`` rows as DTensors on ``batch_pspec``'s placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.specs import batch_pspec, placements

    out = {}
    for k, v in rows.items():
        shape = (global_batch, *v.shape[1:])
        pls = placements(batch_pspec(shape, mesh, global_batch), mesh)
        out[k] = DTensor.from_local(v, mesh.device_mesh, pls, run_check=False)
    return out


class Prefetcher:
    """Background-thread prefetch of this rank's rows and their copy to
    ``device`` (straggler hiding). Iterates ``(step, batch)``; ``close()``
    stops the thread. ``fixed_step`` serves that step's batch at every
    step (an overfitting check)."""

    def __init__(self, dataset: SyntheticLM, mesh, device, start_step: int = 0,
                 depth: int = 2, fixed_step: int | None = None,
                 dp_sync: str = "themis"):
        self.dataset = dataset
        self.mesh = mesh
        self.dp_sync = dp_sync
        self.device = torch.device(device)
        self.fixed_step = fixed_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host(self, step: int) -> dict:
        src = step if self.fixed_step is None else self.fixed_step
        out = {}
        for k, v in local_rows(self.dataset.batch_at(src), self.mesh,
                                self.dp_sync).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._host(step))
            except Exception as e:       # hand the failure to the consumer
                item = (None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, host = self._q.get()
        if step is None:
            raise RuntimeError("prefetch worker failed") from host
        return step, {k: v.to(self.device, non_blocking=True)
                      for k, v in host.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
