"""Synthetic, deterministic token pipeline with host prefetch (port of
``repro/data/pipeline.py``).

The stream is seeded and step-indexed (``np.random.default_rng((seed,
step))``), so its batches are byte-equal to the reference's. Each process
takes only its rank's rows of the global batch (``local_rows``): a
background thread cuts them, puts them in pinned memory on a CUDA run, and
the consumer copies them to the device with ``non_blocking=True``.
"""
from __future__ import annotations

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


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of every array of ``batch`` (the whole batch on a
    one-rank mesh)."""
    if mesh is None or mesh.size == 1:
        return batch
    i = mesh.block_index(BATCH_AXES)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.size:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{mesh.size} ranks")
        n = v.shape[0] // mesh.size
        out[k] = v[i * n:(i + 1) * n]
    return out


class Prefetcher:
    """Background-thread prefetch of this rank's rows and their copy to
    ``device`` (straggler hiding). Iterates ``(step, batch)``; ``close()``
    stops the thread. ``fixed_step`` serves that step's batch at every
    step (an overfitting check)."""

    def __init__(self, dataset: SyntheticLM, mesh, device, start_step: int = 0,
                 depth: int = 2, fixed_step: int | None = None):
        self.dataset = dataset
        self.mesh = mesh
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
        for k, v in local_rows(self.dataset.batch_at(src), self.mesh).items():
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
