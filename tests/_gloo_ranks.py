"""Shared harness of the port's multi-rank tests: one reference run in a
JAX subprocess on virtual CPU devices, one spawn of gloo ranks on the CPU,
each check reported as its own case; ``sub_mesh`` lays a smaller mesh over
the first ranks of the spawn.

``run_reference(script, path, spec, devices)`` runs ``script`` with
``argv[1] = path`` (an .npz it writes) and ``argv[2] = repr(spec)`` under
``--xla_force_host_platform_device_count=devices``;
``run_references(script, path, specs, devices)`` runs one such process per
spec, all at once, and merges their arrays into ``path``. ``spawn(worker, world,
tmp, args)`` starts ``worker(rank, store, out_dir, *args)`` on ``world``
ranks (a ``file://`` store in ``tmp``, a join timeout) and returns each
rank's results. A worker calls ``run_checks(rank, out_dir, checks)``: it
starts the process group, runs each named check in order, and writes
``{name: {"ok": bool, "error": str, "value": ...}}``; a check that raises is
recorded and the rest still run.
"""
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def run_reference(script: str, path, spec, devices: int, timeout: int = 900):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", script, str(path), repr(spec)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]


def run_references(script: str, path, specs: list, devices: int,
                   timeout: int = 900):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    path = Path(path)
    parts = [path.with_name(f"{path.stem}.{i}.npz") for i in range(len(specs))]
    with ThreadPoolExecutor(len(specs)) as pool:
        for f in [pool.submit(run_reference, script, part, spec, devices,
                              timeout) for part, spec in zip(parts, specs)]:
            f.result()
    merged = {}
    for part in parts:
        merged.update(np.load(part))
    np.savez(path, **merged)


def spawn(worker, world: int, tmp, args=(), timeout: int = 600) -> list[dict]:
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    ctx = mp.start_processes(worker, args=(str(tmp / "store"), str(tmp), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world}-rank gloo run did not finish in {timeout} s")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


def run_checks(rank: int, world: int, store: str, out_dir: str, checks) -> None:
    """``checks``: (name, fn) pairs; ``fn()`` returns a JSON-able value."""
    import warnings

    import torch
    import torch.distributed as dist

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res = {}
    try:
        for name, fn in checks:
            try:
                res[name] = {"ok": True, "value": fn()}
            except Exception:
                res[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def sub_mesh(shape, names, device="cpu"):
    """A ``repro_torch`` ``Mesh`` over the first ``prod(shape)`` ranks of a
    larger process group, so that one spawn serves meshes of several
    sizes. Every rank of the group builds it (the ``DeviceMesh``'s groups
    are made collectively); ``dist.get_rank() < mesh.size`` tells a member.
    """
    import math

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import Mesh

    mesh = Mesh.__new__(Mesh)
    mesh.shape = dict(zip(names, shape))
    mesh.names = tuple(names)
    mesh.device = torch.device(device)
    mesh.size = math.prod(shape)
    mesh._dm = DeviceMesh(mesh.device.type,
                          torch.arange(mesh.size).reshape(tuple(shape)),
                          mesh_dim_names=tuple(names))
    return mesh


def check_case(results: list[dict], name: str) -> list:
    """Assert check ``name`` passed on every rank; returns its values."""
    bad = [(r, res.get(name, {"error": "not run"}).get("error"))
           for r, res in enumerate(results) if not res.get(name, {}).get("ok")]
    assert not bad, f"{name} failed on ranks {[r for r, _ in bad]}:\n{bad[0][1]}"
    return [res[name]["value"] for res in results]
