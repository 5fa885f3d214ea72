"""The port's collectives and Themis step over ``torch.distributed`` against
the reference, on 8 gloo ranks on the CPU.

One spawn of 8 processes (a ``file://`` store in ``tmp_path``, a join
timeout) runs every multi-rank check, as ``tests/multidevice_checks.py``
runs the reference's on 8 virtual devices:

- ``chunked_all_reduce`` over a (pod 2, data 2, model 2) mesh with mixed
  per-chunk orders, one forced to ("pod", "model", "data"): every rank
  holds the sum within 1e-3 (8-way fp32 sums in another order);
- the int8 reduce-scatter over an 8-rank axis: mean relative error < 0.05;
- the Themis ZeRO-2 step on reduced qwen2.5-3b (fp32 activations,
  remat off, 4 chunks, 2 steps) against the reference's
  ``make_themis_train_step`` on 8 virtual devices, run in a subprocess from
  the same initial params and batch: the chunk orders equal; losses and
  gnorms within 1e-5 relative; each rank's master/m/v shard against its
  block of the reference's global arrays (master within 1e-2 of its update's
  L2 and 0.1 lr per element, m and v within 1e-4 relative L2); params
  likewise;
- the int8 Themis step on reduced llama3-8b over a (data 2, model 4) mesh:
  the loss falls in 6 steps (``multidevice_checks.py``'s check).

The int8 codes of ``_quantize`` are compared with the reference's on the
same input in this process.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
LR = 1e-3

# The reference's Themis step on 8 virtual CPU devices; writes its initial
# params, orders, metrics and final state to the .npz named in argv[1].
REFERENCE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import ParallelConfig, TrainConfig, get_arch
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.train.step import make_themis_train_step

out = sys.argv[1]
lr = float(sys.argv[2])
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = get_arch("qwen2.5-3b", reduced=True).replace(remat=False, dtype="float32")
api = build_model(cfg)
tcfg = TrainConfig(learning_rate=lr, warmup_steps=1, total_steps=10)
step, init, orders = make_themis_train_step(
    api, mesh, ParallelConfig(data=2, model=2, pods=2, dp_sync="themis",
                              chunks_per_collective=4), tcfg)
params, opt = init(0)
res = {f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
res["master0"] = np.asarray(opt["master"])
rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
res.update(batch)
losses, gnorms = [], []
for _ in range(2):
    params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    losses.append(float(m["loss"]))
    gnorms.append(float(m["gnorm"]))
res.update({f"final_p{i}": np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(params))})
for k in ("master", "m", "v"):
    res[k] = np.asarray(opt[k])
res["count"] = np.asarray(opt["count"])
res["losses"], res["gnorms"] = np.asarray(losses), np.asarray(gnorms)
res["orders"] = np.asarray(["->".join(o) for o in orders])
np.savez(out, **res)
"""


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_all_reduce(rank):
    from repro_torch.comms.hierarchical import chunked_all_reduce
    from repro_torch.comms.schedule_bridge import themis_axis_orders
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert mesh.block_index(("pod", "data", "model")) == rank
    n = 1234
    orders = themis_axis_orders({"pod": 2, "data": 2, "model": 2}, n * 4, 6,
                                "themis")
    orders[0] = ("pod", "model", "data")
    x = np.random.default_rng(0).standard_normal((WORLD, n)).astype(np.float32)
    got = chunked_all_reduce(torch.from_numpy(x[rank]), orders, mesh,
                             mean=False)
    np.testing.assert_allclose(got.numpy(), x.sum(0), rtol=1e-3, atol=1e-3)
    return {"distinct_orders": len(set(orders))}


def _check_int8_reduce_scatter(rank):
    import torch.distributed as dist

    from repro_torch.comms.hierarchical import int8_reduce_scatter_axis
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((WORLD,), ("data",), "cpu")
    n = 64 * WORLD
    x = np.random.default_rng(1).standard_normal((WORLD, n)).astype(np.float32)
    got = int8_reduce_scatter_axis(torch.from_numpy(x[rank]), "data", mesh)
    want = x.sum(0)[rank * 64:(rank + 1) * 64]
    rel = torch.tensor(float((np.abs(got.numpy() - want)
                              / (np.abs(want) + 1e-3)).sum()))
    dist.all_reduce(rel)
    mean = float(rel) / n
    assert mean < 0.05, f"int8 RS error too large: {mean}"
    return {"int8_rs_mean_rel_err": mean}


def _check_themis_step(rank, ref_path):
    from repro_torch import bridge
    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.data.pipeline import local_rows
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves
    from repro_torch.train.step import make_themis_train_step

    ref = dict(np.load(ref_path))
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    cfg = get_arch("qwen2.5-3b", reduced=True).replace(remat=False,
                                                      dtype="float32")
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    step, init_state, orders = make_themis_train_step(
        api, mesh, ParallelConfig(data=2, model=2, pods=2, dp_sync="themis",
                                  chunks_per_collective=4), tcfg)
    assert ["->".join(o) for o in orders] == list(ref["orders"])
    params = api.init(0, "cpu")
    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            p.copy_(torch.from_numpy(ref[f"p{i}"]))
    params, opt = init_state(params=params)
    axes = ("model", "data", "pod")                 # the step's dp axes
    master0 = bridge.opt_state_from_jax(
        {"master": ref["master0"]}, "cpu",
        block=(mesh.block_index(axes), mesh.size))["master"].numpy()
    assert np.array_equal(opt["master"].numpy(), master0)
    batch = {k: torch.from_numpy(v) for k, v in
             local_rows({"tokens": ref["tokens"], "labels": ref["labels"]},
                        mesh).items()}
    losses, gnorms = [], []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(gnorms, ref["gnorms"], rtol=1e-5)
    want = bridge.opt_state_from_jax(
        {k: ref[k] for k in ("master", "m", "v", "count")}, "cpu",
        block=(mesh.block_index(axes), mesh.size))
    assert opt["count"] == want["count"] == 2
    master, wmaster = opt["master"].numpy(), want["master"].numpy()
    upd = np.linalg.norm(wmaster - master0)
    errs = {"master_diff_over_update": float(np.linalg.norm(master - wmaster)
                                             / upd),
            "master_max_abs_over_lr": float(np.abs(master - wmaster).max() / LR)}
    for k in ("m", "v"):
        errs[f"{k}_rel_l2"] = _rel_l2(opt[k].numpy(), want[k].numpy())
    p_diff = 0.0
    for i, p in enumerate(leaves(params)):
        a, b, c = p.detach().numpy(), ref[f"final_p{i}"], ref[f"p{i}"]
        p_diff = max(p_diff, float(np.linalg.norm(a - b) / np.linalg.norm(b - c)))
        assert np.abs(a - b).max() <= 0.1 * LR
    errs["params_diff_over_update"] = p_diff
    assert errs["master_diff_over_update"] <= 1e-2, errs
    assert errs["master_max_abs_over_lr"] <= 0.1, errs
    assert errs["m_rel_l2"] <= 1e-4 and errs["v_rel_l2"] <= 1e-4, errs
    assert p_diff <= 1e-2, errs
    return {"losses": losses, "gnorms": gnorms, **errs}


def _check_int8_step(rank):
    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.data.pipeline import local_rows
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import make_themis_train_step

    mesh = Mesh((2, 4), ("data", "model"), "cpu")
    cfg = get_arch("llama3-8b", reduced=True).replace(remat=False)
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10,
                       weight_decay=0.0)
    step, init_state, _ = make_themis_train_step(
        api, mesh, ParallelConfig(data=2, model=4, dp_sync="themis",
                                  chunks_per_collective=2, compression="int8"),
        tcfg)
    params, opt = init_state(0, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
    batch = {k: torch.from_numpy(v) for k, v in local_rows(batch, mesh).items()}
    losses = []
    for _ in range(6):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], f"int8 training diverged: {losses}"
    return {"int8_losses": losses}


def _worker(rank, store, ref_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        res = {"all_reduce": _check_all_reduce(rank),
               "int8_rs": _check_int8_reduce_scatter(rank),
               "themis_step": _check_themis_step(rank, ref_path),
               "int8_step": _check_int8_step(rank)}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _run_reference(path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, str(path),
                           str(LR)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_quantize_codes_equal_reference():
    import jax.numpy as jnp

    from repro.comms.hierarchical import _quantize as jquantize
    from repro_torch.comms.hierarchical import _quantize

    x = (np.random.default_rng(2).standard_normal(4096) * 3).astype(np.float32)
    x[7] = 0.0
    q, s = _quantize(torch.from_numpy(x))
    jq, js = jquantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.mark.slow
def test_eight_gloo_ranks_match_reference(tmp_path):
    import torch.multiprocessing as mp

    ref_path = tmp_path / "reference.npz"
    _run_reference(ref_path)
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "store"),
                                            str(ref_path), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("8-rank gloo run did not finish in 300 s")
    assert all(not p.is_alive() for p in ctx.processes)
    results = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    assert results[0]["all_reduce"]["distinct_orders"] >= 1
    # every rank agrees on the pmean'd loss and the all-reduced gnorm
    assert len({tuple(r["themis_step"]["losses"]) for r in results}) == 1
    assert len({tuple(r["themis_step"]["gnorms"]) for r in results}) == 1
    assert len({tuple(r["int8_step"]["int8_losses"]) for r in results}) == 1
