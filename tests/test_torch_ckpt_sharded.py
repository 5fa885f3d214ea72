"""Checkpoints of multi-rank runs of the port, on 4 gloo ranks.

One spawn runs every check; each is a case of its own:

- ``gspmd_reshard``: a sharded GSPMD state (params and ZeRO-1 m/v as
  DTensors) saved on a (data 2, model 2) mesh after one step restores onto
  a (data 1, model 4) mesh, and onto plain single-device tensors on one
  rank, equal to the bit to the saved state gathered whole;
- ``gspmd_resume``: ``launch/train.py --mesh 2x2 --dp-sync gspmd
  --ckpt-dir`` interrupted in its third step resumes from the checkpoint
  of step 2 and ends equal to the bit to the uninterrupted run;
- ``themis_same_mesh``: the Themis state (each rank's master/m/v shard)
  saved in the reference's global layout restores onto its own mesh equal
  to the bit, and ``check_themis`` refuses it for a mesh of another world
  size;
- ``themis_resume``: the launcher's Themis run on 2x2 resumes to the bit.

Apart from the spawn, ``torchrun --standalone --nproc-per-node 2``
runs ``launch/train.py --mesh 2x1 --ckpt-dir`` twice: the second run
resumes from the first's last checkpoint.
"""
import os
import subprocess
import sys

import pytest

from _gloo_ranks import ROOT, check_case, run_checks, spawn, sub_mesh

WORLD = 4
TRAIN_ARGS = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
              "--seq", "16", "--log-every", "1", "--lr", "1e-2"]


def _equal(a, b):
    import torch

    return bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))


def _check_gspmd_reshard(tmp):
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import restore, save
    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves
    from repro_torch.sharding.specs import gather
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import gspmd_init_state, make_gspmd_train_step

    cfg = get_arch("qwen2.5-3b", reduced=True).replace(remat=False,
                                                       dtype="float32")
    api = build_model(cfg)
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    par = ParallelConfig(data=2, model=2)
    params, opt = gspmd_init_state(api, mesh, par, 0, "cpu")
    step = make_gspmd_train_step(api, mesh, par, TrainConfig(learning_rate=1e-2))
    batch = {"tokens": torch.arange(64).reshape(4, 16) % cfg.vocab_size,
             "labels": torch.arange(1, 65).reshape(4, 16) % cfg.vocab_size}
    params, opt, _ = step(params, opt, batch)
    path = os.path.join(tmp, "gspmd_reshard")
    save(path, 1, (params, opt))
    want = [x for x in leaves(gather((params, opt)))]
    mesh14 = Mesh((1, 4), ("data", "model"), "cpu")
    p14, o14 = gspmd_init_state(api, mesh14, ParallelConfig(model=4), 1, "cpu")
    (p14, o14), _ = restore(path, (p14, o14))
    got = leaves(gather((p14, o14)))
    assert all(_equal(a, b) for a, b in zip(got, want))
    # the (1, 4) mesh cuts the leaves otherwise than the (2, 2) one
    assert any(a.to_local().shape != b.to_local().shape
               for a, b in zip(leaves((p14, o14)), leaves((params, opt))))
    if dist.get_rank() == 0:
        plain = api.init(2, "cpu")
        (plain, popt), _ = restore(path, (plain, adamw_init(plain)))
        assert all(_equal(a, b) for a, b in zip(leaves((plain, popt)), want))
    return {"leaves": len(want)}


def _crash_at(n):
    def on_step(step, metrics):
        if step == n:
            raise RuntimeError("interrupted")
    return on_step


def _check_resume(tmp, dp_sync):
    from repro_torch.ckpt import latest_step
    from repro_torch.launch import train as ttrain
    from repro_torch.models.registry import leaves
    from repro_torch.sharding.specs import gather

    argv = TRAIN_ARGS + ["--mesh", "2x2", "--dp-sync", dp_sync]
    whole = ttrain.main(argv)
    path = os.path.join(tmp, f"resume_{dp_sync}")
    ck = argv + ["--ckpt-dir", path, "--ckpt-every", "2"]
    try:
        ttrain.main(ck, on_step=_crash_at(2))
        raise AssertionError("the run was not interrupted")
    except RuntimeError as e:
        assert "interrupted" in str(e)
    assert latest_step(path) == 2
    res = ttrain.main(ck)
    assert res["start_step"] == 2 and res["restored"]["step"] == 2
    assert res["losses"] == whole["losses"][2:]
    a, b = gather(res["params"]), gather(whole["params"])
    assert all(_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    if dp_sync == "themis":
        for k in ("master", "m", "v"):
            assert _equal(res["opt"][k], whole["opt"][k])
    else:
        a, b = gather(res["opt"]), gather(whole["opt"])
        assert all(_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    return {"losses": res["losses"]}


def _check_themis_same_mesh(tmp):
    import torch

    from repro_torch.ckpt import (
        check_themis,
        read_extra,
        restore,
        save,
        themis_global,
        themis_local,
        themis_record,
    )
    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.train.step import make_themis_train_step

    cfg = get_arch("llama3-8b", reduced=True).replace(remat=False)
    api = build_model(cfg)
    mesh = Mesh((2, 2), ("data", "model"), "cpu")
    par = ParallelConfig(data=2, model=2, dp_sync="themis", chunks_per_collective=3)
    step, init_state, orders = make_themis_train_step(
        api, mesh, par, TrainConfig(learning_rate=1e-2))
    params, opt = init_state(0, "cpu")
    batch = {"tokens": torch.arange(32).reshape(2, 16) % cfg.vocab_size,
             "labels": torch.arange(1, 33).reshape(2, 16) % cfg.vocab_size}
    params, opt, _ = step(params, opt, batch)
    path = os.path.join(tmp, "themis_same_mesh")
    save(path, 1, (params, themis_global(opt, mesh)),
         extra={"themis": themis_record(mesh, orders)})
    fresh_p, fresh = init_state(3, "cpu")
    check_themis(read_extra(path), mesh, orders)
    (fresh_p, state), _ = restore(path, (fresh_p, themis_global(fresh, mesh)))
    themis_local(state, fresh, mesh)
    for k in ("master", "m", "v"):
        assert _equal(fresh[k], opt[k])
    assert fresh["count"] == opt["count"] == 1
    small = sub_mesh((2, 1), ("data", "model"))
    try:
        check_themis(read_extra(path), small, orders)
        raise AssertionError("a mesh of 2 ranks took a 4-rank Themis checkpoint")
    except ValueError:
        pass
    return {"orders": themis_record(mesh, orders)["orders"]}


def _worker(rank, store, out_dir):
    run_checks(rank, WORLD, store, out_dir, [
        ("gspmd_reshard", lambda: _check_gspmd_reshard(out_dir)),
        ("gspmd_resume", lambda: _check_resume(out_dir, "gspmd")),
        ("themis_same_mesh", lambda: _check_themis_same_mesh(out_dir)),
        ("themis_resume", lambda: _check_resume(out_dir, "themis")),
    ])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn(_worker, WORLD, tmp_path_factory.mktemp("ckpt_sharded"))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["gspmd_reshard", "gspmd_resume",
                                  "themis_same_mesh", "themis_resume"])
def test_multi_rank_checkpoints(results, name):
    check_case(results, name)


@pytest.mark.slow
def test_launch_train_mesh_2x1_ckpt_dir_under_torchrun(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--reduced", "--device", "cpu", "--mesh", "2x1", "--batch", "4",
           "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
           "--log-every", "1"]
    outs = []
    for steps in ("2", "4"):
        proc = subprocess.run(cmd + ["--steps", steps], env=env, cwd=tmp_path,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        outs.append(proc.stdout)
    assert "resumed from step 2 (data cursor -> 2)" in outs[1]
    assert sorted(os.listdir(tmp_path / ".." / tmp_path.name)) == [
        "MANIFEST.json", "step-00000002", "step-00000004"]
