"""The port's checkpoints (``repro_torch.ckpt``) against the reference's on the
CPU.

- A checkpoint the reference writes (reduced llama3-8b with fp32
  activations, two steps of its GSPMD step) restores into the port leaf
  for leaf to the bit, and the port's steps 3-4 from it match the
  reference's unbroken steps 3-4: losses and gnorms within 1e-5 relative,
  params as ``test_torch_train.py``'s ``_params_close`` states (AdamW
  carries the fp32 rounding of a gradient element near eps into its update
  at full scale).
- A checkpoint the port writes restores into the reference's ``restore``,
  leaf for leaf to the bit, with the reference's paths (the hybrid's tail
  is a list), and the reference's steps from it match the port's.
- A resumed port run continues an unbroken one to the bit (losses and
  params), as ``tests/test_train_and_ckpt.py`` holds the reference; the
  one-rank Themis optimizer layout (fp32 master, m, v, error feedback and
  the host step count) round-trips.
- The manifest falls back past a partial write, old checkpoints are
  collected, the async snapshot is taken before an in-place update, a
  failed write raises, and ``launch/train.py --ckpt-dir`` resumes with the
  data cursor where the interrupted run stopped.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import build_model as jax_build_model
from repro.train.step import gspmd_init_state as jax_gspmd_init
from repro.train.step import make_gspmd_train_step as jax_gspmd_step
from repro_torch import bridge
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.registry import leaves
from repro_torch.train.step import (
    gspmd_init_state,
    make_gspmd_train_step,
    make_themis_train_step,
    trainable,
)

TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(x)


def _params_close(got, want, init, lr):
    """Per leaf, the L2 of the difference within 1e-2 of the L2 of the
    update, and every element within 0.1 lr (``test_torch_train.py``)."""
    for a, b, c in zip(got, want, init):
        a, b, c = _np(a), _np(b), _np(c)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - c)
        assert np.abs(a - b).max() <= 0.1 * lr


def _jax_setup(arch="llama3-8b"):
    jcfg = jax_get_arch(arch, reduced=True).replace(dtype="float32", remat=False)
    jmodel = jax_build_model(jcfg)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jstep, *_ = jax_gspmd_step(jmodel, mesh, JParallelConfig(), JTrainConfig(**TRAIN))
    jparams, jopt = jax_gspmd_init(jmodel, mesh, JParallelConfig())
    return jcfg, jstep, jparams, jopt


def _port_setup(arch="llama3-8b", seed=0):
    cfg = get_arch(arch, reduced=True).replace(dtype="float32", remat=False)
    api = build_model(cfg)
    step = make_gspmd_train_step(api, None, ParallelConfig(), TrainConfig(**TRAIN))
    params, opt = gspmd_init_state(api, None, ParallelConfig(), seed, "cpu")
    return cfg, step, params, opt


def _batches(vocab, n):
    ds = SyntheticLM(vocab, 4, 16, seed=7)
    return [ds.batch_at(i) for i in range(n)]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jcfg, jstep, jparams, jopt = _jax_setup()
    batches = _batches(jcfg.vocab_size, 4)
    for b in batches[:2]:
        jparams, jopt, _ = jstep(jparams, jopt, _jb(b))
    jckpt.save(str(tmp_path), 2, (jparams, jopt), extra={"next_step": 2, "seed": 7})
    at_two = jax.tree.leaves(jax.tree.map(np.asarray, (jparams, jopt)))
    jm = []
    for b in batches[2:]:
        jparams, jopt, m = jstep(jparams, jopt, _jb(b))
        jm.append(m)

    _, tstep, params, opt = _port_setup(seed=1)        # other weights, overwritten
    (params, opt), extra = restore(str(tmp_path), (params, opt))
    assert extra == {"next_step": 2, "seed": 7} and opt["count"] == 2
    for got, want in zip(leaves((params, opt)), at_two):
        assert np.array_equal(_np(got), want)
    init = [_np(p).copy() for p in leaves(params)]
    for b, m in zip(batches[extra["next_step"]:], jm):
        params, opt, tm = tstep(params, opt, _tb(b))
        assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(m["gnorm"]), rel=1e-5)
    _params_close(leaves(params), jax.tree.leaves(jparams), init, TRAIN["learning_rate"])


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-2b"])
def test_port_checkpoint_restores_into_the_reference(arch, tmp_path):
    """The reference's own ``restore`` reads the port's checkpoint: leaves
    equal to the bit (the step count as its 0-d int32), and the paths in
    ``meta.json`` are the ones the reference writes for its own state."""
    jcfg, jstep, jparams, jopt = _jax_setup(arch)
    _, tstep, _, _ = _port_setup(arch)
    params = trainable(bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    opt = {"m": bridge.params_from_jax(jax.tree.map(np.asarray, jopt["m"]), "cpu"),
           "v": bridge.params_from_jax(jax.tree.map(np.asarray, jopt["v"]), "cpu"),
           "count": 0}
    batches = _batches(jcfg.vocab_size, 3)
    for b in batches[:2]:
        params, opt, _ = tstep(params, opt, _tb(b))
    save(str(tmp_path), 2, (params, opt), extra={"next_step": 2})
    with open(tmp_path / "step-00000002" / "meta.json") as f:
        assert json.load(f)["paths"] == jckpt._paths((jparams, jopt))
    (jparams, jopt), extra = jckpt.restore(str(tmp_path), (jparams, jopt))
    assert extra == {"next_step": 2} and int(jopt["count"]) == 2
    assert jopt["count"].dtype == jnp.int32
    for got, want in zip(jax.tree.leaves((jparams, jopt)), leaves((params, opt))):
        assert np.array_equal(np.asarray(got), _np(want))
    if arch == "llama3-8b":
        jparams, jopt, jm = jstep(jparams, jopt, _jb(batches[2]))
        params, opt, tm = tstep(params, opt, _tb(batches[2]))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    return tree


def test_resumed_run_continues_the_unbroken_run_to_the_bit(tmp_path):
    """Three steps, a checkpoint, a fresh state restored from it and three
    more steps give the losses and params of six unbroken steps, to the bit
    (reduced llama3-8b, as ``tests/test_train_and_ckpt.py``)."""
    cfg = get_arch("llama3-8b", reduced=True).replace(remat=False)
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=12, warmup_steps=2)
    step = make_gspmd_train_step(api, None, ParallelConfig(), tcfg)
    ds = SyntheticLM(cfg.vocab_size, 4, 32, seed=7)
    params, opt = gspmd_init_state(api, None, ParallelConfig(), 0, "cpu")
    p_ref, o_ref = _clone(params), _clone(opt)
    ref_losses = []
    for i in range(6):
        p_ref, o_ref, m = step(p_ref, o_ref, _tb(ds.batch_at(i)))
        ref_losses.append(float(m["loss"]))
    losses = []
    for i in range(3):
        params, opt, m = step(params, opt, _tb(ds.batch_at(i)))
        losses.append(float(m["loss"]))
    save(str(tmp_path), 3, (params, opt), extra={"next_step": 3, "seed": ds.seed})
    del params, opt
    params, opt = gspmd_init_state(api, None, ParallelConfig(), 5, "cpu")
    (params, opt), extra = restore(str(tmp_path), (params, opt))
    for i in range(extra["next_step"], 6):
        params, opt, m = step(params, opt, _tb(ds.batch_at(i)))
        losses.append(float(m["loss"]))
    assert losses == ref_losses and opt["count"] == o_ref["count"] == 6
    for a, b in zip(leaves((params, opt)), leaves((p_ref, o_ref))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_themis_opt_layout_round_trips(compression, tmp_path):
    """The one-rank Themis state (fp32 master, m and v of (chunks,
    per_chunk), the error feedback, the host step count) written after a
    step restores into a fresh state to the bit, and the next step from it
    equals the next step of the original."""
    cfg = get_arch("qwen2.5-3b", reduced=True).replace(dtype="float32", remat=False)
    api = build_model(cfg)
    mesh = Mesh((1, 1), ("data", "model"), "cpu")
    step, init_state, _ = make_themis_train_step(
        api, mesh, ParallelConfig(dp_sync="themis", chunks_per_collective=5,
                                  compression=compression), TrainConfig(**TRAIN))
    batches = _batches(cfg.vocab_size, 2)
    params, opt = init_state(0, "cpu")
    params, opt, _ = step(params, opt, _tb(batches[0]))
    save(str(tmp_path), 1, (params, opt))
    fresh = init_state(3, "cpu")
    (p2, o2), _ = restore(str(tmp_path), fresh)
    assert sorted(o2) == ["count", "err", "m", "master", "v"] and o2["count"] == 1
    for a, b in zip(leaves((p2, o2)), leaves((params, opt))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    params, opt, m1 = step(params, opt, _tb(batches[1]))
    p2, o2, m2 = step(p2, o2, _tb(batches[1]))
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(leaves((p2, o2)), leaves((params, opt))):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_manifest_ahead_of_the_data_falls_back(tmp_path):
    state = {"p": torch.arange(3.0)}
    save(str(tmp_path), 1, state)
    save(str(tmp_path), 2, state)
    with open(tmp_path / "MANIFEST.json", "w") as f:    # a crash wrote the
        json.dump({"latest_step": 99}, f)               # manifest, no data
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), state)


def test_gc_keeps_n_and_restore_checks_the_state(tmp_path):
    for s in range(5):
        save(str(tmp_path), s, {"p": torch.zeros(3)}, keep=2)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step-")) == [
        "step-00000003", "step-00000004"]
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), {"p": torch.zeros(3), "q": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), {"p": torch.zeros(4)})


def test_bfloat16_leaves_round_trip_exactly(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).bfloat16()
    save(str(tmp_path), 1, {"x": x, "n": 3})
    with np.load(tmp_path / "step-00000001" / "arrays.npz") as f:
        assert f["leaf_1"].dtype == np.float32          # numpy has no bf16
        assert f["leaf_0"].dtype == np.int32 and f["leaf_0"] == 3
    state, _ = restore(str(tmp_path), {"x": torch.zeros(5, 7, dtype=torch.bfloat16),
                                       "n": 0})
    assert torch.equal(state["x"], x) and state["n"] == 3


def test_async_snapshot_is_taken_before_an_in_place_update(tmp_path):
    """``save_async`` returns with its host copy complete: an in-place update
    right after it does not reach the checkpoint. A failed write raises from
    ``wait``."""
    p = torch.arange(6.0).requires_grad_(True)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save_async(5, {"p": p, "count": 5}, extra={"next_step": 5})
    with torch.no_grad():
        p.add_(100.0)                                    # the next step
    ck.wait()
    state, extra = restore(str(tmp_path), {"p": torch.zeros(6), "count": 0})
    assert torch.equal(state["p"], torch.arange(6.0)) and state["count"] == 5
    assert extra == {"next_step": 5}
    rec = ck.saves[0]
    assert rec["step"] == 5 and rec["bytes"] == 6 * 4 + 4 and rec["write_s"] >= 0
    blocked = AsyncCheckpointer(str(tmp_path / "MANIFEST.json"))  # a file
    blocked.save_async(1, {"p": p})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        blocked.wait()


class _Crash(Exception):
    pass


@pytest.mark.parametrize("dp_sync", ["gspmd", "themis"])
def test_launch_train_ckpt_dir_resumes_with_the_exact_data_cursor(dp_sync, tmp_path,
                                                                  capsys):
    """``--ckpt-dir`` with ``--ckpt-every 2``: a run interrupted in its third
    step leaves the checkpoint of step 2; the same command then resumes at
    the data cursor 2 and its steps 3-4 give the losses and params of an
    uninterrupted run, to the bit (a new batch every step)."""
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--dp-sync", dp_sync, "--lr", "1e-2"]
    whole = ttrain.main(argv)
    ck = argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]

    def crash(step, metrics):
        if step == 2:
            raise _Crash

    with pytest.raises(_Crash):
        ttrain.main(ck, on_step=crash)
    assert latest_step(str(tmp_path)) == 2
    capsys.readouterr()
    res = ttrain.main(ck)
    out = capsys.readouterr().out
    assert "resumed from step 2 (data cursor -> 2)" in out
    assert res["start_step"] == 2 and res["restored"]["step"] == 2
    assert res["losses"] == whole["losses"][2:]
    assert [c["step"] for c in res["checkpoints"]] == [4]
    for a, b in zip(leaves(res["params"]), leaves(whole["params"])):
        assert torch.equal(a, b)


def test_launch_train_refuses_checkpoints_of_a_multi_rank_run(tmp_path):
    with pytest.raises(NotImplementedError, match="M12"):
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "2x1",
                     "--ckpt-dir", str(tmp_path)])
