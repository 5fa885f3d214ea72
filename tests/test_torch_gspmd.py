"""The port's sharded GSPMD train step on 8 gloo ranks against the
reference's ``make_gspmd_train_step`` on 8 virtual CPU devices, from the
same initial params and batch.

One reference subprocess runs every case of ``RUNS`` (reduced configs,
fp32 activations, remat off, 2 steps); one spawn of 8 ranks runs the
port's (a case on a mesh of fewer ranks lies on the first ranks; the
others only build its mesh). Each case is checked on every rank of its
mesh: losses and gnorms within 1e-5 relative, every param, m and v, each
gathered whole, within ``test_torch_comms.FP32_BOUNDS``'s limits (params
within 1e-2 of their update's L2 and 0.1 lr per element, m and v 1e-4
relative L2), and each local shard's shape the one its spec implies. One
more case runs the port's Themis and GSPMD steps from one seed on the
(pod 2, data 2, model 2) mesh and holds their losses within 0.05, as
``tests/multidevice_checks.py`` holds the reference's.
"""
import math

import numpy as np
import pytest

from _gloo_ranks import check_case, run_checks, run_reference, spawn, sub_mesh

WORLD = 8
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
# name: (mesh shape, axis names, arch, ParallelConfig kwargs, TrainConfig
# kwargs, steps)
RUNS = {
    "pod_data_model": ((2, 2, 2), ("pod", "data", "model"), "qwen2.5-3b",
                       dict(pods=2, data=2, model=2), TCFG, 2),
    "fsdp": ((2, 4), ("data", "model"), "qwen2.5-3b",
             dict(data=2, model=4, fsdp=True), TCFG, 2),
    "microbatch": ((2, 2, 2), ("pod", "data", "model"), "qwen2.5-3b",
                   dict(pods=2, data=2, model=2), dict(TCFG, microbatch=2), 2),
    "seq_sharding": ((2, 4), ("data", "model"), "qwen2.5-3b",
                     dict(data=2, model=4, seq_sharding=True), TCFG, 2),
    "hybrid": ((2, 2), ("data", "model"), "recurrentgemma-2b",
               dict(data=2, model=2), TCFG, 2),
}
BOUNDS = {"losses_rel": 1e-5, "gnorms_rel": 1e-5, "m_rel_l2": 1e-4,
          "v_rel_l2": 1e-4, "params_diff_over_update": 1e-2,
          "params_max_abs_over_lr": 0.1}

REFERENCE_SCRIPT = r"""
import ast, math, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import ParallelConfig, TrainConfig, get_arch
from repro.models import build_model
from repro.train.step import gspmd_init_state, make_gspmd_train_step

res = {}
for name, (shape, names, arch, par, tcfg, steps) in ast.literal_eval(sys.argv[2]).items():
    n = math.prod(shape)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    cfg = get_arch(arch, reduced=True).replace(remat=False, dtype="float32")
    api = build_model(cfg)
    step, *_ = make_gspmd_train_step(api, mesh, ParallelConfig(**par),
                                     TrainConfig(**tcfg))
    params, opt = gspmd_init_state(api, mesh, ParallelConfig(**par))
    r = {f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
    r.update(batch)
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    for key, tree in (("final_p", params), ("m", opt["m"]), ("v", opt["v"])):
        r.update({f"{key}{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(tree))})
    r["losses"], r["gnorms"] = np.asarray(losses), np.asarray(gnorms)
    res.update({f"{name}/{k}": v for k, v in r.items()})
np.savez(sys.argv[1], **res)
"""


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _local_shape(shape, spec, mesh):
    return tuple(d // math.prod(mesh.axis_size(a) for a in
                                ([e] if isinstance(e, str) else (e or ())))
                 for d, e in zip(shape, spec))


def _check_run(name, ref_path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves
    from repro_torch.sharding.specs import opt_specs, param_specs
    from repro_torch.train.step import gspmd_init_state, make_gspmd_train_step

    shape, names, arch, par, tcfg, steps = RUNS[name]
    mesh = sub_mesh(shape, names)
    if dist.get_rank() >= mesh.size:
        return None
    ref = {k[len(name) + 1:]: v for k, v in np.load(ref_path).items()
           if k.startswith(name + "/")}
    cfg = get_arch(arch, reduced=True).replace(remat=False, dtype="float32")
    api = build_model(cfg)
    parallel = ParallelConfig(**par)
    step = make_gspmd_train_step(api, mesh, parallel, TrainConfig(**tcfg))
    params = api.init(0, "cpu")
    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            p.copy_(torch.from_numpy(ref[f"p{i}"]))
    params, opt = gspmd_init_state(api, mesh, parallel, params=params)
    batch = {k: torch.from_numpy(ref[k]) for k in ("tokens", "labels")}
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    errs = {"losses_rel": float(np.max(np.abs(np.asarray(losses) - ref["losses"])
                                       / np.abs(ref["losses"]))),
            "gnorms_rel": float(np.max(np.abs(np.asarray(gnorms) - ref["gnorms"])
                                       / np.abs(ref["gnorms"])))}
    lr = tcfg["learning_rate"]
    p_diff = p_max = m_rel = v_rel = 0.0
    pspecs = leaves_of(param_specs(params, mesh, parallel))
    ospecs = leaves_of(opt_specs(params, mesh, parallel))
    for i, (p, mm, vv) in enumerate(zip(leaves(params), leaves(opt["m"]),
                                        leaves(opt["v"]))):
        assert tuple(p.to_local().shape) == _local_shape(p.shape, pspecs[i], mesh)
        for t in (mm, vv):
            assert tuple(t.to_local().shape) == _local_shape(t.shape, ospecs[i], mesh)
        a = p.full_tensor().detach().numpy()
        b, c = ref[f"final_p{i}"], ref[f"p{i}"]
        p_diff = max(p_diff, float(np.linalg.norm(a - b) / np.linalg.norm(b - c)))
        p_max = max(p_max, float(np.abs(a - b).max() / lr))
        m_rel = max(m_rel, _rel_l2(mm.full_tensor().numpy(), ref[f"m{i}"]))
        v_rel = max(v_rel, _rel_l2(vv.full_tensor().numpy(), ref[f"v{i}"]))
    errs.update(params_diff_over_update=p_diff, params_max_abs_over_lr=p_max,
                m_rel_l2=m_rel, v_rel_l2=v_rel)
    beyond = {k: (errs[k], lim) for k, lim in BOUNDS.items() if errs[k] > lim}
    assert not beyond, f"{name}: beyond the bounds {beyond}"
    return {"losses": losses, "gnorms": gnorms, **errs}


def leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def _check_themis_vs_gspmd():
    """``multidevice_checks.py``'s check on the port: both steps from seed
    0 on (pod 2, data 2, model 2), reduced qwen2.5-3b in bf16, 2 steps."""
    import torch

    from repro_torch.configs import ParallelConfig, TrainConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.data.pipeline import local_rows
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        gspmd_init_state,
        make_gspmd_train_step,
        make_themis_train_step,
    )

    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    cfg = get_arch("qwen2.5-3b", reduced=True).replace(remat=False)
    api = build_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       weight_decay=0.0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 32)))}
    step_t, init_t, orders = make_themis_train_step(
        api, mesh, ParallelConfig(data=2, model=2, pods=2, dp_sync="themis",
                                  chunks_per_collective=4), tcfg)
    pt, ot = init_t(0, "cpu")
    par = ParallelConfig(data=2, model=2, pods=2)
    step_g = make_gspmd_train_step(api, mesh, par, tcfg)
    pg, og = gspmd_init_state(api, mesh, par, 0, "cpu")
    for _ in range(2):
        pt, ot, mt = step_t(pt, ot, local_rows(batch, mesh))
        pg, og, mg = step_g(pg, og, batch)
    lt, lg = float(mt["loss"]), float(mg["loss"])
    assert abs(lt - lg) < 0.05, f"themis {lt} vs gspmd {lg}"
    return {"themis": lt, "gspmd": lg}


def _worker(rank, store, out_dir, ref_path):
    checks = [(name, lambda name=name: _check_run(name, ref_path))
              for name in RUNS]
    checks.append(("themis_vs_gspmd", _check_themis_vs_gspmd))
    run_checks(rank, WORLD, store, out_dir, checks)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd")
    ref_path = tmp / "reference.npz"
    run_reference(REFERENCE_SCRIPT, ref_path, RUNS, WORLD)
    return spawn(_worker, WORLD, tmp, (str(ref_path),))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RUNS) + ["themis_vs_gspmd"])
def test_sharded_gspmd_step_matches_reference(results, name):
    values = check_case(results, name)
    members = [v for v in values if v is not None]
    assert members
    # every rank of the mesh reads the same loss and gnorm
    assert len({tuple(v.get("losses", [v.get("gspmd")])) for v in members}) == 1
