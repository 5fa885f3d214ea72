"""The port's dry run (``repro_torch.launch.dryrun``: meta tensors on a fake
process group) against the reference's ``repro/launch/dryrun.py``.

The reference's side runs in JAX subprocesses, all at once: one on 512
virtual devices for the production meshes, ``parallel_for`` /
``pick_microbatch`` on every arch x shape x production mesh x ``dp_sync``
and every arch's ``batch_spec`` / ``decode_spec`` at its applicable
shapes (``kv_quant`` off and on); and a few on 8 devices that lower and
compile the reference's steps of the small cells (``CELLS``: each
family's reduced config at seq 32, batch 8 on a (2, 4) mesh) for
``memory_analysis()``. The port's side runs in this process, on fake
groups it starts and destroys.

``argument_bytes`` equals XLA's ``argument_size_in_bytes`` up to three
differences that ``_expected_gap`` computes exactly (ROADMAP §3): the
reference keeps the optimizer's int32 step count on the device (the port
on the host), XLA drops the arguments a step never reads (whisper's
encoder params in a decode step, the xLSTM's position), and, given no
sharding for the batch, XLA splits the seq-sharding families' batch
along its sequence over "model" too, where the port places it on
``batch_pspec`` (its batch dim only).
"""
import json
import math
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from _gloo_ranks import run_reference

FAMILY_ARCHS = ["llama3-8b", "recurrentgemma-2b", "deepseek-moe-16b",
                "internvl2-26b", "whisper-medium", "xlstm-1.3b"]
# name: (arch, shape kind, dp_sync); reduced configs, seq 32, batch 8, (2, 4)
CELLS = {f"{a}/{k}": (a, k, "gspmd") for a in FAMILY_ARCHS
         for k in ("train", "prefill", "decode")}
CELLS["llama3-8b/themis"] = ("llama3-8b", "train", "themis")
SMALL = dict(seq_len=32, global_batch=8)
MESH = ((2, 4), ("data", "model"))

META_SCRIPT = r"""
import dataclasses, json, sys
import repro.models as rm
from repro.launch.dryrun import parallel_for, pick_microbatch
import jax
from repro.configs import get_arch, list_archs
from repro.configs.base import ALL_SHAPES, applicable_shapes
from repro.launch.mesh import make_production_mesh
from repro.models import build_model

# parallel_for counts the params of a fresh param_spec on every call:
# count each arch's once
_build, _apis = rm.build_model, {}
def build_once(cfg):
    if cfg not in _apis:
        api = _build(cfg)
        spec = api.param_spec()
        api.param_spec = lambda seed=0, spec=spec: spec
        _apis[cfg] = api
    return _apis[cfg]
rm.build_model = build_once

out = {"meshes": {}, "parallel": {}, "specs": {}, "shapes": {}}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["meshes"][str(mp)] = [list(m.axis_names), [int(v) for v in m.shape.values()]]
for arch in list_archs():
    cfg = get_arch(arch)
    out["shapes"][arch] = [s.name for s in applicable_shapes(cfg)]
    for mp in (False, True):
        axes = dict(make_production_mesh(multi_pod=mp).shape)
        for dp in ("gspmd", "themis", "hier_baseline"):
            par = parallel_for(arch, cfg, axes, dp)
            for s in ALL_SHAPES:
                out["parallel"][f"{arch}/{mp}/{dp}/{s.name}"] = [
                    dataclasses.asdict(par), pick_microbatch(cfg, s, axes, par)]
    for kvq in (False, True):
        api = build_model(cfg.replace(kv_quant=kvq))
        for s in applicable_shapes(cfg):
            c, t, p = api.decode_spec(s)
            out["specs"][f"{arch}/{kvq}/{s.name}"] = {
                "batch": {k: [list(v.shape), str(v.dtype)]
                          for k, v in api.batch_spec(s).items()},
                "decode": [[list(x.shape), str(x.dtype)]
                           for x in jax.tree.leaves((c, t, p))]}
json.dump(out, open(sys.argv[1], "w"))
"""

CELL_SCRIPT = r"""
import ast, dataclasses, json, math, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.configs.base import ShapeConfig, TrainConfig
from repro.launch.dryrun import _themis_opt_spec, parallel_for, pick_microbatch
from repro.models import build_model
from repro.train.optimizer import adamw_init
from repro.train.serve import make_serve_fns
from repro.train.step import make_gspmd_train_step, make_themis_train_step

cells, small, (mshape, names) = ast.literal_eval(sys.argv[2])
out = {}
for name, (arch, kind, dp_sync) in cells.items():
    cfg = get_arch(arch, reduced=True)
    shape = ShapeConfig("small", small["seq_len"], small["global_batch"], kind)
    mesh = Mesh(np.asarray(jax.devices()[:math.prod(mshape)]).reshape(mshape), names)
    axes = dict(mesh.shape)
    api = build_model(cfg)
    par = parallel_for(arch, cfg, axes, dp_sync)
    ps = api.param_spec()
    if kind == "train" and dp_sync == "gspmd":
        tcfg = dataclasses.replace(TrainConfig(), microbatch=pick_microbatch(cfg, shape, axes, par))
        step, *_ = make_gspmd_train_step(api, mesh, par, tcfg)
        opt = jax.eval_shape(adamw_init, ps)
        opt = {"m": opt["m"], "v": opt["v"], "count": jax.ShapeDtypeStruct((), jnp.int32)}
        lowered = step.lower(ps, opt, api.batch_spec(shape))
    elif kind == "train":
        world = math.prod(axes.values())
        shape = ShapeConfig(shape.name, shape.seq_len, max(shape.global_batch, world), kind)
        step, _, _ = make_themis_train_step(api, mesh, par, TrainConfig())
        opt = jax.eval_shape(lambda: _themis_opt_spec(api, mesh, par))
        lowered = step.lower(ps, opt, api.batch_spec(shape))
    elif kind == "prefill":
        prefill, _, _ = make_serve_fns(api, mesh, par, shape)
        lowered = prefill.lower(ps, api.batch_spec(shape))
    else:
        _, decode, _ = make_serve_fns(api, mesh, par, shape)
        lowered = decode.lower(ps, *api.decode_spec(shape))
    mem = lowered.compile().memory_analysis()
    out[name] = int(mem.argument_size_in_bytes)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's readings, computed in subprocesses that start here
    and run while the port's tests run; ``reference()[key]`` waits."""
    tmp = tmp_path_factory.mktemp("dryrun")
    names = list(CELLS)
    groups = [names[i::4] for i in range(4)]
    jobs = [("meta", META_SCRIPT, None, 512)] + [
        (f"cells{i}", CELL_SCRIPT, ({n: CELLS[n] for n in g}, SMALL, MESH), 8)
        for i, g in enumerate(groups)]
    pool = ThreadPoolExecutor(len(jobs))
    futures = {key: pool.submit(run_reference, script, tmp / f"{key}.json",
                                spec, devices)
               for key, script, spec, devices in jobs}
    results: dict = {}

    def get(key):
        if key not in results:
            if key == "cells":
                merged = {}
                for i in range(len(groups)):
                    futures[f"cells{i}"].result()
                    merged.update(json.loads((tmp / f"cells{i}.json").read_text()))
                results[key] = merged
            else:
                futures[key].result()
                results[key] = json.loads((tmp / f"{key}.json").read_text())
        return results[key]

    yield get
    pool.shutdown(wait=True)


@pytest.fixture
def fake_group():
    """``fake_group(world)`` starts a fake default group of ``world`` ranks;
    it is destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_process_group

    yield fake_process_group
    if dist.is_initialized():
        dist.destroy_process_group()


# -- shapes, meshes, parallel_for, pick_microbatch, specs -------------------------
def test_production_shapes_equal_the_reference_field_for_field():
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import base as jb

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs import base as tb

    assert [vars(s) for s in tb.ALL_SHAPES] == [vars(s) for s in jb.ALL_SHAPES]
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert vars(getattr(tb, name)) == vars(getattr(jb, name))
    archs = list_archs()
    assert len(archs) == 10
    for arch in archs:
        got = [vars(s) for s in tb.applicable_shapes(get_arch(arch))]
        want = [vars(s) for s in jb.applicable_shapes(jax_get_arch(arch))]
        assert got == want, arch


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_has_the_reference_shape_and_axes(reference, fake_group,
                                                          multi_pod):
    from repro_torch.launch.mesh import axis_sizes, make_production_mesh

    names, sizes = reference("meta")["meshes"][str(multi_pod)]
    fake_group(math.prod(sizes))
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert list(mesh.names) == names
    assert list(axis_sizes(mesh).values()) == sizes
    assert mesh.device_mesh.mesh.shape == tuple(sizes)


def test_parallel_for_and_pick_microbatch_equal_the_reference(reference):
    import dataclasses

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.launch.dryrun import parallel_for, pick_microbatch

    want = reference("meta")["parallel"]
    n = 0
    for arch in list_archs():
        cfg = get_arch(arch)
        for mp in (False, True):
            axes = ({"pod": 2, "data": 16, "model": 16} if mp
                    else {"data": 16, "model": 16})
            for dp in ("gspmd", "themis", "hier_baseline"):
                par = parallel_for(arch, cfg, axes, dp)
                for s in ALL_SHAPES:
                    got = [dataclasses.asdict(par), pick_microbatch(cfg, s, axes, par)]
                    assert got == want[f"{arch}/{mp}/{dp}/{s.name}"], (arch, mp, dp, s)
                    n += 1
    assert n == len(want) == 10 * 2 * 3 * 4


@pytest.mark.parametrize("arch,reduced,sp", [
    # tests/test_serving_features.py::test_pick_microbatch_heuristic's cases
    ("granite-34b", False, True), ("granite-34b", False, False),
    ("qwen2.5-3b", True, True)])
def test_pick_microbatch_heuristic(arch, reduced, sp):
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import TRAIN_4K as J_TRAIN_4K
    from repro.configs.base import ParallelConfig as JPar

    from repro_torch.configs import ParallelConfig, get_arch
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.launch.dryrun import pick_microbatch

    axes = {"data": 16, "model": 16}
    got = pick_microbatch(get_arch(arch, reduced=reduced), TRAIN_4K, axes,
                          ParallelConfig(data=16, model=16, seq_sharding=sp))
    want = _reference_pick_microbatch(
        jax_get_arch(arch, reduced=reduced), J_TRAIN_4K, axes,
        JPar(data=16, model=16, seq_sharding=sp))
    assert got == want
    assert TRAIN_4K.global_batch % got == 0


def _reference_pick_microbatch(cfg, shape, axes, parallel):
    """The reference's ``pick_microbatch``, read from its source (importing
    ``repro.launch.dryrun`` would set this process's ``XLA_FLAGS``)."""
    import ast
    import importlib.util

    src = importlib.util.find_spec("repro.launch.dryrun").origin
    tree = ast.parse(open(src).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "pick_microbatch")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), src, "exec"), ns)
    return ns["pick_microbatch"](cfg, shape, axes, parallel)


def test_batch_and_decode_specs_equal_the_reference(reference):
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import applicable_shapes
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves

    want = reference("meta")["specs"]
    names = {torch.int32: "int32", torch.int8: "int8", torch.bfloat16: "bfloat16",
             torch.float32: "float32"}
    n = 0
    for arch in list_archs():
        for kvq in (False, True):
            api = build_model(get_arch(arch).replace(kv_quant=kvq))
            for s in applicable_shapes(api.cfg):
                w = want[f"{arch}/{kvq}/{s.name}"]
                batch = {k: [list(v.shape), names[v.dtype]]
                         for k, v in api.batch_spec(s).items()}
                assert batch == w["batch"], (arch, kvq, s.name)
                c, t, p = api.decode_spec(s)
                dec = [[list(x.shape), names[x.dtype]] for x in leaves([c, t, p])]
                assert dec == w["decode"], (arch, kvq, s.name)
                assert all(x.is_meta for x in leaves([c, t, p, api.batch_spec(s)]))
                n += 1
    assert n == len(want)


# -- collective_stats ------------------------------------------------------------
def _stats(fn):
    from repro_torch.comms.schedule_bridge import CollectiveCounter, collective_stats

    counter = CollectiveCounter()
    with counter:
        fn()
    return collective_stats(counter)


def _one(kind, nbytes, group):
    return {"bytes_by_kind": {kind: float(nbytes)},
            "bytes_by_group_size": {group: float(nbytes)},
            "op_counts": {kind: 1}, "total_bytes": float(nbytes)}


@pytest.mark.parametrize("program", ["shard_to_replicate", "partial_to_replicate",
                                     "partial_to_shard", "all_to_all_single"])
def test_collective_stats_counts_hand_built_programs(fake_group, program):
    """On a fake group and a (2, 4) mesh, one program per kind: a local
    (8, 16) fp32 block (512 bytes) over "model" (4 ranks)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import Mesh

    fake_group(8)
    mesh = Mesh(*MESH, "cpu")
    dm = mesh.device_mesh

    def dt(pl):
        return DTensor.from_local(torch.empty(8, 16, device="meta"), dm,
                                  (Replicate(), pl), run_check=False)

    if program == "shard_to_replicate":
        x = dt(Shard(0))
        got = _stats(lambda: x.redistribute(dm, (Replicate(), Replicate())))
        want = _one("all-gather", 4 * 512, 4)
    elif program == "partial_to_replicate":
        x = dt(Partial())
        got = _stats(lambda: x.redistribute(dm, (Replicate(), Replicate())))
        want = _one("all-reduce", 512, 4)
    elif program == "partial_to_shard":
        x = dt(Partial())
        got = _stats(lambda: x.redistribute(dm, (Replicate(), Shard(0))))
        want = _one("reduce-scatter", 512 // 4, 4)
    else:
        def a2a():
            out = torch.empty(128, device="meta")
            dist.all_to_all_single(out, torch.empty(128, device="meta"),
                                   group=mesh.group("model"))
        got = _stats(a2a)
        want = _one("all-to-all", 512, 4)
    assert got == want


def test_collective_stats_counts_the_themis_reduce_scatter(fake_group):
    """``chunked_reduce_scatter`` of 2 chunks of 64 fp32 (256 bytes) on
    subgroups, one chunk "model" then "data", the other "data" then "model":
    results of 64 / 4 and 64 / 8 elements, and of 64 / 2 and 64 / 8."""
    from repro_torch.comms.hierarchical import chunked_reduce_scatter
    from repro_torch.launch.mesh import Mesh

    fake_group(8)
    mesh = Mesh(*MESH, "cpu")
    chunks = torch.empty(2, 64, device="meta")
    got = _stats(lambda: chunked_reduce_scatter(
        chunks, [("model", "data"), ("data", "model")], mesh))
    by_group = {4: 4.0 * (16 + 8), 2: 4.0 * (8 + 32)}
    assert got == {"bytes_by_kind": {"reduce-scatter": sum(by_group.values())},
                   "bytes_by_group_size": by_group,
                   "op_counts": {"reduce-scatter": 4},
                   "total_bytes": sum(by_group.values())}


def test_collective_stats_keys_are_the_reference_keys():
    from repro.comms.schedule_bridge import collective_stats as jax_stats
    from test_comms_bridge import SAMPLE_HLO

    from repro_torch.comms.schedule_bridge import CollectiveCounter, collective_stats

    assert set(collective_stats(CollectiveCounter())) == set(jax_stats(SAMPLE_HLO))


# -- the small cells ----------------------------------------------------------------
@pytest.fixture(scope="module")
def port_cells():
    """The port's dry run of every small cell, on one fake group of 8."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_process_group, run_cell

    fake_process_group(8)
    try:
        return {name: run_cell(get_arch(arch, reduced=True),
                               ShapeConfig("small", kind=kind, **SMALL), *MESH,
                               dp_sync=dp)
                for name, (arch, kind, dp) in CELLS.items()}
    finally:
        dist.destroy_process_group()


def _local_bytes(tree, specs, sizes) -> int:
    """The bytes of each leaf's local block under its spec on a mesh of axis
    ``sizes``."""
    from repro_torch.models.registry import leaves

    n = 0
    for x, spec in zip(leaves(tree), _spec_leaves(specs)):
        parts = math.prod(sizes.get(a, 1) for e in spec if e
                          for a in ([e] if isinstance(e, str) else e))
        n += x.numel() * x.element_size() // parts
    return n


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


class _Sizes:
    """A shape-only stand-in of the (2, 4) mesh for the partition rules."""
    names = MESH[1]
    shape = dict(zip(MESH[1], MESH[0]))


def _expected_gap(name) -> int:
    """The port's argument bytes less XLA's for cell ``name`` (the module
    docstring's three differences)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import parallel_for
    from repro_torch.models import build_model
    from repro_torch.sharding.specs import batch_pspec, param_specs

    arch, kind, dp = CELLS[name]
    cfg = get_arch(arch, reduced=True)
    api = build_model(cfg)
    sizes = _Sizes.shape
    parallel = parallel_for(arch, cfg, sizes, dp)
    gap = 0
    if kind == "train":
        gap -= 4                      # the int32 step count
    if kind == "train" and dp == "gspmd" and parallel.seq_sharding:
        # XLA's own split of the batch: also its sequence over "model"
        batch = api.batch_spec(ShapeConfig("small", kind=kind, **SMALL))
        for v in batch.values():
            spec = batch_pspec(tuple(v.shape), _Sizes, v.shape[0])
            local = _local_bytes(v, spec, sizes)
            if v.shape[1] % sizes["model"] == 0:
                gap += local - local // sizes["model"]
    if kind == "decode" and cfg.family == "audio":
        # the encoder's params, which a decode step never reads
        spec = api.param_spec()
        specs = param_specs(spec, _Sizes, parallel)
        for key in ("enc_blocks", "ln_enc"):
            gap += _local_bytes(spec[key], specs[key], sizes)
    if kind == "decode" and cfg.family == "ssm":
        gap += 4                      # the position, which it never reads
    return gap


@pytest.mark.parametrize("name", list(CELLS))
def test_small_cell_runs_and_its_argument_bytes_equal_xla(reference, port_cells,
                                                          name):
    got = port_cells[name]
    assert got["status"] == "ok"
    assert got["compile_s"] == 0.0 and "bytes accessed" not in got["cost"]
    assert got["cost"]["flops"] > 0
    assert set(got) >= {"arch", "shape", "kind", "mesh", "chips", "dp_sync",
                        "status", "n_params", "lower_s", "compile_s", "memory",
                        "cost", "collectives_hlo", "roofline"}
    want = reference("cells")[name]
    assert got["memory"]["argument_bytes"] - want == _expected_gap(name), (
        got["memory"]["argument_bytes"], want)
    if got["kind"] == "train":
        kinds = set(got["collectives_hlo"]["op_counts"])
        assert {"all-reduce", "all-gather", "reduce-scatter"} <= kinds, kinds


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_data_parallel_flops_split_exactly(fake_group, arch):
    """On a pure data-parallel (8, 1) mesh each rank counts 1/8 of the FLOPs
    of the same step on one rank with the whole batch, exactly."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    cfg = get_arch(arch, reduced=True)
    shape = ShapeConfig("small", kind="train", **SMALL)
    fake_group(8)
    eight = run_cell(cfg, shape, (8, 1), ("data", "model"))
    fake_group(1)
    one = run_cell(cfg, shape, (1, 1), ("data", "model"))
    assert 8 * eight["cost"]["flops"] == one["cost"]["flops"] > 0


def test_xlstm_prefill_counts_the_plain_loops_flops(fake_group, monkeypatch):
    """The xLSTM's prefill runs the sLSTM kernel's meta branch (no loop over
    time on meta) and counts the FLOPs the plain step loop counted: the
    reduced xlstm-1.3b's small prefill cell on a (4, 2) mesh, once as it
    runs and once with the scan routed to ``slstm_scan_plain``. (A mesh of
    its own: DTensor keeps the groups of a mesh it has seen by the mesh's
    shape, and ``port_cells`` destroyed the group of its (2, 4) mesh.)"""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import slstm
    from repro_torch.launch.dryrun import run_cell

    cfg = get_arch("xlstm-1.3b", reduced=True)
    shape = ShapeConfig("small", kind="prefill", **SMALL)
    mesh = ((4, 2), ("data", "model"))
    fake_group(8)
    kernel = run_cell(cfg, shape, *mesh)
    tallied = slstm.meta_flops          # the cell's run resets the tally first
    monkeypatch.setattr(slstm, "slstm_scan", slstm.slstm_scan_plain)
    loop = run_cell(cfg, shape, *mesh)
    assert tallied > 0 and slstm.meta_flops == 0
    assert kernel["cost"]["flops"] == loop["cost"]["flops"] > 0


def test_full_size_cell_runs_in_one_process(fake_group):
    """llama3-8b's decode_32k on the 16x16 production mesh: 256 ranks of
    meta tensors in this process; per device under the card's 80 GiB."""
    from repro_torch.launch.dryrun import dryrun_cell

    res = dryrun_cell("llama3-8b", "decode_32k", verbose=False)
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["mesh"] == "data=16xmodel=16"
    assert 0 < res["memory"]["per_device_total_gib"] < 80
    assert res["collectives_hlo"]["total_bytes"] > 0


def test_full_size_prefill_allocates_only_each_ranks_cache_block(fake_group):
    """llama3-8b's prefill_32k at 16x16: each rank allocates only its block
    of the new KV cache (``transformer.place_cache``). Built whole on every
    rank and then sliced, the cache's 32 x 32768 positions of 32 layers
    (2 x 68.7 GB in bf16) put the per-device peak at 129 GiB."""
    from repro_torch.launch.dryrun import dryrun_cell

    res = dryrun_cell("llama3-8b", "prefill_32k", verbose=False)
    assert res["status"] == "ok"
    assert res["memory"]["per_device_total_gib"] < 8, res["memory"]
