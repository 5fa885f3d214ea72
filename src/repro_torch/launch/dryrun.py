"""Multi-pod dry run on meta tensors and a fake process group (port of
``repro/launch/dryrun.py``).

For each (arch x shape x mesh) cell this starts a fake process group of the
mesh's world size (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once and moves nothing), builds the production mesh
over it (16x16 single-pod or 2x16x16 multi-pod), places the params
(``param_spec()`` on the ``meta`` device) on their placements, builds the
same step the reference lowers (the GSPMD train step with
``pick_microbatch``'s accumulation, the Themis step on a world-sized batch,
or sharded serving's prefill or decode) and runs it once on the
``batch_spec`` / ``decode_spec`` stand-ins. Nothing is allocated and no
collective leaves the process; the kernels' wrappers return empty outputs
and tally their FLOPs (``kernels.meta_flops``). It records, for one rank:

  * memory: ``argument_bytes``, the exact local bytes of the step's inputs
    on the device (params, optimizer state, batch or caches, token and
    position; the port keeps the optimizer's step count on the host);
    ``output_bytes``, those of its outputs; ``temp_bytes``, the peak of the
    other tensors alive during the run (each storage counted once, from
    the op that made it to its release), in place of XLA's buffer planner;
    ``per_device_total_gib`` = arguments + temps, against the card's 80 GiB;
  * cost: ``flops`` of one rank, counted on its local shards
    (``torch.utils.flop_counter``'s formulas) plus the kernels' tally. The
    reference's ``"bytes accessed"`` has no counterpart: nothing fuses the
    eager program, so the key is left out, as the reference leaves out a
    key its ``cost_analysis`` lacks;
  * ``collectives_hlo``: ``comms.schedule_bridge.collective_stats`` of the
    collectives DTensor's redistributions and the Themis step's
    ``torch.distributed`` calls issue (the reference's key name, so one
    reader takes either tree's files). The fake group's mesh is a CPU
    mesh, on which DTensor would move a split from one dim to another by an
    all-gather and a local chunk (gloo has no all-to-all); the dry run
    turns that fallback off (``_cuda_alltoall``), so the move is the
    all-to-all a CUDA mesh issues, and its temps are a CUDA run's;
  * roofline: ``launch/roofline.compute_roofline`` with ``hlo_flops`` the
    counted FLOPs, on the port's H100 constants;
  * ``lower_s``: the host seconds of the meta run; ``compile_s``: 0.0, as
    nothing compiles.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --dp-sync themis      # the paper's ZeRO-2 program

Any host read of a step's result (a metric turned to a float) would raise
on meta, so the dry run keeps the metrics as tensors. A decode step runs at
the last position of its cache (``seq_len - 1``): the port's decode reads
the whole cache whatever the position.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from repro_torch.comms.schedule_bridge import (
    CollectiveCounter,
    collective_stats,
    tensors_of,
)

GIB = 2**30
CARD_GIB = 80


def parallel_for(arch_name: str, cfg, mesh_axes: dict, dp_sync: str = "gspmd"):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import build_model
    from repro_torch.models.registry import count_params

    n = count_params(build_model(cfg).param_spec())
    return ParallelConfig(
        data=mesh_axes.get("data", 1),
        model=mesh_axes.get("model", 1),
        pods=mesh_axes.get("pod", 1),
        fsdp=n >= 8e9,
        # sequence parallelism between blocks for the transformer-family
        # residual streams; the recurrent, SSM and MoE paths work on whole
        # rows (a scan over time, a per-row dispatch sort)
        seq_sharding=cfg.family in ("dense", "vlm", "audio"),
        zero=1,
        dp_sync=dp_sync,
    )


def pick_microbatch(cfg, shape, mesh_axes: dict, parallel) -> int:
    """Gradient-accumulation factor so the layer-carry stack fits: carry ~=
    L x tokens_local x d_model x 2 B (bf16), / tp when seq-sharded, at most
    2 GiB per device."""
    dp = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)
    tp = mesh_axes.get("model", 1)
    b_loc = max(shape.global_batch // dp, 1)
    carry = cfg.num_layers * b_loc * shape.seq_len * cfg.d_model * 2
    if parallel.seq_sharding:
        carry /= tp
    target = 2 * 2**30
    n = 1
    while carry / n > target and n < b_loc and shape.global_batch % (2 * n) == 0:
        n *= 2
    return n


def fake_process_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process rank 0), replacing one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# -- counting -------------------------------------------------------------------
def _tensors(tree) -> list:
    """The tensors of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tensors_of(tree)]


def local_bytes(*trees) -> int:
    """The bytes of every tensor's local shard in ``trees`` (a view's own
    elements, each tensor once)."""
    seen, n = set(), 0
    for t in _tensors(trees):
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


# DTensor's sharding propagation builds meta tensors of the global shapes
# (and caches them); no device holds them, so they are not temps
_PROPAGATION_FILES = ("_op_schema.py", "_sharding_prop.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILES):
            return True
        f = f.f_back
    return False


class StepCounter(CollectiveCounter):
    """A ``CollectiveCounter`` that also counts one rank's FLOPs (each local
    op by ``torch.utils.flop_counter``'s formula) and the peak bytes of the
    storages the local ops make while they are alive (not those of
    DTensor's sharding propagation)."""

    def __init__(self, exclude=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.live = self.peak = 0
        self._owned: dict = {}
        self._exclude = {t.untyped_storage()._cdata for t in _tensors(exclude)}

    def on_local_op(self, func, args, kwargs, out) -> None:
        fn = self.registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owned or key in self._exclude or _in_propagation():
                continue
            n = st.nbytes()
            self._owned[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._owned.pop(key, 0)


@contextlib.contextmanager
def _cuda_alltoall():
    """DTensor's move of a split between dims (``shard_dim_alltoall``) as
    on a CUDA mesh: the all-to-all op, whose meta version moves nothing,
    in place of the CPU mesh's all-gather and chunk."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for m in (cu, pt) if hasattr(m, "shard_dim_alltoall")]
    old = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(mods, old):
            m.shard_dim_alltoall = f


def _measure(run, args) -> dict:
    """``run()`` once under a ``StepCounter`` and the kernels' FLOP tally;
    ``args``: the step's inputs (their storages are the arguments)."""
    from repro_torch import kernels

    kernels.reset_meta_flops()
    counter = StepCounter(exclude=args)
    t0 = time.perf_counter()
    with _cuda_alltoall(), counter:
        out = run()
    lower_s = time.perf_counter() - t0
    return {"out": out, "lower_s": lower_s, "counter": counter,
            "flops": counter.flops + kernels.meta_flops()}


# -- one cell -------------------------------------------------------------------
def _tcfg(**kw):
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(**kw)


def _themis_opt_spec(api, mesh, parallel):
    """This rank's Themis optimizer state on meta: its (C, per_chunk /
    world) master, m and v shards, the step count and the error-feedback
    residual."""
    from repro_torch.comms.hierarchical import chunk_len
    from repro_torch.models.registry import count_params

    world = math.prod(s for s in mesh.shape.values() if s > 1)
    n = count_params(api.param_spec())
    n_chunks = parallel.chunks_per_collective
    per = chunk_len(n, n_chunks, world) // world

    def z():
        return torch.empty((n_chunks, per), dtype=torch.float32, device="meta")

    err = (torch.empty((n,), dtype=torch.float32, device="meta")
           if parallel.compression == "int8"
           else torch.empty((), dtype=torch.float32, device="meta"))
    return {"master": z(), "m": z(), "v": z(), "count": 0, "err": err}


def _place_caches(cfg, caches, mesh, batch: int):
    """The decode stand-ins' caches on ``cache_pspec``'s placements, as
    each family's prefill places its own (``transformer.place_cache``)."""
    from repro_torch.models.common import mesh_context
    from repro_torch.models.transformer import place_cache
    from repro_torch.sharding.specs import cache_pspec, distribute_leaf, placements

    stacked = {"hybrid": {"periods": True, "tail": False},
               "ssm": {"mlstm": 2, "slstm": 1}}.get(cfg.family, True)
    with mesh_context(mesh):
        if cfg.family != "audio":
            return place_cache(lambda dev: caches, batch, stacked, "meta")
        mem = caches["memory"]
        return {"kv": place_cache(lambda dev: caches["kv"], batch, True, "meta"),
                "memory": distribute_leaf(mem, placements(cache_pspec(
                    "memory", tuple(mem.shape), mesh, batch), mesh), mesh)}


def run_cell(cfg, shape, mesh_shape, axes, *, dp_sync: str = "gspmd",
             parallel=None, verbose: bool = False) -> dict:
    """The dry run of ``cfg`` at ``shape`` on a mesh of ``mesh_shape`` /
    ``axes`` over the current process group (a fake one of the mesh's
    size, ``fake_process_group``); ``parallel`` defaults to
    ``parallel_for``'s. Returns the reference's result dict."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import compute_roofline
    from repro_torch.models import build_model
    from repro_torch.models.registry import count_params
    from repro_torch.sharding.specs import distribute, opt_placements, param_placements
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import shard_batch, trainable

    mesh = make_mesh(tuple(mesh_shape), tuple(axes), "cpu")
    axes_d = dict(mesh.shape)
    api = build_model(cfg)
    n_params = count_params(api.param_spec())
    if parallel is None:
        parallel = parallel_for(cfg.name, cfg, axes_d, dp_sync)
    spec = api.param_spec()

    if shape.kind == "train" and dp_sync != "gspmd":
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data.pipeline import local_rows
        from repro_torch.train.step import make_themis_train_step

        # pure DP over every axis: a world-sized batch at least
        world = math.prod(axes_d.values())
        shape = ShapeConfig(shape.name, shape.seq_len,
                            max(shape.global_batch, world), shape.kind)
        step, _, _ = make_themis_train_step(api, mesh, parallel, _tcfg())
        params = trainable(spec)
        opt = _themis_opt_spec(api, mesh, parallel)
        batch = local_rows(api.batch_spec(shape), mesh)
        args = (params, opt, batch)
        res = _measure(lambda: step(params, opt, batch), args)
    elif shape.kind == "train":
        from repro_torch.train.step import make_gspmd_train_step

        tcfg = _tcfg(microbatch=pick_microbatch(cfg, shape, axes_d, parallel))
        step = make_gspmd_train_step(api, mesh, parallel, tcfg)
        params = trainable(distribute(spec, mesh,
                                      param_placements(spec, mesh, parallel)))
        opt = adamw_init(params, opt_placements(params, mesh, parallel))
        batch = shard_batch(api.batch_spec(shape), mesh)
        args = (params, opt, batch)
        res = _measure(lambda: step(params, opt, batch), args)
    else:
        from repro_torch.train.serve import make_serve_fns, place_params

        prefill, decode = make_serve_fns(api, "meta", parallel, mesh=mesh,
                                         shape=shape)
        params = place_params(spec, mesh, parallel)
        if shape.kind == "prefill":
            whole = {k: v for k, v in api.batch_spec(shape).items()
                     if k != "labels"}
            args = (params, shard_batch(whole, mesh))
            res = _measure(lambda: prefill(params, whole), args)
        else:
            caches, token, pos = api.decode_spec(shape)
            caches = _place_caches(cfg, caches, mesh, shape.global_batch)
            args = (params, caches, shard_batch({"t": token}, mesh), pos)
            res = _measure(lambda: decode(params, caches, token,
                                          shape.seq_len - 1), args)

    arg_bytes = local_bytes(*args)
    out_bytes = local_bytes(res["out"])
    temp_bytes = res["counter"].peak
    stats = collective_stats(res["counter"])
    flops = res["flops"]
    rl = compute_roofline(cfg, shape, n_params, parallel, axes_d,
                          hlo_flops=float(flops))
    chips = math.prod(axes_d.values())
    result = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": "x".join(f"{k}={v}" for k, v in axes_d.items()),
        "chips": chips, "dp_sync": dp_sync, "status": "ok",
        "n_params": n_params,
        "lower_s": round(res["lower_s"], 1), "compile_s": 0.0,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "per_device_total_gib": round((arg_bytes + temp_bytes) / GIB, 3),
        },
        "cost": {"flops": float(flops)},
        "collectives_hlo": stats,
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "per_axis_s": rl.per_axis_s,
            "dominant": rl.dominant, "model_flops": rl.model_flops,
            "analytic_flops": rl.analytic_flops,
            "useful_ratio": rl.useful_ratio,
            "roofline_fraction": rl.roofline_fraction,
            "step_time_s": rl.step_time_s,
        },
    }
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} mesh={result['mesh']} "
              f"dp_sync={dp_sync}: OK lower={res['lower_s']:.1f}s "
              f"mem/dev={result['memory']['per_device_total_gib']}GiB "
              f"(of {CARD_GIB} GiB) dominant={rl.dominant} "
              f"frac={rl.roofline_fraction:.3f}")
        print("  memory:", json.dumps(result["memory"]))
        print("  flops/dev=%.3e" % flops)
        print("  collectives:", json.dumps(stats["bytes_by_kind"]))
    return result


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                dp_sync: str = "gspmd", verbose: bool = True,
                kv_quant: bool = False,
                mesh_split: tuple[int, int] | None = None) -> dict:
    """The reference's cell: ``arch``'s published config at the production
    shape ``shape_name`` on the production mesh (or ``mesh_split``'s
    (data, model) split of it), over a fake process group of its size."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ALL_SHAPES, applicable_shapes

    cfg = get_arch(arch)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    if shape not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention"}
    if mesh_split is not None:
        mesh_shape, axes = tuple(mesh_split), ("data", "model")
    elif multi_pod:
        mesh_shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        mesh_shape, axes = (16, 16), ("data", "model")
    fake_process_group(math.prod(mesh_shape))
    return run_cell(cfg, shape, mesh_shape, axes, dp_sync=dp_sync,
                    verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dp-sync", default="gspmd",
                    choices=["gspmd", "themis", "hier_baseline"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--mesh-split", default="",
                    help="override single-pod logical split, e.g. 32x8")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="runs/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        from repro_torch.configs import list_archs
        from repro_torch.configs.base import ALL_SHAPES

        for a in list_archs():
            for s in ALL_SHAPES:
                for mp in (False, True):
                    cells.append((a, s.name, mp))
    else:
        cells.append((args.arch, args.shape, args.multi_pod))

    split = None
    if args.mesh_split:
        split = tuple(int(x) for x in args.mesh_split.split("x"))
    failures = 0
    try:
        for arch, shape, mp in cells:
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}_{args.dp_sync}"
            if args.tag:
                tag += "_" + args.tag
            try:
                res = dryrun_cell(arch, shape, multi_pod=mp, dp_sync=args.dp_sync,
                                  kv_quant=args.kv_quant, mesh_split=split)
            except Exception as e:
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1, default=float)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
