"""The port's partition rules (``repro_torch.sharding.specs``) against the
reference's, and their DTensor placements.

For each of the ten architectures at full size and each shape-only mesh
(16x16, 2x16x16, 2x4, 2x2x2): every leaf of the param tree, under fsdp on
and off and zero 0 and 1, gets the same ``param_pspec`` and
``opt_state_pspec``, and every leaf of the decode cache tree (the
reference's ``decode_spec``) the same ``cache_pspec``; the batch rule
agrees on the token, the batch and the cache shapes. Integer and ordering
outputs match exactly. ``placements`` and ``spec_of`` round-trip, and a
tuple entry named out of the mesh's order raises. The multi-rank tests of
the sharded runtime run on gloo ranks (``tests/test_torch_{gspmd,
sharded_serve, pipeline, ckpt_sharded}.py``).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.sharding import specs as jspecs
from repro_torch.configs import ParallelConfig, get_arch, list_archs
from repro_torch.models import build_model
from repro_torch.sharding import specs as tspecs


class FakeMesh:
    """Shape-only stand-in (``tests/test_sharding_specs.py``'s); its axes in
    the order of its shape dict."""

    def __init__(self, **axes):
        self.shape = axes
        self.names = tuple(axes)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x4": dict(data=2, model=4),
          "2x2x2": dict(pod=2, data=2, model=2)}
POLICIES = [dict(fsdp=f, zero=z) for f, z in itertools.product((False, True),
                                                               (0, 1))]


def _norm(spec, rank):
    """A spec as a tuple of rank entries (tuples for several axes)."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    return tuple(out) + (None,) * (rank - len(out))


def _ref_param_leaves(arch):
    spec = jax_build_model(jax_get_arch(arch)).param_spec()
    return [(jspecs._path_str(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_leaves_with_path(spec)]


def _port_param_leaves(arch):
    out = []
    tspecs.tree_map_with_path(lambda path, x: out.append((path, tuple(x.shape))),
                              build_model(get_arch(arch)).param_spec())
    return sorted(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_equal_reference(arch, mesh):
    fm = FakeMesh(**MESHES[mesh])
    ref_leaves = _ref_param_leaves(arch)
    assert sorted(ref_leaves) == _port_param_leaves(arch)
    sizes = {"pods": fm.shape.get("pod", 1), "data": fm.shape["data"],
             "model": fm.shape["model"]}
    for pol in POLICIES:
        jpar, tpar = JParallelConfig(**sizes, **pol), ParallelConfig(**sizes, **pol)
        for path, shape in ref_leaves:
            jp = jspecs.param_pspec(path, shape, fm, jpar)
            tp = tspecs.param_pspec(path, shape, fm, tpar)
            assert tp == _norm(jp, len(shape)), (path, pol)
            jo = jspecs.opt_state_pspec(jp, shape, fm, jpar)
            to = tspecs.opt_state_pspec(tp, shape, fm, tpar)
            assert to == _norm(jo, len(shape)), (path, pol)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    fm = FakeMesh(**MESHES[mesh])
    shape = JShapeConfig("decode", 4096, 128, "decode")
    caches, token, _ = jax_build_model(jax_get_arch(arch)).decode_spec(shape)
    leaves = jax.tree_util.tree_leaves_with_path(caches)
    assert leaves
    for p, x in leaves:
        path = jspecs._path_str(p)
        want = jspecs.cache_pspec(path, x.shape, fm, shape.global_batch)
        got = tspecs.cache_pspec(path, tuple(x.shape), fm, shape.global_batch)
        assert got == _norm(want, len(x.shape)), path
    for s, gb in ((tuple(token.shape), shape.global_batch), ((128, 4096), 128),
                  ((1, 524288), 1), ((6, 32), 6)):
        assert tspecs.batch_pspec(s, fm, gb) == _norm(
            jspecs.batch_pspec(s, fm, gb), len(s))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_round_trip(mesh):
    from torch.distributed.tensor import Replicate, Shard

    fm = FakeMesh(**MESHES[mesh])
    names = fm.names
    for arch in ("llama3-8b", "recurrentgemma-2b", "qwen3-moe-235b-a22b"):
        for path, shape in _ref_param_leaves(arch):
            for pol in POLICIES:
                par = ParallelConfig(**{"pods": fm.shape.get("pod", 1),
                                        "data": fm.shape["data"],
                                        "model": fm.shape["model"]}, **pol)
                spec = tspecs.opt_state_pspec(
                    tspecs.param_pspec(path, shape, fm, par), shape, fm, par)
                pls = tspecs.placements(spec, fm)
                assert len(pls) == len(names)
                assert all(isinstance(p, (Shard, Replicate)) for p in pls)
                assert tspecs.spec_of(pls, fm, len(shape)) == spec
    # a dim over (pod, data) in the mesh's order takes both mesh dims
    if "pod" in names:
        pls = tspecs.placements((("pod", "data"), None), fm)
        assert pls[names.index("pod")] == Shard(0) == pls[names.index("data")]
        assert tspecs.spec_of(pls, fm, 2) == (("pod", "data"), None)
    else:
        assert tspecs.placements(("data", "model"), fm) == (Shard(0), Shard(1))


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-34b",
                                  "recurrentgemma-2b"])
def test_stacked_cache_specs_keep_the_layer_dim_whole(arch, mesh):
    """The port's serving caches at full size, placed as ``place_cache``
    places them: a stacked leaf's layer dim is never split, and its spec is
    the reference's ``cache_pspec`` of one layer. At a batch other than the
    layer count that is the reference's spec of the stacked leaf; at a batch
    equal to it the reference's rule would split the layer dim."""
    from repro_torch.models import recurrent, transformer

    fm = FakeMesh(**MESHES[mesh])
    cfg = get_arch(arch)
    if cfg.family == "hybrid":
        n_stack = cfg.num_layers // len(cfg.block_pattern)
        build = lambda b: recurrent.init_caches(cfg, b, device="meta")
    else:
        n_stack = cfg.num_layers
        build = lambda b: transformer.init_cache(cfg, b, 64, device="meta")
    for batch in (n_stack, 2 * n_stack):
        caches = build(batch)
        stacked = caches["periods"] if cfg.family == "hybrid" else caches
        got = tspecs.cache_specs(stacked, fm, batch, stacked=True)
        seen = []
        for path, x in _leaves_with_path(stacked):
            shape = tuple(x.shape)
            layer = jspecs.cache_pspec(path, shape[1:], fm, batch)
            assert _at(got, path) == (None, *_norm(layer, len(shape) - 1)), path
            whole = _norm(jspecs.cache_pspec(path, shape, fm, batch), len(shape))
            seen.append(whole == _at(got, path))
        assert seen and all(seen) == (batch != n_stack), (batch, seen)
        if cfg.family == "hybrid":
            tail = tspecs.cache_specs(caches["tail"], fm, batch)
            for path, x in _leaves_with_path(caches["tail"]):
                assert _at(tail, path) == _norm(jspecs.cache_pspec(
                    path, tuple(x.shape), fm, batch), x.ndim), path


def _leaves_with_path(tree):
    out = []
    tspecs.tree_map_with_path(lambda path, x: out.append((path, x)), tree)
    return out


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@pytest.mark.parametrize("spec", [(("data", "pod"), None),
                                  (("model", "data", "pod"),),
                                  ("data", "data")])
def test_placements_refuse_what_dtensor_cannot_lay_out(spec):
    with pytest.raises(ValueError):
        tspecs.placements(spec, FakeMesh(pod=2, data=2, model=2))


def test_distribute_wraps_the_same_storage_on_one_rank(tmp_path):
    """On a one-rank mesh every DTensor wraps its param's own storage (the
    card's sharded serving keeps no second copy of the weights)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import leaves
    from repro_torch.train.serve import place_params

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), "cpu")
        assert mesh.device_mesh is not None
        params = build_model(get_arch("llama3-8b", reduced=True)).init(0, "cpu")
        placed = place_params(params, mesh, ParallelConfig())
        for a, b in zip(leaves(params), leaves(placed)):
            assert b.to_local().data_ptr() == a.data_ptr()
            assert torch.equal(b.full_tensor(), a)
    finally:
        dist.destroy_process_group()
