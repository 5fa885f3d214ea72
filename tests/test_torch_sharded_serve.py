"""The port's sharded serving on gloo ranks against the reference's
GSPMD serving on 8 virtual CPU devices, the same params and prompts.

One reference subprocess serves every case of ``RUNS`` as the reference's
``make_serve_fns`` does (params on ``param_shardings``, caches on
``cache_pspec`` for the global batch, tokens on ``batch_pspec``, under
``mesh_context``), with a cache of ``max_len`` past the last decode step
(R3); one spawn of 8 ranks serves them through the port's
``make_serve_fns(..., mesh=...)`` (a (2, 2) case on the first 4 ranks).
Checks per case, on every rank of its mesh: the prefill logits and 4
greedy decode steps (fed the reference's tokens) within the tolerance
``tests/test_torch_serve.py`` uses for the config (1e-4 in fp32, 3e-2 with
the int8 cache), every cache leaf's placements equal to the reference's
``cache_pspec`` (on one layer of a stacked leaf: the port keeps the layer
dim whole, which the reference's rule splits when the layer count equals
the batch, as in the ``layers_eq_batch`` case), and the attention of every
layer run on H/tp local q heads. Sharded serving refuses whole params.
"""
import json

import numpy as np
import pytest

from _gloo_ranks import check_case, run_checks, run_reference, spawn, sub_mesh

WORLD = 8
STEPS = 4
# name: (mesh shape, arch, config overrides, prompt length, batch, tolerance)
RUNS = {
    "llama3_8b": ((2, 4), "llama3-8b", {}, 12, 4, 1e-4),
    "granite_34b_mqa": ((2, 4), "granite-34b", {}, 12, 4, 1e-4),
    "qwen2_5_3b_bias": ((2, 4), "qwen2.5-3b", {}, 12, 4, 1e-4),
    "llama3_8b_kv_quant": ((2, 4), "llama3-8b", {"kv_quant": True}, 12, 4,
                           3e-2),
    "recurrentgemma_2b": ((2, 2), "recurrentgemma-2b", {}, 40, 4, 1e-4),
    # a batch of as many rows as the reduced config has layers (2): the
    # reference's rule splits the stacked caches' layer dim over "data",
    # the port keeps it whole
    "llama3_8b_layers_eq_batch": ((2, 4), "llama3-8b", {}, 12, 2, 1e-4),
}

REFERENCE_SCRIPT = r"""
import ast, json, math, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ParallelConfig, get_arch
from repro.models import build_model, recurrent, transformer
from repro.models.common import mesh_context
from repro.sharding.specs import (_path_str, batch_pspec, cache_pspec,
                                  param_shardings)

STEPS = 4
res = {}
for name, (shape, arch, over, s, B, tol) in ast.literal_eval(sys.argv[2]).items():
    mesh = Mesh(np.asarray(jax.devices()[:math.prod(shape)]).reshape(shape),
                ("data", "model"))
    par = ParallelConfig(data=shape[0], model=shape[1])
    cfg = get_arch(arch, reduced=True).replace(remat=False, dtype="float32", **over)
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    max_len = s + STEPS
    if cfg.family == "hybrid":
        pf = lambda p, t: recurrent.prefill(p, t, cfg, max_len)
        cspec = jax.eval_shape(lambda: recurrent.init_caches(cfg, B))
    else:
        pf = lambda p, t: transformer.prefill(p, t, cfg, max_len)
        cspec = jax.eval_shape(lambda: transformer.init_cache(cfg, B, max_len))
    specs, layer_specs = {}, {}
    def listed(spec, rank):
        return [list(e) if isinstance(e, tuple) else e
                for e in tuple(spec) + (None,) * (rank - len(spec))]
    def rule(path, leaf):
        ps, n = _path_str(path), len(leaf.shape)
        spec = cache_pspec(ps, leaf.shape, mesh, B)
        specs[ps] = listed(spec, n)
        # the same rule on one layer of a stacked leaf, its layer dim whole
        layer_specs[ps] = (listed(spec, n) if ps.startswith("tail/") else
                           [None] + listed(cache_pspec(ps, leaf.shape[1:], mesh, B), n - 1))
        return NamedSharding(mesh, spec)
    c_shard = jax.tree_util.tree_map_with_path(rule, cspec)
    p_shard = param_shardings(api.param_spec(), mesh, par)
    t_shard = NamedSharding(mesh, batch_pspec((B,), mesh, B))

    def prefill(p, t):
        with mesh_context(mesh):
            return pf(p, t)

    def decode(p, c, t, pos):
        with mesh_context(mesh):
            return api.decode_step(p, c, t, pos)

    jpf = jax.jit(prefill, in_shardings=(p_shard, None), out_shardings=(None, c_shard))
    jdec = jax.jit(decode, in_shardings=(p_shard, c_shard, t_shard, NamedSharding(mesh, P())),
                   out_shardings=(None, c_shard))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    r = {f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    r["tokens"] = toks
    logits, caches = jpf(params, jnp.asarray(toks))
    r["prefill"] = np.asarray(logits, np.float32)
    tok = np.argmax(r["prefill"][:, -1], -1).astype(np.int32)
    for i in range(STEPS):
        r[f"tok{i}"] = tok
        logits, caches = jdec(params, caches, jnp.asarray(tok), jnp.asarray(s + i, jnp.int32))
        r[f"decode{i}"] = np.asarray(logits, np.float32)
        tok = np.argmax(r[f"decode{i}"][:, 0], -1).astype(np.int32)
    r["cache_specs"] = np.asarray(json.dumps(specs))
    r["layer_cache_specs"] = np.asarray(json.dumps(layer_specs))
    res.update({f"{name}/{k}": v for k, v in r.items()})
np.savez(sys.argv[1], **res)
"""


def _check_run(name, ref_path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig, ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.models import common, transformer
    from repro_torch.models.registry import leaves
    from repro_torch.sharding.specs import spec_of, tree_map_with_path
    from repro_torch.train.serve import make_serve_fns, place_params

    shape, arch, over, s, batch, tol = RUNS[name]
    mesh = sub_mesh(shape, ("data", "model"))
    if dist.get_rank() >= mesh.size:
        return None
    ref = {k[len(name) + 1:]: v for k, v in np.load(ref_path).items()
           if k.startswith(name + "/")}
    cfg = get_arch(arch, reduced=True).replace(remat=False, dtype="float32",
                                               **over)
    api = build_model(cfg)
    params = api.init(0, "cpu")
    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            p.copy_(torch.from_numpy(ref[f"p{i}"]))
    heads = []
    inner = common._heads_local

    def counting(fn, q, k, v, *extra):
        def local(ql, *rest):
            heads.append(ql.shape[2])
            return fn(ql, *rest)
        return inner(local, q, k, v, *extra)

    common._heads_local = transformer._heads_local = counting
    try:
        parallel = ParallelConfig(data=shape[0], model=shape[1])
        prefill, decode = make_serve_fns(
            api, "cpu", parallel, mesh=mesh,
            shape=ShapeConfig("serve", s, batch, "decode"))
        try:
            prefill(params, {"tokens": torch.from_numpy(ref["tokens"])}, s + STEPS)
            raise AssertionError("sharded serving took whole params")
        except ValueError:
            pass
        params = place_params(params, mesh, parallel)
        logits, caches = prefill(params, {"tokens": torch.from_numpy(ref["tokens"])},
                                 s + STEPS)
        errs = [float(np.abs(logits.numpy() - ref["prefill"]).max())]
        np.testing.assert_allclose(logits.numpy(), ref["prefill"], atol=tol, rtol=tol)
        for i in range(STEPS):
            logits, caches = decode(params, caches, torch.from_numpy(ref[f"tok{i}"]),
                                    s + i)
            errs.append(float(np.abs(logits.numpy() - ref[f"decode{i}"]).max()))
            np.testing.assert_allclose(logits.numpy(), ref[f"decode{i}"],
                                       atol=tol, rtol=tol)
    finally:
        common._heads_local = transformer._heads_local = inner
    want = json.loads(str(ref["layer_cache_specs"]))
    got = {}
    tree_map_with_path(lambda path, x: got.__setitem__(path, [
        list(e) if isinstance(e, tuple) else e
        for e in spec_of(x.placements, mesh, x.ndim)]), caches)
    assert got == want, f"cache placements {got} != reference specs {want}"
    # the reference's own specs, but where it splits the layer dim
    splits_layers = cfg.num_layers == batch
    assert (want != json.loads(str(ref["cache_specs"]))) == splits_layers
    tp = shape[1]
    assert heads and set(heads) == {cfg.num_heads // tp}, heads
    return {"max_abs_err": errs, "local_q_heads": sorted(set(heads))}


def _worker(rank, store, out_dir, ref_path):
    run_checks(rank, WORLD, store, out_dir,
               [(name, lambda name=name: _check_run(name, ref_path))
                for name in RUNS])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    ref_path = tmp / "reference.npz"
    run_reference(REFERENCE_SCRIPT, ref_path, RUNS, WORLD)
    return spawn(_worker, WORLD, tmp, (str(ref_path),))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_serving_matches_reference(results, name):
    values = [v for v in check_case(results, name) if v is not None]
    assert len(values) == (4 if name == "recurrentgemma_2b" else WORLD)
    # every rank returns the same whole logits
    assert len({tuple(v["max_abs_err"]) for v in values}) == 1
