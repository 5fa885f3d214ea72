"""The MoE, VLM, audio and SSM families' sharded serving on gloo ranks
against the reference's GSPMD serving on 8 virtual CPU devices, the same
params and prompts.

One reference subprocess per case of ``RUNS``, all at once, serves as the
reference's ``make_serve_fns`` does (params on ``param_shardings``, caches
on ``cache_pspec`` for the global batch, tokens on ``batch_pspec``, under
``mesh_context``), with a cache of ``max_len`` past the last decode step
(R3); the VLM is held to the reference's ``prefill(..., max_len=P+S+steps,
extra_embeds=patches)`` and ``decode_step`` at positions P+S+i (R8). One
spawn of 8 ranks serves every case through the port's
``make_serve_fns(..., mesh=...)`` (a (2, 2) case on the first 4 ranks).
Checks per case, on every rank of its mesh: the prefill logits and 4
greedy decode steps (fed the reference's tokens) within the family's fp32
tolerance of the reference's logits and of the port's own on one device
(``RUNS``), and every cache leaf's placements equal to the reference's
``cache_pspec``,
taken per layer for a stacked leaf (the port keeps the layer dims whole):
the xLSTM's "C", "n", "h", "conv", whisper's "memory" and k/v.
"""
import json
import math

import numpy as np
import pytest

from _gloo_ranks import check_case, run_checks, run_references, spawn, sub_mesh

WORLD = 8
STEPS = 4
# name: (mesh shape, arch, config overrides, prompt length, batch,
# tolerance against the reference (atol and rtol), against the port on one
# device (max abs))
RUNS = {
    "moe16b": ((2, 4), "deepseek-moe-16b", {}, 12, 4, 1e-4, 1e-5),
    # 2 layers over a model axis of 2: the reference's expert rule splits
    # the layer dim of the shared expert's stacked weights
    "moe16b_2x2": ((2, 2), "deepseek-moe-16b", {}, 12, 4, 1e-4, 1e-5),
    # fp32 params (the config's own are bf16)
    "qwen3moe": ((2, 2), "qwen3-moe-235b-a22b", {"param_dtype": "float32"},
                 12, 4, 1e-4, 1e-5),
    # the N(0,1) patches (50x the token embeddings' scale) widen every gap:
    # 5.7e-4 from the reference, 1.7e-4 from one device (the same prompt
    # with patches of 0.02: 6e-6)
    "vlm": ((2, 4), "internvl2-26b", {}, 12, 4, 2e-3, 1e-3),
    "whisper": ((2, 2), "whisper-medium", {}, 12, 4, 1e-4, 5e-5),
    # the reduced xLSTM's decode is sensitive to the order of its sums: the
    # reference's own (2, 2) run lies up to 9.5e-4 (d_model 128: 4.5e-3)
    # from its run on one device over these 4 steps; readings here up to
    # 2.2e-3 (4.8e-3) from the reference, 2.6e-3 (3.1e-3) from one device
    "xlstm": ((2, 2), "xlstm-1.3b", {}, 12, 4, 1e-2, 1e-2),
    # head dim 64: "C", "n", "h" and "conv" split their last dim
    "xlstm_d128": ((2, 2), "xlstm-1.3b", {"d_model": 128}, 12, 4, 1e-2, 1e-2),
}

REFERENCE_SCRIPT = r"""
import ast, json, math, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ParallelConfig, get_arch
from repro.models import build_model, transformer, whisper, xlstm
from repro.models.common import mesh_context
from repro.sharding.specs import (_path_str, batch_pspec, cache_pspec,
                                  param_shardings)

STEPS = 4
res = {}
for name, (shape, arch, over, s, B, tol, tol1) in ast.literal_eval(sys.argv[2]).items():
    mesh = Mesh(np.asarray(jax.devices()[:math.prod(shape)]).reshape(shape),
                ("data", "model"))
    par = ParallelConfig(data=shape[0], model=shape[1])
    cfg = get_arch(arch, reduced=True).replace(remat=False, dtype="float32", **over)
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    extra, plen = None, s
    if cfg.family == "vlm":
        extra = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        plen = s + cfg.num_patches
    if cfg.family == "audio":
        extra = rng.standard_normal((B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    max_len = plen + STEPS
    if cfg.family == "ssm":
        pf = lambda p, t, e: xlstm.prefill(p, t, cfg, max_len)
        cspec = jax.eval_shape(lambda: xlstm.init_caches(cfg, B))
    elif cfg.family == "audio":
        pf = lambda p, t, e: whisper.prefill(p, e, t, cfg, max_len)
        cspec = {"kv": jax.eval_shape(lambda: whisper.init_caches(cfg, B, max_len)),
                 "memory": jax.ShapeDtypeStruct((B, cfg.num_frames, cfg.d_model), jnp.float32)}
    else:
        pf = lambda p, t, e: transformer.prefill(p, t, cfg, max_len, extra_embeds=e)
        cspec = jax.eval_shape(lambda: transformer.init_cache(cfg, B, max_len))
    layer_specs = {}
    def listed(spec, rank):
        return [list(e) if isinstance(e, tuple) else e
                for e in tuple(spec) + (None,) * (rank - len(spec))]
    def rule(path, leaf):
        ps, n = _path_str(path), len(leaf.shape)
        # the rule on one layer of a stacked leaf, its layer dims whole
        lead = 2 if ps.startswith("mlstm/") else 0 if ps == "memory" else 1
        layer_specs[ps] = [None] * lead + listed(
            cache_pspec(ps, leaf.shape[lead:], mesh, B), n - lead)
        return NamedSharding(mesh, cache_pspec(ps, leaf.shape, mesh, B))
    c_shard = jax.tree_util.tree_map_with_path(rule, cspec)
    p_shard = param_shardings(api.param_spec(), mesh, par)
    t_shard = NamedSharding(mesh, batch_pspec((B,), mesh, B))

    def prefill(p, t, e):
        with mesh_context(mesh):
            return pf(p, t, e)

    def decode(p, c, t, pos):
        with mesh_context(mesh):
            return api.decode_step(p, c, t, pos)

    jpf = jax.jit(prefill, in_shardings=(p_shard, None, None), out_shardings=(None, c_shard))
    jdec = jax.jit(decode, in_shardings=(p_shard, c_shard, t_shard, NamedSharding(mesh, P())),
                   out_shardings=(None, c_shard))
    r = {f"p{i}": np.asarray(x, np.float32) for i, x in enumerate(jax.tree.leaves(params))}
    r["tokens"] = toks
    if extra is not None:
        r["extra"] = extra
    logits, caches = jpf(params, jnp.asarray(toks), None if extra is None else jnp.asarray(extra))
    r["prefill"] = np.asarray(logits, np.float32)
    tok = np.argmax(r["prefill"][:, -1], -1).astype(np.int32)
    for i in range(STEPS):
        r[f"tok{i}"] = tok
        logits, caches = jdec(params, caches, jnp.asarray(tok), jnp.asarray(plen + i, jnp.int32))
        r[f"decode{i}"] = np.asarray(logits, np.float32)
        tok = np.argmax(r[f"decode{i}"][:, 0], -1).astype(np.int32)
    r["layer_cache_specs"] = np.asarray(json.dumps(layer_specs))
    res.update({f"{name}/{k}": v for k, v in r.items()})
np.savez(sys.argv[1], **res)
"""


def _check_run(name, ref_path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig, ShapeConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves
    from repro_torch.sharding.specs import spec_of, tree_map_with_path
    from repro_torch.train.serve import make_serve_fns, place_params

    shape, arch, over, s, batch, tol, tol1 = RUNS[name]
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
    single = _serve_single(api, params, ref, s)
    parallel = ParallelConfig(data=shape[0], model=shape[1])
    prefill, decode = make_serve_fns(
        api, "cpu", parallel, mesh=mesh,
        shape=ShapeConfig("serve", s, batch, "decode"))
    params = place_params(params, mesh, parallel)
    inputs = {"tokens": torch.from_numpy(ref["tokens"])}
    plen = s
    if cfg.family == "vlm":
        inputs["patches"] = torch.from_numpy(ref["extra"])
        plen += cfg.num_patches
    if cfg.family == "audio":
        inputs["frames"] = torch.from_numpy(ref["extra"])
    logits, caches = prefill(params, inputs, plen + STEPS)
    outs = [logits.numpy()]
    for i in range(STEPS):
        logits, caches = decode(params, caches, torch.from_numpy(ref[f"tok{i}"]),
                                plen + i)
        outs.append(logits.numpy())
    names = ["prefill"] + [f"decode{i}" for i in range(STEPS)]
    errs = [float(np.abs(o - ref[n]).max()) for o, n in zip(outs, names)]
    errs1 = [float(np.abs(o - w).max()) for o, w in zip(outs, single)]
    assert max(errs1) <= tol1, f"against one device: {errs1}"
    for o, n in zip(outs, names):
        np.testing.assert_allclose(o, ref[n], atol=tol, rtol=tol,
                                   err_msg=f"{n}: {errs}")
    want = json.loads(str(ref["layer_cache_specs"]))
    got = {}
    tree_map_with_path(lambda path, x: got.__setitem__(path, [
        list(e) if isinstance(e, tuple) else e
        for e in spec_of(x.placements, mesh, x.ndim)]), caches)
    assert got == want, f"cache placements {got} != reference specs {want}"
    split = sorted(k for k, v in got.items() if "model" in v)
    return {"max_abs_err": errs, "max_abs_err_one_device": errs1,
            "split_over_model": split}


def _serve_single(api, params, ref, s):
    """The port's single-device serving of the same prompt and tokens (plain
    tensors, no mesh): its prefill and decode logits."""
    import torch

    from repro_torch.train.serve import make_serve_fns

    prefill, decode = make_serve_fns(api, "cpu")
    inputs = {"tokens": torch.from_numpy(ref["tokens"])}
    plen = s
    if api.cfg.family == "vlm":
        inputs["patches"] = torch.from_numpy(ref["extra"])
        plen += api.cfg.num_patches
    if api.cfg.family == "audio":
        inputs["frames"] = torch.from_numpy(ref["extra"])
    logits, caches = prefill(params, inputs, plen + STEPS)
    outs = [logits.numpy()]
    for i in range(STEPS):
        logits, caches = decode(params, caches, torch.from_numpy(ref[f"tok{i}"]),
                                plen + i)
        outs.append(logits.numpy())
    return outs


def _worker(rank, store, out_dir, ref_path):
    run_checks(rank, WORLD, store, out_dir,
               [(name, lambda name=name: _check_run(name, ref_path))
                for name in RUNS])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family_sharded_serve")
    ref_path = tmp / "reference.npz"
    run_references(REFERENCE_SCRIPT, ref_path,
                   [{name: run} for name, run in RUNS.items()], WORLD)
    return spawn(_worker, WORLD, tmp, (str(ref_path),))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RUNS))
def test_family_sharded_serving_matches_reference(results, name):
    values = [v for v in check_case(results, name) if v is not None]
    assert len(values) == math.prod(RUNS[name][0])
    # every rank returns the same whole logits
    assert len({tuple(v["max_abs_err"]) for v in values}) == 1
    split = values[0]["split_over_model"]
    if name == "xlstm_d128":
        assert split == ["mlstm/C", "mlstm/conv", "mlstm/n", "slstm/h"], split
    if name == "whisper":
        assert "memory" in split, split
