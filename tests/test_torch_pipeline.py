"""The port's GPipe pipeline (``train/pipeline.py``) on 4 gloo ranks
against the reference's ``make_pipeline_loss`` on 4 virtual CPU devices:
reduced llama3-8b at 4 layers, a "pipe" axis of 4 stages (one layer each),
8 x 16 tokens in ``n_micro=4`` microbatches, the same params.

Each rank's loss and the gradient of every leaf of its stage's params (its
rows of the stacked blocks, and embed, ln_f and lm_head whole) are held to
the reference's pipeline, to the reference's ``transformer.loss_fn`` and
to the port's own ``loss_fn`` on the whole params. In fp32: the loss
within 1e-5 relative and each leaf within 1e-4 relative L2 of all three.
In bf16 the bound is the reference pipeline's own gap from its
``loss_fn`` (1.2e-4 on a loss of 5.955 and at most 1.4e-2 relative L2 per
leaf): 2e-4 absolute on the loss and 2e-2 per leaf from the port's own
``loss_fn``; from the reference's pipeline and ``loss_fn``, which round in
bf16 apart from the port, that bound plus the distance of the port's
``loss_fn`` from the reference's on the same input (4.2e-4 on the loss and
up to 2.2e-2 per leaf with these params). The gradients are
``loss_fn``'s, not n_stage times larger.
"""
import numpy as np
import pytest

from _gloo_ranks import check_case, run_checks, run_reference, spawn

WORLD = 4
N_MICRO = 4
LAYERS = 4
TOL = {"float32": {"loss_rel": 1e-5, "loss_abs": None, "leaf_rel_l2": 1e-4},
       "bfloat16": {"loss_rel": None, "loss_abs": 2e-4, "leaf_rel_l2": 2e-2}}

REFERENCE_SCRIPT = r"""
import ast, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_arch
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models import transformer as tr
from repro.train.pipeline import make_pipeline_loss

res = {}
mesh = make_mesh((4,), ("pipe",))
for dtype in ast.literal_eval(sys.argv[2]):
    cfg = get_arch("llama3-8b", reduced=True).replace(num_layers=4, remat=False,
                                                      dtype=dtype)
    api = build_model(cfg)
    params = api.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    pipe = make_pipeline_loss(cfg, mesh, n_micro=4)
    lp, gp = jax.jit(jax.value_and_grad(lambda p: pipe(p, jnp.asarray(toks), jnp.asarray(labs))))(params)
    lr, gr = jax.jit(jax.value_and_grad(lambda p: tr.loss_fn(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}, cfg)))(params)
    r = {"tokens": toks, "labels": labs, "pipe_loss": np.asarray(lp),
         "plain_loss": np.asarray(lr)}
    for key, tree in (("p", params), ("pipe_g", gp), ("plain_g", gr)):
        r.update({f"{key}{i}": np.asarray(x, np.float32)
                  for i, x in enumerate(jax.tree.leaves(tree))})
    res.update({f"{dtype}/{k}": v for k, v in r.items()})
np.savez(sys.argv[1], **res)
"""


def _check(dtype, ref_path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.registry import leaves
    from repro_torch.train.pipeline import make_pipeline_loss, stage_split_params

    ref = {k[len(dtype) + 1:]: v for k, v in np.load(ref_path).items()
           if k.startswith(dtype + "/")}
    mesh = Mesh((WORLD,), ("pipe",), "cpu")
    cfg = get_arch("llama3-8b", reduced=True).replace(
        num_layers=LAYERS, remat=False, dtype=dtype)
    params = build_model(cfg).init(0, "cpu")
    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            p.copy_(torch.from_numpy(ref[f"p{i}"]))
    stage = dist.get_rank()
    sp = stage_split_params(params, WORLD, stage)
    ps = leaves(sp)
    for p in ps:
        p.requires_grad_(True)
    loss = make_pipeline_loss(cfg, mesh, N_MICRO)(
        sp, torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"]))
    grads = [g.float().numpy() for g in torch.autograd.grad(loss, ps)]
    # the port's own loss_fn on the whole params
    whole = leaves(params)
    for p in whole:
        p.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "labels": torch.from_numpy(ref["labels"])}
    plain = build_model(cfg).loss_fn(params, batch)
    plain_g = [g.float().numpy() for g in torch.autograd.grad(plain, whole)]
    tol = TOL[dtype]
    per = LAYERS // WORLD
    # the reference's leaves in its order (embed, blocks/..., lm_head, ln_f
    # sorted) are the port's: a stage's leaves take its rows of the blocks
    rows = []
    for key in sorted(sp):
        n = len(leaves(sp[key]))
        rows += [key == "blocks"] * n

    def cut(i, w):
        return w[stage * per:(stage + 1) * per] if rows[i] else w

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the port's loss_fn's distance from the reference's (0 in fp32)
    slack_loss = abs(float(plain) - float(ref["plain_loss"]))
    slack = [rel(cut(i, g), cut(i, ref[f"plain_g{i}"]))
             for i, g in enumerate(plain_g)]
    if dtype == "float32":
        slack_loss, slack = 0.0, [0.0] * len(slack)
    wants = {"port_plain": (float(plain), [cut(i, g) for i, g in enumerate(plain_g)],
                            0.0, [0.0] * len(slack))}
    for which in ("pipe", "plain"):
        wants[f"reference_{which}"] = (
            float(ref[f"{which}_loss"]),
            [cut(i, ref[f"{which}_g{i}"]) for i in range(len(grads))],
            slack_loss, slack)
    out = {"loss": float(loss)}
    for which, (want, want_g, s_loss, s_leaf) in wants.items():
        d = abs(float(loss) - want)
        lim = (tol["loss_rel"] * abs(want) if tol["loss_rel"] else tol["loss_abs"])
        assert d <= lim + s_loss, (which, float(loss), want, s_loss)
        errs = [rel(g, w) for g, w in zip(grads, want_g)]
        bad = [(i, e, s_leaf[i]) for i, e in enumerate(errs)
               if e > tol["leaf_rel_l2"] + s_leaf[i]]
        assert not bad, (which, bad)
        out[which] = {"loss_err": d, "worst_leaf_rel_l2": max(errs)}
    return out


def _worker(rank, store, out_dir, ref_path):
    run_checks(rank, WORLD, store, out_dir,
               [(dt, lambda dt=dt: _check(dt, ref_path)) for dt in TOL])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    ref_path = tmp / "reference.npz"
    run_reference(REFERENCE_SCRIPT, ref_path, list(TOL), WORLD)
    return spawn(_worker, WORLD, tmp, (str(ref_path),))


@pytest.mark.slow
@pytest.mark.parametrize("dtype", list(TOL))
def test_pipeline_loss_and_grads_match_reference(results, dtype):
    values = check_case(results, dtype)
    # the loss is all-reduced: every stage returns the last stage's
    assert len({v["loss"] for v in values}) == 1
