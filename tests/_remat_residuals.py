"""What remat "dots" keeps, read on both sides, for the port's remat tests.

The port's side wraps its selective-checkpoint policy
(``repro_torch.models.common.save_dots``) and records the output of every
op the policy saves in the forward; the reference's side reads
``saved_residuals`` of a ``jax.checkpoint``-ed function. Both give
(rows, cols, dtype) per tensor, the leading dims folded into rows (a 3-D
``x @ W`` runs as one 2-D matmul in the port).
"""
import math

from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.models import common as tc


def saved_by_port(monkeypatch):
    """A list that collects (rows, cols, dtype) of each tensor the port's
    remat "dots" policy keeps in the forward: ``common.save_dots`` wrapped,
    its decisions unchanged."""
    saved = []
    policy = tc.save_dots

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]                    # mm(a, b), addmm(bias, a, b)
            saved.append((a.shape[0], b.shape[1], str(a.dtype).split(".")[-1]))
        return out

    monkeypatch.setattr(tc, "save_dots", spy)
    return saved


def saved_by_reference(unit, *args):
    """(rows, cols, dtype) of the residuals ``jax.checkpoint`` keeps for
    ``unit(*args)`` under its policy, without the unit's own inputs."""
    return [(math.prod(a.shape[:-1]), a.shape[-1], a.dtype.name)
            for a, why in saved_residuals(unit, *args)
            if "from the argument" not in why and "from a constant" not in why]
