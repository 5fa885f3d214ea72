from repro_torch.sharding.specs import (  # noqa: F401
    batch_pspec,
    cache_placements,
    cache_pspec,
    distribute,
    gather,
    opt_placements,
    opt_state_pspec,
    param_placements,
    param_pspec,
    placements,
    spec_of,
)
