from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
