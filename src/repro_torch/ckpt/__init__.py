from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    check_themis,
    latest_step,
    read_extra,
    restore,
    save,
    themis_global,
    themis_local,
    themis_record,
)
