from repro_torch.models.registry import ModelApi, build_model  # noqa: F401
