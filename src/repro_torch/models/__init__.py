from repro_torch.models.factory import build_model  # noqa: F401
