from repro_torch.configs.base import get_config  # noqa: F401
