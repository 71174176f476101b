from repro_torch.configs.registry import get_config, get_smoke, list_archs, SHAPES, applicable_shapes  # noqa: F401
