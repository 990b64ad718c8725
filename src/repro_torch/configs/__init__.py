"""Model-architecture configs (one module per assigned family) and the
registry in ``repro_torch.configs.base``."""
