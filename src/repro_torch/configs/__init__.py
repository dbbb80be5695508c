"""Architecture configs: a copy of the JAX package's plain dataclasses
(``ArchConfig``, ``param_count``, the registry and the ten arch files),
kept here so that the port never imports JAX."""
from repro_torch.configs.base import ArchConfig, param_count
from repro_torch.configs.registry import ARCHS, get_arch, smoke_config

__all__ = ["ArchConfig", "param_count", "ARCHS", "get_arch", "smoke_config"]
