"""Multi-tenant model registry: versioned artifacts, hot-swap, canary
routing (:mod:`.registry`) and the byte-budgeted resident pack set on the
card (:mod:`.cache`); port of ``repro.registry``."""
from repro_torch.registry.cache import CacheStats, PackCache
from repro_torch.registry.registry import ModelRegistry, TenantState

__all__ = ["CacheStats", "ModelRegistry", "PackCache", "TenantState"]
