from repro_torch.optim.optim import (
    OptState, adamw, sgd, clip_by_global_norm, cosine_schedule,
    linear_warmup_cosine, global_norm, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.optim.compression import (
    CompressionState, compress_int8, decompress_int8, ef_compress_grads,
    init_compression,
)

__all__ = [
    "OptState", "adamw", "sgd", "clip_by_global_norm", "cosine_schedule",
    "linear_warmup_cosine", "global_norm", "tree_leaves", "tree_map",
    "tree_unflatten",
    "CompressionState", "compress_int8", "decompress_int8",
    "ef_compress_grads", "init_compression",
]
