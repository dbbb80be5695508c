"""The serving plane's device list (port of ``repro.launch.mesh``'s
``serve_devices``; the rest of that module builds XLA meshes and has no
counterpart on one card)."""
from __future__ import annotations

import torch


def serve_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` CUDA devices for the data-parallel serving plane
    (None = all of them).  Raises when fewer exist (none, without a card).

    The serving tier replicates the model per replica and shards the
    BATCH, so it wants a flat device list.  To run several replicas on one
    card, repeat its device (``[torch.device("cuda:0")] * 4``): each
    replica gets its own CUDA stream.
    """
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n is None else n
    if want < 1 or want > have:
        raise ValueError(
            f"serve_devices({n}): only {have} CUDA devices exist; repeat a "
            "device to run several replicas on one card, or pass CPU "
            "devices to run the plain path")
    return [torch.device("cuda", i) for i in range(want)]
