"""The paper's micro-architecture as a ring: groves pinned to shards, the
req/ack handshake as a roll of every shard's queue to the next, driven
through FogEngine (the port's counterpart of the JAX package's
``examples/fog_ring_demo.py``).  The eight shards of ``RingMesh(8)`` are
stacked on one device; each hop walks every shard's grove with the
tree_traverse kernel and updates with grove_aggregate.

    python -m repro_torch.examples.fog_ring_demo              # on the card
    PYTHONPATH=src python -m repro_torch.examples.fog_ring_demo --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import FogEngine, FogPolicy, RingMesh, split
from repro_torch.core.engine import sample_starts
from repro_torch.data import make_dataset
from repro_torch.forest import TrainConfig, train_random_forest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FoG on a grove ring")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=8))
    gc = split(rf, 2)                       # 8 groves -> one per shard
    mesh = RingMesh(8)
    print(f"ring: {mesh.n_shards} shards stacked on {dev}")

    engine = FogEngine(gc, backend="ring", mesh=mesh, use_kernels=True,
                       device=dev)
    x = ds.x_test[:512]
    # the ring's start draw is stratified: 512 / 8 lanes start per shard
    start = sample_starts(torch.Generator(device=dev).manual_seed(0), 512,
                          gc.n_groves, dev, n_shards=mesh.n_shards)
    res = engine.eval(x, policy=FogPolicy(threshold=0.3, max_hops=8),
                      start=start)
    hops = res.hops.cpu().numpy()
    acc = (res.label.cpu().numpy() == ds.y_test[:512]).mean()
    print(f"accuracy          : {acc:.3f}")
    print(f"mean hops         : {hops.mean():.2f} of 8 groves")
    print("ring occupancy    :", " ".join(
        f"hop{j}:{(hops > j).mean():.2f}" for j in range(8)))
    print("Each hop is one handshake: every shard's queue moves to the next "
          "shard.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
