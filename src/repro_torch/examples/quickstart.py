"""Quickstart: train a random forest, split it into a Field of Groves,
classify with confidence-gated early exit through FogEngine, and read the
energy meter (the port's counterpart of the JAX package's
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import FogEngine, FogPolicy, rf_report, split
from repro_torch.data import make_dataset
from repro_torch.forest import TrainConfig, rf_predict, train_random_forest
from repro_torch.paper.common import forest_on
from repro_torch.sklearn import FogClassifier


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FoG quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a dataset (synthetic twin of UCI Pen-based digits: 16 features,
    #    10 classes)
    ds = make_dataset("penbased")
    x = torch.as_tensor(ds.x_test, device=dev)

    # 2. conventional RF: 16 trees, depth 8 (Algorithm 1 line 2)
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=8))
    rf_acc = np.mean(rf_predict(forest_on(rf, dev), x).cpu().numpy()
                     == ds.y_test)
    rf_energy = rf_report(1, 16, 8, ds.n_classes).per_example_nj
    print(f"conventional RF : acc={rf_acc:.3f}  energy={rf_energy:.2f} "
          "nJ/example")

    # 3. split into a Field of Groves: 8 groves x 2 trees (Algorithm 1
    #    Split)
    gc = split(rf, 2)

    # 4. one engine owns Algorithm 2; "fused" runs the whole early-exit
    #    loop in one CUDA launch ("pallas": one aggregate launch a hop;
    #    "reference": plain PyTorch; "ring": see fog_ring_demo).  All
    #    backends return identical labels and hop counts.
    engine = FogEngine(gc, backend="fused", device=dev)
    gen = torch.Generator(device=dev)

    # 5. Algorithm 2: random start grove, MaxDiff confidence, hop while
    #    confidence < threshold; every runtime knob travels in a FogPolicy
    for thresh in [0.1, 0.3, 0.6, 1.1]:
        res = engine.eval(x, gen.manual_seed(0),
                          policy=FogPolicy(threshold=thresh))
        acc = np.mean(res.label.cpu().numpy() == ds.y_test)
        hops = res.hops.cpu().numpy()
        e = res.energy_report()   # the EvalReport prices its own evaluation
        tag = " (== RF, every grove votes)" if thresh > 1 else ""
        print(f"FoG thresh={thresh:<4} acc={acc:.3f}  "
              f"mean_hops={hops.mean():.2f}  "
              f"energy={e.per_example_nj:.2f} nJ/example{tag}")

    # 6. per-lane policies: one batch, two QoS tiers
    B = len(ds.y_test)
    tiers = torch.where(torch.arange(B) < B // 2, 0.1, 0.6)
    res = engine.eval(x, gen.manual_seed(0),
                      policy=FogPolicy(threshold=tiers))
    hops = res.hops.cpu().numpy()
    print(f"mixed QoS batch  : mean_hops lo-tier={hops[:B // 2].mean():.2f} "
          f"hi-tier={hops[B // 2:].mean():.2f}")

    # 7. the sklearn-style facade owns train -> split -> engine and meters
    #    energy as it classifies
    clf = FogClassifier(n_trees=16, grove_size=2, max_depth=8,
                        device=dev).fit(ds.x_train, ds.y_train)
    print(f"FogClassifier    : acc={clf.score(ds.x_test, ds.y_test):.3f}  "
          f"profile={clf.profile()['energy_nj_per_classification']:.2f} "
          f"nJ/classification at {clf.profile()['mean_hops']:.2f} mean hops")

    # 8. quantize + persist: int8 packed tables and a versioned .npz
    #    artifact that round-trips through save/load without retraining
    clf.quantize("int8").reset_profile()
    acc8 = clf.score(ds.x_test, ds.y_test)
    nj8 = clf.profile()["energy_nj_per_classification"]
    pack8 = clf.engine_.tables.pack("int8")
    pack32 = clf.engine_.tables.pack("fp32")
    print(f"int8 quantized   : acc={acc8:.3f}  profile={nj8:.2f} nJ  "
          f"tables {pack32.table_bytes // 1024} KiB -> "
          f"{pack8.table_bytes // 1024} KiB")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fog_quickstart.npz"
        clf.save(path)
        reloaded = FogClassifier.load(path, device=dev)
    same = np.array_equal(reloaded.predict(ds.x_test), clf.predict(ds.x_test))
    print(f"save -> load     : precision={reloaded.precision}  "
          f"identical labels: {same}")

    # 9. the energy budget as a control plane: calibrate the frontier over
    #    (threshold x precision), pin the best policy under 2 nJ, and read
    #    measured-vs-budget from the profile
    clf.set_energy_budget(2.0, ds.x_test[:512], ds.y_test[:512])
    acc_b = clf.score(ds.x_test, ds.y_test)
    prof = clf.profile()
    print(f"2 nJ budget      : acc={acc_b:.3f}  "
          f"measured={prof['energy_nj_per_classification']:.2f} nJ  "
          f"within_budget={prof['within_budget']}  "
          f"(pinned thr={clf.policy.threshold}, "
          f"precision={clf.policy.precision})")

    print("\nThe run-time knobs: lower threshold -> fewer groves per input -> "
          "less energy, graceful accuracy decay (paper Fig. 5); int8 packs "
          "-> fewer table bytes per hop.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
