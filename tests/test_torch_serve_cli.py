"""repro_torch's serve CLI (``python -m repro_torch.launch.serve``).

The parser's choices track the port's ``BACKENDS`` and ``PRECISIONS``
(the JAX package's --fog-backend regression); ``--device`` is the one
argument JAX's CLI lacks.  Both modes run on the CPU with ``--device
cpu``: the registry mode over a registry the JAX package published, the
LM mode on a smoke config, each with one and two replicas.  Without
``--device`` and without a card the CLI raises instead of falling back.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.forest import ForestPack as JPack  # noqa: E402
from repro.launch.serve import build_parser as j_build_parser  # noqa: E402
from repro.registry import ModelRegistry as JRegistry  # noqa: E402
from repro_torch.core.policy import BACKENDS, PRECISIONS  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import (build_parser, main,  # noqa: E402
                                      replica_devices)

ROOT = Path(__file__).resolve().parents[1]


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_fog_backend_choices_track_the_port():
    acts = _actions(build_parser())
    assert list(acts["fog_backend"].choices) == list(BACKENDS)
    assert list(acts["fog_precision"].choices) == list(PRECISIONS)


def test_parser_keeps_jax_arguments_and_adds_device():
    mine, theirs = _actions(build_parser()), _actions(j_build_parser())
    assert set(mine) - set(theirs) == {"device"}
    assert set(theirs) <= set(mine)
    for dest, a in theirs.items():
        if dest == "help":
            continue
        assert mine[dest].default == a.default, dest
        assert (list(mine[dest].choices or [])
                == list(a.choices or [])), dest
    assert mine["device"].default == "cuda"
    assert mine["devices"].default == 1
    assert mine["max_queue"].default is None
    assert list(mine["shed_policy"].choices) == ["reject", "oldest"]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_every_backend_parses(backend):
    args = build_parser().parse_args(["--arch", "x", "--fog",
                                      "--fog-backend", backend])
    assert args.fog_backend == backend


@pytest.fixture(scope="module")
def jax_registry(trained, tmp_path_factory):
    """Two tenants published by the JAX package."""
    ds, rf = trained
    root = tmp_path_factory.mktemp("cli") / "reg"
    reg = JRegistry(root)
    pack = JPack.from_groves(jcore.split(rf, 2))
    for t in ("alpha", "beta"):
        reg.publish(t, pack, extra={"n_features_in": ds.x_test.shape[1]})
    reg.publish("beta", pack.astype("int8"),
                extra={"n_features_in": ds.x_test.shape[1]})
    return root


@pytest.mark.parametrize("extra", [[], ["--sync"], ["--devices", "2"],
                                   ["--energy-budget-nj", "0.2",
                                    "--fog-precision", "int8"]],
                         ids=["pipelined", "sync", "two-replicas",
                              "governed"])
def test_registry_mode_on_cpu(jax_registry, extra, capsys):
    out = main(["--device", "cpu", "--registry", str(jax_registry),
                "--requests", "40", "--slots", "8"] + extra)
    assert len(out["done"]) == 40
    assert {r.model for r in out["done"]} == {"alpha", "beta"}
    assert {r.version for r in out["done"] if r.model == "beta"} == {2}
    assert all(r.hops[0] >= 1 for r in out["done"])
    assert out["batcher"].pipeline == ("--sync" not in extra)
    text = capsys.readouterr().out
    assert "40/40 requests over 2 tenants" in text
    if "--energy-budget-nj" in extra:
        assert "[serve] ledger" in text


@pytest.mark.parametrize("devices", ["1", "2"])
def test_lm_mode_on_cpu(devices, capsys):
    out = main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--smoke",
                "--requests", "4", "--slots", "2", "--max-new", "3",
                "--fog", "--fog-backend", "pallas", "--devices", devices,
                "--thresh", "2.0", "--hop-budget", "2"])
    assert len(out["done"]) == 4
    assert all(len(r.generated) == 3 for r in out["done"])
    # the hop budget binds every token (threshold 2.0 never exits)
    assert all(h == 2 for r in out["done"] for h in r.hops)
    assert "groves/token 2.00" in capsys.readouterr().out


def test_lm_mode_plain_and_governed_on_cpu(capsys):
    out = main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--smoke",
                "--requests", "2", "--slots", "2", "--max-new", "2"])
    assert len(out["done"]) == 2 and out["batcher"].stats.n_events == 0
    out = main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--smoke",
                "--requests", "4", "--slots", "2", "--max-new", "4",
                "--fog", "--thresh", "2.0", "--energy-budget-nj", "1e-9"])
    gov = out["governor"]
    assert gov.transitions and gov.rung == gov.n_rungs - 1
    assert "[serve] governor" in capsys.readouterr().out


def test_cli_refusals():
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--smoke",
              "--energy-budget-nj", "1.0"])           # needs --fog
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--smoke",
              "--slots", "3", "--devices", "2"])
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])                      # no --arch
    assert replica_devices("cpu", 3) == [torch.device("cpu")] * 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_is_the_default_and_raises_without_a_card(jax_registry):
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--registry", str(jax_registry)])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "tinyllama-1.1b", "--smoke"])
    with pytest.raises(ValueError, match="CUDA devices"):
        mesh.serve_devices(1)
    with pytest.raises(ValueError, match="CUDA devices"):
        mesh.serve_devices()


def test_module_runs_as_a_script(jax_registry):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--registry", str(jax_registry), "--requests", "8", "--slots", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "8/8 requests over 2 tenants" in proc.stdout
    assert np.isfinite(float(proc.stdout.split(" in ")[1].split("s")[0]))
