"""repro_torch stands alone: it imports neither JAX nor the JAX package,
so it installs on a GPU host without JAX."""
import pytest

pytest.importorskip("torch")

import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # and everything the smoke run imports
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_imports_with_jax_and_repro_blocked():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    # every .py file but the package's own __init__ is one module imported
    n_files = len(list(PKG.rglob("*.py")))
    assert int(proc.stdout.split()[-1]) == n_files - 1 >= 15


def test_no_source_names_jax_or_repro():
    bad = re.compile(r"^\s*(import jax|from jax|import repro(\.|\s|$)"
                     r"|from repro(\.|\s))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in bad.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("module", ["repro_torch.models.mla",
                                    "repro_torch.models.moe",
                                    "repro_torch.models.transformer",
                                    "repro_torch.kernels.autotune",
                                    "repro_torch.train.loop",
                                    "repro_torch.train.checkpoint",
                                    "repro_torch.train.fault",
                                    "repro_torch.launch.train",
                                    "repro_torch.examples.train_lm",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.sharding"])
def test_new_modules_import_first_and_alone(module):
    """Each module of the last slices imports as the first module of a
    fresh process (no import cycle through kernels, forest and the
    tuner), with JAX and the JAX package blocked."""
    code = (f"import sys\nsys.modules['jax'] = None\n"
            f"sys.modules['repro'] = None\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
            f"import {module}\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", \
        proc.stderr
