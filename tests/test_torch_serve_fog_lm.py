"""repro_torch's mixed-QoS LM serving example
(``src/repro_torch/examples/serve_fog_lm.py``) on the CPU against the JAX
package's own script (``examples/serve_fog_lm.py``, run as it is through
``runpy``): fed the script's own parameters (carried by
``params_from_jax``), every request's generated tokens and per-token hops
equal JAX's.  The weights are untrained, so margins are tiny at the 0.01
threshold: a lane that took the other side of the gate would be a fault,
and the bar is equality."""
from pathlib import Path
import runpy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.examples import serve_fog_lm as ex  # noqa: E402
from repro_torch.models.carry import params_from_jax  # noqa: E402

SCRIPT = Path(__file__).resolve().parents[1] / "examples" / "serve_fog_lm.py"


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's globals after it ran (its ``done``, ``params``,
    ``cfg``, ``TIERS``)."""
    return runpy.run_path(str(SCRIPT), run_name="jax_serve_fog_lm")


def test_settings_are_jax_scripts(jax_run):
    assert ex.config().__dict__ == jax_run["cfg"].__dict__
    assert (ex.N_SLOTS, ex.MAX_SEQ, ex.THRESH) == (
        jax_run["N_SLOTS"], jax_run["MAX_SEQ"], jax_run["THRESH"])
    for name, pol in jax_run["TIERS"].items():
        mine = ex.TIERS[name]
        assert (mine.threshold, mine.hop_budget) == (pol.threshold,
                                                     pol.hop_budget), name
    assert [ex.tier(r) for r in range(8)] == [
        jax_run["tier_of"][r] for r in range(8)]


def test_tokens_and_hops_equal_jax(jax_run):
    cfg = ex.config()
    params = params_from_jax(jax.tree.map(np.asarray, jax_run["params"]),
                             cfg, device="cpu")
    done = {r.rid: r for r in ex.serve(params, cfg, "cpu")}
    want = {r.rid: r for r in jax_run["done"]}
    assert sorted(done) == sorted(want) == list(range(ex.N_REQUESTS))
    for rid, w in want.items():
        got = done[rid]
        assert len(got.generated) == ex.MAX_NEW
        assert [int(t) for t in got.generated] == [int(t)
                                                   for t in w.generated], rid
        assert [int(h) for h in got.hops] == [int(h) for h in w.hops], rid
        if ex.tier(rid) == "budget":
            assert max(got.hops) <= 2


def test_main_runs_on_the_card_by_default(monkeypatch):
    """The entry point's default device is the card: without one it
    raises (the plain path is ``--device cpu``), never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        ex.main([])
