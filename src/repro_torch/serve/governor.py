"""EnergyGovernor — hold a serving-side nJ/classification SLO at run time
(port of ``repro.serve.governor``; host numpy, as there).

The paper's knobs (threshold, hop budget, precision) trade accuracy for
energy *per evaluation*; this module closes the loop for a *service*: the
governor tracks a rolling nJ/classification estimate from evaluation
telemetry (:class:`~repro_torch.core.engine.EvalReport` energy, or raw hop
counts priced by an energy model) and walks a calibrated **policy ladder**
— quality-descending rungs, canonically a
:class:`~repro_torch.core.frontier.Frontier`'s Pareto points — stepping
down (tighten threshold -> drop to int8 -> cut hop budget) whenever the
rolling estimate breaches the budget and stepping back up when sustained
headroom returns:

    frontier = build_frontier(engine, x_cal, y_cal)
    gov = EnergyGovernor(frontier, budget_nj=2.0,
                         model=engine.energy_model())
    batcher = ContinuousBatcher(..., governor=gov)   # serves under the SLO

Per-request contracts ride the same calibration: ``Request(...,
energy_budget_nj=1.0)`` is resolved by :meth:`policy_for_budget` into the
highest-accuracy rung fitting that budget, with the hop budget additionally
clamped so the contract holds even for adversarially hard inputs.

Step-down is immediate (an SLO breach must not persist); step-up requires
``patience`` consecutive compliant observations below ``headroom x budget``
(hysteresis, so the governor does not flap around the boundary).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.frontier import Frontier
from repro_torch.core.policy import FogPolicy


class EnergyGovernor:
    """Walks a quality-descending policy ladder to hold an energy SLO.

    ladder:     a :class:`Frontier` (its Pareto points become the rungs,
                best-accuracy first) or an explicit quality-descending
                ``[FogPolicy]`` list
    budget_nj:  the SLO — rolling mean nJ/classification to stay under;
                None disables stepping (the governor only meters)
    model:      prices raw hop observations (``observe(hops=...)``) —
                anything with ``lane_pj(hops)`` / ``hops_within(pj)``
                (:class:`~repro_torch.core.energy.EnergyModel` or
                :class:`~repro_torch.core.energy.AffineEnergy`).  Optional when
                observations already carry pJ.
    window:     EWMA horizon in classifications for the rolling estimate
    headroom:   step back up only below ``headroom * budget_nj``
    patience:   consecutive compliant observations required to step up
    cooldown:   observations before a rung that *measured* over budget may
                be probed again (default ``4 * window``) — breach memory
                keeps an uncalibrated ladder from flapping, the expiry lets
                quality recover when the traffic mix eases
    warmup:     observations a freshly-entered rung must accumulate before
                the governor acts on its estimate again (default
                ``max(1, window // 8)``) — the EWMA restarts at each
                transition, so without a warmup a single outlier example
                could reseed it, trigger another step-down, and falsely
                stamp the rung's breach memory from a 1-sample estimate
    """

    def __init__(self, ladder: "Frontier | Sequence[FogPolicy]",
                 budget_nj: float | None, model=None, *,
                 window: int = 256, headroom: float = 0.8,
                 patience: int = 3, cooldown: int | None = None,
                 warmup: int | None = None):
        if isinstance(ladder, Frontier):
            self.frontier: Frontier | None = ladder
            rungs = ladder.ladder()
            self._rungs = [p.policy for p in rungs]
            self._predicted_nj = [p.energy_nj for p in rungs]
        else:
            self.frontier = None
            self._rungs = list(ladder)
            self._predicted_nj = None
        if not self._rungs:
            raise ValueError("governor needs at least one ladder rung")
        for i, p in enumerate(self._rungs):
            if p.per_lane:
                raise ValueError(
                    f"ladder rung {i} carries per-lane knobs; rungs are "
                    "scalar policies (the batcher assembles lane vectors)")
        self.budget_nj = budget_nj
        self.model = model
        self.window = int(window)
        self.headroom = float(headroom)
        self.patience = int(patience)
        self.cooldown = (int(cooldown) if cooldown is not None
                         else 4 * self.window)
        self.warmup = (int(warmup) if warmup is not None
                       else max(1, self.window // 8))
        self.rolling_nj: float | None = None
        self._seen = 0
        self._rung_obs = 0
        self._ok_streak = 0
        # per-device rolling estimates (data-parallel serving): the FLEET
        # estimate drives the ladder — one SLO, one control loop — but the
        # per-device view survives rung transitions and exposes skew (a
        # device drawing hard traffic, a straggling replica) that the fleet
        # mean would average away
        self.device_nj: dict[int, float] = {}
        self._device_obs: dict[int, int] = {}
        self._models: dict[str, object] = {}
        # measured cost of rungs that breached the budget, with the
        # observation count at the breach: an uncalibrated ladder learns
        # which rungs are unaffordable the first time it probes them (no
        # flapping), and the cooldown expiry re-admits them once the
        # breach evidence is stale
        self._measured_nj: dict[int, tuple[float, int]] = {}
        # start on the highest rung already predicted to meet the budget
        # (calibration said the rest overspend — don't serve them first)
        self.rung = 0
        if budget_nj is not None and self._predicted_nj is not None:
            fits = [i for i, e in enumerate(self._predicted_nj)
                    if e <= budget_nj]
            self.rung = fits[0] if fits else len(self._rungs) - 1
        self.transitions: list[tuple[int, int, float]] = []  # (from, to, nj)

    # -- state ------------------------------------------------------------
    @property
    def current(self) -> FogPolicy:
        """The active rung's policy (what the batcher serves this step)."""
        return self._rungs[self.rung]

    @property
    def n_rungs(self) -> int:
        return len(self._rungs)

    # -- telemetry --------------------------------------------------------
    def model_for(self, precision: str | None):
        """The pricing model at ``precision`` (derived from ``self.model``
        and cached): an int8 rung's hops must be priced at int8 byte
        widths, or stepping down a precision rung would never show a
        measured saving.  Falls back to the base model when the model
        carries no topology (AffineEnergy prices every precision alike)."""
        if precision is None or self.model is None:
            return self.model
        cached = self._models.get(precision)
        if cached is None:
            import dataclasses
            try:
                cached = dataclasses.replace(self.model,
                                             precision=precision)
            except (TypeError, ValueError):
                cached = self.model
            self._models[precision] = cached
        return cached

    def price(self, hops) -> np.ndarray:
        """Per-example pJ for raw hop telemetry, priced at the ACTIVE
        rung's precision (what the serving batcher feeds the stats)."""
        if self.model is None:
            raise ValueError(
                "pricing raw hop counts needs an energy model; "
                "construct EnergyGovernor(..., model=...)")
        return np.asarray(
            self.model_for(self.current.precision).lane_pj(
                np.asarray(hops)))

    def observe(self, hops=None, energy_pj=None, devices=None) -> float:
        """Fold one batch of telemetry into the rolling estimate.

        Pass ``energy_pj`` (per-example pJ, e.g. ``EvalReport.energy_pj``)
        when available, else ``hops`` to be priced at the active rung's
        precision.  ``devices`` optionally labels each example with the
        serving device index (data-parallel plane) to additionally feed the
        per-device rolling estimates (``device_nj``) — the fleet-wide
        estimate, and the ladder it drives, are unaffected.  Returns the
        updated rolling nJ/classification.
        """
        if energy_pj is None:
            if hops is None:
                raise ValueError("observe() needs hops or energy_pj")
            energy_pj = self.price(hops)
        e = np.asarray(energy_pj, np.float64)
        batch_nj = float(e.mean()) * 1e-3
        n = int(e.size)
        total = self._rung_obs + n
        if self.rolling_nj is None:
            self.rolling_nj = batch_nj
        else:
            # sample-weighted while the rung has seen fewer than `window`
            # examples (exact cumulative mean — a 1-example first batch
            # must not outweigh the 32 that follow), EWMA after
            alpha = min(1.0, n / max(1, min(total, self.window)))
            self.rolling_nj += alpha * (batch_nj - self.rolling_nj)
        self._seen += n
        self._rung_obs = total
        if devices is not None:
            d = np.asarray(devices).reshape(-1)
            if d.shape != e.reshape(-1).shape:
                raise ValueError(
                    f"devices labels {d.shape} must match the energy "
                    f"samples {e.reshape(-1).shape}")
            flat = e.reshape(-1)
            for dev in np.unique(d):
                vals = flat[d == dev]
                self._observe_device(int(dev), float(vals.mean()) * 1e-3,
                                     int(vals.size))
        return self.rolling_nj

    def _observe_device(self, dev: int, batch_nj: float, n: int) -> None:
        """Per-device EWMA, same warm-start weighting as the fleet
        estimate.  Survives rung transitions: it tracks the device, not
        the rung."""
        prev = self.device_nj.get(dev)
        obs = self._device_obs.get(dev, 0) + n
        if prev is None:
            self.device_nj[dev] = batch_nj
        else:
            alpha = min(1.0, n / max(1, min(obs, self.window)))
            self.device_nj[dev] = prev + alpha * (batch_nj - prev)
        self._device_obs[dev] = obs

    def ingest(self, batches) -> FogPolicy:
        """Replay deferred telemetry: ``batches`` is an ordered iterable of
        ``(energy_pj, devices)`` per-step batches (devices may be None).
        Each batch is observed and followed by one control-loop
        :meth:`step`, exactly as if it had been fed live — the batcher's
        deferred-telemetry ``flush()`` drains through here, so deferral
        shifts WHEN the governor acts (flush boundaries) but never what it
        sees.  Returns the active policy after the replay."""
        for energy_pj, devices in batches:
            self.observe(energy_pj=energy_pj, devices=devices)
            self.step()
        return self.current

    def device_summary(self) -> dict:
        """Per-device view: ``{device: {"nj": rolling, "n": observations}}``
        plus the fleet spread (max - min rolling nJ across devices) under
        the ``"spread_nj"`` key of the returned dict's ``None`` entry."""
        out: dict = {dev: {"nj": nj, "n": self._device_obs[dev]}
                     for dev, nj in sorted(self.device_nj.items())}
        if self.device_nj:
            vals = list(self.device_nj.values())
            out[None] = {"spread_nj": max(vals) - min(vals)}
        return out

    # -- the control loop -------------------------------------------------
    def step(self) -> FogPolicy:
        """One governor decision after the latest ``observe``: step down on
        a breach, step up after sustained headroom.  Returns the (possibly
        new) active policy."""
        if self.budget_nj is None or self.rolling_nj is None:
            return self.current
        if self._rung_obs < self.warmup:
            # fresh rung, fresh estimate: don't act (or stamp breach
            # memory) off a handful of possibly-outlier examples
            return self.current
        if self.rolling_nj > self.budget_nj:
            self._ok_streak = 0
            # remember what this rung measured at the breach: the governor
            # will not climb back onto it until the evidence goes stale
            self._measured_nj[self.rung] = (self.rolling_nj, self._seen)
            if self.rung < len(self._rungs) - 1:
                self._move(self.rung + 1)
        elif self.rolling_nj <= self.headroom * self.budget_nj:
            self._ok_streak += 1
            if self._ok_streak >= self.patience and self.rung > 0:
                # only climb onto a rung neither calibration nor a recent
                # measured breach says is unaffordable
                up = self.rung - 1
                pred = (self._predicted_nj[up]
                        if self._predicted_nj is not None else None)
                if ((pred is None or pred <= self.budget_nj)
                        and not self._recently_breached(up)):
                    self._move(up)
                    self._ok_streak = 0
        else:
            self._ok_streak = 0
        return self.current

    def _recently_breached(self, rung: int) -> bool:
        entry = self._measured_nj.get(rung)
        if entry is None:
            return False
        nj, seen_at = entry
        if self._seen - seen_at >= self.cooldown:
            del self._measured_nj[rung]      # stale evidence: probe again
            return False
        return nj > self.budget_nj

    def _move(self, to: int) -> None:
        self.transitions.append((self.rung, to, self.rolling_nj))
        self.rung = to
        # the EWMA estimated the OLD rung's cost; carrying it across the
        # transition would misattribute stale breaches to the new rung
        # (cascading one expensive burst down the whole ladder and falsely
        # stamping every rung on the way) — start the estimate fresh
        self.rolling_nj = None
        self._rung_obs = 0
        self._ok_streak = 0

    # -- per-request contracts --------------------------------------------
    def policy_for_budget(self, energy_budget_nj: float) -> FogPolicy:
        """Resolve a per-request nJ contract into a scalar policy: the
        highest-accuracy calibrated rung fitting the budget, with the hop
        budget clamped (via the energy model) so even adversarially hard
        inputs cannot overspend it.

        Without a frontier the best rung is taken instead of the cheapest:
        the hop clamp alone already enforces the budget, so giving up
        threshold quality too would punish the request twice.  Only a
        model-less, frontier-less governor degrades to the cheapest rung
        (nothing can price the clamp).

        Raises ValueError when the budget is below even ONE hop's cost at
        the cheapest rung's precision: the first hop is always spent, so
        such a contract is unhonorable and silently overspending it would
        make the "hard" per-request guarantee a lie."""
        if self.frontier is not None:
            try:
                pol = self.frontier.under_budget(energy_budget_nj).policy
            except ValueError:
                pol = self._rungs[-1]      # cheapest rung: best effort
        elif self.model is not None:
            pol = self._rungs[0]           # clamp enforces the budget
        else:
            pol = self._rungs[-1]
        if self.model is not None:
            budget_pj = energy_budget_nj * 1e3
            if budget_pj < self.model_for(pol.precision).per_hop_pj:
                # maybe a cheaper table dtype on the bottom rung still fits
                pol = self._rungs[-1]
                if budget_pj < self.model_for(pol.precision).per_hop_pj:
                    raise ValueError(
                        f"energy budget {energy_budget_nj:.4f} nJ is below "
                        f"one hop's cost "
                        f"({self.model_for(pol.precision).per_hop_pj * 1e-3:.4f}"
                        f" nJ) — the first hop is always spent, so this "
                        "per-request contract cannot be honored")
            cap = self.model_for(pol.precision).hops_within(budget_pj)
            if pol.hop_budget is not None:
                cap = min(cap, int(np.asarray(pol.hop_budget).item()))
            pol = pol.replace(hop_budget=cap)
        return pol

    def summary(self) -> str:
        nj = ("n/a" if self.rolling_nj is None
              else f"{self.rolling_nj:.3f}")
        budget = ("none" if self.budget_nj is None
                  else f"{self.budget_nj:.3f}")
        s = (f"rolling {nj} nJ / budget {budget} nJ, rung "
             f"{self.rung + 1}/{len(self._rungs)}, "
             f"{len(self.transitions)} transitions, "
             f"{self._seen} classifications")
        if self.device_nj:
            vals = list(self.device_nj.values())
            s += (f", {len(vals)} devices "
                  f"(spread {max(vals) - min(vals):.3f} nJ)")
        return s


class TenantLedger:
    """Per-tenant energy budget ledger: one independent
    :class:`EnergyGovernor` per tenant behind a single serving process.

    Each tenant's governor walks its own ladder under its own nJ budget —
    one tenant's expensive traffic steps *that tenant's* rung down and
    leaves every other tenant's estimate untouched (the batcher groups hop
    telemetry by tenant before feeding it here).  The optional ``default``
    governor serves requests whose tenant has no ledger entry; without
    one, unledgered tenants serve the batcher's default policy unpriced.

        ledger = TenantLedger()
        ledger.add("alpha", EnergyGovernor(ladder_a, 2.0, model=model_a))
        ledger.add("beta",  EnergyGovernor(ladder_b, 0.8, model=model_b))
        batcher = ContinuousBatcher(..., governor=ledger, registry=reg)
    """

    def __init__(self, default: EnergyGovernor | None = None):
        if default is not None and default.model is None:
            raise ValueError(
                "the ledger's default governor needs an energy model to "
                "price hop telemetry")
        self._governors: dict[str, EnergyGovernor] = {}
        self.default = default

    def add(self, tenant: str, governor: EnergyGovernor) -> EnergyGovernor:
        """Install one tenant's governor (replacing any previous one)."""
        if governor.model is None:
            raise ValueError(
                f"tenant {tenant!r}: a ledgered governor needs an energy "
                "model to price hop telemetry; construct "
                "EnergyGovernor(..., model=...)")
        self._governors[tenant] = governor
        return governor

    def governor_for(self, tenant: str | None) -> EnergyGovernor | None:
        """The governor billing ``tenant`` (the default when unledgered)."""
        if tenant is not None and tenant in self._governors:
            return self._governors[tenant]
        return self.default

    def tenants(self) -> list[str]:
        return sorted(self._governors)

    def items(self):
        return sorted(self._governors.items())

    def summary(self) -> str:
        lines = [f"{t}: {g.summary()}" for t, g in self.items()]
        return "\n".join(lines) if lines else "no ledgered tenants"


def default_ladder(base: FogPolicy, model=None,
                   budget_nj: float | None = None) -> list[FogPolicy]:
    """An uncalibrated quality-descending ladder when no frontier exists:
    the rung order — tighten threshold, drop to int8, cut the hop
    budget (sized from the model + budget when both are given, else 2)."""
    t = float(np.asarray(base.threshold).mean())
    tight = base.replace(threshold=t * 0.5)
    int8 = tight.replace(precision="int8")
    if model is not None and budget_nj is not None:
        cap = model.hops_within(budget_nj * 1e3)
    else:
        cap = 2
    return [base, tight, int8, int8.replace(hop_budget=cap)]
