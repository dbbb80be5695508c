"""ModelRegistry — multi-tenant versioned forest artifacts behind one process
(port of ``repro.registry.registry``).

The paper's energy wins only matter at fleet scale if one serving process
can host *many* fields of groves at once: real edge fleets serve several
models per device, and drift retraining (the Adaptive-RF direction) needs
zero-downtime swaps.  This module is that substrate.

A registry roots a directory tree of **tenants** (named models), each with
monotonically versioned ``.npz`` artifacts (the exact
:meth:`~repro_torch.forest.pack.ForestPack.save` format ``FogClassifier``
writes: the JAX package's v1 artifact, so a registry either package wrote
loads in the other) and one ``MANIFEST.json`` naming the live version:

    root/
      alpha/
        MANIFEST.json        {"live": 2, "canary": null, "versions": [1, 2]}
        v00001.npz
        v00002.npz
      beta/
        ...

Every mutation is atomic: artifacts and manifests are written to a temp
file and ``os.replace``'d into place, so a crashed publish can never leave
a tenant pointing at a half-written model.  :meth:`publish` is a
**hot-swap**: the manifest flips to the new version in one in-memory +
on-disk step, in-flight requests keep the version they were assigned at
slot time (the batcher pins ``Request.version`` on slot assignment), and
new requests route to the new live — no draining, no request loss.

Traffic-split rollout: ``publish(tenant, model, canary=0.05)`` keeps the
old live and routes a deterministic hash-split of requests
(:meth:`route`) to the new version.  Per-version
:class:`~repro_torch.serve.scheduler.ServeStats` telemetry (fed by the
batcher) makes the canary judgeable — :meth:`judge_canary` compares live vs canary
mean hops/nJ — and :meth:`promote` / :meth:`abort_canary` settle it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from pathlib import Path

MANIFEST = "MANIFEST.json"
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


@dataclasses.dataclass
class TenantState:
    """One tenant's manifest: the live version, an optional canary split,
    and every version ever published (artifacts are kept for rollback)."""

    live: int | None = None
    canary_version: int | None = None
    canary_fraction: float = 0.0
    versions: list[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        canary = (None if self.canary_version is None else
                  {"version": self.canary_version,
                   "fraction": self.canary_fraction})
        return {"live": self.live, "canary": canary,
                "versions": list(self.versions)}

    @classmethod
    def from_json(cls, d: dict) -> "TenantState":
        c = d.get("canary") or {}
        return cls(live=d.get("live"),
                   canary_version=c.get("version"),
                   canary_fraction=float(c.get("fraction", 0.0)),
                   versions=[int(v) for v in d.get("versions", [])])


class ModelRegistry:
    """Versioned multi-tenant artifact store + deterministic traffic router.

    root:  the registry directory (created on first publish).  Existing
           tenants' manifests are loaded eagerly, so a fresh process serves
           exactly what the last one published.
    """

    def __init__(self, root):
        self.root = Path(root)
        self._tenants: dict[str, TenantState] = {}
        # per-(tenant, version) serving telemetry, fed by the batcher —
        # the evidence judge_canary weighs.  In-memory only: telemetry is
        # a property of this serving process, not of the artifact store.
        self._stats: dict[tuple[str, int], object] = {}
        if self.root.is_dir():
            for mf in sorted(self.root.glob(f"*/{MANIFEST}")):
                self._tenants[mf.parent.name] = TenantState.from_json(
                    json.loads(mf.read_text()))

    # -- introspection -----------------------------------------------------
    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    def versions(self, tenant: str) -> list[int]:
        return list(self._state(tenant).versions)

    def live_version(self, tenant: str) -> int:
        live = self._state(tenant).live
        if live is None:
            raise ValueError(f"tenant {tenant!r} has no live version")
        return live

    def canary(self, tenant: str) -> tuple[int, float] | None:
        st = self._state(tenant)
        if st.canary_version is None:
            return None
        return st.canary_version, st.canary_fraction

    def artifact_path(self, tenant: str, version: int) -> Path:
        return self.root / tenant / f"v{int(version):05d}.npz"

    def _state(self, tenant: str) -> TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            raise ValueError(f"unknown tenant {tenant!r}; published tenants: "
                             f"{self.tenants() or 'none'}")
        return st

    # -- publish / rollback / canary lifecycle ----------------------------
    def publish(self, tenant: str, model, *, canary: float | None = None,
                extra: dict | None = None) -> int:
        """Write ``model`` as the tenant's next version, atomically.

        ``model`` is anything with the ForestPack ``save(path)`` contract
        (a :class:`~repro_torch.forest.pack.ForestPack` or a fitted
        ``FogClassifier``).  Without ``canary`` the new version becomes
        live immediately (hot-swap).  With ``canary=f`` (0 < f < 1) the
        old live keeps serving and a deterministic ``f`` fraction of
        request traffic routes to the new version until :meth:`promote`
        or :meth:`abort_canary`.
        """
        if not _TENANT_RE.match(tenant):
            raise ValueError(
                f"invalid tenant name {tenant!r} (letters, digits, '.', "
                "'_', '-'; must not start with a separator)")
        if canary is not None and not 0.0 < canary < 1.0:
            raise ValueError(f"canary fraction must be in (0, 1), "
                             f"got {canary}")
        st = self._tenants.setdefault(tenant, TenantState())
        if canary is not None and st.live is None:
            raise ValueError(
                f"tenant {tenant!r} has no live version to canary against; "
                "first publish must be a full publish")
        version = (max(st.versions) + 1) if st.versions else 1
        tdir = self.root / tenant
        tdir.mkdir(parents=True, exist_ok=True)
        final = self.artifact_path(tenant, version)
        tmp = tdir / f".{final.name}.tmp"
        from repro_torch.forest.pack import ForestPack
        try:
            if isinstance(model, ForestPack):
                model.save(tmp, extra=extra)
            else:
                model.save(tmp)                    # FogClassifier facade
            os.replace(tmp, final)                 # atomic: all or nothing
        finally:
            tmp.unlink(missing_ok=True)
        st.versions.append(version)
        if canary is None:
            st.live = version
            st.canary_version, st.canary_fraction = None, 0.0
        else:
            st.canary_version, st.canary_fraction = version, float(canary)
        self._write_manifest(tenant, st)
        return version

    def rollback(self, tenant: str, to_version: int | None = None) -> int:
        """Flip live back to ``to_version`` (default: the version published
        before the current live).  Any active canary is aborted — a
        rollback is a judgment that the newest code path misbehaves."""
        st = self._state(tenant)
        if st.live is None:
            raise ValueError(f"tenant {tenant!r} has no live version")
        if to_version is None:
            older = [v for v in st.versions if v < st.live]
            if not older:
                raise ValueError(
                    f"tenant {tenant!r} has nothing older than live "
                    f"v{st.live} to roll back to")
            to_version = max(older)
        if to_version not in st.versions:
            raise ValueError(
                f"tenant {tenant!r} has no version {to_version}; "
                f"published: {st.versions}")
        st.live = int(to_version)
        st.canary_version, st.canary_fraction = None, 0.0
        self._write_manifest(tenant, st)
        return st.live

    def promote(self, tenant: str) -> int:
        """Make the canary version live (ends the split)."""
        st = self._state(tenant)
        if st.canary_version is None:
            raise ValueError(f"tenant {tenant!r} has no active canary")
        st.live = st.canary_version
        st.canary_version, st.canary_fraction = None, 0.0
        self._write_manifest(tenant, st)
        return st.live

    def abort_canary(self, tenant: str) -> None:
        """End the split without promoting (the artifact stays on disk)."""
        st = self._state(tenant)
        st.canary_version, st.canary_fraction = None, 0.0
        self._write_manifest(tenant, st)

    def _write_manifest(self, tenant: str, st: TenantState) -> None:
        mf = self.root / tenant / MANIFEST
        tmp = mf.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(st.to_json(), indent=1))
        os.replace(tmp, mf)

    # -- request routing ---------------------------------------------------
    def route(self, tenant: str, rid) -> int:
        """The version serving request ``rid``: the live version, or — with
        an active canary — the canary version for a deterministic hash
        split of the id space.  Pure function of (tenant, rid, manifest):
        the same request always lands on the same side of the split, and
        retries don't flap across versions."""
        st = self._state(tenant)
        if st.live is None:
            raise ValueError(f"tenant {tenant!r} has no live version")
        if st.canary_version is not None:
            h = zlib.crc32(f"{tenant}/{rid}".encode()) % 10_000
            if h < st.canary_fraction * 10_000:
                return st.canary_version
        return st.live

    # -- artifact loading --------------------------------------------------
    def load(self, tenant: str, version: int | None = None):
        """(ForestPack on the CPU, extra dict) for one tenant version
        (default live)."""
        from repro_torch.forest.pack import ForestPack
        if version is None:
            version = self.live_version(tenant)
        path = self.artifact_path(tenant, version)
        if not path.is_file():
            raise ValueError(
                f"tenant {tenant!r} v{version}: artifact {path} is missing "
                "(registry directory moved or pruned?)")
        return ForestPack.load_with_meta(path)

    # -- per-version telemetry --------------------------------------------
    def stats_for(self, tenant: str, version: int):
        """The (tenant, version) ServeStats bucket (created on first use);
        the batcher feeds it per decoded event when registry-routed."""
        from repro_torch.serve.scheduler import ServeStats
        key = (tenant, int(version))
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = ServeStats()
        return st

    def judge_canary(self, tenant: str) -> dict:
        """Live-vs-canary evidence: per-version event counts, mean hops and
        mean nJ.  ``delta_nj`` < 0 means the canary is cheaper."""
        st = self._state(tenant)
        if st.canary_version is None:
            raise ValueError(f"tenant {tenant!r} has no active canary")
        live, cny = (self.stats_for(tenant, st.live),
                     self.stats_for(tenant, st.canary_version))
        return {
            "live_version": st.live, "canary_version": st.canary_version,
            "canary_fraction": st.canary_fraction,
            "live": {"n_events": live.n_events, "mean_hops": live.mean_hops,
                     "mean_nj": live.mean_energy_nj},
            "canary": {"n_events": cny.n_events, "mean_hops": cny.mean_hops,
                       "mean_nj": cny.mean_energy_nj},
            "delta_nj": cny.mean_energy_nj - live.mean_energy_nj,
        }
