"""PackCache — byte-budgeted resident set of packed tables on the card, by
traffic weight (port of ``repro.registry.cache``).

A multi-tenant process cannot keep every (tenant, version, precision)
combination's tables on the card, so the cache holds a byte budget
(``ForestPack.table_bytes`` accounting; int8 tables pack ~4x the fields of
fp32, which is the densification lever) and evicts the *least-trafficked*
pack when a load would overflow it.

Eviction is safe by construction: dropping a cache entry only releases the
cache's reference — a dispatch reading the pack holds its own reference
until harvest (``Pending.pack``), so no launch on any stream reads freed
memory, and an evicted pack reloads lazily from its registry artifact on
the next request that needs it (a miss, not an error).

Traffic weighting is an exponentially-decayed hit counter: every hit adds
1 to the entry's weight, every *miss* (a load event — the only moment
eviction can happen) decays all weights by ``decay``, so a tenant that
went quiet an hour ago cannot pin tables a currently-hot tenant needs.
Two refinements keep the pure-LFU failure modes out:

* a fresh entry is seeded at the *mean* resident weight, not 1.0 — else a
  newly-published version's bucket is always the eviction minimum and a
  stale heavyweight can thrash it in and out of residency forever;
* eviction prefers **stale versions** — buckets whose version is neither
  live nor canary for their tenant (a hot-swap or promote demoted them) —
  over live buckets, whatever their historical weight.

Per-device placement rides the same entries: :meth:`device_pack` makes one
copy per ``torch.device`` (``ForestPack.to``, a blocking copy, so the
tables are in place before any stream reads them) and drops the copies
with the entry at eviction.  The copies are keyed by device, not by
replica: replicas that share a card (one CUDA stream each) share one copy,
so four stream replicas on one card hold the bytes the budget counts, not
four times them.  Every device holds the same resident set, so the budget
models ONE device's bytes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.hits + self.misses)

    def reset(self) -> None:
        self.hits = self.misses = self.evictions = 0


@dataclasses.dataclass
class _Entry:
    pack: object
    nbytes: int
    weight: float = 1.0
    # torch.device -> that device's copy (dropped with the entry)
    device_copies: dict = dataclasses.field(default_factory=dict)


def _device_key(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` is the current card),
    so ``cuda`` and ``cuda:0`` share one copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PackCache:
    """Budgeted (tenant, version, precision) -> ForestPack resident set.

    registry:      the :class:`~repro_torch.registry.registry.ModelRegistry`
                   artifacts reload from on a miss
    budget_bytes:  the bytes packed tables may occupy on one device (every
                   device holds the same resident set)
    decay:         per-miss multiplicative decay of every entry's traffic
                   weight (1.0 = pure hit counts, no recency)
    """

    def __init__(self, registry, budget_bytes: int, *, decay: float = 0.97):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be positive")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.registry = registry
        self.budget_bytes = int(budget_bytes)
        self.decay = float(decay)
        self._entries: dict[tuple, _Entry] = {}
        self.stats = CacheStats()
        self.peak_bytes = 0

    # -- accounting --------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def keys(self) -> list[tuple]:
        return list(self._entries)

    def weight_of(self, tenant: str, version: int, precision: str) -> float:
        return self._entries[(tenant, int(version), precision)].weight

    # -- the lookup path ---------------------------------------------------
    def get(self, tenant: str, version: int, precision: str = "fp32"):
        """The resident pack for one bucket, loading (and evicting) on a
        miss.  The returned pack is on the CPU; replicas use
        :meth:`device_pack` for their device's copy."""
        key = (tenant, int(version), precision)
        entry = self._entries.get(key)
        if entry is not None:
            entry.weight += 1.0
            self.stats.hits += 1
            return entry.pack
        self.stats.misses += 1
        pack, _ = self.registry.load(tenant, version)
        if pack.precision != precision:
            # the artifact's dtype is the publisher's choice; the serving
            # bucket's dtype is the request's — repack on the way in
            pack = pack.astype(precision)
        nbytes = pack.table_bytes
        if nbytes > self.budget_bytes:
            raise ValueError(
                f"pack ({tenant!r}, v{version}, {precision}) needs "
                f"{nbytes} bytes but the whole cache budget is "
                f"{self.budget_bytes} — raise the budget or publish at a "
                "denser precision (int8 tables are ~4x smaller than fp32)")
        for e in self._entries.values():
            e.weight *= self.decay
        self._evict_down_to(self.budget_bytes - nbytes)
        # seed at the mean resident weight: the newcomer competes fairly
        # instead of being the guaranteed eviction minimum
        seed = 1.0
        if self._entries:
            seed = (sum(e.weight for e in self._entries.values())
                    / len(self._entries))
        self._entries[key] = _Entry(pack, nbytes, weight=seed)
        self.peak_bytes = max(self.peak_bytes, self.bytes_used)
        return pack

    def device_pack(self, tenant: str, version: int, precision: str,
                    device):
        """``device``'s copy of the bucket's pack (placed on first use,
        cached on the entry, dropped at eviction); one copy per device,
        whatever number of replicas share it."""
        pack = self.get(tenant, version, precision)
        entry = self._entries[(tenant, int(version), precision)]
        dev = _device_key(device)
        copy = entry.device_copies.get(dev)
        if copy is None:
            copy = entry.device_copies[dev] = pack.to(dev)
        return copy

    def _stale(self, key: tuple) -> bool:
        """Is this bucket's version demoted — neither live nor canary for
        its tenant?  Stale versions are the first eviction candidates."""
        tenant, version, _ = key
        try:
            st = self.registry._state(tenant)
        except ValueError:
            return True                      # tenant gone entirely
        return version != st.live and version != st.canary_version

    def _evict_down_to(self, limit: int) -> None:
        """Drop entries until ``bytes_used <= limit``: stale versions
        first, then lowest traffic weight (ties broken by insertion
        order: oldest goes first)."""
        while self._entries and self.bytes_used > limit:
            key = min(self._entries,
                      key=lambda k: (not self._stale(k),
                                     self._entries[k].weight))
            del self._entries[key]
            self.stats.evictions += 1

    def evict(self, tenant: str, version: int, precision: str) -> bool:
        """Explicitly drop one bucket (e.g. a rolled-back version)."""
        return self._entries.pop((tenant, int(version), precision),
                                 None) is not None

    def summary(self) -> str:
        return (f"{len(self._entries)} packs, {self.bytes_used}/"
                f"{self.budget_bytes} B (peak {self.peak_bytes}), "
                f"hit rate {self.stats.hit_rate:.3f} "
                f"({self.stats.hits}h/{self.stats.misses}m/"
                f"{self.stats.evictions}e)")
