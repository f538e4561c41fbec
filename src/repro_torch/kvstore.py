"""Multi-tier KV store: HBM -> DRAM -> disk, every movement priced.

DESIGN.md section 15. The flat ``PrefixCache`` (core/prefix_cache.py)
answers "which prefill tokens can this request skip?" but models a
single bottomless-ish pool: pages are either cached or gone. Production
KV offload (NVIDIA Dynamo, LMCache, MoonCake) instead keeps hot pages in
accelerator HBM and spills colder ones down a memory hierarchy — reuse
then costs real tier traffic, priced by the same PCIe/DRAM/NVMe media
the paper's transfer study already models (``core/transfer.py``).

``TieredKVStore`` is that hierarchy at page granularity:

  * Three tiers in fixed order — ``hbm``, ``dram``, ``disk`` — each an
    LRU list with a page-count capacity from ``TierSpec``. A tier with
    capacity 0 is disabled; overflow past the last enabled tier drops
    pages (a free eviction, like the flat cache's LRU popitem).
  * Global-recency inclusion: an access promotes the page to HBM MRU;
    an HBM overflow demotes the HBM-LRU page to DRAM's MRU end (it is
    still hotter than everything already in DRAM), DRAM overflow
    demotes to disk the same way. The concatenation hbm+dram+disk is
    therefore the global LRU order, so the resident set under a larger
    total budget is a superset of the smaller one — hit rate is
    monotone in capacity (tests/test_kvstore.py locks this).
  * **Pins**: pages matched by a lookup are pinned until the consuming
    sequence finishes its prefill (the engine calls ``release``);
    pinned pages are skipped by eviction — demoting KV that a running
    prefill is actively reading would be a use-after-free. A tier may
    transiently exceed capacity when every resident page is pinned.
  * **Pricing**: a demand fetch from DRAM/disk is one batched
    ``fetch_cost`` leg per source tier (stage ``tier-fetch`` — it
    occupies the engine and delays the prefill, landing in TTFT and the
    PowerTrace); a demotion is a ``store_cost`` leg per page (stage
    ``tier-spill`` — asynchronous DMA energy, metered without engine
    occupancy). Every movement is also appended to ``events``, the
    ledger the invariant tests reconcile against the meter.
  * Optional **prefetch**: a demand fetch from a tier drags along up to
    ``prefetch_pages`` of that tier's hottest remaining pages in the
    same batched leg — read-ahead for the sequential consumers a shared
    prefix implies.

Page keys come from ``core.prefix_cache``'s stable blake2b digests:
chain hashes in ``prefix`` mode (position-dependent, longest-prefix
match) and content hashes in ``pic`` mode (position-independent, with
CacheBlend-style ``recompute_frac`` repair) — so a store's residency is
comparable across processes and across engines.

``ReuseSpec`` lives here (re-exported by ``repro.exp`` for backward
compatibility) and gains the optional ``tiers`` field; its ``encode()``
omits ``tiers`` when None so every pre-PR experiment cache hash
survives unchanged.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # typing only — see the runtime imports below
    from repro_torch.core.transfer import LegCost

# repro.core imports live inside the functions that need them:
# core.__init__ transitively imports fleet.cluster, which imports this
# module — a top-level import here would make ``import repro.kvstore``
# as the first repro import blow up on the half-initialized cycle.

TIER_ORDER = ("hbm", "dram", "disk")
REUSE_MODES = ("prefix", "pic")


def _encode_dc(obj) -> dict:
    """Dataclass -> plain dict with tuples as lists (json-canonical)."""
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class TierSpec:
    """Per-tier page budgets. ``disk_pages=0`` disables the disk tier
    (DRAM overflow drops); ``prefetch_pages`` is read-ahead per demand
    fetch (0 = demand-only)."""
    hbm_pages: int = 1024
    dram_pages: int = 4096
    disk_pages: int = 0
    prefetch_pages: int = 0

    def __post_init__(self):
        assert self.hbm_pages >= 1, "HBM tier cannot be empty"
        assert self.dram_pages >= 0 and self.disk_pages >= 0
        assert self.prefetch_pages >= 0

    @property
    def total_pages(self) -> int:
        return self.hbm_pages + self.dram_pages + self.disk_pages

    def capacity(self, tier: str) -> int:
        return {"hbm": self.hbm_pages, "dram": self.dram_pages,
                "disk": self.disk_pages}[tier]

    def encode(self) -> dict:
        return _encode_dc(self)


def as_tier_spec(t) -> Optional["TierSpec"]:
    if t is None or isinstance(t, TierSpec):
        return t
    if isinstance(t, dict):
        return TierSpec(**t)
    raise TypeError(f"cannot interpret {t!r} as a TierSpec")


@dataclass(frozen=True)
class ReuseSpec:
    """KV reuse configuration (paper section II-C + tiered extension).

    ``tiers is None`` -> the flat shared ``PrefixCache`` (pre-PR
    behavior, fast-stepper safe). ``tiers`` set -> one ``TieredKVStore``
    per engine with priced cross-tier traffic (the fast stepper bails
    to exact, DESIGN.md section 15). ``capacity_pages`` only applies to
    the flat cache; the tiered store's budget IS the TierSpec.
    """
    mode: str = "prefix"          # "prefix" | "pic"
    capacity_pages: int = 200_000
    page_size: int = 16
    recompute_frac: float = 0.15
    warm: bool = True             # pre-insert request 0's prompt
    tiers: Optional[TierSpec] = None

    def __post_init__(self):
        assert self.mode in REUSE_MODES, self.mode
        object.__setattr__(self, "tiers", as_tier_spec(self.tiers))

    def encode(self) -> dict:
        d = _encode_dc(self)
        if self.tiers is None:
            d.pop("tiers")        # pre-PR hashes must survive
        else:
            d["tiers"] = self.tiers.encode()
        return d


def as_reuse_spec(r) -> Optional["ReuseSpec"]:
    """None | ReuseSpec | mode string | dict (tiers as nested dict ok)."""
    if r is None or isinstance(r, ReuseSpec):
        return r
    if isinstance(r, str):
        return ReuseSpec(mode=r)
    if isinstance(r, dict):
        return ReuseSpec(**r)     # __post_init__ normalizes tiers
    raise TypeError(f"cannot interpret {r!r} as a ReuseSpec")


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
@dataclass
class TierLookup:
    """Result of ``TieredKVStore.lookup``: the reuse arithmetic (same
    fields/semantics as ``prefix_cache.ReuseResult``) plus the priced
    legs the engine must meter and the pins it must later release."""
    matched_tokens: int
    recompute_tokens: int
    mode: str                     # "prefix" | "pic" | "none"
    fetch_legs: List[LegCost]     # one batched leg per source tier
    spill_legs: List[LegCost]     # demotions displaced by the promotion
    pins: Tuple[int, ...]         # page keys held until release()

    def saved_tokens(self, total: int) -> int:
        return total - self.recompute_tokens


class TieredKVStore:
    """Per-engine HBM->DRAM->disk page store with LRU-with-pin eviction.

    Not thread-safe and not shared: each engine owns one (what KV an
    engine "holds" is exactly what the prefix-affinity router scores).
    """

    def __init__(self, tiers: TierSpec, *, mode: str = "prefix",
                 page_size: int = 16, recompute_frac: float = 0.15,
                 page_bytes: int, host=None):
        assert mode in REUSE_MODES, mode
        self.spec = as_tier_spec(tiers)
        self.mode = mode
        self.page_size = page_size
        self.recompute_frac = recompute_frac
        self.page_bytes = int(page_bytes)
        assert self.page_bytes > 0
        # DRAM sits behind the host-staging path, disk behind NVMe —
        # the exact media the paper's transfer study prices
        from repro_torch.core.transfer import DiskPath, HostPath
        self._paths = {"dram": HostPath(host), "disk": DiskPath(host)}
        # key -> None, LRU order (popitem(last=False) side is coldest)
        self._tier: Dict[str, "collections.OrderedDict[int, None]"] = {
            t: collections.OrderedDict() for t in TIER_ORDER}
        self._pins: Dict[int, int] = {}   # key -> pin count
        self.hits = 0
        self.misses = 0
        # movement ledger: every insert/promote/fetch/spill/drop,
        # reconciled against the EnergyMeter by tests/test_kvstore.py
        self.events: List[dict] = []
        # observability (repro.obs): the owning engine installs its
        # tracer and stamps `now` with its clock before lookup/insert,
        # so tier movements land as instants on the "tier" track
        from repro_torch.obs.trace import NULL_TRACER
        self.tracer = NULL_TRACER
        self.now = 0.0

    # -- residency ------------------------------------------------------
    def _where(self, key: int) -> Optional[str]:
        for t in TIER_ORDER:
            if key in self._tier[t]:
                return t
        return None

    def resident_pages(self) -> int:
        return sum(len(d) for d in self._tier.values())

    def _keys(self, tokens: Sequence[int]) -> List[int]:
        from repro_torch.core.prefix_cache import PrefixCache, _page_hash
        arr = np.asarray(tokens, dtype=np.int64)
        n_full = len(arr) // self.page_size
        pages = [arr[i * self.page_size:(i + 1) * self.page_size]
                 for i in range(n_full)]
        if self.mode == "prefix":
            keys, chain = [], 0
            for p in pages:
                chain = PrefixCache._chain(chain, p)
                keys.append(chain)
            return keys
        return [_page_hash(p) for p in pages]

    # -- ledger ---------------------------------------------------------
    def _event(self, op: str, src: Optional[str], dst: Optional[str],
               pages: int, leg: Optional[LegCost] = None) -> None:
        self.events.append({
            "op": op, "src": src, "dst": dst, "pages": pages,
            "nbytes": pages * self.page_bytes,
            "latency_s": leg.latency_s if leg else 0.0,
            "energy_j": dict(leg.energy_j) if leg else {}})
        if self.tracer.enabled:
            self.tracer.instant("tier", op, self.now,
                                src=src or "", dst=dst or "",
                                pages=pages)

    def ledger_energy_j(self, ops: Sequence[str] = ("fetch", "spill"),
                        ) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for ev in self.events:
            if ev["op"] in ops:
                for c, j in ev["energy_j"].items():
                    out[c] += j
        return dict(out)

    # -- eviction -------------------------------------------------------
    def _demote_one(self, tier: str, spill_legs: List[LegCost]) -> bool:
        """Demote this tier's LRU unpinned page one level down (or drop
        it past the last enabled tier). False when every resident page
        is pinned — the tier then transiently exceeds capacity rather
        than evict KV a running prefill is reading."""
        victim = next((k for k in self._tier[tier]
                       if not self._pins.get(k)), None)
        if victim is None:
            return False
        del self._tier[tier][victim]
        dst = next((t for t in TIER_ORDER[TIER_ORDER.index(tier) + 1:]
                    if self.spec.capacity(t) > 0), None)
        if dst is None:
            self._event("drop", tier, None, 1)
            return True
        # the demoted page is hotter than everything already in dst
        # (it was resident one tier up), so it lands at dst's MRU end —
        # preserving the global-recency inclusion property
        leg = self._paths[dst].store_cost(self.page_bytes)
        self._tier[dst][victim] = None
        self._event("spill", tier, dst, 1, leg)
        spill_legs.append(leg)
        return True

    def _enforce(self, spill_legs: List[LegCost]) -> None:
        for t in TIER_ORDER:
            cap = self.spec.capacity(t)
            while len(self._tier[t]) > cap:
                if not self._demote_one(t, spill_legs):
                    break

    # -- pins -----------------------------------------------------------
    def pin(self, keys: Sequence[int]) -> None:
        for k in keys:
            self._pins[k] = self._pins.get(k, 0) + 1

    def release(self, keys: Sequence[int]) -> List[LegCost]:
        """Drop pins, then re-enforce capacities: a tier that ran over
        budget while fully pinned demotes its overflow the moment the
        pins come off — returned as priced spill legs for the caller to
        meter (the invariant "over capacity => nothing evictable" must
        hold at every quiescent point, not just after inserts)."""
        for k in keys:
            c = self._pins.get(k, 0)
            if c <= 1:
                self._pins.pop(k, None)
            else:
                self._pins[k] = c - 1
        spill: List[LegCost] = []
        self._enforce(spill)
        return spill

    # -- operations -----------------------------------------------------
    def insert(self, tokens: Sequence[int]) -> List[LegCost]:
        """Store every full page of ``tokens`` at HBM MRU; returns the
        priced spill legs for demotions the overflow forced. Pages the
        engine just (re)computed are born in HBM for free; pages found
        in a lower tier are promoted without a fetch leg — their KV was
        just recomputed/repaired in HBM by the prefill that triggered
        this insert, so no tier read occurred."""
        spill: List[LegCost] = []
        n = 0
        promoted = {"dram": 0, "disk": 0}
        for key in self._keys(tokens):
            t = self._where(key)
            if t is not None and t != "hbm":
                del self._tier[t][key]
                promoted[t] += 1
            self._tier["hbm"][key] = None
            self._tier["hbm"].move_to_end(key)
            n += 1
        self._event("insert", None, "hbm", n)
        for src, k in promoted.items():
            if k:
                # free promotion (no leg), but still ledgered: the
                # conservation audit tracks every page leaving a tier
                self._event("promote", src, "hbm", k)
        self._enforce(spill)
        return spill

    def lookup(self, tokens: Sequence[int]) -> TierLookup:
        """Match, promote to HBM, pin. Demand fetches are batched into
        one ``fetch_cost`` leg per source tier (plus read-ahead when
        ``prefetch_pages > 0``); promotions may displace HBM pages,
        priced as spill legs. The caller owns metering both and calling
        ``release(result.pins)`` when its prefill completes."""
        keys = self._keys(tokens)
        total = len(tokens)
        if self.mode == "prefix":
            matched_keys: List[int] = []
            for key in keys:
                if self._where(key) is None:
                    break
                matched_keys.append(key)
        else:
            matched_keys = [k for k in keys if self._where(k) is not None]

        by_src = {"dram": 0, "disk": 0}
        for key in matched_keys:
            src = self._where(key)
            if src != "hbm":
                del self._tier[src][key]
                by_src[src] += 1
            self._tier["hbm"][key] = None
            self._tier["hbm"].move_to_end(key)
        self.pin(matched_keys)

        fetch_legs: List[LegCost] = []
        for src in ("dram", "disk"):
            demand = by_src[src]
            if demand == 0:
                continue
            # read-ahead: drag the source tier's hottest unpinned
            # leftovers along in the same batched leg
            ahead = 0
            for _ in range(self.spec.prefetch_pages):
                extra = next((k for k in reversed(self._tier[src])
                              if not self._pins.get(k)), None)
                if extra is None:
                    break
                del self._tier[src][extra]
                self._tier["hbm"][extra] = None
                self._tier["hbm"].move_to_end(extra)
                ahead += 1
            pages = demand + ahead
            leg = self._paths[src].fetch_cost(pages * self.page_bytes)
            self._event("fetch", src, "hbm", pages, leg)
            fetch_legs.append(leg)

        spill_legs: List[LegCost] = []
        self._enforce(spill_legs)

        matched = len(matched_keys) * self.page_size
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        if self.mode == "pic":
            repair = int(np.ceil(matched * self.recompute_frac))
            return TierLookup(matched, total - matched + repair,
                              "pic" if matched else "none",
                              fetch_legs, spill_legs,
                              tuple(matched_keys))
        return TierLookup(matched, total - matched,
                          "prefix" if matched else "none",
                          fetch_legs, spill_legs, tuple(matched_keys))

    def peek_match(self, tokens: Sequence[int]) -> int:
        """Matched tokens a ``lookup`` would report — no promotion, no
        pins, no LRU touch, no counters (router probes must be free)."""
        keys = self._keys(tokens)
        if self.mode == "prefix":
            n = 0
            for key in keys:
                if self._where(key) is None:
                    break
                n += 1
        else:
            n = sum(1 for k in keys if self._where(k) is not None)
        return n * self.page_size

    # -- invariants (tests/test_kvstore.py) -----------------------------
    def check_invariants(self) -> None:
        seen: set = set()
        for t in TIER_ORDER:
            keys = set(self._tier[t])
            leaked = seen & keys
            assert not leaked, f"pages resident in two tiers: {leaked}"
            seen |= keys
            cap = self.spec.capacity(t)
            if len(keys) > cap:
                unpinned = [k for k in keys if not self._pins.get(k)]
                assert not unpinned, \
                    (f"{t} over capacity ({len(keys)} > {cap}) with "
                     f"unpinned evictable pages {unpinned[:4]}")
        for k, c in self._pins.items():
            assert c > 0, f"non-positive pin count for {k}"
            assert k in seen, f"pinned page {k} is not resident"


__all__ = ["TIER_ORDER", "REUSE_MODES", "TierSpec", "ReuseSpec",
           "TierLookup", "TieredKVStore", "as_tier_spec",
           "as_reuse_spec"]
