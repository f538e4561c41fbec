"""Load-aware request/KV routing across a fleet (P/D-Serve style).

Two routing decisions exist in a disaggregated fleet and both use the
same policy machinery:

  frontend   which prefill (or colocated) instance admits an arriving
             request — evaluated at the request's arrival event, so a
             load-aware policy sees the live queue state;
  kv         which decode instance receives a finished prefill's KV
             cache — evaluated at prefill completion, so pool pressure
             on the decode side steers the transfer.

Policies (registry ``POLICIES`` / ``make_policy``):

  round-robin              static rotation in arrival order; ignores
                           load entirely (the generalization of the old
                           ``Cluster.submit`` ``i % 2`` split, kept as
                           the regression baseline)
  least-outstanding-tokens pick the engine with the least queued work —
                           remaining prefill + remaining decode tokens
                           across every queue (``Engine.
                           outstanding_tokens``); the FlowKV-style
                           load-aware default for the frontend
  kv-free-space            pick the engine whose paged KV pool has the
                           most free pages — the natural signal for the
                           KV transfer target, where admission is gated
                           by pool reservations, not compute
  min-energy               pick the engine with the least projected
                           joules to absorb the work: the cost model's
                           per-token energy at the instance's CURRENT
                           phi (a governor may have downclocked it)
                           times its outstanding backlog — the
                           energy-aware policy fig8's fleet runs use
  prefix-affinity          pick the engine already holding the longest
                           matched prefix of the request's prompt in
                           its KV store (tiered or flat), falling back
                           to least-outstanding-tokens on cold
                           prefixes — the KV-locality frontend policy
                           DESIGN.md section 15's tiered store exists
                           to feed

Ties are broken with a ``numpy`` Generator seeded from the spec, so a
fleet run is reproducible from ``(spec, workload)`` alone: same seed,
same tie-break sequence, bit-identical metrics.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import Engine


class Policy:
    """Base: ``select(engines, rng, req=None) -> engine``. Stateful
    policies (the round-robin rotation) keep their state on the
    instance, so build a fresh policy per router (``make_policy``).

    ``req`` is the request being routed (None for KV-transfer picks
    made before the request was threaded through, and in older call
    sites/tests) —
    only content-aware policies like ``prefix-affinity`` read it; the
    load-only policies accept and ignore it."""

    name = "base"

    def select(self, engines: Sequence[Engine],
               rng: np.random.Generator, req=None) -> Engine:
        raise NotImplementedError


def _argmin(engines: Sequence[Engine], key: Callable[[Engine], float],
            rng: np.random.Generator) -> Engine:
    """Lowest score wins; exact ties resolved by the seeded generator."""
    scores = [key(e) for e in engines]
    best = min(scores)
    ties = [i for i, s in enumerate(scores) if s == best]
    if len(ties) == 1:
        return engines[ties[0]]
    return engines[ties[int(rng.integers(len(ties)))]]


class RoundRobin(Policy):
    name = "round-robin"

    def __init__(self):
        self._i = 0

    def select(self, engines, rng, req=None):
        e = engines[self._i % len(engines)]
        self._i += 1
        return e


class LeastOutstandingTokens(Policy):
    name = "least-outstanding-tokens"

    def select(self, engines, rng, req=None):
        return _argmin(engines, lambda e: e.outstanding_tokens(), rng)


class KVFreeSpace(Policy):
    name = "kv-free-space"

    @staticmethod
    def _headroom(e: Engine) -> int:
        """Free pages minus reservations already routed here but not
        yet reflected in the pool: ``decode_queue`` entries reserve
        only at ``_admit``, and transfers still in their store leg
        (``inflight_kv_pages``, maintained by the fleet's ``_transfer``)
        have not even arrived — raw ``free_pages`` is blind to both, so
        a burst of prefill completions within one store-latency window
        would all pile onto the same instance."""
        pending = sum(
            e.pool.pages_for(s.ctx + (s.req.output_len - s.req.generated)
                             + 1)
            for s, _, _ in e.decode_queue)
        return e.pool.free_pages - pending \
            - getattr(e, "inflight_kv_pages", 0)

    def select(self, engines, rng, req=None):
        # most headroom == least pool pressure; negate for argmin
        return _argmin(engines, lambda e: -self._headroom(e), rng)


class MinEnergy(Policy):
    """Energy-aware routing (DESIGN.md section 11): fold each
    candidate's power state and projected joules-per-token into the
    score. The projection is first-order — ``CostModel.
    joules_per_token`` at the instance's *current* phi (so an instance a
    governor has parked at a low clock, whose marginal token is cheap,
    is preferred) times the tokens it would have to serve before going
    idle (its backlog + the new unit of work). Queue depth therefore
    still matters, but through the energy lens: a busy-but-efficient
    instance can beat an idle-but-pinned-at-phi-1.0 one."""

    name = "min-energy"

    @staticmethod
    def _projected_j(e: Engine) -> float:
        return e.cost.joules_per_token(e.phi, chunk=e.budget) \
            * (e.outstanding_tokens() + 1)

    def select(self, engines, rng, req=None):
        return _argmin(engines, self._projected_j, rng)


class PrefixAffinity(Policy):
    """KV-locality routing (Dynamo/SGLang cache-aware style, DESIGN.md
    section 15): score each engine by how many of the request's prompt
    tokens are already resident in its KV store (tiered
    ``TieredKVStore.peek_match`` or flat shared ``PrefixCache.
    peek_match`` — both probe without touching LRU order or counters),
    and break score ties by least-outstanding-tokens.

    The score tuple ``(-matched, outstanding)`` makes the cold-prefix /
    no-store case BYTE-IDENTICAL to plain least-outstanding-tokens:
    when every match is 0 the first component never discriminates, the
    tie set and the seeded rng draw sequence are exactly LOT's
    (tests/test_kvstore.py machine-checks this)."""

    name = "prefix-affinity"

    @staticmethod
    def _matched(e: Engine, req) -> int:
        if req is None:
            return 0
        toks = getattr(req, "prompt_tokens", None)
        if toks is None:
            return 0
        store = getattr(e, "kv_store", None)
        if store is not None:
            return store.peek_match(toks)
        cache = getattr(e, "prefix_cache", None)
        if cache is not None:
            return cache.peek_match(toks)
        return 0

    def select(self, engines, rng, req=None):
        return _argmin(
            engines,
            lambda e: (-self._matched(e, req), e.outstanding_tokens()),
            rng)


POLICIES = {
    RoundRobin.name: RoundRobin,
    LeastOutstandingTokens.name: LeastOutstandingTokens,
    KVFreeSpace.name: KVFreeSpace,
    MinEnergy.name: MinEnergy,
    PrefixAffinity.name: PrefixAffinity,
}


def make_policy(name: str) -> Policy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown router policy {name!r}; "
                         f"choose from {sorted(POLICIES)}") from None
    return cls()


class Router:
    """One routing decision point: a policy bound to its target engines
    and a seeded tie-break stream.

    ``accept`` (installed only by controller-active fleets) filters the
    candidate set per pick so routing never sees a sleeping, draining,
    or wrong-role instance; ``pick`` returns None when nothing is
    eligible and the cluster parks the work. When every engine is
    eligible the filtered list is the full list — identical contents
    and order, so policy state and tie-break rng draws match the
    static (accept=None) path bit-for-bit.
    """

    def __init__(self, engines: Sequence[Engine],
                 policy: str = "least-outstanding-tokens", seed: int = 0,
                 accept: Optional[Callable[[Engine], bool]] = None):
        if not engines:
            raise ValueError("router needs >= 1 target engine")
        self.engines: List[Engine] = list(engines)
        self.policy = make_policy(policy)
        self._rng = np.random.default_rng(seed)
        self.accept = accept
        # routing-decision counts per target engine (repro.obs reads
        # this into the metrics registry at end of run)
        self.picks: Dict[str, int] = {}

    def pick(self, req=None) -> Optional[Engine]:
        if self.accept is None:
            if len(self.engines) == 1:   # the 1P:1D / co-1gpu fast path
                e = self.engines[0]
            else:
                e = self.policy.select(self.engines, self._rng, req=req)
        else:
            cands = [e for e in self.engines if self.accept(e)]
            if not cands:
                return None
            if len(cands) == 1:
                e = cands[0]
            else:
                e = self.policy.select(cands, self._rng, req=req)
        key = getattr(e, "name", None)
        if key is not None:          # duck-typed test engines may lack it
            self.picks[key] = self.picks.get(key, 0) + 1
        return e
