"""Counter / gauge / fixed-bucket-histogram registry.

The aggregate face of observability: where ``obs.trace`` records every
event, the registry holds a small deterministic summary — latency
histograms, fastpath coalescing stats, tier hit rates, router decision
counts — cheap enough to collect on EVERY run (it reads end-of-run
state; no hot-path hooks) and JSON-stable enough to snapshot into
``RunRecord.obs``. Buckets are fixed at registration, so two runs of
the same spec produce byte-identical snapshots (the ``repro.exp``
warm-cache contract extends to this field).

Dependency-free at import time (stdlib only), like ``obs.trace``:
``collect_run_metrics`` duck-types the cluster it summarizes.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BOUNDS_S", "collect_run_metrics"]

# Shared log-spaced latency buckets (seconds): wide enough for queue
# delays at saturation, fine enough to separate TPOT targets. Fixed
# here — per-run adaptive buckets would break snapshot comparability.
LATENCY_BOUNDS_S = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2,
                    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v=1):
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations
    ``<= bounds[i]`` (and ``counts[-1]`` the overflow), plus the exact
    count/sum pair so means survive the bucketing."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS_S):
        self.bounds: Tuple[float, ...] = tuple(bounds)
        assert list(self.bounds) == sorted(self.bounds), bounds
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name -> instrument map with a JSON-safe snapshot. Names are
    dotted paths (``fastpath.coalesced_steps``); get-or-create, so
    collection code never pre-declares."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  bounds: Sequence[float] = LATENCY_BOUNDS_S) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds)
        else:
            assert h.bounds == tuple(bounds), (name, h.bounds, bounds)
        return h

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "sum": h.sum}
                for k, h in sorted(self._histograms.items())},
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        reg = cls()
        for k, v in snap.get("counters", {}).items():
            reg.counter(k).inc(v)
        for k, v in snap.get("gauges", {}).items():
            reg.gauge(k).set(v)
        for k, d in snap.get("histograms", {}).items():
            h = reg.histogram(k, d["bounds"])
            h.counts = list(d["counts"])
            h.count = d["count"]
            h.sum = d["sum"]
        return reg


# ----------------------------------------------------------------------
def collect_run_metrics(cluster, requests,
                        reg: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Summarize a finished run into a registry: request latency
    histograms, fastpath coalescing stats, tier hit rates, router
    decision counts, governor/controller activity. Pure read of
    end-of-run state — calling it never perturbs the cluster."""
    reg = reg or MetricsRegistry()
    h_ttft = reg.histogram("request.ttft_s")
    h_tpot = reg.histogram("request.tpot_s")
    h_queue = reg.histogram("request.queue_s")
    for r in requests:
        if r.ttft_s is not None:
            h_ttft.observe(r.ttft_s)
        if r.tpot_s is not None:
            h_tpot.observe(r.tpot_s)
        if r.queue_s is not None:
            h_queue.observe(r.queue_s)
    reg.counter("request.total").inc(len(requests))
    reg.counter("request.evictions").inc(
        sum(r.evictions for r in requests))
    reg.counter("request.recomputed_tokens").inc(
        sum(r.recomputed_tokens for r in requests))
    reg.counter("request.reused_tokens").inc(
        sum(r.reused_tokens for r in requests))

    engines = getattr(cluster, "engines", [])
    total_steps = sum(e.steps for e in engines)
    reg.counter("engine.steps").inc(total_steps)
    reg.counter("engine.preemptions").inc(
        sum(e.preemptions for e in engines))

    # fastpath coalescing (satellite: perf regressions diagnosable)
    windows = getattr(cluster, "coalesce_windows", 0)
    coalesced = getattr(cluster, "coalesced_steps", 0)
    reg.counter("fastpath.windows").inc(windows)
    reg.counter("fastpath.coalesced_steps").inc(coalesced)
    reg.gauge("fastpath.coalesced_step_fraction").set(
        coalesced / total_steps if total_steps else 0.0)

    # tiered-KV residency (per-store ledgers already exist; fold them)
    hits = misses = 0
    tier_ops: Dict[str, int] = {}
    for e in engines:
        store = getattr(e, "kv_store", None)
        if store is None:
            continue
        hits += store.hits
        misses += store.misses
        for ev in store.events:
            tier_ops[ev["op"]] = tier_ops.get(ev["op"], 0) + 1
    if hits or misses:
        reg.counter("tier.hits").inc(hits)
        reg.counter("tier.misses").inc(misses)
        reg.gauge("tier.hit_rate").set(hits / (hits + misses))
        for op, n in sorted(tier_ops.items()):
            reg.counter(f"tier.{op}").inc(n)

    # router decision counts (Router.picks, maintained per pick)
    for label in ("frontend", "kv_router"):
        router = getattr(cluster, label, None)
        if router is None:
            continue
        key = "kv" if label == "kv_router" else label
        for name, n in sorted(getattr(router, "picks", {}).items()):
            reg.counter(f"router.{key}.{name}").inc(n)

    reg.counter("governor.decisions").inc(
        sum(len(e.governor.decisions) for e in engines
            if getattr(e, "governor", None) is not None))
    reg.counter("controller.actions").inc(
        len(getattr(cluster, "controller_log", []) or []))
    return reg
