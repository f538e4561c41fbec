"""Rate x setup x medium grid sweeps and the load-crossover locator.

The paper's caveat — disaggregation's benefit "depends on the request
load and KV transfer mediums" — becomes a measurable object here: the
*crossover load*, the offered rate at which the SLO-goodput winner
between a dis-* setup and the equal-resource co-2gpus baseline flips.
On this cost model (repo findings F1/F2) colocation wins below the
crossover — while arrivals rarely overlap there is no interference for
disaggregation to remove, so the KV handoff is pure overhead — and
disaggregation wins above it, where colocated prefill-priority stalls
decode (TPOT inflation) and, past the KV-pool limit, preemption churn
triggers the recompute cliff. Slower media shift the crossover upward;
dis-disk typically never crosses at all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.orchestrator import SETUPS, SetupResult, make_cluster
from repro_torch.core.request import SLO
from repro_torch.fleet.spec import FleetSpec, setup_label

from .goodput import GoodputReport, evaluate
from .lengths import LengthMix
from .spec import open_loop_workload

# every sweep knob takes either a legacy setup name or a fleet shape;
# FleetSpec is frozen/hashable, so both forms key the goodput caches
Setup = Union[str, FleetSpec]


@dataclass(frozen=True)
class RatePoint:
    setup: str
    rate: float
    attainment: float
    goodput_rps: float
    offered_rps: float
    median_ttft_s: float
    p99_ttft_s: float
    median_tpot_s: float
    makespan_s: float
    joules_per_token: float
    total_evictions: int
    # energy view (repro_torch.govern): totals + the idle-state share, so
    # rate sweeps expose the idle-power floor alongside goodput
    total_j: float = 0.0
    idle_j: float = 0.0

    def as_row(self) -> List:
        return [self.setup, self.rate, round(self.attainment, 4),
                round(self.goodput_rps, 4), round(self.median_ttft_s, 4),
                round(self.p99_ttft_s, 4),
                round(self.median_tpot_s * 1e3, 3),
                round(self.makespan_s, 2),
                round(self.joules_per_token, 4), self.total_evictions,
                round(self.total_j, 2), round(self.idle_j, 2)]

    ROW_HEADER = ["setup", "rate_rps", "slo_attainment", "goodput_rps",
                  "median_ttft_s", "p99_ttft_s", "median_tpot_ms",
                  "makespan_s", "j_per_token", "evictions",
                  "total_j", "idle_j"]


def _as_experiment(setup: Setup, cfg, rate: float, *, lengths, slo, n,
                   seed, arrival, cluster_kw):
    """The cell as a cacheable ``repro_torch.exp`` spec, or None when it
    cannot be content-addressed (an off-registry / modified config,
    cluster kwargs with no spec equivalent, or unregistered workload
    pieces) and must simulate directly. The gating rules live in
    ``repro_torch.exp.spec`` — shared with the DVFS shims."""
    from repro_torch.exp.spec import (Experiment, apply_spec_knobs,
                                as_cacheable, registered_arch)
    arch = registered_arch(cfg)
    if arch is None:
        return None
    exp = Experiment.open(setup, rate, arch=arch, n=n, arrival=arrival,
                          lengths=lengths, seed=seed, slo=slo)
    exp, leftovers = apply_spec_knobs(exp, cluster_kw)
    if leftovers:
        return None
    return as_cacheable(exp)


def run_rate_point(setup: Setup, cfg, rate: float, *,
                   lengths: Optional[LengthMix] = None,
                   slo: Optional[SLO] = None, n: int = 24, seed: int = 0,
                   arrival: str = "poisson",
                   **cluster_kw) -> RatePoint:
    """One grid cell: an open-loop workload served on ``setup``.

    Routed through ``repro_torch.exp.run`` whenever the cell is expressible
    as a spec — which is every benchmark call — so rate grids,
    crossover bisections, and capacity searches share one
    content-addressed cache across processes. Off-registry configs and
    exotic cluster kwargs fall back to a direct (uncached) simulation."""
    exp = _as_experiment(setup, cfg, rate, lengths=lengths, slo=slo, n=n,
                         seed=seed, arrival=arrival, cluster_kw=cluster_kw)
    if exp is not None:
        from repro_torch.exp import run as run_exp
        rec = run_exp(exp)
        m = rec.metrics
        g = rec.goodput
        return RatePoint(setup=rec.setup, rate=rate,
                         attainment=g["attainment"],
                         goodput_rps=g["goodput_rps"],
                         offered_rps=g["offered_rps"],
                         median_ttft_s=m.median_ttft_s,
                         p99_ttft_s=m.p99_ttft_s,
                         median_tpot_s=m.median_tpot_s,
                         makespan_s=m.makespan_s,
                         joules_per_token=rec.joules_per_token,
                         total_evictions=m.total_evictions,
                         total_j=rec.total_j,
                         idle_j=rec.idle_j)
    from repro_torch.exp.runner import count_uncached_sim
    count_uncached_sim()
    reqs = open_loop_workload(rate, n, lengths=lengths, slo=slo,
                              arrival=arrival, seed=seed)
    res: SetupResult = make_cluster(setup, cfg, **cluster_kw).run(reqs)
    rep: GoodputReport = evaluate(reqs, slo)
    m = res.metrics
    return RatePoint(setup=setup_label(setup), rate=rate,
                     attainment=rep.attainment,
                     goodput_rps=rep.goodput_rps,
                     offered_rps=rep.offered_rps,
                     median_ttft_s=m.median_ttft_s,
                     p99_ttft_s=m.p99_ttft_s,
                     median_tpot_s=m.median_tpot_s,
                     makespan_s=m.makespan_s,
                     joules_per_token=res.joules_per_token,
                     total_evictions=m.total_evictions,
                     total_j=res.energy.total_j,
                     idle_j=res.energy.by_stage.get("idle", 0.0))


def rate_grid(cfg, rates: Sequence[float],
              setups: Sequence[Setup] = SETUPS, **kw) -> List[RatePoint]:
    """The full rate x setup grid (media are setups: dis-ici/host/disk;
    entries may be ``FleetSpec`` shapes, e.g. a P:D-ratio sweep)."""
    return [run_rate_point(s, cfg, r, **kw) for s in setups for r in rates]


# ----------------------------------------------------------------------
def goodput_gap(setup: Setup, baseline: Setup, cfg, rate: float,
                cache: Optional[Dict[Tuple[Setup, float], float]] = None,
                **kw) -> float:
    """goodput(setup) - goodput(baseline) at one offered rate.

    ``cache`` maps (setup, rate) -> goodput_rps and is consulted/filled
    so bisections sharing a baseline (or following a ``rate_grid``) do
    not re-simulate identical cells; entries are only valid for one
    fixed (cfg, workload, slo) combination — the caller's scope."""
    def goodput(s: Setup) -> float:
        key = (s, rate)
        if cache is not None and key in cache:
            return cache[key]
        g = run_rate_point(s, cfg, rate, **kw).goodput_rps
        if cache is not None:
            cache[key] = g
        return g

    return goodput(setup) - goodput(baseline)


@dataclass(frozen=True)
class Crossover:
    """The load at which the goodput winner flips between two setups."""
    rate: float
    winner_below: str
    winner_above: str


def crossover_rate(setup: Setup, cfg, *, baseline: Setup = "co-2gpus",
                   lo: float, hi: float, iters: int = 5,
                   cache: Optional[Dict[Tuple[Setup, float], float]] = None,
                   **kw) -> Optional[Crossover]:
    """Bisect for the offered rate where the goodput winner between
    ``setup`` and ``baseline`` flips, in either orientation.

    On this simulator's seeded physics (findings F1/F2) the flip runs
    co->dis: below the crossover the colocated baseline matches or beats
    dis-* (the KV handoff buys nothing while there is no interference to
    avoid), above it colocated prefill-priority interference — and, past
    the pool limit, preemption churn — hands the win to disaggregation.
    DistServe's orientation (dis wins low, co wins at saturation) is the
    mirror image; ``Crossover`` records who wins on each side rather
    than assuming one. Returns None when there is no sign change inside
    [lo, hi]: one side wins the whole bracket (dis-disk typically never
    beats co-2gpus at any rate).
    """
    if cache is None:
        cache = {}          # at least dedupe within this bisection
    g_lo = goodput_gap(setup, baseline, cfg, lo, cache=cache, **kw)
    g_hi = goodput_gap(setup, baseline, cfg, hi, cache=cache, **kw)
    if g_lo == 0.0 or (g_lo > 0) == (g_hi > 0):
        return None
    lo_wins_setup = g_lo > 0
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        if (goodput_gap(setup, baseline, cfg, mid, cache=cache, **kw) > 0) \
                == lo_wins_setup:
            lo = mid
        else:
            hi = mid
    mid = (lo + hi) / 2.0
    s_label, b_label = setup_label(setup), setup_label(baseline)
    return Crossover(rate=mid,
                     winner_below=s_label if lo_wins_setup else b_label,
                     winner_above=b_label if lo_wins_setup else s_label)
