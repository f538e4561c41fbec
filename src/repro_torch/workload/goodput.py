"""SLO attainment and goodput (DESIGN.md section 9).

Goodput follows DistServe (arXiv 2401.09670): the number of completed
requests per second that meet BOTH their TTFT and TPOT SLOs. A request
with no decode phase (single-token output, ``tpot_s is None``) is judged
on TTFT alone. ``max_goodput_rate`` is the paper-style capacity number:
the highest offered rate a setup sustains while attaining the SLO on at
least ``target_attainment`` of requests, located by bisection.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

from repro_torch.core.request import Request, SLO, goodput_stats


# the interactive SLO the benchmarks, example, and regression tests
# share; the documented ~3.6 req/s dis-ici crossover (DESIGN.md
# section 9) is calibrated to it, so tune it HERE, not per-caller
DEFAULT_INTERACTIVE_SLO = SLO(ttft_s=2.0, tpot_s=0.0075)


@dataclass(frozen=True)
class GoodputReport:
    n: int
    attained: int
    attainment: float          # attained / n
    duration_s: float          # first arrival -> last finish
    goodput_rps: float         # attained / duration
    offered_rps: float         # observed arrival rate


def evaluate(reqs: Sequence[Request],
             slo: Optional[SLO] = None) -> GoodputReport:
    """Score a finished workload. ``slo`` overrides each request's own
    SLO when given (one global SLO, the DistServe setting)."""
    assert reqs and all(r.done for r in reqs), "workload not finished"
    attained, duration, offered = goodput_stats(reqs, slo)
    return GoodputReport(
        n=len(reqs), attained=attained, attainment=attained / len(reqs),
        duration_s=duration,
        goodput_rps=attained / max(duration, 1e-9),
        offered_rps=offered)


# ----------------------------------------------------------------------
RunAtRate = Callable[[float], List[Request]]


def _default_attains(setup, cfg, slo: Optional[SLO],
                     target_attainment: float, **runner_kw):
    """rate -> does ``setup`` attain the SLO target at that rate?

    Each probe is one ``run_rate_point`` cell — i.e. a ``repro_torch.exp``
    experiment served from the content-addressed cache whenever the
    cell is spec-expressible — so repeated bisections (fig7's capacity
    search, CI reruns) re-simulate nothing."""
    from .sweep import run_rate_point

    def attains(rate: float) -> bool:
        pt = run_rate_point(setup, cfg, rate, slo=slo, **runner_kw)
        return pt.attainment >= target_attainment

    return attains


def max_goodput_rate(setup: Union[str, "FleetSpec", RunAtRate],  # noqa: F821
                     cfg=None, *,
                     slo: SLO,
                     lo: float = 0.25, hi: float = 32.0,
                     target_attainment: float = 0.9,
                     rel_tol: float = 0.08, max_iters: int = 12,
                     **runner_kw) -> float:
    """Highest offered rate with SLO attainment >= ``target_attainment``.

    ``setup`` is a setup name or ``FleetSpec`` (a fresh cluster per
    probe, the real sweep) or a callable ``rate -> finished requests``
    (stubbed cost models in tests). Assumes attainment is non-increasing
    in rate — true of every work-conserving setup here. Returns 0.0 when even
    ``lo`` misses the target; returns ``hi`` when ``hi`` still attains
    it (the bracket saturated, not a fixed point).
    """
    if callable(setup):
        if cfg is not None or runner_kw:
            raise ValueError(
                "with a callable runner, cfg/workload kwargs are the "
                f"callable's own business: got cfg={cfg!r}, "
                f"kwargs={sorted(runner_kw)}")
        run = setup

        def attains(rate: float) -> bool:
            reqs = run(rate)
            return evaluate(reqs, slo).attainment >= target_attainment
    else:
        attains = _default_attains(setup, cfg, slo, target_attainment,
                                   **runner_kw)

    if not attains(lo):
        return 0.0
    if attains(hi):
        return hi
    for _ in range(max_iters):
        mid = (lo + hi) / 2.0
        if attains(mid):
            lo = mid
        else:
            hi = mid
        if hi - lo <= rel_tol * lo:
            break
    return lo
