"""DVFS benchmarking (paper Experiment 2 / Fig 5).

Mirrors the paper's methodology: fix the workload, sweep the frequency grid
(applied to every accelerator in the setup), measure median TTFT / median
TPOT and per-stage energy, and build the latency-energy Pareto frontiers.

Stage-wise *independent* frequency selection — disaggregation's unique
capability — is then evaluated by combining the prefill frontier at
phi_p with the decode frontier at phi_d (the engines are physically
separate, so the sweep points compose), and comparing against the best
colocated single-phi point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.fleet.spec import FleetSpec, as_fleet_spec, setup_label
from .costs import DEFAULT_FREQ_GRID
from .energy import ParetoPoint, min_energy_under_slo, pareto_frontier
from .orchestrator import SetupResult, make_cluster
from .request import Request

Setup = Union[str, FleetSpec]


@dataclass
class FrequencySweep:
    setup: str
    prefill_points: List[ParetoPoint]   # (phi, median TTFT, prefill energy)
    decode_points: List[ParetoPoint]    # (phi, median TPOT, decode energy)
    results: Dict[float, SetupResult]

    def prefill_frontier(self) -> List[ParetoPoint]:
        return pareto_frontier(self.prefill_points)

    def decode_frontier(self) -> List[ParetoPoint]:
        return pareto_frontier(self.decode_points)


def _materialize(workload) -> List[Request]:
    """Accept either a zero-arg factory (the legacy t=0 batches) or any
    object with a ``build()`` method (``repro_torch.workload.WorkloadSpec``);
    each call must yield a FRESH request list (requests are mutated by a
    run), which both forms guarantee."""
    build = getattr(workload, "build", None)
    if callable(build):
        return build()
    return workload()


def _route_exp(setup: Setup, cfg, workload, cluster_kw):
    """The sweep cell as a ``repro_torch.exp`` Experiment base (phi applied
    per grid point by the caller) when it is spec-expressible: a
    registered config, no out-of-band cluster kwargs, and a declarative
    workload (``WorkloadSpec`` / ``ClosedLoop`` / ``OpenLoop``). A
    factory callable cannot be content-addressed -> None (direct,
    uncached simulation, the original behavior)."""
    if cluster_kw:
        return None
    from repro_torch.exp.spec import (ClosedLoop, Experiment, OpenLoop,
                                as_cacheable, registered_arch)
    from repro_torch.workload.spec import WorkloadSpec
    arch = registered_arch(cfg)
    if arch is None:
        return None
    if isinstance(workload, WorkloadSpec):
        exp = Experiment(arch=arch, fleet=setup, workload=workload,
                         slo=workload.slo)
    elif isinstance(workload, (ClosedLoop, OpenLoop)):
        exp = Experiment(arch=arch, fleet=setup, workload=workload)
    else:
        return None
    return as_cacheable(exp)


def sweep_frequencies(setup: Setup, cfg: ModelConfig,
                      workload: Callable[[], List[Request]],
                      freq_grid: Tuple[float, ...] = DEFAULT_FREQ_GRID,
                      **cluster_kw) -> FrequencySweep:
    """Run the fixed workload at each grid frequency (set on ALL
    accelerators, as the paper does) and collect per-stage points.
    ``setup`` is a legacy setup name or any ``FleetSpec``; ``workload``
    is a request-list factory or a ``WorkloadSpec``.

    This is the legacy sweep signature, kept as a shim over
    ``repro_torch.exp``: a spec-expressible call routes each grid point
    through the content-addressed result cache (``results`` values are
    then ``RunRecord``s — same ``.metrics`` / ``.energy`` surface);
    factory workloads and custom configs simulate directly as before."""
    label = setup_label(setup)
    base = _route_exp(setup, cfg, workload, cluster_kw)
    # function-local imports keep the core <-> exp import direction
    # acyclic at module load; hoisted above the loop
    from repro_torch.exp import run as _run_exp
    from repro_torch.exp.record import decode_side_j, prefill_side_j
    from repro_torch.exp.runner import count_uncached_sim
    prefill_pts, decode_pts, results = [], [], {}
    for phi in freq_grid:
        if base is not None:
            res = _run_exp(base.with_phi(phi=phi))
        else:
            count_uncached_sim()
            res = make_cluster(setup, cfg, phi=phi, **cluster_kw).run(
                _materialize(workload))
        # each handoff leg is attributed to the stage that runs it,
        # using the routed TransferPath's actual LegCosts (tagged at the
        # call sites): the STORE leg is driven by the prefill side, the
        # FETCH leg occupies the decode engine at admission. One rule,
        # shared with fig5 and the F6 claim check (repro_torch.exp.record).
        prefill_pts.append(ParetoPoint(
            phi=phi, latency_s=res.metrics.median_ttft_s,
            energy_j=prefill_side_j(res.energy.by_stage), label=label))
        decode_pts.append(ParetoPoint(
            phi=phi, latency_s=res.metrics.median_tpot_s,
            energy_j=decode_side_j(res.energy.by_stage), label=label))
        results[phi] = res
    return FrequencySweep(setup=label, prefill_points=prefill_pts,
                          decode_points=decode_pts, results=results)


def sweep_independent(setup: Setup, cfg: ModelConfig,
                      workload: Callable[[], List[Request]],
                      freq_grid: Tuple[float, ...] = DEFAULT_FREQ_GRID,
                      **cluster_kw) -> List[Dict]:
    """True stage-wise independent scaling for disaggregated setups: run
    the workload at every (phi_prefill, phi_decode) pair. This is the
    capability colocated serving cannot express (one clock drives both
    stages) — the paper's Experiment 2 question is whether any pair beats
    the colocated frontier. Returns one record per pair. Works for any
    disaggregated fleet shape: the pair sets every instance of a stage."""
    assert as_fleet_spec(setup).is_disaggregated, \
        "independent scaling needs separate prefill/decode engines"
    base = _route_exp(setup, cfg, workload, cluster_kw)
    from repro_torch.exp import run as _run_exp
    from repro_torch.exp.record import decode_side_j, prefill_side_j
    from repro_torch.exp.runner import count_uncached_sim
    records = []
    for phi_p in freq_grid:
        for phi_d in freq_grid:
            if base is not None:
                res = _run_exp(base.with_phi(phi_prefill=phi_p,
                                             phi_decode=phi_d))
            else:
                count_uncached_sim()
                res = make_cluster(setup, cfg, phi_prefill=phi_p,
                                   phi_decode=phi_d,
                                   **cluster_kw).run(_materialize(workload))
            records.append({
                "phi_prefill": phi_p, "phi_decode": phi_d,
                "ttft_s": res.metrics.median_ttft_s,
                "tpot_s": res.metrics.median_tpot_s,
                "energy_j": (prefill_side_j(res.energy.by_stage)
                             + decode_side_j(res.energy.by_stage)),
                "total_energy_j": res.energy.total_j,
            })
    return records


def best_independent(records: List[Dict],
                     ttft_slo_s: Optional[float] = None,
                     tpot_slo_s: Optional[float] = None) -> Optional[Dict]:
    feasible = [r for r in records
                if (ttft_slo_s is None or r["ttft_s"] <= ttft_slo_s)
                and (tpot_slo_s is None or r["tpot_s"] <= tpot_slo_s)]
    if not feasible:
        return None
    return min(feasible, key=lambda r: r["energy_j"])


def best_total_energy(sweep: FrequencySweep,
                      ttft_slo_s: Optional[float] = None,
                      tpot_slo_s: Optional[float] = None) -> Dict:
    """Minimum total (prefill + decode) energy under optional SLOs.

    Colocated: one phi drives both stages -> choose a single grid point.
    Disaggregated: phi_p and phi_d are independent -> choose the best pair
    (this is the 'independent frequency optimization' the paper tests).
    """
    colocated = sweep.setup.startswith("co")
    best = None
    if colocated:
        for pp, dp in zip(sweep.prefill_points, sweep.decode_points):
            if ttft_slo_s is not None and pp.latency_s > ttft_slo_s:
                continue
            if tpot_slo_s is not None and dp.latency_s > tpot_slo_s:
                continue
            tot = pp.energy_j + dp.energy_j
            if best is None or tot < best["energy_j"]:
                best = {"phi_prefill": pp.phi, "phi_decode": dp.phi,
                        "energy_j": tot, "ttft_s": pp.latency_s,
                        "tpot_s": dp.latency_s}
    else:
        for pp in sweep.prefill_points:
            if ttft_slo_s is not None and pp.latency_s > ttft_slo_s:
                continue
            for dp in sweep.decode_points:
                if tpot_slo_s is not None and dp.latency_s > tpot_slo_s:
                    continue
                tot = pp.energy_j + dp.energy_j
                if best is None or tot < best["energy_j"]:
                    best = {"phi_prefill": pp.phi, "phi_decode": dp.phi,
                            "energy_j": tot, "ttft_s": pp.latency_s,
                            "tpot_s": dp.latency_s}
    return best
