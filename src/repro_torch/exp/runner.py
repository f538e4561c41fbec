"""run(exp) / run_grid(grid): the one driver behind every figure,
sweep, and CLI (DESIGN.md section 12).

``run`` memoizes through the content-addressed ``ResultCache``; a hit
returns the stored ``RunRecord`` without touching the simulator, a miss
simulates, stores, and returns. ``run_grid`` expands a ``Grid`` (or
takes an experiment list), dedupes identical cells, serves hits from
the cache, and fans the misses out over a process pool — the grid is
embarrassingly parallel because every cell is a pure function of its
spec (seeded workloads, seeded routers, no global state).

``SIM_COUNT`` counts actual simulations in this process; the warm-cache
CI lane asserts it stays zero on a second pass.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, List, Optional, Sequence, Union

from repro_torch.configs import get_config

from .cache import ResultCache
from .grid import Grid
from .record import RunRecord
from .spec import Experiment

__all__ = ["run", "run_grid", "simulate", "default_cache",
           "set_default_cache", "sim_count"]

# process-wide simulation counter (cache-layer-independent, so a
# ``cache=None`` run still counts); read via sim_count()
SIM_COUNT = 0
# simulations the legacy entrypoints ran OUTSIDE repro_torch.exp (the
# documented fallbacks in workload.sweep / core.dvfs for off-registry
# configs and non-spec workloads). Counted separately so the warm-cache
# CI contract can also assert no benchmark path regressed into the
# uncached branch.
UNCACHED_SIM_COUNT = 0

_DEFAULT_CACHE: Optional[ResultCache] = None
_NO_CACHE = object()     # sentinel: "explicitly uncached"


def sim_count() -> int:
    return SIM_COUNT


def uncached_sim_count() -> int:
    return UNCACHED_SIM_COUNT


def count_uncached_sim() -> None:
    """Called by the legacy entrypoints' direct-simulation fallbacks."""
    global UNCACHED_SIM_COUNT
    UNCACHED_SIM_COUNT += 1


def default_cache() -> ResultCache:
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = ResultCache()
    return _DEFAULT_CACHE


def set_default_cache(cache: Optional[ResultCache]) -> None:
    """Swap the process-default cache (tests point it at a tmpdir)."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = cache


def _resolve_cache(cache) -> Optional[ResultCache]:
    if cache is _NO_CACHE:
        return default_cache()
    return cache


# ----------------------------------------------------------------------
def simulate(exp: Experiment, *, executor_factory=None,
             tracer=None) -> RunRecord:
    """One uncached simulation of a cell. ``executor_factory`` switches
    the engines to real execution (launch.serve --real); real runs are
    never cached — the record schema captures the simulation aggregate,
    not token streams. ``tracer`` (a ``repro_torch.obs.Tracer``) records the
    run's full event stream; it is purely observational, so the record
    is bit-identical with or without it."""
    global SIM_COUNT
    SIM_COUNT += 1
    from repro_torch.fleet.cluster import FleetCluster
    cfg = get_config(exp.arch)
    reqs = exp.workload.build(exp.slo)
    cluster = FleetCluster(
        exp.fleet, cfg, prefill_token_budget=exp.prefill_token_budget,
        page_size=exp.page_size, executor_factory=executor_factory,
        tracer=tracer)
    if exp.reuse is not None and exp.reuse.tiers is None:
        # flat shared reuse: this pre-tier branch is kept VERBATIM so
        # cached reuse_bench results replay bit-identical
        from repro_torch.core.prefix_cache import PrefixCache
        pc = PrefixCache(capacity_pages=exp.reuse.capacity_pages,
                         page_size=exp.reuse.page_size,
                         pic=(exp.reuse.mode == "pic"),
                         recompute_frac=exp.reuse.recompute_frac)
        if exp.reuse.warm and reqs and reqs[0].prompt_tokens is not None:
            pc.insert(reqs[0].prompt_tokens)
        for e in cluster.engines:
            e.prefix_cache = pc
    elif exp.reuse is not None:
        # tiered: per-engine stores; warming happens inside run() via
        # the cluster's _warm_stores (spills priced at t=0)
        cluster._attach_reuse(exp.reuse)
    result = cluster.run(reqs)
    decisions = sum(len(e.governor.decisions) for e in cluster.engines
                    if e.governor is not None)
    actions = len(getattr(cluster, "controller_log", []) or [])
    from repro_torch.obs.metrics import collect_run_metrics
    obs = collect_run_metrics(cluster, reqs).snapshot()
    return RunRecord.from_result(exp, result,
                                 governor_decisions=decisions,
                                 controller_actions=actions,
                                 requests=reqs, obs=obs)


def run(exp: Experiment, *, cache=_NO_CACHE,
        force: bool = False, executor_factory=None,
        tracer=None) -> RunRecord:
    """The memoized driver: cache hit -> stored record; miss ->
    simulate + store. ``cache=None`` bypasses the cache entirely;
    ``force=True`` re-simulates and overwrites. Real-execution runs
    (``executor_factory``) and traced runs (``tracer``) are always
    uncached — a hit would leave the tracer empty."""
    if executor_factory is not None or tracer is not None:
        return simulate(exp, executor_factory=executor_factory,
                        tracer=tracer)
    cache = _resolve_cache(cache)
    if cache is not None and not force:
        rec = cache.get(exp)
        if rec is not None:
            return rec
    rec = simulate(exp)
    if cache is not None:
        cache.put(rec)
    return rec


# ----------------------------------------------------------------------
def _worker_simulate(exp_json: str) -> dict:
    """Process-pool entry: specs travel as canonical JSON, records come
    back as dicts (both trivially picklable and version-checked)."""
    rec = simulate(Experiment.from_json(exp_json))
    return rec.to_dict()


def run_grid(grid: Union[Grid, Sequence[Experiment]], *,
             parallel: int = 1, cache=_NO_CACHE,
             force: bool = False) -> List[RunRecord]:
    """Run every cell of a grid, returning records in expansion order.

    Identical cells (same content address) are simulated once; cache
    hits cost a JSON read; misses fan out over ``parallel`` worker
    processes (``parallel <= 1`` stays in-process — the right choice
    for small grids, where worker startup dwarfs the simulation).
    """
    exps = grid.expand() if isinstance(grid, Grid) else list(grid)
    cache = _resolve_cache(cache)

    # dedupe on the content address, preserving first-seen order
    order: List[str] = []
    unique = {}
    for e in exps:
        h = e.spec_hash()
        order.append(h)
        if h not in unique:
            unique[h] = e

    records = {}
    misses = []
    for h, e in unique.items():
        rec = cache.get(e) if (cache is not None and not force) else None
        if rec is not None:
            records[h] = rec
        else:
            misses.append((h, e))

    if misses and parallel > 1:
        global SIM_COUNT
        from concurrent.futures import as_completed
        first_error = None
        # spawned, not forked: the parent holds torch's threads and may
        # hold a CUDA context, neither of which survives a fork
        with ProcessPoolExecutor(
                max_workers=parallel,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futs = {pool.submit(_worker_simulate, e.to_json()): h
                    for h, e in misses}
            # persist every record the moment its worker finishes: one
            # failed cell must not discard the completed simulations of
            # the rest of the batch, so survivors are cached before the
            # first failure is re-raised
            for fut in as_completed(futs):
                try:
                    rec = RunRecord.from_dict(fut.result())
                except Exception as e:  # noqa: BLE001 — re-raised below
                    if first_error is None:
                        first_error = e
                    continue
                records[futs[fut]] = rec
                SIM_COUNT += 1
                if cache is not None:
                    cache.put(rec)
        if first_error is not None:
            raise first_error
    else:
        for h, e in misses:
            records[h] = simulate(e)
            if cache is not None:
                cache.put(records[h])

    return [records[h] for h in order]
