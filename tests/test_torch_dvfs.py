"""The port's ``core/dvfs.py`` (the paper's Experiment 2: the frequency
sweep, its latency-energy Pareto frontiers, and the stage-wise
independent (phi_p, phi_d) search) against the reference's, for
llama32-3b in the five setups over a three-point phi grid: equal
points, frontiers, records and best choices, through each package's
``exp`` (a registered config and a declarative workload) and through
the direct branch (a request factory)."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

from torch_sim import PORT, REF, port_cache  # noqa: E402,F401


SETUPS = ("co-1gpu", "co-2gpus", "dis-ici", "dis-host", "dis-disk")
GRID = (0.42, 0.74, 1.0)


def _closed(P):
    return P.exp.ClosedLoop(batch=4, input_len=4096, output_len=32)


def _factory(P):
    return lambda: P.core.random_workload(4, input_len=4096, output_len=32)


def _points(pts):
    return [dataclasses.astuple(p) for p in pts]


def _sweep(P, setup, workload):
    cfg = P.configs.get_config("llama32-3b")
    sw = P.core.sweep_frequencies(setup, cfg, workload(P), freq_grid=GRID)
    out = {"setup": sw.setup,
           "prefill": _points(sw.prefill_points),
           "decode": _points(sw.decode_points),
           "prefill_frontier": _points(sw.prefill_frontier()),
           "decode_frontier": _points(sw.decode_frontier()),
           "best": P.core.best_total_energy(sw),
           "best_slo": P.core.best_total_energy(sw, ttft_slo_s=1.0,
                                                tpot_slo_s=0.004),
           "energy": [sw.results[phi].energy.total_j for phi in GRID]}
    if setup.startswith("dis"):
        recs = P.core.dvfs.sweep_independent(setup, cfg, workload(P),
                                             freq_grid=GRID)
        out["independent"] = recs
        out["best_independent"] = P.core.dvfs.best_independent(recs)
        out["best_independent_slo"] = P.core.dvfs.best_independent(
            recs, ttft_slo_s=1.0, tpot_slo_s=0.004)
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("setup", SETUPS)
def test_sweep_matches_reference(setup):
    before = PORT.exp.sim_count()
    got = _sweep(PORT, setup, _closed)
    # every point simulated once: the independent search's diagonal
    # pairs are the same-phi sweep's cells, read back from the cache
    n = len(GRID) ** 2 if setup.startswith("dis") else len(GRID)
    assert PORT.exp.sim_count() == before + n
    assert got == _sweep(REF, setup, _closed)
    assert got["best"] is not None


@pytest.mark.parametrize("setup", ("co-2gpus", "dis-ici"))
def test_direct_sweep_matches_reference(setup):
    """A request factory cannot be content-addressed: both packages
    simulate it directly, outside ``exp``."""
    before = PORT.exp.uncached_sim_count()
    got = _sweep(PORT, setup, _factory)
    assert PORT.exp.uncached_sim_count() > before
    assert got == _sweep(REF, setup, _factory)
    assert got == _sweep(PORT, setup, _closed)


def test_core_reexports_dvfs():
    for name in ("FrequencySweep", "best_total_energy", "sweep_frequencies"):
        assert getattr(PORT.core, name) is getattr(PORT.core.dvfs, name)
        assert name in PORT.core.__all__
