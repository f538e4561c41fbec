"""The port's ``exp/`` against the reference's: the same specs serialize
and hash alike, and ``run`` gives a ``RunRecord`` whose JSON is
identical to the reference's for the five setups, intra-gpu, a fleet
shape, the three governors, an open-loop cell, the chunked-interleave
scheduler, flat and tiered KV reuse, and an adaptive fleet controller.
These runs hold the port's copies of ``fleet/``, ``govern/``, ``obs/``
(the record's snapshot), ``sched/`` and ``kvstore.py`` to the
reference's. Also: ``Grid`` order, the result cache, a process pool, and
the port's cache root kept apart from the reference's."""
import json
import os

import pytest

pytest.importorskip("torch")

from torch_sim import PORT, REF, port_cache  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO_KW = dict(ttft_s=2.0, tpot_s=0.0075)
TIERED = {"mode": "prefix", "page_size": 16,
          "tiers": {"hbm_pages": 64, "dram_pages": 128, "disk_pages": 256}}


def _closed(setup):
    return lambda P: P.exp.Experiment.closed(setup, 4, input_len=2048,
                                             output_len=16)


def _open(P, setup="dis-ici", rate=3.0, n=12, **kw):
    kw.setdefault("lengths", P.workload.PaperFixedLengths(2048, 32))
    return P.exp.Experiment.open(setup, rate, n=n,
                                 slo=P.core.SLO(**SLO_KW), **kw)


def _fleet_shape(P):
    return P.exp.Experiment(
        arch="llama32-3b",
        fleet=P.fleet.FleetSpec.disaggregated(
            2, 1, "disk", phi_prefill=(1.0, 0.58),
            governor=("static", "queue-depth", "slo-slack")),
        workload=P.exp.OpenLoop(
            arrivals=P.workload.GammaArrivals(rate=5.0, cv=2.0),
            lengths=P.workload.MixtureLengths(components=(
                (0.7, P.workload.PaperFixedLengths(1024, 16)),
                (0.3, P.workload.ShareGPTLengths()))),
            n=9, seed=2))


def _tiered(P):
    return P.exp.Experiment.open(
        P.fleet.FleetSpec(n_colocated=2, router="prefix-affinity",
                          reuse=TIERED),
        8.0, n=16, vocab_size=512,
        lengths=P.workload.RAGSharedPrefixLengths(prefix_len=1024),
        slo=P.core.SLO(**SLO_KW))


def _flat_reuse(P):
    return P.exp.Experiment(
        arch="llama32-3b", fleet="co-2gpus",
        workload=P.exp.ClosedLoop(batch=4, input_len=8192,
                                  vocab_size=1000, rag_doc_len=2048),
        reuse=P.exp.ReuseSpec(mode="pic", recompute_frac=0.2))


def _controller(P):
    return P.exp.Experiment.open(
        "2P2D-ici", 20.0, n=30, arrival="diurnal",
        arrival_kw={"period_s": 2.0, "floor": 0.1},
        lengths=P.workload.PaperFixedLengths(1024, 64),
        slo=P.core.SLO(**SLO_KW)).with_controller(
            {"policy": "adaptive", "interval_s": 0.1,
             "sleep_after_s": 0.3, "wake_latency_s": 0.5,
             "initial_awake_prefill": 1, "initial_awake_decode": 1})


RUNS = {
    **{s: _closed(s) for s in ("co-1gpu", "co-2gpus", "dis-ici", "dis-host",
                               "dis-disk", "intra-gpu", "2P2D-ici")},
    **{f"governor-{g}": (lambda g: lambda P: _open(P).with_governor(g))(g)
       for g in ("static", "queue-depth", "slo-slack")},
    "phi-split": lambda P: _closed("dis-host")(P).with_phi(
        phi_prefill=0.74, phi_decode=0.42),
    "open-poisson": lambda P: _open(P, "co-2gpus", rate=4.0, n=16,
                                    lengths=P.workload.ShareGPTLengths()),
    "chunked-interleave": lambda P: _open(
        P, P.fleet.FleetSpec(n_colocated=1), rate=8.0, n=12,
        lengths=P.workload.PaperFixedLengths(2048, 64),
        seed=3).with_scheduler("chunked-interleave"),
    "tiered-reuse": _tiered,
    "flat-reuse": _flat_reuse,
    "fleet-shape": _fleet_shape,
    "controller": _controller,
}
SPECS = {
    **RUNS,
    "open-ramp": lambda P: P.exp.Experiment.open("co-3", 6.0,
                                                 arrival="ramp", n=32),
    "intra-2": lambda P: P.exp.Experiment.closed("intra-2", 8).with_phi(
        phi=0.58),
}


def _dump(rec):
    return json.dumps(rec.to_dict(), sort_keys=True)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_json_and_hash_match_reference(name):
    ref, port = SPECS[name](REF), SPECS[name](PORT)
    assert port.to_json() == ref.to_json()
    assert port.spec_hash() == ref.spec_hash()
    back = PORT.exp.Experiment.from_json(ref.to_json())
    assert back == port and back.spec_hash() == ref.spec_hash()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_record_matches_reference(name):
    before = PORT.exp.sim_count()
    port = PORT.exp.run(RUNS[name](PORT), cache=None)
    assert PORT.exp.sim_count() == before + 1
    ref = REF.exp.run(RUNS[name](REF), cache=None)
    assert _dump(port) == _dump(ref)
    assert port.obs is not None and port.metrics.num_requests > 0


def test_engaged_paths_are_not_vacuous():
    """The cells above really exercise what they name."""
    recs = {n: PORT.exp.run(RUNS[n](PORT), cache=None)
            for n in ("tiered-reuse", "flat-reuse", "governor-slo-slack",
                      "controller")}
    assert recs["tiered-reuse"].metrics.total_reused_tokens > 0
    assert recs["flat-reuse"].metrics.total_reused_tokens > 0
    assert recs["governor-slo-slack"].governor_decisions > 0
    assert recs["controller"].controller_actions > 0


def _grid(P):
    base = P.exp.Experiment.closed("co-1gpu", 2, input_len=1024,
                                   output_len=8)
    return P.exp.Grid(base, {"setup": P.core.SETUPS,
                             "phi": (0.58, 1.0), "batch": (2, 3)})


def test_grid_expands_in_reference_order():
    got = [e.to_json() for e in _grid(PORT).expand()]
    want = [e.to_json() for e in _grid(REF).expand()]
    assert got == want and len(got) == 5 * 2 * 2
    rates = dict(rate=(1.0, 2.0), governor=("static", "slo-slack"))
    assert [e.to_json() for e in PORT.exp.Grid(_open(PORT), rates)
            .expand()] == [e.to_json() for e in REF.exp.Grid(
                _open(REF), rates).expand()]


def test_cache_round_trip_and_warm_grid(tmp_path):
    cache = PORT.exp.ResultCache(str(tmp_path / "cache"))
    exp = _closed("dis-ici")(PORT)
    rec = PORT.exp.run(exp, cache=None)
    path = cache.put(rec)
    assert path.startswith(str(tmp_path))
    assert _dump(cache.get(exp)) == _dump(rec)

    grid = _grid(PORT)
    cold = PORT.exp.run_grid(grid, cache=cache)
    s0 = PORT.exp.sim_count()
    warm = PORT.exp.run_grid(grid, cache=cache)
    assert PORT.exp.sim_count() == s0               # simulated nothing
    assert [_dump(r) for r in warm] == [_dump(r) for r in cold]
    assert [_dump(r) for r in cold] == [
        _dump(r) for r in REF.exp.run_grid(_grid(REF), cache=None)]


def test_run_grid_parallel_matches_serial():
    grid = PORT.exp.Grid(_closed("co-1gpu")(PORT),
                         {"setup": ("co-2gpus", "dis-host"),
                          "phi": (0.42, 1.0)})
    serial = PORT.exp.run_grid(grid, parallel=1, cache=None)
    pooled = PORT.exp.run_grid(grid, parallel=2, cache=None)
    assert [_dump(r) for r in pooled] == [_dump(r) for r in serial]


def test_cache_root_is_the_ports_own(monkeypatch, tmp_path):
    """The key is the spec hash alone, which both packages compute
    alike: the port must never read or write the reference's records."""
    monkeypatch.setenv("REPRO_EXP_CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_EXP_CACHE_DIR", str(tmp_path / "port"))
    assert PORT.exp.default_cache_root() == str(tmp_path / "port")
    assert REF.exp.default_cache_root() == str(tmp_path / "ref")

    monkeypatch.delenv("REPRO_TORCH_EXP_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    root = PORT.exp.default_cache_root()
    assert root == os.path.join(str(tmp_path / "home"), ".cache",
                                "repro-torch-exp")
    monkeypatch.delenv("REPRO_EXP_CACHE_DIR")
    assert PORT.exp.default_cache_root() == root
    assert "benchmarks" not in root

    # a record the reference cached under the same hash is never read
    exp = _closed("co-1gpu")
    ref_cache = REF.exp.ResultCache(str(tmp_path / "ref"))
    ref_cache.put(REF.exp.run(exp(REF), cache=None))
    PORT.exp.set_default_cache(None)
    bench = os.path.join(ROOT, "benchmarks", "out", "cache")
    listing = sorted(os.listdir(bench)) if os.path.isdir(bench) else None
    s0 = PORT.exp.sim_count()
    PORT.exp.run(exp(PORT))
    assert PORT.exp.sim_count() == s0 + 1
    assert len(PORT.exp.ResultCache(root)) == 1
    assert (sorted(os.listdir(bench)) if os.path.isdir(bench)
            else None) == listing
