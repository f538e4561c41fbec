"""The port's ``workload/`` against the reference's: every arrival
process and length mix draws the same numbers from the same seed,
``WorkloadSpec.build`` and ``open_loop_workload`` give the same
requests, and the goodput scoring and rate sweeps (which run through
each package's own ``exp``) give equal results. The simulator is
deterministic, so equal means equal, not close."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_sim import PORT, REF, port_cache  # noqa: E402,F401


SEEDS = (0, 1, 7, 12345)


ARRIVALS = {
    "poisson": dict(rate=4.0),
    "gamma": dict(rate=3.0, cv=2.5),
    "ramp": dict(rate0=1.0, rate1=8.0, ramp_s=3.0),
    "diurnal": dict(rate=20.0, period_s=4.0, floor=0.1),
    "deterministic": dict(rate=5.0),
}
LENGTHS = {
    "paper-fixed": lambda P: P.workload.PaperFixedLengths(),
    "sharegpt": lambda P: P.workload.ShareGPTLengths(),
    "chatbot": lambda P: P.workload.ChatbotLengths(),
    "rag-shared-prefix": lambda P: P.workload.RAGSharedPrefixLengths(
        prefix_len=1024),
    "mixture": lambda P: P.workload.MixtureLengths(components=(
        (0.6, P.workload.PaperFixedLengths(1024, 16)),
        (0.3, P.workload.ShareGPTLengths()),
        (0.1, P.workload.RAGSharedPrefixLengths(prefix_len=512)))),
}


def _shapes(shapes):
    return [dataclasses.astuple(s) for s in shapes]


def _requests(reqs):
    """Every field of each request, token ids as a list."""
    out = []
    for r in reqs:
        d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        toks = d.pop("prompt_tokens")
        d["prompt_tokens"] = None if toks is None else np.asarray(
            toks).tolist()
        d["slo"] = dataclasses.astuple(d["slo"])
        out.append(repr(d))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(ARRIVALS) + sorted(LENGTHS))
def test_samples_match_reference(kind, seed):
    n = 40
    if kind in ARRIVALS:
        want = REF.workload.make_arrivals(kind, **ARRIVALS[kind]).times(
            n, seed=seed)
        got = PORT.workload.make_arrivals(kind, **ARRIVALS[kind]).times(
            n, seed=seed)
        assert got.dtype == want.dtype
        assert got.tolist() == want.tolist()
    else:
        want = LENGTHS[kind](REF).sample(n, seed=seed)
        got = LENGTHS[kind](PORT).sample(n, seed=seed)
        assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("vocab", (0, 512))
def test_workload_spec_build_matches_reference(vocab):
    def build(P):
        W = P.workload
        return W.WorkloadSpec(
            arrivals=W.make_arrivals("gamma", rate=5.0, cv=2.0),
            lengths=LENGTHS["mixture"](P), n=24, seed=3,
            slo=P.core.SLO(ttft_s=2.0, tpot_s=0.01),
            vocab_size=vocab).build()
    assert _requests(build(PORT)) == _requests(build(REF))


@pytest.mark.parametrize("arrival", ("poisson", "ramp", "diurnal"))
def test_open_loop_workload_matches_reference(arrival):
    def build(P):
        kw = {"period_s": 3.0} if arrival == "diurnal" else {}
        return P.workload.open_loop_workload(
            6.0, 20, arrival=arrival, seed=5, vocab_size=300,
            lengths=P.workload.RAGSharedPrefixLengths(prefix_len=256),
            slo=P.workload.DEFAULT_INTERACTIVE_SLO, **kw)
    assert _requests(build(PORT)) == _requests(build(REF))


def _small(P):
    return dict(lengths=P.workload.PaperFixedLengths(2048, 32), n=10,
                slo=P.workload.DEFAULT_INTERACTIVE_SLO)


@pytest.mark.parametrize("setup", ("co-2gpus", "dis-ici", "dis-disk"))
def test_rate_point_and_evaluate_match_reference(setup):
    pts = {}
    for name, P in (("ref", REF), ("port", PORT)):
        cfg = P.configs.get_config("llama32-3b")
        before = PORT.exp.sim_count()
        pts[name] = [P.workload.run_rate_point(setup, cfg, r, **_small(P))
                     for r in (1.0, 4.0, 12.0)]
        if P is PORT:      # it simulated: nothing came from a shared cache
            assert PORT.exp.sim_count() == before + 3
        reqs = P.workload.open_loop_workload(4.0, seed=0, **_small(P))
        P.core.make_cluster(setup, cfg).run(reqs)
        pts[name + "-eval"] = P.workload.evaluate(
            reqs, P.workload.DEFAULT_INTERACTIVE_SLO)
    assert [p.as_row() for p in pts["port"]] == \
        [p.as_row() for p in pts["ref"]]
    assert [dataclasses.asdict(p) for p in pts["port"]] == \
        [dataclasses.asdict(p) for p in pts["ref"]]
    assert dataclasses.asdict(pts["port-eval"]) == \
        dataclasses.asdict(pts["ref-eval"])


def test_uncached_rate_point_matches_reference():
    """An off-registry config takes the direct (uncached) branch."""
    pts = {}
    for name, P in (("ref", REF), ("port", PORT)):
        cfg = P.configs.get_config("llama32-3b").replace(num_layers=14)
        before = P.exp.uncached_sim_count()
        pts[name] = P.workload.run_rate_point("dis-host", cfg, 3.0,
                                              **_small(P))
        assert P.exp.uncached_sim_count() == before + 1
    assert dataclasses.asdict(pts["port"]) == dataclasses.asdict(pts["ref"])


def test_goodput_gap_and_crossover_match_reference():
    """At the paper's 16k/256 shape, where dis-ici crosses co-2gpus."""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        cfg = P.configs.get_config("llama32-3b")
        kw = dict(n=16, slo=P.workload.DEFAULT_INTERACTIVE_SLO)
        gaps = [P.workload.goodput_gap("dis-ici", "co-2gpus", cfg, r, **kw)
                for r in (1.0, 3.0, 9.0)]
        c = P.workload.crossover_rate("dis-ici", cfg, lo=1.0, hi=16.0,
                                      iters=3, **kw)
        cap = P.workload.max_goodput_rate("co-2gpus", cfg, lo=0.5,
                                          hi=16.0, max_iters=3, **kw)
        got[name] = (gaps, dataclasses.asdict(c), cap)
    assert got["port"] == got["ref"]
    assert 0.5 < got["port"][2] < 16.0       # the search did not saturate
