"""The port's wall-clock spans (``repro_torch.obs.trace``, the ``wall``
family beside the simulation-clock events).

Contracts: spans nest with the right parents and all close; self time
is duration less the children; ``NULL_TRACER`` records nothing; wall
spans leave every simulation-clock view as it was; a real-mode run
serves the same tokens and metrics with wall tracing on and off; the
phases inside ``RealExecutor.decode_batch`` and ``.prefill`` tile their
call; every handoff span names its request.
"""
from collections import Counter

import pytest
import torch

import repro_torch.core as T
from repro_torch import configs as tcfg
from repro_torch.launch.serve import device_kv
from repro_torch.models import get_model
from repro_torch.obs import NULL_TRACER, Tracer, self_times

# every span a real-mode dis-host run records, with the parent it has
PARENTS = {
    "cluster.run": {None},
    "cluster.event": {"cluster.run"},
    "engine.step": {"cluster.run"},
    "exec.prefill": {"engine.step"},
    "exec.store": {"engine.step"},
    "exec.fetch": {"engine.step"},
    "exec.release": {"engine.step", "cluster.event"},
    "exec.decode": {"engine.step"},
    "path.store": {"engine.step"},
    "path.fetch": {"cluster.event"},
    "decode.prepare": {"exec.decode"},
    "decode.forward": {"exec.decode"},
    "decode.sync": {"exec.decode"},
    "decode.commit": {"exec.decode"},
    "prefill.forward": {"exec.prefill"},
    "prefill.kv_write": {"exec.prefill"},
    "prefill.sync": {"exec.prefill"},
}
PHASES = {"exec.decode": ["decode.prepare", "decode.forward", "decode.sync",
                          "decode.commit"],
          "exec.prefill": ["prefill.forward", "prefill.kv_write",
                           "prefill.sync"]}
ARCHS = ("llama32-3b", "rwkv6-3b")
N_REQ, IN_LEN, OUT_LEN = 3, 20, 5


def _model(arch):
    cfg = tcfg.reduce_for_smoke(tcfg.REGISTRY[arch])
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


_MODELS = {}


def real_run(arch, tracer, setup="dis-host"):
    if arch not in _MODELS:
        _MODELS[arch] = _model(arch)
    cfg, model, params = _MODELS[arch]
    reqs = T.random_workload(N_REQ, input_len=IN_LEN, output_len=OUT_LEN,
                             vocab_size=cfg.vocab_size, seed=11)
    kv = device_kv(cfg, reqs, "cpu") if model.paged else None
    return T.make_cluster(
        setup, cfg, executor_factory=lambda path: T.RealExecutor(
            model, params, kv, transfer_path=path), tracer=tracer).run(reqs)


_TRACED = {}


def traced(arch):
    """One wall-traced dis-host run of ``arch`` (shared by the tests)."""
    if arch not in _TRACED:
        tr = Tracer(enabled=False, wall=True)
        _TRACED[arch] = (tr, real_run(arch, tr))
    return _TRACED[arch]


def test_spans_nest_and_self_time_is_the_rest():
    tr = Tracer(enabled=False, wall=True)
    tr.begin("a", x=1)
    tr.begin("b")
    tr.switch("c", y=2)
    tr.begin("d")
    tr.end(z=3)
    tr.end()
    tr.end()
    tr.begin("e")
    tr.end()
    a, b, c, d, e = tr.walls
    assert [s.name for s in tr.walls] == list("abcde")
    assert [s.id for s in tr.walls] == list(range(5))
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == \
        (None, 0, 0, 2, None)
    assert a.args == {"x": 1} and c.args == {"y": 2} and d.args == {"z": 3}
    assert c.t0 == b.t1                  # a switch leaves no gap
    assert a.t0 <= b.t0 <= b.t1 <= c.t0 <= d.t0 <= d.t1 <= c.t1 <= a.t1
    st = self_times(tr.walls)
    assert st[a.id] == pytest.approx(a.dur - b.dur - c.dur, abs=1e-12)
    assert st[c.id] == pytest.approx(c.dur - d.dur, abs=1e-12)
    assert st[d.id] == d.dur and st[e.id] == e.dur
    assert tr.events == [] and not tr.enabled


def test_null_tracer_records_nothing():
    assert not NULL_TRACER.wall and not NULL_TRACER.enabled
    NULL_TRACER.begin("x", a=1)
    NULL_TRACER.switch("y")
    NULL_TRACER.end()
    res = real_run("llama32-3b", None)
    assert res.requests[0].output_tokens
    assert NULL_TRACER.walls == [] and NULL_TRACER.events == []


@pytest.mark.parametrize("stepper", ["fast", "exact"])
def test_wall_spans_leave_the_sim_views_unchanged(stepper):
    cfg = tcfg.REGISTRY["llama32-3b"]
    views = []
    for wall in (False, True):
        tr = Tracer(wall=wall)
        reqs = T.random_workload(6, input_len=256, output_len=32,
                                 vocab_size=cfg.vocab_size, seed=5)
        res = T.make_cluster("dis-host", cfg, tracer=tr).run(
            reqs, stepper=stepper)
        assert bool(tr.walls) == wall
        views.append((
            [e.to_dict() for e in tr.events],
            [e.to_dict() for e in tr.spans()],
            [e.to_dict() for e in tr.instants()],
            tr.engine_tracks(),
            {t: tr.coalesced(t) for t in tr.engine_tracks()},
            {r: {k: [e.to_dict() for e in v] for k, v in d.items()}
             for r, d in tr.lifecycle_events().items()},
            res.metrics, res.energy.total_j))
    assert views[0] == views[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_real_run_is_the_same_with_wall_spans(arch):
    tr, on = traced(arch)
    off = real_run(arch, None)
    assert [r.output_tokens for r in on.requests] == \
        [r.output_tokens for r in off.requests]
    assert all(len(r.output_tokens) == OUT_LEN for r in on.requests)
    assert on.metrics == off.metrics
    assert on.makespan_s == off.makespan_s
    assert on.energy.total_j == off.energy.total_j


@pytest.mark.parametrize("arch", ARCHS)
def test_every_span_closes_under_its_parent(arch):
    tr, _ = traced(arch)
    by_id = {s.id: s for s in tr.walls}
    names = Counter(s.name for s in tr.walls)
    assert set(names) == set(PARENTS)
    assert names["cluster.run"] == 1
    assert names["exec.prefill"] == names["exec.store"] == \
        names["path.store"] == names["path.fetch"] == \
        names["exec.fetch"] == N_REQ
    assert names["exec.release"] == 2 * N_REQ   # prefill side, then decode
    for s in tr.walls:
        assert s.t1 is not None and s.t1 >= s.t0, s
        parent = by_id[s.parent] if s.parent is not None else None
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent is not None:
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1, (s, parent)
    steps = [s for s in tr.walls if s.name == "engine.step"]
    assert {s.args["engine"] for s in steps} == {"acc0", "acc1"}
    assert {s.args["did"] for s in steps} <= {"prefill", "decode", "fetch",
                                              "none"}
    # every decode step is one engine step that says so
    assert sum(s.args["did"] == "decode" for s in steps) == \
        names["exec.decode"]
    # the run's own time: the loop's spans less what they called
    st = self_times(tr.walls)
    loop = sum(st[s.id] for s in tr.walls
               if s.name in ("cluster.run", "cluster.event", "engine.step"))
    run = next(s for s in tr.walls if s.name == "cluster.run")
    assert 0 < loop < run.dur


@pytest.mark.parametrize("arch", ARCHS)
def test_phases_tile_each_call(arch):
    tr, res = traced(arch)
    kids = {}
    for s in tr.walls:
        kids.setdefault(s.parent, []).append(s)
    calls = {n: [s for s in tr.walls if s.name == n] for n in PHASES}
    assert calls["exec.prefill"] and calls["exec.decode"]
    for name, phases in PHASES.items():
        for call in calls[name]:
            ch = kids[call.id]
            assert [c.name for c in ch] == phases
            assert call.t0 <= ch[0].t0 and ch[-1].t1 <= call.t1
            for a, b in zip(ch, ch[1:]):
                assert b.t0 == a.t1            # no gap, no overlap
    rows = [s.args["rows"] for s in calls["exec.decode"]]
    # each request's first token comes with its fetch, the rest from decode
    assert sum(rows) == sum(r.generated - 1 for r in res.requests)
    assert all(s.args["tokens"] == IN_LEN for s in calls["exec.prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_spans_name_their_request(arch):
    tr, res = traced(arch)
    ids = sorted(r.req_id for r in res.requests)
    for name in ("exec.prefill", "exec.store", "path.store", "path.fetch",
                 "exec.fetch"):
        got = [s.args["req"] for s in tr.walls if s.name == name]
        assert sorted(got) == ids, name
    stored = {s.args["req"]: s.args["nbytes"] for s in tr.walls
              if s.name == "path.store"}
    fetched = {s.args["req"]: s.args["nbytes"] for s in tr.walls
               if s.name == "path.fetch"}
    assert stored == fetched and min(stored.values()) > 0
    # a request's fetch follows its store
    t = {(s.name, s.args["req"]): s for s in tr.walls
         if s.name in ("path.store", "path.fetch")}
    assert all(t["path.store", r].t1 <= t["path.fetch", r].t0 for r in ids)
