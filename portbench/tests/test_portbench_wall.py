"""The readers of the program's wall-clock spans (``harness/wall.py`` and
the five metrics that split a decode step) on hand-made spans and device
events with known answers, and on the spans of a tiny run through the
harness's own serving path with the program's tracer handed over."""
import time

import numpy as np
import pytest
import torch

from conftest import TINY_CELLS
from portbench.harness import layers, wall
from portbench.harness.devtrace import DevEvents
from repro_torch.obs.trace import WallSpan

SEED = 3_000_000_017
NEW = ("decode_prep_ms", "decode_enqueue_ms", "decode_rows",
       "decode_ops_per_step", "idle_in_enqueue")


def _spans(rows):
    """WallSpans from (name, t0, t1, parent index or None, args)."""
    return [WallSpan(n, a, b, i, p, dict(kw))
            for i, (n, a, b, p, kw) in enumerate(rows)]


def _ctx(untraced, traced, events=None, t0=0.0, t1=10.0, trace=None):
    ctx = layers.Context(spans=[], traced_spans=[], t0=t0, t1=t1, cfg={},
                         ref=None, events=events, trace=trace)
    ctx.program_spans, ctx.program_traced_spans = untraced, traced
    return ctx


def _known():
    """Two decode steps in the untraced part [0, 10), two and a prefill
    in the traced part [10, 20), and the device's operations there."""
    spans = _spans([
        ("cluster.run", 0.0, 9.0, None, {"requests": 2}),
        ("engine.step", 1.0, 5.0, 0, {}),
        ("exec.decode", 1.5, 4.5, 1, {"rows": 4}),
        ("decode.prepare", 1.5, 2.0, 2, {}),
        ("decode.forward", 2.0, 3.5, 2, {}),
        ("decode.sync", 3.5, 4.2, 2, {}),
        ("decode.commit", 4.2, 4.5, 2, {}),
        ("engine.step", 5.0, 8.0, 0, {}),
        ("exec.decode", 5.0, 8.0, 7, {"rows": 2}),
        ("decode.prepare", 5.0, 5.5, 8, {}),
        ("decode.forward", 5.5, 7.0, 8, {}),
        ("decode.sync", 7.0, 7.8, 8, {}),
        ("decode.commit", 7.8, 8.0, 8, {}),
        ("exec.decode", 11.0, 15.0, None, {"rows": 3}),
        ("decode.forward", 12.0, 14.0, 13, {}),
        ("exec.decode", 16.0, 19.0, None, {"rows": 3}),
        ("decode.forward", 16.5, 18.0, 15, {}),
        ("prefill.forward", 19.0, 19.5, None, {"tokens": 9}),
    ])
    ev = DevEvents(["a", "b", "c", "d", "e", "f"],
                   np.array([11.2, 12.5, 14.9, 15.5, 16.0, 19.2]),
                   np.array([11.5, 13.0, 15.00002, 15.6, 16.2, 20.5]))
    untraced, traced = wall.split(spans, 0.0, 10.0, 20.0)
    return _ctx(untraced, traced, ev, trace=(10.0, 20.0))


def test_readers_on_known_spans():
    ctx = _known()
    read = {n: layers.load(n).read(ctx) for n in NEW}
    assert read["decode_prep_ms"] == pytest.approx(500.0)
    assert read["decode_enqueue_ms"] == pytest.approx(1500.0)
    assert read["decode_rows"] == 3.0
    # a, b, c start in the first traced step; e at the second's start;
    # d between the steps and f in the prefill count for neither
    assert read["decode_ops_per_step"] == 2.0
    # idle inside the forwards: [12, 14] less b's 0.5 (the gap 13-14.9
    # straddles the span's end: its part inside counts), [16.5, 18]
    # whole, [19, 19.5] less f's 0.3; over the 10 s window
    assert read["idle_in_enqueue"] == pytest.approx(100 * 3.2 / 10)


def test_idle_and_own_time_by_innermost_span():
    ctx = _known()
    lo, hi = ctx.trace
    idle = wall.innermost(wall.every(ctx),
                          wall.idle_measure(ctx.events, lo, hi), lo, hi)
    # exec.decode keeps [11, 12] and [14, 15] of the first step and
    # [16, 16.5] and [18, 19] of the second, less what ran there
    assert idle["exec.decode"] == pytest.approx(0.7 + 0.9 + 0.3 + 1.0)
    assert idle["decode.forward"] == pytest.approx(1.5 + 1.5)
    assert idle["prefill.forward"] == pytest.approx(0.2)
    assert idle[wall.OUTSIDE] == pytest.approx(1.0 + 1.0 - 0.00002 - 0.1)
    assert sum(idle.values()) == pytest.approx(10.0 - 2.00002)
    own = wall.innermost(ctx.program_spans, wall.length, 0.0, 10.0)
    assert own["cluster.run"] == pytest.approx(2.0)
    assert own["engine.step"] == pytest.approx(1.0)
    assert own[wall.OUTSIDE] == pytest.approx(1.0)
    assert sum(own.values()) == pytest.approx(10.0)
    rep = wall.report(ctx, drift_s=1e-6)
    assert rep["loop_self_share"] == pytest.approx(30.0)
    assert rep["outside_share"] == pytest.approx(10.0)
    assert rep["decode_steps"] == 2 and rep["phase_cover_min"] == 1.0
    assert rep["exec_decode_ms"] == pytest.approx(3000.0)
    assert rep["idle_by_span"] == pytest.approx(idle)
    # the first traced step's last operation ends 20 us after it; the
    # second's only one ends long before
    assert rep["overhang_us"]["step_max"] == pytest.approx(20.0, abs=1e-3)
    assert rep["overhang_us"]["ops"] == 4
    assert rep["overhang_us"]["ops_within_50us"] == 1.0
    assert rep["clock_drift_us"] == pytest.approx(1.0)


def test_overhang_counts_operations_past_the_end():
    steps = _spans([("exec.decode", 0.0, 1.0, None, {"rows": 1}),
                    ("exec.decode", 2.0, 3.0, None, {"rows": 1})])
    ev = DevEvents(["x"] * 4, np.array([0.1, 0.9, 2.5, 3.5]),
                   np.array([0.5, 1.0001, 2.9, 3.6]))
    last, each = wall.overhang(steps, ev)
    assert last == pytest.approx([1e-4, -0.1])
    assert sorted(each) == pytest.approx([-0.5, -0.1, 1e-4])
    assert wall.starts_in(steps, ev).tolist() == [2, 1]


def test_no_program_spans_reads_nothing(monkeypatch):
    """A program without wall spans, or a run that did not ask for them:
    every new reader returns None and the report is empty."""
    ctx = layers.Context(spans=[], traced_spans=[], t0=0.0, t1=1.0, cfg={},
                         ref=None)
    assert all(layers.load(n).read(ctx) is None for n in NEW)
    assert wall.report(ctx) is None
    ev = DevEvents(["k"], np.array([0.1]), np.array([0.2]))
    ctx = _ctx([], [], ev, t1=1.0, trace=(1.0, 2.0))
    assert all(layers.load(n).read(ctx) is None for n in NEW)
    from repro_torch.obs import trace
    assert wall.program_tracer().wall
    monkeypatch.delattr(trace, "WallSpan")
    assert wall.program_tracer() is None


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_run_spans_line_up_with_the_harness(monkeypatch, tiny_root,
                                                 cell):
    """Two waves through ``serving.run_wave`` with the program's tracer
    handed to each cluster and, through the timed wrapper, to each
    executor: the host-clock readers read the first wave, one
    ``exec.decode`` lies inside each of the harness's ``decode_batch``
    spans with as many rows, and the device readers find no trace."""
    import repro_torch.core as core
    from portbench.harness import serving, spec, weights
    from portbench.harness import traffic as T
    from repro_torch.models import get_model
    dev = torch.device("cpu")
    c = spec.load_cell(tiny_root, cell)
    cfg = spec.model_config(c.config_name, c.config)
    model = get_model(cfg)
    params = weights.make(model, c.config["init"], cfg.num_layers, SEED, dev)
    server = serving.make_server(cfg, model, params, c.traffic,
                                 c.cell["setup"], dev)
    tr = wall.program_tracer()
    make = core.make_cluster
    monkeypatch.setattr(core, "make_cluster",
                        lambda *a, **kw: make(*a, tracer=tr, **kw))
    monkeypatch.setattr(serving.TimedExecutor, "tracer", property(
        lambda self: self.inner.tracer,
        lambda self, t: setattr(self.inner, "tracer", t)), raising=False)
    bench = serving.Bench(dev, probe_every=2, seed=SEED)
    marks = [time.perf_counter()]
    for w in range(2):
        serving.run_wave(server, bench,
                         T.wave(c.traffic, cfg.vocab_size, SEED, w), w)
        marks.append(time.perf_counter())
    ctx = _ctx(*wall.split(tr.walls, *marks), t0=marks[0], t1=marks[1])
    ctx.spans = [s for s in bench.spans if s.t0 < marks[1]]
    read = {n: layers.load(n).read(ctx) for n in NEW}
    assert read["decode_prep_ms"] > 0 and read["decode_enqueue_ms"] > 0
    assert read["decode_ops_per_step"] is None
    assert read["idle_in_enqueue"] is None
    calls = [s for s in bench.spans if s.kind == "decode_batch"]
    steps = [s for s in tr.walls if s.name == "exec.decode"]
    assert len(steps) == len(calls) > 0
    for call, step in zip(calls, steps):
        assert call.t0 <= step.t0 and step.t1 <= call.t1
        assert step.args["rows"] == len(call.ctxs)
    first = [len(s.ctxs) for s in ctx.of("decode_batch")]
    assert read["decode_rows"] == pytest.approx(np.mean(first))
    assert all(s.t1 is not None for s in tr.walls)
    rep = wall.report(ctx)
    assert 0 < rep["loop_self_share"] < 100
    assert rep["decode_steps"] == len(first)
    assert rep["phase_cover_min"] > 0.5
