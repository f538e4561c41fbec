"""The program's own wall-clock spans, and what the harness reads from them.

The port's tracer (``repro_torch.obs.trace``) records wall-clock spans
inside the serving path when it is built with ``wall=True``: the
cluster's run and events, each engine step, each executor and transfer
call, and the phases of a decode step and of a prefill. They are stamped
on ``time.perf_counter``, the clock of the harness's own spans and of
the device trace once mapped (``devtrace.py``), so the three share one
timeline.

A run that reads them hands the program the tracer of
``program_tracer()`` for its window and gives the ``Context`` the spans
split as its own are: ``program_spans``, those begun in the untraced
part, and ``program_traced_spans``, those of the traced part. Where a
context has neither (the program has no wall spans, or the run did not
ask for them) every reader here returns None.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .devtrace import DevEvents, busy_intervals

LOOP = ("cluster.run", "cluster.event", "engine.step")
ENQUEUE = ("decode.forward", "prefill.forward")
DECODE_PHASES = ("decode.prepare", "decode.forward", "decode.sync",
                 "decode.commit")
OUTSIDE = "(none)"          # the host inside no span of the program


def program_tracer():
    """A tracer that records the wall family alone, or None where the
    program's tracer has no such family."""
    from repro_torch.obs import trace
    if not hasattr(trace, "WallSpan"):
        return None
    return trace.Tracer(enabled=False, wall=True)


def split(spans, t0: float, t_open: float, t_close: float
          ) -> Tuple[list, list]:
    """The spans begun in [t0, t_open), and those begun in
    [t_open, t_close)."""
    return ([s for s in spans if t0 <= s.t0 < t_open],
            [s for s in spans if t_open <= s.t0 < t_close])


def untraced(ctx, name: str) -> Optional[list]:
    spans = getattr(ctx, "program_spans", None)
    return None if spans is None else [s for s in spans if s.name == name]


def traced(ctx, name: str) -> Optional[list]:
    spans = getattr(ctx, "program_traced_spans", None)
    return None if spans is None else [s for s in spans if s.name == name]


def every(ctx) -> Optional[list]:
    a = getattr(ctx, "program_spans", None)
    b = getattr(ctx, "program_traced_spans", None)
    return None if a is None or b is None else list(a) + list(b)


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean wall of the untraced part's spans of ``name``, in ms."""
    spans = untraced(ctx, name)
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)


# ----------------------------------------------------------------------
# interval arithmetic on one timeline
# ----------------------------------------------------------------------
def idle_measure(ev: DevEvents, lo: float, hi: float
                 ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """f(x, y): the seconds of each [x, y] within [lo, hi] in which no
    device operation runs, by exact intersection with the union of the
    operations' intervals."""
    a, b = busy_intervals(ev, lo, hi)
    before = np.r_[0.0, np.cumsum(b - a)]      # busy time of whole pieces

    def busy_until(t):
        i = np.searchsorted(a, t, side="right")    # pieces begun by t
        j = np.maximum(i - 1, 0)
        part = np.clip(t - a[j], 0.0, (b - a)[j]) if a.size else 0.0
        return np.where(i > 0, before[j] + part, 0.0)

    def idle(x, y):
        x, y = np.clip(x, lo, hi), np.clip(y, lo, hi)
        return (y - x) - (busy_until(y) - busy_until(x))
    return idle


def innermost(spans, measure, lo: float, hi: float) -> Dict[str, float]:
    """``measure`` of [lo, hi] shared out by the innermost span open at
    each instant, by span name (``OUTSIDE`` where none is): each span
    keeps its own interval's measure less its children's. Spans nest,
    so this is exact; a span whose parent is not among ``spans`` counts
    as outermost."""
    spans = list(spans)
    out = {OUTSIDE: float(measure(np.asarray([lo]), np.asarray([hi]))[0])}
    if not spans:
        return out
    x = np.clip(np.asarray([s.t0 for s in spans], dtype=np.float64), lo, hi)
    y = np.clip(np.asarray([s.t1 for s in spans], dtype=np.float64), lo, hi)
    m = measure(x, y)
    own = {s.id: float(v) for s, v in zip(spans, m)}
    for s, v in zip(spans, m):
        if s.parent in own:
            own[s.parent] -= float(v)
        else:
            out[OUTSIDE] -= float(v)
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + own[s.id]
    return out


def length(x, y):
    return y - x


def starts_in(spans, ev: DevEvents) -> np.ndarray:
    """For each span, the number of device operations that start in
    [t0, t1)."""
    t = np.sort(ev.t0)
    return np.asarray([np.searchsorted(t, s.t1, side="left")
                       - np.searchsorted(t, s.t0, side="left")
                       for s in spans], dtype=np.int64)


def overhang(spans, ev: DevEvents) -> Tuple[np.ndarray, np.ndarray]:
    """How far past each span's end the operations begun inside it end:
    for each span, the latest of them (NaN where none began there), and
    for every such operation its own."""
    order = np.argsort(ev.t0, kind="stable")
    t0, t1 = ev.t0[order], ev.t1[order]
    last, each = [], []
    for s in spans:
        i, j = np.searchsorted(t0, [s.t0, s.t1], side="left")
        d = t1[i:j] - s.t1
        each.append(d)
        last.append(d.max() if d.size else np.nan)
    return np.asarray(last), (np.concatenate(each) if each
                              else np.zeros(0))


def report(ctx, drift_s: Optional[float] = None) -> Optional[dict]:
    """What a ``--trace 1`` run logs of the program's spans: the traced
    window's idle seconds by the innermost span, the loop's measured own
    time in the untraced part, how fully the phases tile each decode
    step, and how the device trace lines up with the steps' ends."""
    spans = every(ctx)
    if spans is None:
        return None
    window = ctx.t1 - ctx.t0
    own = innermost(spans, length, ctx.t0, ctx.t1)
    out = {"loop_self_s": {n: own.get(n, 0.0) for n in LOOP},
           "loop_self_share": 100.0 * sum(own.get(n, 0.0) for n in LOOP)
           / window, "outside_share": 100.0 * own[OUTSIDE] / window}
    steps = untraced(ctx, "exec.decode")
    if steps:
        kids: Dict[int, float] = {}
        for s in ctx.program_spans:
            if s.name in DECODE_PHASES:
                kids[s.parent] = kids.get(s.parent, 0.0) + (s.t1 - s.t0)
        cover = np.asarray([kids.get(s.id, 0.0) / (s.t1 - s.t0)
                            for s in steps])
        out["decode_steps"] = len(steps)
        out["exec_decode_ms"] = 1e3 * float(np.mean([s.t1 - s.t0
                                                     for s in steps]))
        out["phase_ms"] = {n: mean_ms(ctx, n) for n in DECODE_PHASES}
        out["phase_cover_min"] = float(cover.min())
        out["phase_cover_98_share"] = float((cover >= 0.98).mean())
    if ctx.events is not None and ctx.trace is not None:
        lo, hi = ctx.trace
        out["idle_by_span"] = innermost(spans, idle_measure(ctx.events, lo,
                                                            hi), lo, hi)
        tsteps = traced(ctx, "exec.decode")
        if tsteps:
            last, each = overhang(tsteps, ctx.events)
            out["overhang_us"] = {
                "step_p50": 1e6 * float(np.nanmedian(last)),
                "step_max": 1e6 * float(np.nanmax(last)),
                "ops": int(each.size),
                "ops_within_50us": float((each <= 50e-6 + abs(
                    drift_s or 0.0)).mean()) if each.size else None}
    if drift_s is not None:
        out["clock_drift_us"] = 1e6 * drift_s
    return out
