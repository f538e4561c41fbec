"""Chrome trace-event (Perfetto-loadable) export + text Gantt summary.

``chrome_trace`` turns a finished :class:`~repro.obs.trace.Tracer` into
the JSON object format of the Trace Event spec — load the file in
https://ui.perfetto.dev (or chrome://tracing) and every engine is a
thread of phase slices, every request an async track of lifecycle
stages, and governor/controller activity a row of instants.

Mapping:

  engine span            -> "X" complete event on that engine's tid
  transfer span          -> "X" on the pair's ``xfer:src->dst`` tid
  request lifecycle      -> "b"/"e" async pairs, ``cat="request"``,
                            ``id=req_id`` (one derived contiguous
                            stage chain per request)
  governor / controller  -> "i" instant events on their own tids
  track names            -> "M" thread_name metadata

Timestamps are microseconds of *simulation* time (the spec's ``ts``
unit), so a trace is bit-reproducible and directly comparable across
setups. ``validate_chrome_trace`` is the structural checker CI runs on
the exported artifact; ``text_summary`` renders the terminal
Gantt/flame view behind ``benchmarks.report --trace``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from .trace import (CONTROLLER_TRACK, GOVERNOR_TRACK, LIFECYCLE_TRACK,
                    SPAN, Tracer)

__all__ = ["chrome_trace", "validate_chrome_trace",
           "request_lifecycles", "assert_complete_lifecycles",
           "text_summary"]

_PID = 1
_US = 1e6


def _tid_map(tracer: Tracer) -> Dict[str, int]:
    """Stable track -> tid assignment: engines first (sorted), then
    transfer pairs, then governor/controller."""
    tracks = tracer.engine_tracks()
    xfer = sorted({e.track for e in tracer.events
                   if e.track.startswith("xfer:")})
    tail = [t for t in (GOVERNOR_TRACK, CONTROLLER_TRACK)
            if any(e.track == t for e in tracer.events)]
    return {t: i + 1 for i, t in enumerate(tracks + xfer + tail)}


def chrome_trace(tracer: Tracer, *, label: str = "repro-sim"
                 ) -> Dict[str, Any]:
    """Export the tracer as a Trace Event JSON object (dict)."""
    tids = _tid_map(tracer)
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
         "args": {"name": label}}]
    for track, tid in tids.items():
        out.append({"ph": "M", "pid": _PID, "tid": tid,
                    "name": "thread_name", "args": {"name": track}})
    for e in tracer.events:
        if e.track == LIFECYCLE_TRACK:
            continue            # exported as derived async stages below
        base = {"pid": _PID, "tid": tids[e.track], "name": e.name,
                "ts": e.t0 * _US, "args": dict(e.args)}
        if e.kind == SPAN:
            base.update(ph="X", dur=e.dur * _US, cat="engine")
        else:
            base.update(ph="i", s="t", cat=e.track)
        out.append(base)
    for rid in tracer.request_ids():
        for stage, t0, t1 in tracer.derive_lifecycle(rid):
            common = {"pid": _PID, "tid": 0, "cat": "request",
                      "id": rid, "name": stage}
            out.append(dict(common, ph="b", ts=t0 * _US))
            out.append(dict(common, ph="e", ts=t1 * _US))
    out.sort(key=lambda ev: (ev["ts"] if "ts" in ev else -1.0,
                             ev["ph"] == "e"))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
def validate_chrome_trace(payload: Dict[str, Any]) -> int:
    """Structural validity check; returns the event count or raises
    ``ValueError``. Checks the invariants Perfetto's importer needs:
    known phases, numeric non-negative timestamps/durations, and
    balanced async begin/end pairs per (cat, id, name)."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("not a trace-event JSON object")
    events = payload["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("empty traceEvents")
    open_async: Dict[Tuple, List[float]] = defaultdict(list)
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "b", "e", "M"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if "name" not in ev or "pid" not in ev:
            raise ValueError(f"event {i}: missing name/pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph in ("b", "e"):
            key = (ev.get("cat"), ev.get("id"), ev["name"])
            if key[1] is None:
                raise ValueError(f"event {i}: async event without id")
            if ph == "b":
                open_async[key].append(ts)
            else:
                if not open_async[key]:
                    raise ValueError(f"event {i}: 'e' without 'b': {key}")
                t0 = open_async[key].pop()
                if ts < t0:
                    raise ValueError(f"event {i}: span ends before it "
                                     f"begins: {key}")
    dangling = {k: v for k, v in open_async.items() if v}
    if dangling:
        raise ValueError(f"unclosed async spans: {sorted(dangling)[:5]}")
    return len(events)


def request_lifecycles(payload: Dict[str, Any]
                       ) -> Dict[int, List[Tuple[str, float, float]]]:
    """Reconstruct {req_id: [(stage, t0_s, t1_s), ...]} from the async
    events of an exported trace (times back in seconds)."""
    begins: Dict[Tuple, List[float]] = defaultdict(list)
    spans: Dict[int, List[Tuple[float, str, float]]] = defaultdict(list)
    for ev in payload["traceEvents"]:
        if ev.get("cat") != "request":
            continue
        key = (ev["id"], ev["name"])
        if ev["ph"] == "b":
            begins[key].append(ev["ts"])
        elif ev["ph"] == "e":
            t0 = begins[key].pop(0)
            spans[ev["id"]].append((t0 / _US, ev["ts"] / _US, ev["name"]))
    # sort by (t0, t1) so a zero-length stage (e.g. queue on an idle
    # engine) precedes the stage starting at the same instant
    return {rid: [(n, t0, t1) for t0, t1, n in sorted(rows)]
            for rid, rows in spans.items()}


def assert_complete_lifecycles(payload: Dict[str, Any],
                               n_requests: Optional[int] = None,
                               tol: float = 0.0) -> int:
    """Every request in the trace must carry a contiguous lifecycle
    chain (each stage starting exactly where the previous ended)
    beginning with ``queue`` and ending with ``decode``. Returns the
    request count; raises ``ValueError`` otherwise. ``n_requests``
    additionally pins how many requests must be present."""
    lcs = request_lifecycles(payload)
    if n_requests is not None and len(lcs) != n_requests:
        raise ValueError(f"expected {n_requests} request lifecycles, "
                         f"got {len(lcs)}")
    if not lcs:
        raise ValueError("no request lifecycles in trace")
    for rid, chain in lcs.items():
        if not chain or chain[0][0] != "queue" or chain[-1][0] != "decode":
            raise ValueError(f"req {rid}: incomplete chain {chain}")
        for (_, _, t1), (name, t0, _) in zip(chain, chain[1:]):
            if abs(t0 - t1) > tol:
                raise ValueError(f"req {rid}: gap before {name}: "
                                 f"{t1} -> {t0}")
    return len(lcs)


# ----------------------------------------------------------------------
_GANTT_CH = {"prefill": "P", "decode": "D", "transfer-fetch": "F",
             "tier-fetch": "T"}


def text_summary(payload: Dict[str, Any], width: int = 64,
                 top: int = 5) -> str:
    """Terminal Gantt/flame view of an exported trace: per-track stage
    totals with an occupancy bar, plus the slowest requests' lifecycle
    waterfalls (``benchmarks.report --trace``)."""
    names = {ev["tid"]: ev["args"]["name"]
             for ev in payload["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    spans: Dict[str, List[Tuple[float, float, str]]] = defaultdict(list)
    for ev in payload["traceEvents"]:
        if ev.get("ph") == "X":
            spans[names.get(ev["tid"], str(ev["tid"]))].append(
                (ev["ts"] / _US, (ev["ts"] + ev["dur"]) / _US, ev["name"]))
    all_spans = [s for rows in spans.values() for s in rows]
    lcs = request_lifecycles(payload)
    if not all_spans and not lcs:
        return "(empty trace)"
    t0 = min([s[0] for s in all_spans]
             + [c[0][1] for c in lcs.values() if c])
    t1 = max([s[1] for s in all_spans]
             + [c[-1][2] for c in lcs.values() if c])
    scale = width / max(t1 - t0, 1e-12)
    lines = [f"trace span [{t0:.3f}s, {t1:.3f}s]  "
             f"({len(all_spans)} spans, {len(lcs)} requests)", ""]
    for track in sorted(spans):
        rows = sorted(spans[track])
        by_stage: Dict[str, float] = defaultdict(float)
        for a, b, name in rows:
            by_stage[name] += b - a
        bar = ["."] * width
        for a, b, name in rows:
            lo = int((a - t0) * scale)
            hi = max(lo, min(width - 1, int((b - t0) * scale)))
            ch = _GANTT_CH.get(name, name[:1].upper() or "?")
            for i in range(lo, hi + 1):
                bar[i] = ch
        busy = sum(by_stage.values())
        stages = " ".join(f"{k}={v:.3f}s"
                          for k, v in sorted(by_stage.items()))
        lines.append(f"{track:>14s} |{''.join(bar)}|")
        lines.append(f"{'':>14s}  busy {busy:.3f}s  {stages}")
    if lcs:
        lines.append("")
        slowest = sorted(lcs.items(),
                         key=lambda kv: kv[1][0][1] - kv[1][-1][2])[:top]
        lines.append(f"slowest {len(slowest)} requests "
                     "(arrival-to-finish waterfall):")
        for rid, chain in slowest:
            total = chain[-1][2] - chain[0][1]
            parts = "  ".join(f"{name} {t1 - a:.3f}s"
                              for name, a, t1 in chain)
            lines.append(f"  req {rid:>4}  total {total:.3f}s: {parts}")
    return "\n".join(lines)
