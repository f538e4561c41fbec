"""Tracing: the simulation clock's events, and the host's wall-clock spans.

``Tracer`` collects :class:`TraceEvent` records — engine phase/batch
spans, per-request lifecycle instants, KV-transfer spans, tier
movements, governor retunes, controller ops — stamped with the
*simulation* clock, so a trace is a pure function of ``(spec,
workload)`` and bit-reproducible like everything else in the simulator.

Determinism contract (DESIGN.md section 16, locked by
``tests/test_obs.py``):

  * tracer **off** (the ``NULL_TRACER`` default) the hooks are a single
    attribute read + branch — behavior is byte-identical to a build
    without them;
  * tracer **on** the hooks only *read* simulation state — every
    metric, timestamp, and joule stays bit-identical to an untraced
    run (a new parity axis fuzzes this);
  * **fast vs exact stepper**: a coalesced decode window emits ONE
    window-level span carrying its step count where the exact stepper
    emits one span per step. After :meth:`Tracer.coalesced` — maximal
    merging of adjacent same-name spans per track, summing ``steps`` —
    the two steppers' engine traces are identical, and the lifecycle /
    governor / controller instants are identical as timestamped sets
    (a coalesced window batches its finish emissions, so only the
    cross-engine interleaving of the event *list* may differ).

**Wall-clock spans** are a second family on the same ``Tracer``,
switched by its own flag (``Tracer(wall=True)``; ``enabled`` switches
the simulation-clock hooks alone). A :class:`WallSpan` is stamped with
``time.perf_counter_ns()`` and stored in ``time.perf_counter`` seconds:
the clock of the benchmark harness's own spans (``portbench/``), onto
which its device trace is mapped, so that program spans, harness spans
and device operations share one timeline. A span has an id, its
parent's id (the innermost span open when it began) and flat args; a
span tied to one request carries ``req``. Wall spans live
in ``Tracer.walls``, apart from ``events``, so the simulation-clock
views, the exporters and the SLO attribution see exactly what they
would see without them. Hook sites guard on ``tracer.wall`` as the
simulation hooks guard on ``tracer.enabled``: off, each costs one
attribute read and a branch, and ``NULL_TRACER`` records nothing.

This module is dependency-free at import time (stdlib only):
``repro.core.engine`` imports it, so it must not import ``repro``
back. The converters at the bottom single-source the three event
formats that used to live apart — obs events, ``GovernorDecision``
records, and the ``FleetCluster.controller_log`` action dicts — with
JSON round-trips tested in ``tests/test_obs.py``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["SPAN", "INSTANT", "LIFECYCLE_TRACK", "GOVERNOR_TRACK",
           "CONTROLLER_TRACK", "TIER_TRACK", "TraceEvent", "WallSpan",
           "Tracer", "NULL_TRACER", "self_times",
           "event_from_governor_decision",
           "governor_decision_from_event", "event_from_controller_action",
           "controller_action_from_event"]

SPAN, INSTANT = "span", "instant"

# Reserved track names. Engine tracks use the engine's own name
# ("acc0", ...); KV-transfer spans ride on "xfer:<src>-><dst>".
LIFECYCLE_TRACK = "lifecycle"
GOVERNOR_TRACK = "governor"
CONTROLLER_TRACK = "controller"
TIER_TRACK = "tier"
_RESERVED_TRACKS = (LIFECYCLE_TRACK, GOVERNOR_TRACK, CONTROLLER_TRACK,
                    TIER_TRACK)

# Lifecycle instants: the arrival/first_token/finish triple is emitted
# exactly once per request (the property suite pins this); the rest may
# legitimately repeat (a preempted prefill completes twice, a parked
# request is routed twice).
LIFECYCLE_ONCE = ("arrival", "first_token", "finish")


@dataclass
class TraceEvent:
    """One trace record. ``t1 == t0`` for instants; ``args`` is a flat
    JSON-safe dict (ints/floats/strings only, by convention)."""
    name: str
    track: str
    t0: float
    t1: float
    kind: str = SPAN
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "track": self.track, "t0": self.t0,
                "t1": self.t1, "kind": self.kind, "args": dict(self.args)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(name=d["name"], track=d["track"], t0=d["t0"],
                   t1=d["t1"], kind=d["kind"], args=dict(d["args"]))


@dataclass
class WallSpan:
    """One wall-clock span: ``t0``/``t1`` in ``time.perf_counter``
    seconds (``t1`` is None while it is open), ``id`` its index in
    ``Tracer.walls``, ``parent`` the id of the span it began inside."""
    name: str
    t0: float
    t1: Optional[float]
    id: int
    parent: Optional[int]
    args: Dict[str, Any]

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def _now() -> float:
    return time.perf_counter_ns() * 1e-9


def self_times(spans: Iterable[WallSpan]) -> Dict[int, float]:
    """{span id: its duration less the part its children cover}.
    Children nest inside their parent and follow one another, so the
    part they cover is the sum of their durations; a child whose parent
    is not among ``spans`` counts for nobody."""
    spans = list(spans)
    out = {s.id: s.dur for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.dur
    return out


class Tracer:
    """Append-only event sink. Hot paths guard on ``tracer.enabled``
    (simulation-clock events) or ``tracer.wall`` (wall-clock spans)
    before computing any event arguments, so the disabled default costs
    one attribute read per hook site."""

    enabled = True

    def __init__(self, *, enabled: bool = True, wall: bool = False):
        self.enabled = enabled
        self.wall = wall
        self.events: List[TraceEvent] = []
        self.walls: List[WallSpan] = []
        self._open: List[WallSpan] = []

    # ---- wall-clock spans --------------------------------------------
    def begin(self, name: str, **args) -> None:
        """Open a span inside the innermost open one."""
        parent = self._open[-1].id if self._open else None
        s = WallSpan(name, _now(), None, len(self.walls), parent, args)
        self.walls.append(s)
        self._open.append(s)

    def end(self, **args) -> None:
        """Close the innermost open span, adding ``args`` to its own."""
        s = self._open.pop()
        s.t1 = _now()
        s.args.update(args)

    def note(self, **args) -> None:
        """Add ``args`` to the innermost open span."""
        self._open[-1].args.update(args)

    def switch(self, name: str, **args) -> None:
        """Close the innermost open span and open its next sibling at the
        same instant, so that consecutive phases leave no gap."""
        s = self._open.pop()
        s.t1 = t = _now()
        nxt = WallSpan(name, t, None, len(self.walls), s.parent, args)
        self.walls.append(nxt)
        self._open.append(nxt)

    # ---- emission ----------------------------------------------------
    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> None:
        self.events.append(TraceEvent(name, track, float(t0), float(t1),
                                      SPAN, args))

    def instant(self, track: str, name: str, t: float, **args) -> None:
        t = float(t)
        self.events.append(TraceEvent(name, track, t, t, INSTANT, args))

    def lifecycle(self, name: str, req_id: int, t: float, **args) -> None:
        """One per-request lifecycle instant (track ``lifecycle``)."""
        self.instant(LIFECYCLE_TRACK, name, t, req=int(req_id), **args)

    # ---- views -------------------------------------------------------
    def spans(self, track: Optional[str] = None) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == SPAN
                and (track is None or e.track == track)]

    def instants(self, track: Optional[str] = None) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == INSTANT
                and (track is None or e.track == track)]

    def engine_tracks(self) -> List[str]:
        """Tracks carrying engine phase spans (everything that is not a
        reserved track or a transfer-pair track)."""
        seen = []
        for e in self.events:
            if e.kind == SPAN and e.track not in _RESERVED_TRACKS \
                    and not e.track.startswith("xfer:") \
                    and e.track not in seen:
                seen.append(e.track)
        return sorted(seen)

    def coalesced(self, track: str) -> List[Tuple[str, float, float, int]]:
        """Engine spans of ``track`` after maximal merging of adjacent
        same-name spans (``next.t0 == cur.t1``), summing step counts —
        the normalization under which fast and exact steppers emit
        identical traces (the window-span contract)."""
        out: List[Tuple[str, float, float, int]] = []
        for e in self.spans(track):
            steps = int(e.args.get("steps", 0))
            if out and out[-1][0] == e.name and out[-1][2] == e.t0:
                name, t0, _, n = out[-1]
                out[-1] = (name, t0, e.t1, n + steps)
            else:
                out.append((e.name, e.t0, e.t1, steps))
        return out

    # ---- per-request lifecycle ---------------------------------------
    def lifecycle_events(self) -> Dict[int, Dict[str, List[TraceEvent]]]:
        """{req_id: {event name: events in emission (= time) order}}."""
        out: Dict[int, Dict[str, List[TraceEvent]]] = defaultdict(
            lambda: defaultdict(list))
        for e in self.instants(LIFECYCLE_TRACK):
            out[e.args["req"]][e.name].append(e)
        return {k: dict(v) for k, v in out.items()}

    def request_ids(self) -> List[int]:
        return sorted({e.args["req"]
                       for e in self.instants(LIFECYCLE_TRACK)})

    def derive_lifecycle(self, req_id: int) -> List[Tuple[str, float,
                                                          float]]:
        """The request's journey as contiguous (stage, t0, t1) spans:
        ``queue -> prefill [-> transfer -> decode-queue -> fetch] ->
        decode``, derived from the lifecycle instants. Adjacent spans
        share their boundary instant, so the set covers
        arrival..finish with no gap — the "complete lifecycle span
        set" the Perfetto export and the CI check consume."""
        evs = {}
        for e in self.instants(LIFECYCLE_TRACK):
            if e.args["req"] != req_id:
                continue
            evs.setdefault(e.name, []).append(e.t0)
        if "arrival" not in evs or "first_token" not in evs:
            return []
        arrival = evs["arrival"][0]
        first = evs["first_token"][0]
        finish = evs.get("finish", [first])[0]
        out = []
        if "prefill_start" not in evs:
            return [("queue", arrival, first), ("decode", first, finish)]
        ps = evs["prefill_start"][0]
        out.append(("queue", arrival, ps))
        if "transfer_done" not in evs:
            # colocated: the first token is sampled from the prefill
            # logits, so everything between prefill_start and
            # first_token (chunk waits, interference, recompute) is the
            # prefill stage
            out.append(("prefill", ps, first))
        else:
            td = evs["transfer_done"][-1]
            pd = max(t for t in evs.get("prefill_done", [td]) if t <= td)
            out.append(("prefill", ps, pd))
            out.append(("transfer", pd, td))
            if "fetch_start" in evs:
                fs = evs["fetch_start"][0]
                out.append(("decode-queue", td, fs))
                out.append(("fetch", fs, first))
            else:
                out.append(("decode-queue", td, first))
        out.append(("decode", first, finish))
        return out


class _NullTracer(Tracer):
    """The zero-overhead default: ``enabled`` is False and every
    emission method is a no-op, so un-guarded call sites stay cheap and
    guarded ones cost one attribute read."""

    enabled = False

    def __init__(self):
        super().__init__(enabled=False, wall=False)

    def span(self, track, name, t0, t1, **args):
        pass

    def begin(self, name, **args):
        pass

    def end(self, **args):
        pass

    def note(self, **args):
        pass

    def switch(self, name, **args):
        pass

    def instant(self, track, name, t, **args):
        pass

    def lifecycle(self, name, req_id, t, **args):
        pass


NULL_TRACER = _NullTracer()


# ----------------------------------------------------------------------
# Format converters: the obs event is the canonical record; the legacy
# shapes (GovernorDecision, controller_log dicts) are derived views.
# ----------------------------------------------------------------------
def event_from_governor_decision(d) -> TraceEvent:
    """``repro.govern.GovernorDecision`` -> instant on the governor
    track (same payload ``Governor.on_step`` emits live)."""
    return TraceEvent(name="phi", track=GOVERNOR_TRACK, t0=float(d.t),
                      t1=float(d.t), kind=INSTANT,
                      args={"engine": d.engine, "phi": d.phi,
                            "signal": d.signal})


def governor_decision_from_event(ev: TraceEvent):
    assert ev.track == GOVERNOR_TRACK and ev.name == "phi", ev
    from repro_torch.govern.governors import GovernorDecision  # lazy: no cycle
    return GovernorDecision(t=ev.t0, engine=ev.args["engine"],
                            phi=ev.args["phi"], signal=ev.args["signal"])


def event_from_controller_action(d: Dict[str, Any]) -> TraceEvent:
    """A ``FleetCluster.controller_log`` entry (``{"t", "op", "engine",
    **kw}``) -> instant on the controller track."""
    args = {"engine": d["engine"]}
    args.update({k: v for k, v in d.items()
                 if k not in ("t", "op", "engine")})
    return TraceEvent(name=d["op"], track=CONTROLLER_TRACK,
                      t0=float(d["t"]), t1=float(d["t"]), kind=INSTANT,
                      args=args)


def controller_action_from_event(ev: TraceEvent) -> Dict[str, Any]:
    assert ev.track == CONTROLLER_TRACK, ev
    out: Dict[str, Any] = {"t": ev.t0, "op": ev.name,
                           "engine": ev.args["engine"]}
    out.update({k: v for k, v in ev.args.items() if k != "engine"})
    return out
