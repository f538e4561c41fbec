"""Power-state telemetry: per-component time-series power traces.

The paper measures power with pynvml / RAPL / IPMI *samplers* — a power
timeline, not just integrated joules — and its central energy finding is
about the shape of that timeline: disaggregated serving keeps more
accelerator-seconds in the idle state (static draw with no work), so its
integrated energy stays higher even when stage-wise DVFS trims the
active draw. ``PowerTrace`` is the simulation analogue of that sampler:
every ``EnergyMeter.add_power`` call that knows *when* its interval
happened appends a ``PowerSample``; after a run the cluster fills each
accelerator's uncovered gaps with explicit idle-state samples, so the
idle-energy floor becomes a first-class, plottable quantity
(``energy_j(state="idle")``, ``timeline()``).

This module is dependency-free (stdlib + numpy only): ``repro.core``
imports it, so it must not import ``repro.core`` back.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ACTIVE, IDLE = "active", "idle"
# Deep-sleep (powered down to a residual draw, wake costs latency) and
# absent (instance not part of the fleet over that interval — scaled in
# late or never provisioned). fill_idle must NEVER back-fill these
# windows with idle joules; the fleet controller records them
# explicitly so state_summary() attributes the floor honestly.
SLEEP, ABSENT = "sleep", "absent"


@dataclass(frozen=True)
class PowerSample:
    """One sampled interval of constant power draw on one component."""
    component: str
    t0: float
    t1: float
    watts: float
    stage: str              # prefill / decode / transfer-* / tier-fetch
                            #   (tiered-KV promotions, DESIGN.md s15) /
                            #   idle / other
    state: str = ACTIVE     # "active" (work) or "idle" (static floor)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def joules(self) -> float:
        return self.watts * self.seconds


class _RunBlock:
    """A contiguous run of constant-stage samples, stored as arrays and
    expanded to ``PowerSample`` objects only when somebody reads the
    per-sample view. ``t1s[i] == t0s[i+1]`` (checked at record time), so
    for coverage/energy queries the block acts as one interval."""

    __slots__ = ("t0s", "t1s", "watts", "stage", "state")

    def __init__(self, t0s, t1s, watts, stage, state):
        self.t0s = t0s
        self.t1s = t1s
        self.watts = watts
        self.stage = stage
        self.state = state

    def expand(self, component: str) -> List[PowerSample]:
        # direct __dict__ fill: a frozen dataclass pays one
        # object.__setattr__ per field in __init__, which dominates when
        # a fleet run expands tens of thousands of samples
        new = object.__new__
        out = []
        for a, b, w in zip(self.t0s.tolist(), self.t1s.tolist(),
                           self.watts.tolist()):
            s = new(PowerSample)
            s.__dict__.update(component=component, t0=a, t1=b, watts=w,
                              stage=self.stage, state=self.state)
            out.append(s)
        return out


class PowerTrace:
    """Append-only per-component power timeline.

    Purely observational: the authoritative joule totals live in
    ``EnergyMeter.joules`` (identical call sequence as before traces
    existed, so golden-metric parity is bit-exact); the trace is the
    sampled view a plotter or governor post-mortem reads. The two agree
    to fp rounding wherever an interval was recorded with a timestamp.

    Internally a component's timeline is a list of chunks — single
    ``PowerSample`` objects or lazily-expanded ``_RunBlock`` runs from
    the coalescing fast stepper. Coverage and energy queries consume
    chunks directly; ``samples`` materializes the flat per-sample lists
    (identical, in order, to recording every sample individually).
    """

    def __init__(self):
        self._chunks: Dict[str, List[object]] = collections.defaultdict(list)
        # per-component expansion cache: (expanded list, chunks consumed)
        self._expanded: Dict[str, Tuple[List[PowerSample], int]] = {}

    # ------------------------------------------------------------------
    def record(self, component: str, t0: float, t1: float, watts: float,
               stage: str = "other", state: str = ACTIVE) -> None:
        if t1 <= t0:
            return                      # zero-length interval: nothing
        self._chunks[component].append(
            PowerSample(component, t0, t1, watts, stage, state))

    def record_run(self, component: str, t0s, t1s, watts,
                   stage: str = "other", state: str = ACTIVE,
                   contiguous: bool = False) -> None:
        """Bulk ``record``: one sample per element, zero-length intervals
        skipped — observably identical to n sequential calls. A
        contiguous strictly-positive run (the only thing the fast
        stepper emits) is kept as one ``_RunBlock``; anything else falls
        back to per-sample records. ``contiguous=True`` asserts the run
        property (t1s[i] == t0s[i+1] > t0s[i]) without the O(n) check —
        for callers that slice the run from one strictly-increasing
        cumulative-time array."""
        n = len(t0s)
        if n == 0:
            return
        if contiguous or (bool((t1s > t0s).all()) and
                          (n == 1 or bool((t0s[1:] == t1s[:-1]).all()))):
            self._chunks[component].append(
                _RunBlock(t0s, t1s, watts, stage, state))
            return
        for a, b, w in zip(t0s.tolist(), t1s.tolist(), watts.tolist()):
            self.record(component, a, b, w, stage, state)

    @property
    def components(self) -> List[str]:
        return sorted(self._chunks)

    # ------------------------------------------------------------------
    def _samples_of(self, component: str) -> List[PowerSample]:
        """Flat per-sample list for one component (cached; chunk lists
        are append-only, so the cache only ever expands the new tail)."""
        chunks = self._chunks.get(component)
        if not chunks:
            return []
        out, done = self._expanded.get(component, ([], 0))
        for chunk in chunks[done:]:
            if isinstance(chunk, _RunBlock):
                out.extend(chunk.expand(component))
            else:
                out.append(chunk)
        self._expanded[component] = (out, len(chunks))
        return out

    @property
    def samples(self) -> Dict[str, List[PowerSample]]:
        return {c: self._samples_of(c) for c in self._chunks}

    # ------------------------------------------------------------------
    def intervals(self, component: str) -> List[Tuple[float, float]]:
        """Covered (t0, t1) intervals, merged and sorted."""
        ivs = []
        for chunk in self._chunks.get(component, []):
            if isinstance(chunk, _RunBlock):
                # contiguous by construction: one interval per run
                ivs.append((float(chunk.t0s[0]), float(chunk.t1s[-1])))
            else:
                ivs.append((chunk.t0, chunk.t1))
        # engine samples arrive in clock order, so this list is almost
        # always already sorted; Timsort makes the check effectively free
        ivs.sort()
        merged: List[Tuple[float, float]] = []
        for t0, t1 in ivs:
            if merged and t0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
            else:
                merged.append((t0, t1))
        return merged

    def gaps(self, component: str, t0: float,
             t1: float) -> List[Tuple[float, float]]:
        """Sub-intervals of [t0, t1] with no sample on ``component``."""
        out: List[Tuple[float, float]] = []
        cursor = t0
        for a, b in self.intervals(component):
            if b <= t0:
                continue
            if a >= t1:
                break
            if a > cursor:
                out.append((cursor, min(a, t1)))
            cursor = max(cursor, b)
        if cursor < t1:
            out.append((cursor, t1))
        return out

    def fill_idle(self, component: str, t0: float, t1: float,
                  idle_watts: float, stage: str = "idle") -> float:
        """Record an idle-state sample over every uncovered gap of
        [t0, t1]; returns the idle seconds filled. This is how the
        cluster turns 'makespan minus busy' into an explicit power-state
        timeline after a run."""
        filled = 0.0
        for a, b in self.gaps(component, t0, t1):
            self.record(component, a, b, idle_watts, stage, state=IDLE)
            filled += b - a
        return filled

    # ------------------------------------------------------------------
    def energy_j(self, component: Optional[str] = None,
                 state: Optional[str] = None) -> float:
        """Trace-integrated joules, filterable by component / state."""
        comps = [component] if component is not None else self.components
        total = 0.0
        for c in comps:
            for chunk in self._chunks.get(c, []):
                if state is not None and chunk.state != state:
                    continue
                if isinstance(chunk, _RunBlock):
                    total += float(np.dot(chunk.watts,
                                          chunk.t1s - chunk.t0s))
                else:
                    total += chunk.joules
        return total

    def busy_s(self, component: str) -> float:
        total = 0.0
        for chunk in self._chunks.get(component, []):
            if chunk.state != ACTIVE:
                continue
            if isinstance(chunk, _RunBlock):
                total += float(chunk.t1s[-1] - chunk.t0s[0])  # contiguous
            else:
                total += chunk.seconds
        return total

    def span(self, component: str) -> Tuple[float, float]:
        chunks = self._chunks.get(component, [])
        if not chunks:
            return (0.0, 0.0)
        t0s, t1s = [], []
        for chunk in chunks:
            if isinstance(chunk, _RunBlock):
                t0s.append(float(chunk.t0s[0]))
                t1s.append(float(chunk.t1s[-1]))
            else:
                t0s.append(chunk.t0)
                t1s.append(chunk.t1)
        return (min(t0s), max(t1s))

    def covers(self, component: str, t0: float, t1: float,
               tol: float = 1e-9) -> bool:
        """True when [t0, t1] has no uncovered gap wider than ``tol``."""
        return all(b - a <= tol for a, b in self.gaps(component, t0, t1))

    # ------------------------------------------------------------------
    def timeline(self, component: str, n: int = 200
                 ) -> Tuple[List[float], List[float]]:
        """(times, watts) resampled on an ``n``-point uniform grid over
        the component's span — the plottable power curve. Overlapping
        samples (they should not happen for an accelerator, which has
        one clock) sum, matching the energy integral."""
        t0, t1 = self.span(component)
        if n <= 0 or t1 <= t0:
            # empty/unknown component, a single zero-width sample, or a
            # degenerate grid: an empty curve, never a ZeroDivisionError
            return ([], [])
        step = (t1 - t0) / n
        times = [t0 + (i + 0.5) * step for i in range(n)]
        watts = [0.0] * n
        for s in self._samples_of(component):
            # uniform grid: each sample covers a contiguous index range
            # (O(samples + n) total, not O(samples * n))
            lo = max(0, int((s.t0 - t0) / step) - 1)
            hi = min(n - 1, int((s.t1 - t0) / step) + 1)
            for i in range(lo, hi + 1):
                if s.t0 <= times[i] < s.t1:
                    watts[i] += s.watts
        return (times, watts)

    # ------------------------------------------------------------------
    def state_summary(self) -> Dict[str, Dict[str, float]]:
        """{component: {"active_j", "idle_j", "sleep_j", "absent_j",
        "active_s", ...}} — the idle-floor table fig8 and the energy
        report print. Buckets by the sample's ACTUAL state: before the
        fleet controller existed every non-active sample was counted as
        idle, silently back-filling deep-sleep / not-yet-provisioned
        windows into the idle-energy floor. States outside the standard
        four get their own keys."""
        out: Dict[str, Dict[str, float]] = {}
        for c in self.components:
            row = {f"{k}_{u}": 0.0
                   for k in (ACTIVE, IDLE, SLEEP, ABSENT) for u in "js"}
            for chunk in self._chunks[c]:
                key = chunk.state
                row.setdefault(f"{key}_j", 0.0)
                row.setdefault(f"{key}_s", 0.0)
                if isinstance(chunk, _RunBlock):
                    row[f"{key}_j"] += float(np.dot(
                        chunk.watts, chunk.t1s - chunk.t0s))
                    row[f"{key}_s"] += float(chunk.t1s[-1] - chunk.t0s[0])
                else:
                    row[f"{key}_j"] += chunk.joules
                    row[f"{key}_s"] += chunk.seconds
            out[c] = row
        return out
