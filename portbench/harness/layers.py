"""What a per-layer metric reads, and how the harness finds each metric.

Each per-layer metric is one module, ``portbench/metrics/<name>.py``,
with ``read(ctx) -> float | None``: None where its layer left nothing to
read in this cell (the metric then stays out of the result line). The
harness loads it by the name ``BENCHMARK.json`` gives.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np

from .devtrace import DevEvents, busy_intervals
from .serving import PAGE, Span  # noqa: F401 (PAGE: for the readers)

METRICS = Path(__file__).resolve().parent.parent / "metrics"


@dataclass
class Context:
    """A ``--trace 1`` run's window is two parts: [t0, t1), untraced,
    whose calls' host-clock walls the host-clock metrics read, and then
    the part the device trace covers, whose calls the device metrics
    read (the profiler slows every launch, so the walls of traced calls
    are not the program's)."""
    spans: List[Span]              # the calls that began in [t0, t1)
    traced_spans: List[Span]       # those of the traced part
    t0: float                      # the window's start
    t1: float                      # the end of its untraced part
    cfg: dict                      # the configuration file
    ref: ModuleType                # the family's reference module
    events: Optional[DevEvents] = None          # the device trace
    trace: Optional[Tuple[float, float]] = None  # its start and stop
    _by_name: Optional[Dict[str, float]] = None

    def of(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def traced_of(self, kind: str) -> List[Span]:
        return [s for s in self.traced_spans if s.kind == kind]

    def wall(self, kind: str) -> float:
        return sum(s.t1 - s.t0 for s in self.of(kind))

    def by_name(self) -> Dict[str, float]:
        """Device seconds of the trace's operations, by name."""
        if self._by_name is None:
            self._by_name = self.events.seconds_by_name() \
                if self.events is not None else {}
        return self._by_name

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the trace's kernels whose name holds
        ``pattern``."""
        return sum(s for n, s in self.by_name().items() if pattern in n)

    def busy_s(self) -> float:
        a, b = busy_intervals(self.events, *self.trace)
        return float((b - a).sum())


def load(name: str) -> ModuleType:
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def breakdown(ctx: Context, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the device's idle
    time by what the host was doing then (a call of the port's, or the
    serving loop between calls)."""
    lo, hi = ctx.trace
    ops = sorted(ctx.by_name().items(), key=lambda kv: -kv[1])[:top]
    a, b = busy_intervals(ctx.events, lo, hi)
    g0, g1 = np.r_[lo, b], np.r_[a, hi]          # the idle gaps
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    spans = sorted(ctx.traced_spans, key=lambda s: s.t0)
    starts = np.asarray([s.t0 for s in spans])
    ends = np.asarray([s.t1 for s in spans])
    kinds = [s.kind for s in spans] + ["loop"]
    mid = (g0 + g1) / 2
    i = np.searchsorted(starts, mid, side="right") - 1
    inside = (i >= 0) & (mid < ends[np.maximum(i, 0)]) if spans else \
        np.zeros(mid.size, dtype=bool)
    which = np.where(inside, i, len(spans))
    idle: Dict[str, float] = {}
    for k, d in zip(which.tolist(), (g1 - g0).tolist()):
        idle[kinds[k]] = idle.get(kinds[k], 0.0) + d
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_by]}
