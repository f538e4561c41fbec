"""The device's own record of the window: a ``torch.profiler`` trace of
CUDA activity (kernels and copies), read from its raw Kineto events.

Kineto stamps events in Unix-epoch nanoseconds; the window's host spans
are on ``time.perf_counter``. ``start`` notes both clocks at one
instant, so a span's host time maps onto the trace's clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class DevEvents:
    """The trace's device operations: names, and start and end in
    seconds on the host's perf_counter clock, as arrays."""
    names: List[str]
    t0: np.ndarray
    t1: np.ndarray

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, d in zip(self.names, (self.t1 - self.t0).tolist()):
            out[n] = out.get(n, 0.0) + d
        return out


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_start = self.t_stop = None
        self._offset = 0.0

    def start(self) -> None:
        """Starts the profiler and then the traced window: CUPTI's first
        attach is paid before ``t_start``. There is no trace at set-up,
        since a profiler once attached may slow the untraced launches
        after it."""
        self.prof.start()
        self._offset = time.time_ns() / 1e9 - time.perf_counter()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.t_start is None or self.t_stop is not None:
            return
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def events(self) -> DevEvents:
        cuda = torch.autograd.DeviceType.CUDA
        names, starts, durs = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                names.append(e.name())
                starts.append(e.start_ns())
                durs.append(e.duration_ns())
        t0 = np.asarray(starts, dtype=np.float64) / 1e9 - self._offset
        return DevEvents(names, t0, t0 + np.asarray(durs, np.float64) / 1e9)


def busy_intervals(ev: DevEvents, lo: float, hi: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The union of the events' intervals clipped to [lo, hi], as the
    (starts, ends) of its disjoint pieces in order."""
    a, b = np.clip(ev.t0, lo, hi), np.clip(ev.t1, lo, hi)
    keep = b > a
    a, b = a[keep], b[keep]
    if not a.size:
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], np.maximum.accumulate(b[order])
    new = np.empty(a.size, dtype=bool)
    new[0] = True
    new[1:] = a[1:] > b[:-1]
    starts = a[new]
    ends = b[np.r_[np.flatnonzero(new)[1:] - 1, a.size - 1]]
    return starts, ends
