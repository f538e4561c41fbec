"""Energy accounting + latency-energy Pareto utilities (paper Figs 3-5).

``EnergyMeter`` integrates instantaneous power over intervals per hardware
component — the simulation analogue of the paper's pynvml / RAPL / IPMI
measurement stack. Components: one entry per accelerator ("acc0", "acc1"),
plus "cpu", "dram", "disk", "ici"/"pcie" transfer media.

Accelerator busy intervals are logged with (phi, utilization) so the DVFS
study (Experiment 2) can attribute stage-wise energy at each frequency.
When a ``PowerTrace`` is attached (every ``FleetCluster`` run attaches
one), timestamped ``add_power`` calls additionally append power samples,
giving each component a plottable idle/active power timeline
(``repro.govern.telemetry``, DESIGN.md section 11).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.govern.telemetry import ACTIVE, IDLE, PowerTrace


def seq_sum(base: float, vals: np.ndarray) -> float:
    """Left-fold ``base + vals[0] + vals[1] + ...`` with rounding
    identical to the scalar loop (np.cumsum accumulates sequentially, so
    the result is bit-equal to repeated ``+=``). The coalescing fast
    stepper uses this to replay a run's worth of float accumulation in
    one vector op without perturbing golden totals."""
    if len(vals) == 0:
        return base
    return float(np.cumsum(np.concatenate(((base,), vals)))[-1])


@dataclass
class EnergyMeter:
    joules: Dict[str, float] = field(
        default_factory=lambda: collections.defaultdict(float))
    # per-stage attribution (prefill / decode / transfer-store /
    # transfer-fetch / idle)
    by_stage: Dict[str, float] = field(
        default_factory=lambda: collections.defaultdict(float))
    # optional sampled power timeline; purely observational — the joule
    # totals above are accumulated by the identical call sequence
    # whether or not a trace is attached (golden parity stays bit-exact)
    trace: Optional[PowerTrace] = None

    def add(self, component: str, joules: float, stage: str = "other"):
        self.joules[component] += joules
        self.by_stage[stage] += joules

    def add_power(self, component: str, watts: float, seconds: float,
                  stage: str = "other", t0: Optional[float] = None,
                  state: Optional[str] = None):
        self.add(component, watts * seconds, stage)
        if self.trace is not None and t0 is not None:
            if state is None:
                state = IDLE if stage == "idle" else ACTIVE
            self.trace.record(component, t0, t0 + seconds, watts, stage,
                              state=state)

    def add_power_run(self, component: str, watts: np.ndarray,
                      seconds: np.ndarray, stage: str,
                      t0s: Optional[np.ndarray] = None):
        """Bulk equivalent of ``len(watts)`` sequential ``add_power``
        calls: joules fold left-to-right (bit-equal to the scalar loop,
        see ``seq_sum``) and the trace — when attached — gains one
        ``PowerSample`` per element with ``t1 = t0 + seconds`` computed
        elementwise exactly as the scalar path does."""
        vals = watts * seconds
        self.joules[component] = seq_sum(self.joules[component], vals)
        self.by_stage[stage] = seq_sum(self.by_stage[stage], vals)
        if self.trace is not None and t0s is not None:
            self.trace.record_run(component, t0s, t0s + seconds, watts,
                                  stage,
                                  state=IDLE if stage == "idle" else ACTIVE)

    @property
    def total_j(self) -> float:
        return sum(self.joules.values())

    def breakdown(self) -> Dict[str, float]:
        return dict(self.joules)

    def merge(self, other: "EnergyMeter") -> "EnergyMeter":
        out = EnergyMeter()
        for src in (self, other):
            for k, v in src.joules.items():
                out.joules[k] += v
            for k, v in src.by_stage.items():
                out.by_stage[k] += v
        return out


# ----------------------------------------------------------------------
# Pareto frontier (paper Fig 5): (latency, energy) points over a freq grid
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ParetoPoint:
    phi: float            # relative frequency (or (phi_p, phi_d) encoded)
    latency_s: float
    energy_j: float
    label: str = ""


def pareto_frontier(points: Iterable[ParetoPoint]) -> List[ParetoPoint]:
    """Non-dominated subset (lower latency AND lower energy is better)."""
    pts = sorted(points, key=lambda p: (p.latency_s, p.energy_j))
    front: List[ParetoPoint] = []
    best_e = float("inf")
    for p in pts:
        if p.energy_j < best_e:
            front.append(p)
            best_e = p.energy_j
    return front


def min_energy_under_slo(points: Iterable[ParetoPoint],
                         latency_slo_s: Optional[float]
                         ) -> Optional[ParetoPoint]:
    """SLO-aware frequency selection: min energy s.t. latency <= SLO."""
    feasible = [p for p in points
                if latency_slo_s is None or p.latency_s <= latency_slo_s]
    if not feasible:
        return None
    return min(feasible, key=lambda p: p.energy_j)


def sweet_spot(points: Iterable[ParetoPoint]) -> ParetoPoint:
    """Unconstrained minimum-energy point (bottom of the U-curve)."""
    return min(points, key=lambda p: p.energy_j)
