"""Open-loop arrival processes (DESIGN.md section 9).

The paper's RandomDataset submits every request at t=0 ("infinite
rate"); DistServe (arXiv 2401.09670) frames the co-vs-dis comparison as
SLO-attainment goodput under an *open-loop* arrival process instead.
Every process here is seed-deterministic: ``times(n, seed)`` returns the
same non-decreasing float64 array for the same arguments, so a workload
is fully reproducible from ``(process, n, seed)``.

Conventions shared by all processes:

  * ``rate`` is the nominal long-run request rate in requests/second
    (``nominal_rate`` for processes whose instantaneous rate varies).
  * the first arrival is at the first inter-arrival gap (not t=0), so
    a rate sweep degrades gracefully into the paper's t=0 batch as
    ``rate -> inf`` rather than pinning one request to the origin.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class ArrivalProcess:
    """Base: ``times(n, seed)`` -> sorted arrival times, seconds."""

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    @property
    def nominal_rate(self) -> float:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _finalize(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        assert np.all(np.diff(t) >= 0.0), "arrival times must be sorted"
        assert t.size == 0 or t[0] >= 0.0
        return t


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process: i.i.d. exponential gaps, mean 1/rate."""
    rate: float

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        assert self.rate > 0 and n >= 0
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return self._finalize(np.cumsum(gaps))

    @property
    def nominal_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class GammaArrivals(ArrivalProcess):
    """Renewal process with gamma gaps: mean 1/rate, coefficient of
    variation ``cv``. ``cv > 1`` is burstier than Poisson (the FlowKV
    arXiv 2504.03775 regime where transfer media separate), ``cv < 1``
    smoother, ``cv == 1`` recovers Poisson exactly."""
    rate: float
    cv: float = 2.0

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        assert self.rate > 0 and self.cv > 0 and n >= 0
        rng = np.random.default_rng(seed)
        shape = 1.0 / (self.cv ** 2)
        scale = self.cv ** 2 / self.rate           # shape*scale = 1/rate
        gaps = rng.gamma(shape, scale, size=n)
        return self._finalize(np.cumsum(gaps))

    @property
    def nominal_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class RampArrivals(ArrivalProcess):
    """Non-homogeneous Poisson ramp: instantaneous rate climbs linearly
    from ``rate0`` to ``rate1`` over ``ramp_s`` seconds, then holds at
    ``rate1``. Sampled exactly by inverting the cumulative intensity
    Lambda(t) against unit-rate exponential increments (no thinning, so
    the draw count — hence determinism — is independent of the rates)."""
    rate0: float
    rate1: float
    ramp_s: float

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        assert self.rate0 > 0 and self.rate1 > 0 and self.ramp_s > 0
        rng = np.random.default_rng(seed)
        targets = np.cumsum(rng.exponential(1.0, size=n))  # Lambda targets
        r0, r1, d = self.rate0, self.rate1, self.ramp_s
        a = (r1 - r0) / (2.0 * d)                  # Lambda(t)=r0 t + a t^2
        lam_ramp_end = 0.5 * (r0 + r1) * d
        out = np.empty(n, dtype=np.float64)
        for i, lam in enumerate(targets):
            if lam >= lam_ramp_end:                # past the ramp: linear
                out[i] = d + (lam - lam_ramp_end) / r1
            elif abs(a) < 1e-12:                   # flat ramp
                out[i] = lam / r0
            else:                                  # invert the quadratic
                out[i] = (np.sqrt(r0 * r0 + 4.0 * a * lam) - r0) / (2.0 * a)
        return self._finalize(out)

    @property
    def nominal_rate(self) -> float:
        return self.rate1


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Non-homogeneous Poisson diurnal cycle: instantaneous rate

        r(t) = rate * (floor + (1 - floor) * (1 - cos(2 pi t/period)) / 2)

    — a raised-cosine day/night swing between ``rate * floor`` (trough)
    and ``rate`` (peak), period ``period_s``. This is the traffic shape
    autoscaling papers (P/D-Serve, DualScale) target: long low-rate
    valleys where a static fleet burns its idle floor and an adaptive
    one sleeps. Sampled exactly like ``RampArrivals``: unit-exponential
    targets inverted against the closed-form cumulative intensity

        Lambda(t) = rate * (floor t + (1-floor)(t - (p/2pi) sin(2pi t/p))/2)

    by bisection (Lambda is strictly increasing; r(t) >= rate*floor > 0
    bounds the bracket), so the draw count is n regardless of rates."""
    rate: float                 # peak rate, req/s
    period_s: float = 60.0
    floor: float = 0.1          # trough fraction of peak, in (0, 1]

    def _cum(self, t: np.ndarray) -> np.ndarray:
        p, f = self.period_s, self.floor
        w = 2.0 * np.pi / p
        return self.rate * (f * t + (1.0 - f) * 0.5
                            * (t - np.sin(w * t) / w))

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        assert self.rate > 0 and self.period_s > 0 and 0 < self.floor <= 1
        rng = np.random.default_rng(seed)
        targets = np.cumsum(rng.exponential(1.0, size=n))
        rate_min = self.rate * self.floor
        lo = np.zeros(n)
        hi = targets / rate_min + 1.0      # Lambda(hi) >= targets always
        for _ in range(200):               # bisection to float64 limits
            mid = 0.5 * (lo + hi)
            below = self._cum(mid) < targets
            lo = np.where(below, mid, lo)
            hi = np.where(below, hi, mid)
            if np.all(hi - lo <= 1e-12 * np.maximum(hi, 1.0)):
                break
        return self._finalize(np.maximum.accumulate(0.5 * (lo + hi)))

    @property
    def nominal_rate(self) -> float:
        """Long-run average rate (the mean of the raised cosine)."""
        return self.rate * (1.0 + self.floor) / 2.0


@dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Fixed inter-arrival interval 1/rate (the closed-form staggered
    schedule; seed is accepted for interface uniformity and ignored)."""
    rate: float

    def times(self, n: int, seed: int = 0) -> np.ndarray:
        assert self.rate > 0 and n >= 0
        return self._finalize((np.arange(n, dtype=np.float64) + 1.0)
                              / self.rate)

    @property
    def nominal_rate(self) -> float:
        return self.rate


# ----------------------------------------------------------------------
_ARRIVALS = {
    "poisson": PoissonArrivals,
    "gamma": GammaArrivals,
    "ramp": RampArrivals,
    "diurnal": DiurnalArrivals,
    "deterministic": DeterministicArrivals,
}


def make_arrivals(kind: str, **kw) -> ArrivalProcess:
    """Registry constructor, e.g. ``make_arrivals("poisson", rate=4.0)``."""
    try:
        cls = _ARRIVALS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival process {kind!r}; "
                         f"choose from {sorted(_ARRIVALS)}") from None
    return cls(**kw)
