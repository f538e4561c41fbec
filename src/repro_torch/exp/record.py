"""RunRecord: the one result schema behind every figure and report.

A ``RunRecord`` is the JSON-stable aggregate of a single ``Experiment``
run — workload metrics, per-component and per-stage energy, goodput
scoring, governor activity — and is what the content-addressed cache
stores. The schema is versioned: ``SCHEMA_VERSION`` is part of the
cache key, so changing the record's meaning (new fields are fine;
changed semantics are not) must bump it, which invalidates every cached
cell at once instead of silently mixing generations.

Float fidelity: values round-trip through JSON exactly (Python floats
serialize via repr), so a cache hit is value-identical to the
simulation that produced it — the figure-parity goldens rely on this.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.request import WorkloadMetrics

__all__ = ["SCHEMA_VERSION", "EnergyView", "RunRecord",
           "prefill_side_j", "decode_side_j"]

# bump on any semantic change to the record (field meaning, energy
# attribution, metric definition); every cached cell re-simulates
SCHEMA_VERSION = 1


def prefill_side_j(by_stage: Dict[str, float]) -> float:
    """Active energy attributed to the prefill side of a run: the stage
    itself plus the KV store leg it drives. THE per-leg attribution
    rule (store -> prefill, fetch -> decode) — fig5, the F6 claim
    check, and the DVFS sweeps all call this, so changing the rule
    changes all of them together. Tiered-KV traffic (DESIGN.md section
    15) is prefill-side by the same rule: demand fetches precede (and
    delay) the prefill that consumes the pages, spills are driven by
    prefill-side inserts. These stages only exist for tiered specs, so
    untiered records are numerically unchanged (no schema bump)."""
    return by_stage.get("prefill", 0.0) \
        + by_stage.get("transfer-store", 0.0) \
        + by_stage.get("tier-fetch", 0.0) \
        + by_stage.get("tier-spill", 0.0)


def decode_side_j(by_stage: Dict[str, float]) -> float:
    """Decode-side twin of ``prefill_side_j``: decode + the fetch leg
    that occupies the decode engine at admission."""
    return by_stage.get("decode", 0.0) + by_stage.get("transfer-fetch",
                                                      0.0)


@dataclass(frozen=True)
class EnergyView:
    """The slice of ``EnergyMeter`` the figures consume, reconstructed
    from a record: totals plus the component/stage attributions."""
    joules: Dict[str, float]
    by_stage: Dict[str, float]

    @property
    def total_j(self) -> float:
        return sum(self.joules.values())

    def breakdown(self) -> Dict[str, float]:
        return dict(self.joules)


@dataclass(frozen=True)
class RunRecord:
    """Stable result schema, shared by all figures and report tooling."""
    schema_version: int
    spec_hash: str
    spec: Dict[str, Any]               # Experiment.to_dict()
    setup: str                         # display label (sweep-row key)
    arch: str
    metrics: WorkloadMetrics
    energy_by_component: Dict[str, float]
    energy_by_stage: Dict[str, float]
    makespan_s: float
    total_tokens: int
    governor_decisions: int = 0
    # goodput scoring: against the experiment's SLO when it has one,
    # else each request's own (absent targets pass — the t=0 batches)
    goodput: Optional[Dict[str, float]] = None
    # fleet-controller activity (scale/flip/sleep ops logged during the
    # run); additive with a default, so pre-controller cached records
    # deserialize unchanged
    controller_actions: int = 0
    # observability snapshot (repro_torch.obs.metrics.MetricsRegistry
    # .snapshot()): latency histograms, fastpath coalescing stats, tier
    # hit rates, router decision counts. Additive with a default — the
    # same no-bump contract as controller_actions
    obs: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    @property
    def energy(self) -> EnergyView:
        return EnergyView(joules=dict(self.energy_by_component),
                          by_stage=dict(self.energy_by_stage))

    @property
    def total_j(self) -> float:
        return sum(self.energy_by_component.values())

    @property
    def idle_j(self) -> float:
        return self.energy_by_stage.get("idle", 0.0)

    @property
    def prefill_side_j(self) -> float:
        return prefill_side_j(self.energy_by_stage)

    @property
    def decode_side_j(self) -> float:
        return decode_side_j(self.energy_by_stage)

    @property
    def joules_per_token(self) -> float:
        return self.total_j / max(self.total_tokens, 1)

    @property
    def attainment(self) -> float:
        return self.goodput["attainment"] if self.goodput else 1.0

    @property
    def goodput_rps(self) -> float:
        return self.goodput["goodput_rps"] if self.goodput else 0.0

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["metrics"] = dataclasses.asdict(self.metrics)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunRecord":
        d = dict(d)
        d["metrics"] = WorkloadMetrics(**d["metrics"])
        return cls(**d)

    # ------------------------------------------------------------------
    @classmethod
    def from_result(cls, exp, result, *, governor_decisions: int = 0,
                    controller_actions: int = 0,
                    requests: Optional[List] = None,
                    obs: Optional[Dict[str, Any]] = None) -> "RunRecord":
        """Build the record from a finished ``SetupResult``; when the
        experiment carries an SLO the goodput block is scored with it
        (same arithmetic as ``repro_torch.workload.evaluate``)."""
        goodput = None
        if requests:
            from repro_torch.workload.goodput import evaluate
            rep = evaluate(requests, exp.slo)
            goodput = {"n": rep.n, "attained": rep.attained,
                       "attainment": rep.attainment,
                       "duration_s": rep.duration_s,
                       "goodput_rps": rep.goodput_rps,
                       "offered_rps": rep.offered_rps}
        return cls(schema_version=SCHEMA_VERSION,
                   spec_hash=exp.spec_hash(), spec=exp.to_dict(),
                   setup=exp.setup, arch=exp.arch, metrics=result.metrics,
                   energy_by_component=dict(result.energy.joules),
                   energy_by_stage=dict(result.energy.by_stage),
                   makespan_s=result.makespan_s,
                   total_tokens=result.total_tokens,
                   governor_decisions=governor_decisions,
                   controller_actions=controller_actions,
                   goodput=goodput, obs=obs)
