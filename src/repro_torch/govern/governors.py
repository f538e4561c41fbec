"""Online DVFS governors: per-instance frequency controllers.

The paper's Experiment 2 evaluates *offline* grids — one phi fixed for
a whole run (``repro.core.dvfs``). A real deployment runs a *governor*:
a controller that retunes each accelerator's frequency online from the
signals it can actually observe (queue depth, SLO slack). DualScale
(PAPERS.md) is the reference design for the phase-aware variant. The
question fig8 asks with these classes is whether ANY realizable governor
lets disaggregation's stage-wise independent scaling close the energy
gap the paper measures — and the answer stays no, because the gap is an
idle-power floor, not an active-power inefficiency.

Contract: ``Governor.on_step(engine)`` is invoked by the engine event
loop immediately before each scheduler step; it inspects the engine
(queues, cost model, clock), writes ``engine.phi``, and appends a
``GovernorDecision`` whenever the setting changes. Decisions are pure
functions of engine state, so a fleet run stays bit-reproducible from
``(spec, workload)`` — no wall clocks, no unseeded randomness.

This module must not import ``repro.core`` at module level
(``repro.core.energy`` imports ``repro.govern.telemetry``, so the
package inits would cycle); the frequency-grid default resolves lazily.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


def _default_grid() -> Tuple[float, ...]:
    from repro_torch.core.costs import DEFAULT_FREQ_GRID   # lazy: avoid cycle
    return DEFAULT_FREQ_GRID


@dataclass(frozen=True)
class GovernorDecision:
    """One frequency change: when, who, to what, and why."""
    t: float
    engine: str
    phi: float
    signal: str          # human-readable trigger, e.g. "outstanding=9216"


class Governor:
    """Base controller: subclasses implement ``decide(engine) -> phi``."""

    name = "base"
    # True only when decide() is constant over a steady-state decode run
    # (no dependence on queues/clock), so the coalescing fast stepper
    # may invoke on_step once per run instead of once per token-step.
    # Online controllers (queue-depth, slo-slack) read live signals every
    # step and MUST keep False: the fast path then bails to the exact
    # stepper whenever they are installed (DESIGN.md section 13).
    coalescible = False

    def __init__(self, grid: Optional[Sequence[float]] = None,
                 seed: int = 0):
        self.grid: Tuple[float, ...] = tuple(
            sorted(grid if grid is not None else _default_grid()))
        assert self.grid and all(p > 0 for p in self.grid), self.grid
        self.seed = seed                       # determinism bookkeeping
        self.decisions: List[GovernorDecision] = []

    # ------------------------------------------------------------------
    def on_step(self, engine) -> float:
        """Event-loop hook: retune ``engine.phi`` before a scheduler
        step. Records a decision only when the setting changes (the
        trace stays small on steady workloads)."""
        phi, signal = self.decide(engine)
        if phi != engine.phi:
            self.decisions.append(GovernorDecision(
                t=engine.t, engine=engine.name, phi=phi, signal=signal))
            engine.phi = phi
            tr = getattr(engine, "tracer", None)
            if tr is not None and tr.enabled:
                # same payload as the decision record — one schema, two
                # views (repro.obs.trace.event_from_governor_decision).
                # Sound under the fast stepper: only coalescible
                # governors coalesce, and _advance_engine invokes
                # on_step at the same clock the exact first step would
                tr.instant("governor", "phi", engine.t,
                           engine=engine.name, phi=phi, signal=signal)
        return phi

    def decide(self, engine) -> Tuple[float, str]:
        raise NotImplementedError


class StaticGovernor(Governor):
    """No-op controller reproducing the offline sweeps: the engine keeps
    the phi its ``FleetSpec`` configured (or ``phi`` when given). This
    is the default on every cluster, and with the spec's phi it is
    bit-identical to pre-governor behavior — the parity goldens in
    ``tests/test_fleet.py`` run through it."""

    name = "static"
    coalescible = True      # decide() ignores queues/clock: run-invariant

    def __init__(self, phi: Optional[float] = None, **kw):
        super().__init__(**kw)
        self.phi = phi

    def decide(self, engine):
        return (engine.phi if self.phi is None else self.phi, "static")


class QueueDepthGovernor(Governor):
    """Race-to-idle on backlog: map the engine's outstanding tokens
    linearly onto the frequency grid. An empty queue coasts at the grid
    floor; ``high_tokens`` of backlog (default: one full prefill token
    budget) runs flat out. The simplest load-following policy a serving
    stack actually ships — it needs no SLO knowledge at all."""

    name = "queue-depth"

    def __init__(self, low_tokens: int = 0,
                 high_tokens: Optional[int] = None, **kw):
        super().__init__(**kw)
        assert high_tokens is None or high_tokens > low_tokens >= 0
        self.low_tokens = low_tokens
        self.high_tokens = high_tokens    # None: the engine's budget

    def decide(self, engine):
        load = engine.outstanding_tokens()
        high = self.high_tokens if self.high_tokens is not None \
            else max(engine.budget, self.low_tokens + 1)
        frac = (load - self.low_tokens) / (high - self.low_tokens)
        frac = min(max(frac, 0.0), 1.0)
        idx = round(frac * (len(self.grid) - 1))
        return (self.grid[idx], f"outstanding={load}")


class SLOSlackGovernor(Governor):
    """DualScale-style: pick the LOWEST phi whose projected TTFT and
    TPOT keep every queued request inside ``safety`` x its SLO.

    Projections are first-order roofline estimates from the engine's own
    cost model — prefill throughput for a full-budget chunk, one decode
    step for the current running batch — deliberately ignoring transfer
    legs and cross-stage interleave; ``safety`` (< 1) absorbs that
    optimism. A request with no SLO target never constrains. When even
    the top of the grid cannot meet a projection the governor pins flat
    out (attainment first, energy second)."""

    name = "slo-slack"

    def __init__(self, safety: float = 0.7, **kw):
        super().__init__(**kw)
        assert 0.0 < safety <= 1.0
        self.safety = safety

    # -- projections ---------------------------------------------------
    def _tpot_ok(self, engine, phi: float) -> bool:
        batch = list(engine.running)
        if not batch or engine.role == "prefill":
            return True
        total_ctx = sum(s.ctx for s in batch)
        step = engine.cost.decode_cost(len(batch), total_ctx).time(phi)
        stall = 0.0
        if engine.role == "colocated":
            # prefill-priority interference (paper finding F2): queued
            # prefill work stalls every running sequence for the full
            # backlog drain before their next tokens come out
            backlog = sum(s.prefill_target - s.prefill_done
                          for s in engine.waiting + engine.prefilling)
            if backlog > 0:
                sched = getattr(engine, "scheduler", None)
                if sched is not None and sched.interleaves:
                    # chunked-interleave composer (repro.sched): decode
                    # shares EVERY step, so a running sequence stalls at
                    # most one chunk-bounded composed step — not the
                    # whole backlog drain. The governor sees scheduler
                    # state and prices interference accordingly.
                    stall = engine.cost.prefill_time_s(
                        min(backlog, sched.chunk_tokens), phi=phi,
                        chunk=sched.chunk_tokens)
                else:
                    stall = engine.cost.prefill_time_s(
                        backlog, phi=phi, chunk=engine.budget)
        for s in batch:
            target = s.req.slo.tpot_s if s.req.slo is not None else None
            if not target:
                continue
            # slack tracking, not open-loop projection: anchor each
            # sequence's final mean TPOT to the inter-token time it has
            # ALREADY accumulated (which contains every past stall —
            # including interference the governor never predicted), plus
            # the remaining steps at the candidate phi and the current
            # backlog stall. Sequences that have eaten their slack force
            # phi up; fresh sequences in quiet periods let it fall.
            intervals = max(s.req.output_len - 1, 1)
            spent = 0.0 if s.req.first_token_s is None \
                else engine.t - s.req.first_token_s
            owed = max(s.req.output_len - s.req.generated, 0)
            projected = (spent + owed * step + stall) / intervals
            if projected > self.safety * target:
                return False
        return True

    def _ttft_ok(self, engine, phi: float) -> bool:
        if engine.role == "decode":
            return True
        pending = sorted(engine.prefilling + engine.waiting,
                         key=lambda s: s.priority)
        if not pending:
            return True
        eta = engine.t                 # queued prefills run serialized
        for s in pending:
            eta += engine.cost.prefill_time_s(
                s.prefill_target - s.prefill_done, ctx_begin=s.prefill_done,
                phi=phi, chunk=engine.budget)
            target = s.req.slo.ttft_s if s.req.slo is not None else None
            if not target:
                continue
            if eta > s.req.arrival_s + self.safety * target:
                return False
        return True

    def decide(self, engine):
        for phi in self.grid:
            if self._tpot_ok(engine, phi) and self._ttft_ok(engine, phi):
                return (phi, f"lowest feasible of {len(self.grid)}")
        return (self.grid[-1], "no feasible phi: pinned to max")


GOVERNORS = {
    StaticGovernor.name: StaticGovernor,
    QueueDepthGovernor.name: QueueDepthGovernor,
    SLOSlackGovernor.name: SLOSlackGovernor,
}


def make_governor(name: str, **kw) -> Governor:
    """Build a fresh governor (controllers are stateful: one per
    engine). ``name`` is a registry key; kwargs go to the class."""
    try:
        cls = GOVERNORS[name]
    except KeyError:
        raise ValueError(f"unknown governor {name!r}; "
                         f"choose from {sorted(GOVERNORS)}") from None
    return cls(**kw)
