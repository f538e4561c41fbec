"""Online fleet controllers: autoscaling, P<->D role-flipping, and
scale-to-zero (DESIGN.md section 14).

fig8 proved the paper's negative energy verdict for
disaggregation is an *idle-power floor* — static fleets pay
``p_static_w`` on every provisioned accelerator for the whole run, and
no per-step DVFS policy can reach below it. The counter-moves all
require changing the fleet itself while it serves: put idle instances
into a deep-sleep state (``p_sleep_w`` residual draw, wake costs
latency), wake them against backlog, and flip a surplus instance's
prefill<->decode role as the goodput-optimal P:D ratio drifts with the
length mix (P/D-Serve's at-scale dynamic ratio adjustment, DualScale's
phase-aware placement — PAPERS.md).

The hook contract mirrors ``govern.Governor.on_step``: a controller is
a pure, seed-deterministic object the cluster calls at fixed simulated
intervals (``on_tick(cluster, t)``), acting only through the cluster's
lifecycle primitives (``ctl_wake`` / ``ctl_sleep`` / ``ctl_drain`` /
``ctl_flip_asleep``).  Determinism matters twice over: a fleet run must
be reproducible from ``(spec, workload)`` alone, and the differential
parity harness re-runs the same spec through both steppers.  A
controller whose actions depend on anything but cluster state at tick
time would break both.

Stepper interaction (the bail rule): the coalescing fast stepper
advances engines through vectorized decode runs *between* events, which
is only valid if nothing can change fleet state inside a window.  Tick
events bound every window, so a controller that never acts outside its
tick handler is safe — but conservatively, ``FleetCluster.run`` bails
to the exact stepper unless the controller declares itself
``coalescible`` (only the no-op ``NullController`` does).  Parity
between steppers therefore holds trivially for active controllers and
is fuzz-verified for the null one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np


@dataclass(frozen=True)
class ControllerSpec:
    """Frozen, hashable controller configuration.

    Lives on ``FleetSpec.controller`` so the ``repro.exp``
    content-addressed cache keys on it like every other knob; every
    field is a scalar so the canonical-JSON spec hash stays trivial.
    ``policy`` names a class in ``CONTROLLERS``; the remaining fields
    parameterize whichever policy is chosen (unused ones are inert but
    still hash — two specs differing only in an inert field re-run,
    which is correct-if-conservative).
    """
    policy: str = "adaptive"
    # simulated seconds between on_tick invocations
    interval_s: float = 0.25
    # latency (not extra energy beyond idle draw) to wake a sleeping or
    # absent instance; the honest cost of scale-to-zero
    wake_latency_s: float = 0.5
    # idle dwell before the adaptive policy deep-sleeps an instance
    sleep_after_s: float = 1.0
    # never sleep below these awake floors (0 = true scale-to-zero)
    min_awake_prefill: int = 0
    min_awake_decode: int = 0
    # instances awake at t=0; -1 = all. The rest start ABSENT (never
    # provisioned) — they are woken on demand and their pre-wake window
    # is attributed at 0 W, not back-filled idle joules.
    initial_awake_prefill: int = -1
    initial_awake_decode: int = -1
    allow_flip: bool = True
    allow_sleep: bool = True
    # decode backlog per awake decode instance that triggers a wake
    wake_backlog_tokens: int = 4096
    # prefill backlog is judged against this TTFT budget (projected
    # queue delay > slo_safety * target_ttft_s wakes an instance)
    target_ttft_s: float = 2.0
    slo_safety: float = 0.7

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
        if self.wake_latency_s < 0 or self.sleep_after_s < 0:
            raise ValueError("wake_latency_s / sleep_after_s must be >= 0")


def as_controller_spec(
        value: Union[str, dict, ControllerSpec, None]
) -> Optional[ControllerSpec]:
    """Normalize the accepted ``FleetSpec.controller`` forms: a policy
    name, a kwargs dict (how decoded experiment specs arrive), a spec,
    or None."""
    if value is None or isinstance(value, ControllerSpec):
        return value
    if isinstance(value, str):
        return ControllerSpec(policy=value)
    if isinstance(value, dict):
        return ControllerSpec(**value)
    raise TypeError(f"cannot interpret controller spec {value!r}")


# ----------------------------------------------------------------------
class FleetController:
    """Base: ``on_tick(cluster, t)`` acts through the cluster's
    lifecycle primitives. Stateful (idle-dwell tracking, rng), so build
    a fresh instance per cluster (``make_controller``)."""

    name = "base"
    # a coalescible controller guarantees it never changes fleet state
    # (the fast stepper may coalesce across its ticks); anything that
    # can sleep/wake/flip must leave this False so runs bail to exact
    coalescible = False
    # whether the cluster should schedule periodic tick events at all
    wants_ticks = True

    def __init__(self, spec: ControllerSpec, seed: int = 0):
        self.spec = spec
        self.rng = np.random.default_rng(seed)

    def on_tick(self, cluster, t: float) -> None:
        raise NotImplementedError


class NullController(FleetController):
    """The static-equivalent no-op: never sleeps, wakes, or flips.
    Exists so the test layer can prove plumbing a controller through
    the cluster leaves every golden bit-identical (routers see the same
    candidate lists, the fast stepper stays engaged)."""

    name = "null"
    coalescible = True
    wants_ticks = False

    def on_tick(self, cluster, t):
        pass


class AdaptiveController(FleetController):
    """Backlog/SLO-slack-driven autoscaling + role-flipping +
    scale-to-zero — the policy fig9 sweeps.

    Per tick, in order:
      sleep  an awake instance idle for >= ``sleep_after_s`` (pool
             empty, nothing in flight, awake floor respected);
      wake   a sleeping/absent prefill instance when the projected
             prefill queue delay exceeds the TTFT budget, or a decode
             one when per-instance decode backlog exceeds
             ``wake_backlog_tokens``;
      flip   when the awake P:D split deviates >= 1 instance from the
             work-optimal ratio (remaining prefill vs decode tokens
             weighted by roofline per-token times): repurpose a
             sleeping surplus-role instance in place if one exists,
             else drain the least-loaded awake one (at most one
             drain-to-flip in flight).
    """

    name = "adaptive"

    def __init__(self, spec, seed=0):
        super().__init__(spec, seed)
        self._idle_since = {}          # engine name -> first-idle tick t
        self._rates = None             # (s/token prefill, s/token decode)

    # -- roofline per-token times, cached once per run ------------------
    def _per_token_s(self, cluster):
        if self._rates is None:
            cost = cluster.cost
            cp = 1.0 / cost.prefill_rate_tok_s(1.0)
            # nominal steady decode batch of 8 at 1k context each
            cd = cost.decode_cost(8, 8 * 1024).time(1.0) / 8.0
            self._rates = (cp, cd)
        return self._rates

    @staticmethod
    def _engine_idle(e) -> bool:
        return e._quiescent() and not e.pool.seqs \
            and not getattr(e, "inflight_kv_pages", 0)

    def on_tick(self, cluster, t):
        spec = self.spec
        colo = cluster.spec.is_colocated
        state = cluster.lifecycle_state
        awake = [e for e in cluster.engines
                 if state(e) == "on" and e not in cluster._draining]
        asleep = [e for e in cluster.engines
                  if state(e) in ("sleep", "absent")]

        def role_of(e):
            return "prefill" if colo or e.role != "decode" else "decode"

        # backlogs in tokens (parked work counts toward its stage)
        back_p = sum(r.prompt_len for r in cluster._parked_requests)
        back_d = sum(s.req.output_len - s.req.generated
                     for _, s, _ in cluster._parked_transfers)
        for e in cluster.engines:
            if role_of(e) == "prefill":
                back_p += e.outstanding_tokens()
            else:
                back_d += e.outstanding_tokens()

        # ---- sleep: idle-dwell tracked per instance -------------------
        if spec.allow_sleep:
            floors = {"prefill": spec.min_awake_prefill,
                      "decode": spec.min_awake_decode}
            n_awake = {"prefill": sum(role_of(e) == "prefill"
                                      for e in awake),
                       "decode": sum(role_of(e) == "decode"
                                     for e in awake)}
            parked = {"prefill": bool(cluster._parked_requests),
                      "decode": bool(cluster._parked_transfers)}
            for e in awake:
                if not self._engine_idle(e):
                    self._idle_since.pop(e.name, None)
                    continue
                since = self._idle_since.setdefault(e.name, t)
                role = role_of(e)
                if (t - since >= spec.sleep_after_s
                        and n_awake[role] > floors[role]
                        and not parked[role]):
                    if cluster.ctl_sleep(e, t):
                        n_awake[role] -= 1
                        self._idle_since.pop(e.name, None)

        # ---- wake against backlog / SLO slack -------------------------
        cp, cd = self._per_token_s(cluster)
        awake_p = [e for e in awake if role_of(e) == "prefill"
                   and e not in cluster._draining]
        awake_d = [e for e in awake if role_of(e) == "decode"
                   and e not in cluster._draining]
        budget_s = spec.slo_safety * spec.target_ttft_s
        if back_p > 0 and (not awake_p
                           or back_p * cp / len(awake_p) > budget_s):
            for e in asleep:
                if role_of(e) == "prefill":
                    cluster.ctl_wake(e, t)
                    break
        if back_d > 0 and not colo and (
                not awake_d
                or back_d / len(awake_d) > spec.wake_backlog_tokens):
            for e in asleep:
                if role_of(e) == "decode":
                    cluster.ctl_wake(e, t)
                    break

        # ---- flip toward the work-optimal awake P:D split -------------
        if colo or not spec.allow_flip:
            return
        if any(f == "flip" for f in cluster._draining.values()):
            return                      # at most one drain-to-flip
        n = len(awake_p) + len(awake_d)
        if n < 2 or (back_p <= 0 and back_d <= 0):
            return
        wp, wd = back_p * cp, back_d * cd
        if wp + wd <= 0:
            return
        target_p = round(n * wp / (wp + wd))
        target_p = min(max(target_p, 1 if back_p > 0 else 0), n - 1)
        surplus_role, = (["prefill"] if len(awake_p) - target_p >= 1 else
                         ["decode"] if target_p - len(awake_p) >= 1 else
                         [None])
        if surplus_role is None:
            return
        # repurpose a sleeping surplus-role instance for free if any
        for e in asleep:
            if role_of(e) == surplus_role:
                if cluster.ctl_flip_asleep(e, t):
                    cluster.ctl_wake(e, t)
                    return
        pool = awake_p if surplus_role == "prefill" else awake_d
        if len(pool) < 2:
            return                      # never drain the last instance
        victim = min(pool, key=lambda e: (e.outstanding_tokens(), e.gidx))
        cluster.ctl_drain(victim, t, then="flip")


class ScheduleController(FleetController):
    """Seeded random scale/flip/sleep schedule — not a serving policy
    but the adversary the fleet-invariant property tests run under: any
    action sequence it emits must preserve exactly-once completion,
    routing/lifecycle invariants, and power-trace coverage."""

    name = "schedule"

    def on_tick(self, cluster, t):
        state = cluster.lifecycle_state
        r = float(self.rng.random())
        if r < 0.30:
            cands = [e for e in cluster.engines
                     if state(e) in ("sleep", "absent")]
            if cands:
                cluster.ctl_wake(self._choose(cands), t)
        elif r < 0.55:
            cands = [e for e in cluster.engines
                     if state(e) == "on" and e.accepting
                     and e not in cluster._draining]
            if cands:
                cluster.ctl_drain(self._choose(cands), t, then="sleep")
        elif r < 0.75 and not cluster.spec.is_colocated:
            cands = [e for e in cluster.engines
                     if state(e) == "on" and e.accepting
                     and e not in cluster._draining]
            if cands:
                cluster.ctl_drain(self._choose(cands), t, then="flip")
        elif r < 0.85 and not cluster.spec.is_colocated:
            cands = [e for e in cluster.engines
                     if state(e) in ("sleep", "absent")]
            if cands:
                e = self._choose(cands)
                if cluster.ctl_flip_asleep(e, t):
                    cluster.ctl_wake(e, t)
        # else: no-op tick

    def _choose(self, cands):
        return cands[int(self.rng.integers(len(cands)))]


CONTROLLERS = {
    NullController.name: NullController,
    AdaptiveController.name: AdaptiveController,
    ScheduleController.name: ScheduleController,
}


def make_controller(spec: Union[str, dict, ControllerSpec],
                    seed: int = 0) -> FleetController:
    spec = as_controller_spec(spec)
    try:
        cls = CONTROLLERS[spec.policy]
    except KeyError:
        raise ValueError(f"unknown controller policy {spec.policy!r}; "
                         f"choose from {sorted(CONTROLLERS)}") from None
    return cls(spec, seed=seed)
