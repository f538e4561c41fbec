"""Energy governance subsystem: online DVFS governors, power-state
telemetry, and the machinery behind the energy-aware fleet control
experiments (DESIGN.md section 11).

The paper's energy story is measured offline (one phi per run,
integrated joules). ``repro.govern`` upgrades both halves to online
form: ``PowerTrace`` gives every component a sampled power timeline
with explicit idle/active states (the idle-energy floor becomes
plottable), and the ``Governor`` classes retune each engine's phi from
live signals inside the event loop — ``static`` (the offline sweeps),
``queue-depth`` (race-to-idle on backlog), ``slo-slack``
(DualScale-style: lowest phi that preserves SLO attainment).
``benchmarks/fig8_governor_pareto.py`` overlays the realized governor
points on the static Pareto frontier and reproduces the paper's
negative result against adaptive policies.

Import direction: ``repro.core.energy`` imports ``.telemetry``, so
nothing in this package may import ``repro.core`` at module level
(``.governors`` resolves its grid default lazily).
"""
from .governors import (GOVERNORS, Governor, GovernorDecision,
                        QueueDepthGovernor, SLOSlackGovernor,
                        StaticGovernor, make_governor)
from .telemetry import ABSENT, ACTIVE, IDLE, SLEEP, PowerSample, PowerTrace

__all__ = [
    "PowerTrace", "PowerSample", "ACTIVE", "IDLE", "SLEEP", "ABSENT",
    "Governor", "GovernorDecision", "StaticGovernor",
    "QueueDepthGovernor", "SLOSlackGovernor", "GOVERNORS",
    "make_governor",
]
