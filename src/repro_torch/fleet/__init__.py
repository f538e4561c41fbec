"""Fleet-scale serving: xP:yD instance pools with load-aware KV routing
(DESIGN.md section 10).

The paper's five setups generalized to arbitrary fleet shapes — build a
``FleetSpec`` (x prefill : y decode over one KV medium, or n colocated),
serve any workload on a ``FleetCluster``, and let the pluggable
``Router`` policies balance requests and KV transfers across the pool.
The legacy ``Cluster`` is a 1-2 instance facade over this subsystem.
"""
# Fully initialize repro.core before touching .cluster: core's own init
# imports this package (orchestrator subclasses FleetCluster), and
# entering the cycle via .cluster would leave it partially initialized.
# core <-> fleet imports therefore always use the submodule form
# (repro.fleet.spec / repro.fleet.cluster), never the package.
import repro_torch.core  # noqa: F401  (import-order side effect only)

from .cluster import FleetCluster, SetupResult
from .controller import (CONTROLLERS, AdaptiveController, ControllerSpec,
                         FleetController, NullController,
                         ScheduleController, as_controller_spec,
                         make_controller)
from .router import (KVFreeSpace, LeastOutstandingTokens, MinEnergy,
                     POLICIES, Policy, PrefixAffinity, RoundRobin,
                     Router, make_policy)
from .spec import (DIS_PATH, MEDIA, SETUPS, FleetSpec, as_fleet_spec,
                   setup_label)

__all__ = [
    "FleetCluster", "SetupResult",
    "Router", "Policy", "RoundRobin", "LeastOutstandingTokens",
    "KVFreeSpace", "MinEnergy", "PrefixAffinity", "POLICIES",
    "make_policy",
    "FleetSpec", "as_fleet_spec", "setup_label",
    "SETUPS", "DIS_PATH", "MEDIA",
    "ControllerSpec", "FleetController", "NullController",
    "AdaptiveController", "ScheduleController", "CONTROLLERS",
    "as_controller_spec", "make_controller",
]
