"""Cluster orchestration: the paper's five experimental setups.

  co-1gpu    one colocated accelerator, full batch (DistServe's baseline)
  co-2gpus   two colocated accelerators, batch split by the load-aware
             least-outstanding-tokens router (the paper's equal-resource
             baseline; the old static ``i % 2`` split ignored queue
             depth and inflated p99 TTFT on bursty arrivals)
  dis-ici    prefill acc + decode acc, KV over the interconnect (dis-gpu)
  dis-host   prefill acc + decode acc, KV staged in host DRAM  (dis-cpu)
  dis-disk   prefill acc + decode acc, KV staged on NVMe       (dis-disk)

``Cluster`` is a thin facade: each setup is the smallest possible
``repro.fleet`` fleet (1P:1D disaggregated, or 1-2 colocated), and the
discrete-event loop, transfer legs, and energy integration all live in
``FleetCluster`` (DESIGN.md section 10). Arbitrary xP:yD shapes go
through ``make_cluster`` / ``run_setup`` with a ``FleetSpec``.
"""
from __future__ import annotations

from typing import List, Optional, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.fleet.cluster import FleetCluster, SetupResult
from repro_torch.fleet.spec import DIS_PATH, SETUPS, FleetSpec, as_fleet_spec

from .request import Request

__all__ = ["SETUPS", "DIS_PATH", "SetupResult", "Cluster", "make_cluster",
           "run_setup"]


class Cluster(FleetCluster):
    """The five legacy setups as minimal fleets; same constructor
    signature and run() semantics as the pre-fleet orchestrator."""

    def __init__(self, setup: str, cfg: ModelConfig, *,
                 phi: float = 1.0, phi_prefill: Optional[float] = None,
                 phi_decode: Optional[float] = None, **kw):
        assert setup in SETUPS, setup
        super().__init__(FleetSpec.from_setup(setup), cfg, phi=phi,
                         phi_prefill=phi_prefill, phi_decode=phi_decode,
                         **kw)
        self.setup = setup      # report under the legacy name


# ----------------------------------------------------------------------
def make_cluster(setup: Union[str, FleetSpec], cfg: ModelConfig,
                 **kw) -> FleetCluster:
    """A cluster for a legacy setup name (reported under that name),
    a ``FleetSpec``, or a fleet-shape string like ``"2P2D-ici"``."""
    if isinstance(setup, str) and setup in SETUPS:
        return Cluster(setup, cfg, **kw)
    return FleetCluster(as_fleet_spec(setup), cfg, **kw)


def run_setup(setup: Union[str, FleetSpec], cfg: ModelConfig,
              requests: List[Request], *, stepper: Optional[str] = None,
              max_steps: int = 2_000_000, **kw) -> SetupResult:
    """Build and run a cluster. ``stepper`` picks the simulation core:
    "fast" (coalescing, the default), "exact" (reference event loop);
    None defers to ``repro.fleet.cluster.DEFAULT_STEPPER`` /
    ``REPRO_STEPPER``. Remaining kwargs go to the constructor."""
    return make_cluster(setup, cfg, **kw).run(requests, max_steps=max_steps,
                                              stepper=stepper)
