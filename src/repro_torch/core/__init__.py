"""The paper's subject: disaggregated LLM serving — engines, paged KV pool,
KV transfer paths, DVFS energy model, and the co/dis experiment setups."""
from . import (costs, dvfs, energy, engine, kvcache, orchestrator,
               prefix_cache, request, transfer)
from .costs import AcceleratorSpec, ChipSpec, CostModel, HostSpec, \
    DEFAULT_FREQ_GRID
from .energy import EnergyMeter, ParetoPoint, pareto_frontier, \
    min_energy_under_slo, sweet_spot
from .engine import Engine, RealExecutor
from .kvcache import DevicePagedKV, OutOfPages, PagedKVPool
from .orchestrator import SETUPS, Cluster, SetupResult, make_cluster, \
    run_setup
from .prefix_cache import PrefixCache, ReuseResult
from .request import Request, SLO, WorkloadMetrics, meets_slo, \
    random_workload, summarize
from .transfer import DiskPath, HostPath, ICIPath, TransferPath, make_path
from .dvfs import FrequencySweep, best_total_energy, sweep_frequencies

__all__ = [
    "AcceleratorSpec", "ChipSpec", "CostModel", "HostSpec",
    "DEFAULT_FREQ_GRID", "EnergyMeter", "ParetoPoint", "pareto_frontier",
    "min_energy_under_slo", "sweet_spot", "Engine", "RealExecutor",
    "DevicePagedKV", "OutOfPages", "PagedKVPool", "SETUPS", "Cluster",
    "SetupResult", "run_setup", "make_cluster", "PrefixCache",
    "ReuseResult", "Request",
    "SLO", "WorkloadMetrics", "meets_slo", "random_workload", "summarize",
    "DiskPath",
    "HostPath", "ICIPath", "TransferPath", "make_path",
    "FrequencySweep", "best_total_energy", "sweep_frequencies",
]
