"""repro_torch.exp — the declarative Experiment API (DESIGN.md section 12).

One spine for the paper's whole benchmark matrix: describe a cell as a
frozen ``Experiment`` (arch x fleet x workload x SLO x reuse), expand
axes with ``Grid``, and execute through ``run`` / ``run_grid`` — which
memoize through a content-addressed on-disk cache keyed by
``spec_hash x SCHEMA_VERSION`` and fan cache misses out over a process
pool. The sweeps in ``repro_torch.workload`` /
``repro_torch.core.dvfs`` and ``launch.serve`` route through here; new
media, governors, and workloads extend the spec instead of adding
another entrypoint. The result cache has a root of its own
(``default_cache_root``), apart from the reference package's.
"""
from .cache import CacheStats, ResultCache, default_cache_root
from .grid import Grid
from .record import (EnergyView, RunRecord, SCHEMA_VERSION,
                     decode_side_j, prefill_side_j)
from .runner import (default_cache, run, run_grid, set_default_cache,
                     sim_count, simulate, uncached_sim_count)
from .spec import (ClosedLoop, Experiment, OpenLoop, ReuseSpec, TierSpec,
                   apply_spec_knobs, as_cacheable, registered_arch)

__all__ = [
    "Experiment", "ClosedLoop", "OpenLoop", "ReuseSpec", "TierSpec",
    "Grid",
    "RunRecord", "EnergyView", "SCHEMA_VERSION",
    "prefill_side_j", "decode_side_j",
    "ResultCache", "CacheStats", "default_cache_root",
    "run", "run_grid", "simulate", "default_cache", "set_default_cache",
    "sim_count", "uncached_sim_count",
    "registered_arch", "apply_spec_knobs", "as_cacheable",
]
