"""Distribution subsystem, the port of ``repro.dist``.

  fault      atomic checkpoints and the straggler watchdog of the
             training path
  opt_flags  the registry of output-preserving perf flags (``REPRO_OPT``)
  sharding   placement rules for params, batches, decode state and
             optimizer moments on a ``DeviceMesh`` or an abstract mesh

``collectives`` and ``hlo_analysis`` are not ported yet (ROADMAP,
queue 1).
"""
from . import fault, opt_flags, sharding

__all__ = ["fault", "opt_flags", "sharding"]
