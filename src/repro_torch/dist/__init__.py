"""Distribution subsystem, the port of ``repro.dist``.

  collectives   ring pass, ring all-gather, halo exchange, bucketed and
                int8-compressed gradient sums on ``torch.distributed``
  fault         atomic checkpoints and the straggler watchdog of the
                training path
  hlo_analysis  one device's flops, bytes and collectives from a run of
                the step on fake DTensors, and the three-term roofline
  opt_flags     the registry of output-preserving perf flags
                (``REPRO_OPT``)
  sharding      placement rules for params, batches, decode state and
                optimizer moments on a ``DeviceMesh`` or an abstract mesh
"""
from . import collectives, fault, hlo_analysis, opt_flags, sharding

__all__ = ["collectives", "fault", "hlo_analysis", "opt_flags", "sharding"]
