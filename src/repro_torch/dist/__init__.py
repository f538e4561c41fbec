"""Distribution subsystem, the port of ``repro.dist``.

So far only ``fault``: atomic checkpoints and the straggler watchdog of
the training path. ``sharding``, ``collectives``, ``opt_flags`` and
``hlo_analysis`` come with the multi-card slice.
"""
from . import fault

__all__ = ["fault"]
