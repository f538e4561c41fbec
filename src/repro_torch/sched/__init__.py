"""repro.sched: pluggable per-step batch composition + admission order.

DESIGN.md section 17. ``SchedulerSpec`` rides on ``FleetSpec.scheduler``
(None = the legacy serialize-prefill engine, byte-identical); the
chunked-interleave composer and the SJF/SRPT/prefix-aware admission
orders live in ``repro.core.engine``, priced by
``CostModel.mixed_step_cost``.
"""
from .spec import (ADMISSIONS, COMPOSERS, SchedulerSpec,
                   as_scheduler_spec)

__all__ = ["ADMISSIONS", "COMPOSERS", "SchedulerSpec",
           "as_scheduler_spec"]
