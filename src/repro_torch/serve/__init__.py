"""Step builders (the port of ``repro.serve``)."""
from . import steps
from .steps import (StepBundle, build_decode_step, build_prefill_step,
                    build_step, build_train_step)

__all__ = ["steps", "StepBundle", "build_decode_step", "build_prefill_step",
           "build_step", "build_train_step"]
