"""Open-loop workload subsystem: arrival processes, length mixes, SLO
goodput, and rate sweeps (DESIGN.md section 9).

This is the load axis of the paper's central caveat — "the performance
benefit of disaggregation is not guaranteed; it depends on the request
load and KV transfer mediums" — made executable: build a seed-
deterministic open-loop workload with ``WorkloadSpec``, serve it on any
of the five setups, score it with DistServe-style SLO goodput, and
locate the crossover load with ``crossover_rate`` / ``max_goodput_rate``.
"""
from .arrivals import (ArrivalProcess, DeterministicArrivals,
                       DiurnalArrivals, GammaArrivals, PoissonArrivals,
                       RampArrivals, make_arrivals)
from .goodput import (DEFAULT_INTERACTIVE_SLO, GoodputReport, evaluate,
                      max_goodput_rate)
from .lengths import (ChatbotLengths, LengthMix, MixtureLengths,
                      PaperFixedLengths, RAGSharedPrefixLengths, ReqShape,
                      ShareGPTLengths, make_lengths)
from .spec import WorkloadSpec, open_loop_workload
from .sweep import (Crossover, RatePoint, crossover_rate, goodput_gap,
                    rate_grid, run_rate_point)

__all__ = [
    "ArrivalProcess", "PoissonArrivals", "GammaArrivals", "RampArrivals",
    "DiurnalArrivals", "DeterministicArrivals", "make_arrivals",
    "LengthMix", "PaperFixedLengths", "ShareGPTLengths", "ChatbotLengths",
    "RAGSharedPrefixLengths", "MixtureLengths", "ReqShape", "make_lengths",
    "WorkloadSpec", "open_loop_workload",
    "DEFAULT_INTERACTIVE_SLO", "GoodputReport", "evaluate",
    "max_goodput_rate",
    "Crossover", "RatePoint", "run_rate_point", "rate_grid",
    "goodput_gap", "crossover_rate",
]
