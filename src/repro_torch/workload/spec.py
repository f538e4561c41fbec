"""WorkloadSpec: arrival process x length mix -> a concrete request list.

``build()`` is the single materialization point: same spec -> identical
``Request`` list (ids, arrival times, lengths, SLOs, and — in real mode
— token payloads). Requests are numbered in arrival order because the
engines use ``req_id`` as the FCFS priority key.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.request import Request, SLO

from .arrivals import ArrivalProcess
from .lengths import LengthMix

# distinct, fixed salts so the arrival / length / token streams are
# independent draws from one user-facing seed
_ARRIVAL_SALT, _LENGTH_SALT, _TOKEN_SALT = 0x5EED1, 0x5EED2, 0x5EED3


@dataclass(frozen=True)
class WorkloadSpec:
    """A reproducible open-loop workload.

    vocab_size > 0 additionally materializes real token ids (the
    bit-exact integration-test mode); requests from the same tenant
    sharing a ``prefix_len`` then share the identical token prefix, so
    the prefix cache sees real reuse.
    """
    arrivals: ArrivalProcess
    lengths: LengthMix
    n: int
    seed: int = 0
    slo: Optional[SLO] = None
    vocab_size: int = 0

    def build(self) -> List[Request]:
        times = self.arrivals.times(self.n, seed=self.seed + _ARRIVAL_SALT)
        shapes = self.lengths.sample(self.n, seed=self.seed + _LENGTH_SALT)
        rng = np.random.default_rng(self.seed + _TOKEN_SALT)
        prefixes = {}            # (tenant, prefix_len) -> shared tokens
        reqs: List[Request] = []
        for i, (t, shape) in enumerate(zip(times, shapes)):
            tokens = None
            if self.vocab_size > 0:
                tokens = rng.integers(0, self.vocab_size, shape.prompt_len)
                if shape.prefix_len > 0:
                    key = (shape.tenant, shape.prefix_len)
                    if key not in prefixes:
                        prefixes[key] = rng.integers(0, self.vocab_size,
                                                     shape.prefix_len)
                    tokens[:shape.prefix_len] = prefixes[key]
            slo = (dataclasses.replace(self.slo)
                   if self.slo is not None else SLO())
            reqs.append(Request(req_id=i, prompt_len=shape.prompt_len,
                                output_len=shape.output_len,
                                arrival_s=float(t), slo=slo,
                                prompt_tokens=tokens))
        return reqs

    @property
    def nominal_rate(self) -> float:
        return self.arrivals.nominal_rate


def open_loop_workload(rate: float, n: int, *,
                       lengths: Optional[LengthMix] = None,
                       arrival: str = "poisson",
                       slo: Optional[SLO] = None, seed: int = 0,
                       vocab_size: int = 0, **arrival_kw) -> List[Request]:
    """One-call convenience: Poisson (or named) arrivals at ``rate`` over
    the paper's fixed 16k/256 shape unless another mix is given.

    ``rate`` means the process's nominal rate; for the ramp (which has
    no single rate) it is the terminal ``rate1``, warming up from
    ``rate0 = rate/4`` over half the nominal schedule unless overridden
    via ``arrival_kw``."""
    from .arrivals import make_arrivals
    from .lengths import PaperFixedLengths
    if arrival == "ramp":
        arrival_kw.setdefault("rate1", rate)
        arrival_kw.setdefault("rate0", rate / 4.0)
        arrival_kw.setdefault("ramp_s", 0.5 * n / rate)
        proc = make_arrivals("ramp", **arrival_kw)
    else:
        proc = make_arrivals(arrival, rate=rate, **arrival_kw)
    mix = lengths if lengths is not None else PaperFixedLengths()
    return WorkloadSpec(arrivals=proc, lengths=mix, n=n, seed=seed,
                        slo=slo, vocab_size=vocab_size).build()
