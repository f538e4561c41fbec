"""Requests, per-request metrics, and the paper's synthetic workload.

``random_workload`` mirrors the paper's RandomDataset setup (section
IV-D): fixed input length 16,384, output length 256, batch size swept
2..64, request rate infinite (all requests submitted at t=0). Finite-
rate open-loop workloads — arrival processes, length mixes, SLO goodput
— live in ``repro.workload`` (DESIGN.md section 9); ``Request.arrival_s``
is honored by the orchestrator event heap, so a request is never served
before it arrives and TTFT is always >= 0.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SLO:
    ttft_s: Optional[float] = None   # time-to-first-token target
    tpot_s: Optional[float] = None   # time-per-output-token target


@dataclass(eq=False)
class Request:
    req_id: int
    prompt_len: int
    output_len: int
    arrival_s: float = 0.0
    slo: SLO = field(default_factory=SLO)
    # real-mode payload (tiny models in integration tests): actual token ids
    prompt_tokens: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # lifecycle bookkeeping (filled in by the engines)
    # ------------------------------------------------------------------
    prefill_start_s: Optional[float] = None
    prefill_done_s: Optional[float] = None
    transfer_done_s: Optional[float] = None
    first_token_s: Optional[float] = None      # first decode-step output
    finish_s: Optional[float] = None
    decode_start_s: Optional[float] = None     # first decode step time
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)
    # recompute accounting (the paper's eviction cliff mechanism)
    evictions: int = 0
    recomputed_tokens: int = 0
    # KV reuse (paper section II-C): prefill tokens skipped via cache hits
    reused_tokens: int = 0

    # ------------------------------------------------------------------
    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean inter-token time once decoding has begun (paper's TPOT).

        ``None`` when fewer than two tokens were generated: a
        single-token request has no inter-token interval, and a 0.0
        placeholder would drag median/p99 TPOT toward zero (``summarize``
        excludes these requests from the TPOT percentiles)."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        n = self.generated
        if n <= 1:
            return None
        return (self.finish_s - self.first_token_s) / (n - 1)

    @property
    def queue_s(self) -> Optional[float]:
        """Arrival -> first prefill scheduling (open-loop queueing delay)."""
        if self.prefill_start_s is None:
            return None
        return self.prefill_start_s - self.arrival_s

    @property
    def done(self) -> bool:
        return self.finish_s is not None


def meets_slo(req: Request, slo: Optional[SLO] = None) -> bool:
    """DistServe-style attainment: BOTH targets must hold (a request with
    no decode phase — ``tpot_s is None`` — is judged on TTFT alone).
    ``slo`` overrides the request's own SLO; absent targets pass."""
    s = slo if slo is not None else req.slo
    if s is None:
        return True
    if s.ttft_s is not None:
        if req.ttft_s is None or req.ttft_s > s.ttft_s:
            return False
    if s.tpot_s is not None and req.tpot_s is not None \
            and req.tpot_s > s.tpot_s:
        return False
    return True


def goodput_stats(reqs: List["Request"],
                  slo: Optional[SLO] = None) -> Tuple[int, float, float]:
    """The single source of the goodput arithmetic, shared by
    ``summarize`` and ``repro.workload.goodput.evaluate``:
    (attained count, duration first-arrival->last-finish, observed
    offered rate — inf for a t=0 batch)."""
    attained = sum(1 for r in reqs if meets_slo(r, slo))
    t0 = min(r.arrival_s for r in reqs)
    duration = max(r.finish_s for r in reqs) - t0
    span = max(r.arrival_s for r in reqs) - t0
    offered = (len(reqs) - 1) / span if span > 0 else float("inf")
    return attained, duration, offered


def random_workload(batch_size: int, *, input_len: int = 16_384,
                    output_len: int = 256, vocab_size: int = 0,
                    seed: int = 0, arrival_s: float = 0.0,
                    shared_prefix_len: int = 0) -> List[Request]:
    """The paper's RandomDataset: ``batch_size`` requests at t=0.

    ``shared_prefix_len`` > 0 gives every request an identical prefix
    (the KV-reuse / RAG scenario of section II-C).
    """
    rng = np.random.default_rng(seed)
    prefix = None
    if shared_prefix_len and vocab_size:
        prefix = rng.integers(0, vocab_size, shared_prefix_len)
    reqs = []
    for i in range(batch_size):
        tokens = None
        if vocab_size:
            tokens = rng.integers(0, vocab_size, input_len)
            if prefix is not None:
                tokens[:shared_prefix_len] = prefix
        reqs.append(Request(req_id=i, prompt_len=input_len,
                            output_len=output_len, arrival_s=arrival_s,
                            prompt_tokens=tokens))
    return reqs


# ----------------------------------------------------------------------
# aggregate metrics over a finished workload
# ----------------------------------------------------------------------
@dataclass
class WorkloadMetrics:
    median_ttft_s: float
    p99_ttft_s: float
    median_tpot_s: float
    p99_tpot_s: float
    prefill_throughput_tok_s: float
    decode_throughput_tok_s: float
    makespan_s: float
    total_evictions: int
    total_recomputed_tokens: int
    # prefill tokens skipped via KV-reuse cache hits (section II-C)
    total_reused_tokens: int = 0
    # open-loop / goodput view (DESIGN.md section 9)
    num_requests: int = 0
    offered_rps: float = float("inf")   # observed arrival rate; inf at t=0
    median_queue_s: float = 0.0         # arrival -> prefill scheduling
    slo_attainment: float = 1.0         # fraction meeting their own SLO
    goodput_rps: float = 0.0            # attained requests / makespan


def summarize(reqs: List[Request]) -> WorkloadMetrics:
    assert all(r.done for r in reqs), "workload not finished"
    ttfts = np.array([r.ttft_s for r in reqs], dtype=np.float64)
    # single-token requests have no inter-token interval: excluded
    tpots = np.array([r.tpot_s for r in reqs if r.tpot_s is not None],
                     dtype=np.float64)
    queues = np.array([r.queue_s for r in reqs if r.queue_s is not None],
                      dtype=np.float64)
    t0 = min(r.arrival_s for r in reqs)
    prefill_end = max(r.prefill_done_s for r in reqs)
    prefill_tokens = sum(r.prompt_len + r.recomputed_tokens
                         - r.reused_tokens for r in reqs)
    decode_tokens = sum(r.generated for r in reqs)
    # goodput_stats' duration IS the makespan (first arrival->last finish)
    attained, makespan, offered = goodput_stats(reqs)
    return WorkloadMetrics(
        median_ttft_s=float(np.median(ttfts)),
        p99_ttft_s=float(np.percentile(ttfts, 99)),
        median_tpot_s=float(np.median(tpots)) if tpots.size else 0.0,
        p99_tpot_s=float(np.percentile(tpots, 99)) if tpots.size else 0.0,
        prefill_throughput_tok_s=prefill_tokens / max(prefill_end - t0, 1e-9),
        decode_throughput_tok_s=decode_tokens / max(makespan, 1e-9),
        makespan_s=float(makespan),
        total_evictions=sum(r.evictions for r in reqs),
        total_recomputed_tokens=sum(r.recomputed_tokens for r in reqs),
        total_reused_tokens=sum(r.reused_tokens for r in reqs),
        num_requests=len(reqs),
        offered_rps=offered,
        median_queue_s=float(np.median(queues)) if queues.size else 0.0,
        slo_attainment=attained / len(reqs),
        goodput_rps=attained / max(makespan, 1e-9),
    )
