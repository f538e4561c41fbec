"""Per-request SLO-violation attribution and the per-setup blame table.

For each request that misses its TTFT or TPOT target, decompose the
*overrun* (measured − target) into named stage terms that sum exactly
to the overrun, so "why did this request violate" has a machine-checked
answer instead of a prose verdict.

TTFT decomposes along the request's derived lifecycle (see
``Tracer.derive_lifecycle``): ``queue`` / ``prefill`` for colocated
requests, plus ``transfer`` / ``decode-queue`` / ``fetch`` for
disaggregated ones. The segment durations already telescope to the
measured TTFT (shared boundary instants), so scaling each by
``overrun / ttft`` yields terms that sum to the overrun; a residual
correction on the largest term absorbs the last float ulp, keeping the
sum *exact* (the residual is 0.0, not merely within 1e-9).

TPOT decomposes by overlapping the decode engine's phase spans with the
request's decode interval ``[first_token, finish]``: time the engine
spent decoding (``decode``), prefilling other requests
(``prefill-interference``), fetching KV (``fetch-interference``), and
anything uncovered (``stall`` — queue/preemption dead time). Per-token
shares then scale to the overrun the same way.

``blame_table`` aggregates attributions per setup;
``transfer_queue_share`` is the scalar CI asserts for the fig6
narrative (below the crossover, dis violations are transfer+queue
dominated, not compute dominated).

Stdlib-only at import time; requests are duck-typed (``Request``
fields: arrival_s, first_token_s, finish_s, generated, ttft_s, tpot_s,
slo).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Attribution", "attribute_ttft", "attribute_tpot",
           "attribute_run", "blame_table", "transfer_queue_share",
           "TRANSFER_QUEUE_TERMS", "COMPUTE_TERMS"]

# Term families for the fig6 claim: a violation is "transfer+queue
# dominated" when these terms out-blame the compute terms.
TRANSFER_QUEUE_TERMS = ("queue", "transfer", "decode-queue", "fetch",
                        "fetch-interference", "stall")
COMPUTE_TERMS = ("prefill", "decode", "prefill-interference")


@dataclass
class Attribution:
    """One violating (request, metric) pair. ``terms`` maps stage name
    -> seconds of overrun blamed on it; values sum to ``overrun_s``
    exactly (enforced at construction)."""
    req_id: int
    metric: str                  # "ttft" | "tpot"
    measured_s: float
    target_s: float
    overrun_s: float
    terms: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        s = sum(self.terms.values())
        assert abs(s - self.overrun_s) <= 1e-9 * max(1.0, self.overrun_s), \
            (self.req_id, self.metric, s, self.overrun_s)

    def to_dict(self) -> Dict[str, Any]:
        return {"req_id": self.req_id, "metric": self.metric,
                "measured_s": self.measured_s, "target_s": self.target_s,
                "overrun_s": self.overrun_s, "terms": dict(self.terms)}


def _exact_scale(segments: Dict[str, float], total: float,
                 overrun: float) -> Dict[str, float]:
    """Scale non-negative ``segments`` (which sum ~total) by
    overrun/total, then absorb the float residual into the largest term
    so the returned terms sum to ``overrun`` exactly."""
    if total <= 0.0 or not segments:
        return {"stall": overrun} if overrun else {}
    f = overrun / total
    terms = {k: v * f for k, v in segments.items() if v > 0.0}
    if not terms:
        return {"stall": overrun} if overrun else {}
    big = max(terms, key=lambda k: terms[k])
    terms[big] += overrun - sum(terms.values())
    return terms


# ----------------------------------------------------------------------
def attribute_ttft(req, target_s: float,
                   lifecycle: Sequence[Tuple[str, float, float]]
                   ) -> Optional[Attribution]:
    """Attribute a TTFT overrun along the derived lifecycle (the spans
    before ``decode`` telescope from arrival to first token). Returns
    None when the request meets the target."""
    ttft = req.ttft_s
    if ttft is None or target_s is None or ttft <= target_s:
        return None
    overrun = ttft - target_s
    segments: Dict[str, float] = {}
    for stage, t0, t1 in lifecycle:
        if stage == "decode":
            continue
        segments[stage] = segments.get(stage, 0.0) + (t1 - t0)
    return Attribution(req_id=req.req_id, metric="ttft", measured_s=ttft,
                       target_s=target_s, overrun_s=overrun,
                       terms=_exact_scale(segments, sum(segments.values()),
                                          overrun))


_TPOT_TERM = {"decode": "decode", "prefill": "prefill-interference",
              # a chunked-interleave composed step (repro.sched) makes
              # token progress for every running sequence, so its span
              # is productive decode time, not interference — this is
              # what lets fig11 measure the blame-share shrink
              "mixed": "decode",
              "transfer-fetch": "fetch-interference",
              "tier-fetch": "fetch-interference"}


def attribute_tpot(req, target_s: float,
                   engine_spans: Sequence[Tuple[str, float, float, int]]
                   ) -> Optional[Attribution]:
    """Attribute a TPOT overrun by overlapping the decode engine's phase
    spans (``Tracer.coalesced(engine)`` rows) with the request's decode
    interval. Whatever the spans don't cover is ``stall``."""
    tpot = req.tpot_s
    if tpot is None or target_s is None or tpot <= target_s:
        return None
    overrun = tpot - target_s
    lo, hi = req.first_token_s, req.finish_s
    window = hi - lo
    segments: Dict[str, float] = {}
    covered = 0.0
    for name, t0, t1, _steps in engine_spans:
        o = min(t1, hi) - max(t0, lo)
        if o <= 0.0:
            continue
        term = _TPOT_TERM.get(name, "stall")
        segments[term] = segments.get(term, 0.0) + o
        covered += o
    if window - covered > 1e-12:
        segments["stall"] = segments.get("stall", 0.0) + (window - covered)
    return Attribution(req_id=req.req_id, metric="tpot", measured_s=tpot,
                       target_s=target_s, overrun_s=overrun,
                       terms=_exact_scale(segments, sum(segments.values()),
                                          overrun))


# ----------------------------------------------------------------------
def attribute_run(requests, slo, tracer) -> List[Attribution]:
    """All violating (request, metric) attributions for a traced run.
    ``slo`` needs ``ttft_s`` / ``tpot_s`` attributes (either may be
    None); ``tracer`` is the run's :class:`~repro.obs.trace.Tracer`."""
    lcs = tracer.lifecycle_events()
    coalesced_cache: Dict[str, List[Tuple[str, float, float, int]]] = {}
    out: List[Attribution] = []
    for req in requests:
        if getattr(slo, "ttft_s", None) is not None:
            a = attribute_ttft(req, slo.ttft_s,
                               tracer.derive_lifecycle(req.req_id))
            if a is not None:
                out.append(a)
        if getattr(slo, "tpot_s", None) is not None and req.tpot_s is not None:
            # the engine that emitted this request's first_token decodes it
            evs = lcs.get(req.req_id, {})
            ft = evs.get("first_token")
            engine = ft[0].args.get("engine") if ft else None
            if engine is not None:
                spans = coalesced_cache.get(engine)
                if spans is None:
                    spans = coalesced_cache[engine] = tracer.coalesced(engine)
                a = attribute_tpot(req, slo.tpot_s, spans)
                if a is not None:
                    out.append(a)
    return out


def blame_table(attrs: Sequence[Attribution]) -> Dict[str, Any]:
    """Aggregate attributions into a per-metric blame table:
    total overrun seconds per term, violation counts, and the
    transfer+queue share of total blame."""
    by_metric: Dict[str, Dict[str, float]] = {}
    counts: Dict[str, int] = {}
    for a in attrs:
        row = by_metric.setdefault(a.metric, {})
        counts[a.metric] = counts.get(a.metric, 0) + 1
        for term, v in a.terms.items():
            row[term] = row.get(term, 0.0) + v
    table = {}
    for metric, row in sorted(by_metric.items()):
        total = sum(row.values())
        table[metric] = {
            "violations": counts[metric],
            "total_overrun_s": total,
            "terms": {k: row[k] for k in sorted(row)},
            "transfer_queue_share": (
                sum(v for k, v in row.items()
                    if k in TRANSFER_QUEUE_TERMS) / total if total else 0.0),
        }
    return {"metrics": table, "violations": len(attrs)}


def transfer_queue_share(table: Dict[str, Any]) -> Optional[float]:
    """Overall transfer+queue blame share across all metrics of a
    :func:`blame_table` result (None when there are no violations)."""
    rows = table.get("metrics", {})
    total = sum(r["total_overrun_s"] for r in rows.values())
    if not total:
        return None
    tq = sum(r["total_overrun_s"] * r["transfer_queue_share"]
             for r in rows.values())
    return tq / total
