"""SchedulerSpec: the per-step batch-composition policy of an engine.

Until this module existed the composition decision was hard-coded in
``Engine.step``: serialize whole prefills ahead of decode (prefill
priority), admit FCFS by req_id. That is the *weakest* colocation the
paper's headline claim can be measured against — DistServe frames
disaggregation's win as eliminating prefill/decode interference, and
Sarathi-Serve showed chunked-prefill interleaving removes most of that
interference without splitting the hardware. ``SchedulerSpec`` makes
the decision a frozen, hashable, spec-addressable value object on
``FleetSpec.scheduler`` with two pluggable layers:

  * **step composer** — ``serial`` (the legacy behavior, bit-for-bit)
    or ``chunked-interleave`` (each step packs the running decode batch
    plus up to ``chunk_tokens`` of chunked prefill; priced exactly via
    ``CostModel.mixed_step_cost``). The interleaved composer is
    *stall-free*: every composed step emits one token per running
    sequence, so the worst decode inter-token gap is a single
    chunk-bounded step instead of a whole prefill-backlog drain.
  * **admission order** — ``fcfs`` (legacy req_id order), ``sjf``
    (shortest predicted total job first), ``srpt`` (shortest predicted
    *remaining* work first, recomputed at every waiting-queue insert so
    preempted sequences re-sort by what is actually left), or
    ``prefix-aware`` (consults the engine's TieredKVStore / PrefixCache
    ``peek_match`` so cached-prefix requests jump the queue). Every
    non-FCFS key ends in ``req_id``, so ties break deterministically —
    two runs of the same spec produce the same order, always.

``None`` on ``FleetSpec.scheduler`` is the legacy engine, byte-for-byte
(spec encodings omit the key, so every pre-scheduler exp-cache hash is
preserved). Only the ``serial`` + ``fcfs`` spec is ``coalescible``: any
other composer/admission changes per-step decisions in ways the
coalescing fast stepper cannot vectorize, so those runs bail to the
exact stepper (the bail rule pinned by ``benchmarks/BENCH_simcore.json``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

__all__ = ["COMPOSERS", "ADMISSIONS", "SchedulerSpec",
           "as_scheduler_spec"]

COMPOSERS = ("serial", "chunked-interleave")
ADMISSIONS = ("fcfs", "sjf", "srpt", "prefix-aware")


@dataclass(frozen=True)
class SchedulerSpec:
    """One engine scheduling policy: step composer x admission order."""
    composer: str = "serial"
    admission: str = "fcfs"
    # composed-step token budget of the chunked-interleave composer:
    # each step spends one token per running decode sequence and packs
    # prefill chunks into the remainder. Small values bound the decode
    # stall per step (TPOT); large values amortize the per-step weight
    # stream (TTFT). Ignored by the serial composer.
    chunk_tokens: int = 1024

    def __post_init__(self):
        if self.composer not in COMPOSERS:
            raise ValueError(f"unknown composer {self.composer!r}; "
                             f"choose from {COMPOSERS}")
        if self.admission not in ADMISSIONS:
            raise ValueError(f"unknown admission {self.admission!r}; "
                             f"choose from {ADMISSIONS}")
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}")

    # ------------------------------------------------------------------
    @property
    def interleaves(self) -> bool:
        return self.composer == "chunked-interleave"

    @property
    def coalescible(self) -> bool:
        """True only for the legacy-equivalent policy: the coalescing
        fast stepper may vectorize steady-state decode. Chunked
        interleave changes step composition mid-run and non-FCFS
        admission reorders the waiting queue on every insert — both
        invalidate the uniform-run precondition, so such runs take the
        exact stepper (tests/test_fastpath_parity.py fuzzes this axis;
        the perf lane pins the ratio near 1.0)."""
        return self.composer == "serial" and self.admission == "fcfs"

    # ------------------------------------------------------------------
    def admission_key(self, seq, engine) -> Optional[Tuple[int, ...]]:
        """The waiting-queue sort key for ``seq`` on ``engine``, or None
        for FCFS (the engine then keeps its legacy int req_id priority —
        bit-identical ordering AND representation). Recomputed at every
        ``_enqueue_waiting`` so a preempted-and-requeued sequence sorts
        by its live remaining work. Lower sorts earlier; the trailing
        req_id makes every ordering a deterministic total order."""
        if self.admission == "fcfs":
            return None
        req = seq.req
        rid = req.req_id
        if self.admission == "sjf":
            # shortest predicted total job: prompt + full output budget
            return (req.prompt_len + req.output_len, rid)
        remaining = (seq.prefill_target - seq.prefill_done) \
            + (req.output_len - req.generated)
        if self.admission == "srpt":
            return (remaining, rid)
        # prefix-aware: requests whose prompt prefix is already resident
        # in the engine's KV reuse layer jump the queue (their prefill
        # is mostly free, so serving them first is SRPT on *actual*
        # remaining compute). Without a reuse layer every match is 0 and
        # the order degrades to SRPT — documented, deterministic.
        matched = 0
        store = engine.kv_store if engine.kv_store is not None \
            else engine.prefix_cache
        if store is not None and req.prompt_tokens is not None:
            matched = store.peek_match(req.prompt_tokens)
        return (-matched, remaining, rid)


def as_scheduler_spec(value: Union[None, str, dict, SchedulerSpec]
                      ) -> Optional[SchedulerSpec]:
    """Normalize the accepted scheduler forms: None passes through (the
    legacy engine), a string names a composer OR an admission policy,
    a dict is SchedulerSpec kwargs."""
    if value is None or isinstance(value, SchedulerSpec):
        return value
    if isinstance(value, str):
        if value in COMPOSERS:
            return SchedulerSpec(composer=value)
        if value in ADMISSIONS:
            return SchedulerSpec(admission=value)
        raise ValueError(
            f"unknown scheduler {value!r}: expected a composer "
            f"{COMPOSERS}, an admission policy {ADMISSIONS}, a kwargs "
            f"dict, or a SchedulerSpec")
    if isinstance(value, dict):
        return SchedulerSpec(**value)
    raise TypeError(f"not a scheduler spec: {type(value).__name__}")
