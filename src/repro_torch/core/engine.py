"""Serving engine: one accelerator running prefill, decode, or both.

One class, three roles (DESIGN.md section 4):

  colocated   vLLM-V1-style continuous batching: progressive per-chunk KV
              allocation, prefill-priority, and preemption-by-recompute of
              the lowest-priority sequence when the pool is exhausted. The
              serialized prefill/decode timeline IS the interference the
              paper measures; the preemption churn at high batch IS the
              paper's co-2gpus TPOT cliff (finding F2).
  prefill     prefill-only; finished sequences are handed to the
              orchestrator, which runs the KV store leg of the transfer.
              Pages stay held until the store completes (backpressure).
  decode      decode-only; admits transferred sequences when prompt + full
              output reservation fits (waves, never churn); the KV FETCH
              leg occupies the engine, so slower media degrade TPOT.

Timing comes from the roofline CostModel at the engine's DVFS setting
``phi`` (compute scales 1/phi, memory/interconnect do not). Energy is
integrated per step at P(phi, utilization). In real mode the engine also
executes the model on its device (``RealExecutor``) so token streams are
comparable across setups — the KV-handoff correctness test.
"""
from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .costs import CostModel, StepCost
from .energy import EnergyMeter
from .kvcache import OutOfPages, PagedKVPool
from .request import Request
from repro_torch.obs.trace import NULL_TRACER


@dataclass(eq=False)
class EngineSeq:
    req: Request
    prefill_target: int = 0        # tokens to prefill (prompt, or recompute)
    prefill_done: int = 0
    ctx: int = 0                   # materialized KV tokens in the pool
    # real-mode payload
    state: Any = None              # decode-state pytree (batch axis 1, B=1)
    last_logits: Any = None
    next_token: Optional[int] = None
    # tiered-KV bookkeeping (repro.kvstore): the TierLookup from submit
    # (carries fetch/spill legs + pinned page keys) and a consumed-once
    # flag so preemption/re-admission never double-charges the fetch
    tier_hit: Any = None
    tier_charged: bool = False
    # admission-order override (repro.sched): a tuple key computed by
    # SchedulerSpec.admission_key at every waiting-queue insert; None
    # under FCFS, keeping the legacy int req_id priority bit-for-bit
    admission_key: Optional[tuple] = None

    @property
    def seq_id(self) -> int:
        return self.req.req_id

    @property
    def priority(self):
        # FCFS: lower req_id = earlier arrival = higher priority; an
        # SJF/SRPT/prefix-aware scheduler substitutes its tuple key
        # (whose trailing element is req_id — deterministic tie-break)
        if self.admission_key is not None:
            return self.admission_key
        return self.req.req_id


class Engine:
    def __init__(self, name: str, role: str, cost: CostModel,
                 pool: PagedKVPool, meter: EnergyMeter, *,
                 phi: float = 1.0, prefill_token_budget: int = 8192,
                 executor: Optional["RealExecutor"] = None,
                 on_prefill_done: Optional[Callable] = None,
                 prefix_cache=None):
        assert role in ("colocated", "prefill", "decode")
        self.name = name
        self.role = role
        self.cost = cost
        self.pool = pool
        self.meter = meter
        self.phi = phi
        self.budget = prefill_token_budget
        self.executor = executor
        # online DVFS controller (repro.govern): set by the cluster;
        # invoked at the top of every scheduler step. None = no retuning
        # (identical to the default StaticGovernor).
        self.governor = None
        # observability sink (repro.obs, DESIGN.md section 16): the
        # cluster installs a live Tracer; the default is the no-op
        # NULL_TRACER, so every hook below costs one attribute read
        self.tracer = NULL_TRACER
        self.on_prefill_done = on_prefill_done   # (engine, seq, t) -> None
        # KV reuse (paper section II-C): prefill work for matched tokens is
        # skipped. Simulation-only — in real mode the matched KV bytes are
        # not actually materialized, so reuse is disabled there.
        self.prefix_cache = prefix_cache if executor is None else None
        # tiered KV store (repro.kvstore, DESIGN.md section 15): set by
        # the fleet when the spec's ReuseSpec carries a TierSpec.
        # Mutually exclusive with prefix_cache (the fleet attaches one
        # or the other); a tiered engine is never fast-path eligible.
        self.kv_store = None
        # per-step batch composition + admission order (repro.sched,
        # DESIGN.md section 17): a SchedulerSpec set by the cluster.
        # None = the legacy serialize-prefill FCFS paths, byte-for-byte;
        # a non-coalescible spec also disables the fast path.
        self.scheduler = None
        # chunked-interleave audit log: (req_id, c0, c1) per scheduled
        # prefill chunk — the conservation invariant tests read this
        self.chunk_log: List[Tuple[int, int, int]] = []

        self.t = 0.0                 # engine-local clock
        self.busy_s = 0.0
        # fleet-controller lifecycle flags (repro.fleet.controller): a
        # sleeping or draining engine stops ACCEPTING new routed work but
        # keeps stepping what it already holds. Static fleets never
        # clear this, so the flag is free for them.
        self.accepting = True
        # pages reserved on this engine by in-flight KV transfers (the
        # kv-free-space router subtracts these; only decode-role engines
        # accumulate them, but a flipped engine needs the attribute)
        self.inflight_kv_pages = 0
        self.waiting: List[EngineSeq] = []       # priority-sorted
        self.prefilling: List[EngineSeq] = []    # priority-sorted
        self.running: List[EngineSeq] = []       # decode set
        self.decode_queue: deque = deque()       # (seq, handle, fetch_cost)
        self.pending_fetch: deque = deque()
        # tier demand-fetches awaiting their priced latency/energy step
        # (seqs whose submit-time lookup promoted pages out of DRAM/disk)
        self.pending_tier_fetch: deque = deque()
        self.steps = 0
        self.preemptions = 0
        # cached steady-state decode run (repro.core.fastpath); always
        # validated against live state before reuse, so stale entries
        # are harmless
        self._fastrun = None

    # ------------------------------------------------------------------
    def _free_seq(self, seq: EngineSeq) -> None:
        """Free a sequence's simulated pages and, in real mode, its
        physical KV pages on the device."""
        self.pool.free_seq(seq.seq_id)
        if self.executor is not None:
            self.executor.release(seq)

    # ------------------------------------------------------------------
    def _quiescent(self) -> bool:
        """No queued or in-flight work of any kind."""
        return not (self.waiting or self.prefilling or self.running
                    or self.decode_queue or self.pending_fetch
                    or self.pending_tier_fetch)

    def submit(self, req: Request) -> None:
        # A request cannot be worked on before it arrives: a QUIESCENT
        # engine's clock fast-forwards to the arrival instant. An engine
        # that still holds work must NOT be clamped — the old
        # unconditional max() teleported a blocked engine's clock past
        # its queued work, billing that work a phantom wait (the latent
        # single-engine drift this PR's unit tests pin down). Instead,
        # _admit gates each sequence on arrival_s <= clock, and step()
        # skips an idle clock forward when all queued work lies in the
        # future — so prefill_start_s >= arrival_s still always holds.
        if self._quiescent():
            self.t = max(self.t, req.arrival_s)
        seq = EngineSeq(req=req, prefill_target=req.prompt_len)
        if self.kv_store is not None and req.prompt_tokens is not None:
            if self.tracer.enabled:
                self.kv_store.now = self.t   # clock for tier instants
            hit = self.kv_store.lookup(req.prompt_tokens)
            seq.tier_hit = hit
            saved = hit.saved_tokens(req.prompt_len)
            if saved > 0:
                seq.prefill_done = min(req.prompt_len - hit.recompute_tokens,
                                       req.prompt_len - 1)
                req.reused_tokens = seq.prefill_done
        elif self.prefix_cache is not None and req.prompt_tokens is not None:
            hit = self.prefix_cache.lookup(req.prompt_tokens)
            saved = hit.saved_tokens(req.prompt_len)
            if saved > 0:
                # matched KV is reused: only the remainder is computed
                # (always leave >=1 token so the last-position logits run)
                seq.prefill_done = min(req.prompt_len - hit.recompute_tokens,
                                       req.prompt_len - 1)
                req.reused_tokens = seq.prefill_done
        self._enqueue_waiting(seq)

    def _enqueue_waiting(self, seq: EngineSeq) -> None:
        if self.scheduler is not None:
            # recomputed at every insert: a preempted-and-requeued
            # sequence re-sorts by its live remaining work (SRPT)
            seq.admission_key = self.scheduler.admission_key(seq, self)
        bisect.insort(self.waiting, seq, key=lambda s: s.priority)

    def enqueue_decode(self, seq: EngineSeq, handle: Any, fetch_cost) -> None:
        self.decode_queue.append((seq, handle, fetch_cost))

    # ------------------------------------------------------------------
    def outstanding_tokens(self) -> int:
        """Remaining work queued on THIS engine, in tokens. This is the
        load signal the fleet's least-outstanding-tokens router balances
        on — unlike a request count, it weighs a 16k prompt ~64x heavier
        than a chat turn. Only work this engine will actually execute
        counts: a prefill-role engine hands its sequences off at
        prefill-done, so their decode tokens are the *decode* engine's
        outstanding work, not this one's."""
        decode_here = self.role != "prefill"
        tot = 0
        for s in self.waiting:
            tot += (s.prefill_target - s.prefill_done) \
                + (s.req.output_len - s.req.generated if decode_here else 0)
        for s in self.prefilling:
            tot += (s.prefill_target - s.prefill_done) \
                + (s.req.output_len - s.req.generated if decode_here else 0)
        for s in self.running:
            tot += s.req.output_len - s.req.generated
        for s, _, _ in self.decode_queue:
            tot += s.req.output_len - s.req.generated
        for s, _, _ in self.pending_fetch:
            tot += s.req.output_len - s.req.generated
        return tot

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        if self.prefilling or self.running or self.pending_fetch \
                or self.pending_tier_fetch:
            return True
        if self.waiting and self.role in ("colocated", "prefill"):
            # progressive allocation: a single free page is enough to start
            return self.pool.free_pages > 0
        if self.decode_queue and self._can_admit_decode(
                self.decode_queue[0][0]):
            return True
        return False

    # ------------------------------------------------------------------
    def _can_admit_decode(self, seq: EngineSeq) -> bool:
        # reserve prompt + full output budget: disaggregated decode never
        # preempts (waves instead of churn)
        need = seq.ctx + (seq.req.output_len - seq.req.generated) + 1
        return self.pool.can_fit(need)

    def _admit(self) -> None:
        if self.role in ("colocated", "prefill"):
            # V1-style: admission is cheap; per-chunk allocation throttles.
            # Only ARRIVED sequences are admitted (arrival_s <= clock):
            # priority order is req_id, which need not be arrival order,
            # so each entry is gated individually rather than head-only.
            i = 0
            while i < len(self.waiting) and self.pool.free_pages > 0:
                seq = self.waiting[i]
                if seq.req.arrival_s > self.t:
                    i += 1
                    continue
                self.waiting.pop(i)
                if seq.req.prefill_start_s is None:
                    seq.req.prefill_start_s = self.t
                    if self.tracer.enabled:
                        self.tracer.lifecycle("prefill_start",
                                              seq.req.req_id, self.t,
                                              engine=self.name)
                if seq.tier_hit is not None and not seq.tier_charged \
                        and (seq.tier_hit.fetch_legs
                             or seq.tier_hit.spill_legs):
                    # the submit-time lookup pulled pages up the tier
                    # hierarchy: run the priced fetch leg before this
                    # sequence's prefill (step() drains it first)
                    self.pending_tier_fetch.append(seq)
                bisect.insort(self.prefilling, seq,
                              key=lambda s: s.priority)
        if self.role == "decode":
            while (self.decode_queue
                   and self._can_admit_decode(self.decode_queue[0][0])):
                seq, handle, fetch_cost = self.decode_queue.popleft()
                reserve = seq.ctx + (seq.req.output_len
                                     - seq.req.generated) + 1
                self.pool.allocate(seq.seq_id, reserve)
                self.pending_fetch.append((seq, handle, fetch_cost))

    # ------------------------------------------------------------------
    # one scheduler step; returns True if any progress was made
    # ------------------------------------------------------------------
    def step(self) -> bool:
        tr = self.tracer
        if not tr.wall:
            return self._step() is not None
        tr.begin("engine.step", engine=self.name)
        did = self._step()
        tr.end(did=did or "none")
        return did is not None

    def _step(self) -> Optional[str]:
        """One step: what it did (``fetch``, ``prefill`` for a step of
        the prefill composer, which may fall through to a decode, or
        ``decode``), or None where it made no progress."""
        if self.governor is not None:
            # retune phi from live signals BEFORE the step so the step's
            # timing and power integrate at the decided frequency
            self.governor.on_step(self)
        self._admit()
        if self.pending_fetch:
            self._fetch_step()
            return "fetch"
        if self.pending_tier_fetch:
            self._tier_fetch_step()
            return "fetch"
        if self.prefilling:
            return "prefill" if self._compose_step() else None
        if self.running:
            return "decode" if self._decode_step() else None
        if self.waiting and self.pool.free_pages > 0 \
                and self.role in ("colocated", "prefill"):
            # nothing schedulable now but queued arrivals lie in the
            # future: an otherwise-idle engine skips its clock to the
            # earliest one (a bare engine driven by step() alone must
            # not deadlock; in a cluster an event usually fires first)
            t_next = min(s.req.arrival_s for s in self.waiting)
            if t_next > self.t:
                self.t = t_next
                self._admit()
                if self.prefilling:
                    return "prefill" if self._compose_step() else None
        return None

    def _compose_step(self):
        """Route a step with prefill work through the configured step
        composer: the legacy serialize-prefill path, or the Sarathi-style
        chunked-interleave composer (repro.sched)."""
        if self.scheduler is not None and self.scheduler.interleaves:
            return self._interleaved_step()
        return self._prefill_step()

    # ------------------------------------------------------------------
    def _account(self, cost: StepCost, stage: str) -> float:
        dt = cost.time(self.phi)
        util = cost.utilization(self.phi)
        self.meter.add_power(self.name, self.cost.power_w(self.phi, util),
                             dt, stage=stage, t0=self.t)
        t0 = self.t
        self.t += dt
        self.busy_s += dt
        self.steps += 1
        if self.tracer.enabled:
            self.tracer.span(self.name, stage, t0, self.t, steps=1)
        return self.t

    # ------------------------------------------------------------------
    def _fetch_step(self) -> float:
        """Run the KV fetch leg for one admitted sequence (decode role)."""
        seq, handle, leg = self.pending_fetch.popleft()
        # the fetch leg belongs to the DECODE side of the handoff: its
        # joules (and the engine-occupancy power below) are tagged
        # transfer-fetch so the DVFS sweeps attribute them to decode
        # energy, per the routed path's actual LegCost (the store leg is
        # tagged transfer-store by the fleet's _transfer)
        for comp, joules in leg.energy_j.items():
            self.meter.add(comp, joules, stage="transfer-fetch")
        # the engine is occupied while the fetch lands in its HBM
        self.meter.add_power(self.name, self.cost.idle_power_w(),
                             leg.latency_s, stage="transfer-fetch",
                             t0=self.t)
        t0 = self.t
        self.t += leg.latency_s
        self.busy_s += leg.latency_s
        if self.tracer.enabled:
            self.tracer.span(self.name, "transfer-fetch", t0, self.t,
                             steps=0, req=seq.req.req_id)
            self.tracer.lifecycle("fetch_start", seq.req.req_id, t0,
                                  engine=self.name)
        if self.executor is not None and handle is not None:
            # recorded here, not in the executor: a handle names no
            # request
            if self.tracer.wall:
                self.tracer.begin("exec.fetch", req=seq.req.req_id)
            seq.state, seq.last_logits = self.executor.fetch(handle)
            if self.tracer.wall:
                self.tracer.end()
        if seq.req.decode_start_s is None:
            seq.req.decode_start_s = self.t
        if seq.req.first_token_s is None:
            # dis-*: the first token (argmax of the transferred prefill
            # logits) is released once the KV lands on the decode side —
            # so TTFT = prefill + store + queue + fetch (medium-sensitive)
            seq.req.first_token_s = self.t
            seq.req.generated = 1
            if seq.next_token is not None:
                seq.req.output_tokens.append(int(seq.next_token))
            if self.tracer.enabled:
                self.tracer.lifecycle("first_token", seq.req.req_id,
                                      self.t, engine=self.name)
        if seq.req.generated >= seq.req.output_len:
            # single-token outputs finish at the first token
            seq.req.finish_s = self.t
            self._free_seq(seq)
            if self.tracer.enabled:
                self.tracer.lifecycle("finish", seq.req.req_id, self.t,
                                      engine=self.name)
        else:
            self.running.append(seq)
        return self.t

    # ------------------------------------------------------------------
    def _tier_fetch_step(self) -> float:
        """Meter one sequence's tiered-KV movement (DESIGN.md section
        15). Demand-fetch legs occupy the engine at idle power for
        their latency — stage ``tier-fetch``, sampled into the
        PowerTrace, landing in TTFT exactly like a transfer fetch.
        Spill legs displaced by the promotion are asynchronous DMA:
        energy only, stage ``tier-spill``, no engine occupancy."""
        seq = self.pending_tier_fetch.popleft()
        hit = seq.tier_hit
        seq.tier_charged = True
        latency = 0.0
        for leg in hit.fetch_legs:
            for comp, joules in leg.energy_j.items():
                self.meter.add(comp, joules, stage="tier-fetch")
            latency += leg.latency_s
        for leg in hit.spill_legs:
            for comp, joules in leg.energy_j.items():
                self.meter.add(comp, joules, stage="tier-spill")
        if latency > 0.0:
            self.meter.add_power(self.name, self.cost.idle_power_w(),
                                 latency, stage="tier-fetch", t0=self.t)
            t0 = self.t
            self.t += latency
            self.busy_s += latency
            if self.tracer.enabled:
                self.tracer.span(self.name, "tier-fetch", t0, self.t,
                                 steps=0, req=seq.req.req_id)
        return self.t

    # ------------------------------------------------------------------
    # preemption (vLLM recompute-style)
    # ------------------------------------------------------------------
    def _victims_below(self, priority) -> List[EngineSeq]:
        """Sequences holding pages, strictly lower priority, lowest first.

        (A decode-victims-first variant was hypothesized to keep TTFT
        clean under churn; measured: it TRIPLES recompute volume and
        worsens both TTFT and TPOT — vLLM's pure arrival-priority order
        is kept. See EXPERIMENTS.md reproduction caveats.)"""
        holders = [s for s in self.running + self.prefilling
                   if s.priority > priority
                   and self.pool.has_seq(s.seq_id)]
        # reverse=True, not key=-priority: admission keys may be tuples
        return sorted(holders, key=lambda s: s.priority, reverse=True)

    def _preempt(self, seq: EngineSeq) -> None:
        self._free_seq(seq)
        self.preemptions += 1
        if self.tracer.enabled:
            self.tracer.instant(self.name, "preempt", self.t,
                                req=seq.req.req_id)
        if seq in self.running:
            self.running.remove(seq)
            seq.req.evictions += 1
            redo = seq.req.prompt_len + seq.req.generated
            seq.req.recomputed_tokens += redo
            seq.prefill_target = redo
        elif seq in self.prefilling:
            self.prefilling.remove(seq)
            seq.req.evictions += 1
            seq.req.recomputed_tokens += seq.prefill_done
        seq.prefill_done = 0
        seq.ctx = 0
        seq.state = None
        self._enqueue_waiting(seq)

    def _alloc_or_preempt(self, seq: EngineSeq, tokens: int) -> bool:
        """Allocate; on exhaustion preempt strictly-lower-priority holders.
        Returns False if the allocation is impossible right now."""
        while True:
            try:
                self.pool.allocate(seq.seq_id, tokens)
                return True
            except OutOfPages:
                victims = self._victims_below(seq.priority)
                if not victims:
                    return False
                self._preempt(victims[0])

    # ------------------------------------------------------------------
    def _prefill_step(self) -> float:
        budget = self.budget
        chunks: List[Tuple[EngineSeq, int, int]] = []
        for seq in list(self.prefilling):
            if budget <= 0:
                break
            if seq not in self.prefilling:
                continue   # preempted by an earlier seq's allocation
            remaining = seq.prefill_target - seq.prefill_done
            take = min(remaining, budget)
            if take <= 0:
                continue
            if not self._alloc_or_preempt(seq, take):
                # pool exhausted by higher-priority holders: take whatever
                # fits (vLLM V1 chunked prefill absorbs the free slack —
                # the behavior behind the co-* preemption churn at high
                # batch, finding F2)
                take = min(take,
                           self.pool.free_pages * self.pool.page_size)
                if take <= 0 or not self._alloc_or_preempt(seq, take):
                    break
            chunks.append((seq, seq.prefill_done, seq.prefill_done + take))
            budget -= take
        if not chunks:
            # nothing schedulable: fall through to decode if possible
            if self.running:
                return self._decode_step()
            return False

        cost = self.cost.prefill_step_cost(
            [(c1 - c0, c0, c1) for _, c0, c1 in chunks])
        t_end = self._account(cost, "prefill")

        for seq, c0, c1 in chunks:
            if not self.pool.has_seq(seq.seq_id):
                continue   # preempted later in the same step's alloc loop
            seq.prefill_done = c1
            seq.ctx = c1
            if seq.prefill_done >= seq.prefill_target:
                self._complete_prefill(seq, t_end)
        return True

    def _complete_prefill(self, seq: EngineSeq, t_end: float) -> None:
        """Bookkeeping when a sequence's LAST prefill chunk lands —
        shared by the serial and chunked-interleave step composers:
        reuse-layer insert/release, executor prefill, and either the
        colocated first-token release or the disaggregated handoff."""
        self.prefilling.remove(seq)
        seq.req.prefill_done_s = t_end
        if self.tracer.enabled:
            self.tracer.lifecycle("prefill_done", seq.req.req_id,
                                  t_end, engine=self.name)
            if self.kv_store is not None:
                self.kv_store.now = t_end
        self.pool.touch(seq.seq_id)
        if self.kv_store is not None and \
                seq.req.prompt_tokens is not None:
            # newly computed pages are born in HBM; demotions
            # forced by the overflow — and by releasing this
            # sequence's pins — are priced spill legs
            legs = self.kv_store.insert(seq.req.prompt_tokens)
            if seq.tier_hit is not None:
                legs += self.kv_store.release(seq.tier_hit.pins)
            for leg in legs:
                for comp, joules in leg.energy_j.items():
                    self.meter.add(comp, joules,
                                   stage="tier-spill")
        elif self.prefix_cache is not None and \
                seq.req.prompt_tokens is not None:
            self.prefix_cache.insert(seq.req.prompt_tokens)
        if self.executor is not None:
            seq.state, seq.last_logits, seq.next_token = \
                self.executor.prefill(seq)
        if self.role == "colocated":
            if seq.req.first_token_s is None:
                # first token sampled from prefill logits (vLLM)
                seq.req.first_token_s = t_end
                seq.req.generated = 1
                if seq.next_token is not None:
                    seq.req.output_tokens.append(int(seq.next_token))
                if self.tracer.enabled:
                    self.tracer.lifecycle(
                        "first_token", seq.req.req_id, t_end,
                        engine=self.name)
            if seq.req.generated >= seq.req.output_len:
                # single-token outputs finish at the first token
                seq.req.finish_s = t_end
                self._free_seq(seq)
                if self.tracer.enabled:
                    self.tracer.lifecycle(
                        "finish", seq.req.req_id, t_end,
                        engine=self.name)
            else:
                self.running.append(seq)
        else:
            self.on_prefill_done(self, seq, t_end)

    # ------------------------------------------------------------------
    def _decode_step(self) -> float:
        # grow each running seq by one token (colocated; decode pre-reserved)
        if self.role != "decode":
            for seq in sorted(self.running, key=lambda s: s.priority):
                if seq not in self.running:
                    continue   # preempted by an earlier seq's growth
                if not self._alloc_or_preempt(seq, 1):
                    # lowest-priority holder and no room: preempt self
                    self._preempt(seq)
        if not self.running:
            return False
        batch = list(self.running)
        total_ctx = sum(s.ctx for s in batch)
        cost = self.cost.decode_cost(len(batch), total_ctx)
        t_end = self._account(cost, "decode")

        if self.executor is not None:
            self.executor.decode_batch(batch)

        for seq in batch:
            if seq not in self.running:
                continue   # preempted during the growth loop
            self._complete_decode_token(seq, t_end)
        return True

    def _complete_decode_token(self, seq: EngineSeq, t_end: float) -> None:
        """One emitted token's bookkeeping — shared by the serial decode
        step and the chunked-interleave composed step."""
        seq.ctx += 1
        self.pool.touch(seq.seq_id)
        seq.req.generated += 1
        if seq.next_token is not None:
            seq.req.output_tokens.append(int(seq.next_token))
        if seq.req.generated >= seq.req.output_len:
            seq.req.finish_s = t_end
            self._free_seq(seq)
            self.running.remove(seq)
            if self.tracer.enabled:
                self.tracer.lifecycle("finish", seq.req.req_id,
                                      t_end, engine=self.name)

    # ------------------------------------------------------------------
    def _interleaved_step(self) -> float:
        """Sarathi-style composed step (the ``chunked-interleave``
        composer, repro.sched): grow the running decode batch by one
        token each AND pack prefill chunks into the remainder of the
        step's ``chunk_tokens`` budget. Stall-free batching: every
        composed step emits one token per running sequence, so the
        worst decode inter-token gap is ONE chunk-bounded step — the
        prefill backlog can no longer starve TPOT the way the serial
        composer's full-budget prefill steps do. Priced exactly by
        ``CostModel.mixed_step_cost`` (weights stream once for both
        halves; compute and HBM traffic add)."""
        sched = self.scheduler
        # decode side first — identical growth/preemption discipline to
        # _decode_step (decode-role engines are pre-reserved, no growth)
        if self.role != "decode":
            for seq in sorted(self.running, key=lambda s: s.priority):
                if seq not in self.running:
                    continue   # preempted by an earlier seq's growth
                if not self._alloc_or_preempt(seq, 1):
                    self._preempt(seq)
        # prefill side: one decode token per running sequence is spent
        # from the composed budget before any chunk is packed — that IS
        # the stall-free guarantee (decode work is never displaced)
        budget = max(sched.chunk_tokens - len(self.running), 0)
        chunks: List[Tuple[EngineSeq, int, int]] = []
        for seq in list(self.prefilling):
            if budget <= 0:
                break
            if seq not in self.prefilling:
                continue   # preempted by an earlier seq's allocation
            remaining = seq.prefill_target - seq.prefill_done
            take = min(remaining, budget)
            if take <= 0:
                continue
            if not self._alloc_or_preempt(seq, take):
                # pool exhausted by higher-priority holders: absorb the
                # free slack, exactly like the serial composer
                take = min(take,
                           self.pool.free_pages * self.pool.page_size)
                if take <= 0 or not self._alloc_or_preempt(seq, take):
                    break
            chunks.append((seq, seq.prefill_done, seq.prefill_done + take))
            budget -= take
        # chunk packing may have preempted grown decode sequences:
        # compose the batch AFTER packing so pricing matches execution
        batch = list(self.running)
        if not chunks and not batch:
            return False
        total_ctx = sum(s.ctx for s in batch)
        if chunks and batch:
            cost = self.cost.mixed_step_cost(
                [(c1 - c0, c0, c1) for _, c0, c1 in chunks],
                len(batch), total_ctx)
            stage = "mixed"
        elif chunks:
            cost = self.cost.prefill_step_cost(
                [(c1 - c0, c0, c1) for _, c0, c1 in chunks])
            stage = "prefill"
        else:
            cost = self.cost.decode_cost(len(batch), total_ctx)
            stage = "decode"
        t0 = self.t
        t_end = self._account(cost, stage)

        for seq, c0, c1 in chunks:
            self.chunk_log.append((seq.req.req_id, c0, c1))
        if self.tracer.enabled:
            # scheduler decisions are first-class trace events: an
            # instant on the engine track, plus one span per chunk on a
            # dedicated sched:<engine> track (Perfetto-visible chunks)
            self.tracer.instant(self.name, "sched", t0,
                                decode_batch=len(batch),
                                prefill_tokens=sum(
                                    c1 - c0 for _, c0, c1 in chunks),
                                chunks=len(chunks))
            for seq, c0, c1 in chunks:
                self.tracer.span(f"sched:{self.name}", "chunk", t0,
                                 t_end, steps=0, req=seq.req.req_id,
                                 c0=c0, c1=c1)

        if self.executor is not None and batch:
            self.executor.decode_batch(batch)
        for seq in batch:
            if seq not in self.running:
                continue   # preempted during the packing loop
            self._complete_decode_token(seq, t_end)
        for seq, c0, c1 in chunks:
            if not self.pool.has_seq(seq.seq_id):
                continue   # preempted later in the same step's alloc loop
            seq.prefill_done = c1
            seq.ctx = c1
            if seq.prefill_done >= seq.prefill_target:
                self._complete_prefill(seq, t_end)
        return True


# ----------------------------------------------------------------------
# Real execution: timing stays simulated, but tokens are really computed
# on the device, so setups can be compared token for token.
# ----------------------------------------------------------------------
class RealExecutor:
    """Executes prefill/decode with an actual model; greedy sampling.

    The dense and moe families decode from paged KV: every executor on
    a device shares that device's ``DevicePagedKV``, a sequence's KV lives in
    physical pages keyed by its seq id, prefill writes them, decode
    attends over them through the paged kernel, and ``release`` returns
    them. ``seq.state`` is the handle ``(seq_id, ctx)``; the transferred
    payload is ``(seq_id, k [L, ctx, KV, hd], v, logits)``.

    The recurrent families (ssm, hybrid) carry ``seq.state`` per
    sequence, as the reference's executor does, and take ``kv=None``:
    ``seq.state`` is the model's decode state for one sequence (batch
    axis 1), prefilled with room for ``prompt + output + 2`` tokens; the
    payload is ``(state as a plain tuple, logits)`` and the decode side
    rebuilds the NamedTuple; ``decode_batch`` concatenates the states on
    the batch axis and splits them back; ``release`` drops the state.
    Like the reference, this needs equal-length requests for zamba2,
    whose shared-attention cache is dense and sized per request:
    ``random_workload`` gives them.
    """

    def __init__(self, model, params, kv=None, transfer_path=None):
        self.model = model
        self.params = params
        self.kv = kv
        self.path = transfer_path
        self.paged = model.paged
        if self.paged and kv is None:
            raise ValueError(f"the {model.family} family decodes from a "
                             f"DevicePagedKV")
        self.device = (kv.device if kv is not None
                       else params["embed"]["embedding"].device)
        # wall-clock spans of each call; a cluster hands in its tracer
        self.tracer = NULL_TRACER

    def _context_tokens(self, seq: EngineSeq) -> np.ndarray:
        """prompt + already-emitted tokens (recompute path needs both)."""
        toks = list(seq.req.prompt_tokens)
        need = seq.prefill_target - len(toks)
        if need > 0:
            toks = toks + seq.req.output_tokens[:need]
        return np.asarray(toks[:seq.prefill_target], dtype=np.int64)

    def prefill(self, seq: EngineSeq):
        """Spans (wall tracing on): ``exec.prefill`` with its ``req``
        and ``tokens``, split into
        ``prefill.forward`` (the model's call, enqueued), ``.kv_write``
        (the prompt's pages, paged families) and ``.sync`` (the first
        token read back, where the host waits on the device)."""
        import torch
        tr = self.tracer
        wall = tr.wall
        if wall:
            tr.begin("exec.prefill", req=seq.req.req_id,
                     tokens=seq.prefill_target)
            tr.begin("prefill.forward")
        toks = torch.as_tensor(self._context_tokens(seq),
                               device=self.device)[None, :]
        if self.paged:
            logits, cache = self.model.prefill(self.params,
                                               {"tokens": toks})
        else:
            s_max = seq.req.prompt_len + seq.req.output_len + 2
            logits, state = self.model.prefill(self.params, {"tokens": toks},
                                               s_max=s_max)
        if wall:
            tr.switch("prefill.kv_write")
        if self.paged:
            S = toks.shape[1]
            assert not self.kv.pool.has_seq(seq.seq_id), "pages not released"
            self.kv.pool.allocate(seq.seq_id, S)
            self.kv.write_prefill(seq.seq_id, cache.k[:, 0], cache.v[:, 0])
            state = (seq.seq_id, S)
        if wall:
            tr.switch("prefill.sync")
        next_token = int(torch.argmax(logits[0]))
        if wall:
            tr.end()
            tr.end()
        return state, logits, next_token

    def store(self, seq: EngineSeq):
        tr = self.tracer
        if tr.wall:
            tr.begin("exec.store", req=seq.req.req_id)
        if self.paged:
            k, v = self.kv.gather_dense(seq.seq_id)
            payload = (seq.seq_id, k, v, seq.last_logits)
        else:
            payload = (tuple(seq.state), seq.last_logits)
        if self.path is not None:
            payload = self.path.store(payload)
        if tr.wall:
            tr.end()
        return payload

    def fetch(self, handle):
        payload = handle if self.path is None else self.path.fetch(handle)
        if not self.paged:
            fields, logits = payload
            return self.model.state_type(*fields), logits
        seq_id, k, v, logits = payload
        assert not self.kv.pool.has_seq(seq_id), "pages not released"
        self.kv.pool.allocate(seq_id, k.shape[1])
        self.kv.write_prefill(seq_id, k, v)
        return (seq_id, k.shape[1]), logits

    def release(self, seq: EngineSeq) -> None:
        tr = self.tracer
        if tr.wall:
            tr.begin("exec.release", req=seq.req.req_id)
        if self.paged:
            self.kv.free(seq.seq_id)
        else:
            seq.state = None
        if tr.wall:
            tr.end()

    def decode_batch(self, batch: List[EngineSeq]) -> None:
        """Spans (wall tracing on): ``exec.decode`` with its ``rows``,
        split into ``decode.prepare`` (the step's inputs: tokens,
        positions, and the block table with each row's new page, or the
        joined recurrent states), ``.forward`` (the model's call: the
        host enqueues the step, or copies its inputs and replays a CUDA
        graph; its arg ``graph`` is the graph's row bucket, 0 for an
        eager step), ``.sync`` (the tokens read back, where the host
        waits on the device) and ``.commit`` (each row's new token and
        state)."""
        import torch
        tr = self.tracer
        wall = tr.wall
        if wall:
            tr.begin("exec.decode", rows=len(batch))
            tr.begin("decode.prepare")
        dev = self.device
        tokens = torch.tensor([s.next_token for s in batch],
                              dtype=torch.int64, device=dev)
        pos = torch.tensor([s.ctx for s in batch], dtype=torch.int32,
                           device=dev)
        if self.paged:
            pool = self.kv.pool
            for s in batch:
                pool.allocate(s.seq_id, 1)       # room for the new token
            tables = [pool.block_table(s.seq_id) for s in batch]
            max_pages = max(len(t) for t in tables)
            block_table = torch.tensor(
                [t + [0] * (max_pages - len(t)) for t in tables],
                dtype=torch.int32, device=dev)
            if wall:
                tr.switch("decode.forward")
            logits = self.model.decode_step_paged(
                self.params, tokens, self.kv.k, self.kv.v, block_table, pos,
                self.kv.sink_page)
            graph = self.model.graph_stats.last
        else:
            joined = self.model.state_type(*(
                torch.cat(xs, dim=1) for xs in zip(*(s.state for s in batch))))
            if wall:
                tr.switch("decode.forward")
            logits, new_state = self.model.decode_step(
                self.params, tokens, joined, pos)
            graph = 0
        if wall:
            tr.note(graph=graph)
            tr.switch("decode.sync")
        nxt = torch.argmax(logits, dim=-1).tolist()
        if wall:
            tr.switch("decode.commit")
        for i, (seq, tok) in enumerate(zip(batch, nxt)):
            seq.state = (seq.seq_id, seq.ctx + 1) if self.paged else \
                self.model.state_type(*(x[:, i:i + 1] for x in new_state))
            seq.next_token = int(tok)
        if wall:
            tr.end()
            tr.end()
