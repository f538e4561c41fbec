"""Event-coalescing fast stepper for steady-state decode.

The exact discrete-event loop (``FleetCluster._run_loop`` with
``fast=False``) walks one scheduler step per token per engine; at fleet
scale that Python loop is the cold-simulation bottleneck. This module
implements the coalesced alternative: between two "interesting" instants
(the next heap event, or a non-coalescible engine becoming the min-clock
candidate) an engine in *steady-state decode* executes a fully
predetermined run of uniform steps — fixed batch membership, context sum
growing by ``batch`` per step — so its per-step (dt, watts) sequence and
the cumulative folds of its clock, busy time, and joules can be
precomputed once per run (``RunCache``) and consumed as O(1) slices per
window.

Correctness contract (locked by ``tests/test_fastpath_parity.py``): a
fast run is observably identical to the exact stepper — bit-equal
metrics, per-request timestamps, per-component joules, and power-trace
samples. Two narrow exceptions, both verified by the parity harness:

  - ``EnergyMeter.by_stage``: engines advance independently inside a
    window, so the *order* in which their per-step joules fold into the
    shared per-stage accumulator differs from the exact interleave.
    Float addition is commutative but not associative, so per-stage
    totals agree only to ~1e-12 relative (per-component totals fold in
    engine order and stay bit-exact; ``total_j`` sums bit-exact
    per-component values and is therefore bit-exact too).
  - physical KV page ids: bulk growth grants each sequence its run's
    pages contiguously instead of round-robin per step. Pages are
    fungible — counts, LRU order, and pool invariants still match.

Independent advance is sound because coalesced decode steps neither
push heap events nor read another engine's state: all cross-engine
coupling (routing, transfers, admissions) happens in exact steps or
event callbacks, and the window ends before any of those can run.

An engine is coalescible only when every per-step decision the exact
stepper would make is provably a no-op for the whole run
(``fast_decode_eligible`` + ``_build_run``):

  - no real executor (token streams must replay step-by-step),
  - governor absent or ``coalescible`` (StaticGovernor): online
    controllers read live queues every step,
  - nothing schedulable besides the running decode batch (no waiting /
    prefilling / pending_fetch; decode_queue head not admissible),
  - colocated/prefill-role growth for the whole run fits the free pool
    (otherwise preemption semantics apply -> exact stepper),
  - flop/byte counts below 2**53 so int->float64 stays exact.

Everything else — prefill chunking, KV fetch legs, admissions,
preemption churn, online governors — always goes through the unchanged
``Engine.step``. See DESIGN.md section 13.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def fast_decode_eligible(e) -> bool:
    """True when ``e``'s next exact step is guaranteed to be a pure
    decode step of its current running batch (see module docstring)."""
    if e.executor is not None:
        return False
    if getattr(e, "kv_store", None) is not None:
        return False               # tiered KV store: exact only (s15)
    if e.pending_fetch or getattr(e, "pending_tier_fetch", None) \
            or e.prefilling or e.waiting or not e.running:
        return False
    gov = e.governor
    if gov is not None and not gov.coalescible:
        return False
    sched = getattr(e, "scheduler", None)
    if sched is not None and not sched.coalescible:
        return False               # chunked/SRPT scheduler: exact (s17)
    if e.decode_queue and e._can_admit_decode(e.decode_queue[0][0]):
        return False               # exact stepper would admit: bail
    return True


class RunCache:
    """One uniform decode run, precomputed: per-step arrays plus the
    cumulative sequential folds of clock (tcum), busy seconds (bcum) and
    this engine's component joules (jcum), all anchored at the engine
    state when the run was built. ``np.cumsum`` accumulates left-to-
    right, so ``tcum[j]`` is bit-equal to j repeated ``t += dt`` — a
    window consumes steps [j0, j1) by slicing, and the cache survives
    across windows (validated against live state on reuse)."""

    __slots__ = ("B", "S0", "k0", "phi", "grow", "j",
                 "watts", "tcum", "jcum", "bcum", "t0s")

    def __init__(self, e, batch, k, grow, dt, watts):
        self.B = len(batch)
        self.S0 = sum(s.ctx for s in batch)
        self.k0 = k
        self.phi = e.phi
        self.grow = grow
        self.j = 0                  # steps already consumed
        self.watts = watts
        vals = watts * dt
        self.tcum = np.cumsum(np.concatenate(((e.t,), dt)))
        self.jcum = np.cumsum(np.concatenate(
            ((e.meter.joules[e.name],), vals)))
        self.bcum = np.cumsum(np.concatenate(((e.busy_s,), dt)))
        self.t0s = self.tcum[:k]    # clock before each step


def _build_run(e) -> Optional[RunCache]:
    """Plan the next uniform run for an eligible engine, or None when
    bit-exact coalescing cannot be guaranteed (caller bails to exact)."""
    batch = e.running
    k = min(s.req.output_len - s.req.generated for s in batch)
    if k <= 0:
        return None
    grow = e.role != "decode"
    if grow:
        pool = e.pool
        need = 0
        for s in batch:
            need += pool.pages_for(s.ctx + k) \
                - len(pool.seqs[s.seq_id].pages)
        if need > pool.free_pages:
            return None             # pool pressure: preemption -> exact
    arrays = e.cost.decode_step_arrays(
        len(batch), sum(s.ctx for s in batch), k, e.phi)
    if arrays is None:
        return None
    rc = RunCache(e, batch, k, grow, *arrays)
    e._fastrun = rc
    return rc


def _get_run(e) -> Optional[RunCache]:
    """Reuse the engine's cached run when its live state still sits
    exactly on the cached trajectory; rebuild otherwise. The key is
    state-derived — batch size, context sum, remaining tokens, phi,
    clock, joules, busy seconds — so any intervening exact step, event
    callback, or retune either matches the cached fold bit-for-bit
    (and may legitimately resume it) or forces a rebuild."""
    rc = e._fastrun
    if rc is not None:
        # O(1) happy path: every mutation of the running batch happens
        # either in _apply (which keeps rc.j in sync) or inside an exact
        # step / event callback that moves the engine clock — so a clock
        # still bit-equal to the cached fold at the cursor, with the same
        # batch size and phi, implies the batch and its context sums are
        # exactly where the cache left them
        if e.t == rc.tcum[rc.j] and e.phi == rc.phi \
                and len(e.running) == rc.B:
            return rc
        batch = e.running
        k = min(s.req.output_len - s.req.generated for s in batch)
        j = rc.k0 - k
        if (rc.j < j < rc.k0 and len(batch) == rc.B and e.phi == rc.phi
                and rc.S0 + j * rc.B == sum(s.ctx for s in batch)
                and e.t == rc.tcum[j]
                and e.meter.joules[e.name] == rc.jcum[j]
                and e.busy_s == rc.bcum[j]):
            # j > rc.j means exact decode steps walked the same
            # trajectory in between (their scalar math is bit-equal);
            # fast-forward the cursor and keep the cache
            rc.j = j
            return rc
        e._fastrun = None
    return _build_run(e)


def _consume(e, rc: RunCache, t_event: Optional[float],
             barrier: Optional[Tuple[float, int]], idx: int) -> int:
    """Advance the engine along its cached run as far as the window
    limits allow; O(1) scalar updates plus one trace extend."""
    t0s = rc.t0s                    # clock before each step
    hi = rc.k0
    if t_event is not None:
        # a step may start only strictly before the next heap event
        # (the exact loop fires an event due at-or-before the clock)
        hi = min(hi, int(np.searchsorted(t0s, t_event, side="left")))
    if barrier is not None:
        bt, bidx = barrier
        # exact tie-break is (clock, engine-list position): at equal
        # clocks the earlier-listed engine steps first
        side = "right" if idx < bidx else "left"
        hi = min(hi, int(np.searchsorted(t0s, bt, side=side)))
    j = rc.j
    n = hi - j
    if n <= 0:
        return 0
    meter = e.meter
    meter.joules[e.name] = float(rc.jcum[hi])
    # shared per-stage accumulator: order across engines is relaxed
    # (module docstring); value matches exact to float commutativity
    meter.by_stage["decode"] += float(rc.jcum[hi] - rc.jcum[j])
    if meter.trace is not None:
        # tcum[i+1] == tcum[i] + dt[i] exactly, so these are the same
        # (t0, t1, watts) samples the exact stepper records one by one;
        # slices of one strictly-increasing cumsum are contiguous by
        # construction, so the trace can skip its run check
        meter.trace.record_run(e.name, rc.tcum[j:hi], rc.tcum[j + 1:hi + 1],
                               rc.watts[j:hi], "decode", contiguous=True)
    e.t = float(rc.tcum[hi])
    e.busy_s = float(rc.bcum[hi])
    e.steps += n
    rc.j = hi
    if e.tracer.enabled:
        # one window-level span carrying the step count, where the
        # exact stepper emits n unit spans back to back — identical
        # after Tracer.coalesced() (the window-span contract, s16)
        e.tracer.span(e.name, "decode", float(rc.tcum[j]), e.t, steps=n)
    return n


def _apply(e, rc: RunCache, n: int) -> None:
    """Per-sequence bookkeeping for the ``n`` steps just consumed:
    context growth, page allocation/touch, finishes. Deferred to window
    boundaries — nothing reads this state mid-window — and the final
    LRU order and page counts match the exact per-step updates."""
    pool = e.pool
    if rc.grow:
        # exact grows 1 token/seq/step in priority order; one bulk
        # allocate per seq yields the same page counts and the same
        # pre-touch LRU order (_build_run verified the run fits)
        for s in sorted(e.running, key=lambda s: s.priority):
            pool.allocate(s.seq_id, n)
    t_end = e.t
    for s in list(e.running):
        s.ctx += n
        s.req.generated += n
        if s.req.generated >= s.req.output_len:
            # only a fully consumed run can finish (k = min remaining)
            s.req.finish_s = t_end
            pool.free_seq(s.seq_id)
            e.running.remove(s)
            if e.tracer.enabled:
                e.tracer.lifecycle("finish", s.req.req_id, t_end,
                                   engine=e.name)
        else:
            pool.touch(s.seq_id)


def _advance_engine(e, idx: int, t_event: Optional[float],
                    barrier: Optional[Tuple[float, int]]) -> int:
    """Chain coalesced runs on one engine up to the window limits."""
    total = 0
    tuned = False
    while True:
        if t_event is not None and e.t >= t_event:
            break
        if barrier is not None and barrier < (e.t, idx):
            break
        if not tuned and e.governor is not None:
            # the exact stepper retunes before every step; a coalescible
            # governor's decision is run-invariant, so once per window —
            # at the same clock the exact first step would use — suffices
            e.governor.on_step(e)
            tuned = True
        rc = _get_run(e)
        if rc is None:
            break
        n = _consume(e, rc, t_event, barrier, idx)
        if n == 0:
            break
        total += n
        _apply(e, rc, n)
        if rc.j < rc.k0:
            break                   # window limit reached mid-run
        e._fastrun = None           # run complete: maybe chain the next
        if not fast_decode_eligible(e):
            break
    return total


# ----------------------------------------------------------------------
def coalesce_window(candidates: List, order: Dict,
                    t_event: Optional[float]) -> int:
    """Advance every coalescible candidate through uniform decode runs
    up to the next interesting time — the heap event at ``t_event`` or
    the instant a non-coalescible engine becomes the min-clock pick.
    Returns the number of engine steps executed (0: nothing was
    coalescible; the caller falls back to one exact step)."""
    fast: List = []
    barrier: Optional[Tuple[float, int]] = None
    for e in candidates:
        if fast_decode_eligible(e):
            fast.append(e)
        else:
            key = (e.t, order[e])
            if barrier is None or key < barrier:
                barrier = key
    executed = 0
    for e in fast:
        executed += _advance_engine(e, order[e], t_event, barrier)
    return executed
