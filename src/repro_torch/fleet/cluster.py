"""FleetCluster: the discrete-event serving loop over an xP:yD fleet.

The generalization of the paper's five two-accelerator setups to
arbitrary fleet shapes (``FleetSpec``): x prefill + y decode instances
(or n colocated), each with its own ``PagedKVPool``, per-instance DVFS
setting, and energy attribution under one shared ``EnergyMeter``.
Arriving requests are routed to a prefill instance by the frontend
``Router`` at their arrival event; a finished prefill's KV cache is
routed to a decode instance by the KV router at prefill completion and
streamed over that (prefill, decode) pair's own ``TransferPath`` — any
prefill instance can feed any decode instance over ici/host/disk.

The event loop, transfer legs, and energy integration are the ones the
1P:1D ``Cluster`` always ran (it is now a thin facade over this class,
see ``repro.core.orchestrator``); the parity regression in
``tests/test_fleet.py`` pins the 1P:1D and colocated special cases to
the pre-fleet metrics bit-for-bit.
"""
from __future__ import annotations

import heapq
import itertools
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costs import AcceleratorSpec, CostModel, HostSpec
from repro_torch.core.energy import EnergyMeter
from repro_torch.core.engine import Engine, EngineSeq, RealExecutor
from repro_torch.core.fastpath import coalesce_window
from repro_torch.core.kvcache import PagedKVPool
from repro_torch.core.request import Request, WorkloadMetrics, summarize
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.transfer import (LegCost, TransferPath, make_path,
                                       payload_bytes)
from repro_torch.govern import make_governor
from repro_torch.kvstore import ReuseSpec, TieredKVStore, as_reuse_spec
from repro_torch.govern.telemetry import ABSENT, IDLE, SLEEP, PowerTrace
from repro_torch.obs.trace import (NULL_TRACER, Tracer,
                             controller_action_from_event,
                             event_from_controller_action)

from .controller import make_controller
from .router import Router
from .spec import FleetSpec, as_fleet_spec

Phi = Union[float, Tuple[float, ...]]

# Default stepper for FleetCluster.run: "fast" coalesces steady-state
# decode runs (repro.core.fastpath), "exact" is the retained one-step-
# per-token reference the parity harness differentially tests against.
# The two are observably identical (tests/test_fastpath_parity.py);
# REPRO_STEPPER=exact flips the default for debugging a suspect run.
STEPPERS = ("fast", "exact")
DEFAULT_STEPPER = os.environ.get("REPRO_STEPPER", "fast")


@dataclass
class SetupResult:
    setup: str
    metrics: WorkloadMetrics
    energy: EnergyMeter
    requests: List[Request]
    makespan_s: float
    total_tokens: int

    @property
    def joules_per_token(self) -> float:
        return self.energy.total_j / max(self.total_tokens, 1)


class FleetCluster:
    def __init__(self, spec: Union[str, FleetSpec], cfg: ModelConfig, *,
                 acc: Optional[AcceleratorSpec] = None,
                 host: Optional[HostSpec] = None,
                 phi: Optional[float] = None,
                 phi_prefill: Optional[Phi] = None,
                 phi_decode: Optional[Phi] = None,
                 governor: Optional[Union[str, Tuple[str, ...]]] = None,
                 reuse: Optional[Union[str, dict, ReuseSpec]] = None,
                 scheduler=None,
                 page_size: int = 16,
                 prefill_token_budget: int = 8192,
                 pool_bytes: Optional[float] = None,
                 executor_factory: Optional[Callable[
                     [Optional[TransferPath]], RealExecutor]] = None,
                 tracer: Optional[Tracer] = None):
        spec = as_fleet_spec(spec)
        if phi is not None or phi_prefill is not None \
                or phi_decode is not None:
            spec = spec.with_phi(phi=phi, phi_prefill=phi_prefill,
                                 phi_decode=phi_decode)
        if governor is not None:
            # sweep-plumbing override, mirroring the phi kwargs: any
            # entry point taking **cluster_kw can run a governor
            from dataclasses import replace
            spec = replace(spec, governor=governor)
        if reuse is not None:
            # same sweep-plumbing shape for KV reuse (DESIGN.md s15)
            from dataclasses import replace
            spec = replace(spec, reuse=reuse)
        if scheduler is not None:
            # same sweep-plumbing shape for the step scheduler (s17)
            from dataclasses import replace
            spec = replace(spec, scheduler=scheduler)
        self.spec = spec
        self.setup = spec.name
        self.cfg = cfg
        self.acc = acc or AcceleratorSpec()
        self.host = host or HostSpec()
        self.cost = CostModel(cfg, self.acc, self.host)
        # every run carries a power-state timeline (repro.govern): the
        # trace is observational — joule totals use the same call
        # sequence with or without it, so parity goldens stay bit-exact
        self.meter = EnergyMeter(trace=PowerTrace())
        # observability (repro.obs, DESIGN.md section 16): the tracer is
        # observational too — on or off, every simulated quantity is
        # bit-identical (tests/test_obs.py parity axis)
        self.tracer = tracer or NULL_TRACER
        # fastpath coalescing stats (window count / steps coalesced),
        # maintained by _run_loop; exact runs leave both at 0
        self.coalesce_windows = 0
        self.coalesced_steps = 0
        pool_bytes = pool_bytes or self.acc.kv_pool_gb * 1e9
        kv_per_tok = max(self.cost.kv_bytes_per_token, 1)

        def new_pool():
            return PagedKVPool.from_bytes(pool_bytes, kv_per_tok, page_size)

        self.engines: List[Engine] = []
        self.prefill_engines: List[Engine] = []
        self.decode_engines: List[Engine] = []
        # one TransferPath per (prefill, decode) pair: media with real
        # per-connection state (disk scratch files, staging buffers)
        # stay independent, and a future heterogeneous-media fleet only
        # has to change this map
        self.paths: Dict[Tuple[int, int], TransferPath] = {}
        self._events: List = []   # heap of (t, tiebreak, fn)
        self._counter = itertools.count()

        if spec.is_colocated:
            for i, phi_i in enumerate(spec.phis_prefill):
                ex = executor_factory(None) if executor_factory else None
                self.engines.append(Engine(
                    f"acc{i}", "colocated", self.cost, new_pool(),
                    self.meter, phi=phi_i,
                    prefill_token_budget=prefill_token_budget, executor=ex))
            self.prefill_engines = self.engines
        elif spec.is_intra:
            # intra-GPU P/D disaggregation (RAPID-Serve, DESIGN.md s17):
            # each accelerator is SM-partitioned into a prefill slice
            # and a decode slice — two engines whose CostModels are
            # complementary slices of ONE accelerator (rooflines and
            # power rails sum back to the whole part) sharing ONE KV
            # pool. The handoff never leaves HBM: no TransferPath, no
            # transfer joules, zero latency (_intra_handoff).
            cost_p = self.cost.slice(spec.intra_split)
            cost_d = self.cost.slice(1.0 - spec.intra_split)
            for i, (phi_p, phi_d) in enumerate(zip(spec.phis_prefill,
                                                   spec.phis_decode)):
                pool = new_pool()
                ex_p = executor_factory(None) if executor_factory else None
                ex_d = executor_factory(None) if executor_factory else None
                ep = Engine(f"acc{i}p", "prefill", cost_p, pool,
                            self.meter, phi=phi_p,
                            prefill_token_budget=prefill_token_budget,
                            executor=ex_p,
                            on_prefill_done=self._intra_handoff)
                ep.fleet_index = i
                ed = Engine(f"acc{i}d", "decode", cost_d, pool,
                            self.meter, phi=phi_d,
                            prefill_token_budget=prefill_token_budget,
                            executor=ex_d)
                ed.fleet_index = i
                ed.inflight_kv_pages = 0
                # the handoff target is the fixed same-accelerator peer
                # (KV is physically resident there already) — no KV
                # routing decision exists for this shape
                ep.intra_peer = ed
                self.prefill_engines.append(ep)
                self.decode_engines.append(ed)
            self.engines = self.prefill_engines + self.decode_engines
        else:
            x, y = spec.n_prefill, spec.n_decode
            for i in range(x):
                for j in range(y):
                    self.paths[(i, j)] = make_path(spec.medium, self.host)
            # engine executors are built path-less: the (prefill, decode)
            # pair — hence the path the real bytes travel — is only known
            # at transfer time, so _transfer runs the pair path's
            # store()/fetch() around the executor's payload
            for i, phi_i in enumerate(spec.phis_prefill):
                ex = executor_factory(None) if executor_factory else None
                eng = Engine(f"acc{i}", "prefill", self.cost, new_pool(),
                             self.meter, phi=phi_i,
                             prefill_token_budget=prefill_token_budget,
                             executor=ex, on_prefill_done=self._transfer)
                eng.fleet_index = i
                self.prefill_engines.append(eng)
            for j, phi_j in enumerate(spec.phis_decode):
                ex = executor_factory(None) if executor_factory else None
                eng = Engine(f"acc{x + j}", "decode", self.cost, new_pool(),
                             self.meter, phi=phi_j,
                             prefill_token_budget=prefill_token_budget,
                             executor=ex)
                eng.fleet_index = j
                # pages for transfers routed here but still in their
                # store leg (not yet in decode_queue): the kv-free-space
                # router subtracts this, else every prefill finishing
                # within one store-latency window picks the same target
                eng.inflight_kv_pages = 0
                self.decode_engines.append(eng)
            self.engines = self.prefill_engines + self.decode_engines

        # one governor instance per engine (controllers are stateful;
        # per-engine seeds keep any future stochastic policy decoupled
        # across instances). The default StaticGovernor keeps the
        # spec-configured phi — a no-op on the timing/energy stream.
        for idx, (eng, gname) in enumerate(zip(self.engines,
                                               spec.governors)):
            eng.governor = make_governor(gname,
                                         seed=spec.seed + 1000 + idx)

        for eng in self.engines:
            eng.tracer = self.tracer
            if eng.executor is not None:
                eng.executor.tracer = self.tracer

        # per-step scheduler (repro.sched, DESIGN.md section 17): one
        # normalized SchedulerSpec shared by every engine. None leaves
        # Engine.scheduler = None — the legacy paths, byte-for-byte.
        if spec.scheduler is not None:
            for eng in self.engines:
                eng.scheduler = spec.scheduler

        # legacy attribute: the single transfer path of a 1P:1D fleet
        self.path: Optional[TransferPath] = self.paths.get((0, 0)) \
            if len(self.paths) == 1 else None

        # global engine index + pair paths keyed on it: role flips make
        # (prefill_index, decode_index) ambiguous, so the transfer code
        # looks paths up by (src.gidx, dst.gidx). Pre-populated with the
        # SAME TransferPath objects as self.paths (which is kept for
        # compatibility); pairs first connected after a flip get a
        # fresh path of the spec's medium lazily.
        for idx, e in enumerate(self.engines):
            e.gidx = idx
        x = spec.n_prefill
        self._pair_paths: Dict[Tuple[int, int], TransferPath] = {
            (i, x + j): p for (i, j), p in self.paths.items()}

        # ---- online fleet controller (repro.fleet.controller) --------
        # None = static fleet: every branch below is byte-for-byte the
        # pre-controller behavior (accept=None routers, no lifecycle
        # bookkeeping, no tick events).
        self.controller = None
        self.controller_log: List[dict] = []
        self._lifecycle: Dict[str, List[Tuple[float, str]]] = {}
        self._draining: Dict[Engine, str] = {}   # engine -> "sleep"|"flip"
        self._parked_requests: List[Request] = []
        self._parked_transfers: List[Tuple[Engine, EngineSeq, float]] = []
        self._pending_arrivals = 0
        if spec.controller is not None:
            self.controller = make_controller(spec.controller,
                                              seed=spec.seed + 2000)
            for e in self.engines:
                self._lifecycle[e.name] = [(0.0, "on")]
            self._apply_initial_awake()

        if self.controller is None:
            accept_p = accept_d = None
        elif spec.is_colocated:
            accept_p = lambda e: e.accepting          # noqa: E731
            accept_d = None
        else:
            # role-aware: a flipped engine moves between the two routers'
            # eligible sets without rebinding the router itself
            accept_p = lambda e: e.accepting and e.role != "decode"  # noqa: E731
            accept_d = lambda e: e.accepting and e.role == "decode"  # noqa: E731
        frontend_engines = self.prefill_engines if self.controller is None \
            else self.engines
        self.frontend = Router(frontend_engines, spec.router, spec.seed,
                               accept=accept_p)
        if not self.decode_engines:
            self.kv_router = None
        else:
            kv_engines = self.decode_engines if self.controller is None \
                else self.engines
            self.kv_router = Router(kv_engines, spec.kv_router,
                                    spec.seed + 1, accept=accept_d)

        # ---- KV reuse (repro.kvstore, DESIGN.md section 15) ----------
        self._reuse: Optional[ReuseSpec] = None
        self._shared_prefix_cache: Optional[PrefixCache] = None
        if spec.reuse is not None:
            self._attach_reuse(spec.reuse)

    # ------------------------------------------------------------------
    def _attach_reuse(self, reuse: Union[str, dict, ReuseSpec]) -> None:
        """Attach the spec'd KV reuse machinery to the engines. Flat
        (``tiers is None``): ONE shared ``PrefixCache`` across the fleet
        — the cluster-wide reuse the paper's section II-C experiments
        model, fast-stepper safe (lookups/inserts happen in exact
        submit/prefill steps). Tiered: one ``TieredKVStore`` PER engine
        (residency is the router's locality signal, so it must be
        per-instance), attached to every engine regardless of role so
        controller role flips keep their store. Real-executor engines
        are skipped — matched KV bytes are not actually materialized,
        same rule as ``Engine.prefix_cache``."""
        r = as_reuse_spec(reuse)
        self._reuse = r
        if r.tiers is None:
            pc = PrefixCache(capacity_pages=r.capacity_pages,
                             page_size=r.page_size,
                             pic=(r.mode == "pic"),
                             recompute_frac=r.recompute_frac)
            self._shared_prefix_cache = pc
            for e in self.engines:
                if e.executor is None:
                    e.prefix_cache = pc
            return
        page_bytes = max(self.cost.kv_bytes_per_token, 1) * r.page_size
        for e in self.engines:
            if e.executor is None:
                e.kv_store = TieredKVStore(
                    r.tiers, mode=r.mode, page_size=r.page_size,
                    recompute_frac=r.recompute_frac,
                    page_bytes=page_bytes, host=self.host)
                e.kv_store.tracer = self.tracer

    @property
    def tiered(self) -> bool:
        """Any engine carrying a TieredKVStore — the fast-stepper bail
        signal (checked on engines, not the spec, so tests attaching
        stores directly are covered too)."""
        return any(e.kv_store is not None for e in self.engines)

    @property
    def fastpath_stats(self) -> Dict[str, Union[int, float]]:
        """End-of-run coalescing summary: window count, steps coalesced,
        and the coalesced fraction of all engine steps (diagnosability
        companion to the perf lane's speedup numbers)."""
        total = sum(e.steps for e in self.engines)
        return {"windows": self.coalesce_windows,
                "coalesced_steps": self.coalesced_steps,
                "coalesced_step_fraction":
                    self.coalesced_steps / total if total else 0.0}

    def _warm_stores(self, requests: List[Request]) -> None:
        """``ReuseSpec.warm``: pre-insert request 0's prompt before the
        run so the very first lookup can hit (the reuse benchmarks'
        warmed-cache convention). Tiered warm inserts are priced like
        any other insert — overflow spills are metered at t=0."""
        r = self._reuse
        if r is None or not r.warm or not requests:
            return
        toks = requests[0].prompt_tokens
        if toks is None:
            return
        if self._shared_prefix_cache is not None:
            self._shared_prefix_cache.insert(toks)
            return
        for e in self.engines:
            if e.kv_store is not None:
                for leg in e.kv_store.insert(toks):
                    for comp, joules in leg.energy_j.items():
                        self.meter.add(comp, joules, stage="tier-spill")

    # ------------------------------------------------------------------
    def _push(self, t: float, fn: Callable[[], None]) -> None:
        tr = self.tracer
        if tr.wall:                      # each event fired is a span
            event = fn

            def fn():
                tr.begin("cluster.event")
                event()
                tr.end()
        heapq.heappush(self._events, (t, next(self._counter), fn))

    # ------------------------------------------------------------------
    def _pair_path(self, src: Engine, dst: Engine) -> TransferPath:
        key = (src.gidx, dst.gidx)
        path = self._pair_paths.get(key)
        if path is None:                 # pair first connected post-flip
            path = make_path(self.spec.medium, self.host)
            self._pair_paths[key] = path
        return path

    def _transfer(self, engine: Engine, seq: EngineSeq, t_done: float):
        """Store leg: runs right after prefill; pages stay held on the
        prefill accelerator until the store completes. The decode target
        is picked HERE (not at arrival), so the KV router sees decode
        pool pressure at transfer time. With a controller active the
        pick can come up empty (every decode instance asleep/draining):
        the handoff parks — pages still held, the backpressure is real —
        until ``_provide`` wakes or flips capacity."""
        dec = self.kv_router.pick(req=seq.req)
        if dec is None:
            self._parked_transfers.append((engine, seq, t_done))
            self._provide("decode", t_done)
            return
        self._start_transfer(engine, seq, t_done, dec)

    def _local_handoff(self, engine: Engine, seq: EngineSeq, t: float):
        """A prefill->decode handoff whose target IS the engine that
        prefilled it (possible only after a role flip): the KV is
        already resident in its HBM, so both legs are zero-cost — the
        pages are freed and immediately re-reserved under the decode
        role's prompt+output reservation discipline."""
        engine.pool.free_seq(seq.seq_id)
        seq.req.transfer_done_s = t
        if self.tracer.enabled:
            self.tracer.lifecycle("transfer_start", seq.req.req_id, t,
                                  src=engine.name, dst=engine.name)
            self.tracer.lifecycle("transfer_done", seq.req.req_id, t,
                                  src=engine.name, dst=engine.name)
        engine.t = max(engine.t, t)
        engine.enqueue_decode(seq, None, LegCost(0.0))

    def _intra_handoff(self, engine: Engine, seq: EngineSeq, t: float):
        """Prefill-slice -> decode-slice handoff inside ONE accelerator
        (the intra-gpu shape): the KV pages already live in the shared
        HBM pool, so there is no transfer leg at all — zero latency,
        zero joules, the dominance fig11 machine-checks against
        dis-disk. Like ``_local_handoff``, the pages are freed and
        immediately re-reserved under the decode slice's prompt+output
        reservation discipline (``engine.pool`` IS the peer's pool)."""
        dec = engine.intra_peer
        engine.pool.free_seq(seq.seq_id)
        seq.req.transfer_done_s = t
        if self.tracer.enabled:
            self.tracer.lifecycle("transfer_start", seq.req.req_id, t,
                                  src=engine.name, dst=dec.name)
            self.tracer.lifecycle("transfer_done", seq.req.req_id, t,
                                  src=engine.name, dst=dec.name)
        dec.t = max(dec.t, t)
        dec.enqueue_decode(seq, None, LegCost(0.0))

    def _start_transfer(self, engine: Engine, seq: EngineSeq,
                        t_done: float, dec: Engine):
        if dec is engine:
            self._local_handoff(engine, seq, t_done)
            return
        path = self._pair_path(engine, dec)
        nbytes = self.cost.kv_bytes(seq.ctx)
        store = path.store_cost(nbytes)
        fetch = path.fetch_cost(nbytes)
        # the store leg belongs to the PREFILL side of the handoff
        # (transfer-fetch is added by the decode engine at admission):
        # the DVFS sweeps attribute each leg's joules to its stage from
        # the routed pair's actual LegCost, not an arbitrary 50/50 split
        for comp, joules in store.energy_j.items():
            self.meter.add(comp, joules, stage="transfer-store")
        handle = None
        tr = self.tracer
        moved = 0
        if engine.executor is not None:
            # real byte movement over the ROUTED pair's path (the
            # path-less executor just packages the state payload); the
            # path's spans are recorded here, where the request is known
            payload = engine.executor.store(seq)
            if tr.wall:
                moved = payload_bytes(payload)
                tr.begin("path.store", req=seq.req.req_id, nbytes=moved)
            handle = path.store(payload)
            if tr.wall:
                tr.end()

        t_arrive = t_done + store.latency_s
        seq.req.transfer_done_s = t_arrive
        if self.tracer.enabled:
            self.tracer.lifecycle("transfer_start", seq.req.req_id,
                                  t_done, src=engine.name, dst=dec.name)
            self.tracer.lifecycle("transfer_done", seq.req.req_id,
                                  t_arrive, src=engine.name,
                                  dst=dec.name)
            self.tracer.span(f"xfer:{engine.name}->{dec.name}",
                             "kv-store", t_done, t_arrive,
                             req=seq.req.req_id, nbytes=int(nbytes))
        reserve = seq.ctx + (seq.req.output_len - seq.req.generated) + 1
        inflight = dec.pool.pages_for(reserve)
        dec.inflight_kv_pages += inflight

        def deliver():
            engine.pool.free_seq(seq.seq_id)
            if engine.executor is not None:
                # the stored payload is a copy: the prefill side's
                # physical KV pages go back to the device pool here
                engine.executor.release(seq)
            # both engines resume no earlier than the store completion:
            # the prefill engine may have been blocked on pool space
            engine.t = max(engine.t, t_arrive)
            # the reservation migrates from in-flight to decode_queue,
            # where the router's headroom counts it instead
            dec.inflight_kv_pages -= inflight
            payload = None
            if handle is not None:
                if tr.wall:
                    tr.begin("path.fetch", req=seq.req.req_id,
                             nbytes=moved)
                payload = path.fetch(handle)
                if tr.wall:
                    tr.end()
            dec.enqueue_decode(seq, payload, fetch)
            dec.t = max(dec.t, t_arrive)

        self._push(t_arrive, deliver)

    # ------------------------------------------------------------------
    def submit(self, requests: List[Request]) -> None:
        """Route every request through the event heap at its
        ``arrival_s``: an engine never sees a request before it arrives
        (submitting upfront let a staggered arrival be prefilled at t=0,
        yielding negative TTFT), and the frontend router scores live
        queue depths at the arrival instant rather than at submission.
        ``Engine.submit`` fast-forwards an idle engine's clock to the
        arrival instant; a busy engine (clock already past it) just
        queues the request."""
        self._pending_arrivals += len(requests)
        for r in requests:
            self._push(r.arrival_s, lambda r=r: self._on_arrival(r))

    def _on_arrival(self, r: Request) -> None:
        self._pending_arrivals -= 1
        if self.tracer.enabled:
            self.tracer.lifecycle("arrival", r.req_id, r.arrival_s)
        eng = self.frontend.pick(req=r)
        if eng is None:     # controller-active and nothing accepting
            self._parked_requests.append(r)
            self._provide("prefill", r.arrival_s)
            return
        if self.tracer.enabled:
            self.tracer.lifecycle("routed", r.req_id, r.arrival_s,
                                  engine=eng.name)
        eng.submit(r)

    # ------------------------------------------------------------------
    # fleet-controller lifecycle machinery (DESIGN.md section 14).
    # States per engine: on -> (drain ->) sleep -> wake -> on, plus
    # absent (never provisioned yet; wakes like sleep at 0 W history).
    # Invariants the primitives below maintain — the property tests in
    # tests/test_controller.py fuzz them under random schedules:
    #   * a sleeping/absent/waking/draining engine never ACCEPTS routed
    #     work (routers filter on e.accepting + role);
    #   * sleep requires a fully empty engine (quiescent, no pool seqs,
    #     no in-flight KV), so no request is ever stranded;
    #   * a drain completes only when the engine settles; drain-to-flip
    #     of a prefill engine tolerates pool pages held by its own
    #     PARKED handoffs (they become zero-cost local handoffs the
    #     moment the engine is decode-role);
    #   * every parked request/transfer triggers _provide(), which
    #     always lines up future capacity for that role (wake, cancel a
    #     drain, or flip the other role) — liveness.
    # ------------------------------------------------------------------
    def lifecycle_state(self, e: Engine) -> str:
        if self.controller is None:
            return "on"
        return self._lifecycle[e.name][-1][1]

    def _seg(self, e: Engine, t: float, state: str) -> None:
        lc = self._lifecycle[e.name]
        lc.append((max(t, lc[-1][0]), state))

    def _log(self, t: float, op: str, e: Engine, **kw) -> None:
        # the obs TraceEvent is the canonical record; the legacy dict
        # shape consumers subscript (entry["op"], ...) is derived from
        # it — one schema, two views
        ev = event_from_controller_action(
            dict(t=round(float(t), 9), op=op, engine=e.name, **kw))
        if self.tracer.enabled:
            self.tracer.events.append(ev)
        self.controller_log.append(controller_action_from_event(ev))

    def _apply_initial_awake(self) -> None:
        """Engines beyond the controller's initial_awake_* counts start
        ABSENT (not provisioned): zero draw until first woken, never
        back-filled as idle joules."""
        cspec = self.controller.spec

        def limit(engines, k):
            if k is None or k < 0:
                return
            for e in engines[k:]:
                e.accepting = False
                self._lifecycle[e.name] = [(0.0, "absent")]

        if self.spec.is_colocated:
            limit(self.engines, cspec.initial_awake_prefill)
        else:
            limit(self.prefill_engines, cspec.initial_awake_prefill)
            limit(self.decode_engines, cspec.initial_awake_decode)

    # ---- controller-facing primitives --------------------------------
    def ctl_wake(self, e: Engine, t: float) -> bool:
        """sleep/absent -> wake -> (after wake_latency_s) on."""
        if self.lifecycle_state(e) not in ("sleep", "absent"):
            return False
        t = max(t, e.t)
        self._seg(e, t, "wake")
        self._log(t, "wake", e)
        t_ready = t + self.controller.spec.wake_latency_s

        def ready(e=e, t_ready=t_ready):
            self._seg(e, t_ready, "on")
            e.accepting = True
            e.t = max(e.t, t_ready)
            self._rebalance(t_ready)

        self._push(t_ready, ready)
        return True

    def ctl_sleep(self, e: Engine, t: float) -> bool:
        """Deep-sleep an empty, settled engine immediately."""
        if self.lifecycle_state(e) != "on" or e in self._draining:
            return False
        if not e._quiescent() or e.pool.seqs \
                or getattr(e, "inflight_kv_pages", 0):
            return False
        e.accepting = False
        t = max(t, e.t)
        self._seg(e, t, "sleep")
        self._log(t, "sleep", e)
        return True

    def ctl_drain(self, e: Engine, t: float, then: str = "sleep") -> bool:
        """Stop accepting now; apply ``then`` ("sleep" or "flip") once
        the engine settles."""
        assert then in ("sleep", "flip"), then
        if self.lifecycle_state(e) != "on" or e in self._draining:
            return False
        e.accepting = False
        self._draining[e] = then
        self._log(t, "drain", e, then=then)
        self._check_drains(t)
        return True

    def ctl_cancel_drain(self, e: Engine, t: float) -> bool:
        if e not in self._draining:
            return False
        del self._draining[e]
        e.accepting = True
        self._log(t, "cancel-drain", e)
        return True

    def ctl_flip_asleep(self, e: Engine, t: float) -> bool:
        """Flip the role of a sleeping/absent (hence empty) engine in
        place — repurposing a parked instance costs nothing."""
        if self.lifecycle_state(e) not in ("sleep", "absent"):
            return False
        if e.pool.seqs or not e._quiescent():
            return False
        self._flip_role(e)
        self._log(t, "flip", e, role=e.role, asleep=True)
        return True

    # ---- drain / flip internals --------------------------------------
    def _flip_role(self, e: Engine) -> None:
        e.role = "decode" if e.role == "prefill" else "prefill"
        e.on_prefill_done = self._transfer
        e._fastrun = None    # cached steady-state run keyed on old role

    def _drained(self, e: Engine, fate: str) -> bool:
        if not e._quiescent() or getattr(e, "inflight_kv_pages", 0):
            return False
        if not e.pool.seqs:
            return True
        if fate == "flip" and e.role == "prefill":
            # pages held only by this engine's own parked handoffs:
            # they self-deliver locally the moment the role flips
            parked_here = {s.seq_id for (src, s, _)
                           in self._parked_transfers if src is e}
            return set(e.pool.seqs) <= parked_here
        return False

    def _check_drains(self, t: float) -> bool:
        done = [e for e, fate in self._draining.items()
                if self._drained(e, fate)]
        for e in done:
            fate = self._draining.pop(e)
            tt = max(t, e.t)
            if fate == "sleep":
                self._seg(e, tt, "sleep")
                self._log(tt, "sleep", e)
            else:
                self._apply_flip(e, tt)
        if done:
            self._rebalance(t)
        return bool(done)

    def _apply_flip(self, e: Engine, t: float) -> None:
        self._flip_role(e)
        e.accepting = True
        e.t = max(e.t, t)
        self._log(t, "flip", e, role=e.role)
        if e.role == "decode":
            mine = [item for item in self._parked_transfers
                    if item[0] is e]
            for item in mine:
                self._parked_transfers.remove(item)
                _, seq, td = item
                self._local_handoff(e, seq, max(td, t))

    # ---- parked-work liveness ----------------------------------------
    def _flush(self, t: float) -> None:
        """Re-route parked requests/handoffs against current capacity."""
        still_r: List[Request] = []
        for r in self._parked_requests:
            eng = self.frontend.pick(req=r)
            if eng is None:
                still_r.append(r)
            else:
                if self.tracer.enabled:
                    self.tracer.lifecycle("routed", r.req_id, t,
                                          engine=eng.name)
                eng.submit(r)
        self._parked_requests = still_r
        still_t: List[Tuple[Engine, EngineSeq, float]] = []
        for (src, seq, td) in self._parked_transfers:
            dec = self.kv_router.pick(req=seq.req)
            if dec is None:
                still_t.append((src, seq, td))
            else:
                self._start_transfer(src, seq, max(td, t), dec)
        self._parked_transfers = still_t

    def _rebalance(self, t: float) -> None:
        if self.controller is None:
            return
        self._flush(t)
        if self._parked_requests:
            self._provide("prefill", t)
        if self._parked_transfers:
            self._provide("decode", t)

    def _provide(self, role: str, t: float) -> None:
        """Guarantee future capacity for ``role``. Tried in order:
        capacity already coming (accepting / waking / a pending flip),
        cancel a same-role drain, wake a sleeping same-role instance,
        repurpose the OTHER role (flip a sleeping one, retarget a
        drain-to-sleep, or drain-to-flip the least-loaded accepting
        one). Finite work + this chain being re-run at every settle
        point is the liveness argument: parked work always has capacity
        on the way."""
        if self.controller is None:
            return

        def has_role(e):
            if self.spec.is_colocated:
                return True
            want_decode = role == "decode"
            return (e.role == "decode") == want_decode

        same = [e for e in self.engines if has_role(e)]
        other = [e for e in self.engines if not has_role(e)]
        for e in same:
            if e.accepting or self.lifecycle_state(e) == "wake":
                return
        for e in same:
            if e in self._draining:
                self.ctl_cancel_drain(e, t)
                self._flush(t)
                return
        for e in same:
            if self.lifecycle_state(e) in ("sleep", "absent"):
                self.ctl_wake(e, t)
                return
        for e in other:
            if self._draining.get(e) == "flip":
                return
        for e in other:
            if self.lifecycle_state(e) in ("sleep", "absent") \
                    and not e.pool.seqs and e._quiescent():
                if self.ctl_flip_asleep(e, t):
                    self.ctl_wake(e, t)
                    return
        for e in other:
            if self._draining.get(e) == "sleep":
                self._draining[e] = "flip"
                self._log(t, "retarget-flip", e)
                self._check_drains(t)
                return
        cands = [e for e in other
                 if e.accepting and e not in self._draining]
        if cands:
            victim = min(cands,
                         key=lambda e: (e.outstanding_tokens(), e.gidx))
            self.ctl_drain(victim, t, then="flip")

    # ---- controller tick scheduling ----------------------------------
    def _work_pending(self) -> bool:
        if self._pending_arrivals or self._parked_requests \
                or self._parked_transfers:
            return True
        return any(not e._quiescent() or e.pool.seqs
                   or getattr(e, "inflight_kv_pages", 0)
                   for e in self.engines)

    def _schedule_tick(self, t: float) -> None:
        def tick(t=t):
            self.controller.on_tick(self, t)
            self._check_drains(t)
            self._rebalance(t)
            if self._work_pending():
                self._schedule_tick(t + self.controller.spec.interval_s)

        self._push(t, tick)

    # ------------------------------------------------------------------
    def _run_loop(self, max_steps: int, fast: bool) -> int:
        """The discrete-event loop. With ``fast=False`` this is the
        retained exact reference: pick the min-clock engine with work,
        fire any heap event due at-or-before its clock first, step it
        once. With ``fast=True`` the same loop first offers the
        candidate set to ``repro.core.fastpath.coalesce_window``, which
        advances every steady-state-decode engine to the next
        interesting time in vectorized runs and returns 0 whenever the
        situation is non-uniform (prefill, fetch, admission, online
        governor, pool pressure) — in which case this loop takes one
        exact step, keeping the two steppers observably identical."""
        order = {e: i for i, e in enumerate(self.engines)}
        steps = 0
        stalled = set()   # engines that made no progress; wait for an event
        while steps < max_steps:
            steps += 1
            candidates = [e for e in self.engines
                          if e not in stalled and e.has_work()]
            t_next_event = self._events[0][0] if self._events else None
            if candidates:
                eng = min(candidates, key=lambda e: e.t)
                # <= so an arrival at exactly the engine's clock is
                # admitted before the step that starts at that instant
                if t_next_event is not None and t_next_event <= eng.t:
                    _, _, fn = heapq.heappop(self._events)
                    fn()
                    stalled.clear()
                    continue
                if fast:
                    n = coalesce_window(candidates, order, t_next_event)
                    if n:
                        self.coalesce_windows += 1
                        self.coalesced_steps += n
                        continue
                if eng.step():
                    # a settling engine may complete a pending drain
                    # (sleep or flip), which can free parked work
                    if self._draining and self._check_drains(eng.t):
                        stalled.clear()
                    # engines SHARING this engine's pool (the intra-gpu
                    # P/D slices) may have stalled on pages this step
                    # just freed — un-stall them, since no heap event
                    # marks an in-HBM free. A no-op for per-engine
                    # pools: a stalled engine never shares a pool with
                    # a progressing one there.
                    if stalled:
                        freed = {s for s in stalled
                                 if s.pool is eng.pool}
                        if freed:
                            stalled -= freed
                else:
                    # no progress (e.g. pool blocked by in-flight stores):
                    # park until the next event frees resources
                    stalled.add(eng)
                continue
            if self._events:
                _, _, fn = heapq.heappop(self._events)
                fn()
                stalled.clear()
                continue
            break
        return steps

    # ------------------------------------------------------------------
    def _power_segments(self, e: Engine, t_start: float, t_end: float
                        ) -> Optional[List[Tuple[float, float, str]]]:
        """Lifecycle segments of [t_start, t_end] for end-of-run power
        attribution, or None for an engine that was simply ON the whole
        run — in which case run() takes the legacy makespan-minus-busy
        branch VERBATIM, keeping static fleets (and the no-op
        controller) bit-identical to pre-controller accounting."""
        lc = self._lifecycle.get(e.name) if self.controller is not None \
            else None
        if lc is None or (len(lc) == 1 and lc[0][1] == "on"):
            return None
        out: List[Tuple[float, float, str]] = []
        for i, (t0, state) in enumerate(lc):
            t1 = lc[i + 1][0] if i + 1 < len(lc) else t_end
            s0, s1 = max(t0, t_start), min(t1, t_end)
            if s1 > s0:
                out.append((s0, s1, state))
        return out

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 2_000_000,
            stepper: Optional[str] = None) -> SetupResult:
        stepper = stepper or DEFAULT_STEPPER
        assert stepper in STEPPERS, stepper
        # the bail rule (DESIGN.md section 14): coalescing across a
        # controller's tick events would let fleet state change inside
        # a vectorized window, so controller-active runs take the exact
        # stepper unless the controller declares itself coalescible-
        # quiescent (only the no-op NullController does). Both steppers
        # therefore remain observably identical for every spec. A
        # tiered KV store bails the same way (DESIGN.md section 15):
        # submit-time lookups mutate cross-engine-visible residency and
        # inject tier-fetch occupancy mid-window, so coalescing across
        # them is unsound; flat shared reuse stays fast-eligible (its
        # lookups/inserts live entirely inside exact steps).
        # A non-coalescible SchedulerSpec (chunked-interleave / non-FCFS
        # admission, DESIGN.md section 17) bails identically: composed
        # steps and per-insert re-sorting break the uniform-run
        # precondition. The intra-gpu shape bails too — its two slices
        # share one pool, so a coalesced decode window would hide page
        # frees from the concurrently-stepping prefill slice.
        fast = stepper == "fast" \
            and (self.controller is None or self.controller.coalescible) \
            and not self.tiered \
            and (self.spec.scheduler is None
                 or self.spec.scheduler.coalescible) \
            and not self.spec.is_intra
        tr = self.tracer
        if tr.wall:
            tr.begin("cluster.run", requests=len(requests))
        self._warm_stores(requests)
        self.submit(requests)
        if self.controller is not None and self.controller.wants_ticks:
            self._schedule_tick(self.controller.spec.interval_s)
        steps = self._run_loop(max_steps, fast=fast)

        unfinished = [r for r in requests if not r.done]
        assert not unfinished, (
            f"{self.setup}: {len(unfinished)} requests never finished "
            f"after {steps} loop iterations (deadlock?)")

        t_start = min(r.arrival_s for r in requests)
        t_end = max(r.finish_s for r in requests)
        makespan = t_end - t_start
        # idle (static) accelerator power over the inference period; the
        # joule lump keeps the exact pre-trace arithmetic (parity
        # goldens), while fill_idle writes the same idle power into the
        # timeline gap-by-gap so each accelerator's power-state trace
        # covers the whole run span. An engine whose lifecycle left the
        # always-on state instead pays segment-by-segment: idle draw
        # only while ON, idle draw (stage "wake") while waking, the
        # sleep residual while ASLEEP, and nothing while ABSENT — the
        # honest attribution that lets scale-to-zero attack the floor.
        trace = self.meter.trace
        for e in self.engines:
            # power comes from the ENGINE's cost model: for every fleet
            # shape but intra-gpu that is self.cost (the same object —
            # bit-identical accounting); an intra slice pays its
            # SM-fraction share of the static floor, so the two slices
            # of one accelerator sum to exactly one accelerator's idle
            # draw (the honest denominator for the energy verdicts)
            segs = self._power_segments(e, t_start, t_end)
            if segs is None:
                idle_s = max(makespan - e.busy_s, 0.0)
                self.meter.add_power(e.name, e.cost.idle_power_w(),
                                     idle_s, stage="idle")
                if trace is not None:
                    trace.fill_idle(e.name, t_start, t_end,
                                    e.cost.idle_power_w())
                continue
            for s0, s1, state in segs:
                if state == "on":
                    filled = trace.fill_idle(e.name, s0, s1,
                                             e.cost.idle_power_w())
                    self.meter.add(e.name,
                                   e.cost.idle_power_w() * filled,
                                   stage="idle")
                elif state == "wake":
                    self.meter.add_power(e.name, e.cost.idle_power_w(),
                                         s1 - s0, stage="wake", t0=s0,
                                         state=IDLE)
                elif state == "sleep":
                    self.meter.add_power(e.name, e.cost.sleep_power_w(),
                                         s1 - s0, stage="sleep", t0=s0,
                                         state=SLEEP)
                else:   # absent: 0 W, explicit interval (never idle-filled)
                    self.meter.add_power(e.name, 0.0, s1 - s0,
                                         stage="absent", t0=s0,
                                         state=ABSENT)
        # host-node baseline draw (IPMI-style whole-node accounting)
        self.meter.add_power("cpu", self.host.cpu_idle_w, makespan, "idle",
                             t0=t_start)
        self.meter.add_power("dram", self.host.dram_idle_w, makespan,
                             "idle", t0=t_start)
        self.meter.add_power("disk", self.host.disk_idle_w, makespan,
                             "idle", t0=t_start)

        total_tokens = sum(r.prompt_len + r.generated for r in requests)
        if tr.wall:
            tr.end()
        return SetupResult(setup=self.setup, metrics=summarize(requests),
                           energy=self.meter, requests=requests,
                           makespan_s=makespan, total_tokens=total_tokens)
