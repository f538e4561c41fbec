"""The measured window: the port's own serving entry, driven by waves.

Each wave is one ``make_cluster(setup, cfg, executor_factory=...)`` and
one ``FleetCluster.run(requests)``, its requests all released at once.
The executors are the port's ``RealExecutor``s over one
``DevicePagedKV`` made at set-up (none for a recurrent family); the
cluster orders their calls on its simulated clock, and this module
times them on the host's:

  prefill       RealExecutor.prefill
  store         RealExecutor.store + the transfer path's store
  fetch         the transfer path's fetch, and RealExecutor.fetch
  decode_batch  RealExecutor.decode_batch

Every span ends in ``torch.cuda.synchronize()`` (a no-op on the CPU), so
it holds the device work it launched. A request's tokens are stamped
when the call that produced them returns: the first at the end of its
prefill (colocated) or of its fetch (disaggregated), the others at the
end of each decode step. For the correctness check the wrappers keep
what the program produced: each prefill's logits, the largest logit of
each decode row, and, for a sample of handoffs drawn from the seed, a
copy of the payload before the store to hold against the one fetched.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import traffic as T

PAGE = 16                          # the port's KV page size


@dataclass
class Span:
    kind: str
    t0: float
    t1: float
    req: Optional[int] = None
    tokens: int = 0               # prefill: its context length
    ctxs: Optional[List[int]] = None   # decode: each row's context


@dataclass
class Rec:
    req: int
    wave: int
    prompt: np.ndarray
    output_len: int
    release: float
    stamps: List[float] = field(default_factory=list)   # every token
    prefill_logits: Any = None
    tops: List[Any] = field(default_factory=list)      # (step, row) refs
    served: List[int] = field(default_factory=list)

    @property
    def first(self) -> float:
        return self.stamps[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


class Bench:
    """What one run records, and the hooks the wrappers call."""

    def __init__(self, device, probe_every: int, seed: int):
        self.device = device
        self.spans: List[Span] = []
        self.recs: Dict[int, Rec] = {}
        self.decode_tops: List[tuple] = []     # (req ids, tensor [B])
        self.handoff_diffs: List[int] = []     # differing bytes, probed
        self.deadline = float("inf")
        self.trace_from = float("inf")
        self.on_open: Optional[Callable[[], None]] = None
        self.on_close: Optional[Callable[[], None]] = None
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.probe_every = probe_every
        self.probe_at = 0
        self.rng = np.random.default_rng([seed, 7])
        self._probe: Dict[int, List[torch.Tensor]] = {}
        self._store: Optional[tuple] = None
        self._handle_req: Dict[int, int] = {}
        self._batch_ids: List[int] = []

    def tick(self) -> float:
        """Called as each wrapped call begins: opens the traced part of
        the window at the first call boundary past ``trace_from``, and
        closes the window at the first past the deadline."""
        now = time.perf_counter()
        if self.t_open is None and now >= self.trace_from:
            self.t_open = now
            if self.on_open is not None:
                self.on_open()
        if self.t_close is None and now >= self.deadline:
            self.t_close = time.perf_counter()
            if self.t_open is None:
                self.t_open = self.t_close
            if self.on_close is not None:
                self.on_close()
        return time.perf_counter()

    def span(self, kind, t0, t1, **kw) -> None:
        self.spans.append(Span(kind, t0, t1, **kw))


class ModelProxy:
    """The port's ``Model``, with each decode step's row maxima kept."""

    def __init__(self, model, bench: Bench):
        self._model, self._bench = model, bench

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _keep(self, logits):
        self._bench.decode_tops.append(
            (list(self._bench._batch_ids), logits.max(dim=-1).values))
        return logits

    def decode_step_paged(self, *a, **kw):
        return self._keep(self._model.decode_step_paged(*a, **kw))

    def decode_step(self, *a, **kw):
        logits, state = self._model.decode_step(*a, **kw)
        return self._keep(logits), state


class TimedExecutor:
    """A ``RealExecutor`` whose calls are spans of the run."""

    def __init__(self, inner, bench: Bench):
        self.inner, self.b = inner, bench

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill(self, seq):
        t0 = self.b.tick()
        out = self.inner.prefill(seq)
        _sync(self.b.device)
        t1 = time.perf_counter()
        rec = self.b.recs[seq.req.req_id]
        self.b.span("prefill", t0, t1, req=rec.req,
                    tokens=int(seq.prefill_target))
        rec.prefill_logits = out[1][0]
        rec.stamps = [t1]               # the first token, if colocated
        return out

    def store(self, seq):
        t0 = self.b.tick()
        payload = self.inner.store(seq)
        req = seq.req.req_id
        if req % self.b.probe_every == self.b.probe_at:
            self.b._probe[req] = [t.clone() for t in _tensors(payload)]
        self.b._store = (req, t0)
        return payload

    def fetch(self, handle):
        t0 = self.b.tick()
        req = self.b._handle_req.pop(id(handle))
        out = self.inner.fetch(handle)
        _sync(self.b.device)
        t1 = time.perf_counter()
        self.b.span("fetch", t0, t1, req=req)
        self.b.recs[req].stamps = [t1]  # disaggregated: the first token
        return out

    def release(self, seq):
        return self.inner.release(seq)

    def decode_batch(self, batch):
        t0 = self.b.tick()
        ids = [s.req.req_id for s in batch]
        ctxs = [int(s.ctx) for s in batch]
        self.b._batch_ids = ids
        self.inner.decode_batch(batch)
        _sync(self.b.device)
        t1 = time.perf_counter()
        self.b.span("decode_batch", t0, t1, ctxs=ctxs)
        step = len(self.b.decode_tops) - 1
        for i, r in enumerate(ids):
            rec = self.b.recs[r]
            rec.stamps.append(t1)
            rec.tops.append((step, i))


class TimedPath:
    """A transfer path whose store and fetch are spans of the run; the
    store's span began with ``RealExecutor.store`` (the cluster calls
    ``path.store(executor.store(seq))``)."""

    def __init__(self, inner, bench: Bench):
        self.inner, self.b = inner, bench

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def store(self, state):
        req, t0 = self.b._store
        handle = self.inner.store(state)
        _sync(self.b.device)
        t1 = time.perf_counter()
        self.b.span("store", t0, t1, req=req)
        self.b._handle_req[id(handle)] = req    # held by the cluster
        return handle

    def fetch(self, handle):
        t0 = self.b.tick()
        req = self.b._handle_req.pop(id(handle))
        payload = self.inner.fetch(handle)
        _sync(self.b.device)
        t1 = time.perf_counter()
        self.b.span("fetch", t0, t1, req=req)
        before = self.b._probe.pop(req, None)
        if before is not None:
            after = _tensors(payload)
            diff = sum(int((bits(a) != bits(b)).sum())
                       for a, b in zip(after, before)) \
                if len(after) == len(before) and all(
                    a.shape == b.shape and a.dtype == b.dtype
                    for a, b in zip(after, before)) \
                else sum(t.numel() * t.element_size() for t in before)
            self.b.handoff_diffs.append(diff)
        self.b._handle_req[id(payload)] = req
        return payload


# ----------------------------------------------------------------------
# waves
# ----------------------------------------------------------------------
@dataclass
class Server:
    """What every wave of a run shares: the model, its weights, the KV
    pool, and the cluster's settings."""
    cfg: Any                      # the port's ModelConfig
    model: Any                    # the port's Model
    params: Any
    kv: Any                       # DevicePagedKV or None
    setup: str

    def cluster(self, bench: Bench):
        from repro_torch.core import RealExecutor, make_cluster
        proxy = ModelProxy(self.model, bench)

        def factory(path):
            return TimedExecutor(RealExecutor(proxy, self.params, self.kv,
                                              transfer_path=path), bench)
        # the simulated pool that admits requests is the real one
        kw = {} if self.kv is None else {"pool_bytes": float(
            self.kv.pool.num_pages * PAGE * self.cfg.kv_bytes_per_token())}
        cl = make_cluster(self.setup, self.cfg, executor_factory=factory,
                          **kw)
        timed = {key: TimedPath(p, bench)
                 for key, p in cl._pair_paths.items()}
        cl._pair_paths = timed
        cl.paths = {k: timed[(k[0], cl.spec.n_prefill + k[1])]
                    for k in cl.paths}
        cl.path = next(iter(timed.values())) if len(timed) == 1 else None
        return cl


def make_server(cfg, model, params, traffic, setup: str, device) -> Server:
    """The server of a cell; for a paged family with the KV pool made
    once at the wave's worst case (every request at the longest prompt
    and output, and the executor's two tokens of room), as a deployment
    fixes its pool."""
    kv = None
    if model.paged:
        from repro_torch.core import DevicePagedKV, PagedKVPool
        from repro_torch.models.layers import dtype_of
        max_p, max_o = T.longest(traffic)
        pages = int(traffic["wave"]) * -(-(max_p + max_o + 2) // PAGE)
        kv = DevicePagedKV(PagedKVPool(pages, PAGE), cfg.num_layers,
                           cfg.num_kv_heads, cfg.head_dim,
                           dtype=dtype_of(cfg.compute_dtype), device=device)
    return Server(cfg, model, params, kv, setup)


def requests(draws: List[T.Draw], first_id: int):
    from repro_torch.core import Request
    return [Request(req_id=first_id + i, prompt_len=d.prompt_len,
                    output_len=d.output_len, arrival_s=0.0,
                    prompt_tokens=d.tokens) for i, d in enumerate(draws)]


def run_wave(server: Server, bench: Bench, draws: List[T.Draw],
             wave_index: int) -> None:
    reqs = requests(draws, wave_index * len(draws))
    cl = server.cluster(bench)
    bench.probe_at = int(bench.rng.integers(bench.probe_every))
    t_release = time.perf_counter()
    for r, d in zip(reqs, draws):
        bench.recs[r.req_id] = Rec(r.req_id, wave_index, d.tokens,
                                   d.output_len, t_release)
    res = cl.run(reqs)
    if res.metrics.total_evictions:
        raise RuntimeError(f"{res.metrics.total_evictions} preemptions: "
                           "the KV pool is smaller than the wave needs")
    for r in reqs:
        bench.recs[r.req_id].served = list(r.output_tokens)
    if server.kv is not None and server.kv.pool.used_pages:
        raise RuntimeError("pages left in the KV pool after a wave")
