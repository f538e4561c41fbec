"""The dense family's paged decode step, replayed as CUDA graphs.

Eagerly, one decode step of the dense family enqueues about 74 device
operations a layer, and at serving's batch sizes the host's enqueue, not
the card, sets the step's time. ``DecodeGraphs`` captures the step
(``transformer.decode_step_paged``: the same kernels, math and dtypes)
once per row bucket and replays it after that, so that a step is a few
copies into the graph's inputs and one graph launch:

  row buckets  1, 2, 4, then multiples of 8 up to 256: a step of B rows
               runs in the smallest bucket >= B. The first step that
               needs a bucket captures it and every smaller one not yet
               captured, largest first, into one memory pool, after one
               eager warm-up on the capture stream.
  table width  the widest block table that the paged kernel walks as one
               run a row (``paged_decode.single_run_pages``), so that it
               does for the real rows what it does eagerly.
  padded rows  token 0 at position 0 (one key), and every block-table
               entry the pool's sink page (``DevicePagedKV.sink_page``),
               which the pool never grants: a padded row's K/V lands
               where no sequence reads.

A group of graphs is keyed by what its captures baked in: the table
width, the params (held, so that their id stays theirs), the K and V
pages' addresses, shapes and dtypes, and the perf flags. The kernels'
launch counters count the steps served: a replay adds what its capture
counted, and the warm-up and the captures add nothing. Every other step
runs eagerly, counted in ``GraphStats.eager`` by its reason:

  family   not the dense family (the moe family's routing)
  no_sink  the caller named no sink page
  dtensor  DTensors (a step on a mesh of many devices)
  device   tensors not on a CUDA device
  window   a sliding window (the eager step raises for it)
  rows     more rows than the largest bucket
  width    a block table wider than the single-run width
"""
from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import opt_flags
from repro_torch.kernels import ops, paged_decode

ROW_BUCKETS = (1, 2, 4) + tuple(range(8, 257, 8))
MAX_ROWS = ROW_BUCKETS[-1]


def bucket_for(rows: int) -> int:
    """The smallest bucket that holds ``rows`` rows (at most MAX_ROWS)."""
    return ROW_BUCKETS[bisect.bisect_left(ROW_BUCKETS, rows)]


def to_capture(rows: int, captured) -> List[int]:
    """The buckets that a step of ``rows`` rows captures: its own and
    every smaller one not in ``captured``, largest first."""
    top = bucket_for(rows)
    return [b for b in reversed(ROW_BUCKETS)
            if b <= top and b not in captured]


def table_width(k_pages: torch.Tensor) -> int:
    """The block-table width of the graphs over ``k_pages``
    ([L, P, page, KV, hd])."""
    return paged_decode.single_run_pages(
        k_pages.shape[2], k_pages.shape[4] * k_pages.element_size())


def eager_reason(cfg: ModelConfig, tokens: torch.Tensor,
                 k_pages: torch.Tensor, block_table: torch.Tensor,
                 sink_page: Optional[int]) -> Optional[str]:
    """Why a dense step of these inputs runs eagerly; None to replay."""
    if sink_page is None:
        return "no_sink"
    if any(isinstance(t, DTensor) for t in (tokens, k_pages, block_table)):
        return "dtensor"
    if k_pages.device.type != "cuda":
        return "device"
    if cfg.sliding_window:
        return "window"
    if tokens.shape[0] > MAX_ROWS:
        return "rows"
    if block_table.shape[1] > table_width(k_pages):
        return "width"
    return None


def pad_inputs(tokens: torch.Tensor, pos: torch.Tensor,
               block_table: torch.Tensor, bucket: int, sink_page: int,
               static: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fill the first ``bucket`` rows of the static inputs (tokens [R],
    positions [R], block table [R, W]) and return them: the real rows,
    then padded rows (token 0, position 0, the sink page); the table's
    entries past a real row's width name the sink too."""
    toks, ps, table = (t[:bucket] for t in static)
    B, w = block_table.shape
    toks[:B].copy_(tokens)
    toks[B:].zero_()
    ps[:B].copy_(pos)
    ps[B:].zero_()
    table.fill_(sink_page)
    table[:B, :w].copy_(block_table)
    return toks, ps, table


@dataclass
class GraphStats:
    """``Model.decode_step_paged``'s steps: graphs captured, steps
    replayed, eager steps by reason, and the last step's bucket (0 for
    an eager step)."""
    captures: int = 0
    replays: int = 0
    eager: Counter = field(default_factory=Counter)
    last: int = 0


def _uncounted(run: Callable[[int], torch.Tensor], b: int):
    """``run(b)`` with the launch counters set back after it: (its
    result, the launches it counted)."""
    before = ops.launch_counts()
    out = run(b)
    launches = tuple(a - c for a, c in zip(ops.launch_counts(), before))
    ops.add_launches([-n for n in launches])
    return out, launches


def _ident(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class _Group:
    """The graphs of one key, their static inputs, pool and stream."""

    def __init__(self, params, k_pages: torch.Tensor, width: int):
        dev = k_pages.device
        self.params = params            # held: the graphs read its tensors
        self.static = (
            torch.zeros(MAX_ROWS, dtype=torch.long, device=dev),
            torch.zeros(MAX_ROWS, dtype=torch.int32, device=dev),
            torch.zeros((MAX_ROWS, width), dtype=torch.int32, device=dev))
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        # bucket -> (graph, its logits [bucket, V], its launches)
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, torch.Tensor,
                                     Tuple[int, ...]]] = {}


class DecodeGraphs:
    """The paged decode steps of one model: replayed where the inputs
    allow (``eager_reason``), else ``step`` eagerly. ``step(params,
    tokens, k_pages, v_pages, block_table, pos)`` is the eager step."""

    def __init__(self, cfg: ModelConfig, step: Callable[..., torch.Tensor]):
        self.cfg = cfg
        self.step = step
        self.stats = GraphStats()
        self._groups: Dict[tuple, _Group] = {}

    def eager(self, why: str, *args) -> torch.Tensor:
        self.stats.eager[why] += 1
        self.stats.last = 0
        return self.step(*args)

    def __call__(self, params, tokens: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 pos: torch.Tensor, sink_page: Optional[int]
                 ) -> torch.Tensor:
        why = eager_reason(self.cfg, tokens, k_pages, block_table,
                           sink_page)
        if why:
            return self.eager(why, params, tokens, k_pages, v_pages,
                              block_table, pos)
        width = table_width(k_pages)
        key = (width, id(params), _ident(k_pages), _ident(v_pages),
               opt_flags.active())
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(params, k_pages, width)
        B = tokens.shape[0]
        bucket = bucket_for(B)
        if bucket not in group.graphs:
            self._capture(group, to_capture(B, group.graphs), k_pages,
                          v_pages, sink_page)
        graph, logits, launches = group.graphs[bucket]
        pad_inputs(tokens, pos, block_table, bucket, sink_page,
                   group.static)
        graph.replay()
        ops.add_launches(launches)
        self.stats.replays += 1
        self.stats.last = bucket
        return logits[:B].clone()

    def _capture(self, group: _Group, buckets: List[int],
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 sink_page: int) -> None:
        """Capture ``buckets`` (largest first) over the group's static
        inputs, every row padded, so that the warm-up writes the sink
        page alone. The launch counters count the steps served: they are
        set back after the warm-up and after each capture (which
        launches nothing), and each replay adds its launches. Not
        through the ``torch.cuda.graph`` context, which empties the
        device's and the pinned host memory's caches at each capture: a
        capture in a serving process would make its next handoffs
        allocate their buffers again."""
        toks, ps, table = group.static
        toks.zero_()
        ps.zero_()
        table.fill_(sink_page)

        def run(b):
            return self.step(group.params, toks[:b], k_pages, v_pages,
                             table[:b], ps[:b])
        cur = torch.cuda.current_stream(k_pages.device)
        group.stream.wait_stream(cur)
        with torch.cuda.stream(group.stream):
            if not group.graphs:  # cuBLAS and the launchers initialised
                _uncounted(run, buckets[0])
            for b in buckets:
                graph = torch.cuda.CUDAGraph()
                torch.cuda.synchronize(k_pages.device)
                graph.capture_begin(pool=group.pool,
                                    capture_error_mode="thread_local")
                try:
                    logits, launches = _uncounted(run, b)
                finally:
                    graph.capture_end()
                group.graphs[b] = (graph, logits, launches)
                self.stats.captures += 1
        cur.wait_stream(group.stream)
