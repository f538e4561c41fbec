"""Paged attention for the decode stage: the CUDA kernel's wrapper, its
split plan and its plain torch version.

Decode is the memory-bound stage (paper section II-A) and sets TPOT; the
paged KV cache is vLLM PagedAttention, the paper's serving system. The
kernel (``csrc/paged_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::_paged_kernel`` and is split-KV: each
row's page walk is cut into runs of whole pages (``split_plan``, from
sizes the host knows, never from ``seq_lens``, which lives on the card),
one block per (run, kv head, sequence), and the last run of a row to
finish merges the runs' partial softmax states in the same launch. Its
header says what bounds it on the H100 and how it is laid out. The
launch is the operator ``repro_torch::paged_attention``
(``kernels/library.py``): the plain version for CPU tensors, the kernel
(or a raise) for CUDA tensors, shapes only for meta and fake ones. It
has no backward, on any device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from . import _build
from .flash_prefill import _DTYPES, check_aligned, no_backward
from .library import define, divides, fresh
from .ref import paged_attention_ref as plain

HEAD_DIMS = (32, 64, 128)   # a multiple of 32: each lane holds hd/32 dims
MAX_GROUP = 8               # query heads per kv head the kernel holds

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
             _i, _i, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _p]

# The split plan. The kernel runs one block per SM (its cp.async rings
# fill the shared memory), and a block's start and the merge of partials
# cost about as much as streaming a few hundred KB, so a row is split
# only when its K and V for one kv head exceed MAX_SPLIT_BYTES; a row
# split anyway (the merges are paid then) is cut into runs for about
# FILL_PER_SM blocks per SM over the batch, fine enough to balance
# ragged batches: never below MIN_SPLIT_TOKENS a run, and at most
# MAX_SPLIT_PAGES pages (the kernel's shared-memory slice of the block
# table) or MAX_SPLITS runs (the partials its merge weighs) a row. Tuned
# on the H100 (PERF.md).
MAX_SPLIT_BYTES = 640 << 10
FILL_PER_SM = 0.5
MIN_SPLIT_TOKENS = 64
MAX_SPLIT_PAGES = 256
MAX_SPLITS = 512


def _min_run_pages(page: int) -> int:
    return max(1, -(-MIN_SPLIT_TOKENS // page))


def single_run_pages(page: int, row_bytes: int) -> int:
    """The widest block table that ``split_plan`` walks as one run a row
    (K and V of a kv head within MAX_SPLIT_BYTES, at most
    MAX_SPLIT_PAGES pages): 80 pages for bf16 at hd 128 and page 16."""
    return max(_min_run_pages(page),
               min(MAX_SPLIT_PAGES, MAX_SPLIT_BYTES // (2 * row_bytes * page)))


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, KV: int, max_pages: int, page: int, row_bytes: int,
               sms: int) -> Tuple[int, int]:
    """(splits, split_pages): each block-table row of ``max_pages`` pages
    is walked as ``splits`` runs of ``split_pages`` whole pages (the last
    run may be shorter; none is empty), one block per run, kv head and
    sequence. ``row_bytes``: one K row of one kv head (hd x element
    size). Host-known sizes only: the lengths are on the card."""
    if max_pages <= 0:
        return 1, 1
    lo = _min_run_pages(page)
    hi = single_run_pages(page, row_bytes)
    splits = -(-max_pages // hi)                 # runs the bytes ask for
    if splits > 1:
        splits = max(splits, min(round(FILL_PER_SM * sms / (B * KV)),
                                 -(-max_pages // lo)))
    split_pages = max(-(-max_pages // splits), -(-max_pages // MAX_SPLITS))
    if split_pages > MAX_SPLIT_PAGES:
        raise ValueError(f"paged_attention: {max_pages} pages a row is over "
                         f"the kernel's {MAX_SPLITS * MAX_SPLIT_PAGES}")
    return -(-max_pages // split_pages), split_pages


_sms: Dict[int, int] = {}
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _ticket_counters(device: torch.device, stream: int, n: int):
    """B*KV int32 counters, zero between calls (the kernel resets the ones
    it uses), kept per device and stream: zeroed once, grown on demand."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=device)
    return t


def _check(q, k_pages, v_pages, block_table, seq_lens):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q [B,H,hd], pages "
                       f"[P,page,KV,hd]; got {tuple(q.shape)}, "
                       f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != hd or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                       f"match pages {tuple(k_pages.shape)} (at most "
                       f"{MAX_GROUP} query heads per kv head)")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: float32 or bfloat16 q/pages of "
                      f"one dtype, got {q.dtype}, {k_pages.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {hd} is not built "
                       f"(built: {HEAD_DIMS})")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32 \
            or block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise TypeError("paged_attention: block_table [B, max_pages] and "
                      "seq_lens [B], both int32")
    if block_table.stride(1) != 1 or not seq_lens.is_contiguous():
        raise ValueError("paged_attention: block_table rows and seq_lens "
                       "must be contiguous")
    if len({t.device for t in (q, k_pages, v_pages, block_table,
                             seq_lens)}) != 1:
        raise ValueError("paged_attention: inputs on different devices")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        check_aligned(name, t)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  seq_lens: torch.Tensor) -> torch.Tensor:
    """q: [B, H, hd]; k_pages/v_pages: [P, page, KV, hd];
    block_table: [B, max_pages] int32; seq_lens: [B] int32 -> [B, H, hd].
    Lengths past ``max_pages * page`` are clamped to it."""
    no_backward("paged_attention", q, k_pages, v_pages)
    return paged_op(q, k_pages, v_pages, block_table, seq_lens)


def _launch(q, k_pages, v_pages, block_table, seq_lens):
    _check(q, k_pages, v_pages, block_table, seq_lens)
    B, H, hd = q.shape
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    page, KV = k_pages.shape[1], k_pages.shape[2]
    splits, split_pages = split_plan(B, KV, block_table.shape[1], page,
                                     hd * q.element_size(),
                                     _sm_count(q.device))
    launch = _build.launcher("paged_decode", "paged_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = tickets = None
        if splits > 1:   # partials, from the caching allocator
            ws = torch.empty((B, KV, splits, H // KV, hd + 2),
                             dtype=torch.float32, device=q.device)
            tickets = _ticket_counters(q.device, stream, B * KV)
        launch(_DTYPES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), block_table.data_ptr(),
               seq_lens.data_ptr(), out.data_ptr(),
               None if ws is None else ws.data_ptr(),
               None if tickets is None else tickets.data_ptr(), B, H, KV,
               page, block_table.shape[1], splits, split_pages, q.stride(0),
               q.stride(1), *k_pages.stride()[:3], *v_pages.stride()[:3],
               block_table.stride(0), stream)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# ----------------------------------------------------------------------
# the operator
# ----------------------------------------------------------------------
def _flops(q, k_pages, v_pages, block_table, seq_lens, *, out_shape=None,
           **_) -> int:
    # q.K and p.V over the block table's width (max_pages x page keys; the
    # lengths live on the card, so the formula counts the table's width):
    # 2 products x 2 flops a multiply-add x hd, for each (sequence, head)
    B, H, hd = q
    return 4 * B * H * hd * block_table[1] * k_pages[1]


def _rule(q, k_pages, v_pages, block_table, seq_lens):
    """Replicated; batch on dim 0 (the pool replicated, since any row's
    table may name any page); heads on q's dim 1 and the pool's dim 2
    where the head counts divide every mesh dim."""
    R, S0 = Replicate(), Shard(0)
    rules = [([R], [R] * 5), ([S0], [S0, R, R, S0, S0])]
    if divides(q, q.shape[1], k_pages.shape[2]):
        rules.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), R, R]))
    return rules


paged_op = define(
    "paged_attention(Tensor q, Tensor k_pages, Tensor v_pages, "
    "Tensor block_table, Tensor seq_lens) -> Tensor",
    cpu=lambda q, k_pages, v_pages, block_table, seq_lens: fresh(
        [plain(q, k_pages, v_pages, block_table, seq_lens).contiguous()],
        (q, k_pages, v_pages))[0],
    cuda=_launch,
    fake=lambda q, *_: torch.empty_like(
        q, memory_format=torch.contiguous_format),
    flops=_flops, sharding=_rule)
