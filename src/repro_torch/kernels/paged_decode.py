"""Paged attention for the decode stage: the CUDA kernel's wrapper and
its plain torch version.

Decode is the memory-bound stage (paper section II-A) and sets TPOT; the
paged KV cache is vLLM PagedAttention, the paper's serving system. The
kernel (``csrc/paged_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::_paged_kernel``; its header says what
bounds it on the H100 and how it is laid out. The wrapper takes the
plain version only for CPU tensors; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_prefill import HEAD_DIMS, _DTYPES, check_aligned
from .ref import paged_attention_ref as plain

MAX_GROUP = 8          # query heads per kv head the kernel holds

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
             _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _p]


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
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_table, seq_lens)
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("paged_decode", "paged_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_DTYPES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
               v_pages.data_ptr(), block_table.data_ptr(),
               seq_lens.data_ptr(), out.data_ptr(), B, H, KV, page,
               block_table.shape[1], q.stride(0), q.stride(1),
               *k_pages.stride()[:3], *v_pages.stride()[:3],
               block_table.stride(0), stream)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
