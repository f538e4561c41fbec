"""Dispatch over the hand-written CUDA kernels and their plain versions.

Every model/engine call site goes through this module. Backends:

  auto  -> by the tensor's device: 'cuda' for a CUDA tensor, 'ref' for
           a CPU tensor
  ref   -> plain torch (kernels/ref.py); CPU tensors only
  cuda  -> the hand-written CUDA kernel; CUDA tensors only

A CUDA tensor never reaches ``ref`` and a CPU tensor never reaches a
kernel: an explicit backend that does not match the device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_prefill as _flash
from . import paged_decode as _paged
from . import ref

BACKENDS = ("auto", "ref", "cuda")


def resolve_backend(backend: Optional[str], x: torch.Tensor) -> str:
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; one of {BACKENDS}")
    dev = x.device.type
    if b == "auto":
        b = {"cuda": "cuda", "cpu": "ref"}.get(dev, b)
    if (b, dev) not in (("ref", "cpu"), ("cuda", "cuda")):
        raise ValueError(f"kernel backend {b!r} does not take {dev} tensors")
    return b


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, backend: Optional[str] = None):
    if resolve_backend(backend, q) == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    backend: Optional[str] = None):
    if resolve_backend(backend, q) == "ref":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       seq_lens)
    return _paged.paged_attention(q, k_pages, v_pages, block_table, seq_lens)
