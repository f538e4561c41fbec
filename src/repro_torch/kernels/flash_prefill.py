"""Flash attention for the prefill stage: the CUDA kernel's wrapper and
its plain torch version.

Prefill is the compute-bound stage (paper section II-A) and sets TTFT.
The kernel (``csrc/flash_prefill.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_prefill.py::_flash_kernel``; its header says what
bounds it on the H100 and how it is laid out. The wrapper takes the
plain version only for CPU tensors; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref as plain

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _i, _i, _i, _i, _i,
             _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll,
             _i, _i, _i, _p]


def check_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels read by strides with 16-byte vector loads: the last
    dim must be unit-stride and every other stride and the base address
    16-byte aligned."""
    es = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (s * es) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: needs a unit-stride last dim and 16-byte "
                       f"aligned base and strides, got strides "
                       f"{t.stride()}")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,S,H,hd], k/v [B,T,KV,hd]; "
                       f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                       f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                       f"match k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of one "
                      f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not built "
                       f"(built: {HEAD_DIMS})")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, T, KV, hd] -> [B, S, H, hd]."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window,
                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention: window and q_offset must be >= 0")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    launch = _build.launcher("flash_prefill", "flash_prefill_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), B, S, T, H, KV,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               int(causal), int(window), int(q_offset), stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
