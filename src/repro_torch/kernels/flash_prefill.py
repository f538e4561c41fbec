"""Flash attention for the prefill stage and for training: the CUDA
kernels' wrappers and their plain torch version.

Prefill is the compute-bound stage (paper section II-A) and sets TTFT.
The forward kernel (``csrc/flash_prefill.cu``) replaces the Pallas TPU
kernel ``repro/kernels/flash_prefill.py::_flash_kernel``. The backward
kernel (``csrc/flash_backward.cu``) has no Pallas counterpart: the
reference trains through ``jax.value_and_grad`` of the plain version.
Each header says what bounds the kernel on the H100 and how it is laid
out.

Each launch is an operator of the ``repro_torch`` library
(``kernels/library.py``): ``flash_fwd``, ``flash_fwd_lse`` and
``flash_bwd``. An operator runs the plain version for CPU tensors (for
the gradient, autograd of it), launches the kernel or raises for CUDA
tensors, and gives only shapes for meta and fake ones. ``flash_attention``
goes through the ``FlashAttention`` autograd Function (the forward
operator, then the backward one) only when grad is enabled and an input
requires it (on a real CPU tensor, ``library.on_host``, autograd of the
plain version itself); otherwise it calls the forward operator alone, as
serving does. Under grad the forward also keeps each query row's log-sum-exp
(``flash_attention_with_lse``), which the backward kernel reads instead
of recomputing it. ``flash_attention.launches`` counts the forward
kernel's launches, ``flash_attention.backward_launches`` the backward's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from . import _build
from .library import define, divides, eager_autograd, fresh, on_host
from .ref import flash_attention_lse_ref as plain_lse
from .ref import flash_attention_ref as plain

HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _i, _i, _i, _i, _i,
             _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll,
             _i, _i, _i, _p]
_LSE_ARGTYPES = [*_ARGTYPES[:-1], _p, _p]
_BWD_ARGTYPES = [_i, _i, *[_p] * 10, _i, _i, _i, _i, _i, _i, _i, _i, _p]


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


def no_backward(name: str, *tensors) -> None:
    """A kernel with no backward yet raises under grad, on every device,
    instead of returning an output outside the autograd graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward yet, so it "
                           f"cannot run on tensors that require grad (run "
                           f"it under torch.no_grad())")


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        if on_host(q):
            return plain(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_fwd(q, k, v, causal, window, q_offset)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and each query row's log-sum-exp of
    its visible scores in the log2 domain, [B, H, S] f32 (0 for a row
    that sees no key): what the backward kernel reads. On CUDA tensors
    one launch of the forward kernel (counted in
    ``flash_attention.launches``), outside autograd."""
    return flash_fwd_lse(q, k, v, causal, window, q_offset)


def _padded_rows(S: int) -> int:
    """The kernels' lse and D hold S rounded up to 64 rows a head."""
    return -(-S // 64) * 64


def _forward(q, k, v, causal: bool, window: int, q_offset: int,
             with_lse: bool = False):
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention: window and q_offset must be >= 0")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, _padded_rows(S)), dtype=torch.float32,
                      device=q.device)[..., :S] if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    args = (_DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, T, H, KV, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
            int(q_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if with_lse:
            _build.launcher("flash_prefill", "flash_prefill_fwd_lse",
                            _LSE_ARGTYPES)(*args, lse.data_ptr(), stream)
        else:
            _build.launcher("flash_prefill", "flash_prefill_fwd",
                            _ARGTYPES)(*args, stream)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def backward_route(dtype: torch.dtype) -> str:
    """Which kernels ``flash_attention_backward`` runs for ``dtype``."""
    return {torch.bfloat16: "wgmma", torch.float32: "CUDA cores"}[dtype]


def _kernel_lse(lse, B: int, H: int, S: int, device) -> torch.Tensor:
    """``lse`` [B, H, S] f32 as the kernel reads it: [B, H, Sp] storage,
    rows past S unused; copied only when it is not laid out so."""
    if lse is None:
        raise ValueError("flash_attention backward: on CUDA tensors it "
                         "needs the forward's lse (flash_attention_with_lse)")
    Sp = _padded_rows(S)
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or \
            lse.device != device:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"[{B}, {H}, {S}] on {device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if lse.stride() != (H * Sp, Sp, 1) or lse.data_ptr() % 16:
        padded = torch.zeros((B, H, Sp), dtype=torch.float32, device=device)
        padded[..., :S] = lse
        lse = padded
    return lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *,
                             lse: Optional[torch.Tensor] = None,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` whose output is
    ``out`` and log-sum-exp ``lse`` (both from
    ``flash_attention_with_lse``), for the output gradient ``dout``, in
    q's dtype. On CPU tensors: autograd of the plain version (``out`` and
    ``lse`` unused)."""
    return flash_bwd(q, k, v, out, dout, lse, causal, window, q_offset)


def _backward_cpu(q, k, v, out, dout, lse, causal, window, q_offset):
    with eager_autograd(), torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = plain(*qkv, causal=causal, window=window, q_offset=q_offset)
        grads = torch.autograd.grad(o, qkv, dout)
    return fresh([g.contiguous() for g in grads], (q, k, v, out, dout))


def _backward_cuda(q, k, v, out, dout, lse, causal, window, q_offset):
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    _check(q, k, v)
    if window < 0 or q_offset < 0:
        raise ValueError("flash_attention: window and q_offset must be >= 0")
    if out.shape != q.shape or dout.shape != q.shape or \
            dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: out and dout must be "
                       f"{q.dtype} of q's shape {tuple(q.shape)}")
    for name, t in (("out", out), ("dout", dout)):
        check_aligned(name, t)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if S == 0 or T == 0 or B * H == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = _kernel_lse(lse, B, H, S, q.device)
    delta = torch.empty((B, H, _padded_rows(S)), dtype=torch.float32,
                        device=q.device)
    launch = _build.launcher("flash_backward", "flash_attention_bwd",
                             _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_DTYPES[q.dtype], hd, *(t.data_ptr() for t in (
            q, k, v, out, dout, dq, dk, dv, lse, delta)),
            B, S, T, H, KV, int(causal), int(window), int(q_offset), stream)
    flash_attention.backward_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out, lse = flash_fwd_lse(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_bwd(q, k, v, out, dout, lse, causal, window,
                               q_offset)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention.backward_launches = 0


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """(query row, key) pairs the mask lets through, as in
    ``ref._flash_logits``: key t is seen by row i when t <= i + q_offset
    (causal) and t > i + q_offset - window (window > 0)."""
    qpos = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, T) if causal else np.full(S, T)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(S)
    return int(np.maximum(hi - lo, 0).sum())


def _fwd_flops(q, k, v, causal, window, q_offset, *, out_shape=None,
               **_) -> int:
    # QK^T and PV over the visible pairs: 2 products x 2 flops a
    # multiply-add x hd, for each (batch, query head, visible pair)
    B, S, H, hd = q
    return 4 * B * H * hd * visible_pairs(S, k[1], causal, window, q_offset)


def _bwd_flops(q, k, v, out, dout, lse, causal, window, q_offset, *,
               out_shape=None, **_) -> int:
    # QK^T recomputed, then dV = P^T dO, dP = dO V^T, dQ = dS K and
    # dK = dS^T Q: 5 products over the visible pairs
    B, S, H, hd = q
    return 10 * B * H * hd * visible_pairs(S, k[1], causal, window,
                                           q_offset)


def _fwd_rule(q, k, v, causal, window, q_offset, lse: bool):
    """Replicated; batch on dim 0; heads on dim 2 (lse: dim 1) where the
    query and kv head counts divide every mesh dim."""
    static = [None] * 3
    out = (lambda p, lp: [p, lp]) if lse else (lambda p, lp: [p])
    R, S0 = Replicate(), Shard(0)
    rules = [(out(R, R), [R, R, R, *static]),
             (out(S0, S0), [S0, S0, S0, *static])]
    if divides(q, q.shape[2], k.shape[2]):
        S2 = Shard(2)
        rules.append((out(S2, Shard(1)), [S2, S2, S2, *static]))
    return rules


def _bwd_rule(q, k, v, out, dout, lse, causal, window, q_offset):
    static = [None] * 3
    R, S0 = Replicate(), Shard(0)
    lse_pl = (lambda p: p) if lse is not None else (lambda p: None)
    rules = [([R] * 3, [R] * 5 + [lse_pl(R), *static]),
             ([S0] * 3, [S0] * 5 + [lse_pl(S0), *static])]
    if divides(q, q.shape[2], k.shape[2]):
        S2 = Shard(2)
        rules.append(([S2] * 3, [S2] * 5 + [lse_pl(Shard(1)), *static]))
    return rules


def _lse_like(q: torch.Tensor) -> torch.Tensor:
    """The lse's layout: [B, H, S] f32, on the card a view of S rounded
    up to 64 rows (``_forward``), else contiguous."""
    B, S, H, _ = q.shape
    rows = _padded_rows(S) if q.device.type == "cuda" else S
    return q.new_empty((B, H, rows), dtype=torch.float32)[..., :S]


_MASK_ARGS = "bool causal, int window, int q_offset"

flash_fwd = define(
    f"flash_fwd(Tensor q, Tensor k, Tensor v, {_MASK_ARGS}) -> Tensor",
    cpu=lambda q, k, v, causal, window, q_offset: fresh([plain(
        q, k, v, causal=causal, window=window,
        q_offset=q_offset).contiguous()], (q, k, v))[0],
    cuda=lambda q, k, v, causal, window, q_offset: _forward(
        q, k, v, causal, window, q_offset),
    fake=lambda q, k, v, causal, window, q_offset: torch.empty_like(
        q, memory_format=torch.contiguous_format),
    flops=_fwd_flops,
    sharding=functools.partial(_fwd_rule, lse=False))

flash_fwd_lse = define(
    f"flash_fwd_lse(Tensor q, Tensor k, Tensor v, {_MASK_ARGS}) "
    f"-> (Tensor, Tensor)",
    cpu=lambda q, k, v, causal, window, q_offset: fresh([
        plain(q, k, v, causal=causal, window=window,
              q_offset=q_offset).contiguous(),
        plain_lse(q, k, causal=causal, window=window,
                  q_offset=q_offset).contiguous()], (q, k, v)),
    cuda=lambda q, k, v, causal, window, q_offset: _forward(
        q, k, v, causal, window, q_offset, with_lse=True),
    fake=lambda q, k, v, causal, window, q_offset: (
        torch.empty_like(q, memory_format=torch.contiguous_format),
        _lse_like(q)),
    flops=_fwd_flops,
    sharding=functools.partial(_fwd_rule, lse=True))

flash_bwd = define(
    f"flash_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, "
    f"Tensor? lse, {_MASK_ARGS}) -> (Tensor, Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda q, k, v, *_: tuple(
        torch.empty_like(t, memory_format=torch.contiguous_format)
        for t in (q, k, v)),
    flops=_bwd_flops, sharding=_bwd_rule)
