"""Dispatch over the hand-written CUDA kernels and their plain versions.

Every model/engine call site goes through this module, and from here
through the kernels' operators (``torch.ops.repro_torch.*``,
``kernels/library.py``), which the dispatcher routes by device. Backends:

  auto  -> by the tensor's device: 'cuda' for a CUDA tensor, 'ref' for
           a CPU tensor, the operators' shapes for a meta tensor
  ref   -> plain torch (kernels/ref.py); CPU tensors only
  cuda  -> the hand-written CUDA kernel; CUDA tensors only

A CUDA tensor never reaches ``ref`` and a CPU tensor never reaches a
kernel: an explicit backend that does not match the device raises. A
DTensor's device is its mesh's; fake tensors (``FakeTensorMode``) take
their device's backend, and the operators give their shapes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import flash_prefill as _flash
from . import mamba2_ssd as _ssd
from . import paged_decode as _paged
from . import rwkv6_scan as _rwkv

BACKENDS = ("auto", "ref", "cuda")

# every kernel's launch counter: (the function that carries it, its name)
_COUNTERS = tuple((fn, name) for fn, names in (
    (_flash.flash_attention, ("launches", "backward_launches")),
    (_paged.paged_attention, ("launches",)),
    (_rwkv.rwkv6_scan, ("launches", "backward_launches",
                        "backward_chunked_launches")),
    (_ssd.mamba2_ssd, ("launches", "backward_launches",
                       "backward_chunked_launches")),
) for name in names)


def launch_counts() -> Tuple[int, ...]:
    """Every kernel's launch counter, in one fixed order."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def add_launches(delta: Sequence[int]) -> None:
    """Add ``delta``, a difference of two ``launch_counts()``, to the
    counters: a replayed CUDA graph launches again what its capture
    counted."""
    for (fn, name), d in zip(_COUNTERS, delta):
        setattr(fn, name, getattr(fn, name) + d)


def resolve_backend(backend: Optional[str], x: torch.Tensor) -> str:
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; one of {BACKENDS}")
    dev = x.device.type
    if b == "auto":
        b = {"cuda": "cuda", "cpu": "ref", "meta": "meta"}.get(dev, b)
    if (b, dev) not in (("ref", "cpu"), ("cuda", "cuda"), ("meta", "meta")):
        raise ValueError(f"kernel backend {b!r} does not take {dev} tensors")
    return b


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, backend: Optional[str] = None):
    resolve_backend(backend, q)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    backend: Optional[str] = None):
    resolve_backend(backend, q)
    return _paged.paged_attention(q, k_pages, v_pages, block_table, seq_lens)


# ----------------------------------------------------------------------
# recurrent scans (prefill) and their single-token steps (decode)
# ----------------------------------------------------------------------
def _pad_seq(x: torch.Tensor, chunk: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 up to a multiple of ``chunk`` with ``value``."""
    pad = (-x.shape[1]) % chunk
    if pad == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad], value=value)


def rwkv6(r, k, v, w, u, state, *, chunk: int = 64,
          backend: Optional[str] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's padding contract on both backends: T is padded to
    a multiple of ``chunk`` with w=1, k=0 (and r=v=0), which leaves the
    state as it is, and y is cut back to T. The kernel itself takes any
    T, so on the main path (T a multiple of the chunk) nothing is
    copied."""
    resolve_backend(backend, r)
    if state is None:
        B, _, NH, hd = r.shape
        state = torch.zeros((B, NH, hd, hd), dtype=torch.float32,
                            device=r.device)
    T = r.shape[1]
    rp, kp, vp = (_pad_seq(x, chunk) for x in (r, k, v))
    wp = _pad_seq(w, chunk, value=1.0)
    y, s = _rwkv.rwkv6_scan(rp, kp, vp, wp, u, state)
    return y[:, :T], s


def rwkv6_step(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step (decode), plain torch as in the
    reference. r..w: [B, NH, hd]; state: [B, NH, hd, hd] f32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    y = torch.einsum("bhc,bhcj->bhj", rf, state)
    y = y + (rf * (u.float()[None] * kf)).sum(-1, keepdim=True) * vf
    state = wf[..., :, None] * state + kf[..., :, None] * vf[..., None, :]
    return y.to(r.dtype), state


def mamba2(x, dt, A, B_mat, C_mat, D, state, *, chunk: int = 128,
           backend: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padding contract as for ``rwkv6``: dt=0 pads are a no-op (decay
    1, no input)."""
    resolve_backend(backend, x)
    if state is None:
        B, _, NH, P = x.shape
        state = torch.zeros((B, NH, B_mat.shape[-1], P),
                            dtype=torch.float32, device=x.device)
    T = x.shape[1]
    xp, dtp, Bp, Cp = (_pad_seq(t, chunk) for t in (x, dt, B_mat, C_mat))
    y, s = _ssd.mamba2_ssd(xp, dtp, A, Bp, Cp, D, state)
    return y[:, :T], s


def mamba2_step(x, dt, A, B_mat, C_mat, D, state
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSM step (decode), plain torch as in the reference.
    x: [B, NH, P]; dt: [B, NH]; B_mat/C_mat: [B, N]; state: [B, NH, N, P]."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A.float()[None] * dtf)                  # [B, NH]
    state = (decay[..., None, None] * state
             + B_mat.float()[:, None, :, None]
             * (dtf[..., None] * xf)[:, :, None, :])
    # a product and a sum, which DTensor shards without a reshape
    y = (state * C_mat.float()[:, None, :, None]).sum(2)
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state
