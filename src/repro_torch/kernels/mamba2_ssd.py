"""Mamba2 SSD scan for prefill: the CUDA kernel's wrapper and its plain
torch version.

zamba2-2.7b's backbone runs this recurrence in each of its 54 Mamba2
layers at prefill; the final states are the fixed-size part of its
handoff to decode. The kernel (``csrc/mamba2_ssd.cu``) replaces the
Pallas TPU kernel ``repro/kernels/mamba2_ssd.py::_ssd_kernel``; its
header says what bounds it on the H100 and how it is laid out. For bf16
at zamba2's shape (N 64, P a multiple of 64) it runs the chunked SSD
form on the tensor cores in chunks of its own (64 steps, whatever chunk
the caller pads to); f32 and other shapes scan step by step. Both mask
their ragged tail, so it takes any T. One call is one launch. The
wrapper takes the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .flash_prefill import _DTYPES, no_backward
from .ref import mamba2_ssd_ref as plain

STATE_DIMS = (16, 32, 64, 128)
COLS = 16          # state columns per block: P must be a multiple

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
             *[_ll] * 10, _p]


def _check(x, dt, A, B_mat, C_mat, D, state):
    if x.dim() != 4 or dt.dim() != 3 or B_mat.dim() != 3 \
            or B_mat.shape != C_mat.shape:
        raise ValueError(f"mamba2_ssd: x [B,T,NH,P], dt [B,T,NH], B/C "
                         f"[B,T,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B_mat.shape)}, {tuple(C_mat.shape)}")
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    if tuple(dt.shape) != (Bsz, T, NH) or tuple(B_mat.shape[:2]) != (Bsz, T) \
            or tuple(A.shape) != (NH,) or tuple(D.shape) != (NH,):
        raise ValueError(f"mamba2_ssd: dt {tuple(dt.shape)}, B/C "
                         f"{tuple(B_mat.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} do not match x {tuple(x.shape)}")
    if tuple(state.shape) != (Bsz, NH, N, P):
        raise ValueError(f"mamba2_ssd: state [B,NH,N,P] = "
                         f"{(Bsz, NH, N, P)}, got {tuple(state.shape)}")
    if not (x.dtype == B_mat.dtype == C_mat.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"mamba2_ssd: float32 or bfloat16 x/B/C of one "
                        f"dtype, got {x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if dt.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"mamba2_ssd: dt and state must be float32, got "
                        f"{dt.dtype}, {state.dtype}")
    if N not in STATE_DIMS or P % COLS:
        raise ValueError(f"mamba2_ssd: state dim {N} (built: {STATE_DIMS}) "
                         f"and head dim {P} (a multiple of {COLS})")
    if len({t.device for t in (x, dt, A, B_mat, C_mat, D, state)}) != 1:
        raise ValueError("mamba2_ssd: inputs on different devices")
    if any(t.stride(-1) != 1 for t in (x, B_mat, C_mat)):
        raise ValueError("mamba2_ssd: x, B_mat, C_mat need a unit-stride "
                         "last dim")


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B_mat: torch.Tensor, C_mat: torch.Tensor,
               D: Optional[torch.Tensor] = None,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, NH, P]; dt: [B, T, NH] f32; A, D: [NH]; B_mat, C_mat:
    [B, T, N] in x's dtype; state: [B, NH, N, P] f32 (default zeros) ->
    (y [B, T, NH, P] in x's dtype, final state f32)."""
    if x.device.type == "cpu":
        return plain(x, dt, A, B_mat, C_mat, D, state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: no kernel for {x.device}")
    no_backward("mamba2_ssd", x, dt, A, B_mat, C_mat, D, state)
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    if state is None:
        state = torch.zeros((Bsz, NH, N, P), dtype=torch.float32,
                            device=x.device)
    if D is None:
        D = torch.zeros(NH, dtype=torch.float32, device=x.device)
    _check(x, dt, A, B_mat, C_mat, D, state)
    state = state.contiguous()
    A32, D32 = A.float().contiguous(), D.float().contiguous()  # [NH] each
    y = torch.empty((Bsz, T, NH, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty_like(state)
    if Bsz * NH * P == 0:
        return y, state.clone()
    launch = _build.launcher("mamba2_ssd", "mamba2_ssd_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_DTYPES[x.dtype], N, x.data_ptr(), dt.data_ptr(),
               A32.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
               D32.data_ptr(), state.data_ptr(), y.data_ptr(),
               s_out.data_ptr(), Bsz, T, NH, P, *x.stride()[:3],
               *dt.stride(), B_mat.stride(0), B_mat.stride(1),
               C_mat.stride(0), C_mat.stride(1), stream)
    mamba2_ssd.launches += 1
    return y, s_out


mamba2_ssd.launches = 0
