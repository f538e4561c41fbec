"""Mamba2 SSD scan for prefill and training: the CUDA kernels' wrappers
and their plain torch version.

zamba2-2.7b's backbone runs this recurrence in each of its 54 Mamba2
layers at prefill; the final states are the fixed-size part of its
handoff to decode. The forward kernel (``csrc/mamba2_ssd.cu``) replaces
the Pallas TPU kernel ``repro/kernels/mamba2_ssd.py::_ssd_kernel``. For
bf16 at zamba2's shape (N 64, P a multiple of 64) it runs the chunked
SSD form on the tensor cores in chunks of its own (64 steps, whatever
chunk the caller pads to); f32 and other shapes scan step by step. Both
mask their ragged tail, so it takes any T. One call is one launch. The
backward kernels (``csrc/mamba2_ssd_backward.cu``) have no Pallas
counterpart: the reference trains through ``jax.value_and_grad`` of the
plain version. The backward takes the same split as the forward: bf16
at N 64 with P a multiple of 64 and 16-byte aligned x, B, C and dy runs
the chunked form on the tensor cores (three launches: the chunk-start
states, a reverse walk over the chunks, the sums across blocks); f32
and every other shape run the step kernel (two launches).
``backward_kernel_for`` says which, from the tensors alone. Each header
says what bounds the kernel on the H100 and how it is laid out.

Each is an operator of the ``repro_torch`` library
(``kernels/library.py``), ``mamba2_ssd`` and ``mamba2_ssd_bwd``: the
plain version for CPU tensors (for the gradient, autograd of it), a
kernel or a raise for CUDA tensors, shapes only for meta and fake ones.
``mamba2_ssd`` goes through the ``Mamba2SSD`` autograd Function (the
forward operator, then the backward one) only when grad is enabled and
an input requires it (on a real CPU tensor, ``library.on_host``, autograd
of the plain version itself); otherwise it calls the forward operator
alone, as serving does. ``mamba2_ssd.launches`` counts the forward
kernel's launches, ``mamba2_ssd.backward_launches`` the backward's (both
routes), ``mamba2_ssd.backward_chunked_launches`` those of the chunked
route.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from . import _build
from .flash_prefill import _DTYPES
from .library import define, divides, eager_autograd, fresh, on_host
from .ref import mamba2_ssd_ref as plain
from .rwkv6_scan import _aligned16

STATE_DIMS = (16, 32, 64, 128)
COLS = 16          # state columns per block: P must be a multiple

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
             *[_ll] * 10, _p]
_BWD_ARGTYPES = [_i, _i, *[_p] * 22, _i, _i, _i, _i, *[_ll] * 10, _p]
# the backward kernel's block: a thread a state row (at least a warp), and
# a sub-chunk of steps whose states fill 32 KB of shared memory
# (csrc/mamba2_ssd_backward.cu, kHistBytes)
BWD_ROWS = {n: max(n, 32) for n in STATE_DIMS}
SUB_CHUNK = {n: 32768 // (BWD_ROWS[n] * COLS * 4) for n in STATE_DIMS}
# the chunked backward: chunks of 64 steps, blocks of 64 state columns,
# at the state dim it is built for
CHUNK, CHUNK_COLS, CHUNK_STATE = 64, 64, 64


def backward_kernel_for(x: torch.Tensor, B_mat: torch.Tensor,
                        C_mat: torch.Tensor, dy: torch.Tensor) -> str:
    """The route that ``mamba2_ssd_backward`` launches on the card for
    these inputs (dy as the wrapper passes it, contiguous):
    ``"chunked"`` for bf16 at N 64 with P a multiple of 64 and x, B_mat,
    C_mat and dy 16-byte aligned, else ``"step"``."""
    if x.dtype == torch.bfloat16 and B_mat.shape[-1] == CHUNK_STATE \
            and x.shape[-1] % CHUNK_COLS == 0 \
            and all(_aligned16(t) for t in (x, B_mat, C_mat, dy)):
        return "chunked"
    return "step"


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
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    if state is None:
        state = torch.zeros((Bsz, NH, N, P), dtype=torch.float32,
                            device=x.device)
    if D is None:
        D = torch.zeros(NH, dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_mat, C_mat, D, state)):
        if on_host(x):
            return plain(x, dt, A, B_mat, C_mat, D, state)
        return Mamba2SSD.apply(x, dt, A, B_mat, C_mat, D, state)
    return scan_op(x, dt, A, B_mat, C_mat, D, state)


def _forward(x, dt, A, B_mat, C_mat, D, state):
    _check(x, dt, A, B_mat, C_mat, D, state)
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
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


def mamba2_ssd_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B_mat: torch.Tensor, C_mat: torch.Tensor,
                        D: Optional[torch.Tensor],
                        state: Optional[torch.Tensor], dy: torch.Tensor,
                        ds_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, dD, dstate) of ``mamba2_ssd(x, dt, A, B_mat,
    C_mat, D, state)`` for the gradients ``dy`` of y and ``ds_out`` of the
    final state (default zeros): dx, dB and dC in x's dtype, ddt and
    dstate f32, dA and dD in A's and D's dtypes (a D of None is taken as
    zeros, f32, and dD is the gradient there). On CPU tensors: autograd
    of the plain version."""
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    if state is None:
        state = torch.zeros((Bsz, NH, N, P), dtype=torch.float32,
                            device=x.device)
    if D is None:
        D = torch.zeros(NH, dtype=torch.float32, device=x.device)
    if ds_out is None:
        ds_out = torch.zeros_like(state, dtype=torch.float32)
    return backward_op(x, dt, A, B_mat, C_mat, D, state, dy, ds_out)


def _backward_cpu(x, dt, A, B_mat, C_mat, D, state, dy, ds_out):
    ins = [t.detach().requires_grad_()
           for t in (x, dt, A, B_mat, C_mat, D, state)]
    with eager_autograd(), torch.enable_grad():
        outs = plain(*ins)
        grads = torch.autograd.grad(outs, ins, (dy, ds_out),
                                    allow_unused=True)
    return fresh([torch.zeros_like(t) if g is None else g.contiguous()
                  for t, g in zip(ins, grads)],
                 (x, dt, A, B_mat, C_mat, D, state, dy, ds_out))


def _backward_cuda(x, dt, A, B_mat, C_mat, D, state, dy, ds_out):
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    _check(x, dt, A, B_mat, C_mat, D, state)
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            ds_out.shape != state.shape or ds_out.dtype != torch.float32:
        raise ValueError(f"mamba2_ssd backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)} and ds_out float32 "
                         f"{tuple(state.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}, {ds_out.dtype} "
                         f"{tuple(ds_out.shape)}")
    if Bsz * T * NH * P == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(B_mat),
                torch.zeros_like(C_mat), torch.zeros_like(D), ds_out.clone())
    dy, state, ds_out = (t.contiguous() for t in (dy, state, ds_out))
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bsz, T, NH, P), dtype=x.dtype, device=dev)
    dB, dC = (torch.empty((Bsz, T, N), dtype=x.dtype, device=dev)
              for _ in range(2))
    ddt = torch.empty((Bsz, T, NH), **f32)
    dA, dD = (torch.empty(NH, **f32) for _ in range(2))
    dstate = torch.empty_like(state)
    route = backward_kernel_for(x, B_mat, C_mat, dy)
    if route == "chunked":
        # the state at each chunk's start as bf16 hi and lo planes, and
        # each column block's partials of the sums across blocks
        ns, symbol = P // CHUNK_COLS, "mamba2_ssd_bwd_chunked"
        states = torch.empty((Bsz, NH, -(-T // CHUNK), 2, N, P),
                             dtype=torch.bfloat16, device=dev)
    else:
        # each block's kept states (one every sub-chunk), and its
        # partials of the sums across blocks
        ns, symbol = P // COLS, "mamba2_ssd_bwd"
        states = torch.empty(Bsz * NH * ns * -(-T // SUB_CHUNK[N])
                             * BWD_ROWS[N] * COLS, **f32)
    dB_part, dC_part = (torch.empty((Bsz, NH, ns, T, N), **f32)
                        for _ in range(2))
    ddt_part = torch.empty((Bsz, NH, ns, T), **f32)
    dA_part, dD_part = (torch.empty((Bsz, NH, ns), **f32) for _ in range(2))
    launch = _build.launcher("mamba2_ssd_backward", symbol, _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_DTYPES[x.dtype], N, *(t.data_ptr() for t in (
            x, dt, A32, B_mat, C_mat, D32, state, dy, ds_out, dx, ddt, dA,
            dB, dC, dD, dstate, states, dB_part, dC_part, ddt_part, dA_part,
            dD_part)), Bsz, T, NH, P, *x.stride()[:3], *dt.stride(),
            B_mat.stride(0), B_mat.stride(1), C_mat.stride(0),
            C_mat.stride(1), stream)
    mamba2_ssd.backward_launches += 1
    if route == "chunked":
        mamba2_ssd.backward_chunked_launches += 1
    return dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), dstate


class Mamba2SSD(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, D, state):
        y, s_out = scan_op(x, dt, A, B_mat, C_mat, D, state)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, D, state)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        return backward_op(*ctx.saved_tensors, dy, ds_out)


def backward_occupancy() -> dict:
    """Resident blocks an SM of each backward kernel at N 64 in bf16, as
    launched (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the
    current card): the step kernel, and the chunked route's state launch
    and walk."""
    out = (ctypes.c_int * 3)()
    fn = _build.load("mamba2_ssd_backward").mamba2_ssd_bwd_occupancy
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(out)
    if err:
        raise RuntimeError(f"mamba2_ssd_backward: CUDA error {err}")
    return dict(zip(("step", "chunked_states", "chunked_walk"), out))


mamba2_ssd.launches = 0
mamba2_ssd.backward_launches = 0
mamba2_ssd.backward_chunked_launches = 0


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------
def _fwd_flops(x, dt, A, B_mat, C_mat, D, state, *, out_shape=None,
               **_) -> int:
    # per step, head and batch row: S <- exp(A dt) S + B (dt x)^T (3 N P,
    # and P for dt x), y = S^T C (2 N P) and D x (2 P)
    Bsz, T, NH, P = x
    N = B_mat[-1]
    return Bsz * T * NH * (5 * N * P + 3 * P)


def _bwd_flops(x, dt, A, B_mat, C_mat, D, state, dy, ds_out, *,
               out_shape=None, **_) -> int:
    # the forward's state recomputed (3 N P), the adjoint state
    # G <- exp(A dt) G + C dy^T (3 N P), dx and dB from G (2 N P each),
    # dC from S (2 N P), ddt and dA from S o G and G B (4 N P), and the
    # skip's and dt x's gradients (8 P), per step, head and batch row
    Bsz, T, NH, P = x
    N = B_mat[-1]
    return Bsz * T * NH * (16 * N * P + 8 * P)


def _fwd_rule(x, dt, A, B_mat, C_mat, D, state):
    """Replicated; batch on dim 0 (A and D replicated); heads on x's and
    dt's dim 2 (A's and D's dim 0, the state's dim 1, B and C replicated:
    one group serves every head) where NH divides every mesh dim."""
    R, S0 = Replicate(), Shard(0)
    rules = [([R, R], [R] * 7), ([S0, S0], [S0, S0, R, S0, S0, R, S0])]
    if divides(x, x.shape[2]):
        S1, S2 = Shard(1), Shard(2)
        rules.append(([S2, S1], [S2, S2, S0, R, R, S0, S1]))
    return rules


def _bwd_rule(x, dt, A, B_mat, C_mat, D, state, dy, ds_out):
    """As the forward's; dA and dD sum over the batch and dB and dC over
    the heads, so those are partial sums where their sum is split."""
    R, S0, P = Replicate(), Shard(0), Partial()
    rules = [([R] * 7, [R] * 9),
             ([S0, S0, P, S0, S0, P, S0],
              [S0, S0, R, S0, S0, R, S0, S0, S0])]
    if divides(x, x.shape[2]):
        S1, S2 = Shard(1), Shard(2)
        rules.append(([S2, S2, S0, P, P, S0, S1],
                      [S2, S2, S0, R, R, S0, S1, S2, S1]))
    return rules


scan_op = define(
    "mamba2_ssd(Tensor x, Tensor dt, Tensor A, Tensor B_mat, Tensor C_mat, "
    "Tensor D, Tensor state) -> (Tensor, Tensor)",
    cpu=lambda x, dt, A, B_mat, C_mat, D, state: fresh(
        [t.contiguous() for t in plain(x, dt, A, B_mat, C_mat, D, state)],
        (x, dt, A, B_mat, C_mat, D, state)),
    cuda=_forward,
    fake=lambda x, dt, A, B_mat, C_mat, D, state: (
        torch.empty_like(x, memory_format=torch.contiguous_format),
        torch.empty_like(state, dtype=torch.float32,
                         memory_format=torch.contiguous_format)),
    flops=_fwd_flops, sharding=_fwd_rule)

backward_op = define(
    "mamba2_ssd_bwd(Tensor x, Tensor dt, Tensor A, Tensor B_mat, "
    "Tensor C_mat, Tensor D, Tensor state, Tensor dy, Tensor ds_out) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda x, dt, A, B_mat, C_mat, D, state, *_: tuple(
        torch.empty_like(t, memory_format=torch.contiguous_format)
        for t in (x, dt, A, B_mat, C_mat, D, state)),
    flops=_bwd_flops, sharding=_bwd_rule)
