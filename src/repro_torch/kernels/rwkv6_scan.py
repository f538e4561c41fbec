"""RWKV6 time-mix scan for prefill and training: the CUDA kernels'
wrappers and their plain torch version.

rwkv6-3b is attention-free: each layer's prefill runs this recurrence
over the prompt, and its final state is the whole handoff to decode (the
paper's degenerate-transfer case). The forward kernels
(``csrc/rwkv6_scan.cu``) replace the Pallas TPU kernel
``repro/kernels/rwkv6_scan.py::_rwkv6_kernel``. The backward kernels
(``csrc/rwkv6_backward.cu``) have no Pallas counterpart: the reference
trains through ``jax.value_and_grad`` of the plain version. Each header
says what bounds the kernel on the H100 and how it is laid out. Which
inputs take which forward kernel (``kernel_for``):

- ``rwkv6_chunked``: bf16 r, k, v at head dim 64 (rwkv6-3b's), with r,
  k, v and w on 16-byte aligned bases and strides. The chunked form on
  the tensor cores, in chunks of 64 steps.
- ``rwkv6_fwd``: everything else the wrapper takes: f32 (the parity
  path, exact on the CUDA cores), head dims 32 and 128, and unaligned
  bf16. It scans token by token.

Both mask their ragged tail, so they take any T, and one call is one
launch. The backward takes the same split (``backward_kernel_for``, from
the tensors alone): the forward's chunked condition with dy aligned too
runs the chunked form on the tensor cores (four launches: each chunk's
terms of the two carries, their scans, one block per chunk, du's sum);
the rest runs the step kernel (two launches). Each is an operator of
the ``repro_torch`` library (``kernels/library.py``), ``rwkv6_scan`` and
``rwkv6_scan_bwd``: the plain version for CPU tensors (for the gradient,
autograd of it), a kernel or a raise for CUDA tensors, shapes only for
meta and fake ones. ``rwkv6_scan`` goes through the ``RWKV6Scan``
autograd Function (the forward operator, then the backward one) only
when grad is enabled and an input requires it (on a real CPU tensor,
``library.on_host``, autograd of the plain version itself); otherwise it
calls the forward operator alone, as serving does.
``rwkv6_scan.launches`` counts the forward kernels' launches,
``rwkv6_scan.backward_launches`` the backward's (both routes),
``rwkv6_scan.backward_chunked_launches`` those of the chunked route.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from . import _build
from .flash_prefill import _DTYPES
from .library import define, divides, eager_autograd, fresh, on_host
from .ref import rwkv6_scan_ref as plain

HEAD_DIMS = (32, 64, 128)
CHUNKED_HEAD_DIM = 64
_KERNELS = {"step": 0, "chunked": 1}     # the forward's and the backward's

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_i, _i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
             *[_ll] * 12, _p]
_BWD_ARGTYPES = [_i, _i, _i, *[_p] * 16, _i, _i, _i, *[_ll] * 15, _p]
# steps of the backward kernel's sub-chunk: its states S_t fill 128 KB of
# shared memory (csrc/rwkv6_backward.cu, kHistBytes)
SUB_CHUNK = {hd: 32768 // (hd * hd) for hd in HEAD_DIMS}
# the chunked backward (csrc/rwkv6_backward.cu): chunks of 64 steps in
# sub-chunks of 16; a diagonal sub-chunk block whose summed -log2 w passes
# SPAN_MAX in some channel is taken with exact pairwise exponents; a
# (chunk, channel) with a decay under W_MIN takes dw from the step
# recurrence of its row instead of dividing w dw by w
CHUNK, CHUNK_SUB, SPAN_MAX, W_MIN = 64, 16, 64.0, 0.0625


def _aligned16(t: torch.Tensor) -> bool:
    """Base and outer strides on 16-byte multiples: the chunked kernels
    (this scan's, and the SSD backward's) copy 16-byte pieces
    (cp.async)."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:-1])


def kernel_for(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor) -> str:
    """The kernel that ``rwkv6_scan`` launches for these inputs on the
    card: ``"chunked"`` or ``"step"`` (see the module docstring)."""
    if r.dtype == torch.bfloat16 and r.shape[-1] == CHUNKED_HEAD_DIM \
            and all(_aligned16(t) for t in (r, k, v, w)):
        return "chunked"
    return "step"


def backward_kernel_for(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, dy: torch.Tensor) -> str:
    """The route that ``rwkv6_scan_backward`` launches on the card for
    these inputs (dy as the wrapper passes it, contiguous): ``"chunked"``
    for the forward's chunked condition with dy 16-byte aligned too, else
    ``"step"``."""
    if kernel_for(r, k, v, w) == "chunked" and _aligned16(dy):
        return "chunked"
    return "step"


def _check(r, k, v, w, u, state):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"rwkv6_scan: r, k, v, w [B,T,NH,hd] of one shape; "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, _, NH, hd = r.shape
    if tuple(u.shape) != (NH, hd):
        raise ValueError(f"rwkv6_scan: u [NH,hd] = {(NH, hd)}, got "
                         f"{tuple(u.shape)}")
    if tuple(state.shape) != (B, NH, hd, hd):
        raise ValueError(f"rwkv6_scan: state [B,NH,hd,hd] = "
                         f"{(B, NH, hd, hd)}, got {tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"rwkv6_scan: float32 or bfloat16 r/k/v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: w and state must be float32, got "
                        f"{w.dtype}, {state.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {hd} is not built "
                         f"(built: {HEAD_DIMS})")
    if len({t.device for t in (r, k, v, w, u, state)}) != 1:
        raise ValueError("rwkv6_scan: inputs on different devices")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w need a unit-stride last dim")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: [B, T, NH, hd]; u: [NH, hd]; state: [B, NH, hd, hd]
    f32 (default zeros) -> (y [B, T, NH, hd] in r's dtype, final state
    f32). On the card w must be f32 (the model's decay is)."""
    if state is None:
        B, _, NH, hd = r.shape
        state = torch.zeros((B, NH, hd, hd), dtype=torch.float32,
                            device=r.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        if on_host(r):
            return plain(r, k, v, w, u, state)
        return RWKV6Scan.apply(r, k, v, w, u, state)
    return scan_op(r, k, v, w, u, state)


def _forward(r, k, v, w, u, state):
    _check(r, k, v, w, u, state)
    B, T, NH, hd = r.shape
    state = state.contiguous()
    u32 = u.float().contiguous()           # [NH, hd]: a few KB
    y = torch.empty((B, T, NH, hd), dtype=r.dtype, device=r.device)
    s_out = torch.empty_like(state)
    if B * NH == 0:
        return y, state.clone()
    kernel = _KERNELS[kernel_for(r, k, v, w)]
    launch = _build.launcher("rwkv6_scan", "rwkv6_scan_fwd", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(kernel, _DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(),
               v.data_ptr(), w.data_ptr(), u32.data_ptr(), state.data_ptr(),
               y.data_ptr(), s_out.data_ptr(), B, T, NH,
               *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *w.stride()[:3], stream)
    rwkv6_scan.launches += 1
    return y, s_out


def rwkv6_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state: Optional[torch.Tensor], dy: torch.Tensor,
                        ds_out: Optional[torch.Tensor] = None,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, dstate) of ``rwkv6_scan(r, k, v, w, u,
    state)`` for the gradients ``dy`` of y and ``ds_out`` of the final
    state (default zeros), each in its input's dtype (dstate f32). On CPU
    tensors: autograd of the plain version. On the card ``route`` (default
    ``backward_kernel_for``'s) names the kernels, ``"step"`` or
    ``"chunked"``; a route the inputs do not allow raises."""
    B, T, NH, hd = r.shape
    if state is None:
        state = torch.zeros((B, NH, hd, hd), dtype=torch.float32,
                            device=r.device)
    if ds_out is None:
        ds_out = torch.zeros_like(state, dtype=torch.float32)
    return backward_op(r, k, v, w, u, state, dy, ds_out, route)


def _backward_cpu(r, k, v, w, u, state, dy, ds_out, route):
    ins = [t.detach().requires_grad_() for t in (r, k, v, w, u, state)]
    with eager_autograd(), torch.enable_grad():
        outs = plain(*ins)
        grads = torch.autograd.grad(outs, ins, (dy, ds_out),
                                    allow_unused=True)
    return fresh([torch.zeros_like(x) if g is None else g.contiguous()
                  for x, g in zip(ins, grads)],
                 (r, k, v, w, u, state, dy, ds_out))


def _backward_cuda(r, k, v, w, u, state, dy, ds_out, route):
    B, T, NH, hd = r.shape
    _check(r, k, v, w, u, state)
    if dy.shape != r.shape or dy.dtype != r.dtype or \
            ds_out.shape != state.shape or ds_out.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan backward: dy must be {r.dtype} "
                         f"{tuple(r.shape)} and ds_out float32 "
                         f"{tuple(state.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}, {ds_out.dtype} "
                         f"{tuple(ds_out.shape)}")
    dy, state, ds_out = (t.contiguous() for t in (dy, state, ds_out))
    u32 = u.float().contiguous()
    dr, dk, dv = (torch.empty((B, T, NH, hd), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty((B, T, NH, hd), dtype=torch.float32, device=r.device)
    du = torch.zeros((NH, hd), dtype=torch.float32, device=r.device)
    if B * NH == 0 or T == 0:
        return dr, dk, dv, dw, du.to(u.dtype), ds_out.clone()
    dstate = torch.empty_like(state)
    route = route or backward_kernel_for(r, k, v, w, dy)
    if route not in _KERNELS:
        raise ValueError(f"rwkv6_scan backward: no route {route!r}")
    if route == "chunked":
        # S and G at each chunk boundary as bf16 hi + lo planes, then each
        # chunk's carry term and decay in f32 (as bf16 pairs), and each
        # (b, chunk)'s share of du
        nc = -(-T // CHUNK)
        scratch = torch.empty(2 * B * NH * (2 * (nc + 1) * hd * hd
                                            + 2 * nc * (hd * hd + hd)),
                              dtype=torch.bfloat16, device=r.device)
        du_part = torch.empty((B, nc, NH, hd), dtype=torch.float32,
                              device=r.device)
    else:
        # the state at each sub-chunk's start, and each (b, h)'s share of du
        scratch = torch.empty((B, NH, -(-T // SUB_CHUNK[hd]), hd, hd),
                              dtype=torch.float32, device=r.device)
        du_part = torch.empty((B, NH, hd), dtype=torch.float32,
                              device=r.device)
    launch = _build.launcher("rwkv6_backward", "rwkv6_scan_bwd",
                             _BWD_ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(_KERNELS[route], _DTYPES[r.dtype], hd, *(
            t.data_ptr() for t in (r, k, v, w, dy, u32, state, ds_out, dr,
                                   dk, dv, dw, du_part, du, dstate,
                                   scratch)), B, T, NH,
            *r.stride()[:3], *k.stride()[:3], *w.stride()[:3],
            *v.stride()[:3], *dy.stride()[:3], stream)
    rwkv6_scan.backward_launches += 1
    if route == "chunked":
        rwkv6_scan.backward_chunked_launches += 1
    return dr, dk, dv, dw, du.to(u.dtype), dstate


class RWKV6Scan(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out = scan_op(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        return backward_op(*ctx.saved_tensors, dy, ds_out, None)


def backward_occupancy() -> dict:
    """Resident blocks an SM of each backward kernel at hd 64 in bf16, as
    launched (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the
    current card): the step kernel, and the chunked route's carries and
    chunk blocks."""
    out = (ctypes.c_int * 3)()
    fn = _build.load("rwkv6_backward").rwkv6_bwd_occupancy
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(out)
    if err:
        raise RuntimeError(f"rwkv6_backward: CUDA error {err}")
    return dict(zip(("step", "chunked_carries", "chunked_chunks"), out))


rwkv6_scan.launches = 0
rwkv6_scan.backward_launches = 0
rwkv6_scan.backward_chunked_launches = 0


# ----------------------------------------------------------------------
# the operators
# ----------------------------------------------------------------------
def _fwd_flops(r, k, v, w, u, state, *, out_shape=None, **_) -> int:
    # per step, head and batch row: y = S^T r (2 hd^2), the bonus
    # (r . (u * k)) v (4 hd), and S <- diag(w) S + k v^T (3 hd^2)
    B, T, NH, hd = r
    return B * T * NH * (5 * hd * hd + 4 * hd)


def _bwd_flops(r, k, v, w, u, state, dy, ds_out, route, *, out_shape=None,
               **_) -> int:
    # the forward's state recomputed (3 hd^2), the adjoint state
    # G <- diag(w) G + r dy^T (3 hd^2), dr = S dy, dk = G v, dv = G^T k
    # and dw = rowsum(S o G) (2 hd^2 each), and the bonus' gradients
    # (8 hd), per step, head and batch row
    B, T, NH, hd = r
    return B * T * NH * (14 * hd * hd + 8 * hd)


def _fwd_rule(r, k, v, w, u, state):
    """Replicated; batch on dim 0 (u replicated); heads on dim 2 (u's
    dim 0, the state's dim 1) where NH divides every mesh dim."""
    R, S0 = Replicate(), Shard(0)
    rules = [([R, R], [R] * 6), ([S0, S0], [S0] * 4 + [R, S0])]
    if divides(r, r.shape[2]):
        S1, S2 = Shard(1), Shard(2)
        rules.append(([S2, S1], [S2] * 4 + [S0, S1]))
    return rules


def _bwd_rule(r, k, v, w, u, state, dy, ds_out, route):
    """As the forward's; du sums over the batch, so batch-sharded it is a
    partial sum."""
    R, S0 = Replicate(), Shard(0)
    rules = [([R] * 6, [R] * 8 + [None]),
             ([S0] * 4 + [Partial(), S0], [S0] * 4 + [R, S0, S0, S0, None])]
    if divides(r, r.shape[2]):
        S1, S2 = Shard(1), Shard(2)
        rules.append(([S2] * 4 + [S0, S1],
                      [S2] * 4 + [S0, S1, S2, S1, None]))
    return rules


scan_op = define(
    "rwkv6_scan(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor state) -> (Tensor, Tensor)",
    cpu=lambda r, k, v, w, u, state: fresh(
        [t.contiguous() for t in plain(r, k, v, w, u, state)],
        (r, k, v, w, u, state)),
    cuda=_forward,
    fake=lambda r, k, v, w, u, state: (
        torch.empty_like(r, memory_format=torch.contiguous_format),
        torch.empty_like(state, dtype=torch.float32,
                         memory_format=torch.contiguous_format)),
    flops=_fwd_flops, sharding=_fwd_rule)

backward_op = define(
    "rwkv6_scan_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor state, Tensor dy, Tensor ds_out, str? route) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda r, k, v, w, u, state, *_: tuple(
        torch.empty_like(t, memory_format=torch.contiguous_format)
        for t in (r, k, v, w, u, state)),
    flops=_bwd_flops, sharding=_bwd_rule)
