"""Plain f32 references of the benchmark's model families.

Each module computes, from the published equations and with plain torch
operations only, the final hidden state of every position of a token
sequence (``hidden``), the logits of chosen rows (``logits``), and the
work of the port's prefill and decode calls (``prefill_work``,
``decode_work``). They read the same parameter tree the port serves
(the port's leaf names and ``x @ W`` layout), one layer at a time,
widened to f32 as it runs, so the reference fits beside the bf16
weights. They import nothing of the port.

Every product goes through ``mm``: ``f32_mm`` for the reference itself,
and ``lowp.fp8_mm`` for the lower-precision control.
"""
from __future__ import annotations

import torch


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def exact_f32() -> None:
    """Full f32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def logits(params, cfg: dict, h: torch.Tensor, mm=f32_mm,
           rows: int = 1024):
    """Yield (row offset, logits [rows, V] f32) for the final hidden
    states ``h`` [N, d] (the final norm already applied), a block of rows
    at a time."""
    w = params["embed"]["embedding"].T if cfg.get("tie_embeddings") \
        else params["embed"]["lm_head"]
    w = w.float()
    for lo in range(0, h.shape[0], rows):
        yield lo, mm(h[lo:lo + rows], w)
