"""The lower-precision control: the reference with every product in fp8.

The configurations state bf16; the next precision below it is fp8
(e4m3). ``fp8_mm`` rounds the activation to e4m3 with one scale per row
and the weight with one scale per output column (each scale maps the
row's or column's largest magnitude to e4m3's largest finite value,
448), multiplies the rounded values and sums in f32: the arithmetic of a
W8A8 fp8 serving path. Everything else (norms, attention's softmax, the
recurrence) stays f32, so what the control shows is the products alone.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _round_e4m3(x.float(), -1) @ _round_e4m3(w.float(), 0)
