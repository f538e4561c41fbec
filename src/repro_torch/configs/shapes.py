"""Assigned input shapes and (arch x shape) applicability.

Four shapes per architecture (40 cells total):
  train_4k     seq 4,096   global_batch 256   -> lowers train_step
  prefill_32k  seq 32,768  global_batch 32    -> lowers prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> lowers serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve_step; sub-quadratic only
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES: List[InputShape] = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether the (arch, shape) cell runs or is a recorded skip.

    ``long_500k`` requires sub-quadratic attention: it runs for the SSM
    (rwkv6) and hybrid (zamba2, whose single shared attention block gets a
    sliding window at long context) families and is skipped for the eight
    pure full-attention archs (DESIGN.md section 8).
    """
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str:
    if applicable(cfg, shape):
        return ""
    return (f"{cfg.name} is pure full-attention; long_500k requires "
            f"sub-quadratic attention (DESIGN.md section 8)")
