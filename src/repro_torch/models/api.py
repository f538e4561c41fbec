"""Unified model API, the port of ``repro.models.api``.

``Model(cfg)`` dispatches on ``cfg.family``. The port has the dense
family; the others raise ``NotImplementedError`` naming the ROADMAP item
that brings them. Signatures follow the reference, with an explicit
``device`` and ``torch.Generator`` for initialisation:

  init(generator, device) -> params
  forward(params, batch) -> logits
  prefill(params, batch, s_max) -> (logits[B,V], AttnCache)
  decode_step(params, tokens[B], state, pos[B]) -> (logits[B,V], state)
  decode_step_paged(params, tokens[B], k_pages, v_pages, block_table,
                    pos[B]) -> logits[B,V]
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import transformer as TF

_PENDING = {
    "moe": "ROADMAP queue 1 item 8 (models/moe.py)",
    "vlm": "ROADMAP queue 1 item 8 (models/vlm.py)",
    "encdec": "ROADMAP queue 1 item 8 (models/encdec.py)",
    "ssm": "ROADMAP queue 1 item 9 (models/rwkv6.py, kernel rwkv6_scan)",
    "hybrid": "ROADMAP queue 1 item 9 (models/mamba2.py, kernel "
              "mamba2_ssd)",
}


class Model:
    """Family-dispatched, signature-normalized model handle."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet: "
                f"{_PENDING.get(cfg.family, 'no ROADMAP item')}")
        self.cfg = cfg
        self.family = cfg.family

    def init(self, generator: torch.Generator, device="cuda") -> Any:
        return TF.init(self.cfg, generator, device)

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return TF.forward(params, batch["tokens"], self.cfg)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, TF.AttnCache]:
        return TF.prefill(params, batch["tokens"], self.cfg, s_max)

    def decode_step(self, params, tokens: torch.Tensor, state: TF.AttnCache,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, TF.AttnCache]:
        return TF.decode_step(params, tokens, state, pos, self.cfg)

    def decode_step_paged(self, params, tokens: torch.Tensor,
                          k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        return TF.decode_step_paged(params, tokens, k_pages, v_pages,
                                    block_table, pos, self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
