"""Unified model API, the port of ``repro.models.api``.

``Model(cfg)`` dispatches on ``cfg.family``. The port has three
families:

  dense   transformer.py (llama32-3b, qwen3, qwen2, yi, command-r)
  ssm     rwkv6.py       (rwkv6-3b; prefill through the rwkv6_scan kernel)
  hybrid  mamba2.py      (zamba2-2.7b; prefill through the mamba2_ssd and
                          flash kernels)

moe, vlm and encdec raise ``NotImplementedError`` naming the ROADMAP
item that brings them (queue 1 item 8). Signatures follow the
reference, with an explicit ``device`` and ``torch.Generator`` for
initialisation:

  init(generator, device) -> params
  forward(params, batch) -> logits
  prefill(params, batch, s_max) -> (logits[B,V], decode_state)
  decode_step(params, tokens[B], state, pos[B]) -> (logits[B,V], state)
  init_decode_state(batch_size, s_max, dtype, device) -> state (zeros;
                    ssm and hybrid)
  decode_step_paged(params, tokens[B], k_pages, v_pages, block_table,
                    pos[B]) -> logits[B,V]            (dense only)

The decode state is ``state_type``: the dense KV cache (AttnCache), the
fixed-size recurrent state (RWKVState) or the mixed one (ZambaState).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import mamba2 as MB
from . import rwkv6 as RW
from . import transformer as TF

_PENDING = {
    "moe": "ROADMAP queue 1 item 8 (models/moe.py)",
    "vlm": "ROADMAP queue 1 item 8 (models/vlm.py)",
    "encdec": "ROADMAP queue 1 item 8 (models/encdec.py)",
}
_MODULES = {"dense": TF, "ssm": RW, "hybrid": MB}
_STATES = {"dense": TF.AttnCache, "ssm": RW.RWKVState,
           "hybrid": MB.ZambaState}


def _hybrid_window(cfg: ModelConfig, seq_len: int) -> int:
    """The shared attention block goes sliding-window at long context."""
    if cfg.family != "hybrid":
        return cfg.sliding_window
    w = cfg.hybrid.long_context_window
    return w if seq_len > 4 * w else 0


class Model:
    """Family-dispatched, signature-normalized model handle."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _MODULES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet: "
                f"{_PENDING.get(cfg.family, 'no ROADMAP item')}")
        self.cfg = cfg
        self.family = cfg.family
        self.state_type = _STATES[cfg.family]
        self._mod = _MODULES[cfg.family]

    def init(self, generator: torch.Generator, device="cuda") -> Any:
        return self._mod.init(self.cfg, generator, device)

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._mod.forward(params, batch["tokens"], self.cfg)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        tokens = batch["tokens"]
        if self.family == "hybrid":
            return MB.prefill(params, tokens, self.cfg, s_max,
                              window=_hybrid_window(
                                  self.cfg, s_max or tokens.shape[1]))
        return self._mod.prefill(params, tokens, self.cfg, s_max)

    def decode_step(self, params, tokens: torch.Tensor, state: Any,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        cfg = self.cfg
        if self.family == "hybrid":
            w = cfg.hybrid.long_context_window
            return MB.decode_step(params, tokens, state, pos, cfg,
                                  window=w if state.attn_k.shape[2] == w
                                  else 0)
        return self._mod.decode_step(params, tokens, state, pos, cfg)

    def init_decode_state(self, batch_size: int, s_max: int,
                          dtype=torch.bfloat16, device="cuda") -> Any:
        cfg = self.cfg
        if self.family == "ssm":
            return RW.init_state(cfg, batch_size, dtype, device)
        if self.family == "hybrid":
            return MB.init_state(cfg, batch_size, s_max, dtype,
                                 window=_hybrid_window(cfg, s_max),
                                 device=device)
        raise NotImplementedError(
            f"{cfg.name}: the dense family decodes from the paged pool "
            f"(core.DevicePagedKV), not from a per-sequence state")

    def decode_step_paged(self, params, tokens: torch.Tensor,
                          k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: paged decode is the dense family's; "
                f"{self.family!r} decodes its own state (decode_step)")
        return TF.decode_step_paged(params, tokens, k_pages, v_pages,
                                    block_table, pos, self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
