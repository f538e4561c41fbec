"""Unified model API, the port of ``repro.models.api``.

``Model(cfg)`` dispatches on ``cfg.family``, all six of the reference's:

  dense   transformer.py (llama32-3b, qwen3, qwen2, yi, command-r)
  moe     moe.py         (deepseek-moe-16b, moonshot-v1-16b-a3b)
  ssm     rwkv6.py       (rwkv6-3b; prefill through the rwkv6_scan kernel,
                          training also through its backward kernel)
  hybrid  mamba2.py      (zamba2-2.7b; prefill through the mamba2_ssd and
                          flash kernels)
  vlm     vlm.py         (internvl2-2b; batch {"patches", "tokens"})
  encdec  encdec.py      (seamless-m4t-medium; batch {"src_embeds",
                          "tokens"})

Signatures follow the reference, with an explicit ``device`` and
``torch.Generator`` for initialisation:

  init(generator, device) -> params
  abstract_params() -> params on the meta device (shapes, no memory)
  loss(params, batch, remat=True) -> (scalar, metrics)   batch: dict
  forward(params, batch, remat=False) -> logits
  prefill(params, batch, s_max) -> (logits[B,V], decode_state)
  decode_step(params, tokens[B], state, pos[B]) -> (logits[B,V], state)
  init_decode_state(batch_size, s_max, dtype, device, s_src) -> state
                    (zeros; ssm, hybrid, vlm and encdec)
  decode_step_paged(params, tokens[B], k_pages, v_pages, block_table,
                    pos[B], sink_page=None) -> logits[B,V]
                    (dense and moe; the dense family's step replays
                    as a CUDA graph where it can, ``decode_graph``)

The decode state is ``state_type``: the dense KV cache (AttnCache; dense,
moe, vlm), the fixed-size recurrent state (RWKVState), the mixed one
(ZambaState) or self + cross KV (EncDecState).

``train_inputs``, ``prefill_inputs`` and ``decode_inputs(shape)`` are
the reference's dry-run stand-ins as meta tensors of the reference's
dtypes; the dense and moe families' decode state is the dense cache
(``empty_cache``), which the reference decodes from.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.train.optimizer import tree_leaves
from . import decode_graph as DG
from . import encdec as ED
from . import mamba2 as MB
from . import moe as MOE
from . import rwkv6 as RW
from . import transformer as TF
from . import vlm as VL

_MODULES = {"dense": TF, "moe": MOE, "ssm": RW, "hybrid": MB, "vlm": VL,
            "encdec": ED}
_STATES = {"dense": TF.AttnCache, "moe": TF.AttnCache, "ssm": RW.RWKVState,
           "hybrid": MB.ZambaState, "vlm": TF.AttnCache,
           "encdec": ED.EncDecState}
_BATCHED = ("vlm", "encdec")     # forward/prefill take the whole batch
PAGED = ("dense", "moe")         # decode from the paged pool when served


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
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg
        self.family = cfg.family
        self.paged = cfg.family in PAGED     # serving decodes from the pool
        self.state_type = _STATES[cfg.family]
        self._mod = _MODULES[cfg.family]
        if self.paged:
            self.decode_graphs = DG.DecodeGraphs(cfg, functools.partial(
                self._mod.decode_step_paged, cfg=cfg))

    @property
    def graph_stats(self) -> DG.GraphStats:
        """Captures, replays and eager steps of ``decode_step_paged``."""
        return self.decode_graphs.stats

    def init(self, generator: torch.Generator, device="cuda") -> Any:
        return self._mod.init(self.cfg, generator, device)

    def abstract_params(self) -> Any:
        return self.init(torch.Generator(), device="meta")

    def param_count(self) -> int:
        return sum(math.prod(x.shape)
                   for x in tree_leaves(self.abstract_params()))

    def loss(self, params, batch: Dict[str, torch.Tensor],
             remat: bool = True) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy (the MoE's plus its
        load-balance loss) and the family's metrics."""
        return self._mod.loss_fn(params, batch, self.cfg, remat=remat)

    def forward(self, params, batch: Dict[str, torch.Tensor],
                remat: bool = False) -> torch.Tensor:
        if self.family in _BATCHED:
            return self._mod.forward(params, batch, self.cfg, remat)
        out = self._mod.forward(params, batch["tokens"], self.cfg, remat)
        return out[0] if self.family == "moe" else out    # moe: (logits, aux)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        if self.family in _BATCHED:
            return self._mod.prefill(params, batch, self.cfg, s_max)
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
                          dtype=torch.bfloat16, device="cuda",
                          s_src: int = 0) -> Any:
        """Zeros. ``s_src``: encdec's source length (default
        ``min(s_max, max_source_len)``, as in the reference)."""
        cfg = self.cfg
        if self.family == "ssm":
            return RW.init_state(cfg, batch_size, dtype, device)
        if self.family == "hybrid":
            return MB.init_state(cfg, batch_size, s_max, dtype,
                                 window=_hybrid_window(cfg, s_max),
                                 device=device)
        if self.family == "vlm":
            return TF.empty_cache(cfg, batch_size, s_max, dtype, device)
        if self.family == "encdec":
            e = cfg.encdec
            s_src = s_src or min(s_max, e.max_source_len)

            def z(s):
                return torch.zeros((e.num_decoder_layers, batch_size, s,
                                    cfg.num_kv_heads, cfg.head_dim),
                                   dtype=dtype, device=device)
            return ED.EncDecState(self_k=z(s_max), self_v=z(s_max),
                                  cross_k=z(s_src), cross_v=z(s_src))
        raise NotImplementedError(
            f"{cfg.name}: the {self.family} family decodes from the paged "
            f"pool (core.DevicePagedKV), not from a per-sequence state")

    def decode_step_paged(self, params, tokens: torch.Tensor,
                          k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor, pos: torch.Tensor,
                          sink_page: Optional[int] = None) -> torch.Tensor:
        """``sink_page``: a page of ``k_pages`` that no sequence reads
        (``DevicePagedKV.sink_page``), where the padded rows of a
        replayed step write; without it every step runs eagerly."""
        if not self.paged:
            raise NotImplementedError(
                f"{self.cfg.name}: paged decode is the {PAGED} families'; "
                f"{self.family!r} decodes its own state (decode_step)")
        args = (params, tokens, k_pages, v_pages, block_table, pos)
        if self.family != "dense":
            return self.decode_graphs.eager("family", *args)
        return self.decode_graphs(*args, sink_page)

    # ------------------------------------------------------------------
    # the reference's dry-run stand-ins, as meta tensors
    # ------------------------------------------------------------------
    def train_inputs(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if self.family == "encdec":
            return {"src_embeds": _meta((B, S, cfg.encdec.frontend_dim)),
                    "tokens": _meta((B, S), torch.int32),
                    "targets": _meta((B, S), torch.int32)}
        if self.family == "vlm":
            Np = cfg.vision.num_patches
            return {"patches": _meta((B, Np, cfg.vision.frontend_dim)),
                    "tokens": _meta((B, S - Np), torch.int32),
                    "targets": _meta((B, S - Np), torch.int32)}
        return {"tokens": _meta((B, S), torch.int32),
                "targets": _meta((B, S), torch.int32)}

    def prefill_inputs(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if self.family == "encdec":
            # prompt == the source utterance; decoder starts from BOS
            return {"src_embeds": _meta((B, S, cfg.encdec.frontend_dim)),
                    "tokens": _meta((B, 1), torch.int32)}
        if self.family == "vlm":
            Np = cfg.vision.num_patches
            return {"patches": _meta((B, Np, cfg.vision.frontend_dim)),
                    "tokens": _meta((B, S - Np), torch.int32)}
        return {"tokens": _meta((B, S), torch.int32)}

    def decode_inputs(self, shape: InputShape) -> Dict[str, Any]:
        """serve_step operands: one new token + the seq_len-deep state."""
        B, S = shape.global_batch, shape.seq_len
        if self.paged:
            state = TF.empty_cache(self.cfg, B, S, device="meta")
        else:
            state = self.init_decode_state(B, S, device="meta")
        return {"tokens": _meta((B,), torch.int32), "state": state,
                "pos": _meta((B,), torch.int32)}


def _meta(shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
