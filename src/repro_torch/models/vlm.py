"""VLM backbone (internvl2-2b), the port of ``repro.models.vlm``: a
vision frontend STUB + the dense GQA transformer.

The frontend is a stub, as in the reference: the caller provides
precomputed patch embeddings [B, num_patches, frontend_dim]. A learned
projector maps them into the LM's embedding space; the patch tokens are
prepended to the text tokens and ``transformer.py`` runs over the
combined sequence (prefill through the flash kernel). Decode is plain LM
decode on the dense cache (``AttnCache``), with positions absolute in
the combined sequence.

The reference's real-mode serving passes tokens only, so this family
has the model API here and no serving path, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import transformer as TF

AttnCache = TF.AttnCache


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    dtype = L.dtype_of(cfg.param_dtype)
    params = TF.init(cfg, generator, device)
    params["projector"] = {
        "w": L._normal((cfg.vision.frontend_dim, cfg.d_model), 0.02,
                       generator, device, dtype),
        "b": torch.zeros(cfg.d_model, device=device, dtype=dtype),
    }
    return params


def _combined_embeddings(params, patches: torch.Tensor,
                         tokens: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x [B, Np+S, d], positions [B, Np+S])."""
    pj = params["projector"]
    img = patches.to(L.dtype_of(cfg.compute_dtype)) @ pj["w"] + pj["b"]
    x = torch.cat([img, L.embed(params["embed"], tokens, cfg)], dim=1)
    return x, TF._positions(*x.shape[:2], x.device)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = False) -> torch.Tensor:
    """batch: {"patches": [B,Np,fd], "tokens": [B,S]} -> logits over the
    text positions [B, S, V]."""
    patches, tokens = batch["patches"], batch["tokens"]
    x, positions = _combined_embeddings(params, patches, tokens, cfg)
    logits = TF.forward_from_embeddings(params, x, positions, cfg, remat)
    return logits[:, patches.shape[1]:]


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True):
    logits = forward(params, batch, cfg, remat=remat)
    return TF.cross_entropy(logits, batch["targets"], batch.get("mask")), {}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, AttnCache]:
    """The cache covers patch and text positions; ``s_max`` counts the
    combined length."""
    x, positions = _combined_embeddings(params, batch["patches"],
                                        batch["tokens"], cfg)
    return TF.prefill_from_embeddings(params, x, positions, cfg, s_max)


def decode_step(params, tokens: torch.Tensor, cache: AttnCache,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, AttnCache]:
    """``pos`` is the absolute position in the combined sequence."""
    return TF.decode_step(params, tokens, cache, pos, cfg)
