"""Dense decoder-only GQA transformer (yi-34b / qwen3 / command-r / qwen2 /
llama32-3b), the port of ``repro.models.transformer``.

Entry points (the serving split the paper studies):
  forward            full-sequence forward (causal)
  prefill            full-sequence forward that also returns the dense KV
  decode_step        one token against a dense KV cache (the reference's
                     decode; plain torch attention)
  decode_step_paged  one token against the paged KV pool, through the
                     paged-attention kernel (the port's serving decode)

Params: ``{"embed": {...}, "layers": [per-layer dict, ...]}``; the
reference's layer ``scan`` is a Python loop over the layer list.
Dense KV layout: [L, B, S_max, KV, hd].
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from . import layers as L


class AttnCache(NamedTuple):
    """Dense KV cache for attention archs. k/v: [L, B, S_max, KV, hd]."""
    k: torch.Tensor
    v: torch.Tensor


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    """Seeded parameters with the reference's distributions (std 0.02,
    out-projections 0.02/sqrt(2L), norms 1, biases 0) in
    ``cfg.param_dtype``. ``generator`` must live on ``device``."""
    dtype = L.dtype_of(cfg.param_dtype)
    emb = L.init_embedding(cfg, generator, device, dtype)
    layers: List[Dict[str, Any]] = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn": L.init_attention(cfg, generator, device, dtype),
            "mlp": L.init_mlp(cfg, generator, device, dtype),
            "norm_attn": torch.ones(cfg.d_model, device=device, dtype=dtype),
            "norm_mlp": torch.ones(cfg.d_model, device=device, dtype=dtype),
        })
    return {"embed": emb, "layers": layers}


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def _attn_in(p, x, positions, cfg: ModelConfig):
    """Pre-norm, QKV projection and RoPE: x [B,S,d] -> q, k, v."""
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out_mlp(p, x, attn, cfg: ModelConfig) -> torch.Tensor:
    x = x + L.out_project(p["attn"], attn, cfg)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h, cfg)


def block_forward(p: Dict[str, Any], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, *,
                  return_kv: bool = False):
    """Full-seq pre-norm block. x: [B, S, d]; positions: [B, S]."""
    q, k, v = _attn_in(p, x, positions, cfg)
    attn = L.flash_gqa(q, k, v, causal=True, window=cfg.sliding_window)
    x = _attn_out_mlp(p, x, attn, cfg)
    if return_kv:
        return x, (k, v)
    return x


def block_decode(p: Dict[str, Any], x: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """One-token block step on a dense cache. x: [B, 1, d];
    cache_*: [B, S_max, KV, hd]; pos: [B] (index the token is written at)."""
    q, k, v = _attn_in(p, x, pos[:, None], cfg)
    cache_k = L.cache_write(cache_k, k, pos)
    cache_v = L.cache_write(cache_v, v, pos)
    attn = L.cached_attention(q, cache_k, cache_v, pos,
                              window=cfg.sliding_window)
    return _attn_out_mlp(p, x, attn, cfg), cache_k, cache_v


# ----------------------------------------------------------------------
# model-level entry points
# ----------------------------------------------------------------------
def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, V]."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S, tokens.device)
    for lp in params["layers"]:
        x = block_forward(lp, x, positions, cfg)
    return L.lm_logits(params["embed"], x, cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: Optional[int] = None
            ) -> Tuple[torch.Tensor, AttnCache]:
    """tokens: [B, S] -> (last-position logits [B, V], cache padded with
    zeros to ``s_max`` slots)."""
    B, S = tokens.shape
    s_max = s_max or S
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S, tokens.device)
    ks, vs = [], []
    for lp in params["layers"]:
        x, (k, v) = block_forward(lp, x, positions, cfg, return_kv=True)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if s_max > S:
        pad = (0, 0, 0, 0, 0, s_max - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, AttnCache(k=ks, v=vs)


def decode_step(params, tokens: torch.Tensor, cache: AttnCache,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, AttnCache]:
    """tokens: [B] new token ids; pos: [B] their positions.
    Returns (logits [B, V], updated cache)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    ks, vs = [], []
    for lp, ck, cv in zip(params["layers"], cache.k, cache.v):
        x, ck, cv = block_decode(lp, x, ck, cv, pos, cfg)
        ks.append(ck)
        vs.append(cv)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]
    return logits, AttnCache(k=torch.stack(ks), v=torch.stack(vs))


def decode_step_paged(params, tokens: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token per sequence against the paged pool.

    tokens: [B]; k_pages/v_pages: [L, P, page, KV, hd], written IN PLACE
    (the new K/V lands in page ``block_table[b, pos // page]``, slot
    ``pos % page``); block_table: [B, max_pages] int32 holding a page for
    position ``pos``; pos: [B] int32. Returns logits [B, V].
    """
    if cfg.sliding_window:
        raise NotImplementedError("paged decode has no sliding window")
    page = k_pages.shape[2]
    pos_l = pos.long()
    pages = block_table.long().gather(1, (pos_l // page)[:, None])[:, 0]
    slots = pos_l % page
    seq_lens = (pos + 1).to(torch.int32)
    x = L.embed(params["embed"], tokens[:, None], cfg)
    for layer, lp in enumerate(params["layers"]):
        q, k, v = _attn_in(lp, x, pos_l[:, None], cfg)
        k_pages[layer, pages, slots] = k[:, 0].to(k_pages.dtype)
        v_pages[layer, pages, slots] = v[:, 0].to(v_pages.dtype)
        attn = ops.paged_attention(q[:, 0], k_pages[layer], v_pages[layer],
                                   block_table, seq_lens)
        x = _attn_out_mlp(lp, x, attn[:, None], cfg)
    return L.lm_logits(params["embed"], x, cfg)[:, 0]

