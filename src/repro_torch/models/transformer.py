"""Dense decoder-only GQA transformer (yi-34b / qwen3 / command-r / qwen2 /
llama32-3b), the port of ``repro.models.transformer``.

Entry points (the serving split the paper studies, and training):
  forward            full-sequence forward (causal); ``remat``
                     activation-checkpoints each layer
  loss_fn            mean next-token cross-entropy (f32) of ``forward``
  prefill            full-sequence forward that also returns the dense KV
  decode_step        one token against a dense KV cache (the reference's
                     decode; plain torch attention)
  decode_step_paged  one token against the paged KV pool, through the
                     paged-attention kernel (the port's serving decode);
                     its blocks' FFN is swappable, so the MoE family
                     decodes through it too
  forward_from_embeddings / prefill_from_embeddings
                     the same over pre-embedded inputs (the VLM family)

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


def dense_mlp(p, h, cfg: ModelConfig) -> torch.Tensor:
    """The dense family's FFN of one block."""
    return L.mlp_forward(p["mlp"], h, cfg)


def _attn_out_mlp(p, x, attn, cfg: ModelConfig, ffn=dense_mlp
                  ) -> torch.Tensor:
    """Output projection, residual, pre-norm and ``ffn(p, h, cfg)``."""
    x = x + L.out_project(p["attn"], attn, cfg)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + ffn(p, h, cfg)


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


def forward_from_embeddings(params, x: torch.Tensor,
                            positions: torch.Tensor, cfg: ModelConfig,
                            remat: bool = False) -> torch.Tensor:
    """x: [B, S, d] pre-embedded inputs -> logits [B, S, V] (VLM path).
    ``remat``: each layer is activation-checkpointed."""
    def body(h, lp):
        return block_forward(lp, h, positions, cfg)

    if remat:
        body = L.remat_wrap(body)
    for lp in params["layers"]:
        x = body(x, lp)
    return L.lm_logits(params["embed"], x, cfg)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = False) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, V]."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    return forward_from_embeddings(params, x,
                                   _positions(B, S, tokens.device), cfg,
                                   remat)


def stack_cache(ks: List[torch.Tensor], vs: List[torch.Tensor],
                s_max: int) -> AttnCache:
    """Per-layer K/V [B, S, KV, hd] -> the dense cache, zero-padded to
    ``s_max`` slots."""
    ks, vs = torch.stack(ks), torch.stack(vs)
    S = ks.shape[2]
    if s_max > S:
        ks, vs = (_pad_seq(t, s_max - S) for t in (ks, vs))
    return AttnCache(k=ks, v=vs)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero slots after dim 2, by concatenating zeros (DTensor
    shards a concatenation where it does not shard every pad)."""
    return torch.cat([t, t.new_zeros((*t.shape[:2], n, *t.shape[3:]))],
                     dim=2)


def prefill_from_embeddings(params, x: torch.Tensor,
                            positions: torch.Tensor, cfg: ModelConfig,
                            s_max: Optional[int] = None
                            ) -> Tuple[torch.Tensor, AttnCache]:
    """Pre-embedded prefill (VLM path). x: [B, S, d] -> (last-position
    logits [B, V], cache padded with zeros to ``s_max`` slots)."""
    ks, vs = [], []
    for lp in params["layers"]:
        x, (k, v) = block_forward(lp, x, positions, cfg, return_kv=True)
        ks.append(k)
        vs.append(v)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, stack_cache(ks, vs, s_max or x.shape[1])


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: Optional[int] = None
            ) -> Tuple[torch.Tensor, AttnCache]:
    """tokens: [B, S] -> (last-position logits [B, V], cache padded with
    zeros to ``s_max`` slots)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    return prefill_from_embeddings(params, x,
                                   _positions(B, S, tokens.device), cfg,
                                   s_max)


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
                      pos: torch.Tensor, cfg: ModelConfig,
                      blocks: Optional[List[Tuple[Dict[str, Any], Any]]] = None
                      ) -> torch.Tensor:
    """One token per sequence against the paged pool.

    tokens: [B]; k_pages/v_pages: [L, P, page, KV, hd], written IN PLACE
    (the new K/V lands in page ``block_table[b, pos // page]``, slot
    ``pos % page``); block_table: [B, max_pages] int32 holding a page for
    position ``pos``; pos: [B] int32. ``blocks``: the (layer params,
    ``ffn(p, h, cfg)``) pairs in layer order, by default the dense
    family's layers with their MLP. Returns logits [B, V].
    """
    if cfg.sliding_window:
        raise NotImplementedError("paged decode has no sliding window")
    if blocks is None:
        blocks = [(lp, dense_mlp) for lp in params["layers"]]
    page = k_pages.shape[2]
    pos_l = pos.long()
    pages = block_table.long().gather(1, (pos_l // page)[:, None])[:, 0]
    slots = pos_l % page
    seq_lens = (pos + 1).to(torch.int32)
    x = L.embed(params["embed"], tokens[:, None], cfg)
    for layer, (lp, ffn) in enumerate(blocks):
        q, k, v = _attn_in(lp, x, pos_l[:, None], cfg)
        k_pages[layer, pages, slots] = k[:, 0].to(k_pages.dtype)
        v_pages[layer, pages, slots] = v[:, 0].to(v_pages.dtype)
        attn = ops.paged_attention(q[:, 0], k_pages[layer], v_pages[layer],
                                   block_table, seq_lens)
        x = _attn_out_mlp(lp, x, attn[:, None], cfg, ffn)
    return L.lm_logits(params["embed"], x, cfg)[:, 0]


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch["tokens"], cfg, remat=remat)
    return cross_entropy(logits, batch["targets"], batch.get("mask")), {}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL in f32; with ``mask``, over the masked-in
    positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, targets.long()[..., None],
                                dim=-1)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def empty_cache(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device="cuda") -> AttnCache:
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))
