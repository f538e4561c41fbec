"""Encoder-decoder backbone (seamless-m4t-medium), the port of
``repro.models.encdec``.

The modality frontend is a stub, as in the reference: the caller
provides precomputed frame embeddings [B, S_src, frontend_dim], which a
learned projector maps to d_model. The encoder is bidirectional; the
decoder is causal with cross-attention into the encoder's output. Every
attention of the encoder, and the decoder's prefill self-attention, go
through the flash kernel; so does cross-attention at prefill and at
decode (one query row against S_src keys, as the reference's
``_cross_attend`` calls it). Decode self-attention is plain torch on the
dense cache, as in the reference.

  prefill  = encoder + cross K/V projection + decoder-prefix forward
  decode   = one decoder token: cached self-attention + cross-attention

Params: ``{"embed", "frontend_proj", "encoder": [...], "decoder":
[...]}``. The reference's real-mode serving passes tokens only, so this
family has the model API here and no serving path, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import layers as L
from . import transformer as TF


class EncDecState(NamedTuple):
    self_k: torch.Tensor    # [Ld, B, S_max, KV, hd]
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [Ld, B, S_src, KV, hd]
    cross_v: torch.Tensor


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    e = cfg.encdec
    dtype = L.dtype_of(cfg.param_dtype)
    g = generator

    def ones():
        return torch.ones(cfg.d_model, device=device, dtype=dtype)
    return {
        "embed": L.init_embedding(cfg, g, device, dtype),
        "frontend_proj": {
            "w": L._normal((e.frontend_dim, cfg.d_model), 0.02, g, device,
                           dtype),
            "b": torch.zeros(cfg.d_model, device=device, dtype=dtype),
        },
        "encoder": [{
            "attn": L.init_attention(cfg, g, device, dtype),
            "mlp": L.init_mlp(cfg, g, device, dtype),
            "norm_attn": ones(), "norm_mlp": ones(),
        } for _ in range(e.num_encoder_layers)],
        "decoder": [{
            "self_attn": L.init_attention(cfg, g, device, dtype),
            "cross_attn": L.init_attention(cfg, g, device, dtype),
            "mlp": L.init_mlp(cfg, g, device, dtype),
            "norm_self": ones(), "norm_cross": ones(), "norm_mlp": ones(),
        } for _ in range(e.num_decoder_layers)],
    }


# ----------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------
def encode(params, src_embeds: torch.Tensor, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """src_embeds: [B, S_src, frontend_dim] -> [B, S_src, d]."""
    fp = params["frontend_proj"]
    x = src_embeds.to(L.dtype_of(cfg.compute_dtype)) @ fp["w"] + fp["b"]
    positions = TF._positions(*x.shape[:2], x.device)

    def body(h, lp):
        q, k, v = TF._attn_in(lp, h, positions, cfg)
        attn = L.flash_gqa(q, k, v, causal=False)
        return TF._attn_out_mlp(lp, h, attn, cfg)

    if remat:
        body = L.remat_wrap(body)
    for lp in params["encoder"]:
        x = body(x, lp)
    return x


def project_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_out: [B, S_src, d] -> per-decoder-layer cross K/V
    [Ld, B, S_src, KV, hd]."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    ks, vs = [], []
    for lp in params["decoder"]:
        ca = lp["cross_attn"]
        k = enc_out @ ca["wk"]
        v = enc_out @ ca["wv"]
        if cfg.attn_qkv_bias:
            k = k + ca["bk"]
            v = v + ca["bv"]
        k = k.reshape(*enc_out.shape[:-1], kv, hd)
        v = v.reshape(*enc_out.shape[:-1], kv, hd)
        if cfg.qk_norm:
            k = L.rms_norm(k, ca["k_norm"], cfg.norm_eps)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ----------------------------------------------------------------------
# decoder blocks
# ----------------------------------------------------------------------
def cross_q(lp, h, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm and query projection of cross-attention:
    h [B, T, d] -> q [B, T, H, hd]."""
    ca = lp["cross_attn"]
    hn = L.rms_norm(h, lp["norm_cross"], cfg.norm_eps)
    q = hn @ ca["wq"]
    if cfg.attn_qkv_bias:
        q = q + ca["bq"]
    q = q.reshape(*hn.shape[:-1], cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, ca["q_norm"], cfg.norm_eps)
    return q


def _cross_attend(lp, h, cross_k, cross_v, cfg: ModelConfig):
    """h: [B, T, d]; cross_k/v: [B, S_src, KV, hd]."""
    attn = L.flash_gqa(cross_q(lp, h, cfg), cross_k, cross_v, causal=False)
    return h + L.out_project(lp["cross_attn"], attn, cfg)


def self_in(lp, h, positions, cfg: ModelConfig):
    """Pre-norm, QKV projection and RoPE of the decoder's
    self-attention."""
    hn = L.rms_norm(h, lp["norm_self"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["self_attn"], hn, cfg)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _cross_mlp(lp, h, attn, cross_k, cross_v, cfg: ModelConfig):
    h = h + L.out_project(lp["self_attn"], attn, cfg)
    h = _cross_attend(lp, h, cross_k, cross_v, cfg)
    hn = L.rms_norm(h, lp["norm_mlp"], cfg.norm_eps)
    return h + L.mlp_forward(lp["mlp"], hn, cfg)


def decoder_block_forward(lp, h, positions, cross_k, cross_v,
                          cfg: ModelConfig):
    """-> (h, (k, v)) of the causal self-attention."""
    q, k, v = self_in(lp, h, positions, cfg)
    attn = L.flash_gqa(q, k, v, causal=True)
    return _cross_mlp(lp, h, attn, cross_k, cross_v, cfg), (k, v)


def decoder_block_decode(lp, h, cache_k, cache_v, cross_k, cross_v, pos,
                         cfg: ModelConfig):
    q, k, v = self_in(lp, h, pos[:, None], cfg)
    cache_k = L.cache_write(cache_k, k, pos)
    cache_v = L.cache_write(cache_v, v, pos)
    attn = L.cached_attention(q, cache_k, cache_v, pos)
    return (_cross_mlp(lp, h, attn, cross_k, cross_v, cfg), cache_k,
            cache_v)


# ----------------------------------------------------------------------
# model-level entry points
# ----------------------------------------------------------------------
def _decoder(params, tokens, cross_k, cross_v, cfg: ModelConfig):
    x = L.embed(params["embed"], tokens, cfg)
    positions = TF._positions(*tokens.shape, tokens.device)
    ks, vs = [], []
    for lp, ck, cv in zip(params["decoder"], cross_k, cross_v):
        x, (k, v) = decoder_block_forward(lp, x, positions, ck, cv, cfg)
        ks.append(k)
        vs.append(v)
    return x, ks, vs


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = False) -> torch.Tensor:
    """batch: {"src_embeds": [B,S_src,fd], "tokens": [B,S]} -> decoder
    logits [B, S, V]. ``remat``: each encoder and decoder layer is
    activation-checkpointed."""
    enc_out = encode(params, batch["src_embeds"], cfg, remat=remat)
    cross_k, cross_v = project_cross_kv(params, enc_out, cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg)
    positions = TF._positions(*tokens.shape, tokens.device)

    def body(h, lp, ck, cv):
        return decoder_block_forward(lp, h, positions, ck, cv, cfg)[0]

    if remat:
        body = L.remat_wrap(body)
    for lp, ck, cv in zip(params["decoder"], cross_k, cross_v):
        x = body(x, lp, ck, cv)
    return L.lm_logits(params["embed"], x, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True):
    logits = forward(params, batch, cfg, remat=remat)
    return TF.cross_entropy(logits, batch["targets"], batch.get("mask")), {}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, EncDecState]:
    """batch: {"src_embeds": [B,S_src,fd], "tokens": [B,S_prefix]} ->
    (last-position logits [B, V], state; self K/V padded to ``s_max``)."""
    enc_out = encode(params, batch["src_embeds"], cfg)
    cross_k, cross_v = project_cross_kv(params, enc_out, cfg)
    tokens = batch["tokens"]
    x, ks, vs = _decoder(params, tokens, cross_k, cross_v, cfg)
    cache = TF.stack_cache(ks, vs, s_max or tokens.shape[1])
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, EncDecState(self_k=cache.k, self_v=cache.v,
                               cross_k=cross_k, cross_v=cross_v)


def decode_step(params, tokens: torch.Tensor, state: EncDecState,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, EncDecState]:
    x = L.embed(params["embed"], tokens[:, None], cfg)
    ks, vs = [], []
    for lp, ck, cv, crk, crv in zip(params["decoder"], state.self_k,
                                    state.self_v, state.cross_k,
                                    state.cross_v):
        x, ck, cv = decoder_block_decode(lp, x, ck, cv, crk, crv, pos, cfg)
        ks.append(ck)
        vs.append(cv)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]
    return logits, EncDecState(self_k=torch.stack(ks),
                               self_v=torch.stack(vs),
                               cross_k=state.cross_k, cross_v=state.cross_v)
