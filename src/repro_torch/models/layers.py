"""Common model building blocks (plain torch functions on dict params).

Conventions, as in ``repro.models.layers``:
  * params are nested dicts of tensors; weights are stored [in, out] and
    applied as ``x @ W``, the reference's layout, so the weight bridge
    (``convert``) copies them as they are;
  * activations flow in ``cfg.compute_dtype``; norms/softmax/logits in f32;
  * attention math routes through ``repro_torch.kernels.ops``, so the CUDA
    kernels and their plain versions share one call site.

Only the default branches are ported: the ``opt_flags`` switches
(``pad_heads``, ``head_shard_attn``, ``masked_cache_update``,
``bf16_logits``, ``remat_dots``) come with ``dist/``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def remat_wrap(body):
    """Activation-checkpoint a layer body (the reference's
    ``jax.checkpoint``): its activations are dropped after the forward
    pass and recomputed in the backward pass. The reference's
    ``remat_dots`` policy comes with ``dist/opt_flags``."""
    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False)
    return wrapped


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence GQA attention. q [B,S,H,hd]; k,v [B,T,KV,hd]."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write one token's K or V ([B, 1, KV, hd]) into a copy of a
    [B, S, KV, hd] cache at per-batch position ``pos``."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), pos.long()] = \
        new[:, 0].to(cache.dtype)
    return out


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def init_rms_norm(d: int, device, dtype) -> torch.Tensor:
    return torch.ones(d, device=device, dtype=dtype)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [half]
    angles = positions[..., :, None].float() * freqs             # [.., S, half]
    cos = torch.cos(angles)[..., :, None, :]                     # [.., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention (GQA with optional qk-norm / biases)
# ----------------------------------------------------------------------
def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> q [B,S,H,hd], k/v [B,S,KV,hd]."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(*x.shape[:-1], h, hd)
    k = k.reshape(*x.shape[:-1], kv, hd)
    v = v.reshape(*x.shape[:-1], kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def out_project(p: Params, attn: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """attn: [B, S, H, hd] -> [B, S, d]."""
    o = attn.reshape(*attn.shape[:-2], -1) @ p["wo"]
    if cfg.attn_out_bias:
        o = o + p["bo"]
    return o


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Decode-step attention against a dense KV cache (plain torch).

    q: [B, 1, H, hd] (already rotated); cache_k/v: [B, T, KV, hd] (new
    K/V already written at ``pos``); pos: [B]. Reads the whole cache and
    masks positions > pos: the dense analogue of the paged kernel.
    """
    B, _, H, hd = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg,
                          cache_k.float()) / math.sqrt(hd)
    kpos = torch.arange(T, device=q.device)[None, :]
    pos = pos.to(q.device)
    mask = kpos <= pos[:, None]
    if window > 0:
        mask = mask & (kpos > (pos[:, None] - window))
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ----------------------------------------------------------------------
# FFN (SwiGLU / GELU)
# ----------------------------------------------------------------------
def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_bias:
        up = up + p["b_up"]
    if cfg.act == "silu":
        hidden = F.silu(x @ p["w_gate"]) * up
    else:
        hidden = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out = hidden @ p["w_down"]
    if cfg.mlp_bias:
        out = out + p["b_down"]
    return out


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------
def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embedding"].to(dtype_of(cfg.compute_dtype))[tokens]


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return x.float() @ w.float()


# ----------------------------------------------------------------------
# Seeded initialisation (the reference's distributions, not its values)
# ----------------------------------------------------------------------
def _normal(shape, std, g, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=device) * std).to(dtype)


def init_attention(cfg: ModelConfig, g: torch.Generator, device,
                   dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std, out_std = 0.02, 0.02 / math.sqrt(2 * cfg.num_layers)
    p: Params = {
        "wq": _normal((d, h * hd), std, g, device, dtype),
        "wk": _normal((d, kv * hd), std, g, device, dtype),
        "wv": _normal((d, kv * hd), std, g, device, dtype),
        "wo": _normal((h * hd, d), out_std, g, device, dtype),
    }
    zeros = lambda n: torch.zeros(n, device=device, dtype=dtype)  # noqa: E731
    if cfg.attn_qkv_bias:
        p.update(bq=zeros(h * hd), bk=zeros(kv * hd), bv=zeros(kv * hd))
    if cfg.attn_out_bias:
        p["bo"] = zeros(d)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device, dtype=dtype)
        p["k_norm"] = torch.ones(hd, device=device, dtype=dtype)
    return p


def init_mlp(cfg: ModelConfig, g: torch.Generator, device, dtype,
             d_ff: int = 0) -> Params:
    """``d_ff`` overrides ``cfg.d_ff`` (the MoE family's dense layers)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    std, out_std = 0.02, 0.02 / math.sqrt(2 * cfg.num_layers)
    p: Params = {}
    if cfg.act == "silu":
        p["w_gate"] = _normal((d, f), std, g, device, dtype)
    p["w_up"] = _normal((d, f), std, g, device, dtype)
    p["w_down"] = _normal((f, d), out_std, g, device, dtype)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros(f, device=device, dtype=dtype)
        p["b_down"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def init_embedding(cfg: ModelConfig, g: torch.Generator, device,
                   dtype) -> Params:
    p: Params = {
        "embedding": _normal((cfg.vocab_size, cfg.d_model), 0.02, g, device,
                             dtype),
        "final_norm": torch.ones(cfg.d_model, device=device, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((cfg.d_model, cfg.vocab_size), 0.02, g,
                               device, dtype)
    return p
