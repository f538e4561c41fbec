"""Mamba2 blocks + the Zamba2 hybrid model (zamba2-2.7b), the port of
``repro.models.mamba2``.

Zamba2 = a backbone of Mamba2 blocks with ONE weight-tied ("shared")
full attention block invoked every ``hybrid.shared_attn_every`` layers.
Prefill runs the ``mamba2_ssd`` CUDA kernel in every Mamba2 layer and the
flash kernel (hd 80 at full width) in every shared-block call. The
serving handoff state is mixed:

  conv   [L, B, cw-1, conv_dim]    causal-conv tail (fixed size)
  ssm    [L, B, NH, N, P] f32      SSD recurrence state (fixed size)
  attn   [G, B, S_cache, KV, hd]   KV cache of the G shared-block calls
                                   (the only per-token-growing part)

At long context the shared block runs with a sliding window
(``hybrid.long_context_window``) and its cache becomes a fixed-size ring.
Decode attention (dense cache or ring) is plain torch, as in the
reference; the paged kernel is not on this path.

Params: ``{"embed": {...}, "mamba_layers": [per-layer dict] * L,
"shared_attn": {"attn": {...}, "norm": ...}}``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from . import layers as L
from . import transformer as TF


class ZambaState(NamedTuple):
    conv: torch.Tensor     # [L, B, cw-1, conv_dim]
    ssm: torch.Tensor      # [L, B, NH, N, P] f32
    attn_k: torch.Tensor   # [G, B, S_cache, KV, hd]
    attn_v: torch.Tensor   # [G, B, S_cache, KV, hd]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_dim
    return d_in, nh, conv_dim, s.state_dim


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_mamba_block(cfg: ModelConfig, g: torch.Generator, device,
                     dtype) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim, N = _dims(cfg)
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)
    f32 = dict(device=device, dtype=torch.float32)
    # in_proj emits [z(d_in), x(d_in), B(N), C(N), dt(nh)]; A_log, D and
    # dt_bias stay f32 whatever param_dtype is, as in the reference
    return {
        "in_proj": L._normal((d, 2 * d_in + 2 * N + nh), std, g, device,
                             dtype),
        "conv_w": L._normal((s.conv_width, conv_dim),
                            1.0 / math.sqrt(s.conv_width), g, device, dtype),
        "out_proj": L._normal((d_in, d), out_std, g, device, dtype),
        "gate_norm": L.init_rms_norm(d_in, device, dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.rand(nh, generator=g, **f32) * 3.0 - 4.0,
        "norm": L.init_rms_norm(d, device, dtype),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    """Seeded parameters with the reference's distributions in
    ``cfg.param_dtype``. ``generator`` must live on ``device``."""
    dtype = L.dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(cfg, generator, device, dtype),
        "mamba_layers": [init_mamba_block(cfg, generator, device, dtype)
                         for _ in range(cfg.num_layers)],
        "shared_attn": {
            "attn": L.init_attention(cfg, generator, device, dtype),
            "norm": L.init_rms_norm(cfg.d_model, device, dtype),
        },
    }


def init_state(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, window: int = 0,
               device="cuda") -> ZambaState:
    s = cfg.ssm
    d_in, nh, conv_dim, N = _dims(cfg)
    G = cfg.num_layers // cfg.hybrid.shared_attn_every
    s_cache = min(window, s_max) if window else s_max
    kv = (G, batch, s_cache, cfg.num_kv_heads, cfg.head_dim)
    return ZambaState(
        conv=torch.zeros((cfg.num_layers, batch, s.conv_width - 1, conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros((cfg.num_layers, batch, nh, N, s.head_dim),
                        dtype=torch.float32, device=device),
        attn_k=torch.zeros(kv, dtype=dtype, device=device),
        attn_v=torch.zeros(kv, dtype=dtype, device=device),
    )


# ----------------------------------------------------------------------
# Mamba2 block (sequence form)
# ----------------------------------------------------------------------
def _mamba_in(p, x: torch.Tensor, cfg: ModelConfig,
              conv_state: Optional[torch.Tensor]):
    """x [B, T, d] -> the scan's inputs (xh [B,T,NH,P], dt [B,T,NH] f32,
    A [NH], B/C [B,T,N]), the gate z and the new conv tail. The depthwise
    causal conv over [x|B|C] is plain torch, as in the reference."""
    s = cfg.ssm
    B, T, d = x.shape
    d_in, nh, conv_dim, N = _dims(cfg)
    z, xc, Bm, Cm, dt_raw = torch.split(x @ p["in_proj"],
                                        [d_in, d_in, N, N, nh], dim=-1)
    xbc = torch.cat([xc, Bm, Cm], dim=-1)                     # [B,T,conv_dim]
    cw = s.conv_width
    tail = (torch.zeros((B, cw - 1, conv_dim), dtype=xbc.dtype,
                        device=x.device)
            if conv_state is None else conv_state.to(xbc.dtype))
    padded = torch.cat([tail, xbc], dim=1)                    # [B,T+cw-1,..]
    w = p["conv_w"].float()
    conv = sum(padded[:, i:i + T].float() * w[i] for i in range(cw))
    conv = F.silu(conv).to(xbc.dtype)
    new_conv_state = padded[:, T:] if cw > 1 else tail

    xc, Bm, Cm = torch.split(conv, [d_in, N, N], dim=-1)
    xh = L.unflatten(xc, -1, (nh, s.head_dim))
    dt = F.softplus(L.add_bias(dt_raw.float(), p["dt_bias"]))   # [B,T,nh]
    A = -torch.exp(p["A_log"])
    return xh, dt, A, Bm, Cm, z, new_conv_state


def _mamba_out(p, y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (Mamba2's norm-before-out_proj with a silu(z) gate)
    and the output projection. y: the scan's [..., NH, P]."""
    y = L.flatten(y, -2) * F.silu(z)
    y = L.rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_seq(p, x: torch.Tensor, cfg: ModelConfig,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None):
    """x: [B, T, d] -> (out [B, T, d], (new_conv_state, new_ssm_state))."""
    xh, dt, A, Bm, Cm, z, new_conv = _mamba_in(p, x, cfg, conv_state)
    y, new_ssm = ops.mamba2(xh, dt, A, Bm, Cm, p["D"], ssm_state,
                            chunk=cfg.ssm.chunk_size)
    return _mamba_out(p, y, z, cfg), (new_conv, new_ssm)


def mamba_step(p, x: torch.Tensor, cfg: ModelConfig,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x: [B, d] single token -> (out [B, d], new states)."""
    s = cfg.ssm
    B, d = x.shape
    d_in, nh, conv_dim, N = _dims(cfg)
    z, xc, Bm, Cm, dt_raw = torch.split(x @ p["in_proj"],
                                        [d_in, d_in, N, N, nh], dim=-1)
    xbc = torch.cat([xc, Bm, Cm], dim=-1)                     # [B, conv_dim]
    w = p["conv_w"].float()
    window = torch.cat([conv_state.float(), xbc.float()[:, None]],
                       dim=1)                                 # [B, cw, cd]
    conv = F.silu(torch.einsum("bwc,wc->bc", window, w)).to(x.dtype)
    new_conv_state = window[:, 1:].to(conv_state.dtype)

    xc, Bm, Cm = torch.split(conv, [d_in, N, N], dim=-1)
    xh = L.unflatten(xc, -1, (nh, s.head_dim))
    dt = F.softplus(L.add_bias(dt_raw.float(), p["dt_bias"]))   # [B, nh]
    A = -torch.exp(p["A_log"])
    y, new_ssm = ops.mamba2_step(xh, dt, A, Bm, Cm, p["D"], ssm_state)
    return _mamba_out(p, y, z, cfg), (new_conv_state, new_ssm)


# ----------------------------------------------------------------------
# shared attention block
# ----------------------------------------------------------------------
def _shared_attn_in(p, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig):
    """Pre-norm, QKV projection and RoPE: x [B,S,d] -> q, k, v."""
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def shared_attn_seq(p, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, window: int, *,
                    return_kv: bool = False):
    q, k, v = _shared_attn_in(p, x, positions, cfg)
    attn = L.flash_gqa(q, k, v, causal=True, window=window)
    out = x + L.out_project(p["attn"], attn, cfg)
    if return_kv:
        return out, (k, v)
    return out


def _ring_write(cache: torch.Tensor, val: torch.Tensor, pos: torch.Tensor,
                ring: bool) -> torch.Tensor:
    """cache: [B, S_cache, KV, hd]; val: [B, 1, KV, hd]; pos: [B]. A
    scatter whatever ``masked_cache_update`` says, as in the reference."""
    slot = pos % cache.shape[1] if ring else pos
    return L.scatter_write(cache, val, slot)


def shared_attn_step(p, x: torch.Tensor, cache_k, cache_v, pos, cfg,
                     window: int):
    """x: [B, 1, d]. Ring cache when window > 0 (cache size == window)."""
    q, k, v = _shared_attn_in(p, x, pos[:, None], cfg)
    ring = window > 0 and cache_k.shape[1] == window
    cache_k = _ring_write(cache_k, k, pos, ring)
    cache_v = _ring_write(cache_v, v, pos, ring)
    # a ring cache holds only slots within the window, by construction:
    # its mask is the positions up to pos, with no window
    attn = L.cached_attention(q, cache_k, cache_v, pos,
                              window=0 if ring else window)
    out = x + L.out_project(p["attn"], attn, cfg)
    return out, cache_k, cache_v


# ----------------------------------------------------------------------
# model-level entry points
# ----------------------------------------------------------------------
def _groups(params, cfg: ModelConfig):
    """The Mamba2 layers in G groups of ``shared_attn_every``, each
    group preceded by one call of the shared attention block."""
    every = cfg.hybrid.shared_attn_every
    layers = params["mamba_layers"]
    G = cfg.num_layers // every
    return [layers[g * every:(g + 1) * every] for g in range(G)]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = False, window: int = 0) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, V]. ``remat``: each group (the
    shared block's call and its Mamba2 layers) is
    activation-checkpointed, as the reference wraps its group body."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S, tokens.device)

    def group_body(h, group):
        h = shared_attn_seq(params["shared_attn"], h, positions, cfg, window)
        for lp in group:
            h = h + mamba_seq(lp, h, cfg)[0]
        return h

    if remat:
        group_body = L.remat_wrap(group_body)
    for group in _groups(params, cfg):
        x = group_body(x, group)
    return L.lm_logits(params["embed"], x, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True):
    """Differentiable on both devices: on the card the SSD scan trains
    through its forward and backward kernels (``Mamba2SSD``), the shared
    block through flash's."""
    logits = forward(params, batch["tokens"], cfg, remat=remat)
    return TF.cross_entropy(logits, batch["targets"], batch.get("mask")), {}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: Optional[int] = None, window: int = 0
            ) -> Tuple[torch.Tensor, ZambaState]:
    """tokens: [B, S] -> (last-position logits [B, V], state). The shared
    block's KV is padded with zeros to ``s_max`` slots, or, with a
    window shorter than the prompt, kept as a ring of ``window`` slots
    holding the last ``window`` tokens at ``pos % window``."""
    B, S = tokens.shape
    s_max = s_max or S
    s_cache = min(window, s_max) if window else s_max
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S, tokens.device)
    ks, vs, convs, ssms = [], [], [], []
    for group in _groups(params, cfg):
        x, (k, v) = shared_attn_seq(params["shared_attn"], x, positions,
                                    cfg, window, return_kv=True)
        ks.append(k)
        vs.append(v)
        for lp in group:
            out, (cs, ss) = mamba_seq(lp, x, cfg)
            x = x + out
            convs.append(cs)
            ssms.append(ss)
    ks, vs = torch.stack(ks), torch.stack(vs)        # [G, B, S, KV, hd]

    if window and S > s_cache:
        # the last s_cache positions, position t in ring slot t % s_cache:
        # rolled by the shift, as two slices
        cut = s_cache - (S - s_cache) % s_cache
        ks, vs = (torch.cat([t[:, :, S - s_cache + cut:],
                             t[:, :, S - s_cache:S - s_cache + cut]], dim=2)
                  for t in (ks, vs))
    elif s_cache > S:
        pad = (0, 0, 0, 0, 0, s_cache - S)
        ks, vs = F.pad(ks, pad), F.pad(vs, pad)

    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, ZambaState(conv=torch.stack(convs),
                              ssm=torch.stack(ssms), attn_k=ks, attn_v=vs)


def decode_step(params, tokens: torch.Tensor, state: ZambaState,
                pos: torch.Tensor, cfg: ModelConfig, window: int = 0
                ) -> Tuple[torch.Tensor, ZambaState]:
    """tokens: [B]; pos: [B] their positions. Returns (logits [B, V],
    the advanced state)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)        # [B, 1, d]
    every = cfg.hybrid.shared_attn_every
    ks, vs, convs, ssms = [], [], [], []
    for g, group in enumerate(_groups(params, cfg)):
        x, ck, cv = shared_attn_step(params["shared_attn"], x,
                                     state.attn_k[g], state.attn_v[g], pos,
                                     cfg, window)
        ks.append(ck)
        vs.append(cv)
        for e, lp in enumerate(group):
            i = g * every + e
            out, (cs, ss) = mamba_step(lp, x[:, 0], cfg, state.conv[i],
                                       state.ssm[i])
            x = x + out[:, None]
            convs.append(cs)
            ssms.append(ss)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]
    return logits, ZambaState(conv=torch.stack(convs), ssm=torch.stack(ssms),
                              attn_k=torch.stack(ks), attn_v=torch.stack(vs))
