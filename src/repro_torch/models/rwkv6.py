"""RWKV6 "Finch" (rwkv6-3b), the port of ``repro.models.rwkv6``:
attention-free, with a data-dependent per-channel decay.

Each block = time-mix (the matrix-valued recurrence; its prefill scan is
the ``rwkv6_scan`` CUDA kernel) + channel-mix (a token-shifted
squared-ReLU FFN). There is no KV cache: the per-sequence serving state
is fixed-size,

  wkv   [L, B, NH, hd, hd] f32   recurrence state (key x value)
  tm_x  [L, B, d]                last token seen by the time-mix shift
  cm_x  [L, B, d]                last token seen by the channel-mix shift

which makes this arch the paper's degenerate-transfer case: the
prefill->decode handoff does not grow with the prompt.

Params: ``{"embed": {...}, "layers": [per-layer dict, ...]}``; the
reference's layer ``scan`` is a Python loop over the layer list.
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


class RWKVState(NamedTuple):
    wkv: torch.Tensor    # [L, B, NH, hd, hd] f32
    tm_x: torch.Tensor   # [L, B, d]
    cm_x: torch.Tensor   # [L, B, d]


NUM_MIX = 5  # token-shift mixers: w, k, v, r, g


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_block(cfg: ModelConfig, g: torch.Generator, device,
               dtype) -> Dict[str, Any]:
    r = cfg.rwkv
    d, ff = cfg.d_model, cfg.d_ff
    nh = d // r.head_dim
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.num_layers)

    def mat(shape, s=std):
        return L._normal(shape, s, g, device, dtype)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    return {
        # --- time mix ---
        "mu_base": full((d,), 0.5),
        "mu": full((NUM_MIX, d), 0.5),
        "tm_w1": mat((d, NUM_MIX * r.mix_lora)),
        "tm_w2": mat((NUM_MIX, r.mix_lora, d)),
        "w0": full((d,), -1.0),                    # base log-log decay
        "w1": mat((d, r.decay_lora)),
        "w2": mat((r.decay_lora, d)),
        "u": mat((nh, r.head_dim), 0.1),           # per-head bonus
        "wr": mat((d, d)),
        "wk": mat((d, d)),
        "wv": mat((d, d)),
        "wg": mat((d, d)),
        "wo": mat((d, d), out_std),
        "ln_x_scale": full((d,), 1.0),
        "ln_x_bias": full((d,), 0.0),
        # --- channel mix ---
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": mat((d, ff)),
        "cm_wv": mat((ff, d), out_std),
        "cm_wr": mat((d, d)),
        # --- norms ---
        "norm_tm": L.init_rms_norm(d, device, dtype),
        "norm_cm": L.init_rms_norm(d, device, dtype),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    """Seeded parameters with the reference's distributions in
    ``cfg.param_dtype``. ``generator`` must live on ``device``."""
    dtype = L.dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(cfg, generator, device, dtype),
        "layers": [init_block(cfg, generator, device, dtype)
                   for _ in range(cfg.num_layers)],
    }


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda") -> RWKVState:
    r = cfg.rwkv
    nh = cfg.d_model // r.head_dim
    Lc = cfg.num_layers
    return RWKVState(
        wkv=torch.zeros((Lc, batch, nh, r.head_dim, r.head_dim),
                        dtype=torch.float32, device=device),
        tm_x=torch.zeros((Lc, batch, cfg.d_model), dtype=dtype,
                         device=device),
        cm_x=torch.zeros((Lc, batch, cfg.d_model), dtype=dtype,
                         device=device),
    )


# ----------------------------------------------------------------------
# token shift helpers
# ----------------------------------------------------------------------
def _shift_seq(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, d] -> previous-token view; position 0 sees ``prev`` (or 0)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay w in (0, 1), f32. xw: [..., d]."""
    loglog = (p["w0"].float()
              + torch.tanh(xw.float() @ p["w1"].float()) @ p["w2"].float())
    return torch.exp(-torch.exp(loglog))


def _mix_inputs(p, x: torch.Tensor, xx: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift lerp (ddlerp) for the 5 mixers."""
    base = x + xx * p["mu_base"].to(x.dtype)
    lora = torch.tanh(base.float() @ p["tm_w1"].float())
    lora = L.unflatten(lora, -1, (NUM_MIX, lora.shape[-1] // NUM_MIX))
    mix = torch.einsum("...ml,mld->...md", lora,
                       p["tm_w2"].float())                      # [...,5,d]
    mus = p["mu"].float()                                       # [5, d]
    return tuple(x + xx * (mus[i] + mix[..., i, :]).to(x.dtype)
                 for i in range(NUM_MIX))  # xw, xk, xv, xr, xg


def _ln_x(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head group norm over head_dim (RWKV's ln_x), in f32."""
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    return (yf - mean) * torch.rsqrt(var + eps)


# ----------------------------------------------------------------------
# blocks (sequence form, for prefill)
# ----------------------------------------------------------------------
def _time_mix_in(p, x: torch.Tensor, cfg: ModelConfig,
                 prev_x: Optional[torch.Tensor]):
    """x [B, T, d] (normed) -> the scan's inputs r, k, v [B,T,NH,hd] in
    the compute dtype and w [B,T,NH,hd] in f32, and the gate g."""
    B, T, d = x.shape
    hd = cfg.rwkv.head_dim
    nh = d // hd
    xx = _shift_seq(x, prev_x) - x
    xw, xk, xv, xr, xg = _mix_inputs(p, x, xx)
    r = L.unflatten(xr @ p["wr"], -1, (nh, hd))
    k = L.unflatten(xk @ p["wk"], -1, (nh, hd))
    v = L.unflatten(xv @ p["wv"], -1, (nh, hd))
    g = F.silu(xg @ p["wg"])
    w = L.unflatten(_decay(p, xw), -1, (nh, hd))
    return r, k, v, w, g


def _time_mix_out(p, y: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The scan's y [..., NH, hd] -> ln_x, gate and output projection."""
    y = L.flatten(_ln_x(y, cfg.norm_eps), -2)
    y = (y * p["ln_x_scale"].float()
         + p["ln_x_bias"].float()).to(x.dtype)
    return (y * g) @ p["wo"]


def time_mix_seq(p, x: torch.Tensor, cfg: ModelConfig,
                 wkv_state: Optional[torch.Tensor],
                 prev_x: Optional[torch.Tensor]):
    r, k, v, w, g = _time_mix_in(p, x, cfg, prev_x)
    y, wkv_state = ops.rwkv6(r, k, v, w, p["u"], wkv_state)
    return _time_mix_out(p, y, g, x, cfg), wkv_state, x[:, -1]


def _channel_mix(p, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    xk = x + xx * p["cm_mu_k"].to(x.dtype)
    xr = x + xx * p["cm_mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (k @ p["cm_wv"])


def channel_mix_seq(p, x: torch.Tensor, prev_x: Optional[torch.Tensor]):
    return _channel_mix(p, x, _shift_seq(x, prev_x) - x), x[:, -1]


def block_seq(p, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[Tuple] = None):
    """state: (wkv, tm_x, cm_x) for this layer, or None (fresh sequence)."""
    wkv, tm_x, cm_x = state if state is not None else (None, None, None)
    h = L.rms_norm(x, p["norm_tm"], cfg.norm_eps)
    dt, wkv, tm_x = time_mix_seq(p, h, cfg, wkv, tm_x)
    x = x + dt
    h = L.rms_norm(x, p["norm_cm"], cfg.norm_eps)
    dc, cm_x = channel_mix_seq(p, h, cm_x)
    return x + dc, (wkv, tm_x, cm_x)


# ----------------------------------------------------------------------
# blocks (single-token form, for decode)
# ----------------------------------------------------------------------
def block_step(p, x: torch.Tensor, cfg: ModelConfig, state: Tuple):
    """x: [B, d]; state: (wkv [B,NH,hd,hd], tm_x [B,d], cm_x [B,d])."""
    wkv, tm_x, cm_x = state
    B, d = x.shape
    hd = cfg.rwkv.head_dim
    nh = d // hd

    h = L.rms_norm(x, p["norm_tm"], cfg.norm_eps)
    xw, xk, xv, xr, xg = _mix_inputs(p, h, tm_x.to(h.dtype) - h)
    r = L.unflatten(xr @ p["wr"], -1, (nh, hd))
    k = L.unflatten(xk @ p["wk"], -1, (nh, hd))
    v = L.unflatten(xv @ p["wv"], -1, (nh, hd))
    g = F.silu(xg @ p["wg"])
    w = L.unflatten(_decay(p, xw), -1, (nh, hd))
    y, wkv = ops.rwkv6_step(r, k, v, w, p["u"], wkv)
    x = x + _time_mix_out(p, y, g, x, cfg)
    new_tm_x = h

    h = L.rms_norm(x, p["norm_cm"], cfg.norm_eps)
    x = x + _channel_mix(p, h, cm_x.to(h.dtype) - h)
    return x, (wkv, new_tm_x, h)


# ----------------------------------------------------------------------
# model-level entry points
# ----------------------------------------------------------------------
def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = False) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, V]. ``remat``: each layer is
    activation-checkpointed."""
    x = L.embed(params["embed"], tokens, cfg)

    def body(h, lp):
        return block_seq(lp, h, cfg)[0]

    if remat:
        body = L.remat_wrap(body)
    for lp in params["layers"]:
        x = body(x, lp)
    return L.lm_logits(params["embed"], x, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True):
    """Differentiable on both devices: on the card the scan's gradient is
    the rwkv6 backward kernel (``kernels/rwkv6_scan.py::RWKV6Scan``)."""
    logits = forward(params, batch["tokens"], cfg, remat=remat)
    return TF.cross_entropy(logits, batch["targets"], batch.get("mask")), {}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, RWKVState]:
    """Prefill = one scan over the prompt per layer; returns the
    fixed-size state (``s_max`` is accepted for the API and unused)."""
    del s_max
    x = L.embed(params["embed"], tokens, cfg)
    states = []
    for lp in params["layers"]:
        x, st = block_seq(lp, x, cfg)
        states.append(st)
    wkv, tm_x, cm_x = (torch.stack(s) for s in zip(*states))
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, RWKVState(wkv=wkv, tm_x=tm_x, cm_x=cm_x)


def decode_step(params, tokens: torch.Tensor, state: RWKVState,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, RWKVState]:
    """tokens: [B]; ``pos`` is unused (the recurrence is position-free).
    Returns (logits [B, V], the advanced state)."""
    del pos
    x = L.embed(params["embed"], tokens[:, None], cfg)[:, 0]
    states = []
    for lp, wkv, tm_x, cm_x in zip(params["layers"], *state):
        x, st = block_step(lp, x, cfg, (wkv, tm_x, cm_x))
        states.append(st)
    wkv, tm_x, cm_x = (torch.stack(s) for s in zip(*states))
    logits = L.lm_logits(params["embed"], x[:, None], cfg)[:, 0]
    return logits, RWKVState(wkv=wkv, tm_x=tm_x, cm_x=cm_x)
