"""The dense decoder with grouped-query attention (Llama architecture, as
Yi-34B publishes it: arXiv:2403.04652), plain f32.

  x_0 = E[token]
  per layer:  h = RMSNorm(x) * g_attn
              q, k, v = h W_q, h W_k, h W_v;  RoPE on q and k (the two
              halves of each head rotated together, base ``rope_theta``)
              a = softmax(q k^T / sqrt(hd), causal) v, each KV head
              shared by num_heads / num_kv_heads query heads
              x = x + a W_o
              h = RMSNorm(x) * g_mlp
              x = x + (silu(h W_gate) * (h W_up)) W_down
  logits = (RMSNorm(x) * g_final) W_head

The weights are the port's tree, read one layer at a time and widened to
f32; every activation stays f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import f32_mm, rms_norm

QUERY_ROWS = 512          # attention's query rows a block


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [N, heads, hd] at positions 0..N-1."""
    N, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = torch.arange(N, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos, sin = (f(ang).float()[:, None, :] for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA. q [N, H, hd], k/v [N, KV, hd] -> [N, H, hd]."""
    N, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    kk = k.permute(1, 2, 0)                      # [KV, hd, N]
    vv = v.permute(1, 0, 2)                      # [KV, N, hd]
    for lo in range(0, N, QUERY_ROWS):
        hi = min(lo + QUERY_ROWS, N)
        qb = q[lo:hi].reshape(hi - lo, KV, G, hd).permute(1, 0, 2, 3)
        s = torch.matmul(qb.reshape(KV, -1, hd), kk[:, :, :hi])
        s = s.reshape(KV, hi - lo, G, hi) / math.sqrt(hd)
        qpos = torch.arange(lo, hi, device=q.device)[:, None, None]
        kpos = torch.arange(hi, device=q.device)[None, None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1).reshape(KV, -1, hi)
        o = torch.matmul(p, vv[:, :hi])           # [KV, rows*G, hd]
        out[lo:hi] = o.reshape(KV, hi - lo, G, hd).permute(1, 0, 2, 3) \
            .reshape(hi - lo, H, hd)
    return out


def hidden(params, cfg: dict, tokens: torch.Tensor, mm=f32_mm
           ) -> torch.Tensor:
    """tokens [N] -> the final-normed hidden state [N, d], f32."""
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    N = tokens.shape[0]
    x = params["embed"]["embedding"][tokens].float()
    for lp in params["layers"]:
        a = lp["attn"]
        h = rms_norm(x, lp["norm_attn"], eps)
        q = rope(mm(h, a["wq"]).reshape(N, H, hd), cfg["rope_theta"])
        k = rope(mm(h, a["wk"]).reshape(N, KV, hd), cfg["rope_theta"])
        v = mm(h, a["wv"]).reshape(N, KV, hd)
        x = x + mm(attention(q, k, v).reshape(N, H * hd), a["wo"])
        m = lp["mlp"]
        h = rms_norm(x, lp["norm_mlp"], eps)
        x = x + mm(F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"]),
                   m["w_down"])
    return rms_norm(x, params["embed"]["final_norm"], eps)


# ----------------------------------------------------------------------
# the work of the port's calls, counted from shapes
# ----------------------------------------------------------------------
def _layer_params(cfg: dict) -> int:
    d, H, KV, hd, ff = (cfg["d_model"], cfg["num_heads"],
                        cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    return d * H * hd * 2 + d * KV * hd * 2 + 3 * d * ff


def weight_bytes(cfg: dict, elem: int = 2) -> int:
    """What one pass reads of the weights: every layer's matrices and
    the head (the embedding table is gathered, a row a token)."""
    return (cfg["num_layers"] * _layer_params(cfg)
            + cfg["d_model"] * cfg["vocab_size"]) * elem


def prefill_work(cfg: dict, S: int, elem: int = 2):
    """(FLOPs, bytes) of one prefill of S tokens: the products of every
    layer, causal attention's (query, key) pairs, the head on the last
    position; the weights read once and the K/V written once."""
    L, H, KV, hd = (cfg["num_layers"], cfg["num_heads"],
                    cfg["num_kv_heads"], cfg["head_dim"])
    flops = 2.0 * L * _layer_params(cfg) * S \
        + 4.0 * L * H * hd * S * (S + 1) / 2 \
        + 2.0 * cfg["d_model"] * cfg["vocab_size"]
    nbytes = weight_bytes(cfg, elem) + 2 * L * S * KV * hd * elem
    return flops, nbytes


def decode_work(cfg: dict, ctxs, elem: int = 2):
    """(FLOPs, bytes) of one decode step of a batch whose sequences hold
    ``ctxs`` tokens before it: the products and the head for each
    sequence, attention over ctx + 1 positions; the weights read once,
    every live K/V row read and the new one written."""
    L, H, KV, hd = (cfg["num_layers"], cfg["num_heads"],
                    cfg["num_kv_heads"], cfg["head_dim"])
    B, live = len(ctxs), sum(c + 1 for c in ctxs)
    flops = 2.0 * B * (L * _layer_params(cfg)
                       + cfg["d_model"] * cfg["vocab_size"]) \
        + 4.0 * L * H * hd * live
    nbytes = weight_bytes(cfg, elem) + 2 * L * (live + B) * KV * hd * elem
    return flops, nbytes
