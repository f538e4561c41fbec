"""RWKV6 "Finch" (arXiv:2404.05892) as the port builds it, plain f32.

  x_0 = E[token]
  per layer:  h = RMSNorm(x) * g_tm;  dx = shift(h) - h   (shift: the
              previous position's h, 0 before the first)
              ddlerp: b = h + dx * mu_base;  m = tanh(b W_1) split into 5
              groups of ``mix_lora``;  x_i = h + dx * (mu_i + m_i W_2,i)
              for i = w, k, v, r, g
              w = exp(-exp(w_0 + tanh(x_w W_d1) W_d2))   per channel
              r, k, v = x_r W_r, x_k W_k, x_v W_v;  g = silu(x_g W_g)
              per head (hd = ``head_dim``), from S = 0:
                y_t = S_t^T r_t + (r_t . (u * k_t)) v_t
                S_{t+1} = diag(w_t) S_t + k_t v_t^T
              y = GroupNorm_per_head(y) * ln_scale + ln_bias
              x = x + (y * g) W_o
              h = RMSNorm(x) * g_cm;  dx = shift(h) - h
              x = x + sigmoid((h + dx mu_r) W_cr) * (relu((h + dx mu_k)
                  W_ck)^2 W_cv)
  logits = (RMSNorm(x) * g_final) W_head

Departures from the published model that the port makes, and that this
reference follows so that it judges the port's function: RMSNorm with a
scale and no bias in place of the block LayerNorms; the group norm's
epsilon is ``norm_eps``, not 64e-5. The recurrence is evaluated in
chunks (the same sums, grouped): inside a chunk every decay product is
exp of a difference of cumulative log-decays taken in f64, never a
division, so no factor exceeds 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import f32_mm, rms_norm

NUM_MIX = 5
CHUNK = 32
CHUNKS_A_BLOCK = 16


def shift(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)


def wkv(r, k, v, w, u) -> torch.Tensor:
    """The recurrence over T steps from a zero state. r, k, v, w:
    [T, NH, hd] f32 (w in (0, 1)); u: [NH, hd] -> y [T, NH, hd] f32."""
    T, NH, hd = r.shape
    pad = (-T) % CHUNK
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = r.shape[0] // CHUNK
    rc, kc, vc = (x.reshape(n, CHUNK, NH, hd) for x in (r, k, v))
    # cumulative log-decay inside each chunk, f64: Lc[t] = sum_{l<=t} log w_l
    logw = torch.log(w.double().clamp_min(1e-300)).reshape(n, CHUNK, NH, hd)
    Lc = torch.cumsum(logw, dim=1)
    Lprev = Lc - logw                                   # sum_{l<t}
    y = torch.empty(n, CHUNK, NH, hd, dtype=torch.float32, device=r.device)
    ii = torch.arange(CHUNK, device=r.device)
    below = (ii[None, :] < ii[:, None])                 # [i, j]: j < i
    S_in = torch.empty(n, NH, hd, hd, dtype=torch.float32, device=r.device)
    dS = torch.empty_like(S_in)
    for lo in range(0, n, CHUNKS_A_BLOCK):
        hi = min(lo + CHUNKS_A_BLOCK, n)
        # A[c, i, j, h, e] = prod_{j<l<i} w_l = exp(Lprev_i - Lc_j), j < i
        ex = Lprev[lo:hi, :, None] - Lc[lo:hi, None, :]
        ex = torch.where(below[None, :, :, None, None], ex,
                         torch.full_like(ex, float("-inf")))
        A = torch.exp(ex).float()
        att = torch.einsum("cihe,cjhe,cijhe->chij", rc[lo:hi], kc[lo:hi], A)
        y[lo:hi] = torch.einsum("chij,cjhe->cihe", att, vc[lo:hi])
        bonus = (rc[lo:hi] * u.float()[None, None] * kc[lo:hi]).sum(-1)
        y[lo:hi] += bonus[..., None] * vc[lo:hi]
        # the chunk's own term of the carried state, decayed to its end
        tail = torch.exp(Lc[lo:hi, -1:] - Lc[lo:hi]).float()   # [c,t,h,e]
        dS[lo:hi] = torch.einsum("cthe,cthf->chef", kc[lo:hi] * tail,
                                 vc[lo:hi])
    decay = torch.exp(Lc[:, -1]).float()                # [n, NH, hd]
    S = torch.zeros(NH, hd, hd, dtype=torch.float32, device=r.device)
    for c in range(n):
        S_in[c] = S
        S = decay[c][..., None] * S + dS[c]
    into = torch.exp(Lprev).float()                     # prod_{l<t} w_l
    y += torch.einsum("cthe,chef->cthf", rc * into, S_in)
    return y.reshape(n * CHUNK, NH, hd)[:T]


def group_norm(y: torch.Tensor, eps: float) -> torch.Tensor:
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mean) * torch.rsqrt(var + eps)


def hidden(params, cfg: dict, tokens: torch.Tensor, mm=f32_mm
           ) -> torch.Tensor:
    """tokens [N] -> the final-normed hidden state [N, d], f32."""
    eps = cfg["norm_eps"]
    hd = cfg["rwkv"]["head_dim"]
    N, d = tokens.shape[0], cfg["d_model"]
    nh = d // hd
    x = params["embed"]["embedding"][tokens].float()
    for lp in params["layers"]:
        f = {k: t.float() for k, t in lp.items()}
        h = rms_norm(x, f["norm_tm"], eps)
        dx = shift(h) - h
        base = h + dx * f["mu_base"]
        m = torch.tanh(mm(base, f["tm_w1"])).reshape(N, NUM_MIX, -1)
        mix = torch.stack([mm(m[:, i], f["tm_w2"][i])
                           for i in range(NUM_MIX)], dim=1)
        xw, xk, xv, xr, xg = (h + dx * (f["mu"][i] + mix[:, i])
                              for i in range(NUM_MIX))
        w = torch.exp(-torch.exp(f["w0"] + mm(torch.tanh(mm(xw, f["w1"])),
                                              f["w2"])))
        r, k, v = (mm(a, f[n]).reshape(N, nh, hd)
                   for a, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
        g = F.silu(mm(xg, f["wg"]))
        y = wkv(r, k, v, w.reshape(N, nh, hd), f["u"])
        y = group_norm(y, eps).reshape(N, d) * f["ln_x_scale"] \
            + f["ln_x_bias"]
        x = x + mm(y * g, f["wo"])
        h = rms_norm(x, f["norm_cm"], eps)
        dx = shift(h) - h
        kk = torch.relu(mm(h + dx * f["cm_mu_k"], f["cm_wk"])).square()
        x = x + torch.sigmoid(mm(h + dx * f["cm_mu_r"], f["cm_wr"])) \
            * mm(kk, f["cm_wv"])
    return rms_norm(x, params["embed"]["final_norm"], eps)


# ----------------------------------------------------------------------
# the work of the port's calls, counted from shapes
# ----------------------------------------------------------------------
def _layer_params(cfg: dict) -> int:
    d, ff, r = cfg["d_model"], cfg["d_ff"], cfg["rwkv"]
    return (6 * d * d + d * NUM_MIX * r["mix_lora"]
            + NUM_MIX * r["mix_lora"] * d + 2 * d * r["decay_lora"]
            + 2 * d * ff)


def weight_bytes(cfg: dict, elem: int = 2) -> int:
    return (cfg["num_layers"] * _layer_params(cfg)
            + cfg["d_model"] * cfg["vocab_size"]) * elem


def _state_bytes(cfg: dict) -> int:
    """One sequence's carried state: the f32 wkv state and the two
    shifted rows of every layer."""
    d, hd = cfg["d_model"], cfg["rwkv"]["head_dim"]
    return cfg["num_layers"] * (d * hd * 4 + 2 * d * 2)


def prefill_work(cfg: dict, S: int, elem: int = 2):
    """(FLOPs, bytes) of one prefill of S tokens: the products of every
    layer, the recurrence (4 operations per step, key and value), the
    head on the last position; the weights read once, the state
    written once."""
    L, d, hd = cfg["num_layers"], cfg["d_model"], cfg["rwkv"]["head_dim"]
    flops = 2.0 * L * _layer_params(cfg) * S + 4.0 * L * S * d * hd \
        + 2.0 * d * cfg["vocab_size"]
    return flops, weight_bytes(cfg, elem) + _state_bytes(cfg)


def decode_work(cfg: dict, ctxs, elem: int = 2):
    """(FLOPs, bytes) of one decode step of a batch of len(ctxs)
    sequences: the products, the recurrence and the head for each; the
    weights read once, each state read and written once."""
    L, d, hd = cfg["num_layers"], cfg["d_model"], cfg["rwkv"]["head_dim"]
    B = len(ctxs)
    flops = 2.0 * B * (L * _layer_params(cfg) + d * cfg["vocab_size"]) \
        + 4.0 * B * L * d * hd
    return flops, weight_bytes(cfg, elem) + 2 * B * _state_bytes(cfg)
