"""Mixture-of-experts transformer (deepseek-moe-16b, moonshot-v1-16b-a3b),
the port of ``repro.models.moe``.

Attention is the dense GQA of ``transformer.py``; the FFN of layers
``>= first_k_dense`` is a fine-grained MoE: ``num_experts`` routed experts
of width ``d_expert`` with top-k token choice, plus ``num_shared_experts``
always-on shared experts fused into one dense SwiGLU.

Dispatch is sort-based with capacity, as in the reference:

  1. router top-k -> (expert, weight) per token slot, T*K slots
  2. stable sort of the slots by expert; rank within the expert's run
  3. scatter the kept slots into an [E, C, d] buffer
  4. batched per-expert SwiGLU, [E,C,d] x [E,d,f]
  5. gather back, weight, and sum each token's K slots

Slots past capacity C are dropped (they contribute nothing). Prefill
sizes C from ``capacity_factor``; decode from ``decode_capacity_factor``
(``dropless``), which still drops when one expert gets more than C of a
batch's slots: whether a decode token loses a slot depends on the batch
it shares a step with, by the reference's design. ``decode_drops()``
counts the dropped decode slots.

Parity with the reference: the top-k and the sort are stable (ties go
to the lower expert or slot index, as ``lax.top_k`` and ``jnp.argsort``
break them); dropped slots land in one extra buffer row that is cut off;
the combine un-permutes to [T, K, d] and sums over K by a reduction, not
by ``index_add_``, whose atomics would add in a varying order.

With the ``local_moe_dispatch`` perf flag the tokens are dispatched in
groups, as in the reference: the first g of (16, 8, 4, 2) with T % g ==
0 and T / g >= E, each group sorted and capacity-bounded on its own (C
from T / g tokens), and the aux loss from the summed counts and the
averaged router probabilities. Without it, one group.

Decode on the serving path goes through the paged pool
(``decode_step_paged``, the paged-attention kernel), as the dense
family's does; the reference decodes MoE from the dense cache.

Params: ``{"embed", "dense_layers": [...], "moe_layers": [...]}``, each
layer ``{"attn", "ffn", "norm_attn", "norm_mlp"}``; the router is f32
whatever ``param_dtype`` is.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import opt_flags
from . import layers as L
from . import transformer as TF

AttnCache = TF.AttnCache

# dropped decode slots, summed on each device without a host sync
_DROPS: Dict[torch.device, torch.Tensor] = {}


def decode_drops() -> int:
    """Decode slots dropped at capacity since ``reset_decode_drops``."""
    return sum(int(t) for t in _DROPS.values())


def reset_decode_drops() -> None:
    _DROPS.clear()


def _count_drops(keep: torch.Tensor) -> None:
    n = (~keep).sum()
    total = _DROPS.get(keep.device)
    if total is None:
        _DROPS[keep.device] = n
    else:
        total.add_(n)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_moe_ffn(cfg: ModelConfig, g: torch.Generator, device,
                 dtype) -> Dict[str, Any]:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    std, out_std = 0.02, 0.02 / math.sqrt(2 * cfg.num_layers)
    p: Dict[str, Any] = {
        "router": L._normal((d, E), std, g, device, torch.float32),
        "w_gate": L._normal((E, d, f), std, g, device, dtype),
        "w_up": L._normal((E, d, f), std, g, device, dtype),
        "w_down": L._normal((E, f, d), out_std, g, device, dtype),
    }
    if m.num_shared_experts:
        fs = m.num_shared_experts * f
        p["shared"] = {
            "w_gate": L._normal((d, fs), std, g, device, dtype),
            "w_up": L._normal((d, fs), std, g, device, dtype),
            "w_down": L._normal((fs, d), out_std, g, device, dtype),
        }
    return p


def _init_block(cfg: ModelConfig, g, device, dtype, dense: bool):
    return {
        "attn": L.init_attention(cfg, g, device, dtype),
        "ffn": (L.init_mlp(cfg, g, device, dtype, d_ff=cfg.moe.dense_d_ff)
                if dense else init_moe_ffn(cfg, g, device, dtype)),
        "norm_attn": torch.ones(cfg.d_model, device=device, dtype=dtype),
        "norm_mlp": torch.ones(cfg.d_model, device=device, dtype=dtype),
    }


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    """Seeded parameters with the reference's distributions."""
    dtype = L.dtype_of(cfg.param_dtype)
    n_dense = cfg.moe.first_k_dense
    params: Dict[str, Any] = {
        "embed": L.init_embedding(cfg, generator, device, dtype)}
    if n_dense:
        params["dense_layers"] = [
            _init_block(cfg, generator, device, dtype, True)
            for _ in range(n_dense)]
    params["moe_layers"] = [
        _init_block(cfg, generator, device, dtype, False)
        for _ in range(cfg.num_layers - n_dense)]
    return params


# ----------------------------------------------------------------------
# routed expert dispatch (sort + scatter, capacity-bounded)
# ----------------------------------------------------------------------
def capacity(slots: int, cfg: ModelConfig, dropless: bool) -> int:
    """Expert capacity C for ``slots`` = T*K routed slots."""
    m = cfg.moe
    if dropless:
        return min(slots, max(int(math.ceil(
            slots / m.num_experts * m.decode_capacity_factor)), 1))
    return max(int(math.ceil(slots / m.num_experts * m.capacity_factor)), 1)


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., d] -> (y [..., d], aux_loss scalar). ``dropless``: decode
    capacity (see ``capacity``)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    groups = 1
    if opt_flags.enabled("local_moe_dispatch"):
        groups = next((g for g in (16, 8, 4, 2)
                       if T % g == 0 and T // g >= cfg.moe.num_experts), 1)
    if groups > 1:
        parts = [_dispatch(p, xg, cfg, dropless)
                 for xg in xt.reshape(groups, T // groups, d)]
        y = torch.cat([y for y, _, _ in parts])
        # the aux loss from global routing stats: summed counts and
        # averaged probs give the ungrouped loss (a mean of per-group
        # losses would not: f_e * P_e is quadratic in the stats)
        counts = torch.stack([c for _, c, _ in parts]).sum(0)
        frac_probs = torch.stack([f for _, _, f in parts]).mean(0)
    else:
        y, counts, frac_probs = _dispatch(p, xt, cfg, dropless)
    aux = _aux_loss(counts, frac_probs, cfg, T)
    if cfg.moe.num_shared_experts:
        s = p["shared"]
        y = y + (F.silu(xt @ s["w_gate"]) * (xt @ s["w_up"])) @ s["w_down"]
    return L.unflatten(y, 0, tuple(lead)).to(x.dtype), aux


def _aux_loss(counts: torch.Tensor, frac_probs: torch.Tensor,
              cfg: ModelConfig, total_tokens: int) -> torch.Tensor:
    """Switch load-balance loss E * sum f_e * P_e from routing stats."""
    m = cfg.moe
    frac_tokens = counts / (total_tokens * m.top_k)
    return (m.num_experts * (frac_tokens * frac_probs).sum()
            * m.router_aux_loss)


def route(p: Dict[str, Any], xt: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities [T, E] (f32) and the top-k (weights
    renormalised, expert ids) [T, K], ties to the lower expert id."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    weight, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight, idx = weight[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    weight = weight / weight.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, weight, idx


def _dispatch(p, xt: torch.Tensor, cfg: ModelConfig, dropless: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort + scatter dispatch over one token group. xt: [T, d] ->
    (y [T, d], expert_counts [E], mean_probs [E]).

    On DTensors (a step on a mesh of many devices) every device gathers
    the group's tokens and every expert, and dispatches them all: DTensor
    has no sharded strategy for the sort, the rank search and the
    scatter. The outputs are replicated."""
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        rep = [Replicate()] * mesh.ndim

        def full(t):
            return t.redistribute(mesh, rep).to_local()
        outs = _dispatch({k: full(v) for k, v in p.items()
                          if isinstance(v, DTensor)}, full(xt), cfg,
                         dropless)
        return tuple(DTensor.from_local(t, mesh, rep, run_check=False)
                     for t in outs)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T, d = xt.shape
    dev = xt.device
    probs, weight, idx = route(p, xt, cfg)
    # (bincount would read the largest id back to the host on the card)
    counts = (idx.reshape(-1, 1) == torch.arange(E, device=dev)).sum(0)
    counts = counts.float()
    frac_probs = probs.mean(0)

    # --- sort slots by expert; rank within the expert's run ---
    S = T * K
    flat_e = idx.reshape(S)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(S, device=dev) - torch.searchsorted(se, se)
    C = capacity(S, cfg, dropless)
    keep = rank < C
    if dropless:
        _count_drops(keep)
    # kept slots to se*C + rank; dropped ones to the extra row E*C
    dest = torch.where(keep, se * C + rank, E * C)
    xe = xt.new_zeros(E * C + 1, d)
    xe[dest] = xt[flat_t[order]]
    xe = xe[:E * C].reshape(E, C, d)

    # --- batched per-expert SwiGLU ---
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # --- gather back, weight, un-permute to [T, K, d], sum over K ---
    back = torch.where(keep[:, None], ye[dest.clamp_max(E * C - 1)],
                       ye.new_zeros(()))
    contrib = back * weight.reshape(S)[order][:, None].to(back.dtype)
    slots = torch.empty_like(contrib)
    slots[order] = contrib
    return slots.reshape(T, K, d).sum(1), counts, frac_probs


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def _dense_ffn(p, h, cfg: ModelConfig) -> torch.Tensor:
    return L.mlp_forward(p["ffn"], h, cfg)


def _moe_decode_ffn(p, h, cfg: ModelConfig) -> torch.Tensor:
    return moe_ffn(p["ffn"], h, cfg, dropless=True)[0]


def _blocks(params) -> List[Tuple[Dict[str, Any], bool]]:
    """(layer params, dense?) in layer order."""
    return ([(lp, True) for lp in params.get("dense_layers", [])]
            + [(lp, False) for lp in params["moe_layers"]])


def block_forward(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, dense: bool):
    """Full-seq block. x: [B, S, d] -> (x, aux, (k, v))."""
    q, k, v = TF._attn_in(p, x, positions, cfg)
    attn = L.flash_gqa(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + L.out_project(p["attn"], attn, cfg)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if dense:
        ffn = L.mlp_forward(p["ffn"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        ffn, aux = moe_ffn(p["ffn"], h, cfg)
    return x + ffn, aux, (k, v)


def block_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
                 dense: bool):
    """One-token block step on a dense cache (the reference's decode)."""
    q, k, v = TF._attn_in(p, x, pos[:, None], cfg)
    cache_k = L.cache_write(cache_k, k, pos)
    cache_v = L.cache_write(cache_v, v, pos)
    attn = L.cached_attention(q, cache_k, cache_v, pos,
                              window=cfg.sliding_window)
    ffn = _dense_ffn if dense else _moe_decode_ffn
    return TF._attn_out_mlp(p, x, attn, cfg, ffn), cache_k, cache_v


# ----------------------------------------------------------------------
# model-level entry points (the reference's API)
# ----------------------------------------------------------------------
def _run(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = L.embed(params["embed"], tokens, cfg)
    positions = TF._positions(*tokens.shape, tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    ks, vs = [], []
    for lp, dense in _blocks(params):
        x, aux, (k, v) = block_forward(lp, x, positions, cfg, dense)
        aux_total = aux_total + aux
        ks.append(k)
        vs.append(v)
    return x, aux_total, ks, vs


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V], aux_loss). ``remat``: each
    layer is activation-checkpointed."""
    x = L.embed(params["embed"], tokens, cfg)
    positions = TF._positions(*tokens.shape, tokens.device)

    def body(h, lp, dense):
        h, aux, _ = block_forward(lp, h, positions, cfg, dense)
        return h, aux

    if remat:
        body = L.remat_wrap(body)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp, dense in _blocks(params):
        x, aux = body(x, lp, dense)
        aux_total = aux_total + aux
    return L.lm_logits(params["embed"], x, cfg), aux_total


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True):
    """-> (cross-entropy + the load-balance loss, {"aux_loss", "ce"})."""
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    ce = TF.cross_entropy(logits, batch["targets"], batch.get("mask"))
    return ce + aux, {"aux_loss": aux, "ce": ce}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, AttnCache]:
    """tokens: [B, S] -> (last-position logits [B, V], dense cache padded
    to ``s_max`` slots)."""
    x, _, ks, vs = _run(params, tokens, cfg)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, TF.stack_cache(ks, vs, s_max or tokens.shape[1])


def decode_step(params, tokens: torch.Tensor, cache: AttnCache,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, AttnCache]:
    """One token per sequence against the dense cache (plain attention)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    ks, vs = [], []
    for (lp, dense), ck, cv in zip(_blocks(params), cache.k, cache.v):
        x, ck, cv = block_decode(lp, x, ck, cv, pos, cfg, dense)
        ks.append(ck)
        vs.append(cv)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]
    return logits, AttnCache(k=torch.stack(ks), v=torch.stack(vs))


def decode_step_paged(params, tokens: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token per sequence against the paged pool through the
    paged-attention kernel (see ``transformer.decode_step_paged``)."""
    blocks = [(lp, _dense_ffn if dense else _moe_decode_ffn)
              for lp, dense in _blocks(params)]
    return TF.decode_step_paged(params, tokens, k_pages, v_pages,
                                block_table, pos, cfg, blocks=blocks)
