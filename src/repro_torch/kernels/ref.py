"""Plain torch versions of the kernels.

They are the correctness references (the kernel wrappers compare against
them on the card) and the CPU execution path: a wrapper handed a CPU
tensor runs these. Same signatures and layouts as ``repro.kernels.ref``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, T, KV, hd] -> [B, S, H, hd].

    ``q_offset`` places the query block at absolute position offset within
    the key sequence (used for chunked prefill).
    """
    B, S, H, hd = q.shape
    logits, mask = _flash_logits(q, k, causal, window, q_offset)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _flash_logits(q, k, causal: bool, window: int, q_offset: int):
    """(scaled logits [B, KV, G, S, T] in f32, visibility mask [S, T])."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return logits, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0) -> torch.Tensor:
    """The log-sum-exp of each query row's visible scores in the log2
    domain, log2(sum_t 2^(q.k_t log2(e) / sqrt(hd))), as the flash forward
    kernel keeps it for the backward: [B, H, S] f32, 0 for a row that sees
    no key. (No counterpart in the reference, whose forward keeps none.)"""
    B, S, H, _ = q.shape
    logits, mask = _flash_logits(q, k, causal, window, q_offset)
    lse = torch.logsumexp(logits.masked_fill(~mask, -math.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse * math.log2(math.e), 0.0)
    return lse.reshape(B, H, S)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """q: [B, H, hd]; k_pages/v_pages: [P, page, KV, hd];
    block_table: [B, max_pages] int32 (entries past the sequence are
    arbitrary); seq_lens: [B] int32 -> out [B, H, hd].
    """
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    G = H // KV
    T = block_table.shape[1] * page
    bt = block_table.long()
    # gather each sequence's pages into a contiguous [B, T, KV, hd] copy
    k_seq = k_pages[bt].reshape(B, T, KV, hd)
    v_seq = v_pages[bt].reshape(B, T, KV, hd)
    qg = q.reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_seq.float()) / math.sqrt(hd)
    valid = (torch.arange(T, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])                    # [B, T]
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_seq.float())
    return out.reshape(B, H, hd).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RWKV6 recurrence with a per-channel decay.

    r, k, v, w: [B, T, NH, hd] (w in (0, 1), already exp(-exp(.)));
    u: [NH, hd] bonus; state: [B, NH, hd, hd] (key x value), default
    zeros. Returns (y [B, T, NH, hd] in r's dtype, final state in f32).

      y_t = S_t^T r_t + (r_t . (u * k_t)) v_t
      S_{t+1} = diag(w_t) S_t + k_t v_t^T
    """
    B, T, NH, hd = r.shape
    S = (torch.zeros((B, NH, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # [B,NH,hd]
        y = torch.einsum("bhc,bhcj->bhj", rt, S)
        y = y + (rt * (uf[None] * kt)).sum(-1, keepdim=True) * vt
        S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
        ys.append(y)
    y = torch.stack(ys, 1) if ys else rf.new_zeros((B, 0, NH, hd))
    return y.to(r.dtype), S


def mamba2_ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_mat: torch.Tensor, C_mat: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba2 recurrence with a scalar decay per head.

    x: [B, T, NH, P]; dt: [B, T, NH] (> 0); A: [NH] (< 0; decay
    exp(A dt)); B_mat, C_mat: [B, T, N] (one group, shared by the heads);
    D: [NH] skip, optional; state: [B, NH, N, P], default zeros.
    Returns (y [B, T, NH, P] in x's dtype, final state in f32).

      S_t = exp(A dt_t) S_{t-1} + B_t (dt_t x_t)^T
      y_t = S_t^T C_t + D x_t
    """
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    S = (torch.zeros((Bsz, NH, N, P), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B_mat.float(), C_mat.float()
    Af = A.float()
    ys = []
    for t in range(T):
        xt, dtt, Bt, Ct = xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        decay = torch.exp(Af[None] * dtt)                       # [B, NH]
        S = (decay[..., None, None] * S
             + Bt[:, None, :, None] * (dtt[..., None] * xt)[:, :, None, :])
        ys.append(torch.einsum("bhnp,bn->bhp", S, Ct))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((Bsz, 0, NH, P))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), S
