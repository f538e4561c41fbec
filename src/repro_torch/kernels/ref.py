"""Plain torch versions of the attention kernels.

They are the correctness references (the kernel wrappers compare against
them on the card) and the CPU execution path: a wrapper handed a CPU
tensor runs these. Same signatures and layouts as ``repro.kernels.ref``.
"""
from __future__ import annotations

import math

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
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


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
