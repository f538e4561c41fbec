"""Common model building blocks (plain torch functions on dict params).

Conventions, as in ``repro.models.layers``:
  * params are nested dicts of tensors; weights are stored [in, out] and
    applied as ``x @ W``, the reference's layout, so the weight bridge
    (``convert``) copies them as they are;
  * activations flow in ``cfg.compute_dtype``; norms/softmax/logits in f32;
  * attention math routes through ``repro_torch.kernels.ops``, so the CUDA
    kernels and their plain versions share one call site.

The perf flags of ``repro_torch.dist.opt_flags`` branch here as in the
reference: ``remat_dots`` (``remat_wrap``), ``pad_heads`` and
``head_shard_attn`` (``flash_gqa``), ``masked_cache_update``
(``cache_write``) and ``bf16_logits`` (``lm_logits``). With no flag set
each function runs its default branch.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import opt_flags
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


# products with no batch dimension: the ``x @ W`` projections (a 3-D
# activation times a weight folds to ``mm``), the MoE router and the
# shared experts. ``bmm`` has a batch dimension (attention's scores, the
# MoE experts, the scans' einsums) and is recomputed, as JAX recomputes
# batched dots.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_dots``: JAX's
    ``dots_with_no_batch_dims_saveable``. The flash kernel runs inside an
    autograd Function whose launch is a ``repro_torch`` operator, no
    aten product, so its output is recomputed, as JAX recomputes a Pallas
    call (which is no dot): the policy caches no buffer that the kernel
    writes into."""
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body):
    """Activation-checkpoint a layer body (the reference's
    ``jax.checkpoint``): its activations are dropped after the forward
    pass and recomputed in the backward pass. With the ``remat_dots``
    perf flag (read when the body is wrapped, as the reference reads it
    when tracing), the outputs of products with no batch dimension are
    saved instead of recomputed (``_dots_saveable``)."""
    policy = {}
    if opt_flags.enabled("remat_dots"):
        policy["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)

    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False, **policy)
    return wrapped


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              tp: int = 16) -> torch.Tensor:
    """Full-sequence GQA attention with optional exact head regrouping.
    q [B,S,H,hd]; k,v [B,T,KV,hd].

    With the ``pad_heads`` perf flag and H % tp != 0 (yi-34b: 56, qwen2:
    14, llama32-3b: 24), queries are regrouped so that the head dim
    divides the model axis: each kv head is duplicated tp/KV times in
    place (kv-major, ``repeat_interleave``), and its G query heads are
    spread over the duplicates, zero-padded to equal groups. Zero q rows
    attend uniformly, and their outputs are sliced away: bit-exact.

    ``head_shard_attn`` pins the head dims to the 'model' axis, as the
    reference's sharding constraint does, on the unpadded path: each of
    q, k and v that is a DTensor is redistributed to heads on the
    mesh's 'model' dim where its head count divides that dim
    (``heads_on_model``). Local tensors (a mesh of one device) stay as
    they are, as the reference's constraint is skipped with no mesh in
    scope.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if (not opt_flags.enabled("pad_heads") or H % tp == 0
            or tp % KV != 0 or KV >= tp):
        q, k, v = heads_on_model(q, k, v)
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    dup = tp // KV
    Gp = -(-G // dup)                     # q heads per duplicated kv head
    pad = dup * Gp - G
    qg = F.pad(q.reshape(B, S, KV, G, hd), (0, 0, 0, pad))
    # [B,S,KV,dup,Gp,hd] -> heads (KV*dup) * Gp, kv-major like GQA expects
    qg = qg.reshape(B, S, KV * dup * Gp, hd)
    kd = k.repeat_interleave(dup, dim=2)
    vd = v.repeat_interleave(dup, dim=2)
    out = ops.flash_attention(qg, kd, vd, causal=causal, window=window)
    # the slice is strided: reshape copies it into a contiguous [B,S,H,hd]
    out = out.reshape(B, S, KV, dup * Gp, hd)[:, :, :, :G]
    return out.reshape(B, S, H, hd)


def heads_on_model(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """With ``head_shard_attn``: each DTensor [B, S, heads, hd] with its
    head dim sharded on the mesh's 'model' dim where the head count
    divides it, the other mesh dims' placements kept (the reference's
    ``P.UNCONSTRAINED``). Anything else is returned as it is."""
    if not opt_flags.enabled("head_shard_attn"):
        return tensors
    out = []
    for t in tensors:
        names = (t.device_mesh.mesh_dim_names or ()) \
            if isinstance(t, DTensor) else ()
        if "model" in names:
            m = names.index("model")
            if t.shape[2] % t.device_mesh.shape[m] == 0:
                pl = list(t.placements)
                pl[m] = Shard(2)
                t = t.redistribute(t.device_mesh, pl)
        out.append(t)
    return tuple(out)


def scatter_write(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Write one token's K or V ([B, 1, KV, hd]) into a copy of a
    [B, S, KV, hd] cache at per-batch position ``pos``, by a scatter. A
    DTensor cache (a step on a mesh of many devices) takes the select
    of ``masked_cache_update`` instead, the same values bit for bit:
    DTensor has no sharded strategy for the scatter's ``index_put``."""
    if isinstance(cache, DTensor):
        return select_write(cache, new, pos)
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), pos.long()] = \
        new[:, 0].to(cache.dtype)
    return out


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write one token's K or V ([B, 1, KV, hd]) into a copy of a
    [B, S, KV, hd] cache at per-batch position ``pos``: a scatter, or
    with ``masked_cache_update`` an elementwise select over the sequence
    dim (``select_write``; the same values, bit for bit)."""
    if opt_flags.enabled("masked_cache_update"):
        return select_write(cache, new, pos)
    return scatter_write(cache, new, pos)


def select_write(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """``scatter_write``'s values by an elementwise select over the
    sequence dim."""
    idx = torch.arange(cache.shape[1], device=cache.device)
    sel = idx[None, :, None, None] == pos.to(cache.device)[
        :, None, None, None]
    return torch.where(sel, new.to(cache.dtype), cache)


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
        q = add_bias(q, p["bq"])
        k = add_bias(k, p["bk"])
        v = add_bias(v, p["bv"])
    q, k, v = (unflatten(t, -1, (n, hd)) for t, n in ((q, h), (k, kv),
                                                       (v, kv)))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gathered_uneven(t: DTensor, dim: int, size: int) -> DTensor:
    """``t`` with each mesh dim that shards its ``dim`` gathered where
    the mesh dims sharding it, taken in order, stop dividing ``size``."""
    mesh, n, ways = t.device_mesh, t.ndim, 1
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if p.is_shard() and p.dim % n == dim:
            if size % (ways * mesh.size(i)):
                pl[i] = Replicate()
            else:
                ways *= mesh.size(i)
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def unflatten(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``. A DTensor whose ``dim`` is sharded
    over more ways than divide ``sizes[0]`` is gathered on those mesh
    dims first: DTensor cannot split an unevenly sharded dim."""
    if isinstance(t, DTensor):
        t = _gathered_uneven(t, dim % t.ndim, sizes[0])
    return t.unflatten(dim, sizes)


def flatten(t: torch.Tensor, start: int, end: int = -1) -> torch.Tensor:
    """``t.flatten(start, end)``. A DTensor is first gathered on each
    mesh dim that shards a dim of the range other than its first, or the
    first unevenly: DTensor merges dims only where the outer one alone
    is sharded, evenly."""
    if isinstance(t, DTensor):
        n = t.ndim
        first, last = start % n, end % n
        t = _gathered_uneven(t, first, t.shape[first])
        pl = [Replicate() if p.is_shard() and first < p.dim % n <= last
              else p for p in t.placements]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.flatten(start, end)


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b`` for a product ``y`` and a bias over its last dim. A
    DTensor product that is a partial sum on a mesh dim is first reduced
    there: scattered over its last dim where the bias is sharded so,
    else whole (DTensor cannot split a bias into partial sums)."""
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        bias = b.placements if isinstance(b, DTensor) else \
            [Replicate()] * y.device_mesh.ndim
        y = y.redistribute(y.device_mesh, [
            (Shard(y.ndim - 1) if bp.is_shard() else Replicate())
            if p.is_partial() else p for p, bp in zip(y.placements, bias)])
    return y + b


def out_project(p: Params, attn: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """attn: [B, S, H, hd] -> [B, S, d]."""
    o = flatten(attn, -2) @ p["wo"]
    if cfg.attn_out_bias:
        o = add_bias(o, p["bo"])
    return o


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Decode-step attention against a dense KV cache (plain torch).

    q: [B, 1, H, hd] (already rotated); cache_k/v: [B, T, KV, hd] (new
    K/V already written at ``pos``); pos: [B]. Reads the whole cache and
    masks positions > pos: the dense analogue of the paged kernel.
    """
    if isinstance(cache_k, DTensor):
        return _cached_attention_on_shards(q, cache_k, cache_v, pos, window)
    return _cached_attention(q, cache_k, cache_v, pos, window,
                             math.sqrt(q.shape[-1]))


def _cached_attention(q, cache_k, cache_v, pos, window: int, scale: float,
                      reduce_logits=None):
    """``cached_attention`` on local tensors; ``reduce_logits`` sums
    partial logits across devices, if given."""
    B, _, H, hd = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.float()) / scale
    if reduce_logits is not None:
        logits = reduce_logits(logits)
    kpos = torch.arange(T, device=q.device)[None, :]
    pos = pos.to(q.device)
    mask = kpos <= pos[:, None]
    if window > 0:
        mask = mask & (kpos > (pos[:, None] - window))
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _cached_attention_on_shards(q, cache_k, cache_v, pos, window: int):
    """``cached_attention`` of DTensors, computed on each device's shards
    in the cache's layout (the decode state's, which it keeps): q and pos
    follow the cache's batch sharding, and its heads or head-dim
    sharding (the heads only where both head counts divide the mesh
    dim). Where the head dim is split, each device's logits are a
    partial sum over its slice, reduced across those devices before the
    softmax; a sequence split (``seq_shard_kv``) is gathered first. The
    output is placed as q is."""
    mesh, n = cache_k.device_mesh, cache_k.ndim
    H, KV = q.shape[2], cache_k.shape[2]

    def kv_layout(p, i):
        d = p.dim % n if p.is_shard() else None
        if d == 0 or d == 3 or (d == 2 and H % mesh.size(i) == 0):
            return Shard(d)
        return Replicate()
    pl = [kv_layout(p, i) for i, p in enumerate(cache_k.placements)]
    cache_k, cache_v, q = (t.redistribute(mesh, pl)
                           for t in (cache_k, cache_v, q))
    if not isinstance(pos, DTensor):
        pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    pos = pos.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                  for p in pl]).to_local()
    split_hd = [p.is_shard(3) for p in pl]

    def reduce_logits(logits):
        # [b, KV, G, T]: batch and kv heads as the cache, the head dim's
        # mesh dims partial sums
        placed = [Partial() if s else (p if p.is_shard(0) else
                                       Shard(1) if p.is_shard(2) else p)
                  for p, s in zip(pl, split_hd)]
        full = DTensor.from_local(logits, mesh, placed, run_check=False)
        return full.redistribute(mesh, [Replicate() if s else p for p, s
                                        in zip(placed, split_hd)]).to_local()
    out = _cached_attention(q.to_local(), cache_k.to_local(),
                            cache_v.to_local(), pos, window,
                            math.sqrt(q.shape[-1]),
                            reduce_logits if any(split_hd) else None)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=q.shape, stride=q.stride())


# ----------------------------------------------------------------------
# FFN (SwiGLU / GELU)
# ----------------------------------------------------------------------
def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_bias:
        up = add_bias(up, p["b_up"])
    if cfg.act == "silu":
        hidden = F.silu(x @ p["w_gate"]) * up
    else:
        hidden = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out = hidden @ p["w_down"]
    if cfg.mlp_bias:
        out = add_bias(out, p["b_down"])
    return out


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------
def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``tokens``, by ``F.embedding``, which DTensor shards
    where it cannot shard indexing. A DTensor table's vocab split is
    turned into a d_model split first (its rows whole where d_model does
    not divide): a vocab-split lookup gives partial sums whose gradient
    DTensor cannot take back."""
    table = p["embedding"].to(dtype_of(cfg.compute_dtype))
    if isinstance(table, DTensor):
        mesh = table.device_mesh
        table = table.redistribute(mesh, [
            (Shard(1) if table.shape[1] % mesh.size(i) == 0
             else Replicate()) if pl.is_shard(0) else pl
            for i, pl in enumerate(table.placements)])
    return F.embedding(tokens, table)


def lm_logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    if opt_flags.enabled("bf16_logits"):
        # the head product and the logits in the operands' dtype (bf16
        # under bf16 params and compute); the loss still upcasts
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
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
