"""Collective building blocks on ``torch.distributed``, the port of
``repro.dist.collectives``.

The disaggregated multi-pod runs live or die on collective traffic: the
DP gradient all-reduce in training, the KV/state movement between stages
in serving, and halo exchange for sequence-sharded attention
(``seq_shard_kv``). The reference writes these against ``jax.lax`` axis
primitives inside ``shard_map``; here each function runs on every rank of
a process group and takes, in place of the axis name, a ``group``: a
``ProcessGroup`` (None: the default group), or a ``DeviceMesh`` with the
name of one of its dims in ``dim``. Ranks are the group's own (0 .. n-1),
in the role of the reference's axis index.

The reference's semantics hold: shards concatenate in rank order, rank 0
receives zeros in ``halo_exchange``, buckets hold about ``bucket_bytes``
and are reduced in the bucket's result type, and ``compressed_psum``
returns ``(mean, err)``. Every function works in a world of one, where
``ring_pass`` is the identity.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def _group(group, dim: Optional[str]):
    """The process group of ``group`` (a mesh's dim ``dim``; None: the
    default group)."""
    if isinstance(group, DeviceMesh):
        return group.get_group(dim)
    return dist.group.WORLD if group is None else group


def _size_rank(pg) -> Tuple[int, int]:
    return dist.get_world_size(pg), dist.get_rank(pg)


def _exchange(pg, send: Optional[Tuple[torch.Tensor, int]],
              recv: Optional[Tuple[torch.Tensor, int]]) -> None:
    """One send and one receive (either may be None) to and from group
    ranks, posted together and waited for."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send[0],
                              dist.get_global_rank(pg, send[1]), pg))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv[0],
                              dist.get_global_rank(pg, recv[1]), pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


# ----------------------------------------------------------------------
def ring_pass(x: torch.Tensor, group=None, dim: Optional[str] = None,
              shift: int = 1) -> torch.Tensor:
    """Cyclic shift along the group: rank i receives from rank i-shift.
    The identity where the shift comes back to the rank itself (a world
    of one)."""
    pg = _group(group, dim)
    n, r = _size_rank(pg)
    if shift % n == 0:
        return x
    out = torch.empty_like(x)
    _exchange(pg, (x.contiguous(), (r + shift) % n), (out, (r - shift) % n))
    return out


def ring_allgather(x: torch.Tensor, group=None,
                   dim: Optional[str] = None) -> torch.Tensor:
    """All-gather via n-1 ring passes; shards concatenate along dim 0 in
    rank order on every rank.

    The bandwidth-optimal schedule on a ring of links, written out so the
    per-hop traffic is explicit."""
    pg = _group(group, dim)
    n, r = _size_rank(pg)
    out = x.new_zeros((n,) + tuple(x.shape))
    cur = x
    for k in range(n):
        out[(r - k) % n] = cur          # after k passes we hold shard r-k
        if k < n - 1:
            cur = ring_pass(cur, pg)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:])) \
        if x.dim() else out.reshape(n)


def halo_exchange(x: torch.Tensor, group=None, dim: Optional[str] = None,
                  *, halo: int = 1, seq_axis: int = 1) -> torch.Tensor:
    """Prepend the previous rank's trailing ``halo`` slices along
    ``seq_axis`` (rank 0 receives zeros: the sequence boundary).

    This is the boundary traffic of sequence-sharded attention / conv:
    each shard needs its left neighbor's tail to compute its first
    positions."""
    pg = _group(group, dim)
    n, r = _size_rank(pg)
    s = x.shape[seq_axis]
    tail = x.narrow(seq_axis, s - halo, halo).contiguous()
    recv = torch.zeros_like(tail)
    # non-cyclic: the last rank sends nothing, rank 0 receives nothing
    _exchange(pg, (tail, r + 1) if r < n - 1 else None,
              (recv, r - 1) if r > 0 else None)
    return torch.cat([recv, x], dim=seq_axis)


# ----------------------------------------------------------------------
def bucketed_psum(tree: Any, group=None, dim: Optional[str] = None,
                  bucket_bytes: int = 4 << 20) -> Any:
    """Sum a gradient tree over the group in flattened buckets of
    ~``bucket_bytes``.

    Numerically identical to a per-leaf sum; the point is launch overhead
    — hundreds of tiny per-parameter all-reduces become a few fused ones
    (the "bucket small collectives" lever in the roofline advice). Leaves
    go in ``tree_leaves`` order (the reference's)."""
    pg = _group(group, dim)
    leaves = tree_leaves(tree)
    buckets, cur, cur_bytes = [], [], 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)

    out = [None] * len(leaves)
    for idxs in buckets:
        dt = functools.reduce(torch.promote_types,
                              [leaves[i].dtype for i in idxs])
        flat = torch.cat([leaves[i].reshape(-1).to(dt) for i in idxs])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=pg)
        off = 0
        for i in idxs:
            leaf = leaves[i]
            out[i] = flat[off:off + leaf.numel()].reshape(
                leaf.shape).to(leaf.dtype)
            off += leaf.numel()
    return tree_unflatten(tree, out)


# ----------------------------------------------------------------------
def compressed_psum(tree: Any, group=None, dim: Optional[str] = None,
                    err: Optional[Any] = None) -> Tuple[Any, Any]:
    """int8-quantized gradient all-reduce with error feedback.

    Each leaf is scaled to int8 by its local absmax, the dequantized
    values are mean-reduced (as the reference reduces them), and the
    local quantization residual is returned as the error-feedback carry:
    feed it back as ``err`` on the next step and the accumulated update
    stays unbiased.

    Returns ``(mean_tree, err_tree)``; the errors are f32."""
    pg = _group(group, dim)
    n = dist.get_world_size(pg)
    leaves = tree_leaves(tree)
    errs_in = ([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for g in leaves] if err is None else tree_leaves(err))
    means, errs_out = [], []
    for g, e in zip(leaves, errs_in):
        val = g.float() + e
        scale = torch.clamp(val.abs().max() / 127.0, min=1e-30)
        q = torch.clamp(torch.round(val / scale), -127.0, 127.0)
        deq = q * scale            # what crosses the wire, dequantized
        total = deq.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pg)
        means.append((total / n).to(g.dtype))
        errs_out.append(val - deq)
    return tree_unflatten(tree, means), tree_unflatten(tree, errs_out)
