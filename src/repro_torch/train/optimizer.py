"""AdamW and the cosine schedule over the port's params trees, the port
of ``repro.train.optimizer`` (no optax there, no ``torch.optim`` here).

A params tree is nested dicts, lists and tuples of tensors. Its leaves
are taken in the reference's order (``jax.tree.leaves``: dict keys
sorted, sequences in order), so the gradient norm sums the per-leaf
squares in the order the reference stacks them. The optimizer state is
a params-shaped pair (m, v) of f32 moments (f32 under bf16 params) and
an int32 scalar ``count``.

The arithmetic is the reference's, in its order: grads to f32, clip by
the global norm, ``b1 ** count`` in f32, the update in f32 cast to the
param's dtype. The reference casts the whole grad tree to f32 at once;
here each leaf is cast as it is used, after the norm is taken from the
per-leaf sums: the same numbers without an f32 copy of the whole tree
(12.8 GB at llama32-3b's full width). ``update`` returns the updates as
the reference does; ``update_`` applies them in place (params, m and v
overwritten, each grad dropped once used): the reference's train step
donates params and state, and at full width the card has no room for a
second copy of either.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


# ----------------------------------------------------------------------
# params trees
# ----------------------------------------------------------------------
def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the like-shaped
    ``rest``, visited in ``tree_leaves`` order; keeps the containers
    (a NamedTuple stays one)."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves: List[Any]):
    """The tree of ``like``'s shape holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


class Optimizer(NamedTuple):
    init: Callable[[Any], AdamWState]
    update: Callable[[Any, AdamWState, Any], Tuple[Any, AdamWState]]
    update_: Callable[[List[torch.Tensor], AdamWState, Any], AdamWState]


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip_norm: Optional[float] = 1.0) -> Optimizer:
    """learning_rate: float or callable(count tensor) -> lr."""

    def lr_at(count):
        if callable(learning_rate):
            return learning_rate(count)
        return learning_rate

    def init(params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        device = tree_leaves(params)[0].device
        return AdamWState(m=tree_map(zeros, params),
                          v=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device))

    def scale_of(grads: List[torch.Tensor]):
        if grad_clip_norm is None:
            return None
        gnorm = global_norm(grads)
        return torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)

    def step_of(count):
        count = count + 1
        c = count.float()
        return count, lr_at(count), 1.0 - b1 ** c, 1.0 - b2 ** c

    def leaf_(p, g, m, v, scale, lr, c1, c2) -> torch.Tensor:
        """Moments of one leaf updated in place; returns its update."""
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        step = step + weight_decay * p.float()
        return (-lr * step).to(p.dtype)

    @torch.no_grad()
    def update(grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        g = tree_leaves(grads)
        scale = scale_of(g)
        count, lr, c1, c2 = step_of(state.count)
        m = tree_map(torch.clone, state.m)
        v = tree_map(torch.clone, state.v)
        updates = [leaf_(*x, scale, lr, c1, c2) for x in zip(
            tree_leaves(params), g, tree_leaves(m), tree_leaves(v))]
        return (tree_unflatten(params, updates),
                AdamWState(m=m, v=v, count=count))

    @torch.no_grad()
    def update_(grads: List[torch.Tensor], state: AdamWState,
                params) -> AdamWState:
        """In place: ``grads`` is the list of grads in ``tree_leaves``
        order, emptied as it goes; params, m and v are overwritten."""
        scale = scale_of(grads)
        count, lr, c1, c2 = step_of(state.count)
        for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                          tree_leaves(state.m),
                                          tree_leaves(state.v))):
            p.add_(leaf_(p, grads[i], m, v, scale, lr, c1, c2))
            grads[i] = None
        return AdamWState(m=state.m, v=state.v, count=count)

    return Optimizer(init=init, update=update, update_=update_)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


# ----------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup_steps: int = 200,
                    total_steps: int = 10_000,
                    final_frac: float = 0.1) -> Callable:
    def lr(count):
        c = count.float()
        warm = peak_lr * c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup_steps, warm, peak_lr * cos)
    return lr
