"""Step builders, the port of ``repro.serve.steps``.

Each builder takes a mesh (``launch.mesh``: a ``DeviceMesh``, or the
one-device ``AbstractMesh`` of a process with no process group) and
computes the production shardings as the reference's builders do: params
tensor-parallel, the optimizer moments TP plus ZeRO over the data axes,
the batch and the decode state by their rules (``dist.sharding``). They
come back in ``StepBundle.shardings`` as trees of DTensor placements, and
``abstract_args`` are meta tensors (shapes and dtypes, no memory).

On a mesh of one device the step runs eagerly on that device, on local
tensors. On a ``DeviceMesh`` of more than one device it distributes each
argument that is not a DTensor yet by the bundle's shardings
(``distribute_tensor``: every rank passes the same global tensor), runs
the same code on the DTensors, with the tensors the code makes itself
taken as replicated (``implicit_replication``), and returns DTensors:
DTensor inserts the collectives that the placements call for. The dry
run (``launch.dryrun``) calls it on fake DTensors under a fake process
group. An ``AbstractMesh`` of more than one device has no devices to run
on, and its step raises.

  train    loss, its gradient by autograd, and AdamW, all in place: the
           params and the optimizer state passed in are updated and
           returned, as the reference donates them (``donate_argnums``)
  prefill  ``Model.prefill`` under ``torch.no_grad()``
  decode   ``Model.decode_step`` under ``torch.no_grad()``
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.dist.sharding import (batch_shardings, batch_spec,
                                       data_axes, opt_state_shardings,
                                       param_shardings, placements,
                                       replicated, state_shardings)
from repro_torch.models import get_model
from repro_torch.train.optimizer import (AdamWState, Optimizer, adamw,
                                         cosine_schedule, tree_leaves)


class StepBundle(NamedTuple):
    """A step plus everything needed to call it."""
    fn: Any                      # the step
    abstract_args: Tuple         # meta tensors of its arguments
    shardings: Tuple             # placements trees, one per argument
    model: Any


def _distribute(tree, shardings, mesh):
    """Each tensor leaf of ``tree`` that is not a DTensor yet distributed
    by the like-shaped placements tree ``shardings``; a batch dict's key
    that the bundle does not name takes ``batch_spec``'s placements."""
    if isinstance(tree, DTensor):
        return tree
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k], mesh) if k in shardings
                else _distribute(v, placements(batch_spec(
                    tuple(np.shape(v)), mesh), mesh), mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_placements(shardings):
        out = [_distribute(t, s, mesh) for t, s in zip(tree, shardings)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    t = torch.as_tensor(tree if torch.is_tensor(tree) else np.asarray(tree))
    return distribute_tensor(t.to(mesh.device_type), mesh, shardings)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(
        hasattr(p, "is_shard") for p in x)


def _settle(tree, shardings):
    """``tree``'s DTensors redistributed to the like-shaped placements
    tree ``shardings``; where it names none (None), a partial sum is
    reduced (``Partial`` becomes ``Replicate``) and the rest stays."""
    if isinstance(tree, (dict, list, tuple)) and not isinstance(
            tree, DTensor):
        if isinstance(tree, dict):
            return {k: _settle(v, None if shardings is None
                               else shardings[k]) for k, v in tree.items()}
        subs = [None] * len(tree) if shardings is None else shardings
        out = [_settle(t, s) for t, s in zip(tree, subs)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if not isinstance(tree, DTensor):
        return tree
    want = shardings if shardings is not None else tuple(
        Replicate() if p.is_partial() else p for p in tree.placements)
    if tuple(tree.placements) == tuple(want):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def _on_mesh(step, mesh, shardings, out_shardings=lambda out: None):
    """``step`` on the one device of ``mesh``; on a ``DeviceMesh`` of
    more than one device, ``step`` on its arguments distributed by
    ``shardings`` (one placements tree per argument), its outputs placed
    by ``out_shardings(outputs)`` (``_settle``)."""
    if mesh.size() == 1:
        return step
    if not isinstance(mesh, DeviceMesh):
        @functools.wraps(step)
        def unplaced(*args, **kwargs):
            raise ValueError(
                f"{step.__name__} on an abstract mesh of {mesh.size()} "
                f"devices ({dict(zip(mesh.mesh_dim_names, mesh.shape))}): "
                f"a step runs on a DeviceMesh (launch.mesh under a process "
                f"group); this bundle serves placement only")
        return unplaced

    @functools.wraps(step)
    def on_mesh(*args):
        args = tuple(_distribute(a, s, mesh)
                     for a, s in zip(args, shardings))
        with implicit_replication():
            out = step(*args)
            return _settle(out, out_shardings(out))
    return on_mesh


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``; DTensors stay as
    they are."""
    return {k: v if isinstance(v, DTensor) else
            torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                            else v).to(device)
            for k, v in batch.items()}


# ----------------------------------------------------------------------
def build_train_step(cfg: ModelConfig, mesh, shape: InputShape, *,
                     remat: bool = True,
                     optimizer: Optional[Optimizer] = None) -> StepBundle:
    model = get_model(cfg)
    opt = optimizer or adamw(cosine_schedule(3e-4))
    dev = mesh.device_type
    abs_params = model.abstract_params()
    abs_opt = opt.init(abs_params)
    p_sh = param_shardings(cfg, abs_params, mesh)
    # optimizer moments: ZeRO-sharded over data on top of the TP layout
    m_sh = opt_state_shardings(cfg, abs_params, mesh)
    opt_sh = AdamWState(m=m_sh, v=m_sh, count=replicated(mesh))
    abs_batch = model.train_inputs(shape)
    b_sh = batch_shardings(abs_batch, mesh)

    def train_step(params, opt_state: AdamWState, batch
                   ) -> Tuple[Any, AdamWState, torch.Tensor]:
        batch = to_device(batch, dev)
        leaves = tree_leaves(params)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, _ = model.loss(params, batch, remat=remat)
                if isinstance(loss, DTensor):   # a partial sum, reduced
                    loss = loss.redistribute(placements=replicated(mesh))
                grads = list(torch.autograd.grad(
                    loss, leaves, allow_unused=True, materialize_grads=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        opt_state = opt.update_(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return StepBundle(fn=_on_mesh(train_step, mesh, (p_sh, opt_sh, b_sh),
                                  lambda out: (p_sh, opt_sh, None)),
                      abstract_args=(abs_params, abs_opt, abs_batch),
                      shardings=(p_sh, opt_sh, b_sh), model=model)


# ----------------------------------------------------------------------
def build_prefill_step(cfg: ModelConfig, mesh,
                       shape: InputShape) -> StepBundle:
    model = get_model(cfg)
    dev = mesh.device_type
    abs_params = model.abstract_params()
    p_sh = param_shardings(cfg, abs_params, mesh)
    abs_batch = model.prefill_inputs(shape)
    b_sh = batch_shardings(abs_batch, mesh)
    s_max = shape.seq_len

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, to_device(batch, dev), s_max=s_max)

    # the decode state comes out in the decode step's layout
    return StepBundle(fn=_on_mesh(prefill_step, mesh, (p_sh, b_sh),
                                  lambda out: (None, state_shardings(
                                      out[1], mesh))),
                      abstract_args=(abs_params, abs_batch),
                      shardings=(p_sh, b_sh), model=model)


# ----------------------------------------------------------------------
def build_decode_step(cfg: ModelConfig, mesh,
                      shape: InputShape) -> StepBundle:
    """serve_step: one new token against a seq_len-deep decode state."""
    model = get_model(cfg)
    abs_params = model.abstract_params()
    p_sh = param_shardings(cfg, abs_params, mesh)
    inputs = model.decode_inputs(shape)
    dp = data_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_size = math.prod(sizes[a] for a in dp)
    tok_spec = (dp,) if shape.global_batch % dp_size == 0 else ()
    tok_sh = placements(tok_spec, mesh)
    s_sh = state_shardings(inputs["state"], mesh)

    @torch.no_grad()
    def serve_step(params, tokens, state, pos):
        return model.decode_step(params, tokens, state, pos)

    return StepBundle(fn=_on_mesh(serve_step, mesh,
                                  (p_sh, tok_sh, s_sh, tok_sh),
                                  lambda out: (None, s_sh)),
                      abstract_args=(abs_params, inputs["tokens"],
                                     inputs["state"], inputs["pos"]),
                      shardings=(p_sh, tok_sh, s_sh, tok_sh), model=model)


# ----------------------------------------------------------------------
def build_step(kind: str, cfg: ModelConfig, mesh,
               shape: InputShape, **kw) -> StepBundle:
    if kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh, shape)
    if kind == "decode":
        return build_decode_step(cfg, mesh, shape)
    raise ValueError(kind)
