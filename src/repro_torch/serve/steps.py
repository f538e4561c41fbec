"""Step builders, the port of ``repro.serve.steps``.

The reference jits each step with the production shardings of a mesh
and lowers it for the dry run. The port runs eagerly on one device:
each builder takes the ``device`` where the reference takes the mesh,
``shardings`` holds that device once per argument, and the
``abstract_args`` are meta tensors (shapes and dtypes, no memory).
Sharding over several cards comes with ``dist/``.

  train    loss, its gradient by autograd, and AdamW, all in place: the
           params and the optimizer state passed in are updated and
           returned, as the reference donates them (``donate_argnums``)
  prefill  ``Model.prefill`` under ``torch.no_grad()``
  decode   ``Model.decode_step`` under ``torch.no_grad()``
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import get_model
from repro_torch.train.optimizer import (AdamWState, Optimizer, adamw,
                                         cosine_schedule, tree_leaves)


class StepBundle(NamedTuple):
    """A step plus everything needed to call it."""
    fn: Any                      # the step
    abstract_args: Tuple         # meta tensors of its arguments
    shardings: Tuple             # the device of each argument
    model: Any


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


# ----------------------------------------------------------------------
def build_train_step(cfg: ModelConfig, device, shape: InputShape, *,
                     remat: bool = True,
                     optimizer: Optional[Optimizer] = None) -> StepBundle:
    model = get_model(cfg)
    opt = optimizer or adamw(cosine_schedule(3e-4))
    dev = torch.device(device)
    abs_params = model.abstract_params()
    abs_opt = opt.init(abs_params)
    abs_batch = model.train_inputs(shape)

    def train_step(params, opt_state: AdamWState, batch
                   ) -> Tuple[Any, AdamWState, torch.Tensor]:
        batch = to_device(batch, dev)
        leaves = tree_leaves(params)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, _ = model.loss(params, batch, remat=remat)
                grads = list(torch.autograd.grad(
                    loss, leaves, allow_unused=True, materialize_grads=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        opt_state = opt.update_(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return StepBundle(fn=train_step,
                      abstract_args=(abs_params, abs_opt, abs_batch),
                      shardings=(dev, dev, dev), model=model)


# ----------------------------------------------------------------------
def build_prefill_step(cfg: ModelConfig, device,
                       shape: InputShape) -> StepBundle:
    model = get_model(cfg)
    dev = torch.device(device)
    s_max = shape.seq_len

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, to_device(batch, dev), s_max=s_max)

    return StepBundle(fn=prefill_step,
                      abstract_args=(model.abstract_params(),
                                     model.prefill_inputs(shape)),
                      shardings=(dev, dev), model=model)


# ----------------------------------------------------------------------
def build_decode_step(cfg: ModelConfig, device,
                      shape: InputShape) -> StepBundle:
    """serve_step: one new token against a seq_len-deep decode state."""
    model = get_model(cfg)
    dev = torch.device(device)
    inputs = model.decode_inputs(shape)

    @torch.no_grad()
    def serve_step(params, tokens, state, pos):
        return model.decode_step(params, tokens, state, pos)

    return StepBundle(fn=serve_step,
                      abstract_args=(model.abstract_params(),
                                     inputs["tokens"], inputs["state"],
                                     inputs["pos"]),
                      shardings=(dev, dev, dev, dev), model=model)


# ----------------------------------------------------------------------
def build_step(kind: str, cfg: ModelConfig, device,
               shape: InputShape, **kw) -> StepBundle:
    if kind == "train":
        return build_train_step(cfg, device, shape, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, device, shape)
    if kind == "decode":
        return build_decode_step(cfg, device, shape)
    raise ValueError(kind)
