"""Weight bridge: the reference's parameter tree -> the port's params.

The reference (``repro.models.transformer.init``) stacks every layer
leaf on a leading [L] axis for its layer scan and stores projections
[in, out] for ``x @ W``; ``tie_embeddings`` reads ``embedding.T`` as the
LM head. The port keeps the [in, out] layout and ties the same way, so
the bridge only splits the layer axis into a list of per-layer dicts and
moves each leaf to the device and dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import dtype_of


def _leaf(x, device, dtype) -> torch.Tensor:
    # via float32: numpy has no native bfloat16, and the widening is exact
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig,
                          device="cuda",
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Any]:
    """``np_params``: the reference's dense-family tree as numpy arrays
    (``{"embed": {...}, "layers": {... [L, ...] leaves}}``). Returns
    ``{"embed": {...}, "layers": [per-layer dict] * L}`` in ``dtype``
    (default ``cfg.param_dtype``) on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"no weight bridge for {cfg.family!r}")
    dtype = dtype or dtype_of(cfg.param_dtype)
    emb = _tree(np_params["embed"], lambda x: _leaf(x, device, dtype))
    stacked = _tree(np_params["layers"], lambda x: _leaf(x, device, dtype))
    layers = [_tree(stacked, lambda x, i=i: x[i])
              for i in range(cfg.num_layers)]
    return {"embed": emb, "layers": layers}
