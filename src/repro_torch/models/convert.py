"""Weight bridge: the reference's parameter tree -> the port's params.

The reference stacks every layer leaf on a leading [L] axis for its
layer scan and stores projections [in, out] for ``x @ W``;
``tie_embeddings`` reads ``embedding.T`` as the LM head. The port keeps
the [in, out] layout and ties the same way, so the bridge only splits
the layer axis into a list of per-layer dicts and moves each leaf to the
device and dtype:

  dense   {"embed", "layers": [L, ...]}
  ssm     {"embed", "layers": [L, ...]}                 (rwkv6)
  hybrid  {"embed", "mamba_layers": [L, ...],           (zamba2)
           "shared_attn": {...}}   not stacked: one block, G calls

``A_log``, ``D`` and ``dt_bias`` are f32 in the reference whatever
``param_dtype`` is, and stay f32 here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import dtype_of

_F32_LEAVES = ("A_log", "D", "dt_bias")
_STACKED = {"dense": "layers", "ssm": "layers", "hybrid": "mamba_layers"}


def _leaf(x, device, dtype) -> torch.Tensor:
    # via float32: numpy has no native bfloat16, and the widening is exact
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _tree(tree, fn, name: str = ""):
    """Apply ``fn(leaf, key)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn, k) for k, v in tree.items()}
    return fn(tree, name)


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig,
                          device="cuda",
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Any]:
    """``np_params``: the reference's tree for ``cfg.family`` as numpy
    arrays. Returns the port's tree, the stacked layers as a list of L
    per-layer dicts, in ``dtype`` (default ``cfg.param_dtype``; the
    f32-only leaves stay f32) on ``device``."""
    if cfg.family not in _STACKED:
        raise NotImplementedError(f"no weight bridge for {cfg.family!r}")
    dtype = dtype or dtype_of(cfg.param_dtype)

    def leaf(x, name):
        return _leaf(x, device,
                     torch.float32 if name in _F32_LEAVES else dtype)

    out = {k: _tree(v, leaf) for k, v in np_params.items()}
    key = _STACKED[cfg.family]
    out[key] = [_tree(out[key], lambda x, _, i=i: x[i])
                for i in range(cfg.num_layers)]
    return out
