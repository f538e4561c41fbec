"""Weight bridge: the reference's parameter tree -> the port's params.

The reference stacks every layer leaf on a leading [L] axis for its
layer scan and stores projections [in, out] for ``x @ W``;
``tie_embeddings`` reads ``embedding.T`` as the LM head. The port keeps
the [in, out] layout and ties the same way, so the bridge only splits
each stack's layer axis into a list of per-layer dicts and moves each
leaf to the device and dtype:

  dense   {"embed", "layers": [L, ...]}
  moe     {"embed", "dense_layers": [first_k_dense, ...],
           "moe_layers": [L - first_k_dense, ...]}   expert leaves
                                   [E, d, f] kept whole per layer
  ssm     {"embed", "layers": [L, ...]}                 (rwkv6)
  hybrid  {"embed", "mamba_layers": [L, ...],           (zamba2)
           "shared_attn": {...}}   not stacked: one block, G calls
  vlm     {"embed", "layers": [L, ...], "projector": {...}}
  encdec  {"embed", "frontend_proj": {...}, "encoder": [Le, ...],
           "decoder": [Ld, ...]}

``A_log``, ``D`` and ``dt_bias`` (mamba2) and the MoE ``router`` are f32
in the reference whatever ``param_dtype`` is, and stay f32 here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import dtype_of

_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The family's stacked groups and their depths."""
    L = cfg.num_layers
    if cfg.family in ("dense", "ssm", "vlm"):
        return {"layers": L}
    if cfg.family == "hybrid":
        return {"mamba_layers": L}
    if cfg.family == "moe":
        n = cfg.moe.first_k_dense
        return {"dense_layers": n, "moe_layers": L - n} if n else \
            {"moe_layers": L}
    if cfg.family == "encdec":
        return {"encoder": cfg.encdec.num_encoder_layers,
                "decoder": cfg.encdec.num_decoder_layers}
    raise NotImplementedError(f"no weight bridge for {cfg.family!r}")


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
    arrays. Returns the port's tree, each stack as a list of per-layer
    dicts, in ``dtype`` (default ``cfg.param_dtype``; the
    f32-only leaves stay f32) on ``device``."""
    stacks = _stacks(cfg)
    dtype = dtype or dtype_of(cfg.param_dtype)

    def leaf(x, name):
        return _leaf(x, device,
                     torch.float32 if name in _F32_LEAVES else dtype)

    out = {k: _tree(v, leaf) for k, v in np_params.items()}
    for key, depth in stacks.items():
        out[key] = [_tree(out[key], lambda x, _, i=i: x[i])
                    for i in range(depth)]
    return out
