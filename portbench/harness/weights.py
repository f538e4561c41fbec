"""Seeded weights in the port's parameter layout, made on the device.

The layout (the nested dict of leaf names and shapes) is the port's own,
read from ``Model.abstract_params()`` on the meta device. The values are
the benchmark's: one flat buffer in the served dtype, filled by
``normal_`` from a generator on the device in a few large calls, then
scaled or set leaf group by leaf group by the configuration file's
``init`` table, which gives each leaf name one of

  ["normal", std]       std * N(0, 1)
  ["normal_out", std]   std / sqrt(2 * num_layers) * N(0, 1)
  ["const", value]      every element ``value``

Leaves are views of the buffer, each starting on a 128-byte boundary.
The same seed gives the same weights; the port and the reference are
handed the same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

ALIGN = 64                 # elements: 128 bytes of bf16
CHUNK = 1 << 30            # elements filled by one normal_ call


def _leaves(tree, path=()) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _leaves(t, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, views, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, views, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(t, views, path + (i,)) for i, t in enumerate(tree)]
    return views[path]


def rule_for(init: Dict[str, list], path: Tuple) -> list:
    """The init rule of a leaf: its name is the last string of its path."""
    name = next(p for p in reversed(path) if isinstance(p, str))
    if name not in init:
        raise KeyError(f"the configuration's init table has no rule for "
                       f"leaf {name!r} ({'/'.join(map(str, path))})")
    return init[name]


def make(model, init: Dict[str, list], num_layers: int, seed: int,
         device) -> Any:
    """The port's parameter tree, values drawn from ``seed`` on ``device``."""
    abstract = model.abstract_params()
    leaves = _leaves(abstract)
    dtypes = {t.dtype for _, t in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"mixed parameter dtypes {dtypes}")
    dtype = dtypes.pop()
    # group leaves by rule, so each group is one contiguous range
    groups: Dict[Tuple, List] = {}
    for path, t in leaves:
        rule = rule_for(init, path)
        groups.setdefault((rule[0], float(rule[1])), []).append((path, t))
    offsets, ranges, n = {}, [], 0
    for key, members in groups.items():
        start = n
        for path, t in members:
            offsets[path] = n
            n += -(-t.numel() // ALIGN) * ALIGN
        ranges.append((key, start, n))
    buf = torch.empty(n, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    for lo in range(0, n, CHUNK):
        buf[lo:lo + CHUNK].normal_(generator=g)
    for (kind, value), lo, hi in ranges:
        part = buf[lo:hi]
        if kind == "const":
            part.fill_(value)
        elif kind == "normal":
            part.mul_(value)
        elif kind == "normal_out":
            part.mul_(value / math.sqrt(2 * num_layers))
        else:
            raise ValueError(f"unknown init rule {kind!r}")
    views = {path: buf[offsets[path]:offsets[path] + t.numel()].view(t.shape)
             for path, t in leaves}
    return _rebuild(abstract, views)
