"""Sharding rules, the port of ``repro.dist.sharding``: a legal spec for
every parameter, batch and decode-state leaf of every arch on every mesh.

Parameters get a tensor-parallel layout over the 'model' axis
(replicated across 'data' and 'pod'), batches shard over the data axes,
and the decode state (the KV cache the paper hands from prefill to
decode) has rules of its own, with the ``seq_shard_kv`` lever. Every
rule is checked against the mesh's axis sizes and falls back along a
fixed chain that ends replicated.

A spec is a tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names (the reference's ``PartitionSpec`` made
plain). ``placements(spec, mesh)`` turns it into the DTensor placements
of a ``DeviceMesh``, and the ``*_shardings`` builders return trees of
those placements.

The rules read only the mesh's axis names and sizes
(``mesh_dim_names`` and ``shape``), so a mesh is either a
``torch.distributed.device_mesh.DeviceMesh`` or an ``AbstractMesh`` of
names and sizes, the counterpart of ``jax.sharding.AbstractMesh``: the
16x16 and 2x16x16 production meshes' rules are checked without a
process group.

The parameter layout differs from the reference's. The reference stacks
each layer group on a leading [L] axis and skips that axis; the port
keeps a list of per-layer dicts (``layers/3/attn/wq``;
``models/convert.py``), so each per-layer leaf gets the reference's spec
of its stacked leaf without the leading entry.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import opt_flags

MODEL_AXIS = "model"
# data-parallel axes in outer-to-inner order; 'pod' exists on the
# multi-pod mesh only (cross-pod DP, or pod-level prefill/decode split).
_DATA_AXIS_ORDER = ("pod", "data")

Spec = Tuple[Any, ...]


class AbstractMesh(NamedTuple):
    """Axis sizes and names with no devices behind them, read as a
    ``DeviceMesh`` is read (``shape``, ``mesh_dim_names``).
    ``device_type`` names the one device a mesh of size 1 runs on
    (``launch.mesh.make_host_mesh``), or is None."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device_type: Optional[str] = None

    def size(self) -> int:
        return math.prod(self.shape)


def abstract_mesh(axis_sizes, axis_names,
                  device_type: Optional[str] = None) -> AbstractMesh:
    """``abstract_mesh((16, 16), ("data", "model"))``."""
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names), device_type)


# ----------------------------------------------------------------------
# mesh introspection (DeviceMesh and AbstractMesh alike)
# ----------------------------------------------------------------------
def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axis names present on this mesh, outer first."""
    sizes = _axis_sizes(mesh)
    return tuple(a for a in _DATA_AXIS_ORDER if a in sizes)


def _data_size(mesh) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh)) or 1


def _model_size(mesh) -> int:
    return _axis_sizes(mesh).get(MODEL_AXIS, 1)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on
    every mesh dim that the spec names for tensor dim ``d``,
    ``Replicate()`` elsewhere."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[name] = d
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh) -> Tuple[Any, ...]:
    return placements((), mesh)


def _map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a
    NamedTuple stays one); paths join keys and list indices with '/'."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        out = [_map_with_path(fn, v, sub(k)) for k, v in zip(keys, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(path, tree)


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def _is_norm(name: str) -> bool:
    return "norm" in name or name.startswith("ln_")


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               cfg: ModelConfig) -> Spec:
    """Tensor-parallel spec for one parameter of the port's tree.

    Rules, in order:
      1. norm scales/biases replicate (tiny, and TP-summed activations
         need them whole on every shard);
      2. a MoE layer's expert weights [E, d, f] shard the expert axis:
         expert parallelism keeps each expert's matmul local;
      3. otherwise the largest 'model'-divisible dim is sharded (the
         later dim wins ties: column-parallel for square weights;
         vocab-parallel embeddings when the vocab divides, d_model
         fallback when it does not);
      4. nothing divides -> fully replicated.

    The reference's rules 2 and 3 skip its stacked [L] axis; a per-layer
    leaf here has none, so every dim is a candidate.
    """
    parts = path.split("/")
    ndim = len(shape)
    spec = [None] * ndim
    if _is_norm(parts[-1]):
        return tuple(spec)

    tp = _model_size(mesh)
    if "moe_layers" in parts and ndim == 3 and shape[0] % tp == 0:
        spec[0] = MODEL_AXIS
        return tuple(spec)

    candidates = [d for d in range(ndim)
                  if shape[d] > 1 and shape[d] % tp == 0]
    if candidates:
        best = max(candidates, key=lambda d: (shape[d], d))
        spec[best] = MODEL_AXIS
    return tuple(spec)


def param_shardings(cfg: ModelConfig, abstract_params: Any, mesh) -> Any:
    """Placements tree matching ``abstract_params``."""
    return _map_with_path(
        lambda path, leaf: placements(
            param_spec(path, tuple(leaf.shape), mesh, cfg), mesh),
        abstract_params)


# ----------------------------------------------------------------------
# batches
# ----------------------------------------------------------------------
def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Batch tensors shard dim 0 over ALL data axes (pod included), with
    a fallback to 'data' alone, then replicated (long_500k's batch of 1
    can never shard)."""
    spec = [None] * len(shape)
    if not shape:
        return tuple(spec)
    dax = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    if dax and shape[0] % math.prod(sizes[a] for a in dax) == 0:
        spec[0] = dax
    elif "data" in sizes and shape[0] % sizes["data"] == 0:
        spec[0] = ("data",)
    return tuple(spec)


def batch_shardings(abstract_batch: Any, mesh) -> Any:
    return _map_with_path(
        lambda _, leaf: placements(batch_spec(tuple(leaf.shape), mesh),
                                   mesh), abstract_batch)


# ----------------------------------------------------------------------
# decode state (KV caches / recurrent states)
# ----------------------------------------------------------------------
def state_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Decode-state layout. Leaves follow the convention [L, B, ...feature
    dims]: batch shards over the data axes and the trailing feature dim
    (head_dim, or the kv-head dim when head_dim doesn't divide) shards
    over 'model'.

    With the ``seq_shard_kv`` perf flag, 5-D KV caches [L, B, S, KV, hd]
    shard the SEQUENCE axis on 'model' instead. Recurrent (<= 4-D)
    states are unaffected by the flag.
    """
    ndim = len(shape)
    spec = [None] * ndim
    if ndim < 2:
        return tuple(spec)
    dax = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    if dax and shape[1] % _data_size(mesh) == 0:
        spec[1] = dax
    elif "data" in sizes and shape[1] % sizes["data"] == 0:
        # batch_spec's fallback chain: a batch that divides 'data' but
        # not pod*data must still give batch and state ONE layout
        spec[1] = ("data",)
    tp = _model_size(mesh)
    if (ndim == 5 and opt_flags.enabled("seq_shard_kv")
            and shape[2] % tp == 0):
        spec[2] = MODEL_AXIS
        return tuple(spec)
    for d in (ndim - 1, ndim - 2):
        if d <= 1:
            break
        if shape[d] % tp == 0 and shape[d] > 1:
            spec[d] = MODEL_AXIS
            break
    return tuple(spec)


def state_shardings(abstract_state: Any, mesh) -> Any:
    return _map_with_path(
        lambda _, leaf: placements(state_spec(tuple(leaf.shape), mesh),
                                   mesh), abstract_state)


# ----------------------------------------------------------------------
# optimizer state (ZeRO over data on top of the TP layout)
# ----------------------------------------------------------------------
def moment_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """An AdamW moment's spec: its parameter's TP spec with the first
    free divisible dim also sharded over the data axes (ZeRO-1 style):
    f32 m+v replicated over 256 chips would not fit for the 34B archs."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    dax, dsize = data_axes(mesh), _data_size(mesh)
    if dax:
        for d, entry in enumerate(spec):
            if entry is None and shape[d] > 1 and shape[d] % dsize == 0:
                spec[d] = dax
                break
    return tuple(spec)


def opt_state_shardings(cfg: ModelConfig, abstract_params: Any,
                        mesh) -> Any:
    """Placements tree of the moments (one tree serves m and v)."""
    return _map_with_path(
        lambda path, leaf: placements(moment_spec(
            param_spec(path, tuple(leaf.shape), mesh, cfg),
            tuple(leaf.shape), mesh), mesh),
        abstract_params)
