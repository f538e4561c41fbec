"""Step-derived evidence: collective traffic and roofline terms, the port
of ``repro.dist.hlo_analysis``.

The reference compiles a step and reads XLA's cost and memory analysis
of the compiled module. The port runs its real step instead, on fake
DTensors (``FakeTensorMode``) under a fake process group of the mesh's
size, and reads the numbers off that run, per device:

  ``count`` / ``cost_numbers``   flops (``torch.utils.flop_counter``'s
      formulas, the hand kernels' operators included) and bytes (each
      operator's input and output bytes; a registered kernel is one
      fused operator, a view moves none)
  ``traced_collective_stats``    the ``_c10d_functional`` collectives
      that DTensor issues, under the reference's five kind names, with
      their result bytes per rank

An operator on DTensors is left to DTensor, and the local operators it
runs on rank 0's shards come back to the counter: the numbers are one
device's, as XLA's SPMD module's are. ``collective_stats`` stays a
parser of HLO text, for parity with the reference.

``RooflineTerms`` combines the numbers into the three-term step-time
model ``step = max(compute, memory, collective)`` against a ``ChipSpec``
(``chip``; the TPU ``ChipSpec()`` of ``core/costs.py`` by default, as in
the reference). Whole-model numbers come from runs at 1 and 2 layer
periods and ``linear_extrapolate`` (cost(L) = a + b*L), the reference's
method (``launch.dryrun``).

A divergence: the port's byte count never holds the attention logits or
the scan-state stream, because the registered kernels are opaque, where
XLA's charges them to HBM. ``vmem_resident_traffic`` still estimates
them, but the dry run reports it beside the terms and passes
``vmem_resident_bytes=0``, so they are not taken off a second time.
"""
from __future__ import annotations

import contextlib
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.costs import ChipSpec

_CHIP = ChipSpec()
PEAK_FLOPS = _CHIP.peak_flops                       # bf16 FLOP/s per chip
HBM_BW = _CHIP.hbm_bw                               # B/s per chip
ICI_BW = _CHIP.ici_bw_per_link * _CHIP.ici_links    # B/s per chip

# ----------------------------------------------------------------------
# HLO collective parsing (the reference's, for parity)
# ----------------------------------------------------------------------
_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
          "collective-permute", "all-to-all")

# "%x = TYPE kind(...)" where TYPE is "bf16[8,16,128]{2,1,0}" or a tuple.
# Async pairs: count the -start, skip the -done (it is the same transfer).
_INSTR_RE = re.compile(
    r"=\s*(?P<ty>\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
    r"(?P<kind>" + "|".join(_KINDS) + r")(?P<suffix>-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def _shape_bytes_list(ty: str) -> list:
    out = []
    for dtype, dims in _SHAPE_RE.findall(ty):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out.append(n * _DTYPE_BYTES.get(dtype, 2))
    return out


@dataclass
class CollectiveStats:
    """Collective op counts and payload bytes, per kind."""
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Parse all-gather / all-reduce / reduce-scatter / collective-permute
    / all-to-all instructions (sync or async ``-start``) and sum their
    result-shape bytes per kind."""
    st = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if m is None or m.group("suffix") == "-done":
            continue
        shapes = _shape_bytes_list(m.group("ty"))
        # async '-start' ops are tuple-typed (operand, result, ...): the
        # transfer is the result, so take the largest element, not the
        # sum — summing would double-count the aliased input shard.
        # Sync tuple types (all-to-all) really are multiple outputs.
        if m.group("suffix") == "-start" and m.group("ty").startswith("("):
            payload = max(shapes) if shapes else 0
        else:
            payload = sum(shapes)
        st.add(m.group("kind"), payload)
    return st


# ----------------------------------------------------------------------
# counting a run of the step, per device
# ----------------------------------------------------------------------
# the functional collectives DTensor issues, under the reference's names
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# queries of a tensor's metadata: no operator runs
_METADATA = {getattr(torch.ops.aten, n).default for n in (
    "size", "sym_size", "stride", "sym_stride", "storage_offset",
    "sym_storage_offset", "numel", "sym_numel", "dim", "is_contiguous")} | {
    torch.ops.prim.device.default, torch.ops.prim.layout.default}


# DTensor's own bookkeeping runs operators too, on tensors that no
# device holds: the output's global metadata is found by running the
# operator on global-shaped fake tensors (once per cache miss), and a
# _StridedShard's local size by splitting an index tensor. The counter
# skips what runs inside these frames: each name, with the module and
# class of torch that define it.
_BOOKKEEPING = {
    "_propagate_tensor_meta_non_cached": (
        "torch.distributed.tensor._sharding_prop", "ShardingPropagator"),
    "local_shard_size_and_offset": (
        "torch.distributed.tensor.placement_types", "_StridedShard"),
}


def _check_bookkeeping() -> None:
    """Raise where this torch defines a bookkeeping frame of
    ``_BOOKKEEPING`` under another name (or nowhere): the counters would
    count DTensor's bookkeeping as the device's work."""
    import importlib
    for name, (module, cls) in _BOOKKEEPING.items():
        owner = getattr(importlib.import_module(module), cls, None)
        if not callable(getattr(owner, name, None)):
            raise RuntimeError(
                f"torch {torch.__version__} has no {module}.{cls}.{name}: "
                f"the counter cannot tell DTensor's bookkeeping from the "
                f"device's operators")


def _in_bookkeeping() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _BOOKKEEPING:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def _patched(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` within the context;
    raises where this torch has no such name, rather than run on without
    the replacement."""
    orig = getattr(module, name, None)
    if orig is None:
        raise RuntimeError(f"torch {torch.__version__} has no "
                           f"{getattr(module, '__name__', module)}.{name} "
                           f"to replace")
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _remembered(fn, unfake: bool = False):
    """``fn`` of hashable arguments, computed once for each (under
    ``unset_fake_temporarily`` with ``unfake``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    memo = {}

    def remembered(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in memo:
            with unset_fake_temporarily() if unfake else \
                    contextlib.nullcontext():
                memo[key] = fn(*args, **kwargs)
        out = memo[key]
        return (out[0], list(out[1])) if isinstance(out, tuple) and \
            len(out) == 2 and isinstance(out[1], list) else out
    return remembered


@contextlib.contextmanager
def dtensor_on_fake_shards():
    """Two of DTensor's computations made fit for a step whose shards are
    fake tensors of concrete shapes:

    - a ``_StridedShard``'s local size (the placement a reshape merging
      two sharded dims gives) comes from an index tensor that DTensor
      makes and reads back; under ``FakeTensorMode`` that read is
      data-dependent and raises, so it runs on real CPU tensors, as
      outside fake mode;
    - under ``FakeTensorMode`` DTensor takes itself to be tracing and
      plans the redistributions that cost each sharding strategy afresh
      on every call; with concrete shapes the cost of a (source, target)
      pair of specs never changes, so it is remembered. On the 2x16x16
      mesh a matmul's strategies cost thousands of such pairs.

    Each is computed once for each set of arguments, as a function of
    them."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._ops import utils as op_utils
    with _patched(placement_types._StridedShard, "local_shard_size_and_offset",
                  lambda fn: _remembered(fn, unfake=True)), \
            _patched(op_utils, "redistribute_cost", _remembered):
        yield


def _nbytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree``."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


@dataclass
class Counts:
    """One device's flops, bytes moved and collectives over a run."""
    flops: int = 0
    bytes: int = 0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)


class DeviceCounter(TorchDispatchMode):
    """Counts what one device runs. An operator on DTensors is handed to
    DTensor (``NotImplemented``); the operators it runs on the local
    shards, its collectives among them, come back here. Flops are
    ``torch.utils.flop_counter``'s formulas (an operator with none is
    decomposed first, as ``FlopCounterMode`` does); bytes are each
    operator's input and output bytes, views and collectives excluded;
    collectives are counted by kind with their result's bytes. DTensor's
    bookkeeping (``_BOOKKEEPING``) is not counted."""

    def __init__(self):
        super().__init__()
        _check_bookkeeping()
        self.counts = Counts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _METADATA or _in_bookkeeping():
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.counts
        if packet in flop_registry:
            c.flops += int(flop_registry[packet](*args, **kwargs,
                                                 out_val=out))
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(packet.__name__)
            if kind is not None:
                c.collectives.add(kind, _nbytes(out))
        elif not func.is_view:
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


class LocalMemTracker(MemTracker):
    """``torch.distributed._tools.mem_tracker.MemTracker`` of one
    device's memory: it tracks the local operators DTensor runs, and, as
    ``DeviceCounter``, skips DTensor's bookkeeping, whose global-shaped
    fake tensors no device holds (under ``FakeTensorMode`` MemTracker's
    own test for them passes them through)."""

    def __init__(self):
        super().__init__()
        _check_bookkeeping()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(issubclass(t, DTensor) for t in types) and \
                _in_bookkeeping():
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def peak_bytes(self) -> int:
        """The peak of the tracked bytes, summed over devices."""
        return int(sum(v["Total"] for v in
                       self.get_tracker_snapshot("peak").values()))


def _fake_mode_of(args):
    """The ``FakeTensorMode`` of the first fake tensor among ``args``
    (a DTensor's local tensor included), or None."""
    from torch._subclasses.fake_tensor import FakeTensor
    for t in tree_flatten(args)[0]:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


def count(fn, *args, device: str = "cpu") -> Tuple[Any, Counts]:
    """(``fn(*args)``'s outputs, one device's ``Counts``), run under
    ``FakeTensorMode``: fake arguments (DTensors with fake shards
    included) run in their own mode; real ones are made fake first, and
    meta ones fake on ``device`` (the step's), so nothing is computed and
    no memory is taken."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = _fake_mode_of(args)
    if mode is None:
        mode = FakeTensorMode(allow_non_fake_inputs=True)

        def fake(t):
            if not t.is_meta:
                return mode.from_tensor(t)
            with mode:
                return torch.empty_strided(t.shape, t.stride(),
                                           dtype=t.dtype, device=device)
        args = tree_map_only(torch.Tensor, fake, args)
    counter = DeviceCounter()
    with mode, dtensor_on_fake_shards(), counter:
        out = fn(*args)
    return out, counter.counts


def cost_numbers(fn, *args, device: str = "cpu") -> Tuple[float, float]:
    """(flops, bytes_accessed) of one device over one run of
    ``fn(*args)`` under ``FakeTensorMode`` (``count``)."""
    _, c = count(fn, *args, device=device)
    return float(c.flops), float(c.bytes)


def traced_collective_stats(fn, *args,
                            device: str = "cpu") -> CollectiveStats:
    """The collectives of one run of ``fn(*args)`` under
    ``FakeTensorMode``, per kind, with their result bytes on one rank."""
    return count(fn, *args, device=device)[1].collectives


def linear_extrapolate(y1: float, y2: float, n1: float, n2: float,
                       n: float) -> float:
    """Exact extrapolation of cost(L) = a + b*L from two measured sizes."""
    slope = (y2 - y1) / (n2 - n1)
    return y1 + slope * (n - n1)


# ----------------------------------------------------------------------
# three-term roofline
# ----------------------------------------------------------------------
@dataclass
class RooflineTerms:
    """Per-chip roofline for one step.

    ``flops`` / ``hbm_bytes`` / ``collective_bytes`` are per-device
    numbers; ``vmem_resident_bytes`` is traffic the fused kernels keep
    on-chip and is credited against the HBM term; ``model_flops`` (the
    6ND / 2ND ideal) gives the useful-FLOPs ratio. ``chip`` gives the
    peak rates (the TPU ``ChipSpec()`` by default, as in the reference).
    """
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    model_flops: float = 0.0
    vmem_resident_bytes: float = 0.0
    memory_floor_bytes: float = 0.0
    chip: ChipSpec = field(default_factory=ChipSpec)

    @property
    def compute_s(self) -> float:
        return self.flops / self.chip.peak_flops

    @property
    def memory_s_raw(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bw

    @property
    def memory_s(self) -> float:
        return max(self.hbm_bytes - self.vmem_resident_bytes, 0.0) \
            / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chip.ici_bw_per_link
                                        * self.chip.ici_links)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "vmem_resident_bytes": self.vmem_resident_bytes,
            "memory_floor_bytes": self.memory_floor_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_raw": self.memory_s_raw,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


# ----------------------------------------------------------------------
# model-derived ideals (per chip)
# ----------------------------------------------------------------------
def _tokens(shape: InputShape) -> int:
    if shape.kind in ("train", "prefill"):
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one new token per sequence


def model_flops(cfg: ModelConfig, shape: InputShape, n_chips: int) -> float:
    """The 6ND (train) / 2ND (forward-only) ideal, per chip, on ACTIVE
    params — the MoE useful-work denominator, not the parameter count."""
    n_active = cfg.param_count(active_only=True)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * _tokens(shape) / n_chips


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encdec.num_decoder_layers
    return cfg.num_layers


def vmem_resident_traffic(cfg: ModelConfig, shape: InputShape,
                          n_chips: int) -> float:
    """Bytes the fused kernels keep on-chip that XLA's cost analysis
    charges to HBM: attention logits+probs (flash attention never
    materializes them) and the recurrent scan-state stream (rwkv6/mamba2
    keep the running state on-chip across the chunk). Per chip."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    la = _attn_layers(cfg)
    if la:
        if shape.kind == "decode":
            pair_elems = B * cfg.num_heads * S           # one query row
        else:
            pair_elems = B * cfg.num_heads * S * S / 2   # causal half
        total += 2 * 4.0 * la * pair_elems               # logits + probs, f32
    state = cfg.state_bytes()
    if state:
        steps = 1 if shape.kind == "decode" else S
        total += 2.0 * state * B * steps / max(
            1, getattr(cfg.ssm, "chunk_size", 1) if cfg.ssm else 1)
    return total / n_chips


def structural_memory_floor(cfg: ModelConfig, shape: InputShape,
                            n_chips: int) -> float:
    """Bytes this cell cannot avoid holding per chip: bf16 weights (fully
    sharded), the batch's KV/recurrent state, and the token buffers. The
    sanity line the dry run's memory numbers are compared against."""
    B, S = shape.global_batch, shape.seq_len
    params = 2.0 * cfg.param_count()
    kv = (cfg.kv_bytes_per_token() * S + cfg.state_bytes()) * B
    tokens = 4.0 * B * (S if shape.kind != "decode" else 1)
    return (params + kv + tokens) / n_chips
