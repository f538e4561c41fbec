"""The hand-written kernels as operators of the ``repro_torch`` library.

Each kernel launch, forward and backward, is one operator
(``torch.ops.repro_torch.<name>``) that goes through the C++ dispatcher
(``torch.library.Library.define``/``impl``, with no Python wrapper of
its own) and carries, besides its schema:

  CPU      the plain torch version (``kernels/ref.py``), or autograd of it
           for a gradient;
  CUDA     the hand kernel, launched as the wrapper launched it before;
           it raises on what the kernel does not take, never falling back
           to the CPU version;
  fake     the outputs' shapes, dtypes and strides, for meta and fake
           tensors: a step traced under ``FakeTensorMode`` (the dry run)
           calls the kernel as one opaque operator;
  flops    a formula for ``torch.utils.flop_counter`` (and the dry run's
           per-device counter, ``dist.hlo_analysis``), written out beside
           each operator;
  sharding a DTensor rule (``register_sharding``): the strategies a mesh
           dim may take, one of which is chosen per mesh dim. Every
           operator offers all-replicated and batch-sharded; head-sharded
           is offered only where the head counts divide every mesh dim,
           so that a shard never splits a query group from its kv head.

The autograd Functions of the kernel modules call these operators, so
gradients take the backward operators on CUDA tensors, DTensors and fake
tensors; on a real CPU tensor under grad a wrapper differentiates the
plain version itself (``on_host``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "DEF")


def define(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable,
           flops: Callable, sharding: Callable):
    """Define ``repro_torch::<schema>`` with its implementations, flop
    formula and sharding rule; returns ``torch.ops.repro_torch.<name>``
    (the packet: call it as a function)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    register_sharding(packet.default)(sharding)
    return packet


# the dispatcher's thread-local key sets of plain eager code (this
# module is imported there)
_EAGER_KEYS = (torch._C._dispatch_tls_local_include_set(),
               torch._C._dispatch_tls_local_exclude_set())


def eager_autograd():
    """A context in which autograd records again inside an operator's
    implementation: a gradient operator's CPU implementation is autograd
    of the plain version, and an operator reached through a dispatch
    mode (``FakeTensorMode``'s neighbours, a counter, DTensor's local
    call) runs with the autograd keys excluded."""
    return torch._C._ForceDispatchKeyGuard(*_EAGER_KEYS)


def on_host(t: torch.Tensor) -> bool:
    """A real CPU tensor: neither fake nor a DTensor. Under grad a wrapper
    runs autograd of the plain version on it, one forward pass, where the
    operators would run the plain forward a second time in the backward
    (an operator keeps no autograd graph)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    return (t.device.type == "cpu" and not isinstance(t, DTensor)
            and not is_fake(t))


def divides(spec, *counts: int) -> bool:
    """Every count divides every dim of the DTensor spec's mesh."""
    return all(n % s == 0 for n in counts for s in spec.mesh.shape)


def fresh(outs: Sequence[torch.Tensor], ins: Sequence) -> tuple:
    """``outs`` with any output that shares storage with an input cloned:
    an operator's outputs never alias its inputs (the plain versions
    return a float32 input as it is where ``.float()`` is a no-op)."""
    ptrs = {t.untyped_storage().data_ptr() for t in ins
            if isinstance(t, torch.Tensor) and t.numel()}
    return tuple(o.clone() if o.numel() and
                 o.untyped_storage().data_ptr() in ptrs else o
                 for o in outs)
