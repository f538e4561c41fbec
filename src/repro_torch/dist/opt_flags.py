"""Global perf-flag registry, the port of ``repro.dist.opt_flags``.

Each named flag is one output-preserving tuning lever, applied
process-wide, so that a run can set a flag against the baseline
without touching model code. The flags are read when a function runs,
by ``repro_torch.models.layers`` and ``repro_torch.models.moe`` and by
the sharding rules (``repro_torch.dist.sharding``); every flag must
preserve the model's outputs (``tests/test_torch_opt_flags.py`` holds
each one to the flags-off run and to the reference with the same flag
set).

A subprocess gets its flag set through the ``REPRO_OPT`` environment
variable, read once at import:

  REPRO_OPT=remat_dots,bf16_logits python -m repro_torch.launch.train ...
"""
from __future__ import annotations

import os
from typing import FrozenSet, Tuple

# name -> what it changes; unknown names are rejected, so that a typo'd
# experiment cannot silently measure the baseline.
FLAGS = {
    "remat_dots": (
        "activation-checkpoint policy saves matmul outputs (XLA "
        "dots-saveable) instead of recomputing them in backward"),
    "bf16_logits": (
        "keep the LM-head matmul and logits tensor in bf16; softmax/loss "
        "still upcast to f32"),
    "seq_shard_kv": (
        "shard the KV cache on the sequence axis over 'model' instead of "
        "the head axis (decode-state resharding lever)"),
    "local_moe_dispatch": (
        "MoE sort/rank/scatter per data-shard-sized token group instead "
        "of one global sort; only the expert einsum crosses shards"),
    "masked_cache_update": (
        "decode KV write as an elementwise select over the sequence dim "
        "instead of a scatter (partitions cleanly under SPMD)"),
    "pad_heads": (
        "GQA head regrouping: duplicate kv heads so the q-head dim "
        "divides the model axis (bit-exact, enables head sharding)"),
    "head_shard_attn": (
        "constrain attention q/k/v head dims to 'model' when divisible"),
}

_active: FrozenSet[str] = frozenset()


def set_flags(csv: str) -> None:
    """Replace the active set with a comma-separated flag list ('' clears).

    Raises ``ValueError`` on any unknown name.
    """
    global _active
    names = [n.strip() for n in csv.split(",") if n.strip()]
    unknown = [n for n in names if n not in FLAGS]
    if unknown:
        raise ValueError(
            f"unknown perf flag(s) {unknown}; known: {sorted(FLAGS)}")
    _active = frozenset(names)


def enabled(name: str) -> bool:
    if name not in FLAGS:
        raise ValueError(f"unknown perf flag {name!r}; known: {sorted(FLAGS)}")
    return name in _active


def active() -> Tuple[str, ...]:
    """Currently enabled flags, sorted (falsy when none are set)."""
    return tuple(sorted(_active))


set_flags(os.environ.get("REPRO_OPT", ""))
