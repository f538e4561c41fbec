"""The training substrate: AdamW over params trees and the synthetic
data stream (the port of ``repro.train``)."""
from . import data, optimizer
from .optimizer import (AdamWState, Optimizer, adamw, apply_updates,
                        cosine_schedule, global_norm, tree_leaves, tree_map)

__all__ = ["data", "optimizer", "AdamWState", "Optimizer", "adamw",
           "apply_updates", "cosine_schedule", "global_norm", "tree_leaves",
           "tree_map"]
