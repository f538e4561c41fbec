"""Fault tolerance for the training path: checkpoints + straggler watch,
the port of ``repro.dist.fault``.

The contract is the reference's (``tests/test_torch_fault.py`` holds the
port to it): checkpoints are atomic (a crash mid-save never leaves a
loadable partial file), restarts are bit-exact (restored params +
optimizer moments + data cursor reproduce the uninterrupted loss stream
step for step), rotation keeps disk bounded, and a straggler watchdog
flags slow steps.

A checkpoint is one ``torch.save`` of a step/params/opt_state/cursor
payload whose tensors are copied to the host first. The reference
pickles numpy arrays; numpy has no bfloat16, and host tensors keep every
dtype's bits as they are. ``restore_sharded`` places a loaded payload
on the step's device (the port's stand-in for the reference's
NamedShardings until ``dist/`` has a mesh).
"""
from __future__ import annotations

import os
import statistics
import tempfile
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.train.optimizer import tree_map

_PREFIX = "ckpt_"
_SUFFIX = ".pt"


class SimulatedFailure(RuntimeError):
    """Injected worker failure (``train --fail-at N``)."""


# ----------------------------------------------------------------------
# atomic checkpoint save / load / rotation
# ----------------------------------------------------------------------
def _to_host(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x,
                    tree)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{_PREFIX}{step:08d}{_SUFFIX}")


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                    cursor: Dict, keep: Optional[int] = None) -> str:
    """Atomically write a checkpoint; returns its path.

    Write goes to a ``.tmp`` file first, is fsynced and published with
    ``os.replace`` — readers either see a complete checkpoint or none.
    ``keep=N`` deletes all but the newest N after a successful save.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "params": _to_host(params),
        "opt_state": _to_host(opt_state),
        "cursor": dict(cursor),
    }
    path = checkpoint_path(ckpt_dir, step)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if keep is not None:
        for _, old in sorted_checkpoints(ckpt_dir)[:-keep]:
            os.unlink(old)
    return path


def sorted_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """[(step, path), ...] ascending by step; ignores temp/foreign files."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
            try:
                step = int(name[len(_PREFIX):-len(_SUFFIX)])
            except ValueError:
                continue
            out.append((step, os.path.join(ckpt_dir, name)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = sorted_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def load_checkpoint(path: str) -> Dict:
    """The payload with its tensors on the host. The file holds the
    optimizer state's NamedTuple, so it is unpickled in full: load only
    checkpoints this package wrote."""
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_sharded(payload: Dict, param_device: Any,
                    opt_device: Any) -> Tuple[Any, Any, int, Dict]:
    """Place a loaded payload on the step's devices.

    Returns ``(params, opt_state, step, cursor)``.
    """
    def to(device):
        return lambda x: x.to(device) if torch.is_tensor(x) else x
    params = tree_map(to(param_device), payload["params"])
    opt_state = tree_map(to(opt_device), payload["opt_state"])
    return params, opt_state, int(payload["step"]), payload["cursor"]


# ----------------------------------------------------------------------
# straggler watchdog
# ----------------------------------------------------------------------
class StragglerWatchdog:
    """Flags step times that are outliers vs the rolling median.

    ``observe(step, duration_s)`` returns True when the step is flagged:
    either ``duration > threshold * median`` of the last ``window``
    steps, or past the hard ``deadline_s``. Flagged steps accumulate in
    ``.flagged`` and fire the optional ``on_straggler(step, duration,
    median)`` callback — the hook a pod scheduler would use to evict or
    re-place a slow worker.
    """

    def __init__(self, threshold: float = 2.0, window: int = 20,
                 deadline_s: Optional[float] = None):
        self.threshold = threshold
        self.window = window
        self.deadline_s = deadline_s
        self.durations: deque = deque(maxlen=window)
        self.flagged: List[Tuple[int, float]] = []
        self.on_straggler: Optional[Callable[[int, float, float], Any]] = None

    def observe(self, step: int, duration_s: float) -> bool:
        median = (statistics.median(self.durations)
                  if self.durations else duration_s)
        slow = bool(self.durations) and duration_s > self.threshold * median
        if self.deadline_s is not None and duration_s > self.deadline_s:
            slow = True
        if slow:
            self.flagged.append((step, duration_s))
            if self.on_straggler is not None:
                self.on_straggler(step, duration_s, median)
        self.durations.append(duration_s)
        return slow
