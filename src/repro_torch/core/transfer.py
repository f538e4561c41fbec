"""KV-cache transfer paths between prefill and decode accelerators.

The paper's benchmarked variable (section IV-F). On the card:

  ici    device-to-device copy into the decode side's memory (one card;
         a peer copy across two cards is open)               -> dis-gpu
  host   device -> pinned host DRAM -> device                -> dis-cpu
  disk   host staging + a file written and fsync'd, its pages dropped
         from the page cache, read back from the device and
         unlinked                                            -> dis-disk

The timing and energy legs (``store_cost``/``fetch_cost``) are the
reference's, priced with its TPU-host constants: simulated, not measured.

Every path is split into a STORE half (prefill side; its latency lands in
TTFT) and a FETCH half (decode side; it occupies the decode engine at
admission, so slower media degrade TPOT) — mirroring the LMCache connector
structure the paper instruments. For the ici path the store pushes straight
into decode HBM and the fetch is free.

``store()``/``fetch()`` also REALLY move the state payload (a nested
tuple of ints and tensors) in real mode: a device copy, pinned host
DRAM, or a file written with ``torch.save`` and fsync'd. Round trips are
bit-exact, bf16 included: tensors never pass through numpy. The disk
path loads with ``weights_only=True``, which refuses a pickled class:
the executor hands a model's NamedTuple state over as a plain tuple and
rebuilds it on the decode side.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .costs import HostSpec


def map_tensors(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    """Apply ``fn`` to every tensor in a nested tuple/list/dict payload;
    other leaves (seq ids) pass through. A NamedTuple (a model's decode
    state) comes back as the same NamedTuple."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    return obj


def _device_of(obj: Any) -> Optional[torch.device]:
    found = []
    map_tensors(found.append, obj)
    return found[0].device if found else None


@dataclass
class LegCost:
    latency_s: float
    energy_j: Dict[str, float] = field(default_factory=dict)
    busy: Dict[str, float] = field(default_factory=dict)


class TransferPath:
    name = "base"

    def __init__(self, host: Optional[HostSpec] = None):
        self.host = host or HostSpec()

    # timing/energy model ------------------------------------------------
    def store_cost(self, nbytes: int) -> LegCost:
        raise NotImplementedError

    def fetch_cost(self, nbytes: int) -> LegCost:
        raise NotImplementedError

    # real byte movement (integration tests) ------------------------------
    def store(self, state: Any) -> Any:
        """state pytree -> opaque handle held by the medium."""
        return state

    def fetch(self, handle: Any) -> Any:
        """handle -> state pytree on the decode side."""
        return handle


class ICIPath(TransferPath):
    """Device-to-device over the inter-slice interconnect (dis-gpu analog)."""

    name = "ici"

    def __init__(self, host=None, ici_bw: float = 200e9,
                 launch_latency_s: float = 20e-6):
        super().__init__(host)
        self.ici_bw = ici_bw
        self.launch_latency_s = launch_latency_s

    def store_cost(self, nbytes: int) -> LegCost:
        t = self.launch_latency_s + nbytes / self.ici_bw
        return LegCost(latency_s=t,
                       energy_j={"ici": nbytes * self.host.ici_pj_per_byte
                                 * 1e-12},
                       busy={"ici": t})

    def fetch_cost(self, nbytes: int) -> LegCost:
        return LegCost(latency_s=0.0)   # already resident in decode HBM

    def store(self, state: Any) -> Any:
        # a real copy, never an alias: the prefill side frees its pages
        # once the store completes (one card: device-to-device)
        return map_tensors(lambda x: x.clone(), state)

    def fetch(self, handle: Any) -> Any:
        return handle


class HostPath(TransferPath):
    """Device -> host DRAM -> device staging (dis-cpu analog)."""

    name = "host"

    def __init__(self, host=None, lookup_latency_s: float = 200e-6):
        super().__init__(host)
        self.lookup_latency_s = lookup_latency_s   # Redis index round trip

    def _leg(self, nbytes: int) -> LegCost:
        h = self.host
        t = nbytes / h.pcie_bw + self.lookup_latency_s
        return LegCost(
            latency_s=t,
            energy_j={
                "pcie": nbytes * h.pcie_pj_per_byte * 1e-12,
                "dram": nbytes * h.dram_pj_per_byte * 1e-12,
                "cpu": (h.cpu_active_w - h.cpu_idle_w) * t,
            },
            busy={"cpu": t, "dram": t},
        )

    def store_cost(self, nbytes: int) -> LegCost:
        return self._leg(nbytes)

    def fetch_cost(self, nbytes: int) -> LegCost:
        return self._leg(nbytes)

    def store(self, state: Any) -> Any:
        def to_host(x):                    # -> (pinned) host DRAM
            out = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                              pin_memory=x.is_cuda)
            out.copy_(x)
            return out
        return _device_of(state), map_tensors(to_host, state)

    def fetch(self, handle: Any) -> Any:
        device, state = handle
        return map_tensors(lambda x: x.to(device, copy=True), state)


class DiskPath(TransferPath):
    """Host staging + NVMe write/read, page cache bypassed (dis-disk).

    ``store`` writes the payload with ``torch.save``, fsyncs it, and then
    drops the file's clean pages from the page cache
    (``posix_fadvise(POSIX_FADV_DONTNEED)``), so that ``fetch`` reads the
    bytes back from the device and not from DRAM. What this covers: the
    file's own data pages, written and read through the kernel's normal
    buffered path. What it does not: the write still passes through the
    page cache before the fsync (it is not O_DIRECT), the read-back fills
    the cache again (the file is unlinked right after), the device's own
    cache is not flushed, and the filesystem's metadata stays cached. The
    bypass means nothing where ``scratch_dir`` is a RAM filesystem
    (tmpfs): there the "disk" is DRAM. A platform without
    ``os.posix_fadvise`` raises in ``store`` rather than read back
    through the cache silently (the cost model alone needs no file).
    """

    name = "disk"

    def __init__(self, host=None, scratch_dir: Optional[str] = None,
                 lookup_latency_s: float = 200e-6):
        super().__init__(host)
        self.scratch_dir = scratch_dir
        self.lookup_latency_s = lookup_latency_s

    def store_cost(self, nbytes: int) -> LegCost:
        h = self.host
        t_disk = nbytes / h.disk_write_bw
        t = nbytes / h.pcie_bw + t_disk + self.lookup_latency_s
        return LegCost(
            latency_s=t,
            energy_j={
                "pcie": nbytes * h.pcie_pj_per_byte * 1e-12,
                "dram": nbytes * h.dram_pj_per_byte * 1e-12,
                "disk": nbytes * h.disk_nj_per_byte * 1e-9,
                "cpu": (h.cpu_active_w - h.cpu_idle_w) * t,
            },
            busy={"cpu": t, "dram": t, "disk": t_disk},
        )

    def fetch_cost(self, nbytes: int) -> LegCost:
        h = self.host
        t_disk = nbytes / h.disk_read_bw
        t = t_disk + nbytes / h.pcie_bw + self.lookup_latency_s
        return LegCost(
            latency_s=t,
            energy_j={
                "pcie": nbytes * h.pcie_pj_per_byte * 1e-12,
                "dram": nbytes * h.dram_pj_per_byte * 1e-12,
                "disk": nbytes * h.disk_nj_per_byte * 1e-9,
                "cpu": (h.cpu_active_w - h.cpu_idle_w) * t,
            },
            busy={"cpu": t, "dram": t, "disk": t_disk},
        )

    def store(self, state: Any) -> Any:
        if not hasattr(os, "posix_fadvise"):
            raise RuntimeError("DiskPath: this platform has no "
                               "os.posix_fadvise, so the page cache "
                               "cannot be bypassed")
        fd, path = tempfile.mkstemp(dir=self.scratch_dir, suffix=".kv")
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())     # defeat write-back caching
            # the pages are clean now: drop them, so fetch reads the device
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
        return path, _device_of(state)

    def fetch(self, handle: Any) -> Any:
        path, device = handle
        restored = torch.load(path, map_location=device, weights_only=True)
        os.unlink(path)
        return restored


def mount_of(path: str, mounts: str = "/proc/mounts") -> Tuple[str, str]:
    """(mount point, filesystem type) of the filesystem that holds
    ``path``: the entry of ``mounts`` whose mount point is the longest
    prefix of the resolved path. What the disk medium really is (tmpfs
    would make it DRAM) is read from here."""
    target = os.path.realpath(path)
    best = ("", "unknown")
    with open(mounts) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            # /proc/mounts escapes spaces and tabs as octal
            point = fields[1].encode().decode("unicode_escape")
            inside = (target == point or point == "/"
                      or target.startswith(point.rstrip("/") + "/"))
            if inside and len(point) >= len(best[0]):
                best = (point, fields[2])
    return best


PATHS = {"ici": ICIPath, "host": HostPath, "disk": DiskPath}


def make_path(name: str, host: Optional[HostSpec] = None,
              **kw) -> TransferPath:
    return PATHS[name](host=host, **kw)
