"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
its own nvcc process into ``build/lib<name>-<hash>.so`` beside this
module; the hash covers the source, the headers in ``csrc/`` and the
flags, so an edited kernel is rebuilt and an unchanged one is not. The
build happens at first use, on the machine with the card. A missing
nvcc or a failed compile raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("flash_prefill", "paged_decode")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[str, Callable[..., None]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: seconds} for those
    built; the compiler's report (registers, spills) is kept in a
    ``.log`` beside each library."""
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"--- nvcc failed for {name}:\n{report}")
            continue
        os.replace(tmp, out)          # atomic: a reader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launcher(name: str, symbol: str, argtypes) -> Callable[..., None]:
    """A callable for the C launch function ``symbol`` of kernel
    ``name``: it passes its arguments through and raises when the launch
    returns a non-zero cudaError_t. Built and bound once per process."""
    launch = _launchers.get(symbol)
    if launch is not None:
        return launch
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def launch(*args) -> None:
        err = fn(*args)
        if err:
            msg = lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    _launchers[symbol] = launch
    return launch
