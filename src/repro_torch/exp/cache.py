"""Content-addressed on-disk result cache (DESIGN.md section 12).

One JSON file per simulated cell under

    <root>/v<SCHEMA_VERSION>/<spec_hash>.json

The key is the experiment's content address x the record schema
version: same spec -> same file, forever; a schema bump moves the
whole cache to a new subdirectory, so stale-generation records can
never be returned (the old tree is inert, delete it at leisure).

Writes are atomic (tmp file + ``os.replace``) so concurrent
process-pool workers and parallel CI lanes can share a cache directory;
a torn/corrupt file is treated as a miss and overwritten. Stats are
per-``ResultCache``-instance (hits / misses / puts), which is what the
warm-cache CI lane asserts on ("second pass performs zero
simulations").
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional

from .record import RunRecord, SCHEMA_VERSION

__all__ = ["CacheStats", "ResultCache", "default_cache_root"]


def default_cache_root() -> str:
    """``$REPRO_TORCH_EXP_CACHE_DIR`` when set; else
    ``~/.cache/repro-torch-exp``. The records are keyed by the spec's
    content hash alone, which both packages compute alike, so the port
    keeps a root of its own: it never reads or writes the reference's
    cache (``$REPRO_EXP_CACHE_DIR`` or ``benchmarks/out/cache``), and a
    record it returns is one it simulated."""
    env = os.environ.get("REPRO_TORCH_EXP_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-exp")


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "puts": self.puts}


@dataclass
class ResultCache:
    root: str = field(default_factory=default_cache_root)
    schema_version: int = SCHEMA_VERSION
    stats: CacheStats = field(default_factory=CacheStats)

    # ------------------------------------------------------------------
    @property
    def dir(self) -> str:
        return os.path.join(self.root, f"v{self.schema_version}")

    def path_for(self, spec_hash: str) -> str:
        return os.path.join(self.dir, f"{spec_hash}.json")

    # ------------------------------------------------------------------
    def get(self, exp) -> Optional[RunRecord]:
        path = self.path_for(exp.spec_hash())
        try:
            with open(path) as f:
                rec = RunRecord.from_dict(json.load(f))
        except FileNotFoundError:
            self.stats.misses += 1
            return None
        except (json.JSONDecodeError, KeyError, TypeError):
            # torn write or foreign file: treat as a miss, re-simulate
            self.stats.misses += 1
            return None
        if rec.schema_version != self.schema_version:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return rec

    def put(self, rec: RunRecord) -> str:
        os.makedirs(self.dir, exist_ok=True)
        path = self.path_for(rec.spec_hash)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(rec.to_dict(), f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.stats.puts += 1
        return path

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.dir)
                       if n.endswith(".json"))
        except FileNotFoundError:
            return 0

    def clear(self) -> int:
        """Remove every record of THIS schema generation; returns the
        number of files deleted."""
        n = 0
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return 0
        for name in names:
            if name.endswith(".json"):
                os.unlink(os.path.join(self.dir, name))
                n += 1
        return n
