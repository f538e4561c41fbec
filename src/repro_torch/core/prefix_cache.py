"""KV cache sharing & reuse (paper section II-C).

Two reuse strategies over page-granular token-content hashes:

  * **Prefix matching** (vLLM/SGLang-style): a chain-hash trie keyed on
    page content; a new request reuses the longest prefix of full pages
    whose chain hash matches a previously inserted sequence.
  * **Position-independent caching** (PIC / CacheBlend-style): full pages
    are matched by content hash REGARDLESS of position; reused blocks then
    selectively recompute a fraction of tokens (``recompute_frac``, the
    cross-attention repair CacheBlend performs) — so reuse saves
    (1 - recompute_frac) of the matched tokens' prefill work.

The cache tracks hit statistics and computes the prefill-token savings the
engines feed to the cost model. Page eviction is LRU by insertion/touch.
"""
from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _stable_digest(salt: int, payload: bytes) -> int:
    """64-bit blake2b digest of ``salt || payload``, identical across
    processes. The builtin ``hash()`` is salted per-process by
    PYTHONHASHSEED, which would make page keys — and therefore hit
    statistics, tier residency, and router affinity scores — differ
    between a worker and the process that warmed the cache."""
    h = hashlib.blake2b(digest_size=8)
    h.update(salt.to_bytes(8, "little", signed=True))
    h.update(payload)
    return int.from_bytes(h.digest(), "little", signed=True)


def _page_hash(tokens: np.ndarray, salt: int = 0) -> int:
    return _stable_digest(salt, tokens.tobytes())


@dataclass
class ReuseResult:
    matched_tokens: int          # tokens whose KV can be reused
    recompute_tokens: int        # tokens that must still be (re)computed
    mode: str                    # "prefix" | "pic" | "none"

    def saved_tokens(self, total: int) -> int:
        """Prefill tokens avoided relative to computing all ``total``."""
        return total - self.recompute_tokens


class PrefixCache:
    """Chain-hash prefix trie + position-independent page index."""

    def __init__(self, capacity_pages: int, page_size: int = 16,
                 pic: bool = False, recompute_frac: float = 0.15):
        self.capacity = capacity_pages
        self.page_size = page_size
        self.pic = pic
        self.recompute_frac = recompute_frac
        # chain hash -> page payload (prefix matching)
        self._prefix: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        # content hash -> page payload (position independent)
        self._content: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------
    def _pages(self, tokens: Sequence[int]) -> List[np.ndarray]:
        arr = np.asarray(tokens, dtype=np.int64)
        n_full = len(arr) // self.page_size
        return [arr[i * self.page_size:(i + 1) * self.page_size]
                for i in range(n_full)]

    @staticmethod
    def _chain(prev: int, page: np.ndarray) -> int:
        return _stable_digest(prev, page.tobytes())

    def _touch(self, table, key) -> None:
        table.move_to_end(key)

    def _insert(self, table, key, val=1) -> None:
        table[key] = val
        table.move_to_end(key)
        while len(table) > self.capacity:
            table.popitem(last=False)   # LRU

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int]) -> None:
        chain = 0
        for page in self._pages(tokens):
            chain = self._chain(chain, page)
            self._insert(self._prefix, chain)
            if self.pic:
                self._insert(self._content, _page_hash(page))

    # ------------------------------------------------------------------
    def peek_match(self, tokens: Sequence[int]) -> int:
        """Matched tokens a ``lookup`` would report, WITHOUT touching LRU
        order or hit counters — the prefix-affinity router probes every
        engine's cache per request, and a probe must not reorder
        eviction or inflate statistics."""
        matched_pages = 0
        if not self.pic:
            chain = 0
            for page in self._pages(tokens):
                chain = self._chain(chain, page)
                if chain not in self._prefix:
                    break
                matched_pages += 1
        else:
            matched_pages = sum(1 for page in self._pages(tokens)
                                if _page_hash(page) in self._content)
        return matched_pages * self.page_size

    # ------------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> ReuseResult:
        pages = self._pages(tokens)
        total = len(tokens)

        # longest matching prefix of full pages
        chain = 0
        prefix_pages = 0
        for page in pages:
            chain = self._chain(chain, page)
            if chain in self._prefix:
                self._touch(self._prefix, chain)
                prefix_pages += 1
            else:
                break

        if not self.pic:
            matched = prefix_pages * self.page_size
            if matched:
                self.hits += 1
            else:
                self.misses += 1
            return ReuseResult(matched_tokens=matched,
                               recompute_tokens=total - matched,
                               mode="prefix" if matched else "none")

        # PIC: any full page matched by content, anywhere in the sequence
        matched_pages = 0
        for page in pages:
            key = _page_hash(page)
            if key in self._content:
                self._touch(self._content, key)
                matched_pages += 1
        matched = matched_pages * self.page_size
        # CacheBlend-style selective recompute over reused spans
        repair = int(np.ceil(matched * self.recompute_frac))
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        return ReuseResult(matched_tokens=matched,
                           recompute_tokens=total - matched + repair,
                           mode="pic" if matched else "none")
