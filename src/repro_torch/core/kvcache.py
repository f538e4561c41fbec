"""Paged KV cache pool: the paper's central serving data structure.

Host-side bookkeeping (block tables, freelist, LRU eviction) that drives
every scheduling decision in the engines. It is deliberately independent of
whether KV bytes are physically resident (simulation) or backed by real
device pages (``DevicePagedKV`` below, which the real-mode executors and
the paged-decode kernel read).

Eviction semantics mirror vLLM's recompute-preemption: evicting a sequence
frees ALL its pages; the sequence must re-run prefill over its full context
(prompt + generated so far) before decoding can continue. That recompute is
what produces the paper's co-2gpus TPOT cliff (finding F2).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import torch


class OutOfPages(Exception):
    pass


@dataclass
class SeqAlloc:
    seq_id: int
    pages: List[int] = field(default_factory=list)
    tokens: int = 0                    # tokens currently materialized


class PagedKVPool:
    """Fixed-size page pool with per-sequence block tables + LRU eviction."""

    def __init__(self, num_pages: int, page_size: int = 16):
        assert num_pages > 0
        self.num_pages = num_pages
        self.page_size = page_size
        # Lazy freelist: pages never granted yet are the implicit range
        # [_next_fresh, num_pages); returned pages form an explicit LIFO
        # stack. Grant order (returned pages LIFO first, then fresh
        # ascending) is identical to the eager list(range(N-1, -1, -1))
        # this replaces — page ids are observable through block tables —
        # while construction is O(1) instead of O(num_pages), which
        # matters when a fleet sweep builds hundreds of ~1M-page pools.
        self._returned: List[int] = []
        self._next_fresh = 0
        self.seqs: Dict[int, SeqAlloc] = {}
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    # ------------------------------------------------------------------
    # freelist sanity cap: state-only archs (kv_bytes_per_token == 0, e.g.
    # rwkv6) would otherwise size the pool at pool_bytes/page_size pages —
    # a billion-entry freelist. 2^20 pages = 16M tokens never binds.
    MAX_PAGES = 1 << 20

    @classmethod
    def from_bytes(cls, pool_bytes: float, kv_bytes_per_token: int,
                   page_size: int = 16) -> "PagedKVPool":
        per_page = max(kv_bytes_per_token, 1) * page_size
        pages = min(max(int(pool_bytes // per_page), 1), cls.MAX_PAGES)
        return cls(num_pages=pages, page_size=page_size)

    # ------------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    @property
    def free_pages(self) -> int:
        return len(self._returned) + (self.num_pages - self._next_fresh)

    @property
    def free(self) -> List[int]:
        """Materialized freelist in the eager layout this class used to
        keep (fresh pages descending, then returned pages in return
        order; ``pop()`` order from the end matches ``_pop_free``).
        O(num_pages) — for invariant checks and tests only."""
        return list(range(self.num_pages - 1, self._next_fresh - 1, -1)) \
            + self._returned

    def _pop_free(self) -> int:
        if self._returned:
            return self._returned.pop()
        page = self._next_fresh
        self._next_fresh += 1
        return page

    def block_table(self, seq_id: int) -> List[int]:
        return list(self.seqs[seq_id].pages)

    def tokens_of(self, seq_id: int) -> int:
        return self.seqs[seq_id].tokens

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self.seqs

    # ------------------------------------------------------------------
    def can_fit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.free_pages

    def allocate(self, seq_id: int, tokens: int) -> List[int]:
        """Materialize ``tokens`` MORE tokens for seq_id; returns any newly
        granted pages. Raises OutOfPages when the freelist is exhausted."""
        alloc = self.seqs.setdefault(seq_id, SeqAlloc(seq_id))
        new_total = alloc.tokens + tokens
        need = self.pages_for(new_total) - len(alloc.pages)
        if need > self.free_pages:
            raise OutOfPages(
                f"seq {seq_id}: need {need} pages, {self.free_pages} free")
        # bulk grant, identical order to `need` sequential _pop_free()
        # calls (returned LIFO first, then fresh ascending) without the
        # per-page call overhead — a 2048-token prefill grants 128 pages
        granted = []
        if need:
            take = min(need, len(self._returned))
            if take:
                granted = self._returned[-take:][::-1]
                del self._returned[-take:]
            fresh = need - take
            if fresh:
                granted.extend(range(self._next_fresh,
                                     self._next_fresh + fresh))
                self._next_fresh += fresh
        alloc.pages.extend(granted)
        alloc.tokens = new_total
        self.touch(seq_id)
        return granted

    def free_seq(self, seq_id: int) -> int:
        """Release a sequence's pages; returns how many were freed."""
        alloc = self.seqs.pop(seq_id, None)
        self._lru.pop(seq_id, None)
        if alloc is None:
            return 0
        self._returned.extend(alloc.pages)
        return len(alloc.pages)

    # ------------------------------------------------------------------
    def touch(self, seq_id: int) -> None:
        self._lru[seq_id] = None
        self._lru.move_to_end(seq_id)

    def lru_candidates(self, exclude: Optional[Set[int]] = None
                       ) -> List[int]:
        exclude = exclude or set()
        return [s for s in self._lru if s not in exclude]

    def evict_lru(self, exclude: Optional[Set[int]] = None) -> Optional[int]:
        """Evict the least-recently-used sequence; returns its id."""
        for seq_id in self.lru_candidates(exclude):
            self.free_seq(seq_id)
            return seq_id
        return None

    # invariant checks (property tests assert these hold under any op mix)
    def check_invariants(self) -> None:
        held = [p for a in self.seqs.values() for p in a.pages]
        all_pages = held + self.free
        assert len(all_pages) == self.num_pages, "page leak/duplication"
        assert len(set(all_pages)) == self.num_pages, "page double-grant"
        for a in self.seqs.values():
            assert len(a.pages) == self.pages_for(a.tokens), \
                f"seq {a.seq_id}: page count mismatch"


# ----------------------------------------------------------------------
# Device-backed pool for the dense-family real path: physical pages
# [L, P + 1, page, KV, hd] on one device, shared by every executor there.
# Writes are in place; ``pool`` holds the physical page ids. The last
# page, ``sink_page``, is past the pool's: the pool never grants it, and
# the padded rows of a decode step replayed as a CUDA graph write there.
# ----------------------------------------------------------------------
class DevicePagedKV:
    def __init__(self, pool: PagedKVPool, num_layers: int, kv_heads: int,
                 head_dim: int, dtype=torch.float32, device="cuda"):
        self.pool = pool
        self.device = torch.device(device)
        self.sink_page = pool.num_pages
        shape = (num_layers, pool.num_pages + 1, pool.page_size, kv_heads,
                 head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)

    def _slots(self, seq_id: int, lo: int, hi: int):
        """(page ids, in-page slots) of token positions [lo, hi)."""
        ps = self.pool.page_size
        pages = torch.tensor(self.pool.block_table(seq_id), dtype=torch.long)
        pos = torch.arange(lo, hi)
        return (pages[pos // ps].to(self.device),
                (pos % ps).to(self.device))

    def write_prefill(self, seq_id: int, ks, vs) -> None:
        """ks/vs: [L, S, KV, hd] dense prefill output -> scatter to pages."""
        pages, slots = self._slots(seq_id, 0, ks.shape[1])
        self.k[:, pages, slots] = ks.to(self.k.dtype)
        self.v[:, pages, slots] = vs.to(self.v.dtype)

    def write_token(self, seq_id: int, k_tok, v_tok, pos: int) -> None:
        """k_tok/v_tok: [L, KV, hd] one token at absolute position pos."""
        pages = self.pool.block_table(seq_id)
        page = pages[pos // self.pool.page_size]
        slot = pos % self.pool.page_size
        self.k[:, page, slot] = k_tok
        self.v[:, page, slot] = v_tok

    def gather_dense(self, seq_id: int):
        """-> (k [L, S, KV, hd], v): a contiguous copy of the sequence."""
        pages, slots = self._slots(seq_id, 0, self.pool.tokens_of(seq_id))
        return self.k[:, pages, slots], self.v[:, pages, slots]

    def free(self, seq_id: int) -> int:
        """Return a sequence's physical pages to the pool."""
        return self.pool.free_seq(seq_id)
