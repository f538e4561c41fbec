"""Request length mixes (DESIGN.md section 9).

A length mix turns ``(n, seed)`` into n ``ReqShape`` draws — prompt
length, output length, and an optional shared-prefix length for the RAG
scenario. Like the arrival processes, every mix is seed-deterministic.

The paper's RandomDataset is the degenerate mix ``PaperFixedLengths``
(16,384 / 256). The others cover the shapes the paper's "depends on the
request load" caveat implies but never measures: ShareGPT-style
long-tail chat traces, short interactive chatbot turns, and
RAG-with-shared-prefix retrieval prompts. ``MixtureLengths`` composes
any of them into a multi-tenant blend.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ReqShape:
    prompt_len: int
    output_len: int
    prefix_len: int = 0      # leading tokens shared across the tenant
    tenant: int = 0          # which mixture component drew this shape


class LengthMix:
    """Base: ``sample(n, seed)`` -> list of n ``ReqShape``."""

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        raise NotImplementedError


@dataclass(frozen=True)
class PaperFixedLengths(LengthMix):
    """The paper's RandomDataset shape: fixed input/output lengths."""
    prompt_len: int = 16_384
    output_len: int = 256

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        return [ReqShape(self.prompt_len, self.output_len)
                for _ in range(n)]


@dataclass(frozen=True)
class ShareGPTLengths(LengthMix):
    """ShareGPT-like long tail: lognormal prompts and outputs, clipped.

    Medians/sigmas default to the shape of the public ShareGPT trace
    (most prompts near 1k tokens, a heavy tail into the tens of
    thousands; outputs a few hundred with a shorter tail)."""
    prompt_median: int = 1024
    prompt_sigma: float = 1.0
    output_median: int = 128
    output_sigma: float = 0.8
    prompt_min: int = 16
    prompt_max: int = 32_768
    output_min: int = 2
    output_max: int = 2_048

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        rng = np.random.default_rng(seed)
        p = rng.lognormal(np.log(self.prompt_median), self.prompt_sigma, n)
        o = rng.lognormal(np.log(self.output_median), self.output_sigma, n)
        p = np.clip(np.rint(p), self.prompt_min, self.prompt_max)
        o = np.clip(np.rint(o), self.output_min, self.output_max)
        return [ReqShape(int(pi), int(oi)) for pi, oi in zip(p, o)]


@dataclass(frozen=True)
class ChatbotLengths(LengthMix):
    """Short interactive turns: uniform small prompts and outputs."""
    prompt_min: int = 32
    prompt_max: int = 512
    output_min: int = 32
    output_max: int = 256

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        rng = np.random.default_rng(seed)
        p = rng.integers(self.prompt_min, self.prompt_max + 1, n)
        o = rng.integers(self.output_min, self.output_max + 1, n)
        return [ReqShape(int(pi), int(oi)) for pi, oi in zip(p, o)]


@dataclass(frozen=True)
class RAGSharedPrefixLengths(LengthMix):
    """RAG retrieval: a long prefix shared by every request of the
    tenant (paper section II-C's KV-reuse scenario) plus a short
    per-request question, with short grounded answers."""
    prefix_len: int = 8_192
    suffix_min: int = 64
    suffix_max: int = 512
    output_min: int = 32
    output_max: int = 192

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        rng = np.random.default_rng(seed)
        s = rng.integers(self.suffix_min, self.suffix_max + 1, n)
        o = rng.integers(self.output_min, self.output_max + 1, n)
        return [ReqShape(self.prefix_len + int(si), int(oi),
                         prefix_len=self.prefix_len)
                for si, oi in zip(s, o)]


@dataclass(frozen=True)
class MixtureLengths(LengthMix):
    """Multi-tenant blend: ``components`` = ((weight, mix), ...).

    Each request independently draws its tenant with probability
    proportional to the weights, then its shape from that tenant's mix;
    ``ReqShape.tenant`` records the component index so per-tenant SLOs
    and metrics can be split downstream."""
    components: Tuple[Tuple[float, LengthMix], ...]

    def sample(self, n: int, seed: int = 0) -> List[ReqShape]:
        assert self.components, "empty mixture"
        rng = np.random.default_rng(seed)
        w = np.array([c[0] for c in self.components], dtype=np.float64)
        assert np.all(w > 0), "mixture weights must be positive"
        tenants = rng.choice(len(self.components), size=n, p=w / w.sum())
        # pre-draw each tenant's shapes with a derived (deterministic) seed
        per_tenant = {
            t: iter(self.components[t][1].sample(
                int(np.sum(tenants == t)), seed=seed * 1009 + 7 * t + 1))
            for t in set(int(t) for t in tenants)
        }
        out = []
        for t in tenants:
            shape = next(per_tenant[int(t)])
            out.append(ReqShape(shape.prompt_len, shape.output_len,
                                prefix_len=shape.prefix_len,
                                tenant=int(t)))
        return out


# ----------------------------------------------------------------------
_MIXES = {
    "paper-fixed": PaperFixedLengths,
    "sharegpt": ShareGPTLengths,
    "chatbot": ChatbotLengths,
    "rag-shared-prefix": RAGSharedPrefixLengths,
}


def make_lengths(kind: str, **kw) -> LengthMix:
    """Registry constructor, e.g. ``make_lengths("sharegpt")``."""
    try:
        cls = _MIXES[kind]
    except KeyError:
        raise ValueError(f"unknown length mix {kind!r}; "
                         f"choose from {sorted(_MIXES)}") from None
    return cls(**kw)
