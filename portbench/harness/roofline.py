"""The card's peaks and the least time a piece of work could take on it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W
limit. A kernel's operations and bytes are counted from its shapes as
``chip_smoke.py`` counts them for its kernel table: each input byte read
once, each output byte written once, and only the (query, key) pairs the
causal mask lets through.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The larger of the time at the peak rate and at the peak bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def causal_pairs(S: int) -> int:
    """(query, key) pairs of a causal prefill of S tokens from position 0."""
    return S * (S + 1) // 2


def flash_work(S: int, H: int, KV: int, hd: int, elem: int = 2
               ) -> Tuple[float, float]:
    """One causal flash prefill call, B = 1: 4 operations per (pair,
    head, dim) (QK^T and PV); q read and o written, k and v read."""
    flops = 4.0 * H * hd * causal_pairs(S)
    nbytes = (2 * S * H * hd + 2 * S * KV * hd) * elem
    return flops, nbytes


def paged_work(lens: Iterable[int], H: int, KV: int, hd: int, page: int,
               elem: int = 2) -> Tuple[float, float]:
    """One paged decode call over a batch with context lengths ``lens``
    (the new token included): each live K/V row and q read once, the
    output written once, the block table and lengths read."""
    lens = list(lens)
    live, B = sum(lens), len(lens)
    max_pages = -(-max(lens) // page)
    nbytes = (2 * live * KV * hd + 2 * B * H * hd) * elem \
        + B * max_pages * 4 + B * 4
    return 4.0 * H * hd * live, nbytes


def rwkv6_scan_work(T: int, NH: int, hd: int, elem: int = 2
                    ) -> Tuple[float, float]:
    """One rwkv6 scan call, B = 1, from a zero state: per (step, key,
    value) the state update and the output term, 2 operations each;
    r, k, v read and y written in the compute dtype, w read in f32, u
    and the final state in f32."""
    flops = 4.0 * T * NH * hd * hd
    nbytes = (4 * T * NH * hd) * elem + T * NH * hd * 4 \
        + NH * hd * 4 + NH * hd * hd * 4
    return flops, nbytes
