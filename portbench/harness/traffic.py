"""The one traffic generator: a closed loop of waves, read from a data file.

A wave is ``wave`` requests released together; the next wave is released
when the last request of this one has finished. The file fixes the
wave's multiset of (prompt, output) lengths: each length is a quantile
of its distribution, (i + 1/2) / wave for i = 0 .. wave-1, so the set
stands for the distribution exactly, and prompts are paired with outputs
by a permutation drawn from ``SHAPE_SEED``. Every wave of every run
serves that same set; ``--seed`` only orders it inside each wave and
draws the token ids, so runs with different seeds do the same work.

Distributions (``prompt`` and ``output`` entries):

  {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
  {"dist": "uniform", "min": a, "max": b}          whole numbers a..b
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

SHAPE_SEED = 0      # pairs prompts with outputs, the same in every run

def quantiles(spec: Dict, n: int) -> List[int]:
    """The n mid-quantiles of a length distribution, rounded and clipped,
    in increasing order."""
    lo, hi = int(spec["min"]), int(spec["max"])
    us = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        z = NormalDist()
        vals = [math.exp(math.log(spec["median"])
                         + spec["sigma"] * z.inv_cdf(u)) for u in us]
    elif spec["dist"] == "uniform":
        vals = [lo + (hi - lo) * u for u in us]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(max(int(round(v)), lo), hi) for v in vals]


def wave_shapes(traffic: Dict) -> List[Tuple[int, int]]:
    """The wave's (prompt, output) lengths, the same for every seed."""
    n = int(traffic["wave"])
    prompts = quantiles(traffic["prompt"], n)
    outputs = quantiles(traffic["output"], n)
    pair = np.random.default_rng(SHAPE_SEED).permutation(n)
    return [(prompts[i], outputs[j]) for i, j in enumerate(pair)]


@dataclass(frozen=True)
class Draw:
    prompt_len: int
    output_len: int
    tokens: np.ndarray        # int64 [prompt_len]


def wave(traffic: Dict, vocab: int, seed: int, index: int) -> List[Draw]:
    """Wave ``index`` of run ``seed``: the fixed shapes in an order drawn
    from (seed, index), each with fresh token ids in [0, vocab)."""
    rng = np.random.default_rng([seed, index])
    shapes = wave_shapes(traffic)
    order = rng.permutation(len(shapes))
    return [Draw(shapes[i][0], shapes[i][1],
                 rng.integers(0, vocab, shapes[i][0], dtype=np.int64))
            for i in order]


def longest(traffic: Dict) -> Tuple[int, int]:
    """The longest prompt and the longest output the traffic sends."""
    shapes = wave_shapes(traffic)
    return max(p for p, _ in shapes), max(o for _, o in shapes)
