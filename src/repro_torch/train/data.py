"""Synthetic data pipeline with a resumable cursor, the port of
``repro.train.data`` (numpy only; its batches are byte-identical to the
reference's).

Deterministic function of (seed, step): a restart from a checkpointed
cursor reproduces the exact same batch stream — the property the
fault-tolerance tests assert (restarted loss curve == uninterrupted one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class DataCursor:
    seed: int = 0
    step: int = 0

    def as_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d: Dict) -> "DataCursor":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Random-token LM batches (the RandomDataset analogue for training)."""

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch_size
        self.seq = seq_len
        self.cursor = DataCursor(seed=seed, step=0)

    def restore(self, cursor_dict: Dict) -> None:
        self.cursor = DataCursor.from_dict(cursor_dict)

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(
            (self.cursor.seed * 1_000_003 + self.cursor.step) & 0x7FFFFFFF)

    def _token_stream(self, rng: np.random.Generator, B: int,
                      S: int) -> np.ndarray:
        """Learnable synthetic LM stream: a noisy +stride walk over the
        vocab. 90% of transitions are deterministic, so a working training
        loop must push loss well below ln(vocab) — the property the
        fault-tolerance and end-to-end tests assert."""
        V = self.cfg.vocab_size
        stride = 1 + (self.cursor.seed % 7)
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] + stride) % V
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng()
        cfg = self.cfg
        B, S = self.batch, self.seq
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            Np = cfg.vision.num_patches
            S_txt = max(S - Np, 1)
            out["patches"] = rng.standard_normal(
                (B, Np, cfg.vision.frontend_dim)).astype(np.float32) * 0.1
            toks = self._token_stream(rng, B, S_txt)
        elif cfg.family == "encdec":
            out["src_embeds"] = rng.standard_normal(
                (B, S, cfg.encdec.frontend_dim)).astype(np.float32) * 0.1
            toks = self._token_stream(rng, B, S)
        else:
            toks = self._token_stream(rng, B, S)
        out["tokens"] = toks[:, :-1].astype(np.int32)
        out["targets"] = toks[:, 1:].astype(np.int32)
        self.cursor.step += 1
        return out
