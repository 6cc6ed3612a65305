"""Synthetic-token data pipeline with host-side prefetch.

The sample space is index-addressable and deterministic (sample i is a pure
function of (seed, i)), which is what makes the paper's scheduler idempotent:
a re-executed chunk reproduces exactly the same examples (fault tolerance),
and any group can materialize any [begin, end) range locally (no data
redistribution when chunks move between groups).

The prefetcher double-buffers batch materialization on a background thread —
the O_hd mitigation from DESIGN.md (host→device copy overlaps compute).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.core.types import Chunk


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    vocab: int
    seed: int = 0
    prefix_len: int = 0
    d_model: int = 0               # for stubbed modality prefixes


class SyntheticLMData:
    """Deterministic synthetic LM stream: sample i -> (tokens, labels)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.PCG64(
            (self.cfg.seed << 32) ^ idx))
        # markov-ish stream so loss actually decreases during training
        toks = rng.integers(0, self.cfg.vocab,
                            self.cfg.seq_len + 1, dtype=np.int32)
        toks[1::2] = (toks[0::2][:toks[1::2].shape[0]] * 7 + 3) \
            % self.cfg.vocab
        out = {"tokens": toks[:-1], "labels": toks[1:]}
        if self.cfg.prefix_len:
            out["prefix_emb"] = rng.standard_normal(
                (self.cfg.prefix_len, self.cfg.d_model)).astype(np.float32) \
                * 0.02
        return out

    def batch(self, begin: int, end: int,
              pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Materialize samples [begin, end), optionally padded to a bucket
        size (padded rows are masked via loss_mask)."""
        n = end - begin
        rows = [self.sample(i) for i in range(begin, end)]
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        out["loss_mask"] = np.ones((n, self.cfg.seq_len), np.float32)
        if pad_to and pad_to > n:
            pad = pad_to - n
            for k, v in list(out.items()):
                out[k] = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
        return out

    def chunk_batch(self, chunk: Chunk,
                    pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        return self.batch(chunk.begin, chunk.end, pad_to)


def for_model(cfg: LMConfig, seq_len: int, seed: int = 0) -> SyntheticLMData:
    return SyntheticLMData(DataConfig(
        seq_len=seq_len, vocab=cfg.vocab, seed=seed,
        prefix_len=cfg.prefix_len, d_model=cfg.d_model))


class Prefetcher:
    """Double-buffered background batch materialization."""

    def __init__(self, make_batch, depth: int = 2):
        self.make_batch = make_batch
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idx = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            b = self.make_batch(self._idx)
            self._idx += 1
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self, timeout: float = 60.0):
        return self.q.get(timeout=timeout)

    def stop(self):
        self._stop.set()
