"""The inputs the program under test derives from its seed, derived again
here so that the reference never takes them from the program.

Frozen copies of two generators of the program: the serving engine's
prompt of request ``idx`` and the training data pipeline's example
``idx``. Each is a pure function of (seed, idx).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def prompt(seed: int, idx: int, vocab: int, length: int) -> np.ndarray:
    """Request ``idx``'s prompt: ``length`` token ids uniform in
    [0, vocab)."""
    rng = np.random.Generator(np.random.PCG64((seed << 32) ^ idx))
    return rng.integers(0, vocab, length, dtype=np.int32)


def example(seed: int, idx: int, vocab: int, seq_len: int) \
        -> Dict[str, np.ndarray]:
    """Training example ``idx``: uniform tokens whose odd positions follow
    the even ones (t[2i+1] = 7 t[2i] + 3 mod vocab), and the next-token
    labels."""
    rng = np.random.Generator(np.random.PCG64((seed << 32) ^ idx))
    toks = rng.integers(0, vocab, seq_len + 1, dtype=np.int32)
    toks[1::2] = (toks[0::2][:toks[1::2].shape[0]] * 7 + 3) % vocab
    return {"tokens": toks[:-1], "labels": toks[1:]}
