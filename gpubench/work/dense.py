"""The dense transformer's work, counted from its configuration's widths:
model FLOPs, and the hand-written kernels' launches with each launch's
operations and bytes.

``serve_*`` count one chunk of the serving engine: a prefill of ``b``
prompts of ``prompt`` tokens (logits at the last position only), then
``decode - 1`` steps of one token each against the cache, whose rows
``pos + 1`` every row reads. ``train_*`` count one chunk of ``b`` rows of
``seq`` tokens through the training forward (logits everywhere).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from gpubench import cost


def _dims(cfg: Dict):
    d, h, g = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    return d, h, g, cfg.get("head_dim") or d // h


def block_flops(cfg: Dict, b: int, n: int, q_offset: int) -> int:
    """One decoder block over ``n`` new positions of ``b`` rows that
    attend to ``q_offset`` earlier ones: its products and attention."""
    d, h, g, hd = _dims(cfg)
    weights = d * h * hd + 2 * d * g * hd + h * hd * d + 3 * d * cfg["d_ff"]
    return 2 * b * n * weights + cost.attention_flops(
        b, n, q_offset + n, h, hd, True, q_offset)


def forward_flops(cfg: Dict, b: int, n: int, q_offset: int,
                  logit_rows: int) -> int:
    return cfg["n_layers"] * block_flops(cfg, b, n, q_offset) \
        + 2 * logit_rows * cfg["d_model"] * cfg["vocab"]


def serve_flops(cfg: Dict, b: int, prompt: int, decode: int) -> int:
    total = forward_flops(cfg, b, prompt, 0, b)
    for j in range(decode - 1):
        total += forward_flops(cfg, b, 1, prompt + j, b)
    return total


def train_flops(cfg: Dict, b: int, seq: int) -> int:
    """Forward and backward: three forwards, no recompute counted."""
    return 3 * forward_flops(cfg, b, seq, 0, b * seq)


def serve_kernels(cfg: Dict, b: int, prompt: int, decode: int) \
        -> Dict[str, List[Tuple[int, int]]]:
    d, h, g, hd = _dims(cfg)
    L = cfg["n_layers"]
    k1 = [(cost.attention_flops(b, prompt, prompt, h, hd),
           cost.attention_bytes(b, prompt, prompt, h, g, hd))] * L
    k2 = []
    for j in range(decode - 1):
        rows = b * (prompt + j + 1)
        k2 += [(cost.decode_flops(rows, h, hd),
                cost.decode_bytes(b, h, g, hd, rows))] * L
    return {"k1": k1, "k2": k2, "k3": []}


def train_kernels(cfg: Dict, b: int, seq: int) \
        -> Dict[str, List[Tuple[int, int]]]:
    """The forward's K1 with its row log-sum-exp, once a block and again
    in the block's recompute."""
    d, h, g, hd = _dims(cfg)
    one = (cost.attention_flops(b, seq, seq, h, hd),
           cost.attention_bytes(b, seq, seq, h, g, hd, lse=True))
    return {"k1": [one] * (2 * cfg["n_layers"]), "k2": [], "k3": []}
