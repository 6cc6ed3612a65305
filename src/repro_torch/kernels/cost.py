"""The kernels' work, one formula each, and what abstract evaluation
charges for it.

``*_flops`` and ``*_bytes`` give each kernel's work: the products it must
do and the bytes it must move (each input read once, each output written
once). ``chip_smoke.py`` divides them by the card's rates for each
kernel's bound. Abstract evaluation is the dry run's (``launch.dryrun``):
inside ``recording``, on the meta device, each kernel wrapper launches
nothing and ``charge``s the kernel's work instead, as does the sLSTM's
meta scan (``models.ssm``); ``recording`` collects the charges. Outside
it a meta tensor is refused as any other device's.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

_lock = threading.Lock()
_active: list = []


def attention_pairs(sq: int, skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query row, key column) pairs the flash-attention kernel computes:
    all of them, or with the causal mask q_offset + row >= col."""
    if not causal:
        return sq * skv
    # rows whose mask covers every column contribute skv each
    full = max(0, min(sq, q_offset + sq - skv + 1) if skv <= q_offset + sq
               else 0)
    part = sq - full
    first = q_offset + 1                      # row 0 sees q_offset + 1 cols
    return part * first + part * (part - 1) // 2 + full * skv


def attention_flops(b: int, sq: int, skv: int, h: int, d: int,
                    causal: bool = True, q_offset: int = 0) -> int:
    """K1: Q.K^T and P.V, 2 x 2 d FLOPs per (row, column) pair a head."""
    return 4 * b * h * d * attention_pairs(sq, skv, causal, q_offset)


def attention_bytes(b: int, sq: int, skv: int, h: int, kvh: int, d: int,
                    lse: bool = False) -> int:
    """K1: q read and o written, k and v read, in bf16; fp32 L written."""
    return 2 * (2 * b * sq * h * d + 2 * b * skv * kvh * d) \
        + (4 * b * h * sq if lse else 0)


def attention_bwd_flops(b: int, sq: int, skv: int, h: int, d: int) -> int:
    """The training backward (``models.attention._flash_bwd``): delta =
    rowsum(do * o), then for every (row, column) pair, masked or not, the
    scores, dv, dp, dq and dk, each 2 d FLOPs a head."""
    return 2 * b * sq * h * d + 10 * b * h * d * sq * skv


def decode_flops(rows_read: int, h: int, d: int) -> int:
    """K2: the cache rows read (the sum of kv_len over the batch) against
    every query head of their kv head."""
    return 4 * rows_read * h * d


def decode_bytes(b: int, h: int, kvh: int, d: int, rows_read: int) -> int:
    """K2: q read and o written, the cache rows read, kv_len read."""
    return 2 * (2 * b * h * d + 2 * rows_read * kvh * d) + 4 * b


def ssd_flops(b: int, s: int, nh: int, P: int, N: int, Q: int) -> int:
    """K3: per chunk, the causal Q x Q blocks (C.B^T and W.x over the lower
    triangle), C.S_in and the state update."""
    full, last = divmod(s, Q)
    per = lambda L: L * (L + 1) // 2 * 2 * (N + P) + 4 * L * N * P
    return b * nh * (full * per(Q) + (per(last) if last else 0))


def ssd_bytes(b: int, s: int, nh: int, P: int, g: int, N: int,
              init_state: bool) -> int:
    """K3: x, B, C read and y written in bf16; dt, A read, the final state
    written (and the initial one read) in fp32."""
    return 2 * (2 * b * s * nh * P + 2 * b * s * g * N) \
        + 4 * (b * s * nh + nh) \
        + 4 * b * nh * P * N * (2 if init_state else 1)


@contextmanager
def recording():
    """Collect the charges made in the block: {name: {"flops", "bytes",
    "calls"}}."""
    got: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"flops": 0, "bytes": 0, "calls": 0})
    with _lock:
        _active.append(got)
    try:
        yield got
    finally:
        with _lock:
            _active.remove(got)


def evaluating() -> bool:
    """Whether a ``recording`` is open: the kernels' meta branches run
    only then."""
    return bool(_active)


def charge(name: str, flops: int, nbytes: int, times: int = 1) -> None:
    """Record ``times`` calls of ``name``'s work in every open
    ``recording``."""
    with _lock:
        for got in _active:
            got[name]["flops"] += flops * times
            got[name]["bytes"] += nbytes * times
            got[name]["calls"] += times


def total_flops(got: Optional[Dict[str, Dict[str, int]]]) -> int:
    return sum(v["flops"] for v in (got or {}).values())
