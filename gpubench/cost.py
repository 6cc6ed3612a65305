"""The yardstick: the card's peaks, the hand-written kernels' names, and
each kernel's operations and bytes.

The kernel formulas are frozen copies of the program's own
(``repro_torch/kernels/cost.py``: ``attention_*``, ``decode_*``,
``ssd_*``), kept here so that a change to the program cannot move the
yardstick. Each counts the work the algorithm needs for a call's shapes:
every input byte read once, every output byte written once.
"""
from __future__ import annotations

import re

#: NVIDIA H100 SXM's published peaks (dense, no sparsity), at its full
#: power limit of 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

#: each hand-written kernel by its ``__global__`` names, as the profiler
#: reports them (demangled, with their template arguments)
KERNELS = {
    "k1": re.compile(r"\bflash_attention(_wgmma)?_kernel\b"),
    "k2": re.compile(r"\bflash_decode_kernel\b"),
    "k3": re.compile(r"\bssd_scan_kernel\b"),
}


def kernel_of(name: str):
    """Which hand-written kernel a device operation's name is, or None."""
    for key, pat in KERNELS.items():
        if pat.search(name):
            return key
    return None


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the products at
    the bf16 peak and the bytes at the memory's peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_pairs(sq: int, skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query row, key column) pairs the flash-attention kernel computes:
    all of them, or with the causal mask q_offset + row >= col."""
    if not causal:
        return sq * skv
    full = max(0, min(sq, q_offset + sq - skv + 1) if skv <= q_offset + sq
               else 0)
    part = sq - full
    first = q_offset + 1
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
