"""Accelerator chunk-size search — the paper's §3.2 training phase.

Start from the smallest chunk that fully occupies the accelerator (the paper
reads CL_DEVICE_MAX_COMPUTE_UNITS × PREFERRED_WORK_GROUP_SIZE_MULTIPLE; our
TPU analogue is cores × per-dispatch occupancy quantum, e.g. the number of
sequences that saturate the MXU pipeline for one microbatch). Then try
multiples while throughput improves; stop when it decreases or stays flat
for ``patience`` sizes; return the argmax.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@dataclass
class SearchTrace:
    tried: List[Tuple[int, float]] = field(default_factory=list)
    best_chunk: int = 0
    best_lambda: float = 0.0


def occupancy_seed(n_units: int, per_unit_quantum: int) -> int:
    """The paper's initial chunk: #compute-units × preferred multiple."""
    return max(1, n_units * per_unit_quantum)


def search_chunk(measure: Callable[[int], float], seed: int,
                 *, multiples: int = 64, patience: int = 2,
                 rel_tol: float = 0.02, max_chunk: int = 1 << 22) \
        -> SearchTrace:
    """measure(chunk) -> effective throughput λ (items/s), including transfer
    and dispatch overheads (paper footnote 1). Returns the search trace."""
    tr = SearchTrace()
    flat = 0
    for k in range(1, multiples + 1):
        c = seed * k
        if c > max_chunk:
            break
        lam = measure(c)
        tr.tried.append((c, lam))
        if lam > tr.best_lambda * (1 + rel_tol):
            tr.best_chunk, tr.best_lambda = c, lam
            flat = 0
        else:
            flat += 1
            if flat >= patience:
                break
    if tr.best_chunk == 0 and tr.tried:
        tr.best_chunk, tr.best_lambda = max(tr.tried, key=lambda t: t[1])
    return tr
