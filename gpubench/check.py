"""The comparisons that decide ``correct``.

Serving: for a sample of the requests the window finished, the reference
runs once over each prompt followed by its served tokens, and the numbers
compared are taken from the gaps by which each served token's logit lies
below the reference's best logit at its position (0 where a served token
is the reference's own greedy pick): the widest, the 99th percentile and
the mean. A cell's limits file names those it compares.

Training: the program's first three steps against the reference's on the
same examples from the same weights: each step's loss, the first step's
gradient as the optimizer took it (clipped), and each weight's change
over the three steps. Each is taken by the worst leaf: the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger.

A run, the control and each planted fault are judged alike, by
``judge``: correct where something was attempted, nothing failed, and
every number the cell's limits name is there and within its limit.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gpubench.reference import inputs
from gpubench.reference.layers import Precision

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves under Adam by rounding alone: its change is not compared
STILL_LEAF = 1e-3


def judge(attempted: int, failed: int, numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """Whether a run is correct, and each number compared beside its
    limit (in the limits' order)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items() if k in numbers}
    correct = attempted > 0 and failed == 0 \
        and len(checks) == len(limits) \
        and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def sample_requests(seed: int, n: int, k: int) -> List[int]:
    """``k`` of the ``n`` request indices, drawn from the seed."""
    rng = np.random.Generator(np.random.PCG64(seed ^ 0x5EED))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def served_gaps(family, cfg: Dict, params: Dict, seed: int, prompt_len: int,
                served: Dict[int, np.ndarray], device, prec: Precision,
                rows: int = 2, rival: Precision = None) -> np.ndarray:
    """For each request in ``served`` (index -> its served tokens), the
    gap of each served token below the float32 reference's best logit at
    its position: (requests, tokens). With ``rival``, the gap is instead
    that of the token ``rival``'s precision puts first (the control), at
    the same positions of the same prompts and tokens."""
    idx = sorted(served)
    out = []
    for at in range(0, len(idx), rows):
        part = idx[at:at + rows]
        toks = np.stack([np.concatenate(
            [inputs.prompt(seed, i, cfg["vocab"], prompt_len),
             served[i][:-1]]) for i in part])
        toks = torch.from_numpy(toks).to(device)
        with torch.no_grad():
            ref = family.forward(cfg, params, toks, prec,
                                 keep_from=prompt_len - 1)
            if rival is None:
                pick = torch.from_numpy(np.stack(
                    [served[i] for i in part])).to(device).long()
            else:
                pick = family.forward(cfg, params, toks, rival,
                                      keep_from=prompt_len - 1).argmax(-1)
            best = ref.max(-1).values
            got = ref.gather(-1, pick[..., None])[..., 0]
            out.append((best - got).cpu().numpy())
        del ref
    return np.concatenate(out)


def gap_numbers(gaps: np.ndarray) -> Dict[str, float]:
    """The numbers compared of the served tokens' gaps: the widest, the
    99th percentile (past the widest two or three of a few hundred
    tokens), and the mean."""
    return {"max_logit_gap": float(gaps.max()),
            "p99_logit_gap": float(np.quantile(gaps, 0.99)),
            "mean_logit_gap": float(gaps.mean())}


def rel_gap(got: float, ref: float, floor: float) -> float:
    return abs(got - ref) / max(abs(ref), floor)


def worst_leaf(got: Dict[str, float], ref: Dict[str, float],
               skip: Sequence[str] = ()) -> Tuple[float, str]:
    """The largest relative gap of per-leaf norms, and its leaf."""
    med = statistics.median(ref.values())
    worst = (0.0, "")
    for k, r in ref.items():
        if k in skip:
            continue
        worst = max(worst, (rel_gap(got[k], r, med), k))
    return worst


def still_leaves(grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_norms.values())
    return sorted(k for k, v in grad_norms.items() if v < STILL_LEAF * med)


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared, from the readings of the program and
    of the reference: {"loss": ..., "grad": ..., "change": ...}, with the
    leaves that set the last two."""
    loss = max(rel_gap(a, b, 0.0) for a, b in zip(prog["loss"], ref["loss"]))
    grad, grad_leaf = worst_leaf(prog["grad"], ref["grad"])
    change, change_leaf = worst_leaf(prog["change"], ref["change"],
                                     still_leaves(ref["grad"]))
    return {"loss": loss, "grad": grad, "change": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}
