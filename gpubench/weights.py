"""Random weights from the run's seed, made on the device.

One flat buffer per dtype is drawn from a ``torch.Generator`` on the
device in one call, in the dtype the weights are served in; each weight is
a view of it, scaled to its stddev or filled with its constant. The same
seed on the same kind of device gives the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from gpubench.reference.layers import Spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _leaves(specs, path=()) -> List[Tuple[tuple, Spec]]:
    if isinstance(specs, dict):
        return [leaf for k in sorted(specs)
                for leaf in _leaves(specs[k], path + (k,))]
    return [(path, specs)]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(specs: Dict, seed: int, device) -> Dict:
    """The tree of ``specs`` as tensors on ``device``, drawn from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    leaves = _leaves(specs)
    out: Dict = {}
    for dname in sorted({s.dtype for _, s in leaves}):
        mine = [(p, s) for p, s in leaves if s.dtype == dname]
        # the normal leaves first, so that one draw covers them
        mine.sort(key=lambda ps: ps[1].init != "normal")
        n_rand = sum(_numel(s.shape) for _, s in mine if s.init == "normal")
        total = sum(_numel(s.shape) for _, s in mine)
        flat = torch.empty(total, dtype=DTYPES[dname], device=device)
        if n_rand:
            torch.randn(n_rand, generator=gen, dtype=DTYPES[dname],
                        device=device, out=flat[:n_rand])
        at = 0
        for path, s in mine:
            n = _numel(s.shape)
            t = flat[at:at + n].view(s.shape)
            at += n
            if s.init == "normal":
                t.mul_(s.std)
            elif s.init in ("zeros", "ones"):
                t.fill_(1.0 if s.init == "ones" else 0.0)
            else:
                raise ValueError(f"{'/'.join(path)}: init {s.init!r}")
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
    return out


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree, in sorted key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, t) for k in sorted(tree)
                for p, t in leaves(tree[k])]
    return [("", tree)]
