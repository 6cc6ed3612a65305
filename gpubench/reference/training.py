"""Training in plain PyTorch, float32: the next-token cross entropy over
every position (the token mean over the global batch), its gradient,
clipping by the global norm, and AdamW (Loshchilov and Hutter) with
bias correction, decoupled weight decay on every weight, and a learning
rate that warms up linearly and then follows a cosine down to
``min_lr_frac`` of its peak.

``readings`` runs the first steps from the given weights and returns
what the training check compares: each step's loss, the norm of each
weight's first clipped gradient, and the norm of each weight's change
over the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gpubench import weights as W
from gpubench.reference import inputs
from gpubench.reference.layers import Precision


def lr_at(opt: Dict, step: int) -> float:
    """The learning rate of step ``step`` (counted from 1)."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


def batch(seed: int, first: int, n: int, vocab: int, seq: int, device):
    rows = [inputs.example(seed, i, vocab, seq) for i in range(first,
                                                                first + n)]
    return (torch.from_numpy(np.stack([r["tokens"] for r in rows])).to(device),
            torch.from_numpy(np.stack([r["labels"] for r in rows])).to(device))


def readings(family, cfg: Dict, params: Dict, seed: int, seq: int,
             global_batch: int, opt: Dict, steps: int, device,
             prec: Precision, rows: int = 4, keep_rows: int = None) -> Dict:
    """Train ``steps`` steps of ``global_batch`` examples (step k takes
    examples [k·global_batch, (k+1)·global_batch) of the seed) from
    ``params`` (taken over as float32). The batch is run ``rows`` rows at a
    time, each part's gradient weighted by its share of the tokens.
    ``keep_rows`` keeps only the first rows of each batch (a planted
    fault: half of the batch left out)."""
    p = {k: t.detach().float().clone().requires_grad_()
         for k, t in W.leaves(params)}
    start = {k: t.detach().clone() for k, t in p.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    used = keep_rows or global_batch
    for step in range(1, steps + 1):
        grads = {k: torch.zeros_like(t) for k, t in p.items()}
        total = 0.0
        for at in range(0, used, rows):
            n = min(rows, used - at)
            toks, labels = batch(seed, (step - 1) * global_batch + at, n,
                                 cfg["vocab"], seq, device)
            tree = _tree(params, p)
            logits = family.forward(cfg, tree, toks, prec)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels.long().reshape(-1))
            share = n / used
            got = torch.autograd.grad(loss * share, list(p.values()),
                                      allow_unused=True)
            for (k, _), g in zip(p.items(), got):
                if g is not None:
                    grads[k].add_(g)
            total += loss.item() * share
            del logits, loss, got
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        b1, b2 = opt["beta1"], opt["beta2"]
        lr = lr_at(opt, step)
        with torch.no_grad():
            for k, t in p.items():
                g = grads[k] * scale
                if step == 1:
                    first[k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / (1 - b1 ** step)) / (
                    torch.sqrt(v[k] / (1 - b2 ** step)) + opt["eps"]) \
                    + opt["weight_decay"] * t
                t.sub_(lr * upd)
        del grads
    change = {k: float((t.detach() - start[k]).norm()) for k, t in p.items()}
    return {"loss": losses, "grad": first, "change": change}


def _tree(like: Dict, flat: Dict[str, torch.Tensor], path: str = ""):
    """``flat``'s tensors (keyed by leaf path) in the shape of ``like``."""
    if isinstance(like, dict):
        return {k: _tree(v, flat, f"{path}/{k}" if path else k)
                for k, v in like.items()}
    return flat[path]
